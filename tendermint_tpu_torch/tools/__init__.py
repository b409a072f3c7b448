"""The port's command-line tools for the chaos book, run as
`python -m tendermint_tpu_torch.tools.<name>`: `nemesis_demo` and
`scenario_run`, each the repo's `tools/<name>.py` with a `--device` flag."""
