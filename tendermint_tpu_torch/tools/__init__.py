"""The port's command-line tools, run as
`python -m tendermint_tpu_torch.tools.<name>`, each the repo's
`tools/<name>.py` on the port's package: the chaos book's `nemesis_demo`
and `scenario_run`, the load generator `loadgen`, `statesync_demo`, and
the readers of a node's telemetry `trace_timeline`, `finality_report`,
`device_report`, `gossip_report` and `contention_report`. Those that
verify take `--device` (the CUDA card unless it names another)."""
