"""Compare two trees of the PyTorch/CUDA port on one card, in turns.

    python3 -m tendermint_tpu_torch.abba BEFORE_DIR AFTER_DIR

Each directory holds a checkout of the repository (for example
`git archive <commit> | tar -x -C DIR`). The script runs
`python3 chip_smoke.py` in BEFORE, AFTER, AFTER, BEFORE, one after the
other on the same card (each run at most RUN_TIMEOUT_S), keeps each run's output
and `chip_smoke.json` under `chiprun_out/abba/`, and prints one summary
line a run: each kernel's time and registers, the three calls' wall
times, the flat call's torch prologue and the card's kernel count and
busy share per call. It exits non-zero when any run fails, and stops
when the two trees time a kernel's `ms` by different means (`ms_by`:
CUDA events around a call, or the profiler's device time a launch; a
row without the key was timed by events).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

ORDER = "abba"  # a = BEFORE, b = AFTER
RUN_TIMEOUT_S = 900


def summary(report: dict) -> dict:
    env = report.get("env", {})
    regs = {}
    name = None
    for ln in env.get("ptxas", []):
        if "Compiling entry" in ln:
            m = re.search(r"(ladder_kernel|madd_chain_fused_kernel|madd_chain_entries_kernel|finish_kernel|sha512_masked_kernel)", ln)
            name = m.group(1) if m else None
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            regs.setdefault(name, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            regs.setdefault(name, {})["registers"] = int(m.group(1))
    dev = report.get("device", {})
    return {
        "card": env.get("nvidia_smi"),
        "kernels": {
            k["name"]: {"ms": k["ms"], "ms_by": k.get("ms_by", "events"), "bound_ms": k["bound_ms"],
                        "plain_ms": k["plain_ms"], "launches": k["launches"], "max_abs_err": k["max_abs_err"]}
            for k in report.get("kernels", [])
        },
        "ptxas": regs,
        "commit_s": report.get("consensus", {}).get("warm_commit_s_median"),
        "window_commits_per_s": report.get("fast_sync", {}).get("commits_per_s"),
        "flat_verifies_per_s": report.get("flat", {}).get("verifies_per_s"),
        "flat_warm_s": report.get("flat", {}).get("warm_batch_s_median"),
        "state_apply_s": [h["apply_s"] for h in report.get("state", {}).get("heights", [])] or None,
        "replay_commits_per_s": report.get("certifiers", {}).get("replay", {}).get("commits_per_s"),
        "stages": report.get("stages"),
        "device": {k: {"device_s": v.get("device_s"), "kernels": v.get("device_kernels"),
                       "busy_share": v.get("busy_share")} for k, v in dev.items()},
        "flat_launches": report.get("flat_launches"),
        "finish_ms": report.get("finish_ms"),
        "entries_table_sectors": report.get("entries_table_sectors"),
    }


def timing_mismatch(a: dict, b: dict) -> list[str]:
    """Kernels that both summaries list but whose `ms` they measured by
    different means."""
    ka, kb = a["kernels"], b["kernels"]
    return sorted(n for n in ka.keys() & kb.keys() if ka[n]["ms_by"] != kb[n]["ms_by"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after")
    args = ap.parse_args()
    out = pathlib.Path("chiprun_out") / "abba"
    out.mkdir(parents=True, exist_ok=True)
    trees = {"a": pathlib.Path(args.before), "b": pathlib.Path(args.after)}
    failed = False
    first: dict = {}
    for i, key in enumerate(ORDER):
        tree = trees[key]
        tag = f"{i}_{key}"
        t0 = time.perf_counter()
        with open(out / f"{tag}.log", "w") as log:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, stdout=log,
                                stderr=subprocess.STDOUT, timeout=RUN_TIMEOUT_S).returncode
        seconds = time.perf_counter() - t0
        rep_path = tree / "chiprun_out" / "chip_smoke.json"
        line = {"run": tag, "tree": str(tree), "rc": rc, "seconds": seconds}
        if rc == 0 and rep_path.exists():
            shutil.copy(rep_path, out / f"{tag}.json")
            rep_path.unlink()
            line.update(summary(json.loads((out / f"{tag}.json").read_text())))
            first.setdefault(key, line)
        else:
            failed = True
        print(json.dumps(line), flush=True)
        if len(first) == 2 and (bad := timing_mismatch(first["a"], first["b"])):
            print(f"abba: the trees time {', '.join(bad)} by different means; their ms do not compare",
                  file=sys.stderr)
            return 2
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
