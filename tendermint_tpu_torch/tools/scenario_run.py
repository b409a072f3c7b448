"""Run declarative chaos scenarios from the library or a JSON spec.

Usage:
    python -m tendermint_tpu_torch.tools.scenario_run --list
    python -m tendermint_tpu_torch.tools.scenario_run --scenario churn_small --device cpu
    python -m tendermint_tpu_torch.tools.scenario_run --all --json reports.json
    python -m tendermint_tpu_torch.tools.scenario_run --spec my_scenario.json

Without `--device` the nodes verify on the CUDA card.

Each scenario spins up an in-process Nemesis network, applies the
declared WAN topology / churn schedule / fault timeline / load
profile, grades the run against the spec's `expect` block (finality
SLOs, epoch counts, adaptive-timeout convergence, bisection bridging),
and prints a per-scenario report. Exits non-zero if any scenario
fails its invariants or expectations.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def _fmt_finality(fin: dict) -> str:
    if not fin or not fin.get("count"):
        return "no finality samples"
    return (
        f"finality p50={fin['p50_s']:.2f}s p95={fin['p95_s']:.2f}s "
        f"max={fin['max_s']:.2f}s over {fin['count']} heights"
    )


def _detail(report: dict) -> str:
    bits = [f"heights {report['heights']}", _fmt_finality(report["finality"])]
    if "epochs" in report:
        bits.append(
            f"epochs={report['epochs']} rebuilds={report['valset_rebuilds']}"
        )
    if "bisection" in report:
        b = report["bisection"]
        bits.append(
            f"bisected to h{b['verified_to']} in {b['rounds']} rounds"
        )
    if "propose_timeout_s" in report:
        bits.append(
            f"propose timeout {report['propose_timeout_s']['min']:.3f}s "
            f"> one-way delay {report['max_one_way_delay_s']:.3f}s"
        )
    skips = report.get("round_skips_post_warm")
    if skips is not None:
        bits.append(f"post-warm skips={skips}")
    return ", ".join(bits)


def _fmt_mb(n: float) -> str:
    return f"{n / 1e6:.2f}MB" if n >= 1e5 else f"{n / 1e3:.1f}kB"


def _print_gossip_table(report: dict) -> None:
    """The gossip verdict table (bandwidth per channel, redundancy
    factor per kind) from the scenario's fleet-wide rollup — printed
    alongside the finality report so over-gossip is visible in the same
    place as slow finality."""
    g = report.get("gossip")
    if not g:
        return
    chans = ", ".join(
        f"{c} {_fmt_mb(b)}"
        for c, b in sorted(
            g["channel_bytes"].items(), key=lambda kv: -kv[1]
        )[:5]
    )
    print(f"    gossip: {_fmt_mb(g['total_bytes'])} on the wire — {chans}")
    if g["redundancy_factor"]:
        factors = ", ".join(
            f"{k} {f:.2f}x ({_fmt_mb(g['redundant'][k]['bytes'])} dup)"
            for k, f in sorted(
                g["redundancy_factor"].items(), key=lambda kv: -kv[1]
            )
        )
        top = g.get("top_redundant_kind")
        print(
            f"    redundancy: {factors}"
            + (f" — top waste: {top}" if top else "")
        )


def main() -> int:
    from tendermint_tpu_torch.testing.scenario import (
        SCENARIO_LIBRARY,
        ScenarioRunner,
        validate_scenario,
    )
    from tendermint_tpu_torch.utils.log import setup_logging

    ap = argparse.ArgumentParser(
        description="declarative chaos scenario runner"
    )
    ap.add_argument("--list", action="store_true", help="list library scenarios")
    ap.add_argument(
        "--scenario",
        action="append",
        default=None,
        metavar="NAME",
        help="run this library scenario (repeatable)",
    )
    ap.add_argument(
        "--all", action="store_true", help="run the entire library, slow included"
    )
    ap.add_argument(
        "--spec",
        metavar="PATH",
        default=None,
        help="run a scenario spec from a JSON file instead of the library",
    )
    ap.add_argument(
        "--json",
        metavar="PATH",
        default=None,
        help="also write the full reports as JSON here",
    )
    ap.add_argument("--home", default=None, help="scratch dir (default: tmp)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    if args.list:
        width = max(len(n) for n in SCENARIO_LIBRARY)
        for name, spec in SCENARIO_LIBRARY.items():
            tier = "slow" if spec.get("slow", True) else "tier-1"
            print(f"  {name:<{width}}  [{tier:>6}]  {spec['description']}")
        return 0

    setup_logging("scenario:info,nemesis:warning,*:error")

    specs: list[dict] = []
    if args.spec:
        with open(args.spec) as fh:
            specs.append(validate_scenario(json.load(fh)))
    elif args.all:
        specs = [dict(s) for s in SCENARIO_LIBRARY.values()]
    elif args.scenario:
        for name in args.scenario:
            if name not in SCENARIO_LIBRARY:
                ap.error(
                    f"unknown scenario {name!r} — choices: "
                    f"{', '.join(SCENARIO_LIBRARY)}"
                )
            specs.append(dict(SCENARIO_LIBRARY[name]))
    else:
        ap.error("pick --list, --scenario NAME, --all, or --spec PATH")

    home = args.home or tempfile.mkdtemp(prefix="scenario-run-")
    reports = []
    for spec in specs:
        print(f"=== {spec['name']}: {spec.get('description', '')}")
        report = ScenarioRunner(home=home, device=args.device).run(spec)
        reports.append(report)
        verdict = "PASS" if report["ok"] else "FAIL"
        print(f"    {verdict} in {report['elapsed_s']}s — {_detail(report)}")
        _print_gossip_table(report)
        for failure in report["failures"]:
            print(f"    failure: {failure}")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(reports, fh, indent=2, sort_keys=True)
        print(f"reports written to {args.json}")

    width = max(len(r["scenario"]) for r in reports)
    failed = 0
    print("\nscenario results:")
    for report in reports:
        verdict = "PASS" if report["ok"] else "FAIL"
        print(f"  {report['scenario']:<{width}}  {verdict}  {_detail(report)}")
        failed += not report["ok"]
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
