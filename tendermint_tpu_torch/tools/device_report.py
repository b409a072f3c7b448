"""Device report: the per-launch kernel waterfall.

Merges N nodes' launch ledgers (`telemetry/launchlog.py` — one record
per device launch with backend, mesh width, useful/padded/cached rows,
stage durations, transfer bytes, and compile-cache attribution) into
one per-kind waterfall and **names the top waste source**: padding
waste (zero rows shipped for bucket/mesh geometry), compile stalls
(`_STEP_CACHE` misses), transfer overhead (sharded-table `device_put`
re-ships), or launch-gap idle (device sitting between launches). The
device twin of `tools/contention_report.py`.

The port's nodes write the same records (`telemetry/launchlog.py`);
the waste sources and the verdict's words are the JAX tool's, so on
the port's records "compile stalls" and `device_put` re-ships read
zero.

    # against live nodes (one --rpc per node)
    python -m tendermint_tpu_torch.tools.device_report --rpc 127.0.0.1:26657 \\
        --rpc 127.0.0.1:26660

    # from persisted ledgers / flight-embedded dumps
    python -m tendermint_tpu_torch.tools.device_report --ledgers node*/data/launches.jsonl

Output: a text waterfall per launch kind (occupancy %, padding waste %,
cache-withheld %, stage split, transfer, compile amortization), the
consumer mix, and the fix-first-on-silicon verdict. `--json` writes the
structured report.
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import json
import sys
import urllib.request

from tendermint_tpu_torch.telemetry.launchlog import summarize

# waste sources the verdict can name, with the ROADMAP pointer each
# one implies on real silicon
_FIXES = {
    "padding_waste": (
        "shrink the ops/padding.py bucket ladder (or align batch/valset "
        "sizes to the mesh) — wasted device-seconds scale with every "
        "perf item, including items 2 and 5"
    ),
    "compile_stalls": (
        "warm the persistent XLA cache (utils/jax_cache.py) and pre-"
        "compile the mesh steps at boot — a survivor re-mesh or valset "
        "rotation must not stall launches"
    ),
    "transfer_overhead": (
        "grow the sharded-table placement cache or shrink table bytes "
        "per chip — the device_put re-ship is the cost model item 5's "
        "BLS lane must beat"
    ),
    "launch_gap_idle": (
        "widen the coalescer window / raise dispatch depth — the device "
        "is starved between launches, not slow inside them (the item 2 "
        "incremental state tree adds launches to fill these gaps)"
    ),
}


def fetch_launches_rpc(addr: str, n: int = 512, timeout: float = 30.0) -> list[dict]:
    """dump_telemetry(launches=N) over JSON-RPC; returns the records."""
    req = urllib.request.Request(
        f"http://{addr}/",
        data=json.dumps(
            {
                "jsonrpc": "2.0",
                "id": 1,
                "method": "dump_telemetry",
                "params": {"spans": 0, "launches": int(n)},
            }
        ).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.load(resp)
    if "error" in out:
        raise RuntimeError(out["error"])
    view = (out["result"] or {}).get("launches") or {}
    return view.get("records") or []


def load_ledgers(paths: list[str]) -> list[dict]:
    """Read launch records from JSONL ledgers (`launches.jsonl`), from
    `launchledger-*.json` dumps, or from flight-recorder dumps (their
    embedded `launches` key). Duplicates across overlapping inputs
    dedupe on (t, kind, rows, queue)."""
    out: list[dict] = []
    seen: set = set()
    expanded: list[str] = []
    for p in paths:
        hits = sorted(glob_mod.glob(p))
        expanded.extend(hits if hits else [p])
    for path in expanded:
        records: list[dict] = []
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        try:
            # a whole-file JSON document: launchledger-*.json /
            # flightrec-*.json dump with an embedded record list
            dump = json.loads(text)
            if isinstance(dump, dict):
                records = dump.get("records") or dump.get("launches") or []
        except ValueError:
            # JSONL ledger: one record per line, torn tails skipped
            for line in text.splitlines():
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                if isinstance(d, dict):
                    records.append(d)
        for r in records:
            if not isinstance(r, dict) or "kind" not in r:
                continue
            key = (r.get("t"), r.get("kind"), r.get("rows"), r.get("queue"))
            if key in seen:
                continue
            seen.add(key)
            out.append(r)
    out.sort(key=lambda r: r.get("t", 0.0))
    return out


def _launch_gaps(records: list[dict]) -> dict:
    """Idle seconds between consecutive launches per (node, queue) —
    launch start approximated as commit wall time minus total_s. Only
    queue-bearing records participate (synchronous implicit launches
    have no queue to idle)."""
    lanes: dict[tuple, list[tuple[float, float]]] = {}
    for r in records:
        q = r.get("queue")
        if not q:
            continue
        t_end = float(r.get("t", 0.0))
        t_start = t_end - float(r.get("total_s", 0.0))
        lanes.setdefault((r.get("node", ""), q), []).append((t_start, t_end))
    idle_s = 0.0
    busy_s = 0.0
    gaps = 0
    for spans in lanes.values():
        spans.sort()
        prev_end = None
        for t_start, t_end in spans:
            busy_s += max(0.0, t_end - t_start)
            if prev_end is not None and t_start > prev_end:
                idle_s += t_start - prev_end
                gaps += 1
            prev_end = max(prev_end or t_end, t_end)
    return {
        "idle_s": round(idle_s, 6),
        "busy_s": round(busy_s, 6),
        "gaps": gaps,
        "lanes": len(lanes),
    }


def build_report(records: list[dict]) -> dict:
    """The structured report: the per-kind waterfall (shared rollup
    from telemetry/launchlog.py, so live dumps and offline merges can
    never disagree), the launch-gap analysis, and the verdict naming
    the top waste source in device-seconds."""
    kinds = summarize(records)
    gapinfo = _launch_gaps(records)

    total_in_flight = sum(k["stages_s"]["in_flight"] for k in kinds.values())
    total_rows = sum(k["rows"] for k in kinds.values())
    total_padded = sum(k["rows_padded"] for k in kinds.values())
    shipped = total_rows + total_padded
    waste = {
        # device-seconds the pad rows occupied: in-flight time scaled
        # by the padded share of shipped rows
        "padding_waste": round(
            total_in_flight * (total_padded / shipped) if shipped else 0.0, 6
        ),
        "compile_stalls": round(
            sum(k["compile_s"] for k in kinds.values()), 6
        ),
        "transfer_overhead": round(
            sum(k["device_put_s"] for k in kinds.values()), 6
        ),
        "launch_gap_idle": gapinfo["idle_s"],
    }
    verdict = None
    if records:
        top = max(waste, key=lambda k: waste[k])
        verdict = {
            "top_waste_source": top,
            "cost_s": waste[top],
            "fix_first_on_silicon": _FIXES[top],
            "reseed_note": (
                "reseed BENCH_hotpath.json device sections from this "
                "report on the real pod (ROADMAP real-silicon reseed "
                "bullet); the per-kind costs here are the launch cost "
                "model for ROADMAP items 2 and 5"
            ),
        }
    return {
        "launches": len(records),
        "nodes": sorted({r.get("node", "") for r in records if r.get("node")}),
        "kinds": kinds,
        "launch_gaps": gapinfo,
        "waste_s": waste,
        "verdict": verdict,
    }


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n}B"


def render_text(report: dict) -> str:
    """The operator-facing waterfall."""
    out = [
        "device observatory — per-kind launch waterfall "
        f"({report['launches']} launches"
        + (
            f", nodes: {', '.join(n[:12] for n in report['nodes'])}"
            if report["nodes"]
            else ""
        )
        + ")",
        "",
        f"{'kind':<12} {'launches':>8} {'rows':>9} {'occup%':>7} "
        f"{'pad%':>6} {'cached%':>8} {'transfer':>10} {'compile':>9}",
    ]
    for kind, agg in sorted(
        report["kinds"].items(), key=lambda kv: -kv[1]["launches"]
    ):
        occ = agg["occupancy_pct"]
        pad = agg["padding_waste_pct"]
        cached = agg["cache_withheld_pct"]
        out.append(
            f"{kind:<12} {agg['launches']:>8} {agg['rows']:>9} "
            f"{occ if occ is not None else '-':>7} "
            f"{pad if pad is not None else '-':>6} "
            f"{cached if cached is not None else '-':>8} "
            f"{_fmt_bytes(agg['transfer_bytes']):>10} "
            f"{agg['compile_misses']}m/{agg['compile_hits']}h"
        )
        st = agg["stages_s"]
        out.append(
            f"{'':12} stages: queue_wait {st['queue_wait']:.3f}s | "
            f"host_prep {st['host_prep']:.3f}s | in_flight "
            f"{st['in_flight']:.3f}s | finalize {st['finalize']:.3f}s"
            + (
                f" | compile {agg['compile_s']:.3f}s"
                if agg["compile_s"]
                else ""
            )
            + (
                f" | device_put {agg['device_put_s']:.3f}s"
                if agg["device_put_s"]
                else ""
            )
        )
        if agg["consumers"]:
            mix = ", ".join(
                f"{c} {n}"
                for c, n in sorted(
                    agg["consumers"].items(), key=lambda kv: -kv[1]
                )
            )
            out.append(f"{'':12} consumers: {mix}")
    gaps = report["launch_gaps"]
    out.append("")
    out.append(
        f"launch gaps: {gaps['idle_s']:.3f}s idle vs {gaps['busy_s']:.3f}s "
        f"busy across {gaps['lanes']} queue lane(s) ({gaps['gaps']} gaps)"
    )
    out.append(
        "waste (device-seconds): "
        + ", ".join(f"{k} {v:.3f}s" for k, v in report["waste_s"].items())
    )
    verdict = report.get("verdict")
    if verdict:
        out.append(
            f"verdict: top waste source is {verdict['top_waste_source']} "
            f"({verdict['cost_s']:.3f}s) — {verdict['fix_first_on_silicon']}"
        )
        out.append(f"         {verdict['reseed_note']}")
    else:
        out.append("verdict: no launches recorded (is the ledger enabled?)")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--rpc",
        action="append",
        default=[],
        help="host:port of a live node's RPC listener (repeatable)",
    )
    ap.add_argument(
        "--ledgers",
        nargs="+",
        default=[],
        help="launches.jsonl / launchledger-*.json / flightrec-*.json (globs ok)",
    )
    ap.add_argument(
        "--launches",
        type=int,
        default=512,
        help="records to pull per --rpc node",
    )
    ap.add_argument(
        "--json", dest="json_out", default="", help="write the structured report here"
    )
    args = ap.parse_args(argv)
    if not args.rpc and not args.ledgers:
        ap.error("need --rpc and/or --ledgers inputs")

    records: list[dict] = []
    seen: set = set()
    for addr in args.rpc:
        # dedupe across sources: multi-node-in-process harnesses serve
        # the same process-wide ledger from every node's RPC
        for r in fetch_launches_rpc(addr, n=args.launches):
            key = (r.get("t"), r.get("kind"), r.get("rows"), r.get("queue"))
            if key in seen:
                continue
            seen.add(key)
            records.append(r)
    if args.ledgers:
        for r in load_ledgers(args.ledgers):
            key = (r.get("t"), r.get("kind"), r.get("rows"), r.get("queue"))
            if key not in seen:
                seen.add(key)
                records.append(r)
    records.sort(key=lambda r: r.get("t", 0.0))
    report = build_report(records)
    print(render_text(report))
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
        print(f"\nreport -> {args.json_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
