#!/usr/bin/env python
"""Per-height finality waterfall across N nodes' height ledgers.

Merges the JSONL ledgers `node.Node` / the nemesis harness write under
each node's data dir (`heights.jsonl`, `telemetry/heightlog.py`) — or
the `heightledger-*.json` dumps written on invariant violations — into
one per-height view (the `trace_timeline.py` merge discipline applied
to finality): every node's commit-to-commit gap, phase decomposition,
critical-path label, pipelined-apply overlap (`ovl=` — how much of the
ABCI apply ran under the next height's voting), and the **laggard
validator** whose vote arrived last, plus an aggregate summary
(per-phase means, critical-path histogram, laggard leaderboard,
pipelined-height count + mean overlap).

Usage:
  python -m tendermint_tpu_torch.tools.finality_report --ledgers node*/data/heights.jsonl
  python -m tendermint_tpu_torch.tools.finality_report --ledgers heightledger-*.json \\
      --height 7 --json

The repo's `tools/finality_report.py`, run on the port's ledgers.
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import json
import sys
from collections import defaultdict


def _expand(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        hits = sorted(glob_mod.glob(p))
        out.extend(hits if hits else [p])
    return out


def load_records(paths: list[str]) -> list[dict]:
    """Read ledger files: JSONL rings (one record per line) or
    `dump_all` JSON dumps ({"ledgers": [{"node", "records"}]}).
    Duplicates across overlapping inputs (a restart reloads its tail;
    dumps overlap live files) dedupe on (node, height) keeping the
    newest commit time."""
    best: dict[tuple, dict] = {}

    def _take(rec: dict) -> None:
        if not isinstance(rec, dict) or "height" not in rec:
            return
        key = (rec.get("node", ""), rec["height"])
        cur = best.get(key)
        if cur is None or rec.get("t_commit", 0.0) >= cur.get("t_commit", 0.0):
            best[key] = rec

    for path in _expand(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        stripped = text.lstrip()
        if stripped.startswith("{"):
            try:
                dump = json.loads(text)
            except ValueError:
                dump = None
            if isinstance(dump, dict) and "ledgers" in dump:
                for led in dump.get("ledgers", []):
                    node = led.get("node", "")
                    for rec in led.get("records", []):
                        if isinstance(rec, dict):
                            rec.setdefault("node", node)
                            _take(rec)
                continue
        for line in text.splitlines():
            try:
                _take(json.loads(line))
            except ValueError:
                continue
    return sorted(
        best.values(), key=lambda r: (r["height"], r.get("node", ""))
    )


def build_report(
    records: list[dict], height: int | None = None, last: int | None = None
) -> dict:
    """The merged waterfall: per-height rows (one per node) + aggregate
    summary. `height` selects one height; `last` keeps the newest N
    heights."""
    by_height: dict[int, list[dict]] = defaultdict(list)
    for r in records:
        if height is not None and r["height"] != height:
            continue
        by_height[r["height"]].append(r)
    heights = sorted(by_height)
    if last is not None:
        heights = heights[-last:]

    phase_sums: dict[str, list] = defaultdict(lambda: [0.0, 0])
    path_counts: dict[str, int] = defaultdict(int)
    laggards: dict[str, int] = defaultdict(int)
    gaps: list[float] = []
    pipelined_n = 0
    overlap_sum = 0.0
    rows = {}
    for h in heights:
        nodes = []
        for r in by_height[h]:
            gap = r.get("finality_s")
            if isinstance(gap, (int, float)):
                gaps.append(gap)
            for name, p in (r.get("phases") or {}).items():
                s = p.get("s", 0.0) if isinstance(p, dict) else float(p)
                acc = phase_sums[name]
                acc[0] += s
                acc[1] += 1
            label = r.get("critical_path")
            if label:
                path_counts[label] += 1
            lag = r.get("laggard")
            if isinstance(lag, dict) and lag.get("validator"):
                laggards[lag["validator"]] += 1
            if r.get("pipelined"):
                pipelined_n += 1
                overlap_sum += r.get("apply_overlap_s") or 0.0
            nodes.append(r)
        rows[h] = nodes
    gaps.sort()

    def _pctl(vals, q):
        if not vals:
            return None
        idx = min(len(vals) - 1, max(0, int(q * len(vals))))
        return round(vals[idx] * 1e3, 3)

    return {
        "heights": rows,
        "summary": {
            "heights": len(heights),
            "nodes": sorted({r.get("node", "") for rs in rows.values() for r in rs}),
            "finality_ms": {
                "p50": _pctl(gaps, 0.5),
                "p99": _pctl(gaps, 0.99),
                "samples": len(gaps),
            },
            "phase_mean_ms": {
                name: round(acc[0] / acc[1] * 1e3, 3)
                for name, acc in sorted(phase_sums.items())
                if acc[1]
            },
            "critical_path_counts": dict(
                sorted(path_counts.items(), key=lambda kv: -kv[1])
            ),
            "laggard_counts": dict(
                sorted(laggards.items(), key=lambda kv: -kv[1])
            ),
            "pipelined_heights": pipelined_n,
            "apply_overlap_ms_mean": round(overlap_sum / pipelined_n * 1e3, 3)
            if pipelined_n
            else None,
        },
    }


_PHASE_ORDER = ("new_height", "propose", "prevote", "precommit", "commit", "apply")
_PHASE_ABBR = {"new_height": "nh", "propose": "prop", "prevote": "pv",
               "precommit": "pc", "commit": "com", "apply": "apl"}


def render_text(report: dict) -> str:
    lines: list[str] = []
    for h, nodes in report["heights"].items():
        gaps = [
            r["finality_s"]
            for r in nodes
            if isinstance(r.get("finality_s"), (int, float))
        ]
        span = (
            f"finality {min(gaps) * 1e3:.1f}..{max(gaps) * 1e3:.1f} ms"
            if gaps
            else "finality n/a (first height)"
        )
        lines.append(f"height {h}  ({len(nodes)} nodes)  {span}")
        for r in nodes:
            phases = r.get("phases") or {}
            bar = " ".join(
                f"{_PHASE_ABBR[p]}={phases[p]['s'] * 1e3:.1f}"
                for p in _PHASE_ORDER
                if p in phases
            )
            gap = r.get("finality_s")
            gap_s = f"{gap * 1e3:8.1f}ms" if isinstance(gap, (int, float)) else "       --"
            lag = r.get("laggard")
            lag_s = (
                f"  laggard={lag['validator']}(+{lag['delay_s'] * 1e3:.1f}ms)"
                if isinstance(lag, dict)
                else ""
            )
            ovl_s = (
                f"  ovl={(r.get('apply_overlap_s') or 0.0) * 1e3:.1f}ms"
                if r.get("pipelined")
                else ""
            )
            lines.append(
                f"  {r.get('node', '?'):<14} {gap_s}  [{bar}]  "
                f"path={r.get('critical_path', '?')}{ovl_s}{lag_s}"
            )
    s = report["summary"]
    lines.append("")
    lines.append(
        f"summary: {s['heights']} heights x {len(s['nodes'])} nodes, "
        f"finality p50={s['finality_ms']['p50']}ms p99={s['finality_ms']['p99']}ms"
    )
    lines.append(
        "phase means (ms): "
        + " ".join(f"{k}={v}" for k, v in s["phase_mean_ms"].items())
    )
    lines.append(
        "critical path: "
        + (
            " ".join(f"{k}x{v}" for k, v in s["critical_path_counts"].items())
            or "-"
        )
    )
    lines.append(
        "laggards: "
        + (" ".join(f"{k}x{v}" for k, v in s["laggard_counts"].items()) or "-")
    )
    if s.get("pipelined_heights"):
        lines.append(
            f"pipeline: {s['pipelined_heights']} pipelined records, "
            f"apply overlap mean {s['apply_overlap_ms_mean']}ms"
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--ledgers",
        nargs="+",
        required=True,
        help="heights.jsonl files and/or heightledger-*.json dumps (globs ok)",
    )
    ap.add_argument("--height", type=int, default=None, help="one height only")
    ap.add_argument("--last", type=int, default=None, help="newest N heights")
    ap.add_argument("--json", action="store_true", help="emit JSON, not text")
    args = ap.parse_args(argv)
    report = build_report(
        load_records(args.ledgers), height=args.height, last=args.last
    )
    if args.json:
        json.dump(report, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_text(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
