#!/usr/bin/env python
"""Merge span logs + flight-recorder dumps from N nodes into one
timeline: follow a single tx/vote from ingress to commit across the
whole cluster, or replay one height's forensics.

Inputs:
  * span logs — the per-node JSONL rings `node.Node` writes under
    `<home>/data/spans.jsonl` (`telemetry/spanlog.py`); spans carrying
    a `trace` attr are distributed-trace members;
  * flight-recorder dumps — the JSON files `telemetry/flightrec.py`
    writes on invariant violations, consensus halts, or SIGUSR2;
  * launch ledgers (`--launches`) — the per-launch JSONL rings the
    device observatory persists (`telemetry/launchlog.py`); records
    carrying an exemplar trace id join the timeline as
    `device.launch` entries, attributing device time to a traced tx.

Usage:
  python -m tendermint_tpu_torch.tools.trace_timeline --spans node*/data/spans.jsonl \\
      --trace 6fa0c1b2d3e4f509
  python -m tendermint_tpu_torch.tools.trace_timeline --spans node*/data/spans.jsonl \\
      --flight flightrec-*.json --height 7 --json

Multi-node-in-process harnesses sink every node's spans into every
node's log (the tracer is process-global); the loader dedupes, so
feeding overlapping logs is always safe.
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import json
import sys

# span name -> lifecycle stage shown in the timeline (the five stages
# of a tx's life plus vote/consensus forensics); unknown names fall
# back to their dotted prefix
STAGES = {
    "mempool.admission": "admission",
    "p2p.hop": "hop",
    "batcher.flush": "flush",
    "dispatch.launch": "launch",
    "device.launch": "launch",
    "tx.e2e": "commit",
    "vote.e2e": "verdict",
    "consensus.propose": "consensus",
    "consensus.prevote": "consensus",
    "consensus.precommit": "consensus",
    "consensus.commit": "consensus",
    "consensus.height": "consensus",
}


def _expand(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        hits = sorted(glob_mod.glob(p))
        out.extend(hits if hits else [p])
    return out


def load_spans(paths: list[str]) -> list[dict]:
    """Read JSONL span logs; unparseable lines (torn writes) are
    skipped; duplicates across logs (shared-process harnesses) dedupe
    on (name, start, end, trace)."""
    seen: set = set()
    out: list[dict] = []
    for path in _expand(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if not isinstance(d, dict) or "name" not in d:
                continue
            attrs = d.get("attrs") or {}
            key = (d["name"], d.get("start"), d.get("end"), attrs.get("trace"))
            if key in seen:
                continue
            seen.add(key)
            out.append(d)
    return out


def load_flight(paths: list[str]) -> list[dict]:
    """Read flight-recorder dumps; each event is tagged with the dump's
    node id (when the dumping process knew one)."""
    out: list[dict] = []
    for path in _expand(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                dump = json.load(f)
        except (OSError, ValueError):
            continue
        node = dump.get("node", "")
        for evt in dump.get("events", []):
            if isinstance(evt, dict):
                evt = dict(evt)
                evt.setdefault("node", node)
                out.append(evt)
    return out


def load_launches(paths: list[str]) -> list[dict]:
    """Read LaunchLedger JSONL files (`launches.jsonl`, the device
    observatory) and convert each record carrying an exemplar trace id
    into a span-shaped `device.launch` entry — so a traced tx's
    timeline shows the device launch its verify rode, with the rows /
    padding / stage split as attrs. Records without a trace are
    skipped (the ledger is exhaustive; the timeline is trace-scoped)."""
    out: list[dict] = []
    seen: set = set()
    for path in _expand(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if not isinstance(d, dict) or "kind" not in d or not d.get("trace"):
                continue
            end = float(d.get("t", 0.0))
            start = end - float(d.get("total_s", 0.0))
            key = ("device.launch", start, end, d["trace"])
            if key in seen:
                continue
            seen.add(key)
            attrs = {
                "trace": d["trace"],
                "node": d.get("node", ""),
                "kind": d.get("kind"),
                "backend": d.get("backend"),
                "rows": d.get("rows"),
            }
            for k in ("rows_padded", "rows_cached", "in_flight_s", "queue"):
                if d.get(k):
                    attrs[k] = d[k]
            out.append(
                {
                    "name": "device.launch",
                    "start": start,
                    "end": end,
                    "attrs": attrs,
                }
            )
    return out


def build_timeline(
    spans: list[dict],
    events: list[dict] | None = None,
    trace_id: str | None = None,
    height: int | None = None,
) -> dict:
    """One merged, time-ordered timeline. `trace_id` selects the spans
    of one distributed trace; `height` selects flight events (and, when
    no trace filter is given, spans) of one height. Flight events carry
    no trace ids — with both filters set, you get the trace's spans
    interleaved with that height's black-box events."""
    entries: list[dict] = []
    for s in spans:
        attrs = s.get("attrs") or {}
        if trace_id is not None:
            if attrs.get("trace") != trace_id:
                continue
        elif height is not None and attrs.get("height") != height:
            continue
        entries.append(
            {
                "t": float(s.get("start", 0.0)),
                "end": float(s.get("end", 0.0)),
                "kind": "span",
                "name": s["name"],
                "stage": STAGES.get(s["name"], s["name"].split(".")[0]),
                "node": str(attrs.get("node") or attrs.get("origin") or ""),
                "attrs": attrs,
            }
        )
    for e in events or []:
        if height is not None and e.get("height") != height:
            continue
        if height is None and trace_id is not None:
            continue  # flight events are height-scoped, not trace-scoped
        entries.append(
            {
                "t": float(e.get("t", 0.0)),
                "end": float(e.get("t", 0.0)),
                "kind": "event",
                "name": e.get("kind", ""),
                "stage": "flight",
                "node": str(e.get("node", "")),
                "attrs": {k: v for k, v in e.items() if k not in ("t", "kind")},
            }
        )
    entries.sort(key=lambda x: (x["t"], x["end"]))
    return {
        "trace_id": trace_id,
        "height": height,
        "entries": entries,
        "stages": sorted({x["stage"] for x in entries}),
        "nodes": sorted({x["node"] for x in entries if x["node"]}),
        "span_count": sum(1 for x in entries if x["kind"] == "span"),
        "event_count": sum(1 for x in entries if x["kind"] == "event"),
    }


def render_text(timeline: dict) -> str:
    entries = timeline["entries"]
    if not entries:
        return "(empty timeline)\n"
    t0 = entries[0]["t"]
    head = []
    if timeline.get("trace_id"):
        head.append(f"trace {timeline['trace_id']}")
    if timeline.get("height") is not None:
        head.append(f"height {timeline['height']}")
    lines = [
        " ".join(head) or "timeline",
        f"{len(entries)} entries, nodes: {', '.join(timeline['nodes']) or '-'}",
        "",
    ]
    for x in entries:
        dur_ms = (x["end"] - x["t"]) * 1e3
        attrs = " ".join(
            f"{k}={v}"
            for k, v in sorted(x["attrs"].items())
            if k not in ("trace", "node")
        )
        lines.append(
            f"+{(x['t'] - t0) * 1e3:10.3f}ms "
            f"{x['stage']:>10} {x['name']:<20} "
            f"{x['node'][:12]:<12} {dur_ms:8.3f}ms  {attrs}"
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--spans", nargs="+", default=[], help="span-log JSONL files (globs ok)"
    )
    ap.add_argument(
        "--flight", nargs="+", default=[], help="flight-recorder dump files (globs ok)"
    )
    ap.add_argument(
        "--launches",
        nargs="+",
        default=[],
        help="LaunchLedger JSONL files — device launches join the "
        "traced timeline (globs ok)",
    )
    ap.add_argument("--trace", default=None, help="hex trace id to follow")
    ap.add_argument("--height", type=int, default=None, help="height to replay")
    ap.add_argument("--json", action="store_true", help="emit JSON, not text")
    args = ap.parse_args(argv)
    if not args.spans and not args.flight and not args.launches:
        ap.error("need --spans, --flight, and/or --launches inputs")
    timeline = build_timeline(
        load_spans(args.spans) + load_launches(args.launches),
        load_flight(args.flight),
        trace_id=args.trace,
        height=args.height,
    )
    if args.json:
        json.dump(timeline, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_text(timeline))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
