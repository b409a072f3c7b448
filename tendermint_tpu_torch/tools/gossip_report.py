"""Gossip report: the cross-node bandwidth waterfall + propagation map.

Merges N nodes' gossip-observatory dumps (`dump_telemetry?gossip=1` —
per-peer x per-channel x per-kind traffic tables, per-kind redundancy
counters, first-seen propagation stamps from `telemetry/gossiplog.py`)
into the per-channel bandwidth waterfall, the duplicate-delivery
redundancy ranking, and the region-to-region propagation latency matrix
(first-seen wall-clock deltas joined to `testing/topology.py`-style
placement labels), and **names the top waste source**. The network twin
of `tools/device_report.py`.

This is the measurement ROADMAP items 3/5/6 are judged against: vote
gossip that scales per-validator is exactly what item 3's aggregation
lane must collapse, the per-channel byte split is item 5's 1k-validator
scale budget, and the mempool/receipt fan-out numbers are item 6's cost
model.

    # against live nodes (one --rpc per node, placement optional)
    python -m tendermint_tpu_torch.tools.gossip_report --rpc 127.0.0.1:26657 \\
        --rpc 127.0.0.1:26660 --placement us-east,eu-west

    # from saved dump_telemetry JSON dumps
    python -m tendermint_tpu_torch.tools.gossip_report --dumps node*/gossip.json

Output: the per-channel waterfall (bytes + message split, % of fleet
total), the per-kind redundancy ranking (duplicate deliveries, wasted
bytes, delivered/useful factor), the propagation matrix, and the
fix-first verdict. `--json` writes the structured report.
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import json
import sys
import urllib.request

# waste sources the verdict can name, with the ROADMAP pointer each one
# implies at committee scale
_FIXES = {
    "vote_redundancy": (
        "votes are the top duplicated kind — per-validator vote gossip "
        "is the traffic class ROADMAP item 3's BLS/aggregation lane "
        "exists to collapse (one aggregate per round instead of N "
        "signatures x N peers); until then, tighten HasVote-driven "
        "suppression in the consensus reactor's gossip threads"
    ),
    "block_part_redundancy": (
        "block parts are re-shipped to holders — target part gossip by "
        "the peer's PartSet bitmap before pushing; this is the "
        "bandwidth line that dominates ROADMAP item 5's 1k-validator "
        "scenario budget"
    ),
    "tx_redundancy": (
        "peers cross-ship txs the dup-cache already holds — announce "
        "tx hashes before bodies (or track per-peer send sets); the "
        "same fan-out discipline ROADMAP item 6's receipt layer needs "
        "at millions-of-clients scale"
    ),
    "evidence_redundancy": (
        "the evidence rebroadcast routine re-offers pending batches "
        "flat-rate — back off per peer once acked; cheap, but it rides "
        "the same channel budget as item 5's scale target"
    ),
    "vote_bandwidth": (
        "no pathological duplication, but the vote channel still "
        "dominates fleet bytes — that is the per-validator scaling "
        "wall ROADMAP item 3's aggregation lane removes and item 5's "
        "1k-validator scenario will hit first"
    ),
    "data_bandwidth": (
        "block-part traffic dominates fleet bytes — raise part size / "
        "compress parts or gossip by bitmap; the item 5 scale budget "
        "is mostly this channel"
    ),
    "mempool_bandwidth": (
        "tx gossip dominates fleet bytes — batch tx frames and dedupe "
        "by announce; the fan-out cost model for ROADMAP item 6"
    ),
}

_CHANNEL_FIX = {
    "cns_vote": "vote_bandwidth",
    "cns_data": "data_bandwidth",
    "mempool": "mempool_bandwidth",
}

_KIND_FIX = {
    "vote": "vote_redundancy",
    "block_part": "block_part_redundancy",
    "tx": "tx_redundancy",
    "evidence": "evidence_redundancy",
}

# redundant-kind -> wire-kind join (evidence dedups per item, the wire
# ships lists)
_WIRE_KIND = {"evidence": "evidence_list"}


def fetch_gossip_rpc(addr: str, timeout: float = 30.0) -> dict:
    """dump_telemetry(gossip=1) over JSON-RPC; returns the gossip view."""
    req = urllib.request.Request(
        f"http://{addr}/",
        data=json.dumps(
            {
                "jsonrpc": "2.0",
                "id": 1,
                "method": "dump_telemetry",
                "params": {"spans": 0, "gossip": 1},
            }
        ).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.load(resp)
    if "error" in out:
        raise RuntimeError(out["error"])
    view = (out["result"] or {}).get("gossip") or {}
    return view


def load_dumps(paths: list[str]) -> list[dict]:
    """Read gossip views from saved JSON files: either a bare view (the
    `gossip` object) or a whole dump_telemetry result embedding one.
    Globs expand; unreadable/unparsable files are skipped."""
    out: list[dict] = []
    expanded: list[str] = []
    for p in paths:
        hits = sorted(glob_mod.glob(p))
        expanded.extend(hits if hits else [p])
    for path in expanded:
        try:
            with open(path, "r", encoding="utf-8") as f:
                dump = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(dump, dict):
            continue
        if "channels" in dump and "redundant" in dump:
            out.append(dump)
        elif isinstance(dump.get("gossip"), dict):
            out.append(dump["gossip"])
        elif isinstance(dump.get("result"), dict) and isinstance(
            dump["result"].get("gossip"), dict
        ):
            out.append(dump["result"]["gossip"])
    return out


def _node_label(view: dict, idx: int) -> str:
    return view.get("moniker") or (view.get("node_id") or f"node{idx}")[:12]


def build_report(views: list[dict], placement: list[str] | None = None) -> dict:
    """The structured report over N nodes' gossip views: the channel
    waterfall, the redundancy ranking, the propagation matrix, and the
    verdict naming the top waste source in wasted bytes.

    `placement` is the `testing/topology.py` region list, index-aligned
    with `views` (input order); without it every node is its own
    "region", so the matrix is node-to-node."""
    regions = [
        (placement[i] if placement and i < len(placement)
         else _node_label(v, i))
        for i, v in enumerate(views)
    ]

    chans: dict[str, dict] = {}
    kinds: dict[str, dict] = {}
    red: dict[str, dict] = {}
    for v in views:
        for c, st in (v.get("channels") or {}).items():
            agg = chans.setdefault(
                c, {"send_msgs": 0, "send_bytes": 0,
                    "recv_msgs": 0, "recv_bytes": 0},
            )
            for f in agg:
                agg[f] += st.get(f, 0)
        for k, st in (v.get("kinds") or {}).items():
            agg = kinds.setdefault(
                k, {"send_msgs": 0, "send_bytes": 0,
                    "recv_msgs": 0, "recv_bytes": 0},
            )
            for f in agg:
                agg[f] += st.get(f, 0)
        for k, st in (v.get("redundant") or {}).items():
            agg = red.setdefault(k, {"msgs": 0, "bytes": 0})
            agg["msgs"] += st.get("msgs", 0)
            agg["bytes"] += st.get("bytes", 0)

    total_bytes = sum(
        st["send_bytes"] + st["recv_bytes"] for st in chans.values()
    )

    redundancy = {}
    for k, st in red.items():
        wire = kinds.get(_WIRE_KIND.get(k, k), {})
        recv = wire.get("recv_msgs", 0)
        useful = recv - st["msgs"]
        if useful > 0:
            factor = round(recv / useful, 3)
        elif st["msgs"]:
            factor = float(st["msgs"] + 1)
        else:
            factor = 1.0
        redundancy[k] = {
            "redundant_msgs": st["msgs"],
            "redundant_bytes": st["bytes"],
            "recv_msgs": recv,
            "factor": factor,
        }

    # -- propagation matrix: first-seen deltas, origin = earliest stamp
    stamps: dict[str, list[tuple[int, float]]] = {}
    for i, v in enumerate(views):
        for key, t in (v.get("first_seen") or {}).items():
            stamps.setdefault(key, []).append((i, float(t)))
    cells: dict[tuple[str, str], list] = {}  # (from, to) -> [n, sum_ms, max_ms]
    merged_keys = 0
    for key, arr in stamps.items():
        if len(arr) < 2:
            continue
        merged_keys += 1
        origin_i, t0 = min(arr, key=lambda p: p[1])
        for i, t in arr:
            if i == origin_i:
                continue
            ms = (t - t0) * 1000.0
            cell = cells.setdefault((regions[origin_i], regions[i]), [0, 0.0, 0.0])
            cell[0] += 1
            cell[1] += ms
            cell[2] = max(cell[2], ms)
    propagation = {
        f"{a}->{b}": {
            "n": n,
            "mean_ms": round(s / n, 3),
            "max_ms": round(mx, 3),
        }
        for (a, b), (n, s, mx) in sorted(cells.items())
    }

    # -- verdict: wasted redundant bytes first; if nothing duplicates,
    # the hottest channel's concentration is the scaling story
    verdict = None
    if views:
        top_red = max(
            red.items(), key=lambda kv: kv[1]["bytes"], default=None
        )
        if top_red and top_red[1]["bytes"] > 0:
            source = _KIND_FIX.get(top_red[0], "vote_redundancy")
            cost = top_red[1]["bytes"]
        else:
            hot = max(
                chans.items(),
                key=lambda kv: kv[1]["send_bytes"] + kv[1]["recv_bytes"],
                default=None,
            )
            source = _CHANNEL_FIX.get(hot[0] if hot else "", "vote_bandwidth")
            cost = (
                hot[1]["send_bytes"] + hot[1]["recv_bytes"] if hot else 0
            )
        verdict = {
            "top_waste_source": source,
            "cost_bytes": cost,
            "fix_first": _FIXES[source],
            "reseed_note": (
                "re-run this report on the ROADMAP item 5 scaled "
                "scenario before and after the item 3 aggregation "
                "lane lands — the redundancy factors here are its "
                "before numbers"
            ),
        }
    return {
        "nodes": len(views),
        "regions": regions,
        "total_bytes": total_bytes,
        "channels": chans,
        "kinds": kinds,
        "redundancy": redundancy,
        "propagation": propagation,
        "propagation_keys_merged": merged_keys,
        "verdict": verdict,
    }


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n}B"


def render_text(report: dict) -> str:
    """The operator-facing waterfall + matrix + verdict."""
    out = [
        f"gossip observatory — {report['nodes']} node(s), "
        f"{_fmt_bytes(report['total_bytes'])} on the wire "
        f"(regions: {', '.join(dict.fromkeys(report['regions'])) or '-'})",
        "",
        "per-channel bandwidth waterfall:",
        f"{'channel':<14} {'sent':>10} {'recvd':>10} {'msgs':>9} {'share%':>7}",
    ]
    total = max(report["total_bytes"], 1)
    for c, st in sorted(
        report["channels"].items(),
        key=lambda kv: -(kv[1]["send_bytes"] + kv[1]["recv_bytes"]),
    ):
        both = st["send_bytes"] + st["recv_bytes"]
        out.append(
            f"{c:<14} {_fmt_bytes(st['send_bytes']):>10} "
            f"{_fmt_bytes(st['recv_bytes']):>10} "
            f"{st['send_msgs'] + st['recv_msgs']:>9} "
            f"{100.0 * both / total:>6.1f}%"
        )
    out.append("")
    out.append("redundancy ranking (duplicate deliveries dedup'd on arrival):")
    if report["redundancy"]:
        out.append(
            f"{'kind':<12} {'dup msgs':>9} {'dup bytes':>10} "
            f"{'recv msgs':>10} {'factor':>7}"
        )
        for k, st in sorted(
            report["redundancy"].items(),
            key=lambda kv: -kv[1]["redundant_bytes"],
        ):
            out.append(
                f"{k:<12} {st['redundant_msgs']:>9} "
                f"{_fmt_bytes(st['redundant_bytes']):>10} "
                f"{st['recv_msgs']:>10} {st['factor']:>6.2f}x"
            )
    else:
        out.append("  (no duplicate deliveries recorded)")
    out.append("")
    out.append(
        "propagation (origin region -> region, first-seen deltas over "
        f"{report['propagation_keys_merged']} merged keys):"
    )
    if report["propagation"]:
        for pair, st in report["propagation"].items():
            out.append(
                f"  {pair:<28} mean {st['mean_ms']:>8.1f}ms  "
                f"max {st['max_ms']:>8.1f}ms  (n={st['n']})"
            )
    else:
        out.append(
            "  (no cross-node stamps merged — need >= 2 nodes' dumps "
            "covering the same heights)"
        )
    verdict = report.get("verdict")
    out.append("")
    if verdict:
        out.append(
            f"verdict: top waste source is {verdict['top_waste_source']} "
            f"({_fmt_bytes(verdict['cost_bytes'])}) — {verdict['fix_first']}"
        )
        out.append(f"         {verdict['reseed_note']}")
    else:
        out.append("verdict: no gossip views collected (rollup sampled out?)")
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
        "--dumps",
        nargs="+",
        default=[],
        help="saved dump_telemetry JSON files / bare gossip views (globs ok)",
    )
    ap.add_argument(
        "--placement",
        default="",
        help="comma-separated region labels, index-aligned with the "
        "inputs (--rpc first, then --dumps) — the testing/topology.py "
        "placement list; default: per-node labels",
    )
    ap.add_argument(
        "--json", dest="json_out", default="", help="write the structured report here"
    )
    args = ap.parse_args(argv)
    if not args.rpc and not args.dumps:
        ap.error("need --rpc and/or --dumps inputs")

    views: list[dict] = []
    for addr in args.rpc:
        views.append(fetch_gossip_rpc(addr))
    views.extend(load_dumps(args.dumps))
    placement = (
        [r.strip() for r in args.placement.split(",") if r.strip()]
        if args.placement
        else None
    )
    report = build_report(views, placement)
    print(render_text(report))
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
        print(f"\nreport -> {args.json_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
