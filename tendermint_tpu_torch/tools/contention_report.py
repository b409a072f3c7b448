"""Contention report: the whole-node on-CPU/blocked waterfall.

Merges the three legs of the contention observatory — profiler stack
samples (`telemetry/profiler.py`), ranked-lock wait/hold stats
(`utils/lockrank.py`), and the unified queue-wait table
(`telemetry/views.py`) — into one per-subsystem waterfall that answers
the question ROADMAP item 4 starts from: **which thread(s) must leave
the process first?**

    # against a live node (profiling armed via TENDERMINT_TPU_PROFILE_HZ)
    python -m tendermint_tpu_torch.tools.contention_report --rpc 127.0.0.1:26657

    # from a saved dump_telemetry?profile=1 JSON
    python -m tendermint_tpu_torch.tools.contention_report --dump dump.json

    # flamegraph input (collapsed-stack lines) on the side
    python -m tendermint_tpu_torch.tools.contention_report --rpc ... --collapsed out.collapsed

Output: a text waterfall (on-CPU vs blocked share per subsystem, with
the blocked-by reason split and the queue waits joined in), the
most-contended lock with its hottest acquire site, the dominant
blocked subsystem, and the verdict line naming the top on-CPU
subsystem as the first multi-process extraction candidate. `--json`
writes the structured report.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

# the subsystems a "leave the process" verdict can name — ambient
# buckets (main/other) aren't extraction candidates
_VERDICT_EXCLUDE = {"main", "other"}


def fetch_profile_rpc(addr: str, timeout: float = 30.0) -> dict:
    """dump_telemetry(profile=1) over JSON-RPC; returns the full dump
    (the `profile` key holds the observatory view)."""
    req = urllib.request.Request(
        f"http://{addr}/",
        data=json.dumps(
            {
                "jsonrpc": "2.0",
                "id": 1,
                "method": "dump_telemetry",
                "params": {"spans": 0, "profile": 1},
            }
        ).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.load(resp)
    if "error" in out:
        raise RuntimeError(out["error"])
    return out["result"]


def _profile_of(dump: dict) -> dict:
    """Accept a full dump_telemetry payload OR a bare profile view."""
    if "profile" in dump:
        return dump["profile"]
    if "profiler" in dump:
        return dump
    raise ValueError(
        "no profile view found — dump with profile=1 (and arm the "
        "profiler: TENDERMINT_TPU_PROFILE_HZ or a boost window)"
    )


def build_report(profile: dict) -> dict:
    """The structured report: per-subsystem waterfall rows + the three
    named answers (most-contended lock, dominant blocked subsystem,
    top on-CPU subsystem = the extraction verdict)."""
    prof = profile.get("profiler") or {}
    locks = (profile.get("locks") or {}).get("locks") or []
    queues = profile.get("queues") or {}
    subsystems = prof.get("subsystems") or {}

    rows = []
    total = sum(r["on_cpu"] + r["blocked"] for r in subsystems.values()) or 1
    for sub, r in subsystems.items():
        samples = r["on_cpu"] + r["blocked"]
        blocked_by = dict(
            sorted(
                (r.get("blocked_by") or {}).items(),
                key=lambda kv: kv[1],
                reverse=True,
            )
        )
        qsub = {
            "consensus": queues.get("consensus"),
            "ingress": queues.get("ingress"),
            "coalescer": queues.get("coalescer"),
            "dispatch": queues.get("dispatch"),
            "p2p_send": queues.get("p2p_send"),
        }.get(sub)
        rows.append(
            {
                "subsystem": sub,
                "samples": samples,
                "share_pct": round(100.0 * samples / total, 1),
                "on_cpu": r["on_cpu"],
                "blocked": r["blocked"],
                "on_cpu_pct": round(100.0 * r["on_cpu"] / samples, 1)
                if samples
                else 0.0,
                "blocked_by": blocked_by,
                "queue_waits": qsub or {},
            }
        )
    rows.sort(key=lambda r: r["samples"], reverse=True)

    most_contended = locks[0] if locks else None
    blocked_rows = [r for r in rows if r["blocked"] > 0]
    dominant_blocked = (
        max(blocked_rows, key=lambda r: r["blocked"]) if blocked_rows else None
    )
    cpu_rows = [
        r
        for r in rows
        if r["on_cpu"] > 0 and r["subsystem"] not in _VERDICT_EXCLUDE
    ]
    top_cpu = max(cpu_rows, key=lambda r: r["on_cpu"]) if cpu_rows else None
    total_cpu = sum(r["on_cpu"] for r in rows) or 1

    verdict = None
    if top_cpu is not None:
        verdict = {
            "move_out_first": top_cpu["subsystem"],
            "on_cpu_share_pct": round(
                100.0 * top_cpu["on_cpu"] / total_cpu, 1
            ),
            "reason": (
                f"{top_cpu['subsystem']} burns the largest on-CPU share "
                f"({round(100.0 * top_cpu['on_cpu'] / total_cpu, 1)}% of all "
                "on-CPU samples) under the shared GIL — first candidate "
                "to leave the process (ROADMAP item 4, multi-process "
                "node architecture)"
            ),
        }

    return {
        "samples": prof.get("samples", 0),
        "ticks": prof.get("ticks", 0),
        "hz": prof.get("hz"),
        "cpu_clock": prof.get("cpu_clock"),
        "waterfall": rows,
        "most_contended_lock": most_contended,
        "dominant_blocked_subsystem": (
            {
                "subsystem": dominant_blocked["subsystem"],
                "blocked": dominant_blocked["blocked"],
                "blocked_by": dominant_blocked["blocked_by"],
            }
            if dominant_blocked is not None
            else None
        ),
        "verdict": verdict,
        "threads": prof.get("threads") or {},
        "top_stacks": prof.get("top_stacks") or [],
    }


def _bar(pct: float, width: int = 20) -> str:
    filled = int(round(pct / 100.0 * width))
    return "#" * filled + "." * (width - filled)


def _fmt_blocked_by(blocked_by: dict, blocked: int) -> str:
    if not blocked_by or not blocked:
        return ""
    parts = [
        f"{reason or 'other'} {round(100.0 * n / blocked)}%"
        for reason, n in list(blocked_by.items())[:3]
    ]
    return ", ".join(parts)


def render_text(report: dict) -> str:
    """The operator-facing waterfall."""
    out = [
        "contention observatory — per-subsystem on-CPU vs blocked "
        f"({report['samples']} samples @ {report['hz']} Hz"
        + ("" if report.get("cpu_clock") else "; NO per-thread CPU clocks")
        + ")",
        "",
        f"{'subsystem':<12} {'samples':>7} {'share':>6} {'on-CPU':>7} "
        f"{'blocked':>7}  {'on-CPU%':>7} {'':20}  blocked-by",
    ]
    for r in report["waterfall"]:
        out.append(
            f"{r['subsystem']:<12} {r['samples']:>7} {r['share_pct']:>5.1f}% "
            f"{r['on_cpu']:>7} {r['blocked']:>7}  {r['on_cpu_pct']:>6.1f}% "
            f"{_bar(r['on_cpu_pct'])}  "
            f"{_fmt_blocked_by(r['blocked_by'], r['blocked'])}"
        )
        waits = r.get("queue_waits")
        if waits:
            for key, w in list(waits.items())[:4]:
                if not isinstance(w, dict) or "count" not in w:
                    continue
                label = f"queue[{key}]" if key else "queue"
                out.append(
                    f"{'':12} {label}: {w['count']} waits, "
                    f"p50 {w['p50_ms']} ms, p99 {w['p99_ms']} ms, "
                    f"total {w['total_s']} s"
                )
    out.append("")
    lock = report.get("most_contended_lock")
    if lock:
        site = (lock.get("top_sites") or [{}])[0]
        out.append(
            f"most-contended lock: {lock['lock']} — "
            f"{round(lock['wait_s'], 3)} s waited over {lock['wait_count']} "
            f"acquires (max {round(lock['wait_max_s'] * 1e3, 2)} ms), "
            f"{round(lock['hold_s'], 3)} s held"
            + (
                f"; hottest site {site.get('site')} ({site.get('count')} waits)"
                if site
                else ""
            )
        )
    else:
        out.append("most-contended lock: none recorded (lock timing disarmed?)")
    dom = report.get("dominant_blocked_subsystem")
    if dom:
        out.append(
            f"dominant blocked subsystem: {dom['subsystem']} "
            f"({dom['blocked']} blocked samples; "
            f"{_fmt_blocked_by(dom['blocked_by'], dom['blocked'])})"
        )
    verdict = report.get("verdict")
    if verdict:
        out.append(f"verdict: {verdict['reason']}")
    return "\n".join(out)


def collapsed_lines(profile_or_report: dict) -> list[str]:
    """Flamegraph collapsed-stack lines (`stack count`), from whichever
    shape the caller has (profile view, report, or profiler snapshot)."""
    prof = profile_or_report.get("profiler") or profile_or_report
    stacks = prof.get("top_stacks") or []
    items = sorted(
        ((s["stack"], s["count"]) for s in stacks),
        key=lambda kv: (-kv[1], kv[0]),
    )
    return [f"{stack} {count}" for stack, count in items]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--rpc", help="host:port of a live node's RPC listener")
    src.add_argument("--dump", help="saved dump_telemetry?profile=1 JSON file")
    ap.add_argument("--json", dest="json_out", default="", help="write the structured report here")
    ap.add_argument(
        "--collapsed",
        default="",
        help="write flamegraph collapsed-stack lines here",
    )
    args = ap.parse_args(argv)

    if args.rpc:
        dump = fetch_profile_rpc(args.rpc)
    else:
        with open(args.dump, "r", encoding="utf-8") as f:
            dump = json.load(f)
    profile = _profile_of(dump)
    report = build_report(profile)
    print(render_text(report))
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
        print(f"\nreport -> {args.json_out}")
    if args.collapsed:
        lines = collapsed_lines(profile)
        with open(args.collapsed, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        print(f"collapsed stacks -> {args.collapsed} ({len(lines)} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
