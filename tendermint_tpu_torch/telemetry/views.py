"""Dump-only high-cardinality views: ONE convention, one code path.

The exported metric catalog is low-cardinality **by construction**
(docs/OBSERVABILITY.md "Label conventions"): never peer ids, heights,
thread names, or code sites. But operators still need those details —
which peer's send queue is backed up, which validator's votes lag,
which code site waits on which lock. The convention (documented in
docs/OBSERVABILITY.md "Dump-only views"):

* anything keyed by an unbounded identity (peer id, thread name, lock
  site) is served ONLY through the `dump_telemetry` JSON RPC, never as
  an exported series;
* every such view is a named builder registered HERE, so
  `rpc/core.py` has one code path instead of one ad-hoc stanza per
  view, and the convention is greppable;
* builders read node-local/process state at dump time, return `None`
  to omit themselves (stub nodes without a switch, profiler disarmed),
  and must never raise — a forensic dump can't fail because one
  subsystem is mid-teardown.

Views: `p2p` (per-peer send queues + misbehavior scores),
`vote_arrivals` (per-peer laggard rollup), `profile` (the contention
observatory: profiler snapshot + top-contended locks + the unified
queue-wait table), `launches` (the device observatory: per-launch
ledger records + per-kind rollup, behind `dump_telemetry?launches=N`).

The port's copy of `tendermint_tpu/telemetry/views.py`. The `launches`
view reads the port's `LAUNCHLOG`, the `profile` view the port's
profiler and lock-rank contention table.
"""

from __future__ import annotations

import math
from typing import Callable

VIEWS: dict[str, Callable] = {}


def view(name: str):
    def deco(fn):
        VIEWS[name] = fn
        return fn

    return deco


def collect(node, names) -> dict:
    """{name: built view} for every requested view that applies; an
    unknown name or a raising/None builder is silently omitted (dumps
    degrade, never fail). An entry may be `(name, kwargs)` to pass
    builder parameters (the `launches=N` window size)."""
    out = {}
    for name in names:
        kwargs = {}
        if isinstance(name, tuple):
            name, kwargs = name
        fn = VIEWS.get(name)
        if fn is None:
            continue
        try:
            val = fn(node, **kwargs)
        except Exception:
            continue
        if val is not None:
            out[name] = val
    return out


# -- the views ----------------------------------------------------------------


@view("p2p")
def _p2p_view(node) -> dict | None:
    """Per-peer send-queue depths + misbehavior scores (peer-id
    cardinality — the exported gauges only carry the sum and max)."""
    switch = getattr(node, "switch", None)
    if switch is None:
        return None
    return {
        "send_queues": switch.send_queue_depths(),
        # misbehavior scores + live bans (docs/BYZANTINE.md); absent on
        # stub switches without a scorer
        "misbehavior": (
            switch.scorer.snapshot()
            if getattr(switch, "scorer", None) is not None
            else {}
        ),
    }


@view("vote_arrivals")
def _vote_arrivals_view(node) -> dict | None:
    """Per-peer vote-arrival rollup (the laggard signal
    tools/finality_report.py consumes)."""
    arrivals = getattr(getattr(node, "consensus", None), "vote_arrivals", None)
    if arrivals is None:
        return None
    return arrivals.snapshot()


@view("gossip")
def _gossip_view(node) -> dict | None:
    """The gossip observatory (opt-in, `gossip=1`): the switch-owned
    GossipRollup snapshot — per-peer × per-channel × per-kind traffic
    tables, per-kind redundancy counters, and first-seen propagation
    stamps. Per-peer and per-height detail lives ONLY here (dump-only
    cardinality); `tools/gossip_report.py` merges dumps across nodes
    into the bandwidth waterfall + propagation matrix."""
    gossip = getattr(getattr(node, "switch", None), "gossip", None)
    if gossip is None:
        return None
    snap = gossip.snapshot()
    snap["redundancy_factor"] = gossip.redundancy_factors()
    # join the consensus node id so cross-node merges can label rows
    # even when dumps are collected from files rather than RPC
    info = getattr(getattr(node, "switch", None), "node_info", None)
    if info is not None:
        snap["node_id"] = info.node_id
        snap["moniker"] = info.moniker
    return snap


@view("launches")
def _launches_view(node, n: int = 128) -> dict:
    """The device observatory (opt-in, `launches=N`): the newest N
    LaunchLedger records — one per device launch, with backend, mesh
    width, useful/padded/cached rows, stage durations, transfer bytes,
    compile-cache disposition, consumer mix, and the exemplar trace id —
    plus the per-kind rollup `tools/device_report.py` renders. The
    ledger is process-wide (the launch-producing stacks are process
    singletons), like the `profile` view's profiler."""
    from tendermint_tpu_torch.telemetry import launchlog

    records = launchlog.LAUNCHLOG.recent(max(1, int(n)))
    return {
        "records": records,
        "summary": launchlog.summarize(records),
    }


@view("profile")
def _profile_view(node) -> dict:
    """The contention observatory: sampler snapshot (per-subsystem
    on-CPU/blocked + per-thread table), top-contended ranked locks with
    site attribution, and every queue wait the node measures folded
    into one table (`tools/contention_report.py` input)."""
    from tendermint_tpu_torch.telemetry.profiler import PROFILER
    from tendermint_tpu_torch.utils import lockrank

    return {
        "profiler": PROFILER.snapshot(top_stacks=50),
        "locks": lockrank.contention_snapshot(),
        "queues": queue_wait_summary(node),
    }


# -- queue-wait unification ---------------------------------------------------


def _quantile(snap: dict, q: float) -> float:
    """histogram_quantile over one snapshot dict (the registry child's
    interpolation, usable on `samples()` output)."""
    if snap["count"] == 0:
        return float("nan")
    rank = q * snap["count"]
    prev_ub, prev_cum = 0.0, 0
    for ub, cum in snap["buckets"]:
        if cum >= rank:
            if ub == math.inf or ub == "+Inf":
                return prev_ub
            width = float(ub) - prev_ub
            in_bucket = cum - prev_cum
            if in_bucket == 0:
                return float(ub)
            return prev_ub + width * (rank - prev_cum) / in_bucket
        prev_ub, prev_cum = float(ub) if ub != "+Inf" else prev_ub, cum
    return prev_ub


def _hist_rows(name: str) -> dict[str, dict]:
    """label-tuple -> {count, total_s, p50_ms, p99_ms} for one
    histogram family ('' key for the unlabeled child)."""
    from tendermint_tpu_torch.telemetry import REGISTRY

    fam = REGISTRY.get(name)
    if fam is None:
        return {}
    out: dict[str, dict] = {}
    for values, snap in fam.samples():
        if not isinstance(snap, dict) or snap.get("count", 0) == 0:
            continue
        key = "/".join(values) if values else ""
        out[key] = {
            "count": snap["count"],
            "total_s": round(snap["sum"], 6),
            "p50_ms": round(_quantile(snap, 0.5) * 1e3, 3),
            "p99_ms": round(_quantile(snap, 0.99) * 1e3, 3),
        }
    return out


def queue_wait_summary(node=None) -> dict:
    """Every queue wait the node already measures, one table: dispatch
    launch queues, coalescer windows (per consumer), mempool ingress
    admission, the consensus msg-queue drain, and p2p send queues —
    the subsystem keys line up with the profiler vocabulary so the
    report can join them."""
    out = {
        "dispatch": _hist_rows("tendermint_dispatch_queue_wait_seconds"),
        "coalescer": _hist_rows("tendermint_batcher_wait_seconds"),
        "ingress": _hist_rows("tendermint_mempool_admission_seconds"),
        "consensus": {
            k: v
            for k, v in _hist_rows("tendermint_vote_stage_seconds").items()
            if k == "drain"
        },
        "p2p_send": _hist_rows("tendermint_p2p_send_wait_seconds"),
    }
    # live depths complete the wait picture (a deep-but-fast queue and
    # a shallow-but-slow one read very differently)
    depths: dict[str, object] = {}
    switch = getattr(node, "switch", None)
    if switch is not None:
        try:
            depths["p2p_send_frames"] = switch.send_queue_depth_total()
        except Exception:
            pass
    mem = getattr(node, "mempool", None)
    batcher = getattr(mem, "_ingress", None)
    if batcher is not None and hasattr(batcher, "stats"):
        try:
            depths["ingress"] = batcher.stats()
        except Exception:
            pass
    verifier = getattr(getattr(node, "consensus", None), "verifier", None)
    if verifier is not None and hasattr(verifier, "stats"):
        try:
            depths["coalescer"] = verifier.stats()
        except Exception:
            pass
    if depths:
        out["depths"] = depths
    return out
