"""Health / readiness snapshot + rolling finality SLO.

The machine-readable signal ROADMAP item 1's read-replica fleet sits
behind: one structured dict (served as `GET /health` on the RPC
listener and as the `health` JSON-RPC method) that folds the telemetry
the node already keeps into three states:

* **ok** — serving, all checks green;
* **degraded** — serving, but something an operator should look at is
  wrong: a circuit breaker is off `closed` (device crypto degraded to
  host), the verify mesh is running on survivors, the peer count is
  below the floor, or commits have stalled past the lag ceiling;
* **not_ready** — do not route traffic here: the node is still
  fast-syncing / state-syncing, or its consensus loop halted on a
  fatal error. `GET /health` maps this to HTTP 503 so any off-the-shelf
  load balancer can act on it without parsing the body.

Everything is derived from NODE-LOCAL objects (the node's own breaker
snapshots, its switch's peer count, its HeightLedger) — never from the
process-global registry, so the multi-node-in-process harnesses get
per-node answers.

The **finality SLO** section evaluates the rolling window of
commit-to-commit gaps from the height ledger against a p99 target and
reports error-budget burn (breaches / allowed breaches). It is
deliberately *reported, not folded into the status*: an SLO breach is
an alerting decision, and a load balancer yanking a replica because the
whole chain was slow would make the incident worse, not better.

An exhausted error budget additionally **arms the trace-sampling
boost window** (`telemetry/tracectx.boost()`) — the same reflex a
breaker trip or mesh re-mesh has: the moment the chain is visibly slow
is exactly when an operator wants per-message attribution, so the next
`TENDERMINT_TPU_SLO_BOOST_S` seconds sample every trace context. The
status itself still doesn't change (see above).

The **device** section (device observatory, telemetry/launchlog.py) is
reported under the same discipline: mesh width active/total, a
compile-in-progress flag, and seconds since the last successful device
launch — operator signals, never folded into the routing status.

The **pipeline** section (cross-height pipelined consensus,
consensus/state.py) follows suit: whether height H's apply is in
flight under H+1's voting right now, join-barrier stall counts, and
the apply overlap won — reported, never folded.

Knobs (env):
  TENDERMINT_TPU_FINALITY_SLO_P99_S  p99 finality target, seconds (1.0)
  TENDERMINT_TPU_SLO_WINDOW          heights in the rolling window (64)
  TENDERMINT_TPU_SLO_BUDGET          allowed breach fraction (0.01)
  TENDERMINT_TPU_SLO_BOOST_S         trace-boost window on budget
                                     exhaustion, seconds (30; 0 off)
  TENDERMINT_TPU_HEALTH_MIN_PEERS    peer floor before degraded (1)
  TENDERMINT_TPU_HEALTH_MAX_LAG_S    commit-age ceiling, seconds (60)
  TENDERMINT_TPU_HEALTH_MAX_TIP_LAG  heights a follow-mode replica may
                                     trail the peer tip and stay ready (8)

The **serving** section (light-client layer, lightclient/reactor.py)
appears on nodes running the 0x68 serving reactor: FullCommit-cache
warmth, proof-serving lag behind the chain tip, and subscription
liveness — reported, never folded, with one deliberate exception: a
follow-mode REPLICA's readiness comes from the tip-lag rule above (a
replica serving stale heights must not take read traffic, and that IS
a routing decision).

The port's copy of `tendermint_tpu/telemetry/health.py`. The device
section reads the port's `LAUNCHLOG` and, when something already loaded
it, the port's `parallel/mesh.py`.
"""

from __future__ import annotations

import math
import os
import time


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _pctl(sorted_vals: list[float], q: float) -> float | None:
    """Nearest-rank percentile over raw samples (empirical, not bucket
    interpolation — the window is small and exact)."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


def _breaker_check(node) -> dict:
    """Every breaker snapshot reachable from this node's verify/hash
    services (the same objects `dump_telemetry` serves): ok iff all
    report state == closed."""
    states: dict[str, str] = {}
    for name, svc in (
        ("verifier", getattr(getattr(node, "consensus", None), "verifier", None)),
        ("hasher", getattr(node, "hasher", None)),
    ):
        if svc is None or not hasattr(svc, "snapshot"):
            continue
        try:
            snap = svc.snapshot()
        except Exception:
            continue
        state = snap.get("state")
        if state is not None:
            states[name] = str(state)
    return {"ok": all(s == "closed" for s in states.values()), "states": states}


def _mesh_check(node) -> dict:
    """Sharded-mesh degradation from the verifier snapshot: active <
    total means the mesh is running on survivors (re-mesh absorbed a
    chip loss below the breaker). Nodes without a mesh are trivially
    ok."""
    svc = getattr(getattr(node, "consensus", None), "verifier", None)
    snap = {}
    if svc is not None and hasattr(svc, "snapshot"):
        try:
            snap = svc.snapshot() or {}
        except Exception:
            snap = {}
    mesh = snap.get("mesh")
    if not isinstance(mesh, dict):
        return {"ok": True, "present": False}
    active = int(mesh.get("devices_active", 0))
    total = int(mesh.get("devices_total", 0))
    return {
        "ok": active >= total,
        "present": True,
        "devices_active": active,
        "devices_total": total,
    }


def _device_section(node) -> dict:
    """The device observatory's health view: mesh width (active/total
    from the verifier snapshot — the same node-local object the mesh
    check reads), whether a compiled-step build is in flight right now,
    and the age of the last successful device launch. REPORTED, never
    folded into the status (same discipline as the finality SLO): a
    compile stall or a quiet device is an operator signal, not a
    load-balancer eviction. The compile flag and launch age read the
    process-wide mesh/step-cache and LaunchLedger — the device stack is
    a process singleton, so in multi-node-in-process harnesses they are
    shared across nodes (documented approximation)."""
    svc = getattr(getattr(node, "consensus", None), "verifier", None)
    snap = {}
    if svc is not None and hasattr(svc, "snapshot"):
        try:
            snap = svc.snapshot() or {}
        except Exception:
            snap = {}
    mesh = snap.get("mesh") if isinstance(snap.get("mesh"), dict) else {}
    out: dict = {
        "mesh_active": int(mesh.get("devices_active", 0)) if mesh else None,
        "mesh_total": int(mesh.get("devices_total", 0)) if mesh else None,
    }
    try:
        # consult the mesh module only if something already loaded it:
        # importing it here would drag the kernel modules into a
        # host-only node's health probe (seconds of import on first
        # touch) — and an unloaded mesh module means no compiles exist
        import sys as _sys

        _mesh = _sys.modules.get("tendermint_tpu_torch.parallel.mesh")
        out["compile_in_progress"] = (
            _mesh.compiles_in_progress() > 0 if _mesh is not None else False
        )
    except Exception:
        out["compile_in_progress"] = False
    try:
        from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG

        age = LAUNCHLOG.seconds_since_success()
        out["last_launch_age_s"] = round(age, 3) if age is not None else None
    except Exception:
        out["last_launch_age_s"] = None
    return out


def _pipeline_section(consensus) -> dict:
    """Cross-height pipeline state (consensus/state.py pipelined
    finalize), REPORTED under the same never-folded discipline as the
    SLO and device sections: whether an apply is in flight right now,
    how often the join barrier actually stalled H+1 on H's apply, and
    the overlap won. A stall-heavy pipeline is a tuning signal (the
    apply dominates the height), not a routing decision."""
    out: dict = {
        "enabled": bool(getattr(consensus, "pipeline_enabled", False)),
        "apply_in_flight": getattr(consensus, "_pending_apply", None) is not None,
    }
    stats = getattr(consensus, "pipeline_stats", None)
    if isinstance(stats, dict):
        joins = stats.get("joins", 0)
        out.update(
            {
                "joins": joins,
                "stalls": stats.get("stalls", 0),
                "valset_rebuilds": stats.get("valset_rebuilds", 0),
                "last_overlap_ms": round(stats.get("last_overlap_s", 0.0) * 1e3, 3),
                "overlap_ms_mean": round(
                    stats.get("overlap_s_total", 0.0) / joins * 1e3, 3
                )
                if joins
                else None,
            }
        )
    return out


def _serving_section(node) -> dict | None:
    """Light-client serving view (lightclient/reactor.py): cache
    warmth, proof-serving lag, subscription liveness. REPORTED under
    the same never-folded discipline as the SLO/device/pipeline
    sections — replica readiness is the sync check's tip-lag rule, not
    this. None on nodes without the serving layer (harness stubs)."""
    reactor = getattr(node, "lightclient_reactor", None)
    if reactor is None or not hasattr(reactor, "serving_stats"):
        return None
    try:
        out = reactor.serving_stats()
    except Exception:
        return None
    out["replica"] = bool(getattr(node, "is_replica", False))
    return out


def _gossip_section(node) -> dict | None:
    """Gossip observatory headline (telemetry/gossiplog.py): the top
    redundant message kind and the hottest channel by bytes. REPORTED,
    never folded — over-gossip wastes bandwidth, it doesn't make a node
    unready (scenario expectations and the bench floor are where
    redundancy bounds get enforced). None without a switch (harness
    stubs) or with the rollup sampled out."""
    gossip = getattr(getattr(node, "switch", None), "gossip", None)
    if gossip is None:
        return None
    try:
        out = gossip.headline()
    except Exception:
        return None
    return out if out.get("enabled") else None


def build_health(node, ledger=None) -> dict:
    """The health snapshot for one composed node (`node.Node` or
    anything duck-typed close enough — every read is getattr-tolerant,
    so harness stubs work)."""
    target = _env_float("TENDERMINT_TPU_FINALITY_SLO_P99_S", 1.0)
    window_n = int(_env_float("TENDERMINT_TPU_SLO_WINDOW", 64))
    budget_frac = _env_float("TENDERMINT_TPU_SLO_BUDGET", 0.01)
    min_peers = int(_env_float("TENDERMINT_TPU_HEALTH_MIN_PEERS", 1))
    max_lag = _env_float("TENDERMINT_TPU_HEALTH_MAX_LAG_S", 60.0)

    consensus = getattr(node, "consensus", None)
    if ledger is None:
        ledger = getattr(node, "height_ledger", None)
    if ledger is None:
        ledger = getattr(consensus, "height_ledger", None)

    # -- readiness ---------------------------------------------------------
    bc = getattr(node, "blockchain_reactor", None)
    follow = bool(getattr(bc, "follow", False))
    catching_up = bool(getattr(bc, "fast_sync", False)) and not follow
    ss = getattr(node, "statesync_reactor", None)
    state_syncing = bool(getattr(ss, "sync", False)) and (
        getattr(ss, "restored_state", None) is None
    )
    fatal = getattr(consensus, "fatal_error", None)
    checks: dict[str, dict] = {
        "consensus": {
            "ok": fatal is None,
            "fatal": type(fatal).__name__ if fatal is not None else None,
        },
        "sync": {
            "ok": not (catching_up or state_syncing),
            "fast_sync": catching_up,
            "state_sync": state_syncing,
        },
    }
    if follow:
        # follow-mode replicas stay in fast-sync FOREVER, so readiness
        # is distance from the best-known peer tip, not the flag: a
        # replica serving heights far behind the chain must not take
        # read traffic (TENDERMINT_TPU_HEALTH_MAX_TIP_LAG heights).
        max_tip_lag = int(_env_float("TENDERMINT_TPU_HEALTH_MAX_TIP_LAG", 8))
        try:
            tip_lag = int(bc.tip_lag())
        except Exception:
            tip_lag = 0
        checks["sync"] = {
            "ok": not state_syncing and tip_lag <= max_tip_lag,
            "fast_sync": False,
            "state_sync": state_syncing,
            "follow": True,
            "tip_lag": tip_lag,
            "max_tip_lag": max_tip_lag,
        }

    # -- degradation -------------------------------------------------------
    checks["breakers"] = _breaker_check(node)
    checks["mesh"] = _mesh_check(node)
    switch = getattr(node, "switch", None)
    n_peers = switch.n_peers() if switch is not None else 0
    checks["peers"] = {"ok": n_peers >= min_peers, "count": n_peers, "min": min_peers}

    last = ledger.last() if ledger is not None else None
    lag_s = None
    if last is not None and isinstance(last.get("t_commit"), (int, float)):
        lag_s = max(0.0, time.time() - last["t_commit"])
    checks["commit_lag"] = {
        # no records yet = not enough data to call it stalled (a node
        # that is genuinely behind shows up in the sync check instead)
        "ok": lag_s is None or catching_up or lag_s <= max_lag,
        "lag_s": round(lag_s, 3) if lag_s is not None else None,
        "max_s": max_lag,
    }

    # -- finality SLO (reported, never folded into status) -----------------
    gaps = sorted(ledger.finality_window(window_n)) if ledger is not None else []
    breaches = sum(1 for g in gaps if g > target)
    budget = max(1.0, budget_frac * len(gaps)) if gaps else 1.0
    burn = breaches / budget
    slo = {
        "target_p99_s": target,
        "window": len(gaps),
        "p50_s": round(_pctl(gaps, 0.5), 6) if gaps else None,
        "p99_s": round(_pctl(gaps, 0.99), 6) if gaps else None,
        "breaches": breaches,
        "error_budget": round(budget, 3),
        "budget_burn": round(burn, 3),
        "ok": burn <= 1.0,
    }
    # budget exhausted -> light up tracing, the same reflex breaker
    # trips and mesh re-meshes have (tracectx.boost): the slow window
    # is when per-message attribution pays for itself. Reported, so an
    # operator reading the snapshot knows sampling is boosted.
    if gaps and not slo["ok"]:
        boost_s = _env_float("TENDERMINT_TPU_SLO_BOOST_S", 30.0)
        if boost_s > 0:
            from tendermint_tpu_torch.telemetry import tracectx

            tracectx.boost(boost_s)
            slo["trace_boosted"] = True

    not_ready = not (checks["consensus"]["ok"] and checks["sync"]["ok"])
    degraded = not all(
        checks[k]["ok"] for k in ("breakers", "mesh", "peers", "commit_lag")
    )
    status = "not_ready" if not_ready else ("degraded" if degraded else "ok")
    store = getattr(node, "block_store", None)
    out = {
        "status": status,
        "ready": not not_ready,
        "node_id": getattr(node, "node_id", ""),
        "height": getattr(store, "height", 0) if store is not None else 0,
        "catching_up": catching_up or state_syncing,
        "checks": checks,
        "finality_slo": slo,
        # device observatory (reported, not folded into status — the
        # mesh *degradation* check above is what can mark degraded)
        "device": _device_section(node),
        # cross-height pipeline (reported, never folded: a stalling
        # pipeline is slower finality, which the SLO section owns)
        "pipeline": _pipeline_section(consensus),
    }
    # light-client serving layer (reported, never folded — with ONE
    # exception: the follow-mode tip-lag check above, which IS the
    # replica's readiness): FullCommit-cache warmth, proof-serving lag
    # behind the chain tip, subscription liveness.
    serving = _serving_section(node)
    if serving is not None:
        out["serving"] = serving
    # gossip observatory headline (reported, never folded): top
    # redundant kind + hottest channel — the full tables are dump-only
    # (`dump_telemetry?gossip=1`).
    gossip = _gossip_section(node)
    if gossip is not None:
        out["gossip"] = gossip
    return out
