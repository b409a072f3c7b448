"""The port's metric catalog: the series the verify spine exports, under
the JAX package's names and label sets (`tendermint_tpu/telemetry/metrics.py`),
registered at import into the port's own `REGISTRY`.

Label values are low-cardinality by construction: `backend` in {host,
device, tables, mesh}, `kind` in {verify, hash, tables}, `queue` and
`consumer` the pipeline owners, `direction` in {shrink, restore},
`result` in {hit, miss}, `state` in {useful, padded, cached}, `mode` in
{sequential, bisect}, `stage` the dispatch-handle stages, `lock` the
ranked-lock names of `utils/lockrank.py`.
"""

from __future__ import annotations

from tendermint_tpu_torch.telemetry.registry import (
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
)

# -- device dispatch (verify / hash hot paths) --------------------------------

VERIFY_BATCH_SIZE = Histogram(
    "tendermint_verify_batch_size",
    "ed25519 signatures per verify call, by executing backend",
    labelnames=("backend",),
    buckets=SIZE_BUCKETS,
)
VERIFY_SECONDS = Histogram(
    "tendermint_verify_seconds",
    "ed25519 verify call latency, by executing backend",
    labelnames=("backend",),
    buckets=LATENCY_BUCKETS,
)
HASH_BATCH_LEAVES = Histogram(
    "tendermint_hash_batch_leaves",
    "Merkle leaves per root build, by executing backend",
    labelnames=("backend",),
    buckets=SIZE_BUCKETS,
)
HASH_SECONDS = Histogram(
    "tendermint_hash_seconds",
    "Merkle root build latency, by executing backend",
    labelnames=("backend",),
    buckets=LATENCY_BUCKETS,
)
TABLE_CACHE = Counter(
    "tendermint_verify_table_cache_total",
    "Valset comb-table cache outcomes (hit/miss/incremental/host_build)",
    labelnames=("event",),
)

# -- launch ledger (telemetry/launchlog.py) ------------------------------------
#
# `state` splits the rows of a device launch into useful (requested),
# padded (bucket or mesh geometry zeros shipped to the card) and cached
# (rows the verified-signature cache withheld from the launch); `stage`
# is the handle-lifecycle split. Per-launch detail lives in the ledger's
# records, never as labels.

LAUNCH_ROWS = Counter(
    "tendermint_launch_rows",
    "Rows per device launch by disposition: useful (requested), padded "
    "(shape-bucket zeros shipped to device), cached (withheld by the "
    "verified-signature cache) — occupancy = useful / (useful + padded)",
    labelnames=("kind", "state"),
)
LAUNCH_STAGE_SECONDS = Histogram(
    "tendermint_launch_stage_seconds",
    "Per-launch stage durations from the dispatch-handle lifecycle: "
    "queue_wait (submit -> launch start), host_prep (lane prep + kernel "
    "dispatch), in_flight (enqueued on device -> consumer join), "
    "finalize (materialization blocking the consumer)",
    labelnames=("stage",),
    buckets=LATENCY_BUCKETS,
)
# byte-sized buckets: 1 KiB floor (a small lane batch) to 1 GiB, x4 per step
TRANSFER_BUCKETS = tuple(float(1024 * 4**i) for i in range(11))
LAUNCH_TRANSFER_BYTES = Histogram(
    "tendermint_launch_transfer_bytes",
    "Host->device bytes shipped per launch (lane arrays, padded hash "
    "blocks, sharded-table device_put on placement-cache misses)",
    buckets=TRANSFER_BUCKETS,
)

# -- multi-card verify mesh (parallel/mesh.py) ---------------------------------
#
# `direction` is the re-mesh kind: "shrink" (shard fault -> survivors)
# or "restore" (re-probe brought the full mesh back).

MESH_DEVICES = Gauge(
    "tendermint_mesh_devices",
    "Devices currently active in the sharded verify/hash mesh",
)
MESH_SHARD_FAULTS = Counter(
    "tendermint_mesh_shard_faults_total",
    "Per-shard device faults observed by mesh launches",
)
MESH_REMESH = Counter(
    "tendermint_mesh_remesh_total",
    "Mesh rebuilds (shrink = onto survivors after a shard fault, "
    "restore = full mesh back after a successful re-probe)",
    labelnames=("direction",),
)
MESH_COMPILE = Counter(
    "tendermint_mesh_compile_total",
    "Mesh step-cache lookups by outcome: a miss is the first use of a "
    "device set, which warms every card of it not yet warmed",
    labelnames=("result",),
)
MESH_COMPILE_SECONDS = Histogram(
    "tendermint_mesh_compile_seconds",
    "Wall time one step-cache miss spent warming its device set (the "
    "launch that pays it stalls for the duration)",
    buckets=LATENCY_BUCKETS,
)
TABLE_DEVICE_CACHE = Counter(
    "tendermint_table_device_cache_total",
    "Per-(valset, device-set) sharded-table placement cache outcomes; "
    "a miss slices the comb tables and copies each shard's columns to "
    "its card",
    labelnames=("result",),
)

# -- resilient dispatch / circuit breaker -------------------------------------

BREAKER_STATE = Gauge(
    "tendermint_breaker_state",
    "Circuit breaker state (0=closed, 1=half_open, 2=open)",
    labelnames=("kind",),
)
BREAKER_TRANSITIONS = Counter(
    "tendermint_breaker_transitions_total",
    "Breaker state transitions; to=open counts trips, to=closed recoveries",
    labelnames=("kind", "to"),
)
DISPATCH_PRIMARY = Counter(
    "tendermint_device_primary_calls_total",
    "Calls answered by the primary (device) backend",
    labelnames=("kind",),
)
DISPATCH_FALLBACK = Counter(
    "tendermint_device_fallback_calls_total",
    "Calls degraded to the host fallback",
    labelnames=("kind",),
)
DISPATCH_FAILURES = Counter(
    "tendermint_device_dispatch_failures_total",
    "Primary dispatch attempts that raised (pre-retry granularity)",
    labelnames=("kind",),
)

# -- async dispatch pipeline (services/dispatch.py) ---------------------------

DISPATCH_INFLIGHT = Gauge(
    "tendermint_dispatch_inflight",
    "Launches submitted to a dispatch queue and not yet joined",
    labelnames=("queue",),
)
DISPATCH_QUEUE_WAIT = Histogram(
    "tendermint_dispatch_queue_wait_seconds",
    "Time a launch waited in the dispatch queue before starting",
    labelnames=("queue",),
    buckets=LATENCY_BUCKETS,
)
# Per-handle share of submit->join wall time the consumer spent doing
# other work instead of blocked in result(): 0 = fully synchronous.
DISPATCH_OVERLAP = Histogram(
    "tendermint_dispatch_overlap_ratio",
    "Fraction of a dispatch handle's lifetime overlapped with host work",
    labelnames=("queue",),
    buckets=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0),
)

# -- verify coalescer + dedup cache (services/batcher.py) ---------------------

VERIFY_CACHE_HITS = Counter(
    "tendermint_verify_cache_hits_total",
    "Signature triples answered from the verified-signature dedup cache",
)
VERIFY_CACHE_MISSES = Counter(
    "tendermint_verify_cache_misses_total",
    "Signature triples not in the dedup cache (dispatched for verification)",
)
VERIFY_CACHE_EVICTIONS = Counter(
    "tendermint_verify_cache_evictions_total",
    "Proven triples evicted from the dedup cache by LRU pressure",
)
BATCHER_COALESCE = Histogram(
    "tendermint_batcher_coalesce_factor",
    "Verify requests merged into one coalesced device launch",
    buckets=SIZE_BUCKETS,
)
BATCHER_FLUSH = Counter(
    "tendermint_batcher_flush_total",
    "Coalescer flushes by trigger (window/size/barrier)",
    labelnames=("reason",),
)
BATCHER_WAIT = Histogram(
    "tendermint_batcher_wait_seconds",
    "Time a verify request waited in the coalescer before its launch",
    labelnames=("consumer",),
    buckets=LATENCY_BUCKETS,
)

# -- trace contexts (telemetry/tracectx.py) -----------------------------------

TRACE_SAMPLED = Counter(
    "tendermint_trace_sampled_total",
    "Trace contexts minted (head-based sampling said yes)",
)
TRACE_PROPAGATED = Counter(
    "tendermint_trace_propagated_total",
    "p2p frames sent carrying a trace context",
)
TRACE_DROPPED = Counter(
    "tendermint_trace_dropped_total",
    "Trace contexts lost (wire decode failures, trace-table evictions)",
)

# The span-name catalog: every literal the port passes to TRACER.add()
# or TRACER.span() (tests/test_torch_telemetry.py holds the port's
# sources to it).
SPAN_CATALOG = frozenset({"batcher.flush", "dispatch.launch"})

# -- lock contention (utils/lockrank.py) ---------------------------------------
#
# Only advance while contention timing is armed (`lockrank.set_timing`).

LOCK_WAIT_SECONDS = Histogram(
    "tendermint_lock_wait_seconds",
    "Blocking acquire-wait per annotated ranked lock (armed profiling "
    "only; per-site attribution in dump_telemetry?profile=1)",
    labelnames=("lock",),
    buckets=LATENCY_BUCKETS,
)
LOCK_HOLD_SECONDS = Histogram(
    "tendermint_lock_hold_seconds",
    "Hold duration per annotated ranked lock (armed profiling only)",
    labelnames=("lock",),
    buckets=LATENCY_BUCKETS,
)

# -- light client (certifiers/certifier.py) ------------------------------------
#
# `mode` splits the header-by-header walk (sequential, the
# InquiringCertifier) from the skipping walk (bisect, which the port
# does not carry yet); both series exist from import.

LIGHTCLIENT_WALK_SECONDS = Histogram(
    "tendermint_lightclient_walk_seconds",
    "Wall time one certifier walk took to move trust to the target "
    "height (sequential = header-by-header InquiringCertifier, "
    "bisect = batched skipping verification)",
    labelnames=("mode",),
    buckets=LATENCY_BUCKETS,
)

# Pre-seed the known label values so reads see zero-valued series before
# any instance or event.
for _kind in ("verify", "hash", "tables"):
    BREAKER_STATE.labels(kind=_kind).set(0)
for _reason in ("window", "size", "barrier"):
    BATCHER_FLUSH.labels(reason=_reason).inc(0)
for _direction in ("shrink", "restore"):
    MESH_REMESH.labels(direction=_direction).inc(0)
for _result in ("hit", "miss"):
    MESH_COMPILE.labels(result=_result).inc(0)
    TABLE_DEVICE_CACHE.labels(result=_result).inc(0)
for _kind in ("verify", "hash", "tables", "leaf_hashes"):
    for _state in ("useful", "padded", "cached"):
        LAUNCH_ROWS.labels(kind=_kind, state=_state).inc(0)
for _stage in ("queue_wait", "host_prep", "in_flight", "finalize"):
    LAUNCH_STAGE_SECONDS.labels(stage=_stage)
for _mode in ("sequential", "bisect"):
    LIGHTCLIENT_WALK_SECONDS.labels(mode=_mode)
