"""The port's metric catalog: the series the verify spine exports, under
the JAX package's names and label sets (`tendermint_tpu/telemetry/metrics.py`),
registered at import into the port's own `REGISTRY`.

Label values are low-cardinality by construction: `backend` in {host,
device, tables, mesh}, `kind` in {verify, hash, tables}, `queue` and
`consumer` the pipeline owners, `direction` in {shrink, restore},
`result` in {hit, miss}.
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
