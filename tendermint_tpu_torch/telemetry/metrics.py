"""The port's metric catalog: the series the verify spine, the p2p layer,
consensus, the mempool, the evidence pool and the consensus WAL export,
under the JAX package's names, label sets and buckets
(`tendermint_tpu/telemetry/metrics.py`), registered at import into the
port's own `REGISTRY`.

Label values are low-cardinality by construction: `backend` in {host,
device, tables, mesh}, `kind` in {verify, hash, tables}, `queue` and
`consumer` the pipeline owners, `direction` in {shrink, restore},
`result` in {hit, miss} (the mempool's in {ok, rejected, duplicate,
bad_sig, flushed}), `phase` the round and height-lifecycle phases,
`reason` the flush and pipeline-stall vocabularies, `state` in {useful, padded, cached}, `mode` in
{sequential, bisect}, `stage` the dispatch-handle stages, `lock` the
ranked-lock names of `utils/lockrank.py`; the p2p, gossip and link
families take the fixed offense, channel, message-kind and delivery
vocabularies listed beside them.
"""

from __future__ import annotations

from tendermint_tpu_torch.telemetry.registry import (
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
)

# -- consensus ----------------------------------------------------------------

CONSENSUS_HEIGHT = Gauge(
    "tendermint_consensus_height", "Current consensus height"
)
CONSENSUS_ROUND = Gauge(
    "tendermint_consensus_round", "Current consensus round"
)
CONSENSUS_PHASE_SECONDS = Histogram(
    "tendermint_consensus_phase_seconds",
    "Wall time spent in each round phase (propose/prevote/precommit/commit)",
    labelnames=("phase",),
    buckets=LATENCY_BUCKETS,
)
CONSENSUS_HEIGHT_SECONDS = Histogram(
    "tendermint_consensus_height_seconds",
    "Wall time from entering a height to finalizing its commit",
    buckets=LATENCY_BUCKETS,
)
CONSENSUS_COMMITS = Counter(
    "tendermint_consensus_commits_total", "Blocks finalized by this node"
)
CONSENSUS_TXS_COMMITTED = Counter(
    "tendermint_consensus_txs_committed_total", "Txs in blocks finalized by this node"
)
CONSENSUS_ROUND_SKIPS = Counter(
    "tendermint_consensus_round_skips_total",
    "Round-skip timeouts fired while starved at PREVOTE/PRECOMMIT",
    labelnames=("phase",),
)
VOTE_DRAIN_BATCH = Histogram(
    "tendermint_consensus_vote_drain_batch_size",
    "Consecutive same-(height,round,type) votes drained per receive-loop turn",
    buckets=SIZE_BUCKETS,
)

# -- finality observatory (telemetry/heightlog.py, consensus/state.py) --------
#
# `phase` is the fixed height lifecycle: new_height (commit timeout +
# waiting for round 0), propose, prevote, precommit, commit (waiting
# for the committed block, pre-apply), apply (ABCI + state update) —
# summed across rounds of one height, so the per-height phase set
# always sums to ~the commit-to-commit gap.

FINALITY_SECONDS = Histogram(
    "tendermint_finality_seconds",
    "Commit-to-commit gap: wall time between consecutive finalized "
    "commits on this node (the user-facing finality latency)",
    buckets=LATENCY_BUCKETS,
)
HEIGHT_PHASE_SECONDS = Histogram(
    "tendermint_height_phase_seconds",
    "Per-height time in each lifecycle phase (summed across rounds), "
    "from the HeightLedger record assembled at finalize",
    labelnames=("phase",),
    buckets=LATENCY_BUCKETS,
)
VOTE_ARRIVAL_SECONDS = Histogram(
    "tendermint_consensus_vote_arrival_seconds",
    "Vote timestamp to local arrival, aggregated over all peers "
    "(per-peer rollup lives in dump_telemetry; clock-skew clamped)",
    buckets=LATENCY_BUCKETS,
)
VOTE_ARRIVAL_MAX = Gauge(
    "tendermint_consensus_vote_arrival_max_seconds",
    "Worst single vote-arrival delay observed in the last finalized "
    "height (the laggard-validator signal)",
)

# -- cross-height pipeline (consensus/state.py pipelined finalize) ------------
#
# `reason` is the fixed join-barrier vocabulary: propose (proposer
# needed the applied app_hash/mempool), prevote (validate_block against
# applied state), vote_tally (H+1 vote needed the post-EndBlock
# valset), shutdown (stop() drained the pipeline), fault (the apply
# itself failed — the pipeline drains and consensus halts). A stall is
# a join that actually blocked H+1 progress; instant joins and the
# receive loop's opportunistic idle-joins (nothing queued — blocking
# delays nothing) don't count.

APPLY_OVERLAP_SECONDS = Histogram(
    "tendermint_consensus_apply_overlap_seconds",
    "Share of height H's ABCI apply + state advance that ran "
    "concurrently with H+1's NewHeight/Propose (pipelined finalize; "
    "0 on the serial path)",
    buckets=LATENCY_BUCKETS,
)
PIPELINE_STALLS = Counter(
    "tendermint_consensus_pipeline_stalls_total",
    "Join-barrier waits that actually blocked H+1 progress on H's "
    "in-flight apply, by the barrier that stalled",
    labelnames=("reason",),
)
CONSENSUS_TIMEOUT_DERIVED = Gauge(
    "tendermint_consensus_timeout_derived_seconds",
    "Current measured-latency-derived timeout per phase (clamped to "
    "the configured fixed value; absent while cold-starting on the "
    "fixed ladder)",
    labelnames=("phase",),
)

# -- per-vote and per-tx lifecycle (consensus/state.py, mempool/mempool.py) --
#
# `stage` is a fixed per-vote lifecycle slice: "drain" (gossip arrival
# -> drained into a batch), "verify" (batch submit -> verdict join),
# "e2e" (arrival -> verdict applied). Histograms carry exemplar trace
# ids (JSON dump only) so an aggregate links back to one traced message.

TX_E2E = Histogram(
    "tendermint_tx_e2e_seconds",
    "Tx first-seen (CheckTx admission) to committed in a finalized block",
    buckets=LATENCY_BUCKETS,
)
VOTE_STAGE = Histogram(
    "tendermint_vote_stage_seconds",
    "Traced-vote lifecycle slices (drain/verify/e2e) on this node",
    labelnames=("stage",),
    buckets=LATENCY_BUCKETS,
)

# -- evidence -----------------------------------------------------------------

EVIDENCE_POOL_DEPTH = Gauge(
    "tendermint_evidence_pool_depth",
    "Verified misbehavior proofs pending commitment into a block",
)
EVIDENCE_COMMITTED = Counter(
    "tendermint_evidence_committed_total",
    "Evidence retired from the pool by block commitment",
)
EVIDENCE_EXPIRED = Counter(
    "tendermint_evidence_expired_total",
    "Pending evidence pruned past the ConsensusParams max-age window",
)

# -- mempool ------------------------------------------------------------------
#
# `result` outcomes are fixed: ok / rejected (app said no) / duplicate
# (dup-cache hit) / bad_sig (signed-envelope verify failed) / flushed
# (operator flush invalidated an in-flight admission). Ingress `reason`
# mirrors the coalescer's flush triggers (window/size/barrier).

MEMPOOL_SIZE = Gauge("tendermint_mempool_size", "Pending txs in the mempool")
MEMPOOL_TXS = Counter(
    "tendermint_mempool_txs_total",
    "CheckTx outcomes (ok/rejected/duplicate/bad_sig/flushed)",
    labelnames=("result",),
)
MEMPOOL_ADMISSION_SECONDS = Histogram(
    "tendermint_mempool_admission_seconds",
    "CheckTx arrival to admission verdict (ingress queue + verify window "
    "+ app check); exemplar-linked to the admitted tx's trace id",
    buckets=LATENCY_BUCKETS,
)
MEMPOOL_INGRESS_WINDOW = Histogram(
    "tendermint_mempool_ingress_window_txs",
    "Txs merged per ingress verify window",
    buckets=SIZE_BUCKETS,
)
MEMPOOL_INGRESS_FLUSH = Counter(
    "tendermint_mempool_ingress_flush_total",
    "Ingress window flushes by trigger (window/size/barrier)",
    labelnames=("reason",),
)

for _reason in ("window", "size", "barrier"):
    MEMPOOL_INGRESS_FLUSH.labels(reason=_reason).inc(0)
for _result in ("ok", "rejected", "duplicate", "bad_sig", "flushed"):
    MEMPOOL_TXS.labels(result=_result).inc(0)

# -- consensus WAL ------------------------------------------------------------

WAL_FSYNC_SECONDS = Histogram(
    "tendermint_wal_fsync_seconds",
    "Consensus WAL write+fsync latency per record",
    buckets=LATENCY_BUCKETS,
)
WAL_WRITTEN_BYTES = Counter(
    "tendermint_wal_written_bytes_total", "Framed bytes appended to the consensus WAL"
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
SPAN_CATALOG = frozenset(
    {
        "batcher.flush",
        "consensus.height",
        "dispatch.launch",
        "lightclient.walk",
        "mempool.admission",
        "mempool.window",
        "p2p.hop",
        "tx.e2e",
        "vote.e2e",
    }
)

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

# -- contention observatory (telemetry/profiler.py) ----------------------------
#
# Stack samples by subsystem and on-CPU/blocked state; they only
# advance while profiling is armed (TENDERMINT_TPU_PROFILE_HZ > 0 or a
# profiler boost window).

PROFILE_SAMPLES = Counter(
    "tendermint_profile_samples_total",
    "Profiler stack samples by subsystem and on-CPU/blocked state "
    "(state=blocked carries the wait-reason split)",
    labelnames=("subsystem", "state", "wait"),
)
PROFILE_TICK_SECONDS = Histogram(
    "tendermint_profile_tick_seconds",
    "Wall time one profiler sampling pass took (self-overhead guard)",
    buckets=LATENCY_BUCKETS,
)

# -- state sync (statesync/) ---------------------------------------------------

STATESYNC_CHUNKS = Counter(
    "tendermint_statesync_chunks_total",
    "Snapshot chunks received while syncing (ok/corrupt/timeout)",
    labelnames=("result",),
)
STATESYNC_CHUNKS_SERVED = Counter(
    "tendermint_statesync_chunks_served_total",
    "Snapshot chunks served to syncing peers",
)
STATESYNC_CHUNK_VERIFY_SECONDS = Histogram(
    "tendermint_statesync_chunk_verify_seconds",
    "Batched Merkle verification latency over a full snapshot chunk set",
    buckets=LATENCY_BUCKETS,
)
STATESYNC_RESTORE_SECONDS = Histogram(
    "tendermint_statesync_restore_seconds",
    "Wall time from snapshot selection to restored state (incl. chunk fetch)",
    buckets=LATENCY_BUCKETS,
)
STATESYNC_SNAPSHOT_SECONDS = Histogram(
    "tendermint_statesync_snapshot_seconds",
    "Snapshot creation latency (serialize + chunk + device tree + persist)",
    buckets=LATENCY_BUCKETS,
)
STATESYNC_SNAPSHOTS_TAKEN = Counter(
    "tendermint_statesync_snapshots_taken_total", "Snapshots created by this node"
)
STATESYNC_SNAPSHOTS_REJECTED = Counter(
    "tendermint_statesync_snapshots_rejected_total",
    "Offered snapshots rejected (trust anchoring, bad chunks, timeouts)",
)
STATESYNC_RESTORES = Counter(
    "tendermint_statesync_restores_total",
    "Snapshot restore attempts by outcome (ok/failed)",
    labelnames=("result",),
)

# -- light client (certifiers/, lightclient/) ----------------------------------
#
# `result` is the fixed walk-outcome vocabulary (ok, too_much_change,
# forged, trust_expired, no_source); only `forged` is a provider
# offense. `mode` splits the header-by-header walk (sequential, the
# InquiringCertifier) from the skipping walk (bisect). `kind` on the
# proofs-served counter is the fixed query taxonomy, never heights or
# peer ids.

LIGHTCLIENT_BISECTIONS = Counter(
    "tendermint_lightclient_bisections_total",
    "Skipping-verification walks by outcome (ok / too_much_change / "
    "forged / trust_expired / no_source)",
    labelnames=("result",),
)
LIGHTCLIENT_WALK_SECONDS = Histogram(
    "tendermint_lightclient_walk_seconds",
    "Wall time one certifier walk took to move trust to the target "
    "height (sequential = header-by-header InquiringCertifier, "
    "bisect = batched skipping verification)",
    labelnames=("mode",),
    buckets=LATENCY_BUCKETS,
)
LIGHTCLIENT_CACHE_HITS = Counter(
    "tendermint_lightclient_cache_hits_total",
    "FullCommit lookups answered from the certified-commit cache",
)
LIGHTCLIENT_CACHE_MISSES = Counter(
    "tendermint_lightclient_cache_misses_total",
    "FullCommit lookups that missed the certified-commit cache",
)
REPLICA_PROOFS_SERVED = Counter(
    "tendermint_replica_proofs_served_total",
    "Light-client queries answered by this node's serving layer, by "
    "proof kind (p2p FullCommit channel + proof-carrying RPC routes)",
    labelnames=("kind",),
)

# -- rpc (rpc/server.py, rpc/core.py) ------------------------------------------

RPC_REQUESTS = Counter(
    "tendermint_rpc_requests_total",
    "RPC calls served, by method and outcome",
    labelnames=("method", "result"),
)
RPC_SECONDS = Histogram(
    "tendermint_rpc_request_seconds",
    "RPC handler latency by method (dispatch to result, excl. socket I/O)",
    labelnames=("method",),
    buckets=LATENCY_BUCKETS,
)

# -- p2p (p2p/connection.py, switch.py, score.py) ------------------------------

P2P_SENT_BYTES = Counter(
    "tendermint_p2p_sent_bytes_total", "Frame bytes sent to peers"
)
P2P_RECV_BYTES = Counter(
    "tendermint_p2p_recv_bytes_total", "Frame bytes received from peers"
)
P2P_PEERS = Gauge("tendermint_p2p_peers", "Connected peers")
P2P_SEND_RATE = Gauge(
    "tendermint_p2p_send_rate_bytes", "Aggregate send rate over live peers, bytes/s"
)
P2P_RECV_RATE = Gauge(
    "tendermint_p2p_recv_rate_bytes", "Aggregate recv rate over live peers, bytes/s"
)
# Send-queue depth is the backpressure signal: the aggregate sum and the
# worst single peer (per-peer series would be unbounded cardinality).
P2P_SEND_QUEUE = Gauge(
    "tendermint_p2p_send_queue_depth",
    "Frames queued for send across all peers and channels",
)
P2P_SEND_QUEUE_MAX = Gauge(
    "tendermint_p2p_send_queue_max",
    "Deepest single-peer send queue (frames)",
)
P2P_SEND_WAIT = Histogram(
    "tendermint_p2p_send_wait_seconds",
    "Time a frame waited in a peer send queue before hitting the wire",
    buckets=LATENCY_BUCKETS,
)
# `kind` is the fixed offense taxonomy of p2p/score.py, never peer ids.
PEER_MISBEHAVIOR = Counter(
    "tendermint_p2p_peer_misbehavior_total",
    "Classified peer offenses debited against misbehavior scores",
    labelnames=("kind",),
)
PEER_BANS = Counter(
    "tendermint_p2p_peer_bans_total",
    "Peers banned for crossing the misbehavior threshold",
)

# -- gossip observatory (telemetry/gossiplog.py) ------------------------------
#
# `channel` and `kind` are the fixed wire vocabularies below, mirrored
# from the reactors by gossiplog.py (unknown -> "other").

GOSSIP_CHANNELS = (
    "pex",
    "cns_state",
    "cns_data",
    "cns_vote",
    "cns_votebits",
    "mempool",
    "evidence",
    "blockchain",
    "statesync",
    "lightclient",
    "ctrl",
    "other",
)
GOSSIP_KINDS = (
    "pex_request",
    "pex_addrs",
    "new_round_step",
    "commit_step",
    "proposal",
    "proposal_pol",
    "block_part",
    "vote",
    "has_vote",
    "vote_set_maj23",
    "vote_set_bits",
    "proposal_heartbeat",
    "tx",
    "evidence_list",
    "block_request",
    "block_response",
    "no_block",
    "status_request",
    "status_response",
    "snapshots_request",
    "snapshots_response",
    "chunk_request",
    "chunk_response",
    "no_chunk",
    "commit_request",
    "commit_response",
    "fc_request",
    "fc_response",
    "fc_subscribe",
    "fc_announce",
    "ping",
    "pong",
    "other",
)
GOSSIP_REDUNDANT_KINDS = ("vote", "block_part", "tx", "evidence")

P2P_CHANNEL_BYTES = Counter(
    "tendermint_p2p_channel_bytes_total",
    "Frame bytes by p2p channel and direction (send/recv)",
    labelnames=("channel", "dir"),
)
GOSSIP_MSGS = Counter(
    "tendermint_gossip_msgs_total",
    "Gossip messages by wire kind and direction (send/recv)",
    labelnames=("kind", "dir"),
)
GOSSIP_REDUNDANT = Counter(
    "tendermint_gossip_redundant_total",
    "Duplicate gossip deliveries dedup'd after arrival, by kind",
    labelnames=("kind",),
)
GOSSIP_REDUNDANT_BYTES = Counter(
    "tendermint_gossip_redundant_bytes_total",
    "Payload bytes of duplicate gossip deliveries, by kind",
    labelnames=("kind",),
)

# -- link chaos (p2p/transport.py) ---------------------------------------------
#
# `result` is the fixed delivery taxonomy of the chaos layer; no
# per-link labels.

LINK_SENDS = Counter(
    "tendermint_link_sends_total",
    "ChaosEndpoint sends by delivery outcome (delivered / delayed / "
    "dup / dropped / partitioned)",
    labelnames=("result",),
)
LINK_DELIVERY_DELAY = Histogram(
    "tendermint_link_delivery_delay_seconds",
    "Extra latency injected per delayed delivery (propagation delay + "
    "jitter + bandwidth serialization), as scheduled on the wheel",
    buckets=LATENCY_BUCKETS,
)
LINK_BANDWIDTH_WAIT = Histogram(
    "tendermint_link_bandwidth_wait_seconds",
    "Token-bucket serialization wait per bandwidth-capped send (the "
    "queueing component of the injected delay)",
    buckets=LATENCY_BUCKETS,
)
LINK_INFLIGHT = Gauge(
    "tendermint_link_inflight_deliveries",
    "Delayed deliveries pending on the shared delivery wheel (the "
    "thread-count regression signal: one thread serves all of these)",
)

# Pre-seed the known label values so reads see zero-valued series before
# any instance or event.
for _kind in ("verify", "hash", "tables"):
    BREAKER_STATE.labels(kind=_kind).set(0)
for _phase in ("prevote", "precommit"):
    CONSENSUS_ROUND_SKIPS.labels(phase=_phase).inc(0)
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
for _stage in ("drain", "verify", "e2e"):
    VOTE_STAGE.labels(stage=_stage)
for _phase in ("new_height", "propose", "prevote", "precommit", "commit", "apply"):
    HEIGHT_PHASE_SECONDS.labels(phase=_phase)
for _reason in ("propose", "prevote", "vote_tally", "shutdown", "fault"):
    PIPELINE_STALLS.labels(reason=_reason).inc(0)
for _phase in ("propose", "prevote", "precommit", "commit"):
    CONSENSUS_TIMEOUT_DERIVED.labels(phase=_phase)
for _result in ("ok", "corrupt", "timeout"):
    STATESYNC_CHUNKS.labels(result=_result).inc(0)
for _result in ("ok", "too_much_change", "forged", "trust_expired", "no_source"):
    LIGHTCLIENT_BISECTIONS.labels(result=_result).inc(0)
for _mode in ("sequential", "bisect"):
    LIGHTCLIENT_WALK_SECONDS.labels(mode=_mode)
for _kind in ("full_commit", "commit", "validators", "tx", "abci_query"):
    REPLICA_PROOFS_SERVED.labels(kind=_kind).inc(0)
for _kind in (
    "bad_frame",
    "oversize_frame",
    "bad_msg",
    "bad_sig",
    "bad_vote",
    "forged_block",
    "forged_fullcommit",
    "bad_evidence",
    "flood",
):
    PEER_MISBEHAVIOR.labels(kind=_kind).inc(0)
for _dir in ("send", "recv"):
    for _chan in GOSSIP_CHANNELS:
        P2P_CHANNEL_BYTES.labels(channel=_chan, dir=_dir).inc(0)
    for _kind in GOSSIP_KINDS:
        GOSSIP_MSGS.labels(kind=_kind, dir=_dir).inc(0)
for _kind in GOSSIP_REDUNDANT_KINDS:
    GOSSIP_REDUNDANT.labels(kind=_kind).inc(0)
    GOSSIP_REDUNDANT_BYTES.labels(kind=_kind).inc(0)
for _result in ("delivered", "delayed", "dup", "dropped", "partitioned", "congested"):
    LINK_SENDS.labels(result=_result).inc(0)
