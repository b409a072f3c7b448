"""Cross-subsystem verify coalescer + verified-signature dedup cache
(counterpart of `tendermint_tpu/services/batcher.py`).

The same ed25519 triple is proven on gossip arrival, again inside the
commit that seals the block, again on a fast-sync redo and on the
light-client certifier walk, and each consumer (consensus vote drain,
fast-sync, state sync, RPC / light client, mempool) pays a device launch
of its own on its own small, partly duplicate batch. Two layers remove
both costs:

* `VerifiedSigCache` — a sharded, thread-safe LRU of PROVEN triples,
  keyed by SHA-256 over the length-prefixed `pubkey‖msg‖sig` (prefixes
  make distinct triples unable to alias across field boundaries).
  POSITIVES ONLY: a failed verdict is never cached, so a forged
  signature cannot pin a verdict — every re-offer re-verifies. A hit
  answers without touching the card.

* `VerifyCoalescer` — a time/size-windowed merge stage between
  `verify_batch_async` call sites and the `DispatchQueue`: concurrent
  requests from different consumers coalesce into single device
  launches, each consumer getting a sub-handle that splits the joined
  verdict back out. Requests flush round-robin across consumers so one
  hot consumer cannot starve the rest, and per-consumer submission order
  is preserved. The flush window adapts from the launch:apply ratio the
  dispatch telemetry already measures. Each flush leaves a
  `coalescer_flush` flight event and tags its launch's ledger record
  with the consumer mix, the rows the cache withheld and the request
  count; a flush holding a traced request records a `batcher.flush`
  span and launches under that request's trace context.

Env knobs (all optional):
  TENDERMINT_TPU_VERIFY_CACHE_SIZE   proven triples kept (65536; 0 off)
  TENDERMINT_TPU_COALESCE_WINDOW_MS  fixed flush window (adaptive)
  TENDERMINT_TPU_COALESCE_MAX_BATCH  triples per merged launch (4096)
  TENDERMINT_TPU_COALESCE=0          default_verifier() skips the wrap
"""

from __future__ import annotations

import hashlib
import os
import queue as queue_mod
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Sequence

import numpy as np

from tendermint_tpu_torch.services.verifier import BatchVerifier, Triple
from tendermint_tpu_torch.telemetry import TRACER
from tendermint_tpu_torch.telemetry import launchlog as _launchlog
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.telemetry import tracectx as _trace
from tendermint_tpu_torch.telemetry.flightrec import FLIGHT
from tendermint_tpu_torch.utils import shutdown
from tendermint_tpu_torch.utils.lockrank import ranked_lock

CACHE_SIZE = int(os.environ.get("TENDERMINT_TPU_VERIFY_CACHE_SIZE", "65536"))
MAX_COALESCED_BATCH = int(
    os.environ.get("TENDERMINT_TPU_COALESCE_MAX_BATCH", "4096")
)

# Window bounds: never stall a request longer than one small fraction of
# the launch cost it amortizes, never spin under 0.2 ms (scheduler
# granularity noise dominates below that).
_WINDOW_MIN_S = 2e-4
_WINDOW_MAX_S = 0.01
_WINDOW_REFRESH_FLUSHES = 32

_STOP = object()


def _mesh_width(verifier) -> int:
    """Cards behind a verifier stack (1 for one-device backends): walks
    the `mesh` passthrough the resilient and sharded layers export."""
    mesh = getattr(verifier, "mesh", None)
    if mesh is None:
        mesh = getattr(getattr(verifier, "primary", None), "mesh", None)
    n = getattr(mesh, "n_total", 1)
    return max(1, int(n) if n else 1)


def consumer_kwargs(verifier, consumer: str) -> dict:
    """`{"consumer": ...}` when `verifier` advertises the tag surface
    (every in-tree BatchVerifier), `{}` for minimal test fakes — call
    sites stay compatible with both."""
    if consumer and getattr(verifier, "accepts_consumer", False):
        return {"consumer": consumer}
    return {}


class VerifiedSigCache:
    """Sharded LRU of PROVEN (pubkey, msg, sig) triples.

    Only positive verdicts enter (`add` after a True verdict); a lookup
    hit therefore means "this exact triple verified before". Sharding
    keeps the four consumer threads off one lock; each shard holds
    `capacity / shards` keys with LRU eviction.
    """

    SHARDS = 8

    def __init__(self, capacity: int | None = None) -> None:
        self.capacity = CACHE_SIZE if capacity is None else capacity
        per_shard = max(1, self.capacity // self.SHARDS)
        self._per_shard = per_shard
        self._shards = [
            (ranked_lock("batcher.shard", seq=i), OrderedDict())
            for i in range(self.SHARDS)
        ]
        self.enabled = self.capacity > 0

    @staticmethod
    def key(pubkey: bytes, msg: bytes, sig: bytes) -> bytes:
        """SHA-256 over the LENGTH-PREFIXED concatenation. The prefixes
        are load-bearing: raw `pubkey‖msg‖sig` would let two distinct
        triples alias by shifting bytes across a field boundary
        (`pk+b"ab", m` vs `pk+b"a", b"b"+m`)."""
        h = hashlib.sha256()
        h.update(len(pubkey).to_bytes(4, "big"))
        h.update(pubkey)
        h.update(len(msg).to_bytes(4, "big"))
        h.update(msg)
        h.update(len(sig).to_bytes(4, "big"))
        h.update(sig)
        return h.digest()

    def _shard(self, key: bytes):
        return self._shards[key[0] % self.SHARDS]

    def hit(self, key: bytes) -> bool:
        """Membership + LRU touch + hit/miss telemetry."""
        if not self.enabled:
            return False
        lock, od = self._shard(key)
        with lock:
            if key in od:
                od.move_to_end(key)
                _metrics.VERIFY_CACHE_HITS.inc()
                return True
        _metrics.VERIFY_CACHE_MISSES.inc()
        return False

    def add(self, key: bytes) -> None:
        """Record one PROVEN triple (callers must only pass keys whose
        verify came back True — negatives are never cached, so a forged
        sig can't pin a verdict)."""
        if not self.enabled:
            return
        lock, od = self._shard(key)
        with lock:
            od[key] = True
            od.move_to_end(key)
            while len(od) > self._per_shard:
                od.popitem(last=False)
                _metrics.VERIFY_CACHE_EVICTIONS.inc()

    def __contains__(self, key: bytes) -> bool:
        lock, od = self._shard(key)
        with lock:
            return key in od

    def __len__(self) -> int:
        return sum(len(od) for _lock, od in self._shards)

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "entries": len(self),
            "hits": _metrics.VERIFY_CACHE_HITS.value,
            "misses": _metrics.VERIFY_CACHE_MISSES.value,
            "evictions": _metrics.VERIFY_CACHE_EVICTIONS.value,
        }


class _Request:
    """One consumer's verify submission inside the coalescer."""

    __slots__ = (
        "consumer",
        "out",
        "novel",
        "novel_pos",
        "novel_keys",
        "event",
        "error",
        "submitted_at",
        "flushed",
        "ctx",
    )

    def __init__(self, consumer, out, novel, novel_pos, novel_keys, ctx=None):
        self.consumer = consumer
        self.out = out
        self.novel = novel
        self.novel_pos = novel_pos
        self.novel_keys = novel_keys
        self.event = threading.Event()
        self.error: BaseException | None = None
        self.submitted_at = time.perf_counter()
        self.flushed = False
        self.ctx = ctx  # the submitting thread's trace context


class SubHandle:
    """Per-consumer future over a coalesced launch — API-compatible with
    `VerifyHandle` (done/result/then), resolving to this request's own
    verdict mask. Joining an unflushed request forces a barrier flush so
    a lone consumer never waits out the window."""

    __slots__ = ("_coalescer", "_req")

    kind = "verify"

    def __init__(self, coalescer: "VerifyCoalescer", req: _Request):
        self._coalescer = coalescer
        self._req = req

    def done(self) -> bool:
        return self._req.event.is_set()

    def result(self, timeout: float | None = None):
        req = self._req
        if not req.event.is_set() and not req.flushed:
            self._coalescer.request_barrier()
        if not req.event.wait(timeout):
            raise TimeoutError(f"coalesced verify not resolved in {timeout}s")
        if req.error is not None:
            raise req.error
        return req.out

    def then(self, fn: Callable):
        from tendermint_tpu_torch.services.dispatch import ChainedHandle

        return ChainedHandle(self, fn)


def _adaptive_window_s() -> float:
    """Flush window derived from what the telemetry already measured:
    a small fraction of the mean device launch cost, scaled up when the
    dispatch overlap histogram says launches dominate applies (more
    coalescing amortizes more of the bottleneck). Env override wins."""
    env = os.environ.get("TENDERMINT_TPU_COALESCE_WINDOW_MS")
    if env:
        return max(0.0, float(env) / 1e3)
    from tendermint_tpu_torch.services.dispatch import measured_launch_apply_ratio
    from tendermint_tpu_torch.telemetry import REGISTRY

    launch_mean = None
    fam = REGISTRY.get("tendermint_verify_seconds")
    if fam is not None:
        # "mesh" first: when the sharded backend is live its launch cost
        # is the one the window amortizes
        for backend in ("mesh", "tables", "device", "host"):
            snap = fam.labels(backend=backend).value
            if snap["count"]:
                launch_mean = snap["sum"] / snap["count"]
                break
    if launch_mean is None:
        return 0.002
    ratio = measured_launch_apply_ratio() or 1.0
    return min(max(0.1 * launch_mean * min(ratio, 4.0), _WINDOW_MIN_S), _WINDOW_MAX_S)


class VerifyCoalescer:
    """Time/size-windowed merge of concurrent verify requests.

    Consumers `submit()` triples (already dedup-filtered by the caller)
    and get a `SubHandle`; a flusher thread merges pending requests —
    round-robin across consumers, whole requests only, per-consumer FIFO
    — into single `verify_batch_async` launches on the coalescer's own
    `DispatchQueue`; a joiner thread joins merged handles in submission
    order and scatters the verdict slices back out, feeding proven
    positives to the dedup cache.

    Flush triggers (`tendermint_batcher_flush_total{reason}`):
      window  — the oldest pending request aged past the flush window;
      size    — pending triples reached the max merged batch;
      barrier — a consumer joined an unflushed request (latency beats
                coalescing for whoever is already blocked).
    """

    def __init__(
        self,
        verifier: BatchVerifier,
        cache: VerifiedSigCache | None = None,
        max_batch: int | None = None,
        window_s: float | None = None,
        depth: int = 2,
    ) -> None:
        self._verifier = verifier
        self._cache = cache
        self._max_batch = (
            MAX_COALESCED_BATCH if max_batch is None else max(1, max_batch)
        )
        self._fixed_window = window_s
        self._window_s = window_s if window_s is not None else 0.002
        self._depth = depth
        # Non-reentrant usage throughout; ranked above the handle locks
        # (sub-handle joins may poke the window under a handle join).
        self._cond = threading.Condition(ranked_lock("batcher.window"))
        self._queues: "dict[str, deque[_Request]]" = {}
        self._pending_triples = 0
        self._barrier = False
        self._rr_idx = 0
        self._flushes = 0
        self._running = False
        self._queue = None  # created with the threads
        self._flusher: threading.Thread | None = None
        self._joiner: threading.Thread | None = None
        self._join_q: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()

    # -- lifecycle ---------------------------------------------------------

    def _ensure_threads(self) -> None:
        if self._running:
            return
        with self._cond:
            if self._running:
                return
            from tendermint_tpu_torch.services.dispatch import DispatchQueue

            if self._queue is None:
                self._queue = DispatchQueue(depth=self._depth, name="coalescer")
            self._running = True
            self._flusher = threading.Thread(
                target=self._flush_loop, name="verify-coalescer", daemon=True
            )
            self._joiner = threading.Thread(
                target=self._join_loop, name="verify-coalescer-join", daemon=True
            )
            self._flusher.start()
            self._joiner.start()

    def close(self) -> None:
        """Flush the backlog and stop both threads (tests; production
        coalescers live for the process)."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=5)
        self._join_q.put(_STOP)
        if self._joiner is not None:
            self._joiner.join(timeout=5)
        if self._queue is not None:
            self._queue.close()

    # -- submit side -------------------------------------------------------

    def submit(self, triples: Sequence[Triple], consumer: str = "default") -> SubHandle:
        """Cache-filter `triples` and queue the novel remainder for the
        next coalesced launch; the returned handle resolves to the full
        per-item verdict mask (cache hits pre-filled True)."""
        cache = self._cache
        n = len(triples)
        out = np.zeros(n, dtype=bool)
        novel: list[Triple] = []
        novel_pos: list[int] = []
        novel_keys: list[bytes] = []
        for i, (pk, msg, sig) in enumerate(triples):
            key = VerifiedSigCache.key(pk, msg, sig) if cache is not None else None
            if key is not None and cache.hit(key):
                out[i] = True
                continue
            novel.append((pk, msg, sig))
            novel_pos.append(i)
            novel_keys.append(key)
        req = _Request(consumer, out, novel, novel_pos, novel_keys, ctx=_trace.current())
        if not novel:
            req.flushed = True
            req.event.set()
            return SubHandle(self, req)
        self._ensure_threads()
        with self._cond:
            self._queues.setdefault(consumer, deque()).append(req)
            self._pending_triples += len(novel)
            self._cond.notify_all()
        return SubHandle(self, req)

    def request_barrier(self) -> None:
        """A consumer is blocked on an unflushed request: flush now."""
        with self._cond:
            self._barrier = True
            self._cond.notify_all()

    def stats(self) -> dict:
        """Live window state: pending requests/triples per consumer, the
        current flush window, flushes so far."""
        with self._cond:
            return {
                "window_ms": round(self._window_s * 1e3, 3),
                "max_batch": self._max_batch,
                "flushes": self._flushes,
                "pending_triples": self._pending_triples,
                "pending_requests": {
                    c: len(q) for c, q in self._queues.items() if q
                },
            }

    # -- flusher -----------------------------------------------------------

    def _oldest_age_locked(self, now: float) -> float | None:
        oldest = None
        for q in self._queues.values():
            if q and (oldest is None or q[0].submitted_at < oldest):
                oldest = q[0].submitted_at
        return None if oldest is None else now - oldest

    def _flush_reason_locked(self, now: float) -> str | None:
        if self._pending_triples == 0:
            # a barrier with nothing pending is satisfied trivially
            self._barrier = False
            return None
        if self._barrier:
            return "barrier"
        if self._pending_triples >= self._max_batch:
            return "size"
        age = self._oldest_age_locked(now)
        if age is not None and age >= self._window_s:
            return "window"
        return None

    def _take_locked(self) -> list[_Request]:
        """Round-robin pop: one whole request per non-empty consumer per
        cycle, cycles until the size cap or empty. Per-consumer FIFO is
        preserved — that is the drain-order discipline sub-handles keep."""
        consumers = [c for c, q in self._queues.items() if q]
        if not consumers:
            return []
        start = self._rr_idx % len(consumers)
        self._rr_idx += 1
        order = consumers[start:] + consumers[:start]
        batch: list[_Request] = []
        total = 0
        progressed = True
        while progressed and total < self._max_batch:
            progressed = False
            for c in order:
                q = self._queues[c]
                if not q or total >= self._max_batch:
                    continue
                req = q.popleft()
                req.flushed = True
                batch.append(req)
                total += len(req.novel)
                progressed = True
        self._pending_triples -= total
        if self._pending_triples <= 0:
            self._pending_triples = 0
            self._barrier = False
        return batch

    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                now = time.perf_counter()
                reason = self._flush_reason_locked(now)
                while reason is None and self._running:
                    age = self._oldest_age_locked(now)
                    timeout = (
                        None if age is None else max(0.0, self._window_s - age)
                    )
                    self._cond.wait(timeout)
                    now = time.perf_counter()
                    reason = self._flush_reason_locked(now)
                if reason is None and not self._running:
                    return  # close(): nothing pending, exit
                batch = self._take_locked()
            if batch:
                self._launch(batch, reason)

    def _launch(self, batch: list[_Request], reason: str) -> None:
        now = time.perf_counter()
        _metrics.BATCHER_FLUSH.labels(reason=reason).inc()
        _metrics.BATCHER_COALESCE.observe(len(batch))
        for req in batch:
            _metrics.BATCHER_WAIT.labels(consumer=req.consumer).observe(
                now - req.submitted_at
            )
        merged: list[Triple] = []
        for req in batch:
            merged.extend(req.novel)
        # one exemplar trace context per merged launch (the oldest traced
        # request's): the flush span links the aggregate back to it, and
        # launching with it ambient carries it into the dispatch handle
        exemplar = next((r.ctx for r in batch if r.ctx is not None), None)
        FLIGHT.record("coalescer_flush", reason=reason, requests=len(batch), triples=len(merged))
        if exemplar is not None:
            wall_now = time.time()
            oldest = min(req.submitted_at for req in batch)
            TRACER.add(
                "batcher.flush",
                wall_now - (now - oldest),
                wall_now,
                trace=exemplar.trace,
                reason=reason,
                requests=len(batch),
                triples=len(merged),
            )
        # the flush-level facts only the coalescer knows, captured by the
        # dispatch handle at submit: consumer mix, rows the cache
        # withheld from this launch, request count
        consumer_rows: dict[str, int] = {}
        cached_rows = 0
        for req in batch:
            consumer_rows[req.consumer] = consumer_rows.get(req.consumer, 0) + len(req.novel)
            cached_rows += len(req.out) - len(req.novel)
        try:
            with _launchlog.tag(
                consumers=consumer_rows, rows_cached=cached_rows, requests=len(batch)
            ), _trace.use(exemplar):
                if hasattr(self._verifier, "verify_batch_async"):
                    handle = self._verifier.verify_batch_async(merged, queue=self._queue)
                else:
                    handle = self._queue.submit(
                        lambda m=merged: self._verifier.verify_batch(m),
                        kind="verify",
                    )
        except BaseException as e:  # dispatch-layer failure: fail the batch
            for req in batch:
                req.error = e
                req.event.set()
            return
        self._flushes += 1
        if self._fixed_window is None and self._flushes % _WINDOW_REFRESH_FLUSHES == 1:
            try:
                self._window_s = _adaptive_window_s()
            except Exception:
                pass
        self._join_q.put((handle, batch))

    # -- joiner ------------------------------------------------------------

    def _join_loop(self) -> None:
        while True:
            item = self._join_q.get()
            if item is _STOP:
                return
            handle, batch = item
            try:
                # the join copies the verdict back: torch work that an
                # exiting interpreter waits for (`utils/shutdown.py`)
                with shutdown.section():
                    self._scatter(handle, batch)
            except shutdown.ShuttingDown as e:
                for req in batch:
                    req.error = e
                    req.event.set()

    def _scatter(self, handle, batch: list[_Request]) -> None:
        try:
            mask = handle.result()
        except BaseException as e:
            for req in batch:
                req.error = e
                req.event.set()
            return
        at = 0
        cache = self._cache
        for req in batch:
            k = len(req.novel)
            verdicts = mask[at : at + k]
            at += k
            for pos, key, ok in zip(req.novel_pos, req.novel_keys, verdicts):
                ok = bool(ok)
                req.out[pos] = ok
                if ok and cache is not None and key is not None:
                    cache.add(key)  # positives only
            req.novel = req.novel_keys = None  # drop payloads promptly
            req.event.set()


class CoalescingVerifier(BatchVerifier):
    """The verify-spine facade: dedup cache + coalescer over any inner
    `BatchVerifier` (normally the resilient device stack).

    * `verify_batch` (sync) — cache-filter, verify the novel remainder
      on the inner backend directly (no window wait), feed positives
      back to the cache.
    * `verify_batch_async` — cache-filter + coalesce: concurrent
      consumers share launches (the `queue` argument is ignored — the
      coalescer owns its dispatch queue so merged launches from all
      consumers stay FIFO; per-consumer order is preserved regardless).
    * `verify_commits*` — lane-level cache filtering in front of the
      inner commit-grid path: cached lanes are withheld from the device
      and re-merged as True at the join; when the inner backend has no
      grid surface the novel lanes route through the coalescer as flat
      triples.
    """

    accepts_consumer = True

    def __init__(
        self,
        inner: BatchVerifier,
        cache_size: int | None = None,
        window_s: float | None = None,
        max_batch: int | None = None,
    ) -> None:
        super().__init__()
        self.inner = inner
        cache = VerifiedSigCache(cache_size)
        self.cache = cache if cache.enabled else None
        if max_batch is None:
            # A merged launch should be able to fill the whole mesh: the
            # cap is per card, so N cards coalesce N windows' worth
            # before the size trigger fires (the env knob stays a
            # per-card figure either way).
            max_batch = MAX_COALESCED_BATCH * _mesh_width(inner)
        self.coalescer = VerifyCoalescer(
            inner, self.cache, max_batch=max_batch, window_s=window_s
        )

    # -- passthrough -------------------------------------------------------

    @property
    def breaker(self):
        return self.inner.breaker

    @property
    def degraded(self) -> bool:
        return bool(getattr(self.inner, "degraded", False))

    def snapshot(self) -> dict:
        out = {}
        if hasattr(self.inner, "snapshot"):
            out.update(self.inner.snapshot())
        if self.cache is not None:
            out["verify_cache"] = self.cache.stats()
        return out

    def stats(self) -> dict:
        """Coalescer window state (queue-wait unification view)."""
        return self.coalescer.stats()

    def prebuild(self, pubkeys) -> None:
        if hasattr(self.inner, "prebuild"):
            self.inner.prebuild(pubkeys)

    def warm_kernels(self):
        if hasattr(self.inner, "warm_kernels"):
            return self.inner.warm_kernels()
        return None

    def close(self) -> None:
        self.coalescer.close()
        if hasattr(self.inner, "close"):
            self.inner.close()

    # -- flat triples ------------------------------------------------------

    def verify_batch(self, triples: Sequence[Triple]) -> np.ndarray:
        cache = self.cache
        if cache is None:
            return self.inner.verify_batch(triples)
        out = np.zeros(len(triples), dtype=bool)
        novel, novel_pos, novel_keys = [], [], []
        for i, (pk, msg, sig) in enumerate(triples):
            key = VerifiedSigCache.key(pk, msg, sig)
            if cache.hit(key):
                out[i] = True
            else:
                novel.append((pk, msg, sig))
                novel_pos.append(i)
                novel_keys.append(key)
        if novel:
            verdicts = self.inner.verify_batch(novel)
            for pos, key, ok in zip(novel_pos, novel_keys, verdicts):
                ok = bool(ok)
                out[pos] = ok
                if ok:
                    cache.add(key)
        return out

    def verify_batch_async(
        self, triples: Sequence[Triple], queue=None, consumer: str = "default"
    ):
        return self.coalescer.submit(triples, consumer=consumer)

    # -- commit grids ------------------------------------------------------

    def _filter_lanes(self, pubkeys, commits):
        """Split commit lanes into cached (verdict already proven) and
        novel. Returns (filtered_commits, cached_mask, novel_lanes) with
        novel_lanes = [(ci, lane, key), ...] for post-verdict caching."""
        n = len(pubkeys)
        k = len(commits)
        cached = np.zeros((k, n), dtype=bool)
        novel_lanes: list[tuple[int, int, bytes]] = []
        filtered = []
        any_novel = False
        cache = self.cache
        for ci, (msgs, sigs) in enumerate(commits):
            f_msgs: list = [None] * n
            f_sigs: list = [None] * n
            for i in range(n):
                msg, sig = msgs[i], sigs[i]
                if msg is None or sig is None:
                    continue
                key = None
                if cache is not None:
                    key = VerifiedSigCache.key(pubkeys[i], msg, sig)
                    if cache.hit(key):
                        cached[ci, i] = True
                        continue
                f_msgs[i], f_sigs[i] = msg, sig
                novel_lanes.append((ci, i, key))
                any_novel = True
            filtered.append((f_msgs, f_sigs))
        return filtered, cached, novel_lanes, any_novel

    def _merge_grid(self, grid, cached, novel_lanes) -> np.ndarray:
        out = np.asarray(grid, dtype=bool) | cached
        cache = self.cache
        if cache is not None:
            for ci, i, key in novel_lanes:
                if out[ci, i] and key is not None:
                    cache.add(key)
        return out

    def _flat_lane_grid(self, pubkeys, filtered, cached, novel_lanes, consumer):
        """Inner backend has no commit-grid surface: route the novel
        lanes through the coalescer as flat triples and scatter the
        verdict mask back to grid shape."""
        triples = [
            (pubkeys[i], filtered[ci][0][i], filtered[ci][1][i])
            for ci, i, _key in novel_lanes
        ]
        handle = self.coalescer.submit(triples, consumer=consumer)

        def _assemble(mask):
            out = cached.copy()
            cache = self.cache
            for (ci, i, key), ok in zip(novel_lanes, mask):
                if bool(ok):
                    out[ci, i] = True
                    if cache is not None and key is not None:
                        cache.add(key)
            return out

        return handle.then(_assemble)

    def verify_commits(self, pubkeys, commits, force_fused=None) -> np.ndarray:
        if self.cache is None and hasattr(self.inner, "verify_commits"):
            return self.inner.verify_commits(
                pubkeys, commits, force_fused=force_fused
            )
        filtered, cached, novel_lanes, any_novel = self._filter_lanes(
            pubkeys, commits
        )
        if not any_novel:
            return cached
        if hasattr(self.inner, "verify_commits"):
            # the withheld lanes never reach the card: the launch record
            # carries how many the cache saved it
            with _launchlog.tag(rows_cached=int(cached.sum())):
                grid = self.inner.verify_commits(pubkeys, filtered, force_fused=force_fused)
            return self._merge_grid(grid, cached, novel_lanes)
        return self._flat_lane_grid(
            pubkeys, filtered, cached, novel_lanes, "default"
        ).result()

    def verify_commits_async(
        self, pubkeys, commits, queue=None, force_fused=None, consumer="default"
    ):
        from tendermint_tpu_torch.services.dispatch import CompletedHandle

        if self.cache is None and hasattr(self.inner, "verify_commits_async"):
            return self.inner.verify_commits_async(
                pubkeys, commits, queue=queue, force_fused=force_fused
            )
        filtered, cached, novel_lanes, any_novel = self._filter_lanes(
            pubkeys, commits
        )
        if not any_novel:
            return CompletedHandle(cached)
        if hasattr(self.inner, "verify_commits_async"):
            with _launchlog.tag(rows_cached=int(cached.sum())):
                handle = self.inner.verify_commits_async(
                    pubkeys, filtered, queue=queue, force_fused=force_fused
                )
            return handle.then(
                lambda grid: self._merge_grid(grid, cached, novel_lanes)
            )
        return self._flat_lane_grid(
            pubkeys, filtered, cached, novel_lanes, consumer
        )
