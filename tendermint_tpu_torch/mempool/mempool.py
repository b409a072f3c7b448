"""Mempool: concurrent tx intake, dedup, ABCI validation, reaping.

Reference `mempool/mempool.go`: LRU dup-cache (100k), append-only
mempool WAL, ABCI CheckTx validation, ordered good-tx list consumed by
the proposer (`Reap :303`) and per-peer gossip routines; `Update :334`
removes committed txs and *rechecks* the remainder through the app.

Traffic-scale ingress (ROADMAP open item 2): the single version-counted
list under one RLock became N tx-hash-partitioned **lanes** — per-lane
lock + dup-cache segment + tx list — so concurrent CheckTx admissions
(RPC broadcast threads + per-peer gossip recv threads), per-peer gossip
cursors (`get_after`), `reap`, and `update` stop serializing on one
lock. A process-global monotonically-increasing intake counter is
assigned at insert; `reap` merges lanes in counter order so proposals
stay deterministic regardless of lane layout, and gossip cursors stay
counters, never list positions.

Signed-tx admission batches through `mempool/ingress.py`: signature
windows ride the PR 5 `VerifyCoalescer` as the fifth consumer
(`consumer="mempool"`), the `VerifiedSigCache` makes gossip re-arrivals
near-free, and the breaker ladder degrades a window to host verify.
`TENDERMINT_TPU_INGRESS_BATCH=0` (or `lanes=1` + `ingress_batch=False`)
keeps today's synchronous one-at-a-time semantics.

The port's copy of `tendermint_tpu/mempool/mempool.py`; `verifier=None`
checks envelopes on the host, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

from tendermint_tpu_torch.abci.client import AppConnMempool
from tendermint_tpu_torch.abci.types import CodeType, Result
from tendermint_tpu_torch.telemetry import TRACER
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.telemetry import tracectx as _trace
from tendermint_tpu_torch.types.tx import Tx, Txs, tx_hash
from tendermint_tpu_torch.utils.lockrank import ranked_lock, ranked_rlock

DEFAULT_CACHE_SIZE = 100_000

# Lane count: env wins (ops knob), then the constructor arg, then this.
# Lanes partition by tx hash, so dup detection and gossip re-arrivals
# always land on the lane that saw the tx first.
LANES_ENV = "TENDERMINT_TPU_MEMPOOL_LANES"
DEFAULT_LANES = 4

# Bounded tx-hash -> (TraceContext, first_seen) table: big enough for
# several full blocks of in-flight traced txs, small enough that an
# abandoned tx can't pin memory. Evictions count as dropped traces.
TRACE_TABLE_SIZE = 4096


class TxCache:
    """Bounded FIFO-evicting dup cache (reference `txCache :414-474`)."""

    def __init__(self, size: int = DEFAULT_CACHE_SIZE) -> None:
        self._size = size
        self._map: OrderedDict[bytes, None] = OrderedDict()
        self._lock = ranked_lock("mempool.txcache")

    def push(self, tx: bytes) -> bool:
        """False if already present (and does not re-add)."""
        with self._lock:
            if tx in self._map:
                return False
            if len(self._map) >= self._size:
                self._map.popitem(last=False)
            self._map[tx] = None
            return True

    def remove(self, tx: bytes) -> None:
        with self._lock:
            self._map.pop(tx, None)

    def reset(self) -> None:
        with self._lock:
            self._map.clear()


@dataclass
class MempoolTx:
    counter: int
    height: int  # height when added
    tx: bytes


class _Lane:
    """One tx-hash partition: its own lock, ordered tx list, and
    dup-cache segment. Counters inside a lane are strictly increasing
    (assignment and append happen under the lane lock), so cross-lane
    merges by counter reconstruct global admission order."""

    __slots__ = ("lock", "txs", "cache")

    def __init__(self, cache_size: int, seq: int = 0) -> None:
        # seq = lane index: the lockrank sanitizer allows same-rank lane
        # acquisitions only in ascending index order (what lock() does)
        self.lock = ranked_rlock("mempool.lane", seq=seq)
        self.txs: list[MempoolTx] = []
        self.cache = TxCache(cache_size)


def _resolve_lanes(lanes: int | None) -> int:
    env = os.environ.get(LANES_ENV)
    if env is not None:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    if lanes is not None:
        return max(1, int(lanes))
    return DEFAULT_LANES


def _resolve_ingress(ingress_batch: bool | None) -> bool:
    env = os.environ.get("TENDERMINT_TPU_INGRESS_BATCH")
    if env is not None:
        return env != "0"
    if ingress_batch is not None:
        return bool(ingress_batch)
    return True


def _resolve_signed(signed_txs: bool | None) -> bool:
    env = os.environ.get("TENDERMINT_TPU_SIGNED_TXS")
    if env is not None:
        return env != "0"
    if signed_txs is not None:
        return bool(signed_txs)
    return True


class Mempool:
    """Implements `types.services.MempoolI`."""

    def __init__(
        self,
        app_conn: AppConnMempool,
        height: int = 0,
        cache_size: int = DEFAULT_CACHE_SIZE,
        wal_dir: str | None = None,
        recheck: bool = True,
        node_id: str = "",
        lanes: int | None = None,
        verifier=None,
        ingress_batch: bool | None = None,
        ingress_window_s: float | None = None,
        ingress_max_batch: int | None = None,
        signed_txs: bool | None = None,
    ) -> None:
        self._app = app_conn
        n_lanes = _resolve_lanes(lanes)
        per_lane_cache = max(1, cache_size // n_lanes)
        self._lanes = [_Lane(per_lane_cache, seq=i) for i in range(n_lanes)]
        self._counter = 0
        self._counter_lock = ranked_lock("mempool.counter")
        self._height = height
        self._recheck = recheck
        # Bumped by flush() while every lane lock is held; admissions
        # capture it at submit and re-check it under the lane lock at
        # insert, so a tx queued in an ingress window when the operator
        # flushes cannot re-enter the pool afterwards.
        self._flush_gen = 0
        # Lock ordering discipline (deadlock-free by construction):
        #   _avail -> lane locks                    (get_after's wait+rescan)
        #   lane locks -> _wal_lock -> _counter_lock (admission insert)
        # Nothing acquires _avail while holding a lane lock: admissions
        # insert under the lane lock, RELEASE it, then notify. The
        # once-per-height "txs available" latch has its own tiny lock so
        # update() (holding every lane lock via lock()) never touches
        # _avail either. This order is NORMATIVE: utils/lockrank.py's
        # RANKS table encodes it, tmlint L001 checks it statically, and
        # the ranked locks below enforce it at test time.
        self._avail = threading.Condition(ranked_lock("mempool.avail"))
        self._notif_lock = ranked_lock("mempool.notif")
        self._notified_available = False
        self._fire_available: Callable[[], None] | None = None
        # distributed tracing: who minted (span attr `node`) + the
        # tx-hash -> (ctx, first_seen) table the gossip reactor and the
        # commit-time tx.e2e observation read
        self._node_id = node_id
        self._traces: "OrderedDict[bytes, tuple[object, float]]" = OrderedDict()
        self._trace_lock = ranked_lock("mempool.trace")
        self._wal = None
        # Appends are length-framed; concurrent RPC + gossip admissions
        # used to interleave partial writes and corrupt the framing
        # load_wal replays. One dedicated lock serializes appends AND is
        # the ordering point for counter assignment: counter and WAL
        # record are produced under one _wal_lock hold, so WAL order ==
        # counter (admission) order, which replay for nonce-style serial
        # apps relies on.
        self._wal_lock = ranked_lock("mempool.wal")
        if wal_dir:
            os.makedirs(wal_dir, exist_ok=True)
            self._wal = open(os.path.join(wal_dir, "wal"), "ab")
        # batched ingress: signature windows through the verify spine.
        # _signed_txs gates envelope recognition: the 0xED 0x01 prefix is
        # RESERVED when on (a colliding app payload is treated as an
        # envelope and must carry a valid signature); chains whose apps
        # emit arbitrary payloads opt out and every tx passes through.
        self._verifier = verifier
        self._signed_txs = _resolve_signed(signed_txs)
        self._ingress = None
        if _resolve_ingress(ingress_batch):
            from tendermint_tpu_torch.mempool.ingress import IngressBatcher

            self._ingress = IngressBatcher(
                self,
                verifier=verifier,
                window_s=ingress_window_s,
                max_batch=ingress_max_batch,
                signed_txs=self._signed_txs,
            )

    # -- lanes ---------------------------------------------------------------

    @property
    def n_lanes(self) -> int:
        return len(self._lanes)

    def _lane_for(self, tx: bytes) -> _Lane:
        if len(self._lanes) == 1:
            return self._lanes[0]
        return self._lanes[int.from_bytes(tx_hash(tx)[:4], "big") % len(self._lanes)]

    # -- MempoolI ------------------------------------------------------------

    def lock(self) -> None:
        """Freeze the whole pool (consensus holds this across update()).
        Acquires every lane lock in index order."""
        for lane in self._lanes:
            lane.lock.acquire()

    def unlock(self) -> None:
        for lane in reversed(self._lanes):
            lane.lock.release()

    def size(self) -> int:
        total = 0
        for lane in self._lanes:
            with lane.lock:
                total += len(lane.txs)
        return total

    def flush(self) -> None:
        """Drop everything (unsafe_flush_mempool RPC) — including txs
        still queued in ingress windows: the generation bump invalidates
        every in-flight admission, checked under the lane lock at insert
        time, so nothing queued before the flush re-enters after it."""
        self.lock()
        try:
            self._flush_gen += 1
            for lane in self._lanes:
                lane.txs.clear()
                lane.cache.reset()
        finally:
            self.unlock()
        with self._trace_lock:
            self._traces.clear()
        _metrics.MEMPOOL_SIZE.set(0)

    def check_tx(self, tx: Tx, cb: Callable[[Result], None] | None = None) -> Result:
        """Validate through the app; good txs join the pool.

        With batched ingress on, the tx rides the next verify window
        (concurrent callers share device launches) and this call blocks
        until the window joins — same Result contract, and a lone caller
        forces a barrier flush so it never waits out the window.
        """
        tx = bytes(tx)
        dup = self._dup_or_submit_ctx(tx, cb)
        if isinstance(dup, Result):
            return dup
        ctx, t_admit, gen = dup
        if self._ingress is not None:
            adm = self._ingress.submit(tx, cb, ctx, t_admit, gen)
            return self._ingress.wait(adm)
        return self._check_tx_sync(tx, cb, ctx, t_admit, gen)

    def check_tx_async(self, tx: Tx, cb: Callable[[Result], None] | None = None):
        """Non-blocking admission: queue the tx for the next verify
        window and return immediately (the Result flows via `cb`, the
        reference's CheckTx-callback shape). Gossip recv threads and the
        open-loop load generator use this so intake threads never stall
        on a window join. Falls back to the synchronous path when
        batching is off. Returns an awaitable admission (event/result)
        or the final Result when resolved synchronously."""
        tx = bytes(tx)
        dup = self._dup_or_submit_ctx(tx, cb)
        if isinstance(dup, Result):
            return dup
        ctx, t_admit, gen = dup
        if self._ingress is not None:
            return self._ingress.submit(tx, cb, ctx, t_admit, gen)
        return self._check_tx_sync(tx, cb, ctx, t_admit, gen)

    def _dup_or_submit_ctx(self, tx: bytes, cb):
        """Shared synchronous admission prologue: lane dup-cache push
        (so an immediate re-offer is rejected before any window) and
        trace-context capture on the CALLING thread (the p2p recv loop
        installs the sender's context ambient; batcher threads have
        none). Returns a Result for duplicates, else
        (ctx, t_admit, flush_gen)."""
        if not self._lane_for(tx).cache.push(tx):
            # Non-zero code so RPC/broadcast callers can distinguish an
            # accepted tx from a silently-dropped duplicate (reference
            # returns ErrTxInCache, mempool.go:172-178).
            _metrics.MEMPOOL_TXS.labels(result="duplicate").inc()
            res = Result(
                code=CodeType.TX_IN_CACHE, log="tx already exists in cache"
            )
            if cb is not None:
                cb(res)
            return res
        # Admission is a trace edge: a gossiped tx arrives with the
        # sender's context ambient on this thread (set by the p2p recv
        # loop); a locally-submitted one (RPC broadcast) mints here —
        # head-based sampling, so most txs pay one thread-local read.
        t_admit = time.time()
        ctx = _trace.current()
        if ctx is None:
            ctx = _trace.mint(self._node_id)
        return ctx, t_admit, self._flush_gen

    def _check_tx_sync(self, tx: bytes, cb, ctx, t_admit, gen=None) -> Result:
        """The legacy one-at-a-time admission path (ingress batching
        off): signed envelopes verify inline — one signature, one
        verify call — exactly the host-side shape the batched pipeline
        exists to replace."""
        from tendermint_tpu_torch.mempool.ingress import parse_signed_tx

        parsed = parse_signed_tx(tx) if self._signed_txs else None
        sig_ok = None
        if parsed is not None:
            try:
                sig_ok = self._verify_sig_inline(parsed)
            except Exception as e:
                res = self._admit_unverified(tx, ctx, t_admit, e)
                if cb is not None:
                    cb(res)
                return res
        res = self._admit_checked(tx, ctx, t_admit, sig_ok=sig_ok, gen=gen)
        if cb is not None:
            cb(res)
        return res

    def _verify_sig_inline(self, parsed) -> bool:
        """One-at-a-time signature check for the synchronous path:
        through the configured verifier stack when present (dedup cache
        + breaker ladder still apply), else the host library. A verifier
        that raises raises here: the port does not fall to the host (the
        JAX package does)."""
        pk, sig, payload = parsed
        if self._verifier is not None:
            return bool(self._verifier.verify_batch([(pk, payload, sig)])[0])
        from tendermint_tpu_torch.crypto.keys import PubKey

        try:
            return PubKey(pk).verify(payload, sig)
        except Exception:
            return False

    def _admit_checked(self, tx: bytes, ctx, t_admit, sig_ok=None, gen=None) -> Result:
        """Post-signature admission: app CheckTx, then counter + WAL +
        lane insert as one atomic step, telemetry. `sig_ok` is the
        envelope verdict (None for unsigned txs); a failed signature
        never reaches the app or the WAL and is evicted from the dup
        cache so a corrected re-offer re-verifies. `gen` is the flush
        generation captured at submit: a mismatch under the lane lock
        means the operator flushed while this tx sat in an ingress
        window, so it must not re-enter the pool (or the WAL).

        Counter assignment, WAL append, and lane append all happen under
        the lane lock (with _wal_lock as the cross-lane ordering point),
        which two invariants depend on: WAL record order == counter
        order (nonce-style serial apps replay in admission order), and
        _collect_after's counter-snapshot bound (a counter <= the
        snapshot is guaranteed visible once the lane lock is acquired).
        The WAL is best-effort (flushed, never fsync'd per tx, and only
        admitted txs are logged — an app-rejected tx would be dropped at
        replay's re-validation anyway)."""
        lane = self._lane_for(tx)
        if sig_ok is False:
            lane.cache.remove(tx)
            _metrics.MEMPOOL_TXS.labels(result="bad_sig").inc()
            res = Result(
                code=CodeType.UNAUTHORIZED, log="invalid tx signature"
            )
            self._finish_admission(tx, ctx, t_admit, res)
            return res
        res = self._app.check_tx_async(tx)
        if res.is_ok:
            from tendermint_tpu_torch.codec.binary import encode_bytes

            with lane.lock:
                stale = gen is not None and gen != self._flush_gen
                if not stale:
                    with self._wal_lock:
                        with self._counter_lock:
                            self._counter += 1
                            counter = self._counter
                        if self._wal is not None:
                            self._wal.write(encode_bytes(tx))
                            self._wal.flush()
                    lane.txs.append(MempoolTx(counter, self._height, tx))
            if stale:
                # flushed while queued: the pool (and dup caches) were
                # wiped after this tx was accepted into a window — don't
                # resurrect it
                _metrics.MEMPOOL_TXS.labels(result="flushed").inc()
                res = Result(
                    code=CodeType.INTERNAL_ERROR,
                    log="mempool flushed during admission",
                )
                self._finish_admission(tx, ctx, t_admit, res, label="flushed")
                return res
            if ctx is not None:
                with self._trace_lock:
                    self._traces[tx_hash(tx)] = (ctx, t_admit)
                    while len(self._traces) > TRACE_TABLE_SIZE:
                        self._traces.popitem(last=False)
                        _metrics.TRACE_DROPPED.inc()
            _metrics.MEMPOOL_TXS.labels(result="ok").inc()
            _metrics.MEMPOOL_SIZE.set(self.size())
            self._notify_txs_available()
            with self._avail:
                self._avail.notify_all()
        else:
            # bad tx: evict from cache so a corrected app state can re-admit
            lane.cache.remove(tx)
            _metrics.MEMPOOL_TXS.labels(result="rejected").inc()
        self._finish_admission(tx, ctx, t_admit, res)
        return res

    def _admit_unverified(self, tx: bytes, ctx, t_admit, error: BaseException) -> Result:
        """A signed tx whose signature verify raised: INTERNAL_ERROR,
        never reaching the app or the WAL, evicted from the dup cache so
        a re-offer verifies again. The port's stack raises on a real
        device error, and the port does not verify the tx on the host
        instead (the JAX package does)."""
        self._lane_for(tx).cache.remove(tx)
        _metrics.MEMPOOL_TXS.labels(result="verify_error").inc()
        res = Result(
            code=CodeType.INTERNAL_ERROR,
            log=f"signature verify failed: {type(error).__name__}: {error}",
        )
        self._finish_admission(tx, ctx, t_admit, res, label="verify_error")
        return res

    def _finish_admission(
        self, tx: bytes, ctx, t_admit, res: Result, label: str | None = None
    ) -> None:
        """Admission telemetry shared by every outcome: the p99-tracked
        latency histogram (exemplar-linked to the trace id) and the
        admission span."""
        now = time.time()
        _metrics.MEMPOOL_ADMISSION_SECONDS.observe(
            now - t_admit,
            exemplar=ctx.trace if ctx is not None else None,
        )
        if ctx is not None:
            if label is not None:
                result = label
            elif res.is_ok:
                result = "ok"
            elif res.code == CodeType.UNAUTHORIZED:
                result = "bad_sig"
            else:
                result = "rejected"
            TRACER.add(
                "mempool.admission",
                t_admit,
                now,
                trace=ctx.trace,
                node=self._node_id,
                tx=tx_hash(tx).hex()[:16],
                result=result,
            )

    # -- distributed tracing -------------------------------------------------

    def trace_for(self, tx: bytes):
        """The TraceContext admitted with `tx` (None when unsampled or
        unknown) — the gossip reactor re-attaches it on the wire and
        the proposer adopts it as the block's context."""
        with self._trace_lock:
            entry = self._traces.get(tx_hash(bytes(tx)))
        return entry[0] if entry is not None else None

    def take_trace(self, tx: bytes):
        """Pop `tx`'s (ctx, first_seen) entry — consumed exactly once,
        at commit, for the `tendermint_tx_e2e_seconds` observation and
        the tx.e2e span."""
        with self._trace_lock:
            return self._traces.pop(tx_hash(bytes(tx)), None)

    def reap(self, max_txs: int) -> Txs:
        """Up to max_txs txs for a proposal (-1 = all), pool unchanged
        (reference `Reap :303`). Lanes merge in global-counter order, so
        the proposal ordering is identical to the single-list pool's —
        deterministic regardless of lane count."""
        merged: list[MempoolTx] = []
        self.lock()
        try:
            for lane in self._lanes:
                merged.extend(lane.txs)
        finally:
            self.unlock()
        merged.sort(key=lambda m: m.counter)
        if max_txs >= 0:
            merged = merged[:max_txs]
        return Txs([Tx(m.tx) for m in merged])

    def update(self, height: int, txs: Txs) -> None:
        """Remove committed txs; recheck survivors against the new app
        state (reference `Update :334-360`). Caller holds the mempool
        lock (apply_block's CommitStateUpdateMempool). Survivors are
        rechecked as ONE admission-ordered batch across all lanes —
        not one-by-one interleaved with per-lane list surgery — so the
        pool-frozen window stays as short as the app allows."""
        committed = {bytes(t) for t in txs}
        self.lock()
        try:
            self._height = height
            for lane in self._lanes:
                if committed:
                    lane.txs = [m for m in lane.txs if m.tx not in committed]
            if self._recheck:
                survivors: list[MempoolTx] = []
                for lane in self._lanes:
                    survivors.extend(lane.txs)
                if survivors:
                    # admission order: serial apps (nonce-style) must see
                    # survivors in the same order a single list kept them
                    survivors.sort(key=lambda m: m.counter)
                    dropped = self._recheck_batch(survivors)
                    if dropped:
                        for lane in self._lanes:
                            lane.txs = [
                                m for m in lane.txs if m.counter not in dropped
                            ]
            remaining = sum(len(lane.txs) for lane in self._lanes)
            # reset the once-per-height latch while the pool is still
            # frozen: an admission landing right after unlock must see
            # the fresh latch or its wakeup is lost for the height
            with self._notif_lock:
                self._notified_available = False
        finally:
            self.unlock()
        _metrics.MEMPOOL_SIZE.set(remaining)
        if remaining:
            self._notify_txs_available()

    def _recheck_batch(self, survivors: list[MempoolTx]) -> set[int]:
        """One pass over every lane's survivors through the app; returns
        the counters of txs that went stale (also evicted from their
        lane's dup cache so they can be re-offered later)."""
        dropped: set[int] = set()
        for m in survivors:
            if not self._app.check_tx_async(m.tx).is_ok:
                dropped.add(m.counter)
                self._lane_for(m.tx).cache.remove(m.tx)
        return dropped

    # -- gossip / proposer wakeups -------------------------------------------

    def tx_available(self) -> bool:
        return self.size() > 0

    def enable_txs_available(self) -> None:
        """Install no-empty-blocks gating (reference `:101-106`).
        Consensus sets `on_txs_available` to get woken."""
        self._fire_available = self._fire_available or (lambda: None)

    def set_on_txs_available(self, fn: Callable[[], None]) -> None:
        self._fire_available = fn

    def _notify_txs_available(self) -> None:
        """Fire once per height when the pool becomes non-empty
        (reference `notifyTxsAvailable :284-299`)."""
        with self._notif_lock:
            if self._fire_available is None or self._notified_available:
                return
            self._notified_available = True
            fire = self._fire_available
        fire()

    def _collect_after(self, counter: int) -> list[tuple[int, bytes]]:
        """Lane-by-lane scan with a GAP-FREE guarantee for cursor-style
        callers (the gossip reactor advances its cursor to the max
        returned counter, so a skipped counter would never be gossiped).

        Lanes are scanned one lock at a time, so without a bound a tx
        admitted into an already-scanned lane could be masked by a
        higher-counter tx admitted into a lane scanned later — the
        cursor would jump past it forever. The counter snapshot taken
        BEFORE the walk closes that race: counters <= `hi` were
        assigned inside a lane-lock critical section that also appends
        the tx (see _admit_checked), and that section had already begun
        when we read `hi` — so acquiring the lane lock afterwards
        observes the append. Counters > `hi` are withheld until the
        next scan, when a fresh snapshot covers them."""
        with self._counter_lock:
            hi = self._counter
        out: list[tuple[int, bytes]] = []
        for lane in self._lanes:
            with lane.lock:
                out.extend(
                    (m.counter, m.tx)
                    for m in lane.txs
                    if counter < m.counter <= hi
                )
        out.sort(key=lambda p: p[0])
        return out

    def get_after(
        self, counter: int, wait: bool = False, timeout: float | None = None
    ) -> list[tuple[int, bytes]]:
        """(counter, tx) pairs with counter > `counter`, merged across
        lanes in counter order — the gossip iteration seam (role of
        clist's TxsFront/NextWait). Cursors are the monotonically-
        increasing intake counter, NOT list positions: update() compacts
        lanes after every commit, so a positional cursor would skip or
        stall. With wait=True, LOOPS until a newer tx exists or the
        deadline passes — a spurious Condition wakeup (or a notify for
        an admission the cursor already covers) re-waits instead of
        returning empty."""
        out = self._collect_after(counter)
        if out or not wait:
            return out
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._avail:
            while True:
                # re-scan INSIDE the condition so an admission between
                # the outer scan and the wait can't be missed
                out = self._collect_after(counter)
                if out:
                    return out
                if deadline is None:
                    self._avail.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._avail.wait(remaining):
                        return self._collect_after(counter)

    def close(self) -> None:
        if self._ingress is not None:
            self._ingress.close()
        with self._wal_lock:
            if self._wal is not None:
                self._wal.close()

    def replay_wal(self) -> int:
        """Restart recovery: re-validate WAL txs through the app, then
        atomically COMPACT the file to the txs that actually rejoined
        the pool. The old WAL stays intact on disk until the rewrite
        (a crash mid-replay loses nothing), and app-rejected txs are
        excluded (check_tx's own WAL append is suppressed during
        replay). Returns the number of txs that rejoined."""
        if self._wal is None:
            return 0
        from tendermint_tpu_torch.codec.binary import encode_bytes

        txs = self.load_wal()
        path = self._wal.name
        with self._wal_lock:
            wal, self._wal = self._wal, None  # suppress appends during replay
        before = self.size()
        try:
            for tx in txs:
                self.check_tx(tx)
        finally:
            with self._wal_lock:
                self._wal = wal
        # atomic rewrite with only the survivors, in admission order
        survivors = self.reap(-1)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            for tx in survivors:
                f.write(encode_bytes(bytes(tx)))
            f.flush()
            os.fsync(f.fileno())
        with self._wal_lock:
            self._wal.close()
            os.replace(tmp, path)
            self._wal = open(path, "ab")
        return self.size() - before

    def load_wal(self) -> list[bytes]:
        """Replay the mempool WAL (txs seen before a crash); stops at a
        truncated tail."""
        if self._wal is None:
            return []
        from tendermint_tpu_torch.codec.binary import decode_bytes

        with open(self._wal.name, "rb") as f:
            data = f.read()
        out, off = [], 0
        while off < len(data):
            try:
                tx, off = decode_bytes(data, off)
            except ValueError:
                break
            out.append(tx)
        return out
