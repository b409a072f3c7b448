"""Batched tx admission: signature windows through the verify spine.

CheckTx was the last signature path still verifying one triple at a
time on the submitting thread. `IngressBatcher` accumulates concurrent
CheckTx arrivals (RPC broadcast handler threads + per-peer gossip recv
threads) into **verify windows** and rides each window through the
PR 5 `VerifyCoalescer` as the fifth consumer (`consumer="mempool"`):
one device launch proves a whole window, the `VerifiedSigCache` makes
gossip re-arrivals of already-proven signatures near-free, and device
faults degrade a window to host verify through the breaker ladder
inside the verifier stack. A verifier that raises fails the window's
signed txs with INTERNAL_ERROR (the port's stack raises on a real
device error; the JAX package verifies such a window on the host).

Admission callbacks fire on window join, in arrival order — the global
FIFO queue preserves per-caller submission order, so the existing
`check_tx(tx, cb)` contract holds: a blocking caller forces a barrier
flush (latency beats batching for whoever is already waiting) and gets
the same Result the synchronous path would return.

Signed-tx envelope (the payload signature CheckTx verifies):

    0xED 0x01 | pubkey(32) | sig(64) | payload        (>= 98 bytes)

`parse_signed_tx` returns None for anything else — plain txs ride the
same windows but skip the signature stage (the app's CheckTx remains
their only gate).

CONSENSUS-RELEVANT: with envelope recognition on (the default), the
`0xED 0x01` prefix is RESERVED — a plain app payload that happens to
start with those two bytes and is >= 98 bytes long is classified as an
envelope, signature-verified, and rejected UNAUTHORIZED instead of
reaching the app. Chains whose apps may emit such payloads must opt
out (`TENDERMINT_TPU_SIGNED_TXS=0`, config `[mempool] signed_txs`, or
`Mempool(signed_txs=False)`), which restores unconditional
pass-through; all nodes of a chain must agree on the setting.

Env knobs (mirroring the TENDERMINT_TPU_COALESCE discipline):
  TENDERMINT_TPU_INGRESS_BATCH=0      legacy synchronous admission
  TENDERMINT_TPU_INGRESS_WINDOW_MS    flush window (default 2 ms)
  TENDERMINT_TPU_INGRESS_MAX_BATCH    txs per window (default 1024)
  TENDERMINT_TPU_MEMPOOL_LANES        pool lanes (mempool.py)
  TENDERMINT_TPU_SIGNED_TXS=0         disable envelope recognition

The port's copy of `tendermint_tpu/mempool/ingress.py`: a window's
envelopes go to the port verifier given as `verifier=` (on the card's
stack a window of 512 or more is one `ladder` launch); with
`verifier=None` they are checked on the host, as in the JAX package.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Callable

from tendermint_tpu_torch.abci.types import CodeType, Result
from tendermint_tpu_torch.services.batcher import consumer_kwargs
from tendermint_tpu_torch.telemetry import TRACER
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.utils.lockrank import ranked_lock

SIGNED_TX_MAGIC = b"\xed\x01"
_PK_LEN = 32
_SIG_LEN = 64
_HEADER_LEN = len(SIGNED_TX_MAGIC) + _PK_LEN + _SIG_LEN

_STOP = object()


class _FailedLaunch:
    """The handle of a window whose launch raised: its join re-raises."""

    def __init__(self, error: BaseException) -> None:
        self.error = error

    def result(self, timeout: float | None = None):
        raise self.error


def make_signed_tx(priv_key, payload: bytes) -> bytes:
    """Wrap `payload` in the signed-tx envelope under `priv_key`
    (a `crypto.keys.PrivKey`)."""
    payload = bytes(payload)
    sig = priv_key.sign(payload)
    return SIGNED_TX_MAGIC + priv_key.pub_key.data + sig + payload


def parse_signed_tx(tx: bytes) -> tuple[bytes, bytes, bytes] | None:
    """(pubkey, sig, payload) when `tx` is a signed-tx envelope, else
    None (plain txs skip the signature stage)."""
    if len(tx) < _HEADER_LEN or not tx.startswith(SIGNED_TX_MAGIC):
        return None
    off = len(SIGNED_TX_MAGIC)
    pk = tx[off : off + _PK_LEN]
    sig = tx[off + _PK_LEN : off + _PK_LEN + _SIG_LEN]
    return pk, sig, tx[_HEADER_LEN:]


class _Admission:
    """One queued CheckTx: resolves to a Result at window join."""

    __slots__ = (
        "tx",
        "cb",
        "ctx",
        "t_admit",
        "gen",
        "parsed",
        "event",
        "result",
        "flushed",
        "submitted_at",
    )

    def __init__(self, tx, cb, ctx, t_admit, parsed, gen=None):
        self.tx = tx
        self.cb = cb
        self.ctx = ctx
        self.t_admit = t_admit
        self.gen = gen  # mempool flush generation at submit
        self.parsed = parsed
        self.event = threading.Event()
        self.result: Result | None = None
        self.flushed = False
        self.submitted_at = time.perf_counter()

    def wait(self, timeout: float | None = None) -> Result:
        if not self.event.wait(timeout):
            raise TimeoutError(f"tx admission not resolved in {timeout}s")
        return self.result


class IngressBatcher:
    """Time/size-windowed admission merge in front of a mempool.

    `submit()` queues one tx (dup-cache already consulted by the
    mempool); a flusher thread cuts windows — the whole arrival-order
    FIFO up to the size cap — and launches ONE coalesced signature
    verify for each window's envelope txs; a joiner thread joins the
    verdict, runs the post-signature admission (`Mempool._admit_checked`:
    WAL, app CheckTx, lane insert) for every tx in arrival order, and
    fires callbacks. Flush triggers mirror the coalescer's
    (`tendermint_mempool_ingress_flush_total{reason}`): window age,
    size cap, or a barrier from a blocking caller.
    """

    def __init__(
        self,
        mempool,
        verifier=None,
        window_s: float | None = None,
        max_batch: int | None = None,
        signed_txs: bool = True,
    ) -> None:
        self._mempool = mempool
        self._verifier = verifier
        self._signed_txs = signed_txs
        if window_s is None:
            window_s = (
                float(os.environ.get("TENDERMINT_TPU_INGRESS_WINDOW_MS", "2.0"))
                / 1e3
            )
        self._window_s = max(0.0, window_s)
        if max_batch is None:
            max_batch = int(
                os.environ.get("TENDERMINT_TPU_INGRESS_MAX_BATCH", "1024")
            )
        self._max_batch = max(1, max_batch)
        # Non-reentrant by construction (every `with self._cond:` block
        # is self-contained); ranked BELOW the lane locks — the joiner
        # runs admissions with no window lock held.
        self._cond = threading.Condition(ranked_lock("mempool.ingress"))
        self._queue: "deque[_Admission]" = deque()
        self._barrier = False
        self._running = False
        self._closed = False
        self._flusher: threading.Thread | None = None
        self._joiner: threading.Thread | None = None
        self._join_q: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()

    # -- lifecycle ---------------------------------------------------------

    def _ensure_threads(self) -> None:
        if self._running:
            return
        with self._cond:
            if self._running or self._closed:
                return
            self._running = True
            self._flusher = threading.Thread(
                target=self._flush_loop, name="mempool-ingress", daemon=True
            )
            self._joiner = threading.Thread(
                target=self._join_loop, name="mempool-ingress-join", daemon=True
            )
            self._flusher.start()
            self._joiner.start()

    def close(self) -> None:
        """Drain the backlog and stop both threads."""
        with self._cond:
            self._closed = True
            running = self._running
            self._running = False
            self._cond.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=5)
        if running:
            self._join_q.put(_STOP)
        if self._joiner is not None:
            self._joiner.join(timeout=5)
        # anything still queued resolves as an internal error so no
        # caller blocks forever on a closed pool
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
        for adm in leftovers:
            self._finish(adm, Result(CodeType.INTERNAL_ERROR, log="mempool closed"))
        # a flusher stuck past its join timeout can enqueue a window
        # AFTER the _STOP sentinel; the joiner exits at _STOP without
        # resolving it and _Admission.wait() has no timeout — drain the
        # join queue so no blocked caller hangs on an unresolved batch
        while True:
            try:
                item = self._join_q.get_nowait()
            except queue_mod.Empty:
                break
            if item is _STOP:
                continue
            _handle, batch, _signed = item
            for adm in batch:
                self._finish(
                    adm, Result(CodeType.INTERNAL_ERROR, log="mempool closed")
                )

    # -- submit side -------------------------------------------------------

    def submit(self, tx: bytes, cb, ctx, t_admit, gen=None) -> _Admission:
        parsed = parse_signed_tx(tx) if self._signed_txs else None
        adm = _Admission(tx, cb, ctx, t_admit, parsed, gen)
        self._ensure_threads()
        with self._cond:
            if self._closed:
                pass  # resolved below, outside the lock
            else:
                self._queue.append(adm)
                self._cond.notify_all()
                return adm
        self._finish(adm, Result(CodeType.INTERNAL_ERROR, log="mempool closed"))
        return adm

    def wait(self, adm: _Admission) -> Result:
        """Block until `adm` resolves; an unflushed window flushes NOW
        (a lone synchronous caller never waits out the window)."""
        if not adm.event.is_set() and not adm.flushed:
            with self._cond:
                self._barrier = True
                self._cond.notify_all()
        return adm.wait()

    def stats(self) -> dict:
        """Live window state for the `dump_telemetry?profile=1` queue
        view (the ingress leg of the queue-wait unification)."""
        with self._cond:
            return {
                "window_ms": round(self._window_s * 1e3, 3),
                "max_batch": self._max_batch,
                "pending": len(self._queue),
                "running": self._running,
            }

    # -- flusher -----------------------------------------------------------

    def _flush_reason_locked(self, now: float) -> str | None:
        if not self._queue:
            self._barrier = False
            return None
        if self._barrier:
            return "barrier"
        if len(self._queue) >= self._max_batch:
            return "size"
        if now - self._queue[0].submitted_at >= self._window_s:
            return "window"
        return None

    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                now = time.perf_counter()
                reason = self._flush_reason_locked(now)
                while reason is None and self._running:
                    timeout = None
                    if self._queue:
                        timeout = max(
                            0.0,
                            self._window_s
                            - (now - self._queue[0].submitted_at),
                        )
                    self._cond.wait(timeout)
                    now = time.perf_counter()
                    reason = self._flush_reason_locked(now)
                if reason is None and not self._running:
                    return
                batch: list[_Admission] = []
                while self._queue and len(batch) < self._max_batch:
                    adm = self._queue.popleft()
                    adm.flushed = True
                    batch.append(adm)
                if not self._queue:
                    self._barrier = False
            if batch:
                self._launch(batch, reason)

    def _launch(self, batch: list[_Admission], reason: str) -> None:
        _metrics.MEMPOOL_INGRESS_FLUSH.labels(reason=reason).inc()
        _metrics.MEMPOOL_INGRESS_WINDOW.observe(len(batch))
        signed = [adm for adm in batch if adm.parsed is not None]
        handle = None
        if signed:
            triples = [
                (adm.parsed[0], adm.parsed[2], adm.parsed[1]) for adm in signed
            ]
            verifier = self._verifier
            if verifier is not None:
                from tendermint_tpu_torch.telemetry import tracectx as _trace

                exemplar = next(
                    (adm.ctx for adm in signed if adm.ctx is not None), None
                )
                if exemplar is not None:
                    oldest = min(adm.t_admit for adm in batch)
                    TRACER.add(
                        "mempool.window",
                        oldest,
                        time.time(),
                        trace=exemplar.trace,
                        reason=reason,
                        txs=len(batch),
                        signed=len(signed),
                    )
                try:
                    # the coalescer captures the ambient context at
                    # submit: the window's exemplar rides into the
                    # merged launch's flush/dispatch spans
                    with _trace.use(exemplar):
                        handle = verifier.verify_batch_async(
                            triples, **consumer_kwargs(verifier, "mempool")
                        )
                except Exception as e:
                    handle = _FailedLaunch(e)  # re-raised at the join
        self._join_q.put((handle, batch, signed))

    # -- joiner ------------------------------------------------------------

    def _join_loop(self) -> None:
        while True:
            item = self._join_q.get()
            if item is _STOP:
                return
            handle, batch, signed = item
            error = None
            try:
                verdicts = self._join_verdicts(handle, signed)
            except Exception as e:
                verdicts, error = [], e
            ok_by_id = {
                id(adm): bool(ok) for adm, ok in zip(signed, verdicts)
            }
            for adm in batch:
                sig_ok = ok_by_id.get(id(adm))  # None for plain txs
                try:
                    if error is not None and adm.parsed is not None:
                        res = self._mempool._admit_unverified(
                            adm.tx, adm.ctx, adm.t_admit, error
                        )
                    else:
                        res = self._mempool._admit_checked(
                            adm.tx, adm.ctx, adm.t_admit, sig_ok=sig_ok,
                            gen=adm.gen,
                        )
                except Exception as e:  # admission must never wedge a caller
                    res = Result(CodeType.INTERNAL_ERROR, log=f"admission: {e}")
                self._finish(adm, res)

    def _join_verdicts(self, handle, signed: list[_Admission]) -> list[bool]:
        """The window's signature verdicts: from the coalesced launch,
        or, with no verifier configured, one host pass over the window.
        A launch or join that raised raises here: the port does not
        verify that window on the host (the JAX package does).

        AUDIT (docs/BYZANTINE.md): a forged signature is a FALSE VERDICT
        in the mask, never an exception — so a garbage-sig flood through
        this path cannot record breaker failures and cannot DoS the
        device fast path into host crypto. Only dispatch-layer faults
        (a raising launch or join) count against the breaker, inside
        the verifier stack itself. Pinned by
        tests/test_byzantine.py::TestIngressFloodRecovery."""
        if not signed:
            return []
        if handle is not None:
            return [bool(v) for v in handle.result()]
        from tendermint_tpu_torch.crypto.keys import PubKey

        out = []
        for adm in signed:
            pk, sig, payload = adm.parsed
            try:
                out.append(PubKey(pk).verify(payload, sig))
            except Exception:
                out.append(False)
        return out

    def _finish(self, adm: _Admission, res: Result) -> None:
        adm.result = res
        if adm.cb is not None:
            try:
                adm.cb(res)
            except Exception:
                pass  # a broken callback must not poison the window
        adm.event.set()
