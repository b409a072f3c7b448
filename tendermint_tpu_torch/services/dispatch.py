"""Bounded-depth asynchronous device dispatch: the pipeline substrate
(counterpart of `tendermint_tpu/services/dispatch.py`).

A verify or hash call splits into a launch (host prep + kernel launch;
the card computes in the background) and a finalize (the copy back that
waits for the card). This module gives the services an async seam:

* `VerifyHandle` — the future returned by `verify_batch_async` /
  `verify_commits_async`: the launch runs on the queue's worker thread,
  the result stays on the card until `.result()`, which copies it back
  on the consumer's thread. `then(fn)` chains a consumer-side step
  without another thread hop.

* `DispatchQueue` — keeps at most `depth` launches in flight and
  preserves submission order: the single worker launches FIFO, and a
  slot frees only when the consumer joins (or abandons via close) the
  handle. `submit()` blocks when the pipeline is full.

Ordering guarantee: for handles H1, H2 submitted in that order to one
queue, H1's launch starts before H2's, and a consumer joining in
submission order observes verdicts in submission order.

Every thread launches on the current stream of the card (the legacy
default stream unless a caller installs another), so the copy back at
the join orders after the worker's launch.

Telemetry: `tendermint_dispatch_inflight{queue=}`,
`tendermint_dispatch_queue_wait_seconds` and
`tendermint_dispatch_overlap_ratio` — the share of a handle's
submit->join wall time the consumer spent on other work rather than
blocked inside `result()`. Each handle of a queue with `launch_ledger`
(the default) carries one launch-ledger record, opened on the worker
and committed at the consumer's join (`telemetry/launchlog.py`); every
launch leaves a `dispatch_launch` flight event, and a handle submitted
under a trace context records a `dispatch.launch` span against it.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time
from typing import Callable

from tendermint_tpu_torch.telemetry import TRACER
from tendermint_tpu_torch.telemetry import launchlog as _launchlog
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.telemetry import tracectx as _trace
from tendermint_tpu_torch.telemetry.flightrec import FLIGHT
from tendermint_tpu_torch.utils import shutdown
from tendermint_tpu_torch.utils.lockrank import ranked_lock

# In-flight launches per queue (submitted, not yet joined). 2 is the
# classic double-buffer: one launch on device, one window of host prep.
DISPATCH_DEPTH = int(os.environ.get("TENDERMINT_TPU_DISPATCH_DEPTH", "2"))

# A submit() that cannot get a slot within this window means the
# consumer abandoned its handles — fail loudly instead of wedging the
# sync/consensus thread forever behind a leaked slot.
_STALL_TIMEOUT_S = float(os.environ.get("TENDERMINT_TPU_DISPATCH_STALL_S", "60"))

_STOP = object()


class VerifyHandle:
    """Future for one async dispatch through a `DispatchQueue`.

    Lifecycle: submit (consumer thread) -> launch (worker thread; host
    prep + device kernel dispatch, result left un-materialized) ->
    result() (consumer thread; materializes, runs the finalize step,
    releases the queue slot). `result()` is idempotent — the finalize
    runs once, later calls return the cached verdict (or re-raise the
    cached error).
    """

    __slots__ = (
        "_queue",
        "_launch_fn",
        "_finalize_fn",
        "kind",
        "_event",
        "_launched",
        "_launch_exc",
        "_value",
        "_exc",
        "_finalized",
        "_lock",
        "_submitted_at",
        "_launched_at",
        "_ctx",
        "_submitted_wall",
        "_launch_rec",
        "_launch_tags",
    )

    def __init__(self, queue: "DispatchQueue", launch_fn, finalize_fn, kind: str):
        self._queue = queue
        self._launch_fn = launch_fn
        self._finalize_fn = finalize_fn
        self.kind = kind
        self._event = threading.Event()
        self._launched = None
        self._launch_exc: BaseException | None = None
        self._value = None
        self._exc: BaseException | None = None
        self._finalized = False
        self._lock = ranked_lock("dispatch.handle")
        self._submitted_at = time.perf_counter()
        self._launched_at: float | None = None
        # trace context ambient on the SUBMITTING thread: the worker
        # records a `dispatch.launch` span against it (sampled only)
        self._ctx = _trace.current()
        self._submitted_wall = time.time() if self._ctx is not None else 0.0
        # launch-ledger tags ambient at submit (the coalescer's consumer
        # mix and cached rows cross threads here, like _ctx)
        self._launch_rec = None
        self._launch_tags = _launchlog.current_tags() if queue.launch_ledger else None

    # -- worker side -------------------------------------------------------

    def _run_launch(self) -> None:
        self._launched_at = time.perf_counter()
        _metrics.DISPATCH_QUEUE_WAIT.labels(queue=self._queue.name).observe(
            self._launched_at - self._submitted_at
        )
        # one ledger record per dispatch unit: opened here so that the
        # backend's prep and launch code annotates it, committed at the
        # consumer's join
        rec = None
        if self._queue.launch_ledger:
            rec = _launchlog.begin(kind=self.kind, queue=self._queue.name, tags=self._launch_tags)
        if rec is not None:
            rec["queue_wait_s"] = self._launched_at - self._submitted_at
            if self._ctx is not None:
                rec["trace"] = self._ctx.trace
        try:
            # torch work that an exiting interpreter waits for
            # (`utils/shutdown.py`); refused once it is exiting
            with shutdown.section(), _trace.use(self._ctx):
                self._launched = self._launch_fn()
        except BaseException as e:  # delivered at result(), never lost
            self._launch_exc = e
        finally:
            if rec is not None:
                now = time.perf_counter()
                rec["host_prep_s"] = now - self._launched_at
                rec["_t_launch_end"] = now
                self._launch_rec = _launchlog.detach(rec)
            self._launch_fn = None  # drop closed-over prep data promptly
            FLIGHT.record(
                "dispatch_launch",
                queue=self._queue.name,
                work=self.kind,
                error=type(self._launch_exc).__name__ if self._launch_exc is not None else "",
            )
            if self._ctx is not None:
                TRACER.add(
                    "dispatch.launch",
                    self._submitted_wall,
                    time.time(),
                    trace=self._ctx.trace,
                    queue=self._queue.name,
                    kind=self.kind,
                )
            self._event.set()

    # -- consumer side -----------------------------------------------------

    def done(self) -> bool:
        """Launch completed (the verdict may still need materializing)."""
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """Join: wait for the launch, materialize + finalize the verdict.

        Raises whatever the launch or finalize raised (e.g. the
        ValidationError a commit tally produces). Blocking time spent
        here — waiting for the launch plus materializing device arrays —
        is the NON-overlapped share of this handle's life; everything
        the consumer did between submit and this call was overlap.
        """
        t_join = time.perf_counter()
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.kind} dispatch not launched in {timeout}s")
        with self._lock:
            if not self._finalized:
                self._finalized = True
                rec, self._launch_rec = self._launch_rec, None
                t_fin0 = time.perf_counter()
                if rec is not None:
                    # in flight: launch end on the worker -> the consumer
                    # reaches the join (the window the pipeline hides)
                    rec["in_flight_s"] = max(0.0, t_fin0 - rec.get("_t_launch_end", t_fin0))
                    _launchlog.reattach(rec)
                try:
                    if self._launch_exc is not None:
                        raise self._launch_exc
                    if self._finalize_fn is not None:
                        self._value = self._finalize_fn(self._launched)
                    else:
                        self._value = self._launched
                except BaseException as e:
                    self._exc = e
                finally:
                    self._launched = None
                    self._finalize_fn = None
                    now = time.perf_counter()
                    if rec is not None:
                        rec["finalize_s"] = now - t_fin0
                        rec["total_s"] = now - self._submitted_at
                        _launchlog.commit(rec, error=self._exc)
                    blocked = now - t_join
                    total = now - self._submitted_at
                    if total > 0:
                        _metrics.DISPATCH_OVERLAP.labels(
                            queue=self._queue.name
                        ).observe(max(0.0, min(1.0, 1.0 - blocked / total)))
                    self._queue._release()
            if self._exc is not None:
                raise self._exc
            return self._value

    def then(self, fn: Callable) -> "ChainedHandle":
        """Chain a consumer-side mapping over this handle's result —
        runs at the chained handle's result(), on the joining thread."""
        return ChainedHandle(self, fn)


class ChainedHandle:
    """`handle.then(fn)`: a handle whose result is fn(parent.result()).
    The mapping runs once; its outcome (value or exception) is cached so
    repeated joins behave like VerifyHandle's."""

    __slots__ = ("_parent", "_fn", "_value", "_exc", "_done", "_lock", "kind")

    def __init__(self, parent, fn):
        self._parent = parent
        self._fn = fn
        self._value = None
        self._exc: BaseException | None = None
        self._done = False
        self._lock = ranked_lock("dispatch.handle")
        self.kind = getattr(parent, "kind", "verify")

    def done(self) -> bool:
        return self._parent.done()

    def result(self, timeout: float | None = None):
        # Join the parent BEFORE taking our lock (tmlint L002): parent
        # joins are idempotent and cache their outcome, so concurrent
        # joiners may all block here, but none blocks while holding
        # this handle's lock.
        try:
            parent_value = self._parent.result(timeout)
            parent_exc: BaseException | None = None
        except BaseException as e:
            parent_exc = e
        with self._lock:
            if not self._done:
                self._done = True
                try:
                    if parent_exc is not None:
                        raise parent_exc
                    self._value = self._fn(parent_value)
                except BaseException as e:
                    self._exc = e
                finally:
                    self._fn = None
            if self._exc is not None:
                raise self._exc
            return self._value

    def then(self, fn: Callable) -> "ChainedHandle":
        return ChainedHandle(self, fn)


class CompletedHandle:
    """An already-resolved handle — the no-async-backend degenerate case
    (the work ran synchronously at submit time). Keeps pipeline
    consumers free of `isinstance` forks."""

    __slots__ = ("_value", "_exc", "kind")

    def __init__(self, value=None, exc: BaseException | None = None, kind="verify"):
        self._value = value
        self._exc = exc
        self.kind = kind

    def done(self) -> bool:
        return True

    def result(self, timeout: float | None = None):
        if self._exc is not None:
            raise self._exc
        return self._value

    def then(self, fn: Callable) -> "ChainedHandle":
        return ChainedHandle(self, fn)


class DispatchQueue:
    """FIFO launch queue with a bounded in-flight window.

    One worker thread executes launch functions in submission order;
    `depth` bounds submitted-but-unjoined handles. Consumers MUST join
    handles in submission order (the pipelines do) — a submit past the
    depth blocks until the oldest handle is joined, which is the
    backpressure that keeps device memory and launch backlog bounded.
    """

    def __init__(self, depth: int | None = None, name: str = "default", launch_ledger: bool = True) -> None:
        self.name = name
        # False = this queue carries host-side work, which must not mint
        # device launch-ledger records
        self.launch_ledger = launch_ledger
        self.depth = max(1, DISPATCH_DEPTH if depth is None else depth)
        self._sem = threading.Semaphore(self.depth)
        self._work: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        self._thread: threading.Thread | None = None
        self._thread_lock = ranked_lock("dispatch.worker")
        self._state_lock = ranked_lock("dispatch.state")
        self._inflight = 0
        self._closed = False

    # -- plumbing ----------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name=f"dispatch-{self.name}", daemon=True
                )
                self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._work.get()
            if item is _STOP:
                return
            item._run_launch()

    def _release(self) -> None:
        with self._state_lock:
            self._inflight -= 1
            _metrics.DISPATCH_INFLIGHT.labels(queue=self.name).set(self._inflight)
        self._sem.release()

    # -- API ---------------------------------------------------------------

    def inflight(self) -> int:
        with self._state_lock:
            return self._inflight

    def submit(self, launch_fn, finalize_fn=None, kind: str = "verify") -> VerifyHandle:
        """Enqueue one launch; blocks while `depth` handles are already
        in flight (joined-in-order consumers never block here — they
        join the oldest handle before submitting past the depth)."""
        if self._closed:
            raise RuntimeError(f"dispatch queue {self.name!r} is closed")
        self._ensure_worker()
        if not self._sem.acquire(timeout=_STALL_TIMEOUT_S):
            raise RuntimeError(
                f"dispatch queue {self.name!r} stalled: {self.depth} handles "
                f"in flight and none joined within {_STALL_TIMEOUT_S}s"
            )
        with self._state_lock:
            self._inflight += 1
            _metrics.DISPATCH_INFLIGHT.labels(queue=self.name).set(self._inflight)
        handle = VerifyHandle(self, launch_fn, finalize_fn, kind)
        self._work.put(handle)
        return handle

    def close(self) -> None:
        """Stop accepting work and let the worker exit after the current
        backlog. In-flight handles remain joinable."""
        self._closed = True
        if self._thread is not None:
            self._work.put(_STOP)


def measured_launch_apply_ratio(queue: str | None = None) -> float | None:
    """launch:apply ratio inferred from the overlap histogram this
    module already exports: a handle's overlap `o` is the share of its
    life the consumer spent on OTHER work (host prep + ABCI applies), so
    blocked:overlapped = (1-o):o estimates device-launch time vs host
    apply time. None until any handle has been joined.

    Consumers of the estimate: the fast-sync pipeline sizes its depth
    (≈ 1 + ratio windows keeps the device busy while one applies) and
    the verify coalescer scales its flush window (launch-dominated
    pipelines amortize more per merged launch). `queue` narrows to one
    pipeline's series; None aggregates all of them.
    """
    from tendermint_tpu_torch.telemetry import REGISTRY

    fam = REGISTRY.get("tendermint_dispatch_overlap_ratio")
    if fam is None:
        return None
    total = 0.0
    count = 0
    for values, snap in fam.samples():
        if queue is not None and values != (queue,):
            continue
        total += snap["sum"]
        count += snap["count"]
    if count == 0:
        return None
    o = min(max(total / count, 0.01), 0.99)
    return (1.0 - o) / o


_DEFAULT_QUEUE: DispatchQueue | None = None
_DEFAULT_LOCK = ranked_lock("dispatch.global")


def default_dispatch_queue() -> DispatchQueue:
    """Process-wide queue for call sites that don't own a pipeline
    (ad-hoc async verifies). Pipelined consumers (fast-sync, the
    consensus vote drain) create their OWN queues so one consumer's
    unjoined handles can never backpressure another."""
    global _DEFAULT_QUEUE
    if _DEFAULT_QUEUE is None:
        with _DEFAULT_LOCK:
            if _DEFAULT_QUEUE is None:
                _DEFAULT_QUEUE = DispatchQueue(name="default")
    return _DEFAULT_QUEUE
