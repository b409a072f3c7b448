"""Fault-tolerant device dispatch: health-checked verify and hash
backends (counterpart of `tendermint_tpu/services/resilient.py`).

A sick device (a hung dispatch, or a fault injected to drill the
node's degradation) must degrade a node, not kill it.
`ResilientVerifier` / `ResilientTreeHasher` wrap a primary (device)
backend and a host fallback behind a shared `CircuitBreaker`
(`utils/circuit.py`):

* every primary call gets bounded retries with jittered backoff
  (`utils/backoff.py`) and an optional dispatch timeout;
* N consecutive failures trip the breaker OPEN — calls route straight
  to the host fallback (no device latency tax while it is sick);
* after a reset window one probe call tests the device; success closes
  the breaker and the node re-upgrades.

What counts as a failure is narrower than in the JAX package, which
degrades on any exception: here only an `InjectedDeviceFault` (a
mesh's `ShardDeviceFault` among them), this layer's own
`DispatchTimeout` and a `MeshExhaustedError` (every shard of a mesh
faulted out) do. A real build, launch or CUDA error of
the port's kernels raises to the caller, untouched by the breaker, so
that a broken kernel is never answered for by host crypto.

Deterministic fault injection rides `utils/fail.py`
(`TENDERMINT_TPU_DEVICE_FAIL=verify:3` style). Transitions are logged
through `utils/log.py` and exported through `snapshot()`.

Env knobs (all optional):
  TENDERMINT_TPU_BREAKER_THRESHOLD   consecutive failures to trip (3)
  TENDERMINT_TPU_BREAKER_RESET_S     OPEN -> probe window seconds (5)
  TENDERMINT_TPU_DEVICE_RETRIES      in-call retries before failing (1)
  TENDERMINT_TPU_DEVICE_TIMEOUT_S    per-dispatch timeout (0 = none)
  TENDERMINT_TPU_DEVICE_FAIL         fault injection spec (utils/fail.py)
"""

from __future__ import annotations

import logging
import os
import time
from typing import Sequence

import numpy as np

from tendermint_tpu_torch.parallel.mesh import MeshExhaustedError
from tendermint_tpu_torch.services.hasher import TreeHasher
from tendermint_tpu_torch.services.verifier import (
    BatchVerifier,
    HostBatchVerifier,
    Triple,
)
from tendermint_tpu_torch.utils.backoff import backoff_delay
from tendermint_tpu_torch.utils.circuit import CircuitBreaker
from tendermint_tpu_torch.utils.fail import InjectedDeviceFault, device_fail_point
from tendermint_tpu_torch.utils.log import kv, logger

_log = logger("resilient")


class DispatchTimeout(TimeoutError):
    """A primary call outlasted the dispatch timeout."""


# the failures this layer answers with the host fallback
DEGRADABLE = (InjectedDeviceFault, DispatchTimeout, MeshExhaustedError)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


class _ResilientDispatch:
    """Shared breaker-guarded call plumbing for both services."""

    def __init__(
        self,
        kind: str,
        breaker: CircuitBreaker | None = None,
        max_retries: int | None = None,
        retry_base_s: float = 0.05,
        dispatch_timeout_s: float | None = None,
    ) -> None:
        self._kind = kind
        self._breaker = breaker or CircuitBreaker(
            failure_threshold=_env_int("TENDERMINT_TPU_BREAKER_THRESHOLD", 3),
            reset_timeout_s=_env_float("TENDERMINT_TPU_BREAKER_RESET_S", 5.0),
        )
        # telemetry + transition logs attach to externally supplied
        # breakers too (chaos tests hand in tuned ones and still expect
        # the exported trip/recovery counters to move)
        self._breaker.bind_telemetry(kind)
        self._breaker.add_state_listener(self._log_transition)
        self._max_retries = (
            _env_int("TENDERMINT_TPU_DEVICE_RETRIES", 1)
            if max_retries is None
            else max_retries
        )
        self._retry_base_s = retry_base_s
        self._timeout_s = (
            _env_float("TENDERMINT_TPU_DEVICE_TIMEOUT_S", 0.0)
            if dispatch_timeout_s is None
            else dispatch_timeout_s
        )
        self._executor = None
        self.fallback_calls = 0
        self.primary_calls = 0

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def _log_transition(self, old: str, new: str) -> None:
        level = logging.WARNING if new != "closed" else logging.INFO
        kv(
            _log,
            level,
            f"{self._kind} backend breaker {old} -> {new}",
            kind=self._kind,
            **{
                k: v
                for k, v in self._breaker.snapshot().items()
                if k != "state"
            },
        )

    def _run_with_timeout(self, fn, args, kwargs):
        """Optional hung-dispatch guard. The worker thread cannot be
        killed — a genuinely wedged launch leaks its thread — but the
        caller unblocks, the failure is counted, and the host fallback
        answers; that is the trade this layer exists to make."""
        if self._timeout_s <= 0:
            return fn(*args, **kwargs)
        from concurrent.futures import ThreadPoolExecutor, TimeoutError as FutTimeout

        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"{self._kind}-dispatch"
            )
        future = self._executor.submit(fn, *args, **kwargs)
        try:
            return future.result(timeout=self._timeout_s)
        except FutTimeout:
            future.cancel()
            raise DispatchTimeout(
                f"{self._kind} device dispatch exceeded {self._timeout_s}s"
            ) from None

    def call(self, primary_fn, fallback_fn, *args, **kwargs):
        """Route one operation: primary behind the breaker (with retries
        + fault injection + timeout), host fallback otherwise. Errors
        outside `DEGRADABLE` raise to the caller."""
        from tendermint_tpu_torch.telemetry import metrics

        if self._breaker.allow():
            for attempt in range(1 + max(0, self._max_retries)):
                try:
                    device_fail_point(self._kind)
                    out = self._run_with_timeout(primary_fn, args, kwargs)
                    self._breaker.record_success()
                    self.primary_calls += 1
                    metrics.DISPATCH_PRIMARY.labels(kind=self._kind).inc()
                    return out
                except DEGRADABLE as e:
                    self._breaker.record_failure()
                    metrics.DISPATCH_FAILURES.labels(kind=self._kind).inc()
                    kv(
                        _log,
                        logging.WARNING,
                        f"{self._kind} device dispatch failed",
                        kind=self._kind,
                        attempt=attempt,
                        error=f"{type(e).__name__}: {e}"[:120],
                        breaker=self._breaker.state,
                    )
                    if (
                        attempt < self._max_retries
                        and self._breaker.allow()
                    ):
                        time.sleep(
                            backoff_delay(attempt, self._retry_base_s, cap=1.0)
                        )
                        continue
                    break
        self.fallback_calls += 1
        metrics.DISPATCH_FALLBACK.labels(kind=self._kind).inc()
        return fallback_fn(*args, **kwargs)

    def call_async(self, queue, launch_primary, finalize_primary, fallback_fn):
        """Async analog of `call` for the dispatch pipeline: the launch
        runs on the queue worker, the finalize at the consumer's join.

        Breaker fallback propagates THROUGH the handle — a `DEGRADABLE`
        fault at either stage records the failure and resolves the
        handle via the host fallback instead of raising into the
        pipeline consumer; any other error raises at the join.
        One primary attempt, no in-call retries: a retry would stall
        every launch queued behind this one; the breaker is the
        cross-call policy."""
        from tendermint_tpu_torch.telemetry import metrics

        def _fallback_now():
            self.fallback_calls += 1
            metrics.DISPATCH_FALLBACK.labels(kind=self._kind).inc()
            return fallback_fn()

        def _record_fault(stage: str, e: BaseException) -> None:
            self._breaker.record_failure()
            metrics.DISPATCH_FAILURES.labels(kind=self._kind).inc()
            kv(
                _log,
                logging.WARNING,
                f"{self._kind} async device dispatch failed",
                kind=self._kind,
                stage=stage,
                error=f"{type(e).__name__}: {e}"[:120],
                breaker=self._breaker.state,
            )

        def _launch():
            if self._breaker.allow():
                try:
                    device_fail_point(self._kind)
                    return ("primary", self._run_with_timeout(launch_primary, (), {}))
                except DEGRADABLE as e:
                    _record_fault("launch", e)
            return ("fallback", _fallback_now())

        def _finalize(tagged):
            tag, payload = tagged
            if tag == "fallback":
                return payload
            try:
                out = finalize_primary(payload)
            except DEGRADABLE as e:
                # in-flight launch faulted: host re-verify, not an
                # exception in the consumer
                _record_fault("finalize", e)
                return _fallback_now()
            self._breaker.record_success()
            self.primary_calls += 1
            metrics.DISPATCH_PRIMARY.labels(kind=self._kind).inc()
            return out

        return queue.submit(_launch, _finalize, kind=self._kind)

    def snapshot(self) -> dict:
        out = self._breaker.snapshot()
        out.update(
            kind=self._kind,
            primary_calls=self.primary_calls,
            fallback_calls=self.fallback_calls,
        )
        return out


class ResilientVerifier(BatchVerifier):
    """BatchVerifier that survives its device backend.

    Implements the full verifier surface (verify_batch, verify_commits,
    prebuild, warm_kernels) so VoteSet, ValidatorSet.verify_commit,
    fast-sync, and the certifier can use it as a drop-in wherever
    `default_verifier()` hands it out.
    """

    def __init__(
        self,
        primary: BatchVerifier,
        fallback: BatchVerifier | None = None,
        breaker: CircuitBreaker | None = None,
        max_retries: int | None = None,
        dispatch_timeout_s: float | None = None,
    ) -> None:
        super().__init__()
        self.primary = primary
        self.fallback = fallback if fallback is not None else HostBatchVerifier()
        self._dispatch = _ResilientDispatch(
            "verify",
            breaker=breaker,
            max_retries=max_retries,
            dispatch_timeout_s=dispatch_timeout_s,
        )

    @property
    def breaker(self) -> CircuitBreaker:
        return self._dispatch.breaker

    @property
    def degraded(self) -> bool:
        return self._dispatch.breaker.state != "closed"

    @property
    def mesh(self):
        """The primary's `MeshManager` when the device backend is
        sharded (None otherwise): the coalescer reads the mesh size to
        scale its merge cap, dashboards read the snapshot."""
        return getattr(self.primary, "mesh", None)

    def snapshot(self) -> dict:
        out = self._dispatch.snapshot()
        mesh = self.mesh
        if mesh is not None:
            out["mesh"] = mesh.snapshot()
        return out

    def verify_batch(self, triples: Sequence[Triple]) -> np.ndarray:
        return self._dispatch.call(
            self.primary.verify_batch, self.fallback.verify_batch, triples
        )

    def verify_batch_async(
        self, triples: Sequence[Triple], queue=None, consumer: str = "default"
    ):
        """Breaker-guarded async verify: the handle resolves to a
        verdict mask — a degradable fault re-verifies on host at the
        join instead of raising into the pipeline."""
        from tendermint_tpu_torch.services.dispatch import default_dispatch_queue

        q = queue if queue is not None else default_dispatch_queue()
        return self._dispatch.call_async(
            q,
            lambda: self.primary.launch_verify_batch(triples),
            self.primary.finalize_verify_batch,
            lambda: self.fallback.verify_batch(triples),
        )

    def verify_commits_async(
        self, pubkeys, commits, queue=None, force_fused=None, consumer="default"
    ):
        """Async commit-grid verify with the same guarantee: degradable
        faults at launch OR materialization fall back to the host commit
        loop inside the handle."""
        from tendermint_tpu_torch.services.dispatch import default_dispatch_queue

        q = queue if queue is not None else default_dispatch_queue()
        if hasattr(self.primary, "launch_verify_commits"):
            return self._dispatch.call_async(
                q,
                lambda: self.primary.launch_verify_commits(
                    pubkeys, commits, force_fused=force_fused
                ),
                self.primary.finalize_verify_commits,
                lambda: self._host_verify_commits(pubkeys, commits),
            )
        # primary without the commit-grid surface: host loop, but still
        # on the queue worker so the submitter's host work overlaps
        return q.submit(
            lambda: self._host_verify_commits(pubkeys, commits), kind="verify"
        )

    def verify_commits(self, pubkeys, commits, force_fused=None):
        """K commits over one valset -> (K, N) verdicts; host loop when
        the primary lacks the fused path or the breaker is open."""
        if hasattr(self.primary, "verify_commits"):
            return self._dispatch.call(
                lambda: self.primary.verify_commits(
                    pubkeys, commits, force_fused=force_fused
                ),
                lambda: self._host_verify_commits(pubkeys, commits),
            )
        return self._host_verify_commits(pubkeys, commits)

    def _host_verify_commits(self, pubkeys, commits) -> np.ndarray:
        n, k = len(pubkeys), len(commits)
        out = np.zeros((k, n), dtype=bool)
        for ci, (msgs, sigs) in enumerate(commits):
            lanes = [
                i for i in range(n) if msgs[i] is not None and sigs[i] is not None
            ]
            if not lanes:
                continue
            verdicts = self.fallback.verify_batch(
                [(pubkeys[i], msgs[i], sigs[i]) for i in lanes]
            )
            for i, v in zip(lanes, verdicts):
                out[ci, i] = v
        return out

    # table warming is never worth dispatching to a device the breaker
    # says is sick
    def prebuild(self, pubkeys) -> None:
        if hasattr(self.primary, "prebuild") and self.breaker.state == "closed":
            self.primary.prebuild(pubkeys)

    def warm_kernels(self):
        if hasattr(self.primary, "warm_kernels") and self.breaker.state == "closed":
            return self.primary.warm_kernels()
        return None

    def close(self) -> None:
        if hasattr(self.primary, "close"):
            self.primary.close()


class ResilientTreeHasher(TreeHasher):
    """TreeHasher that degrades device Merkle builds to host hashlib.

    Subclasses TreeHasher so every call site (`Block.make_block`,
    part-set builds, fast-sync stores) keeps its type expectations; only
    the two root builders dispatch through the breaker — proofs are
    host-side already.
    """

    def __init__(
        self,
        primary: TreeHasher | None = None,
        fallback: TreeHasher | None = None,
        breaker: CircuitBreaker | None = None,
        max_retries: int | None = None,
        dispatch_timeout_s: float | None = None,
    ) -> None:
        primary = primary if primary is not None else TreeHasher(backend="device")
        super().__init__(
            backend=primary.backend,
            algo=primary.algo,
            min_device_leaves=primary.min_device_leaves,
            device=primary.device,
            mesh=primary.mesh,
        )
        self.primary = primary
        self.fallback = (
            fallback
            if fallback is not None
            else TreeHasher(backend="host", algo=primary.algo)
        )
        self._dispatch = _ResilientDispatch(
            "hash",
            breaker=breaker,
            max_retries=max_retries,
            dispatch_timeout_s=dispatch_timeout_s,
        )

    @property
    def breaker(self) -> CircuitBreaker:
        return self._dispatch.breaker

    @property
    def degraded(self) -> bool:
        return self._dispatch.breaker.state != "closed"

    def snapshot(self) -> dict:
        return self._dispatch.snapshot()

    def root_from_items(self, items: list[bytes]) -> bytes:
        return self._dispatch.call(
            self.primary.root_from_items, self.fallback.root_from_items, items
        )

    def root_from_hashes(self, hashes: list[bytes]) -> bytes:
        return self._dispatch.call(
            self.primary.root_from_hashes, self.fallback.root_from_hashes, hashes
        )

    def leaf_hashes(self, items: list[bytes]) -> list[bytes]:
        return self._dispatch.call(
            self.primary.leaf_hashes, self.fallback.leaf_hashes, items
        )

    def leaf_hashes_async(self, items: list[bytes], queue=None):
        """Breaker-guarded async leaf hashing (the statesync chunk-
        verify gate): the handle resolves to the per-item hashes, with
        device faults degrading to host hashlib inside the handle."""
        from tendermint_tpu_torch.services.dispatch import default_dispatch_queue

        q = queue if queue is not None else default_dispatch_queue()
        return self._dispatch.call_async(
            q,
            lambda: self.primary.leaf_hashes(items),
            lambda hashes: hashes,
            lambda: self.fallback.leaf_hashes(items),
        )

    def proofs(self, items: list[bytes]):
        return self.fallback.proofs(items)
