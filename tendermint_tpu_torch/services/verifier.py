"""BatchVerifier: accumulate→flush ed25519 verification service.

Counterpart of `tendermint_tpu/services/verifier.py`:

* `verify_batch(triples)` — synchronous batch verdicts;
* `add(pk, msg, sig)` / `flush()` — accumulation across call sites,
  flushed as one batch with per-item verdicts.

Backends: `HostBatchVerifier` (sequential pure-Python RFC 8032),
`DeviceBatchVerifier` (the generic ladder, `ops.ed25519_kernel`, padded
to power-of-two buckets) and `TableBatchVerifier` (cached per-validator
comb tables, `ops.ed25519_tables`: the consensus and fast-sync path),
and their sharded counterparts over a `parallel.mesh.MeshManager`:
`ShardedBatchVerifier` (flat lanes over every active shard) and
`ShardedTableBatchVerifier` (table columns split along the validator
axis), which re-mesh onto the survivors of a shard fault.

Device backends run on the CUDA card unless constructed with
`device="cpu"`; without a card and without a device they raise. A
verify-kernel failure raises to the caller. `default_verifier()` hands
out the wrapper of `services/resilient.py`, which reroutes to host
crypto only on an injected device fault or a dispatch timeout.
Comb-table construction has its own breaker here: an injected build
fault degrades to a build on the CPU (small sets) or to host crypto.

Every backend also has the async surface of `services/dispatch.py`
(`verify_batch_async`, and `verify_commits_async` on the table backend),
and reports its calls to the metric catalog and the launch ledger
(`telemetry/`): padded rows, mesh width and host->device bytes at the
launch, the executing backend and its rows at the finalize.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from tendermint_tpu_torch.crypto.keys import PUBKEY_LEN, PubKey
from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.ops.ed25519_kernel import (
    bucket_size,
    launch_batch_verify,
    materialize_batch_verify,
    prepare_batch,
)
from tendermint_tpu_torch.ops.ed25519_tables import (
    build_key_tables,
    host_build_key_tables,
    prepare_commit_lanes,
    verify_tables_kernel,
)
from tendermint_tpu_torch.ops.padding import pad_rows_to
from tendermint_tpu_torch.parallel.mesh import (
    MeshExhaustedError,
    MeshManager,
    default_mesh_manager,
    gather_verdicts,
    mesh_device_count,
    shard_lanes_validator_major,
    unshard_lanes_validator_major,
)
from tendermint_tpu_torch.telemetry import launchlog as _launchlog
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.utils import shutdown
from tendermint_tpu_torch.utils.circuit import CircuitBreaker
from tendermint_tpu_torch.utils.fail import InjectedDeviceFault, ShardDeviceFault, device_fail_point
from tendermint_tpu_torch.utils.log import kv, logger

Triple = tuple[bytes, bytes, bytes]  # (pubkey32, message, signature64)


def _observe_verify(backend: str, n: int, seconds: float, kind: str = "verify") -> None:
    """One verify call's worth of telemetry. Each executing backend
    reports itself, so a resilient host fallback shows up under
    backend="host" while the failed device attempt stays with the
    dispatch-failure counters. Also annotates or closes the ambient
    launch-ledger record; the table paths pass kind="tables"."""
    _metrics.VERIFY_BATCH_SIZE.labels(backend=backend).observe(n)
    _metrics.VERIFY_SECONDS.labels(backend=backend).observe(seconds)
    _launchlog.observe(kind, backend, n, seconds)


def _nbytes(arrays) -> int:
    return int(sum(a.nbytes for a in arrays))


class BatchVerifier:
    """Interface + shared accumulate/flush bookkeeping."""

    # Every verifier here tolerates the `consumer=` tag on its async
    # surface (the coalescer uses it for fairness and wait telemetry;
    # plain backends ignore it); call sites gate on this attribute
    # (`services/batcher.py::consumer_kwargs`).
    accepts_consumer = True

    def verify_batch(self, triples: Sequence[Triple]) -> np.ndarray:
        raise NotImplementedError

    def __init__(self) -> None:
        self._pending: list[Triple] = []

    def add(self, pubkey: bytes, msg: bytes, sig: bytes) -> int:
        """Queue a triple; returns its index into the next flush()'s mask."""
        self._pending.append((pubkey, msg, sig))
        return len(self._pending) - 1

    def pending(self) -> int:
        return len(self._pending)

    def flush(self) -> np.ndarray:
        """Verify everything queued since the last flush; per-item verdicts."""
        triples, self._pending = self._pending, []
        if not triples:
            return np.zeros(0, dtype=bool)
        return self.verify_batch(triples)

    def verify_one(self, pubkey: bytes, msg: bytes, sig: bytes) -> bool:
        return bool(self.verify_batch([(pubkey, msg, sig)])[0])

    # Backends split a verify into `launch` (host prep + kernel launch —
    # the card computes in the background) and `finalize` (copy back +
    # mask). The base implementation has no device half.

    def launch_verify_batch(self, triples: Sequence[Triple]):
        return self.verify_batch(triples)

    def finalize_verify_batch(self, launched) -> np.ndarray:
        return launched

    def verify_batch_async(self, triples: Sequence[Triple], queue=None, consumer: str = "default"):
        """Submit a batch verify through a `DispatchQueue`; returns a
        `VerifyHandle` whose `.result()` yields the mask `verify_batch`
        would. The verdict stays on the card until the join. `consumer`
        only matters to the coalescing wrapper."""
        from tendermint_tpu_torch.services.dispatch import default_dispatch_queue

        q = queue if queue is not None else default_dispatch_queue()
        return q.submit(
            lambda: self.launch_verify_batch(triples),
            self.finalize_verify_batch,
            kind="verify",
        )


class HostBatchVerifier(BatchVerifier):
    """Sequential host backend over the pure-Python `PubKey`."""

    def verify_batch(self, triples: Sequence[Triple]) -> np.ndarray:
        t0 = time.perf_counter()
        out = np.zeros(len(triples), dtype=bool)
        for i, (pk, msg, sig) in enumerate(triples):
            if len(pk) != PUBKEY_LEN:
                continue
            out[i] = PubKey(pk).verify(msg, sig)
        _observe_verify("host", len(triples), time.perf_counter() - t0)
        return out


# Below this many lanes the host answers: single votes and small commits
# must never wait on a kernel launch (the consensus hot path verifies one
# gossiped vote at a time).
DEVICE_MIN_BATCH = int(os.environ.get("TENDERMINT_TPU_MIN_DEVICE_BATCH", "512"))


class DeviceBatchVerifier(BatchVerifier):
    """Batched backend over `ops.ed25519_kernel.launch_batch_verify`.

    Batches are padded to power-of-two buckets (min 8) inside the
    launch; on the card every bucket takes the ladder kernel. Batches
    smaller than DEVICE_MIN_BATCH go to the host verifier.
    """

    def __init__(self, device=None, min_device_batch: int | None = None) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self._host = HostBatchVerifier()
        self._min_batch = (
            DEVICE_MIN_BATCH if min_device_batch is None else min_device_batch
        )

    def verify_batch(self, triples: Sequence[Triple]) -> np.ndarray:
        return self.finalize_verify_batch(self.launch_verify_batch(triples))

    def launch_verify_batch(self, triples: Sequence[Triple]):
        """Host prep + kernel launch; the verdict tensor is not yet
        synchronised (sub-minimum batches answer on the host at once)."""
        if not triples:
            return ("host", np.zeros(0, dtype=bool))
        if len(triples) < self._min_batch:
            return ("host", self._host.verify_batch(triples))
        pubs, msgs, sigs = zip(*triples)
        t0 = time.perf_counter()
        launched = launch_batch_verify(
            list(pubs), list(msgs), list(sigs), device=self.device
        )
        # the launch pads to the power-of-two bucket and ships four
        # (size, 32) uint8 arrays
        size = bucket_size(len(triples))
        _launchlog.annotate(_additive=True, rows_padded=size - len(triples))
        _launchlog.add_transfer(4 * size * 32)
        return ("device", launched, t0)

    def finalize_verify_batch(self, launched) -> np.ndarray:
        if launched[0] == "host":
            return launched[1]
        _tag, payload, t0 = launched
        out = materialize_batch_verify(payload)
        # launch -> copied back, the time in flight included
        _observe_verify("device", len(out), time.perf_counter() - t0)
        return out


def _table_keys(pubkeys):
    """(pubkeys with every malformed key replaced by the identity's
    encoding, length_ok): a malformed key degrades to a False verdict,
    as on every other backend, instead of corrupting the table build."""
    length_ok = np.array([len(pk) == 32 for pk in pubkeys], dtype=bool)
    if not length_ok.all():
        placeholder = b"\x01" + b"\x00" * 31  # identity point encoding
        pubkeys = [pk if ok else placeholder for pk, ok in zip(pubkeys, length_ok)]
    return pubkeys, length_ok


class TableBuildError(RuntimeError):
    """Comb-table construction is unavailable (the device build faulted
    and the set is too large to build on the CPU); callers answer with
    host crypto."""


class TableBatchVerifier(DeviceBatchVerifier):
    """Validator-set-table backend: the steady-state consensus path.

    Commit-shaped verification (lanes aligned to a known validator set)
    routes through per-validator comb tables (`ops.ed25519_tables`)
    built on the card once per validator set and cached by the SHA-256
    of its pubkey sequence. One launch verifies K stacked commits: stacks
    of K >= FUSED_MIN_STACK (fast-sync windows) take the fused kernel,
    single commits and small stacks the entries chain.
    """

    # diffs up to this many new keys build on the host (Python ints, no
    # device work); larger diffs build the missing keys on the device
    MAX_INCREMENTAL_KEYS = 128

    def __init__(
        self,
        device=None,
        cache_size: int = 4,
        min_device_batch: int | None = None,
    ) -> None:
        super().__init__(device, min_device_batch)
        # key -> (pubkeys tuple, tables, ok)
        self._tables: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._cache_size = cache_size
        self._cache_lock = threading.RLock()
        # key -> the thread of a `prebuild` still running; `close` stops them
        self._prebuilds: dict[bytes, threading.Thread] = {}
        self._closed = threading.Event()
        # Table construction has its own breaker: it is separate work
        # from the verify kernels and can be sick on its own. N build
        # faults stop the device builds; small sets then build on the
        # CPU while the verify kernels stay on the card.
        self._build_breaker = CircuitBreaker(
            failure_threshold=int(os.environ.get("TENDERMINT_TPU_BREAKER_THRESHOLD", 3)),
            reset_timeout_s=float(os.environ.get("TENDERMINT_TPU_BREAKER_RESET_S", 5.0)),
            name="tables",
        )

    @staticmethod
    def _cache_key(pubkeys: tuple[bytes, ...]) -> bytes:
        return hashlib.sha256(b"".join(pubkeys)).digest()

    def _incremental_build(self, pubkeys: tuple[bytes, ...]):
        """Assemble tables for `pubkeys` from the cached set with the
        largest overlap: gather the shared columns on the device, build
        only the new keys. Returns None when no cached set shares a key
        (validator-set diffs touch few keys, so turnover is usually
        tiny)."""
        with self._cache_lock:
            best = None
            for _k, (old_pubs, old_t, old_ok) in self._tables.items():
                pos = {pk: i for i, pk in enumerate(old_pubs)}
                hits = sum(1 for pk in pubkeys if pk in pos)
                if best is None or hits > best[0]:
                    best = (hits, pos, old_t, old_ok)
        if best is None or best[0] == 0:
            return None
        _hits, pos, old_t, old_ok = best
        missing = [pk for pk in pubkeys if pk not in pos]
        if missing:
            if len(missing) <= self.MAX_INCREMENTAL_KEYS:
                new_t, new_ok = host_build_key_tables(missing)
                new_t = torch.from_numpy(new_t).to(self.device)
            else:
                miss_arr = np.frombuffer(b"".join(missing), dtype=np.uint8)
                new_t, new_ok = build_key_tables(
                    miss_arr.reshape(-1, 32), device=self.device
                )
            combined = torch.cat([old_t, new_t], dim=3)
            ok_comb = np.concatenate([old_ok, new_ok])
        else:  # same keys, different order/subset: pure gather
            combined, ok_comb = old_t, old_ok
        new_pos = {pk: i for i, pk in enumerate(missing)}
        n_old = len(pos)
        perm = np.array(
            [pos.get(pk, n_old + new_pos.get(pk, 0)) for pk in pubkeys],
            dtype=np.int64,
        )
        tables = torch.index_select(
            combined, 3, torch.from_numpy(perm).to(self.device)
        ).contiguous()
        return tables, ok_comb[perm]

    def tables_for(self, pubkeys: tuple[bytes, ...]):
        """(tables on the device, ok numpy) for a validator set: from the
        cache, else built (and cached) now."""
        key = self._cache_key(pubkeys)
        with self._cache_lock:
            hit = self._tables.get(key)
            if hit is not None:
                self._tables.move_to_end(key)
                _metrics.TABLE_CACHE.labels(event="hit").inc()
                return hit[1], hit[2]
        _metrics.TABLE_CACHE.labels(event="miss").inc()
        tables, ok = self._build_tables(pubkeys)
        with self._cache_lock:
            self._tables[key] = (tuple(pubkeys), tables, ok)
            while len(self._tables) > self._cache_size:
                self._tables.popitem(last=False)
        return tables, ok

    def _build_tables(self, pubkeys: tuple[bytes, ...]):
        """Tables for an uncached set, behind the table-build breaker:
        the device build (incremental when a cached set overlaps). An
        injected fault, or an open breaker, degrades to the torch build
        on the CPU, moved to the device, for sets of at most
        MAX_INCREMENTAL_KEYS keys, else raises `TableBuildError` so the
        verify answers with host crypto. A real build error raises to
        the caller."""
        pub = np.frombuffer(b"".join(pubkeys), dtype=np.uint8).reshape(len(pubkeys), 32)
        if self._build_breaker.allow():
            try:
                device_fail_point("tables")
                built = self._incremental_build(pubkeys)
                if built is not None:
                    _metrics.TABLE_CACHE.labels(event="incremental").inc()
                else:
                    built = build_key_tables(pub, device=self.device)
                self._build_breaker.record_success()
                return built
            except InjectedDeviceFault as e:
                self._build_breaker.record_failure()
                kv(
                    logger("resilient"),
                    logging.WARNING,
                    "table build failed",
                    n_keys=len(pubkeys),
                    error=f"{type(e).__name__}: {e}"[:120],
                    breaker=self._build_breaker.state,
                )
        if len(pubkeys) <= self.MAX_INCREMENTAL_KEYS:
            _metrics.TABLE_CACHE.labels(event="host_build").inc()
            tables, ok = build_key_tables(pub, device="cpu")
            return tables.to(self.device), ok
        raise TableBuildError(
            f"table build unavailable for {len(pubkeys)} keys "
            f"(breaker {self._build_breaker.state})"
        )

    def prebuild(self, pubkeys) -> None:
        """Warm the table cache for a validator set in the background —
        called when a rotation is decided, so the first verify against
        the next set doesn't stall on a build. At most one build a set
        runs at a time; an exiting interpreter stops it between steps
        (`utils/shutdown.py`)."""
        pubs = tuple(bytes(pk) for pk in pubkeys)
        key = self._cache_key(pubs)
        with self._cache_lock:
            if key in self._tables or key in self._prebuilds or self._closed.is_set():
                return
            self._prebuilds[key] = shutdown.start_thread(
                self._prebuild, "table-prebuild", key, pubs, stop=self._closed
            )

    def _prebuild(self, key: bytes, pubs: tuple[bytes, ...]) -> None:
        try:
            self.tables_for(pubs)
        except TableBuildError as e:  # the verify answers with host crypto
            kv(logger("resilient"), logging.WARNING, "table prebuild unavailable", error=str(e))
        finally:
            with self._cache_lock:
                self._prebuilds.pop(key, None)

    def close(self) -> None:
        """Stop the builds `prebuild` started, between two of their
        steps, and wait for them; no later `prebuild` starts one (a
        node's verifier lives for the process; tests close theirs)."""
        self._closed.set()
        with self._cache_lock:
            threads = list(self._prebuilds.values())
        for t in threads:
            t.join(timeout=shutdown.EXIT_WAIT_S)

    def warm_kernels(self):
        """Do the kernels' first-use work in one background thread,
        which is returned, so that the first verify does not pay for it;
        the node calls this at start. The thread builds or finds the
        kernel library, loads it, creates the CUDA context and runs each
        route once on dummy lanes (`_first_use`), as the JAX package's
        warm-up runs one dummy table build. On the CPU there is nothing
        to warm: returns None at once."""
        if self.device.type != "cuda":
            return None
        from tendermint_tpu_torch.ops import _build

        return _build.warm(self.device, self._first_use)

    def _first_use(self) -> None:
        """One small run of every route on dummy lanes: a table build of
        8 identity keys, a commit through the entries chain, a stack of 8
        through the fused chain, 8 flat lanes through the ladder; each
        ends in the finish. Their verdicts are discarded."""
        keys = np.zeros((8, 32), dtype=np.uint8)
        keys[:, 0] = 1  # identity encodings: decompress cleanly
        tables, _ok = build_key_tables(keys, device=self.device)
        for k, impl in ((1, "entries"), (8, "fused")):
            zero = torch.zeros((8 * k, 32), dtype=torch.uint8, device=self.device)
            verify_tables_kernel(tables, zero, zero, zero, impl=impl)
        pubs = [bytes(keys[0])] * 8
        materialize_batch_verify(launch_batch_verify(pubs, [b""] * 8, [bytes(64)] * 8, device=self.device))

    def verify_commits(
        self,
        pubkeys: Sequence[bytes],
        commits: Sequence[tuple[Sequence[bytes | None], Sequence[bytes | None]]],
        force_fused: bool | None = None,
    ) -> np.ndarray:
        """K commits over one N-validator set -> (K, N) bool verdicts.

        Each commit is (msgs, sigs): length-N sequences aligned to
        validator index, None marking absent votes (absent lanes report
        False). The K*N lanes verify in one launch against the cached
        tables; fast-sync stacks a window of commits into one call, and
        the stack depth picks the chain (`verify_tables_kernel`).

        `force_fused` overrides that pick: True takes the fused chain,
        False the entries chain, None decides by the stack depth."""
        return self.finalize_verify_commits(
            self.launch_verify_commits(pubkeys, commits, force_fused=force_fused)
        )

    def launch_verify_commits(self, pubkeys, commits, force_fused: bool | None = None):
        """Async half of `verify_commits`: lane prep + one kernel launch,
        the verdict tensor not yet synchronised. Paths with no device
        half (small commits, the table-build degradation) compute on the
        host on the spot and tag themselves "host"."""
        n = len(pubkeys)
        k = len(commits)
        if n == 0 or k == 0:
            return ("host", np.zeros((k, n), dtype=bool))
        if k * n < self._min_batch:
            return ("host", self._host_commit_loop(pubkeys, commits))
        pubkeys, length_ok = _table_keys(pubkeys)
        try:
            tables, key_ok = self.tables_for(tuple(pubkeys))
        except TableBuildError:
            # table construction is down and the set is too big to
            # build on the CPU: host crypto answers (slow but correct)
            return ("host", self._host_commit_loop(pubkeys, commits))
        key_ok = key_ok & length_ok
        impl = {None: "auto", True: "fused", False: "entries"}[force_fused]
        t0 = time.perf_counter()
        s, h, r, precheck = prepare_commit_lanes(pubkeys, commits)
        # one launch over the K x N lanes: no commit padding
        _launchlog.annotate(_additive=True, rows_padded=0)
        _launchlog.add_transfer(_nbytes((s, h, r)))
        s, h, r = (torch.from_numpy(a).to(self.device) for a in (s, h, r))
        dev = verify_tables_kernel(tables, s, h, r, impl=impl)
        return ("device", dev, precheck, key_ok, n, k, t0)

    def finalize_verify_commits(self, launched) -> np.ndarray:
        if launched[0] == "host":
            return launched[1]
        _tag, dev, precheck, key_ok, n, k, t0 = launched
        out = dev.cpu().numpy() & precheck & np.tile(key_ok, k)
        _observe_verify("tables", k * n, time.perf_counter() - t0, kind="tables")
        return out.reshape(k, n)

    def verify_commits_async(
        self,
        pubkeys,
        commits,
        queue=None,
        force_fused: bool | None = None,
        consumer: str = "default",
    ):
        """`verify_commits` through the dispatch queue: a VerifyHandle
        resolving to the (K, N) verdict grid, the kernels in flight
        until the consumer joins."""
        from tendermint_tpu_torch.services.dispatch import default_dispatch_queue

        q = queue if queue is not None else default_dispatch_queue()
        return q.submit(
            lambda: self.launch_verify_commits(pubkeys, commits, force_fused=force_fused),
            self.finalize_verify_commits,
            kind="verify",
        )

    def _host_commit_loop(self, pubkeys, commits) -> np.ndarray:
        """Sequential host verification of commit-shaped lanes: the
        small-commit path and the table-build degradation target."""
        n = len(pubkeys)
        out = np.zeros((len(commits), n), dtype=bool)
        for ci, (msgs, sigs) in enumerate(commits):
            lanes = [i for i in range(n) if msgs[i] is not None and sigs[i] is not None]
            lane_triples = [(pubkeys[i], msgs[i], sigs[i]) for i in lanes]
            if lane_triples:
                verdicts = self._host.verify_batch(lane_triples)
                for i, v in zip(lanes, verdicts):
                    out[ci, i] = v
        return out


class _MeshFlatMixin:
    """Mesh plumbing shared by the sharded backends: the flat (pub, r,
    s, h) lane over a `parallel.mesh.MeshManager`, with the survivor
    re-mesh loop around every launch.

    Geometry: rows are padded to `bucket_size(ceil(n / n_active)) *
    n_active`, a power-of-two bucket a shard (min 8) times the active
    shards, one contiguous block a shard: the same per-shard buckets
    serve any mesh size.
    """

    mesh: MeshManager  # set by the subclass's __init__

    def _mesh_flat_launch(self, pub, r, s, h, powers):
        """One sharded launch over the active mesh: re-meshes onto the
        survivors of a shard fault, raises `MeshExhaustedError` (into the
        caller's breaker) when no shard remains. Returns (per-shard
        verdicts, tally), not yet copied back."""
        m = self.mesh
        m.maybe_reprobe()
        n = pub.shape[0]
        while True:
            ndev = m.n_active
            if ndev == 0:
                raise MeshExhaustedError(f"all {m.n_total} mesh devices faulted")
            try:
                m.check_shard_faults()
                size = bucket_size(-(-n // ndev)) * ndev
                arrs = pad_rows_to([pub, r, s, h, powers], size)
                out = m.verify_step()(*arrs)
                # annotated on the successful attempt only: a shard fault
                # retried onto the survivors must not count twice
                _launchlog.annotate(_additive=True, rows_padded=size - n)
                _launchlog.annotate(mesh_width=ndev)
                _launchlog.add_transfer(_nbytes(arrs))
                return out
            except ShardDeviceFault as e:
                if not m.record_shard_fault(e.shard):
                    raise MeshExhaustedError(f"all {m.n_total} mesh devices faulted") from e

    def launch_verify_batch(self, triples):
        """Flat-batch async half: host prep and one launch a shard over
        every active shard (the coalescer's merged batches land here: one
        logical device that is N cards). Sub-minimum batches and
        one-shard meshes take the one-device paths."""
        if self.mesh.n_total <= 1:
            return super().launch_verify_batch(triples)
        if not triples:
            return ("host", np.zeros(0, dtype=bool))
        if len(triples) < self._min_batch:
            return ("host", self._host.verify_batch(triples))
        pubs, msgs, sigs = zip(*triples)
        t0 = time.perf_counter()
        pub, r, s, h, precheck = prepare_batch(pubs, msgs, sigs)
        powers = np.zeros(len(triples), dtype=np.int32)
        ok, _total = self._mesh_flat_launch(pub, r, s, h, powers)
        return ("mesh", ok, precheck, len(triples), t0)

    def finalize_verify_batch(self, launched) -> np.ndarray:
        if launched[0] != "mesh":
            return super().finalize_verify_batch(launched)
        _tag, ok, precheck, n, t0 = launched
        out = gather_verdicts(ok)[:n] & precheck
        _observe_verify("mesh", n, time.perf_counter() - t0)
        return out

    def verify_batch_with_powers(self, triples, powers):
        """Commit-tally lane: per-item verdicts and the verified-power
        total summed on the devices across all shards (no host gather
        for the 2/3-quorum sum). Pad rows and precheck-failed rows carry
        zero power, so they never count."""
        if not triples:
            return np.zeros(0, dtype=bool), 0
        pubs, msgs, sigs = zip(*triples)
        t0 = time.perf_counter()
        pub, r, s, h, precheck = prepare_batch(pubs, msgs, sigs)
        pw = np.asarray(powers, dtype=np.int32) * precheck
        ok, total = self._mesh_flat_launch(pub, r, s, h, pw)
        mask = gather_verdicts(ok)[: len(triples)] & precheck
        _observe_verify("mesh", len(triples), time.perf_counter() - t0)
        return mask, int(total)

    def snapshot(self) -> dict:
        return {"mesh": self.mesh.snapshot()}


class ShardedBatchVerifier(_MeshFlatMixin, DeviceBatchVerifier):
    """Flat-ladder batch verifier sharded over a device mesh.

    Every launch splits the batch axis over the active shards of a
    `MeshManager` and sums the power tally on the devices. Commit grids
    flatten their present lanes into the same flat mesh lane and scatter
    the verdicts back, so fast-sync windows and consensus commits ride N
    cards without validator-set tables. The backend's `device` is the
    mesh's first device.
    """

    def __init__(self, mesh: MeshManager | None = None, min_device_batch: int | None = None, device=None) -> None:
        mesh = mesh if mesh is not None else MeshManager(device=device)
        super().__init__(device=mesh.devices[0], min_device_batch=min_device_batch)
        self.mesh = mesh

    def verify_commits(self, pubkeys, commits, force_fused=None) -> np.ndarray:
        return self.finalize_verify_commits(
            self.launch_verify_commits(pubkeys, commits, force_fused=force_fused)
        )

    def launch_verify_commits(self, pubkeys, commits, force_fused=None):
        """Commit grids as flat mesh lanes: the present (msg, sig) lanes
        go into one sharded launch (`force_fused` is a table-path
        choice; ignored here)."""
        n, k = len(pubkeys), len(commits)
        lanes: list[tuple[int, int]] = []
        triples: list[Triple] = []
        for ci, (msgs, sigs) in enumerate(commits):
            for i in range(n):
                if msgs[i] is not None and sigs[i] is not None:
                    lanes.append((ci, i))
                    triples.append((pubkeys[i], msgs[i], sigs[i]))
        if self.mesh.n_total <= 1 or len(triples) < self._min_batch:
            grid = np.zeros((k, n), dtype=bool)
            if triples:
                verdicts = self._host.verify_batch(triples)
                for (ci, i), ok in zip(lanes, verdicts):
                    grid[ci, i] = bool(ok)
            return ("host_grid", grid)
        return ("mesh_grid", self.launch_verify_batch(triples), lanes, k, n)

    def finalize_verify_commits(self, launched) -> np.ndarray:
        if launched[0] == "host_grid":
            return launched[1]
        _tag, flat, lanes, k, n = launched
        mask = self.finalize_verify_batch(flat)
        grid = np.zeros((k, n), dtype=bool)
        for (ci, i), ok in zip(lanes, mask):
            grid[ci, i] = bool(ok)
        return grid

    def verify_commits_async(self, pubkeys, commits, queue=None, force_fused=None, consumer="default"):
        from tendermint_tpu_torch.services.dispatch import default_dispatch_queue

        q = queue if queue is not None else default_dispatch_queue()
        return q.submit(
            lambda: self.launch_verify_commits(pubkeys, commits, force_fused=force_fused),
            self.finalize_verify_commits,
            kind="verify",
        )


class ShardedTableBatchVerifier(_MeshFlatMixin, TableBatchVerifier):
    """The table path over a mesh: the multi-card steady-state backend.

    Commit grids shard along the VALIDATOR axis: each shard holds
    N/n_active of the cached comb-table columns on its device and the
    lanes of its own validators for every stacked commit
    (`shard_lanes_validator_major`), and the power tally is summed on the
    devices. Each shard picks its chain from the stack depth, as
    `verify_tables_kernel(impl="auto")` does. The tables are built once
    on the mesh's first device through `tables_for` (and its build
    breaker), then sliced and placed, cached by (valset, active devices).

    Falls back per call to the one-card table path when the set does not
    split evenly over the active shards (N % n_active != 0), and to flat
    mesh lanes when the mesh's executor has no table step (the host
    executor).
    """

    def __init__(
        self,
        mesh: MeshManager | None = None,
        cache_size: int = 4,
        min_device_batch: int | None = None,
        device=None,
    ) -> None:
        mesh = mesh if mesh is not None else MeshManager(device=device)
        super().__init__(device=mesh.devices[0], cache_size=cache_size, min_device_batch=min_device_batch)
        self.mesh = mesh
        # (valset key, active device tuple) -> per-shard table columns
        self._sharded_tables: dict = {}

    def warm_kernels(self):
        """`TableBatchVerifier.warm_kernels` on every card of the mesh:
        one background thread (returned) that runs the routes on the
        first card and each mesh step's kernels on every card not yet
        warmed (`parallel.mesh.warm_devices`). None on the CPU."""
        if self.device.type != "cuda":
            return None
        from tendermint_tpu_torch.ops import _build
        from tendermint_tpu_torch.parallel.mesh import warm_devices

        def first_use():
            self._first_use()
            warm_devices(self.mesh.devices)

        return _build.warm(self.device, first_use)

    def _tables_for_mesh(self, pubkeys: tuple[bytes, ...], devices: tuple):
        """The set's tables split along the validator axis over `devices`:
        shard i's columns, contiguous on its device (cached by set and
        device tuple), and key_ok."""
        tables, key_ok = self.tables_for(pubkeys)
        key = (self._cache_key(pubkeys), devices)
        with self._cache_lock:
            hit = self._sharded_tables.get(key)
        if hit is not None:
            _metrics.TABLE_DEVICE_CACHE.labels(result="hit").inc()
            return hit, key_ok
        _metrics.TABLE_DEVICE_CACHE.labels(result="miss").inc()
        per = tables.shape[3] // len(devices)
        t_put = time.perf_counter()
        placed = [
            tables[..., i * per : (i + 1) * per].contiguous().to(dev)
            for i, dev in enumerate(devices)
        ]
        # the copy every placement-cache miss pays: its bytes and its
        # stall land on this launch's ledger record
        _launchlog.add_transfer(tables.element_size() * tables.nelement())
        _launchlog.annotate(_additive=True, device_put_s=time.perf_counter() - t_put)
        with self._cache_lock:
            self._sharded_tables[key] = placed
            while len(self._sharded_tables) > self._cache_size * 2:
                self._sharded_tables.pop(next(iter(self._sharded_tables)))
        return placed, key_ok

    def launch_verify_commits(self, pubkeys, commits, force_fused=None):
        n, k = len(pubkeys), len(commits)
        m = self.mesh
        if m.n_total <= 1:
            return super().launch_verify_commits(pubkeys, commits, force_fused=force_fused)
        if n == 0 or k == 0:
            return ("host", np.zeros((k, n), dtype=bool))
        if k * n < self._min_batch:
            return ("host", self._host_commit_loop(pubkeys, commits))
        if m.executor != "device":
            # host-executor mesh: flat lanes keep the fault / re-mesh
            # choreography without a table step
            return ShardedBatchVerifier.launch_verify_commits(self, pubkeys, commits)
        m.maybe_reprobe()
        while True:
            if m.n_active == 0:
                raise MeshExhaustedError(f"all {m.n_total} mesh devices faulted")
            if n % m.n_active != 0:
                # uneven split: this call takes the one-card table path
                # (still behind the breaker above)
                return super().launch_verify_commits(pubkeys, commits, force_fused=force_fused)
            try:
                m.check_shard_faults()
                return self._launch_mesh_tables(pubkeys, commits, force_fused)
            except ShardDeviceFault as e:
                if not m.record_shard_fault(e.shard):
                    raise MeshExhaustedError(f"all {m.n_total} mesh devices faulted") from e

    def _launch_mesh_tables(self, pubkeys, commits, force_fused):
        n, k = len(pubkeys), len(commits)
        devices = self.mesh.active_devices()
        ndev = len(devices)
        pubkeys, length_ok = _table_keys(pubkeys)
        try:
            tables, key_ok = self._tables_for_mesh(tuple(pubkeys), devices)
        except TableBuildError:
            return ("host", self._host_commit_loop(pubkeys, commits))
        key_ok = key_ok & length_ok
        impl = {None: "auto", True: "fused", False: "entries"}[force_fused]
        t0 = time.perf_counter()
        s, h, r, precheck = prepare_commit_lanes(pubkeys, commits)
        lane_ok = precheck & np.tile(key_ok, k)
        powers = np.ones(k * n, dtype=np.int32)
        lanes = shard_lanes_validator_major([s, h, r, lane_ok, powers], n, ndev)
        ok, _total = self.mesh.tables_step()(tables, *lanes, impl=impl)
        _launchlog.annotate(_additive=True, rows_padded=0)
        _launchlog.add_transfer(_nbytes(lanes))
        _launchlog.annotate(mesh_width=ndev)
        return ("mesh_tables", ok, ndev, k, n, t0)

    def finalize_verify_commits(self, launched) -> np.ndarray:
        if launched[0] in ("host_grid", "mesh_grid"):
            return ShardedBatchVerifier.finalize_verify_commits(self, launched)
        if launched[0] != "mesh_tables":
            return super().finalize_verify_commits(launched)
        _tag, ok, ndev, k, n, t0 = launched
        lanes = unshard_lanes_validator_major(gather_verdicts(ok), n, ndev)
        _observe_verify("mesh", k * n, time.perf_counter() - t0, kind="tables")
        return lanes.reshape(k, n)


def _mesh_opt_in_cpu() -> bool:
    """The CPU joins the sharded mesh only when
    TENDERMINT_TPU_MESH_DEVICES explicitly asks for two shards or more
    (the kernels' plain versions are far slower than host crypto, so
    this exists for testing the mesh path, not for speed); on the card
    the mesh is the default whenever more than one card is visible."""
    knob = os.environ.get("TENDERMINT_TPU_MESH_DEVICES")
    if not knob or int(knob) < 2:
        return False
    return mesh_device_count("cpu") > 1


def _default_primary(dev: torch.device) -> BatchVerifier:
    """The device backend of `dev`'s default stack: the sharded table
    path over `default_mesh_manager()` on a card with more than one card
    in the mesh, else the one-card table path; on the CPU the sharded
    flat lanes when TENDERMINT_TPU_MESH_DEVICES opts in, else the table
    path."""
    if dev.type == "cuda" and mesh_device_count(dev) > 1:
        return ShardedTableBatchVerifier(mesh=default_mesh_manager(dev))
    if dev.type == "cpu" and _mesh_opt_in_cpu():
        return ShardedBatchVerifier(mesh=default_mesh_manager(dev))
    return TableBatchVerifier(device=dev)


_DEFAULTS: dict[torch.device, BatchVerifier] = {}
_DEFAULTS_LOCK = threading.Lock()


def default_verifier(device=None) -> BatchVerifier:
    """Process-wide verifier stack, one per device, as the JAX package's
    `default_verifier` composes it on an accelerator:
    `CoalescingVerifier(ResilientVerifier(TableBatchVerifier(device)))`,
    and with more than one card in the mesh (`mesh_device_count()`,
    TENDERMINT_TPU_MESH_DEVICES) `ShardedTableBatchVerifier` over
    `default_mesh_manager()` in place of `TableBatchVerifier`, so that a
    shard fault re-meshes onto the survivors before the breaker
    considers host crypto. With `device="cpu"` and
    TENDERMINT_TPU_MESH_DEVICES >= 2 the primary is a
    `ShardedBatchVerifier` over that many CPU shards.

    The table backend runs on the card (or on `device` when given), so
    its table cache is shared by every caller; the resilient layer
    degrades a device fault to host crypto behind a breaker
    (`services/resilient.py`); the outermost layer is the
    verified-signature cache plus the cross-consumer coalescer
    (`services/batcher.py`), dropped with TENDERMINT_TPU_COALESCE=0.
    Raises when no card is present and no device was given."""
    dev = resolve_device(device)
    with _DEFAULTS_LOCK:
        if dev not in _DEFAULTS:
            from tendermint_tpu_torch.services.resilient import ResilientVerifier

            stack: BatchVerifier = ResilientVerifier(_default_primary(dev))
            if os.environ.get("TENDERMINT_TPU_COALESCE", "1") != "0":
                from tendermint_tpu_torch.services.batcher import CoalescingVerifier

                stack = CoalescingVerifier(stack)
            _DEFAULTS[dev] = stack
        return _DEFAULTS[dev]


def set_default_verifier(v: BatchVerifier | None, device=None) -> None:
    """Install `v` as the process-wide verifier of `device` (the card
    when not given); None drops the entry, so the next
    `default_verifier` builds a fresh stack."""
    dev = resolve_device(device)
    with _DEFAULTS_LOCK:
        if v is None:
            _DEFAULTS.pop(dev, None)
        else:
            _DEFAULTS[dev] = v
