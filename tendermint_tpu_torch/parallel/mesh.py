"""Device mesh for the verify and hash planes (counterpart of
`tendermint_tpu/parallel/mesh.py`).

A mesh is an ordered list of indexed `torch.device`s, one a shard. A
batch is sharded along its row axis: shard i takes the i-th contiguous
block of rows and runs the port's existing kernels on it, on its own
device — the JAX package's `shard_map` programs, one launch a shard.
The >2/3 power tally is a verified-power sum: every shard sums
`where(ok, power, 0)` in int32 on its device, the shard sums are added
on the first active device, and a mesh that spans processes
(`parallel/distributed.py`) all-reduces that sum over its process
group. No shard waits for another: every shard's kernels are queued
before anything is copied back (`gather_verdicts`).

On the card `MeshManager()` takes `cuda:0 .. cuda:{n-1}`; on the CPU
(`device="cpu"`) its shards are `cpu` repeated, the counterpart of the
virtual CPU devices the JAX package's tests force. A device may appear
more than once (several shards on one card): shard i keeps its index
for fault injection and exclusion, whatever device it sits on.

`MeshManager` is the lifecycle around the steps: device discovery
(capped by TENDERMINT_TPU_MESH_DEVICES), a process-wide step cache, and
the survivor re-mesh cycle. A per-shard fault
(`utils.fail.ShardDeviceFault`, injected with
`TENDERMINT_TPU_DEVICE_FAIL=shard<i>`) drops that shard, and the launch
runs again over the survivors, so the verify spine keeps serving on
N-1 cards instead of falling back to host crypto; a re-probe window
later the full mesh is restored. Only when no shard survives does the
launch raise `MeshExhaustedError` to the `CircuitBreaker` of
`services/resilient.py` (host fallback).
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops.ed25519_kernel import NLIMBS
from tendermint_tpu_torch.ops.ed25519_ladder import verify_kernel_ladder
from tendermint_tpu_torch.ops.ed25519_tables import A_NWIN, verify_tables_kernel
from tendermint_tpu_torch.ops.merkle_kernel import ALGO_CODES, _leaf_kernel
from tendermint_tpu_torch.ops.sha256_kernel import to_words
from tendermint_tpu_torch.telemetry import launchlog as _launchlog
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.telemetry import tracectx as _tracectx
from tendermint_tpu_torch.telemetry.flightrec import FLIGHT
from tendermint_tpu_torch.utils.fail import shard_fail_point, shard_fault_armed
from tendermint_tpu_torch.utils.log import kv, logger

BATCH_AXIS = "batch"


def shard_lanes_validator_major(arrays, n_vals: int, n_shards: int):
    """Reorder commit-major lanes (lane = c*N + v, the
    `prepare_commit_lanes` layout) into shard-major order (shard, commit,
    local validator), so that splitting the lane axis into n_shards
    blocks hands every shard exactly the lanes of its own table columns.
    N must divide evenly into n_shards blocks."""
    if n_vals % n_shards:
        raise ValueError(f"n_vals {n_vals} not divisible by {n_shards} shards")
    out = []
    for a in arrays:
        k = a.shape[0] // n_vals
        a2 = a.reshape((k, n_shards, n_vals // n_shards) + a.shape[1:])
        out.append(np.ascontiguousarray(np.moveaxis(a2, 1, 0)).reshape(a.shape))
    return out


def unshard_lanes_validator_major(a, n_vals: int, n_shards: int):
    """Inverse of shard_lanes_validator_major (shard order -> commit-major)."""
    k = a.shape[0] // n_vals
    a2 = a.reshape((n_shards, k, n_vals // n_shards) + a.shape[1:])
    return np.ascontiguousarray(np.moveaxis(a2, 0, 1)).reshape(a.shape)


def mesh_device_count(device=None) -> int:
    """Shards the verify mesh should span.

    TENDERMINT_TPU_MESH_DEVICES: unset/0 = every visible device,
    1 = the single-device path, N = cap at N. The visible devices are
    the CUDA cards; on the CPU (`device` "cpu", or no card) the knob
    itself, since the CPU's shards are `cpu` repeated — the knob is what
    lets CPU tests opt in and a multi-card host opt out."""
    knob = int(os.environ.get("TENDERMINT_TPU_MESH_DEVICES", "0"))
    if device is not None:
        kind = torch.device(device).type
    else:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    visible = torch.cuda.device_count() if kind == "cuda" else max(1, knob)
    if knob <= 0:
        return visible
    return min(knob, visible)


class MeshExhaustedError(RuntimeError):
    """Every shard of the mesh has faulted out; the caller's breaker
    owns the next step (host fallback)."""


def pad_to_multiple(arrays, powers, multiple: int):
    """Pad (B, 32) byte arrays and (B,) powers up to a multiple of `multiple`.

    Padding rows are zeros. A zero row decodes (y = 0 is a valid point
    of order 4) but verifies False, since S = h = 0 makes the ladder
    produce the identity, which never encodes to the zero R; its power
    is zero too, so the tally is unaffected either way. Don't pad with
    copied rows: those WOULD verify True and count their power."""
    b = arrays[0].shape[0]
    size = ((b + multiple - 1) // multiple) * multiple
    if size == b:
        return arrays, powers, b
    pad = size - b
    arrays = [np.concatenate([a, np.zeros((pad, 32), dtype=np.uint8)]) for a in arrays]
    powers = np.concatenate([powers, np.zeros(pad, dtype=powers.dtype)])
    return arrays, powers, b


def _host_verify_prepared_rows(pub, r, s, h) -> np.ndarray:
    """Host evaluation of the device verify equation ([S]B + [h](-A) ==
    R, cofactorless) over prepared (B, 32) rows — the `executor="host"`
    stand-in that lets the mesh's choreography (pad geometry, shard
    faults, survivor re-mesh) run on the CPU without the kernels'
    plain versions. All-zero pad rows are False, as on the kernels
    (`pad_to_multiple`)."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    n = pub.shape[0]
    out = np.zeros(n, dtype=bool)
    for i in range(n):
        row_pub, row_r = bytes(pub[i]), bytes(r[i])
        if row_pub == b"\x00" * 32 and row_r == b"\x00" * 32:
            continue  # zero pad row: False by construction
        a_pt = ref._decode_point(row_pub)
        r_pt = ref._decode_point(row_r)
        if a_pt is None or r_pt is None:
            continue
        s_int = int.from_bytes(bytes(s[i]), "little")
        h_int = int.from_bytes(bytes(h[i]), "little")
        neg_a = (ref.P - a_pt[0], a_pt[1], a_pt[2], ref.P - a_pt[3])
        check = ref._pt_add(ref._mult_base(s_int), ref._mult_var(h_int, neg_a))
        out[i] = ref._encode_point(check) == row_r
    return out


def gather_verdicts(parts) -> np.ndarray:
    """The per-shard verdicts of a step, copied back and joined in shard
    order (the only copy back of a mesh launch)."""
    return np.concatenate([
        p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p) for p in parts
    ])


def place_shards(a, devices) -> list:
    """One block of rows a shard, on its device. `a` is a host array
    (split into len(devices) contiguous blocks) or a list already placed
    (`distributed.host_local_to_global`)."""
    if isinstance(a, (list, tuple)):
        if len(a) != len(devices):
            raise ValueError(f"expected {len(devices)} placed shards, got {len(a)}")
        return list(a)
    if a.shape[0] % len(devices):
        raise ValueError(f"{a.shape[0]} rows do not split over {len(devices)} shards")
    per = a.shape[0] // len(devices)
    out = []
    for i, dev in enumerate(devices):
        block = a[i * per : (i + 1) * per]
        if isinstance(block, torch.Tensor):
            out.append(block.contiguous().to(dev))
        else:
            out.append(torch.from_numpy(np.ascontiguousarray(block)).to(dev))
    return out


def _local_tally(ok, power):
    """int32 sum of the verified lanes' power on the shard's device."""
    return torch.where(ok, power, torch.zeros_like(power)).sum(dtype=torch.int32)


def _sum_on(sums, dev):
    total = sums[0].to(dev)
    for t in sums[1:]:
        total = total + t.to(dev)
    return total


def _verify_and_tally(devices):
    """The flat verify step over `devices` (`sharded_verify_and_tally`):
    (pub, r, s, h) (B, 32) uint8 and (B,) int32 powers, B a multiple of
    the shard count -> (per-shard (B/n,) bool verdicts, () int32 tally
    on the first device). Each shard runs `verify_kernel_ladder` (the
    `ladder` and `finish_encode_compare` kernels) on its rows."""

    def step(pub, r, s, h, power):
        pub, r, s, h, power = (place_shards(a, devices) for a in (pub, r, s, h, power))
        oks, sums = [], []
        for i in range(len(devices)):
            ok = verify_kernel_ladder(pub[i], r[i], s[i], h[i])
            oks.append(ok)
            sums.append(_local_tally(ok, power[i]))
        return oks, _sum_on(sums, devices[0])

    return step


def _tables_verify_and_tally(devices):
    """The table verify step over `devices`
    (`sharded_tables_verify_and_tally`), sharded along the validator
    axis: `tables` holds shard i's columns [i*N/n, (i+1)*N/n) of the
    (64, 16, 60, N) int16 tables on its device; s, h, r (K*N, 32) uint8,
    lane_ok (K*N,) bool and powers (K*N,) int32 are in shard-major
    order (`shard_lanes_validator_major`), so shard i verifies K*N/n
    lanes in commit-major order against its N/n columns. lane_ok (the
    host precheck AND the tables' key_ok) is ANDed in on the device
    before the tally: an invalid-key column verifies like a forgeable
    check. Each shard picks its chain from its own stack depth
    (`impl`, as `verify_tables_kernel` takes it)."""

    def step(tables, s, h, r, lane_ok, power, impl: str = "auto"):
        s, h, r, lane_ok, power = (place_shards(a, devices) for a in (s, h, r, lane_ok, power))
        oks, sums = [], []
        for i in range(len(devices)):
            ok = verify_tables_kernel(tables[i], s[i], h[i], r[i], impl=impl) & lane_ok[i]
            oks.append(ok)
            sums.append(_local_tally(ok, power[i]))
        return oks, _sum_on(sums, devices[0])

    return step


def _leaf_hash(devices, algo: str):
    """The Merkle leaf lane over `devices`: (blocks (B, M, 16) u32 words,
    n_blocks (B,)) -> per-shard (B/n, W) int32 digests, one
    `sha256_masked` / `ripemd160_masked` launch a shard. Tree reduction
    stays on one device: inner levels halve too fast to pay for the
    gather; the leaf pass is the O(N) term."""
    kernel = _leaf_kernel(algo)

    def step(blocks, n_blocks):
        if not isinstance(blocks, (list, tuple)):  # u32 host words -> int32 views
            blocks, n_blocks = to_words(blocks, "cpu"), to_words(n_blocks, "cpu")
        blocks, n_blocks = place_shards(blocks, devices), place_shards(n_blocks, devices)
        return [kernel(b, n) for b, n in zip(blocks, n_blocks)]

    return step


def _first_use(dev) -> None:
    """One small run, on dummy lanes, of every kernel a mesh step
    launches on `dev`: the flat route, both table chains (on zero
    tables), the two leaf hashes. Their outputs are discarded."""
    zero = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    verify_kernel_ladder(zero, zero, zero, zero)
    tables = torch.zeros((A_NWIN, 16, 3 * NLIMBS, 8), dtype=torch.int16, device=dev)
    verify_tables_kernel(tables, zero, zero, zero, impl="entries")
    stack = torch.zeros((64, 32), dtype=torch.uint8, device=dev)
    verify_tables_kernel(tables, stack, stack, stack, impl="fused")
    blocks = torch.zeros((8, 1, 16), dtype=torch.int32, device=dev)
    n_blocks = torch.zeros((8,), dtype=torch.int32, device=dev)
    for algo in ALGO_CODES:
        _leaf_kernel(algo)(blocks, n_blocks)


# Steps keyed by (executor, active device tuple, program), so every
# MeshManager of the process (the default stacks, tests, the smoke run)
# shares one step a device set. A miss is the first use of a device set:
# it warms every card of the set not yet warmed (`_WARMED`), the port's
# counterpart of the JAX package's compile; a survivor re-mesh over warm
# cards and a restore cost nothing.
_STEP_CACHE: dict = {}
_STEP_LOCK = threading.Lock()
_WARMED: set = set()
# step-cache misses being served right now under _STEP_LOCK (read without
# the lock: a single int read is atomic enough for a health probe)
_COMPILES_IN_PROGRESS = 0


def compiles_in_progress() -> int:
    """Step-cache misses being served right now (0 or 1: they serialize
    on the step-cache lock), so a health probe can tell a first-use
    stall from a dead device."""
    return _COMPILES_IN_PROGRESS


def warm_devices(devices) -> None:
    """Run the kernels' first-use work on every CUDA card of `devices`
    not yet warmed in this process, and wait for it. CPU devices have
    nothing to warm."""
    cold = [d for d in dict.fromkeys(devices) if d.type == "cuda" and d not in _WARMED]
    if not cold:
        return
    _build.kernel_lib()
    for dev in cold:
        _first_use(dev)
        torch.cuda.synchronize(dev)
        _WARMED.add(dev)


def _all_reduce_sum(total):
    """SUM of the tally over the default process group: on the current
    card under NCCL, on the CPU under gloo."""
    import torch.distributed as tdist

    t = total if isinstance(total, torch.Tensor) else torch.tensor(int(total), dtype=torch.int32)
    if tdist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        t = t.cpu()
    t = t.reshape(1).clone()
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return t[0]


class MeshManager:
    """Mesh lifecycle: discovery, steps, survivor re-mesh.

    One manager is shared by the verifier and hasher mesh lanes of a
    process (they degrade together: a sick card is sick for every
    kernel). Thread-safe: launches from the dispatch worker, re-probes
    and snapshots may interleave.

    `executor="host"` swaps the kernel steps for host evaluations with
    the same verdicts and the SAME fault / re-mesh choreography — the
    seam where CPU tests (and the nemesis book) drive the mesh without
    running the kernels' plain versions.

    `spans_processes=True` (`distributed.global_batch_mesh`) all-reduces
    every tally over the default process group after the local sum, so
    every process reads the global tally; every process must then run
    the same sequence of tallied steps.
    """

    def __init__(
        self,
        devices=None,
        executor: str = "device",
        reprobe_s: float | None = None,
        device=None,
        spans_processes: bool = False,
    ) -> None:
        if executor not in ("device", "host"):
            raise ValueError(f"unknown mesh executor {executor!r}")
        self.executor = executor
        if devices is None:
            dev = resolve_device(device)
            n = mesh_device_count(dev)
            devices = [torch.device("cuda", i) for i in range(n)] if dev.type == "cuda" else [dev] * n
        self._all = [resolve_device(d) for d in devices]
        if not self._all:
            raise ValueError("mesh needs at least one device")
        self.spans_processes = spans_processes
        self._excluded: set[int] = set()
        self._last_fault = 0.0
        self._reprobe_s = (
            float(os.environ.get("TENDERMINT_TPU_MESH_REPROBE_S", "5.0"))
            if reprobe_s is None
            else reprobe_s
        )
        self._lock = threading.RLock()
        self._bind_gauge()

    def _bind_gauge(self) -> None:
        _metrics.MESH_DEVICES.set(self.n_active)

    # -- topology ----------------------------------------------------------

    @property
    def devices(self) -> tuple:
        """Every shard's device, by shard index."""
        return tuple(self._all)

    @property
    def n_total(self) -> int:
        return len(self._all)

    @property
    def n_active(self) -> int:
        return len(self._all) - len(self._excluded)

    @property
    def degraded(self) -> bool:
        return bool(self._excluded)

    def active_indices(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(i for i in range(len(self._all)) if i not in self._excluded)

    def active_devices(self) -> tuple:
        with self._lock:
            return tuple(self._all[i] for i in self.active_indices())

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "executor": self.executor,
                "devices_total": self.n_total,
                "devices_active": self.n_active,
                "excluded": sorted(self._excluded),
            }

    # -- fault / re-mesh cycle ---------------------------------------------

    def check_shard_faults(self) -> None:
        """Injected per-shard fault gate, called at the top of every mesh
        launch with the ACTIVE shard indices, so an armed `shard<i>`
        spec fires only while shard i is in the mesh."""
        shard_fail_point(self.active_indices())

    def record_shard_fault(self, shard: int) -> bool:
        """Drop `shard` from the mesh; True while survivors remain.
        False means the mesh is exhausted: the caller raises to its
        breaker and host crypto takes over."""
        with self._lock:
            _metrics.MESH_SHARD_FAULTS.inc()
            self._last_fault = time.monotonic()
            if shard in self._excluded:
                return self.n_active > 0
            self._excluded.add(shard)
            survivors = self.n_active
            if survivors > 0:
                _metrics.MESH_REMESH.labels(direction="shrink").inc()
            self._bind_gauge()
        # a mesh transition is a forensic moment: black-box it and sample
        # every trace for a window (the breakers' policy)
        FLIGHT.record("mesh", event="shard_fault", shard=shard, survivors=survivors)
        _tracectx.boost()
        kv(
            logger("mesh"),
            logging.WARNING,
            "mesh shard fault",
            shard=shard,
            survivors=survivors,
            total=self.n_total,
        )
        return survivors > 0

    def maybe_reprobe(self) -> None:
        """Restore the full mesh once the re-probe window has passed
        since the last shard fault. Shards whose injected fault is still
        armed stay excluded (the peek costs no budget); a recovered card
        simply serves again, and if it is still sick the next launch's
        fault excludes it again, which is the probe."""
        with self._lock:
            if not self._excluded:
                return
            if time.monotonic() - self._last_fault < self._reprobe_s:
                return
            recovered = {i for i in self._excluded if not shard_fault_armed(i)}
            if not recovered:
                self._last_fault = time.monotonic()  # re-arm the window
                return
            self._excluded -= recovered
            _metrics.MESH_REMESH.labels(direction="restore").inc()
            self._bind_gauge()
        FLIGHT.record("mesh", event="restore", recovered=sorted(recovered), active=self.n_active)

    def reset(self) -> None:
        """Forget all exclusions (tests)."""
        with self._lock:
            self._excluded.clear()
            self._bind_gauge()

    # -- steps -------------------------------------------------------------

    def _cached_step(self, program: str, build):
        global _COMPILES_IN_PROGRESS

        devices = self.active_devices()
        key = (self.executor, devices, program)
        warm_s = None
        with _STEP_LOCK:
            step = _STEP_CACHE.get(key)
            if step is None:
                _COMPILES_IN_PROGRESS += 1
                t0 = time.perf_counter()
                try:
                    warm_devices(devices)
                    step = build(devices)
                finally:
                    _COMPILES_IN_PROGRESS -= 1
                warm_s = time.perf_counter() - t0
                _STEP_CACHE[key] = step
        # outside the lock: a miss stalls its launch for the whole
        # warm-up, and the launch's ledger record carries the cost
        if warm_s is None:
            _metrics.MESH_COMPILE.labels(result="hit").inc()
            _launchlog.annotate(compile="hit")
        else:
            _metrics.MESH_COMPILE.labels(result="miss").inc()
            _metrics.MESH_COMPILE_SECONDS.observe(warm_s)
            _launchlog.annotate(compile="miss")
            _launchlog.annotate(_additive=True, compile_s=warm_s)
        return self._tallied(step)

    def _tallied(self, step):
        if not self.spans_processes:
            return step

        def run(*args, **kwargs):
            ok, total = step(*args, **kwargs)
            return ok, _all_reduce_sum(total)

        return run

    def verify_step(self):
        """(pub, r, s, h, powers) -> (per-shard verdicts, power tally)
        over the ACTIVE mesh. Row counts must already be padded to a
        multiple of `n_active` (`ops.padding.pad_rows_to`)."""
        if self.executor == "host":

            def _host_step(pub, r, s, h, power):
                pub, r, s, h, power = (
                    gather_verdicts(a) if isinstance(a, (list, tuple)) else a
                    for a in (pub, r, s, h, power)
                )
                ok = _host_verify_prepared_rows(pub, r, s, h)
                return [ok], int(np.where(ok, power, 0).sum())

            return self._tallied(_host_step)
        return self._cached_step("verify_tally", _verify_and_tally)

    def tables_step(self):
        """The table path over the active mesh (validator-axis shards;
        `_tables_verify_and_tally`)."""
        if self.executor == "host":
            raise NotImplementedError("host executor has no table path — use the generic verify_step")
        return self._cached_step("tables_tally", _tables_verify_and_tally)

    def leaf_hash_step(self, algo: str):
        """The Merkle leaf lane over the active mesh: (blocks, n_blocks),
        B a multiple of `n_active` -> per-shard digests (`_leaf_hash`).
        None for the host executor (the hasher hashes on the host)."""
        if self.executor == "host":
            return None
        if algo not in ALGO_CODES:
            raise ValueError(f"unknown algo {algo!r}")
        return self._cached_step(f"leafhash_{algo}", lambda devices: _leaf_hash(devices, algo))


_DEFAULT_MANAGERS: dict[str, MeshManager] = {}
_DEFAULT_MANAGER_LOCK = threading.Lock()


def default_mesh_manager(device=None) -> MeshManager:
    """The process-wide mesh of a device type (the cards, or the CPU's
    shards with device="cpu"), shared by the default verifier and hasher
    stacks: one health view a process — a card that faults out of the
    verify lane is out of the hash lane too."""
    kind = resolve_device(device).type
    with _DEFAULT_MANAGER_LOCK:
        if kind not in _DEFAULT_MANAGERS:
            _DEFAULT_MANAGERS[kind] = MeshManager(device=kind)
        return _DEFAULT_MANAGERS[kind]


def set_default_mesh_manager(manager: MeshManager | None, device=None) -> None:
    """Install `manager` as the process-wide mesh of `device`'s type (the
    card's when not given); None drops it."""
    if device is not None:
        kind = torch.device(device).type
    else:
        kind = manager.devices[0].type if manager is not None else "cuda"
    with _DEFAULT_MANAGER_LOCK:
        if manager is None:
            _DEFAULT_MANAGERS.pop(kind, None)
        else:
            _DEFAULT_MANAGERS[kind] = manager
