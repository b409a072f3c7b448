"""TreeHasher: batched Merkle tree construction service.

Counterpart of `tendermint_tpu/services/hasher.py`: the `TreeHasher` seam
that `Txs.hash`, `Block.fill_header` / `validate_basic`, `evidence_hash`
and the state-sync chunk gate call. The device backend hashes all leaves
in one kernel launch and reduces the tree in log2(N) launches on the
card (`ops/merkle_kernel.py`); the host backend is the bit-identical
sequential reference (`merkle/simple.py`). Both tree variants run:
`sha256` (the framework's) and `ripemd160` (the reference-compatible
tree). Proofs stay on the host. With a `parallel.mesh.MeshManager` of
more than one shard (`mesh=`) the leaf pass, the O(N) term, shards over
the mesh: `leaf_hashes` and the leaves of `root_from_items`; the tree
reduction stays on one card.

`default_hasher()` / `auto_hasher()` wrap the device hasher in
`ResilientTreeHasher` (`services/resilient.py`), so a device fault
degrades block hashing to host hashlib behind a breaker; each backend
reports its calls to the metric catalog and the launch ledger.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.merkle import simple as host_merkle
from tendermint_tpu_torch.telemetry import launchlog as _launchlog
from tendermint_tpu_torch.telemetry import metrics as _metrics


def _observe_hash(backend: str, leaves: int, seconds: float, kind: str = "hash") -> None:
    _metrics.HASH_BATCH_LEAVES.labels(backend=backend).observe(leaves)
    _metrics.HASH_SECONDS.labels(backend=backend).observe(seconds)
    # closes or annotates the ambient launch record (host roots outside
    # a dispatch handle record nothing)
    _launchlog.observe(kind, backend, leaves, seconds)

# Below this leaf count the host's hashlib tree answers. On the H100 the
# card's tree of 250-byte leaves beat the host's from 1,024 leaves and
# lost at 256 (PERF.md, "Host-vs-card crossover"); 8,192 keeps the JAX
# package's routing, so both packages send the same blocks to the device.
DEVICE_MIN_LEAVES = int(os.environ.get("TENDERMINT_TPU_MIN_DEVICE_LEAVES", "8192"))


class TreeHasher:
    """Merkle root/proof builder with host and device backends. The device
    backend runs on the card (on the mesh's first device with `mesh=`)
    unless `device` says otherwise, and raises without a card and without
    a device."""

    def __init__(
        self,
        backend: str = "device",
        algo: str = "sha256",
        min_device_leaves: int | None = None,
        device=None,
        mesh=None,
    ) -> None:
        if backend not in ("device", "host"):
            raise ValueError(f"unknown backend {backend!r}")
        if algo not in ("sha256", "ripemd160"):
            raise ValueError(f"unknown algo {algo!r}")
        self.algo = algo
        self.backend = backend
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device) if backend == "device" else None
        self.min_device_leaves = (
            DEVICE_MIN_LEAVES if min_device_leaves is None else min_device_leaves
        )
        # Optional `parallel.mesh.MeshManager`: the leaf pass shards over
        # it when it has more than one shard; None = one device.
        self.mesh = mesh

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.n_total > 1

    def _use_device(self, n: int) -> bool:
        return self.backend == "device" and n >= max(2, self.min_device_leaves)

    def root_from_items(self, items: list[bytes]) -> bytes:
        """SimpleMerkle root over raw byte leaves (leaf-prefixed hashes)."""
        t0 = time.perf_counter()
        if self._use_device(len(items)) and self._sharded():
            from tendermint_tpu_torch.ops.merkle_kernel import merkle_root_sharded

            out = merkle_root_sharded(items, self.algo, self.mesh)
            _observe_hash("mesh", len(items), time.perf_counter() - t0)
            return out
        if self._use_device(len(items)):
            from tendermint_tpu_torch.ops.merkle_kernel import merkle_root_device

            out = merkle_root_device(items, self.algo, self.device)
            _observe_hash("device", len(items), time.perf_counter() - t0)
            return out
        out = host_merkle.simple_hash_from_byte_slices(items, self.algo)
        _observe_hash("host", len(items), time.perf_counter() - t0)
        return out

    def root_from_hashes(self, hashes: list[bytes]) -> bytes:
        """Root over already-hashed leaves (PartSet/Commit aggregation)."""
        t0 = time.perf_counter()
        if self._use_device(len(hashes)):
            from tendermint_tpu_torch.ops.merkle_kernel import merkle_root_from_leaf_words
            from tendermint_tpu_torch.ops.padding import digests_to_bytes_be, digests_to_bytes_le
            from tendermint_tpu_torch.ops.sha256_kernel import to_u32

            # sha256 digests are big-endian words; ripemd160 little-endian
            dt, to_bytes = (
                (">u4", digests_to_bytes_be) if self.algo == "sha256" else ("<u4", digests_to_bytes_le)
            )
            words = np.frombuffer(b"".join(hashes), dtype=dt).astype(np.uint32).reshape(len(hashes), -1)
            root = merkle_root_from_leaf_words(words, algo=self.algo, device=self.device)
            out = to_bytes(to_u32(root)[None, :])[0]
            _observe_hash("device", len(hashes), time.perf_counter() - t0)
            return out
        out = host_merkle.simple_hash_from_hashes(hashes, self.algo)
        _observe_hash("host", len(hashes), time.perf_counter() - t0)
        return out

    def leaf_hashes(self, items: list[bytes]) -> list[bytes]:
        """Per-item domain-separated leaf hashes (state-sync chunk
        verification): one kernel launch above the threshold (one a shard
        with a mesh), host hashlib below it."""
        t0 = time.perf_counter()
        if self._use_device(len(items)) and self._sharded():
            from tendermint_tpu_torch.ops.merkle_kernel import leaf_hashes_sharded

            out = leaf_hashes_sharded(items, self.algo, self.mesh)
            _observe_hash("mesh", len(items), time.perf_counter() - t0, kind="leaf_hashes")
            return out
        if self._use_device(len(items)):
            from tendermint_tpu_torch.ops.merkle_kernel import leaf_hashes_device

            out = leaf_hashes_device(items, self.algo, self.device)
            _observe_hash("device", len(items), time.perf_counter() - t0, kind="leaf_hashes")
            return out
        out = [host_merkle.leaf_hash(x, self.algo) for x in items]
        _observe_hash("host", len(items), time.perf_counter() - t0, kind="leaf_hashes")
        return out

    def leaf_hashes_async(self, items: list[bytes], queue=None):
        """`leaf_hashes` through a `DispatchQueue` handle: the state-sync
        chunk gate submits the whole set's hash and decodes payloads
        while it runs. The resilient wrapper overrides this with the
        breaker-guarded version."""
        from tendermint_tpu_torch.services.dispatch import default_dispatch_queue

        q = queue if queue is not None else default_dispatch_queue()
        return q.submit(lambda: self.leaf_hashes(items), kind="hash")

    def proofs(self, items: list[bytes]):
        """Merkle proofs stay on the host: O(N log N) pointer work, tiny data."""
        return host_merkle.simple_proofs_from_byte_slices(items, self.algo)


_DEFAULTS: dict[torch.device, TreeHasher] = {}
_DEFAULTS_LOCK = threading.Lock()


def default_hasher(device=None) -> TreeHasher:
    """Process-wide device hasher, one per device, on the card (or on
    `device` when given), as `auto_hasher` composes it. Raises when no
    card is present and no device was given."""
    dev = resolve_device(device)
    with _DEFAULTS_LOCK:
        if dev not in _DEFAULTS:
            _DEFAULTS[dev] = auto_hasher(dev)
        return _DEFAULTS[dev]


def auto_hasher(device=None) -> TreeHasher:
    """A new device-backed hasher on the card (or on `device`), wrapped
    in `ResilientTreeHasher`, for a node's composition root, as the JAX
    package's `auto_hasher` composes it: on the card the leaf pass
    shards over `default_mesh_manager()` when the mesh spans more than
    one card; on the CPU it does so when TENDERMINT_TPU_MESH_DEVICES
    asks for two shards or more. Raises without a card and without a
    device rather than pick the host backend. The wrapper answers with
    host hashlib only on an injected device fault, a mesh exhausted by
    shard faults or a dispatch timeout: a real kernel error raises
    (`services/resilient.py`)."""
    from tendermint_tpu_torch.parallel.mesh import default_mesh_manager, mesh_device_count
    from tendermint_tpu_torch.services.resilient import ResilientTreeHasher
    from tendermint_tpu_torch.services.verifier import _mesh_opt_in_cpu

    dev = resolve_device(device)
    if dev.type == "cuda":
        sharded = mesh_device_count(dev) > 1
    else:
        sharded = _mesh_opt_in_cpu()
    mesh = default_mesh_manager(dev) if sharded else None
    return ResilientTreeHasher(TreeHasher(backend="device", device=dev, mesh=mesh))
