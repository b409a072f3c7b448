"""Merkle trees on the card: batched leaf hashes, then log-depth levels.

Counterpart of `tendermint_tpu/ops/merkle_kernel.py`. Computes the root of
`merkle.simple` (RFC 6962 split) by level-by-level pairing: adjacent
nodes pair into an inner hash H(0x01 || L || R) and an unpaired trailing
node is promoted unchanged. Both tree variants run: `sha256` (8 big-endian
digest words) and `ripemd160` (5 little-endian words).

A tree build is one leaf-hash launch over the flattened padded leaves
(`sha256_masked` / `ripemd160_masked`) and one `merkle_level` launch a
level (`csrc/hash.cu`); nothing returns to the host between levels. The
leaf digests of a forest are placed into (T, P, W) on the card, so the
JAX package's pad rows (P - count per tree) are never hashed: the level
rule reads no node outside a tree's valid prefix, and the roots are the
same. On the CPU `merkle_level` runs `_merkle_level`, one step of the JAX
`_forest_levels`, with the inner-node words built as in JAX.

Over a mesh (`leaf_hashes_sharded`, `merkle_root_sharded`) the leaf pass
is one launch a shard; the levels stay on the first active device.
"""

from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.merkle.simple import INNER_PREFIX, LEAF_PREFIX
from tendermint_tpu_torch.merkle.simple import leaf_hash as host_leaf_hash
from tendermint_tpu_torch.merkle.simple import simple_hash_from_byte_slices as host_root
from tendermint_tpu_torch.ops._build import check, kernel_lib, stream_ptr
from tendermint_tpu_torch.ops.padding import (
    bucket_blocks,
    digests_to_bytes_be,
    digests_to_bytes_le,
    pad_ripemd160_prefixed,
    pad_sha256_prefixed,
)
from tendermint_tpu_torch.ops.ripemd160_kernel import _H0, _compress160, ripemd160_masked
from tendermint_tpu_torch.ops.sha256_kernel import (
    M32,
    SHA256_H0,
    _compress,
    _initial_state,
    bits32,
    sha256_masked,
    to_u32,
    to_words,
    words64,
)
from tendermint_tpu_torch.telemetry import launchlog as _launchlog

ALGO_CODES = {"sha256": 0, "ripemd160": 1}
WIDTHS = {"sha256": 8, "ripemd160": 5}
# INNER_PREFIX in the top byte of the first SHA-256 message word
_INNER_PREFIX_WORD = INNER_PREFIX[0] << 24


def _inner_node_words(L, R):
    """The two 16-word SHA-256 blocks of H(INNER_PREFIX || L || R).

    L, R: 8 big-endian digest words of (B,), int64 in [0, 2^32). The
    one-byte prefix shifts every digest byte by one, so each message word
    mixes two source words."""
    w0 = [_INNER_PREFIX_WORD | (L[0] >> 8)]
    w0 += [((L[i - 1] << 24) & M32) | (L[i] >> 8) for i in range(1, 8)]
    w0.append(((L[7] << 24) & M32) | (R[0] >> 8))
    w0 += [((R[i - 1] << 24) & M32) | (R[i] >> 8) for i in range(1, 8)]
    zero = torch.zeros_like(L[0])
    w1 = [((R[7] << 24) & M32) | 0x00800000] + [zero] * 14
    w1.append(torch.full_like(L[0], 65 * 8))
    return torch.stack(w0, dim=1), torch.stack(w1, dim=1)


def _inner_node_words_ripemd(L, R):
    """The one 16-word little-endian RIPEMD-160 block of H(0x01 || L20 ||
    R20) = 41 bytes: 0x80 at byte 41, bit length 328 at words 14-15."""
    w = [INNER_PREFIX[0] | ((L[0] << 8) & M32)]
    w += [(L[i - 1] >> 24) | ((L[i] << 8) & M32) for i in range(1, 5)]
    w.append((L[4] >> 24) | ((R[0] << 8) & M32))
    w += [(R[i - 1] >> 24) | ((R[i] << 8) & M32) for i in range(1, 5)]
    w.append((R[4] >> 24) | (0x80 << 8))
    zero = torch.zeros_like(L[0])
    w += [zero, zero, zero, torch.full_like(L[0], 41 * 8), zero]
    return torch.stack(w, dim=1)


def _inner_hash(left, right, algo: str):
    """(B, W), (B, W) int64 words -> (B, W) inner-node digests."""
    L = [left[:, i] for i in range(left.shape[1])]
    R = [right[:, i] for i in range(right.shape[1])]
    if algo == "sha256":
        b0, b1 = _inner_node_words(L, R)
        state = _initial_state(SHA256_H0, left.shape[0], left.device)
        return _compress(_compress(state, b0), b1)
    state = _initial_state(_H0, left.shape[0], left.device)
    return _compress160(state, _inner_node_words_ripemd(L, R))


def _level_valid(counts, level: int):
    """Valid nodes of every tree at `level`: ceil(c / 2^level), the JAX
    loop's `(c + 1) // 2` taken `level` times."""
    return (counts.to(torch.int64) + (1 << level) - 1) >> level


def _merkle_level(nodes, counts, level: int, algo: str = "sha256"):
    """Plain version of the kernel: nodes (T, P, W) int32 (level `level`
    of T trees), counts (T,) int32 leaf counts -> (T, P / 2, W) int32. A
    pair is hashed only if its right child is inside the valid prefix;
    otherwise the left child is promoted."""
    t, p, w = nodes.shape
    half = p // 2
    x = words64(nodes)
    left = x[:, 0::2].reshape(t * half, w)
    right = x[:, 1::2].reshape(t * half, w)
    paired = _inner_hash(left, right, algo).reshape(t, half, w)
    idx = torch.arange(half, device=nodes.device)
    keep = (2 * idx[None, :] + 1 < _level_valid(counts, level)[:, None])[..., None]
    return bits32(torch.where(keep, paired, left.reshape(t, half, w)))


def merkle_level(nodes, counts, level: int, algo: str = "sha256"):
    """One level of a forest: nodes (T, P, W) int32 with P even, counts
    (T,) int32 leaf counts, `level` the level the nodes hold -> (T, P / 2,
    W) int32. CUDA tensors launch the `merkle_level` kernel; CPU tensors
    run `_merkle_level`."""
    if algo not in ALGO_CODES:
        raise ValueError(f"unknown algo {algo!r}")
    width = WIDTHS[algo]
    if nodes.dtype != torch.int32 or counts.dtype != torch.int32:
        raise ValueError(f"merkle_level: expected int32 nodes and counts, got {nodes.dtype}, {counts.dtype}")
    if nodes.dim() != 3 or nodes.shape[2] != width or nodes.shape[1] < 2 or nodes.shape[1] % 2:
        raise ValueError(f"merkle_level: expected nodes (T, P even >= 2, {width}), got {tuple(nodes.shape)}")
    if tuple(counts.shape) != (nodes.shape[0],):
        raise ValueError(f"merkle_level: expected counts ({nodes.shape[0]},), got {tuple(counts.shape)}")
    if nodes.device != counts.device:
        raise ValueError(f"merkle_level: nodes on {nodes.device}, counts on {counts.device}")
    if not 0 <= level < 62:
        raise ValueError(f"merkle_level: level {level} out of range")
    if nodes.device.type == "cpu":
        return _merkle_level(nodes, counts, level, algo)
    if not (nodes.is_contiguous() and counts.is_contiguous()):
        raise ValueError("merkle_level: expected contiguous tensors")
    t, p, _ = nodes.shape
    dev = nodes.device
    out = torch.empty((t, p // 2, width), dtype=torch.int32, device=dev)
    if t == 0:
        return out
    with torch.cuda.device(dev):
        rc = kernel_lib().merkle_level(
            nodes.data_ptr(), counts.data_ptr(), out.data_ptr(), t, p, level, ALGO_CODES[algo],
            stream_ptr(dev),
        )
    check(rc, "merkle_level")
    merkle_level.launches += 1
    return out


merkle_level.launches = 0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def reduce_forest(nodes, counts, algo: str = "sha256"):
    """Roots of a forest: nodes (T, P, W) int32 leaf digests with P a power
    of two, counts (T,) int32 valid leaf prefixes -> (T, W) int32 root
    words, one `merkle_level` a level."""
    for level in range(nodes.shape[1].bit_length() - 1):
        nodes = merkle_level(nodes, counts, level, algo)
    return nodes[:, 0]


def merkle_root_from_leaf_words(leaf_digests, count=None, algo: str = "sha256", device=None):
    """Root from leaf hashes: leaf_digests (N, W) u32 words (already
    leaf-prefixed hashes; W = 8 for sha256 BE words, 5 for ripemd160 LE
    words), padded to the next power of two; `count` defaults to N.
    Returns the (W,) int32 root words on the device."""
    if algo not in ALGO_CODES:
        raise ValueError(f"unknown algo {algo!r}")
    width = WIDTHS[algo]
    dev = resolve_device(device)
    leaves = to_words(leaf_digests, dev)
    n = leaves.shape[0]
    if n == 0:
        raise ValueError("empty leaf batch has no root (host simple_hash_from_hashes([]) is b'')")
    if leaves.dim() != 2 or leaves.shape[1] != width:
        raise ValueError(f"{algo} leaf digests must be (N, {width}) words, got {tuple(leaves.shape)}")
    p = _next_pow2(n)
    if p != n:
        leaves = torch.cat([leaves, leaves.new_zeros((p - n, width))])
    counts = torch.tensor([n if count is None else count], dtype=torch.int32, device=dev)
    return reduce_forest(leaves.contiguous()[None], counts, algo)[0]


def _pad_leaves(items: list[bytes], algo: str):
    if algo == "ripemd160":
        return pad_ripemd160_prefixed(items, LEAF_PREFIX)
    return pad_sha256_prefixed(items, LEAF_PREFIX)


def _leaf_kernel(algo: str):
    return ripemd160_masked if algo == "ripemd160" else sha256_masked


def _to_bytes(algo: str):
    return digests_to_bytes_le if algo == "ripemd160" else digests_to_bytes_be


def forest_leaves(trees: list[list[bytes]], algo: str = "sha256", device=None):
    """The leaf level of a forest on the device, every leaf of every tree
    hashed in one launch: nodes (T_pad, P, W) int32 with leaf j of tree i
    at [i, j], P the next power of two of the largest tree and T_pad =
    `bucket_blocks(T)`, and counts (T_pad,) int32 (pad trees count one
    leaf, as in the JAX package)."""
    counts = np.array([len(items) for items in trees], dtype=np.int32)
    if (counts == 0).any():
        raise ValueError("empty tree in forest (host root of [] is b'')")
    dev = resolve_device(device)
    t = len(trees)
    p = _next_pow2(int(counts.max()))
    width = WIDTHS[algo]
    blocks, n_blocks = _pad_leaves([x for items in trees for x in items], algo)
    digs = _leaf_kernel(algo)(to_words(blocks, dev), to_words(n_blocks, dev))
    t_pad = bucket_blocks(t)
    if t_pad == 1 and counts[0] == p:
        nodes = digs
    else:
        # leaf j of tree i goes to row i * P + j
        starts = np.repeat(np.cumsum(counts) - counts, counts)
        slots = np.repeat(np.arange(t, dtype=np.int64) * p, counts) + np.arange(len(starts)) - starts
        nodes = digs.new_zeros((t_pad * p, width))
        nodes[torch.from_numpy(slots).to(dev)] = digs
    all_counts = np.ones(t_pad, dtype=np.int32)
    all_counts[:t] = counts
    return nodes.view(t_pad, p, width), torch.from_numpy(all_counts).to(dev)


def merkle_roots_forest(trees: list[list[bytes]], algo: str = "sha256", device=None) -> list[bytes]:
    """One root per item list, built together on the device: every leaf of
    every tree hashed in one launch (`forest_leaves`), then one launch a
    level over the forest. Bit-equal to
    `merkle.simple.simple_hash_from_byte_slices` per tree. The pad trees'
    roots are sliced off, as in the JAX package."""
    if algo not in ALGO_CODES:
        raise ValueError(f"unknown algo {algo!r}")
    if not trees:
        return []
    nodes, counts = forest_leaves(trees, algo, device)
    roots = reduce_forest(nodes, counts, algo)
    return _to_bytes(algo)(to_u32(roots[: len(trees)]))


def merkle_root_device(items: list[bytes], algo: str = "sha256", device=None) -> bytes:
    """Full device tree build over raw byte items; bit-equal to
    `merkle.simple.simple_hash_from_byte_slices`."""
    if not items:
        return b""
    return merkle_roots_forest([items], algo, device)[0]


def leaf_hashes_device(items: list[bytes], algo: str = "sha256", device=None) -> list[bytes]:
    """Domain-separated leaf hashes of every item in one launch (bit-equal
    to `merkle.simple.leaf_hash` per item): the state-sync chunk gate."""
    if algo not in ALGO_CODES:
        raise ValueError(f"unknown algo {algo!r}")
    if not items:
        return []
    dev = resolve_device(device)
    blocks, n_blocks = _pad_leaves(items, algo)
    digs = _leaf_kernel(algo)(to_words(blocks, dev), to_words(n_blocks, dev))
    return _to_bytes(algo)(to_u32(digs))


def _sharded_leaves(items: list[bytes], algo: str, manager):
    """The leaf pass over a mesh: the padded leaf messages, zero rows
    added up to a multiple of the active shard count, one leaf launch a
    shard (`MeshManager.leaf_hash_step`), with the survivor re-mesh
    loop. Returns (per-shard digest tensors, true row count), or None
    for the host executor."""
    from tendermint_tpu_torch.ops.padding import pad_rows_to_multiple
    from tendermint_tpu_torch.parallel.mesh import MeshExhaustedError
    from tendermint_tpu_torch.utils.fail import ShardDeviceFault

    if algo not in ALGO_CODES:
        raise ValueError(f"unknown algo {algo!r}")
    blocks, n_blocks = _pad_leaves(items, algo)
    manager.maybe_reprobe()
    while True:
        if manager.n_active == 0:
            raise MeshExhaustedError(f"all {manager.n_total} mesh devices faulted")
        try:
            manager.check_shard_faults()
            if manager.executor == "host":
                return None
            (b_pad, n_pad), n = pad_rows_to_multiple([blocks, n_blocks], manager.n_active)
            parts = manager.leaf_hash_step(algo)(b_pad, n_pad)
            # the lane's pad rows and shipped block bytes, on the
            # successful attempt only (a shard-fault retry must not
            # count twice)
            _launchlog.annotate(_additive=True, rows_padded=b_pad.shape[0] - n)
            _launchlog.annotate(mesh_width=manager.n_active)
            _launchlog.add_transfer(b_pad.nbytes + n_pad.nbytes)
            return parts, n
        except ShardDeviceFault as e:
            if not manager.record_shard_fault(e.shard):
                raise MeshExhaustedError(f"all {manager.n_total} mesh devices faulted") from e


def leaf_hashes_sharded(items: list[bytes], algo: str, manager) -> list[bytes]:
    """`leaf_hashes_device` over a mesh (`parallel.mesh.MeshManager`,
    which owns the shard faults and the survivor re-mesh): each shard
    hashes its block of the padded leaves in one launch. Bit-equal to the
    one-device lane; the pad rows carry n_blocks = 0 and are sliced off.
    The host executor hashes on the host, with the same fault cycle."""
    if not items:
        return []
    out = _sharded_leaves(items, algo, manager)
    if out is None:
        return [host_leaf_hash(x, algo) for x in items]
    parts, n = out
    return _to_bytes(algo)(np.concatenate([to_u32(p) for p in parts])[:n])


def merkle_root_sharded(items: list[bytes], algo: str, manager) -> bytes:
    """`merkle_root_device` with its leaf pass over a mesh: the shards'
    leaf digests are gathered on the first active device and reduced
    there, one `merkle_level` launch a level. Bit-equal to
    `merkle.simple.simple_hash_from_byte_slices`."""
    if not items:
        return b""
    out = _sharded_leaves(items, algo, manager)
    if out is None:
        return host_root(items, algo)
    parts, n = out
    dev = parts[0].device
    leaves = torch.cat([p.to(dev) for p in parts])[:n]
    p = _next_pow2(n)
    if p != n:
        leaves = torch.cat([leaves, leaves.new_zeros((p - n, leaves.shape[1]))])
    counts = torch.tensor([n], dtype=torch.int32, device=dev)
    root = reduce_forest(leaves.contiguous()[None], counts, algo)
    return _to_bytes(algo)(to_u32(root))[0]
