"""Batched SHA-256: the `sha256_masked` kernel and its plain torch version.

Counterpart of `tendermint_tpu/ops/sha256_kernel.py`. Messages are padded
on the host (`ops/padding.py`) to (B, M, 16) big-endian u32 words with a
per-row block count; a row's state freezes after its last real block.

On the card `sha256_masked` launches the CUDA kernel (`csrc/hash.cu`, one
message a thread, looping to the row's own block count). On the CPU it
runs `_sha256_masked`, the JAX package's arithmetic step for step: every
block compressed, the state kept by a mask. torch has no uint32
arithmetic on the CPU, so the plain versions carry each 32-bit word in
int64 and mask with 0xFFFFFFFF after every addition and left shift.
Words cross the wrappers as int32 bit patterns on either device.

Constants come from integer square and cube roots of the first primes,
as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.ops._build import check, kernel_lib, stream_ptr

M32 = 0xFFFFFFFF


def _first_primes(n: int) -> list[int]:
    primes, c = [], 2
    while len(primes) < n:
        if all(c % p for p in primes):
            primes.append(c)
        c += 1
    return primes


def _icbrt(n: int) -> int:
    """Exact integer cube root (floor)."""
    x = int(round(n ** (1 / 3)))
    while x**3 > n:
        x -= 1
    while (x + 1) ** 3 <= n:
        x += 1
    return x


def _frac_root_bits(p: int, root: int, bits: int) -> int:
    """floor(frac(p^(1/root)) * 2^bits), computed exactly in integers."""
    scaled = p << (root * bits)
    r = math.isqrt(scaled) if root == 2 else _icbrt(scaled)
    return r - ((r >> bits) << bits)


_PRIMES64 = _first_primes(64)
SHA256_H0 = np.array([_frac_root_bits(p, 2, 32) for p in _PRIMES64[:8]], dtype=np.uint32)
SHA256_K = np.array([_frac_root_bits(p, 3, 32) for p in _PRIMES64], dtype=np.uint32)


# -- words across the wrappers: int32 bit patterns <-> int64 in [0, 2^32) -----


def words64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & M32


def bits32(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def to_words(a, device) -> torch.Tensor:
    """A u32 word array (numpy, any integer dtype, or an int32 tensor) as
    an int32 tensor of the same bits on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype != np.int32:
        a = a.astype(np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """An int32 word tensor back as a numpy u32 array of the same bits."""
    return t.cpu().numpy().view(np.uint32)


def check_masked_args(name: str, blocks, n_blocks, words: int) -> None:
    """What the masked-hash kernels take: blocks (B, M, words) and
    n_blocks (B,), int32, contiguous, on one device, the blocks 16-byte
    aligned (the kernels read them as 16-byte vectors)."""
    if blocks.dtype != torch.int32 or n_blocks.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32 blocks and n_blocks, got {blocks.dtype}, {n_blocks.dtype}")
    if blocks.dim() != 3 or blocks.shape[2] != words or blocks.shape[1] < 1:
        raise ValueError(f"{name}: expected blocks (B, M >= 1, {words}), got {tuple(blocks.shape)}")
    if tuple(n_blocks.shape) != (blocks.shape[0],):
        raise ValueError(f"{name}: expected n_blocks ({blocks.shape[0]},), got {tuple(n_blocks.shape)}")
    if blocks.device != n_blocks.device:
        raise ValueError(f"{name}: blocks on {blocks.device}, n_blocks on {n_blocks.device}")
    if blocks.device.type == "cuda":
        if not (blocks.is_contiguous() and n_blocks.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous tensors")
        if blocks.data_ptr() % 16:
            raise ValueError(f"{name}: blocks must be 16-byte aligned")


def launch_masked(name: str, blocks, n_blocks, out_words: int) -> torch.Tensor:
    """Launch one of the masked-hash kernels of `csrc/hash.cu`."""
    dev = blocks.device
    bsz, mb = blocks.shape[0], blocks.shape[1]
    out = torch.empty((bsz, out_words), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(kernel_lib(), name)(
            blocks.data_ptr(), n_blocks.data_ptr(), out.data_ptr(), bsz, mb, stream_ptr(dev)
        )
    check(rc, name)
    return out


# -- plain torch version -------------------------------------------------------


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state, w_block):
    """One SHA-256 compression. state (B, 8), w_block (B, 16): int64 words."""
    w = [w_block[:, i] for i in range(16)]
    for t in range(16, 64):
        # W[t] = W[t-16] + s0(W[t-15]) + W[t-7] + s1(W[t-2])
        x, y = w[t - 15], w[t - 2]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = (state[:, i] for i in range(8))
    for k, wt in zip(SHA256_K.tolist(), w):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + k + wt
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        a, b, c, d, e, f, g, h = (t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g
    return (torch.stack([a, b, c, d, e, f, g, h], dim=1) + state) & M32


def _initial_state(h0: np.ndarray, bsz: int, device) -> torch.Tensor:
    return torch.tensor(h0.astype(np.int64), device=device).expand(bsz, len(h0)).clone()


def _sha256_masked(blocks, n_blocks):
    """Plain version of the kernel: blocks (B, M, 16), n_blocks (B,) int32
    -> (B, 8) int32 digest words. Every block is compressed; a row keeps
    its state once j reaches its block count."""
    words = words64(blocks)
    state = _initial_state(SHA256_H0, blocks.shape[0], blocks.device)
    for j in range(blocks.shape[1]):
        new = _compress(state, words[:, j])
        state = torch.where((j < n_blocks)[:, None], new, state)
    return bits32(state)


def sha256_masked(blocks, n_blocks):
    """blocks (B, M, 16) int32 bit patterns of big-endian words, n_blocks
    (B,) int32 -> (B, 8) int32 digest words. CUDA tensors launch the
    `sha256_masked` kernel; CPU tensors run `_sha256_masked`."""
    check_masked_args("sha256_masked", blocks, n_blocks, 16)
    if blocks.device.type == "cpu":
        return _sha256_masked(blocks, n_blocks)
    if blocks.shape[0] == 0:
        return torch.empty((0, 8), dtype=torch.int32, device=blocks.device)
    out = launch_masked("sha256_masked", blocks, n_blocks, 8)
    sha256_masked.launches += 1
    return out


sha256_masked.launches = 0


def sha256_batch(blocks, n_blocks, device=None) -> torch.Tensor:
    """Digest a batch of padded messages: blocks (B, M, 16) u32 words,
    n_blocks (B,) -> (B, 8) int32 digest words on the device (on the card
    unless `device` says otherwise)."""
    dev = resolve_device(device)
    return sha256_masked(to_words(blocks, dev), to_words(n_blocks, dev))


def sha256_fixed2_from_words(w0, w1):
    """Digest exactly-two-block messages given their word arrays ((B, 16)
    int32 each, on one device): the Merkle inner node's shape."""
    blocks = torch.stack([w0, w1], dim=1).contiguous()
    twos = torch.full((blocks.shape[0],), 2, dtype=torch.int32, device=blocks.device)
    return sha256_masked(blocks, twos)


def sha256_digest_bytes(msgs: list[bytes], device=None) -> list[bytes]:
    """Host convenience: pad, hash on the device, bytes."""
    from tendermint_tpu_torch.ops.padding import digests_to_bytes_be, pad_sha256

    if not msgs:
        return []
    blocks, counts = pad_sha256(msgs)
    return digests_to_bytes_be(to_u32(sha256_batch(blocks, counts, device)))
