"""Batched SHA-512: the `sha512_masked` kernel and its plain version.

Counterpart of `tendermint_tpu/ops/sha512_kernel.py` (h = SHA-512(R || A
|| M) of ed25519). Blocks and digests are 64-bit big-endian words as
(hi, lo) pairs of u32, the JAX package's layout (`padding.pad_sha512`).

On the card `sha512_masked` launches the CUDA kernel (`csrc/hash.cu`,
`csrc/sha512.cuh`), which joins each pair into a native 64-bit word. On
the CPU `_sha512_masked` keeps the JAX emulation on (hi, lo) pairs, each
half an int64 in [0, 2^32) (never a signed 64-bit word: `>>` on int64 is
arithmetic), with the carry of an addition taken as `lo < a.lo`.
"""

from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.ops.sha256_kernel import (
    M32,
    _first_primes,
    _frac_root_bits,
    _initial_state,
    bits32,
    check_masked_args,
    launch_masked,
    to_words,
    words64,
)

_PRIMES80 = _first_primes(80)
# (hi, lo) u32 pairs for H0 (sqrt of first 8 primes) and K (cbrt of first 80).
_H0_64 = [_frac_root_bits(p, 2, 64) for p in _PRIMES80[:8]]
_K_64 = [_frac_root_bits(p, 3, 64) for p in _PRIMES80]
SHA512_H0_HI = np.array([v >> 32 for v in _H0_64], dtype=np.uint32)
SHA512_H0_LO = np.array([v & M32 for v in _H0_64], dtype=np.uint32)
SHA512_K_HI = np.array([v >> 32 for v in _K_64], dtype=np.uint32)
SHA512_K_LO = np.array([v & M32 for v in _K_64], dtype=np.uint32)


# -- 64-bit operations on (hi, lo) pairs of int64 words in [0, 2^32) ---------


def _add64(a, b):
    lo = (a[1] + b[1]) & M32
    carry = (lo < a[1]).to(torch.int64)
    return ((a[0] + b[0] + carry) & M32, lo)


def _add64_many(*xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = _add64(acc, x)
    return acc


def _xor64(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def _and64(a, b):
    return (a[0] & b[0], a[1] & b[1])


def _not64(a):
    return (~a[0] & M32, ~a[1] & M32)


def _rotr64(x, n: int):
    hi, lo = x
    if n == 32:
        return (lo, hi)
    if n < 32:
        inv = 32 - n
        return (((hi >> n) | (lo << inv)) & M32, ((lo >> n) | (hi << inv)) & M32)
    m, inv = n - 32, 64 - n
    return (((lo >> m) | (hi << inv)) & M32, ((hi >> m) | (lo << inv)) & M32)


def _shr64(x, n: int):
    hi, lo = x
    if n < 32:
        return (hi >> n, ((lo >> n) | (hi << (32 - n))) & M32)
    return (torch.zeros_like(hi), hi >> (n - 32))


def _compress512(state, w_block):
    """state (B, 16), w_block (B, 32): int64 words, (hi, lo) interleaved."""
    w = [(w_block[:, 2 * i], w_block[:, 2 * i + 1]) for i in range(16)]
    for t in range(16, 80):
        x, y = w[t - 15], w[t - 2]
        s0 = _xor64(_xor64(_rotr64(x, 1), _rotr64(x, 8)), _shr64(x, 7))
        s1 = _xor64(_xor64(_rotr64(y, 19), _rotr64(y, 61)), _shr64(y, 6))
        w.append(_add64_many(w[t - 16], s0, w[t - 7], s1))
    init = tuple((state[:, 2 * i], state[:, 2 * i + 1]) for i in range(8))
    a, b, c, d, e, f, g, h = init
    for k_hi, k_lo, wt in zip(SHA512_K_HI.tolist(), SHA512_K_LO.tolist(), w):
        kt = (torch.full_like(a[0], k_hi), torch.full_like(a[1], k_lo))
        S1 = _xor64(_xor64(_rotr64(e, 14), _rotr64(e, 18)), _rotr64(e, 41))
        ch = _xor64(_and64(e, f), _and64(_not64(e), g))
        t1 = _add64_many(h, S1, ch, kt, wt)
        S0 = _xor64(_xor64(_rotr64(a, 28), _rotr64(a, 34)), _rotr64(a, 39))
        maj = _xor64(_xor64(_and64(a, b), _and64(a, c)), _and64(b, c))
        t2 = _add64(S0, maj)
        a, b, c, d, e, f, g, h = _add64(t1, t2), a, b, c, _add64(d, t1), e, f, g
    out = [_add64(r, s) for r, s in zip((a, b, c, d, e, f, g, h), init)]
    return torch.stack([part for pair in out for part in pair], dim=1)


def _sha512_h0() -> np.ndarray:
    h0 = np.empty(16, dtype=np.uint32)
    h0[0::2] = SHA512_H0_HI
    h0[1::2] = SHA512_H0_LO
    return h0


def _sha512_masked(blocks, n_blocks):
    """Plain version of the kernel: blocks (B, M, 32), n_blocks (B,) int32
    -> (B, 16) int32 digest words, (hi, lo) pairs."""
    words = words64(blocks)
    state = _initial_state(_sha512_h0(), blocks.shape[0], blocks.device)
    for j in range(blocks.shape[1]):
        new = _compress512(state, words[:, j])
        state = torch.where((j < n_blocks)[:, None], new, state)
    return bits32(state)


def sha512_masked(blocks, n_blocks):
    """blocks (B, M, 32) int32 bit patterns of (hi, lo) word pairs,
    n_blocks (B,) int32 -> (B, 16) int32 digest words. CUDA tensors
    launch the `sha512_masked` kernel; CPU tensors run `_sha512_masked`."""
    check_masked_args("sha512_masked", blocks, n_blocks, 32)
    if blocks.device.type == "cpu":
        return _sha512_masked(blocks, n_blocks)
    if blocks.shape[0] == 0:
        return torch.empty((0, 16), dtype=torch.int32, device=blocks.device)
    out = launch_masked("sha512_masked", blocks, n_blocks, 16)
    sha512_masked.launches += 1
    return out


sha512_masked.launches = 0


def sha512_batch(blocks, n_blocks, device=None) -> torch.Tensor:
    """blocks (B, M, 32) u32 (64-bit BE words as hi, lo pairs), n_blocks
    (B,) -> (B, 16) int32: the 64-byte digests as big-endian u32 words."""
    dev = resolve_device(device)
    return sha512_masked(to_words(blocks, dev), to_words(n_blocks, dev))
