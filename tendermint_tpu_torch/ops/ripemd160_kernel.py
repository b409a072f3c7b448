"""Batched RIPEMD-160: the `ripemd160_masked` kernel and its plain version.

Counterpart of `tendermint_tpu/ops/ripemd160_kernel.py`: the reference's
Merkle hash, kept as the bit-compatible variant beside SHA-256. Two
80-step lines (ISO/IEC 10118-3) over little-endian u32 words.

On the card `ripemd160_masked` launches the CUDA kernel (`csrc/hash.cu`,
`csrc/ripemd160.cuh`); on the CPU it runs `_ripemd160_masked`, the JAX
arithmetic with int64 words masked to 32 bits (see `sha256_kernel`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.ops.sha256_kernel import (
    M32,
    _icbrt,
    _initial_state,
    bits32,
    check_masked_args,
    launch_masked,
    to_words,
    words64,
)

# Message word order per 16-step round group (left line, right line).
_RL = [
    list(range(16)),
    [7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8],
    [3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12],
    [1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2],
    [4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13],
]
_RR = [
    [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12],
    [6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2],
    [15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13],
    [8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14],
    [12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11],
]
# Rotation amounts.
_SL = [
    [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8],
    [7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12],
    [11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5],
    [11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12],
    [9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6],
]
_SR = [
    [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6],
    [9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11],
    [9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5],
    [15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8],
    [8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11],
]
# Round constants: left = floor(2^30*sqrt(2,3,5,7)), right = floor(2^30*cbrt(2,3,5,7)).
_KL = [0] + [math.isqrt(p << 60) for p in (2, 3, 5, 7)]
_KR = [_icbrt(p << 90) for p in (2, 3, 5, 7)] + [0]

_H0 = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0], dtype=np.uint32)


def _rotl(x, n: int):
    return ((x << n) | (x >> (32 - n))) & M32


def _f(j: int, x, y, z):
    if j == 0:
        out = x ^ y ^ z
    elif j == 1:
        out = (x & y) | (~x & z)
    elif j == 2:
        out = (x | ~y) ^ z
    elif j == 3:
        out = (x & z) | (y & ~z)
    else:
        out = x ^ (y | ~z)
    return out & M32


def _line(fns, r_tab, s_tab, k_tab, x, state5):
    """One full 80-step line. x: 16 words of (B,); state5: 5 words of (B,)."""
    a, b, c, d, e = state5
    for grp in range(5):
        k = k_tab[grp]
        for r_idx, s_amt in zip(r_tab[grp], s_tab[grp]):
            t = (_rotl((a + _f(fns[grp], b, c, d) + x[r_idx] + k) & M32, s_amt) + e) & M32
            a, b, c, d, e = e, t, b, _rotl(c, 10), d
    return a, b, c, d, e


def _compress160(state, w_block):
    """state (B, 5), w_block (B, 16): int64 little-endian words."""
    x = [w_block[:, i] for i in range(16)]
    init = tuple(state[:, i] for i in range(5))
    al, bl, cl, dl, el = _line(range(5), _RL, _SL, _KL, x, init)
    ar, br, cr, dr, er = _line([4 - j for j in range(5)], _RR, _SR, _KR, x, init)
    h0, h1, h2, h3, h4 = init
    out = [h1 + cl + dr, h2 + dl + er, h3 + el + ar, h4 + al + br, h0 + bl + cr]
    return torch.stack(out, dim=1) & M32


def _ripemd160_masked(blocks, n_blocks):
    """Plain version of the kernel: blocks (B, M, 16), n_blocks (B,) int32
    -> (B, 5) int32 digest words (little-endian)."""
    words = words64(blocks)
    state = _initial_state(_H0, blocks.shape[0], blocks.device)
    for j in range(blocks.shape[1]):
        new = _compress160(state, words[:, j])
        state = torch.where((j < n_blocks)[:, None], new, state)
    return bits32(state)


def ripemd160_masked(blocks, n_blocks):
    """blocks (B, M, 16) int32 bit patterns of little-endian words,
    n_blocks (B,) int32 -> (B, 5) int32 digest words. CUDA tensors launch
    the `ripemd160_masked` kernel; CPU tensors run `_ripemd160_masked`."""
    check_masked_args("ripemd160_masked", blocks, n_blocks, 16)
    if blocks.device.type == "cpu":
        return _ripemd160_masked(blocks, n_blocks)
    if blocks.shape[0] == 0:
        return torch.empty((0, 5), dtype=torch.int32, device=blocks.device)
    out = launch_masked("ripemd160_masked", blocks, n_blocks, 5)
    ripemd160_masked.launches += 1
    return out


ripemd160_masked.launches = 0


def ripemd160_batch(blocks, n_blocks, device=None) -> torch.Tensor:
    """blocks (B, M, 16) u32 LE words, n_blocks (B,) -> (B, 5) int32
    digest words (little-endian) on the device."""
    dev = resolve_device(device)
    return ripemd160_masked(to_words(blocks, dev), to_words(n_blocks, dev))
