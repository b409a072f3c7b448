"""The generic double-scalar verify for flat batches (no cached tables).

Counterpart of `tendermint_tpu/ops/ed25519_ladder_pallas.py`. Ad-hoc
batches (light-client first contact, evidence, mempool envelopes) have
no validator tables, so every lane computes [S]B + [h](-A) on its own.

The card's path is one kernel, `ladder` (`csrc/ladder.cu`), from the
encoding of A and the 128 nibbles of (S, h) that `_digits_w4` packs:
decompression, a table of 16 multiples of -A and a 4-bit window for
[h](-A), the w = 4 comb (`sb_table_w4`) for [S]B, one addition of the
halves. Its plain version `_ladder_w4_plain` takes the same steps in
torch and is the CPU path. The verdict is the table path's
encode-and-compare (`finish_encode_compare`, a kernel of its own) -- R
is never decompressed.

`_build_inputs` and `_ladder_plain` are the JAX package's algorithm
limb for limb: the torch prologue (per-lane table {O, B, -A, B-A} in
affine precomp form, one batched inversion) and 253 steps of
acc = madd(double(acc), table[s_bit + 2*h_bit]), msb-first. They are
the oracle the tests hold the card's path against.
"""

from __future__ import annotations

import torch

from tendermint_tpu_torch.ops._build import check, kernel_lib, stream_ptr
from tendermint_tpu_torch.ops.ed25519_kernel import (
    BX,
    BY,
    D2,
    MASK,
    NLIMBS,
    P,
    SCALAR_BITS,
    _D2_L,
    _D_L,
    _ONE_L,
    _SQRT_M1_L,
    _const,
    _int_to_limbs,
    _scalar_bits_from_le_bytes,
    base_point,
    bytes_to_fe,
    fe_canon,
    fe_carry,
    fe_cmov,
    fe_is_zero,
    fe_mul,
    fe_neg,
    fe_pow_p58,
    fe_sq,
    fe_sub,
    identity_point,
    pt_add,
    pt_decompress,
    pt_double,
    pt_neg,
)
from tendermint_tpu_torch.ops.ed25519_tables import (
    NSTEPS_W4,
    SB_NWIN,
    _check_cuda,
    _coords,
    _digits_w4,
    fe_batch_invert,
    finish_encode_compare,
    pt_madd,
    sb_table_w4,
)

# base-point and identity precomp constants
_YPX_B = _int_to_limbs((BY + BX) % P)
_YMX_B = _int_to_limbs((BY - BX) % P)
_T2D_B = _int_to_limbs(D2 * BX * BY % P)
_IDENT_PRE = _ONE_L, _ONE_L, _int_to_limbs(0)


def _affine_precomp(x, y):
    """Affine (x, y) -> (ypx, ymx, t2d) limbs, each (B, 20) canonical."""
    ypx = fe_canon(fe_carry(y + x))
    ymx = fe_canon(fe_sub(y, x))
    t2d = fe_canon(fe_mul(fe_mul(x, y), _const(_D2_L, x.device)))
    return ypx, ymx, t2d


def _ladder_digits(s_bytes, h_bytes):
    """(B, 32) uint8 LE scalars -> (B, 253) int32 selectors, msb-first:
    column t is s_bit(252-t) + 2*h_bit(252-t) — step t of the ladder
    adds table entry [selector_t] after the doubling."""
    s_bits = _scalar_bits_from_le_bytes(s_bytes)
    h_bits = _scalar_bits_from_le_bytes(h_bytes)
    return torch.flip(s_bits + 2 * h_bits, dims=(-1,)).contiguous()


def _build_inputs(pub_bytes, s_bytes, h_bytes):
    """Torch prologue: per-lane precomp tables + selection digits.

    Returns (gtab (4, B, 60) int32 entry-major — O, B, -A, B-A —,
    dig (B, 253) int32, a_ok (B,) bool). The JAX prologue returns the
    same values cut into (8, w) TPU tiles."""
    bsz = pub_bytes.shape[0]
    dev = pub_bytes.device
    shape = (bsz, NLIMBS)
    a_pt, a_ok = pt_decompress(pub_bytes)
    neg_a = pt_neg(a_pt)  # Z = 1: already affine
    e2 = _affine_precomp(neg_a[0], neg_a[1])
    t3 = pt_add(base_point((bsz,), dev), neg_a)  # B - A, projective
    zinv = fe_batch_invert(fe_carry(t3[2]))
    e3 = _affine_precomp(fe_mul(t3[0], zinv), fe_mul(t3[1], zinv))
    e1 = tuple(_const(c, dev).expand(shape) for c in (_YPX_B, _YMX_B, _T2D_B))
    e0 = tuple(_const(c, dev).expand(shape) for c in _IDENT_PRE)
    gtab = torch.stack([torch.cat(e, dim=-1) for e in (e0, e1, e2, e3)])
    return gtab, _ladder_digits(s_bytes, h_bytes), a_ok


def _ladder_plain(gtab, dig):
    """Plain version of the `ladder` kernel: gtab (4, B, 60), dig
    (B, 253) -> extended acc (x, y, z, t), each (B, 20)."""
    bsz = dig.shape[0]
    lanes = torch.arange(bsz, device=dig.device)
    acc = identity_point((bsz,), dig.device)
    for t in range(SCALAR_BITS):
        acc = pt_double(acc)
        e = gtab[dig[:, t].long(), lanes]  # (B, 60)
        acc = pt_madd(acc, (e[:, :20], e[:, 20:40], e[:, 40:]))
    return acc


# -- the card's flat path: decompression and both halves in one kernel --------


def _decompress_neg(pub_bytes):
    """Step 1 of the `ladder` kernel in torch: (B, 32) encodings ->
    (-A extended, a_ok). The rules of `pt_decompress` (y < p, on the
    curve, no x = 0 with the sign bit set), with y >= p read off the
    limbs as the kernel does; a rejected lane gets the identity, so
    every lane's point is on the curve."""
    enc = pub_bytes.to(torch.int32)
    sign = (enc[..., 31] >> 7) & 1
    y_enc = enc.clone()
    y_enc[..., 31] &= 0x7F
    y = bytes_to_fe(y_enc)  # exact 13-bit limbs of a value < 2^255
    # y >= p = 2^255 - 19: limbs 1..18 all ones, limb 19 (bits 247..254)
    # all ones, limb 0 at least 2^13 - 19
    y_ge_p = (y[..., 1:19] == MASK).all(dim=-1) & (y[..., 19] == 0xFF) & (y[..., 0] >= MASK + 1 - 19)
    dev = y.device
    one = _const(_ONE_L, dev).expand(y.shape)
    y2 = fe_sq(y)
    u = fe_sub(y2, one)
    v = fe_carry(fe_mul(y2, _const(_D_L, dev)) + one)
    v3 = fe_mul(fe_sq(v), v)
    v7 = fe_mul(fe_sq(v3), v)
    x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)))
    vxx = fe_mul(v, fe_sq(x))
    ok_direct = fe_is_zero(fe_sub(vxx, u))
    ok_flip = fe_is_zero(fe_carry(vxx + u))
    x = fe_cmov(x, fe_mul(x, _const(_SQRT_M1_L, dev)), ok_flip & ~ok_direct)
    xc = fe_canon(x)
    x_zero = (xc == 0).all(dim=-1)
    x = fe_cmov(x, fe_neg(x), (xc[..., 0] & 1) != sign)
    ok = (ok_direct | ok_flip) & ~y_ge_p & ~(x_zero & (sign == 1))
    ident = identity_point(y.shape[:-1], dev)
    nx = fe_cmov(ident[0], fe_neg(x), ok)
    ny = fe_cmov(ident[1], y, ok)
    return (nx, ny, ident[2], fe_mul(nx, ny)), ok


def _select_lanes(table, dig):
    """table: 16 points (each coordinate (B, 20)), dig (B,) -> the point
    table[dig[b]] of each lane b."""
    lanes = torch.arange(dig.shape[0], device=dig.device)
    return tuple(torch.stack([e[c] for e in table])[dig.long(), lanes] for c in range(4))


def _ladder_w4_plain(pub, digits):
    """Plain version of the `ladder` kernel, the same steps in torch:
    pub (B, 32) uint8, digits (B, 128) int32 (`_digits_w4`: 64 nibbles
    of S, then 64 of h) -> (extended [S]B + [h](-A), each (B, 20),
    a_ok (B,) bool)."""
    bsz = digits.shape[0]
    dev = digits.device
    neg_a, a_ok = _decompress_neg(pub)
    table = [identity_point((bsz,), dev)]
    for _ in range(15):
        table.append(pt_add(table[-1], neg_a))
    acc = identity_point((bsz,), dev)
    for w in reversed(range(SB_NWIN)):
        if w != SB_NWIN - 1:
            for _ in range(4):
                acc = pt_double(acc)
        acc = pt_add(acc, _select_lanes(table, digits[:, SB_NWIN + w]))
    sb = _const(sb_table_w4(), dev)
    accb = identity_point((bsz,), dev)
    for w in range(SB_NWIN):
        e = sb[w, digits[:, w].long()]
        accb = pt_madd(accb, (e[:, :20], e[:, 20:40], e[:, 40:]))
    return pt_add(acc, accb), a_ok


def ladder(pub, digits):
    """pub (B, 32) uint8 encodings of A, digits (B, 128) int32 nibbles
    -> (extended [S]B + [h](-A), each (B, 20) int32, a_ok (B,) bool).
    CUDA tensors launch the `ladder` kernel; CPU tensors run
    `_ladder_w4_plain`."""
    if digits.device.type == "cpu":
        return _ladder_w4_plain(pub, digits)
    bsz = digits.shape[0]
    _check_cuda("pub", pub, torch.uint8, (bsz, 32))
    _check_cuda("digits", digits, torch.int32, (bsz, NSTEPS_W4))
    if pub.device != digits.device:
        raise ValueError("pub and digits must be on the same device")
    dev = digits.device
    sb = _const(sb_table_w4(), dev)
    out = torch.empty((4, NLIMBS, bsz), dtype=torch.int32, device=dev)
    a_ok = torch.empty((bsz,), dtype=torch.bool, device=dev)
    lib = kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.ladder(
            pub.data_ptr(), digits.data_ptr(), sb.data_ptr(), out.data_ptr(),
            a_ok.data_ptr(), bsz, stream_ptr(dev),
        )
    check(rc, "ladder")
    ladder.launches += 1
    return _coords(out), a_ok


ladder.launches = 0


def verify_kernel_ladder(pub_bytes, r_bytes, s_bytes, h_bytes):
    """Flat-batch verify, the counterpart of `verify_kernel_pallas`:
    pub, r, s, h (B, 32) uint8 tensors -> (B,) bool, cofactorless
    [S]B + [h](-A) == R by byte-compare against the R encoding (the
    same verdicts as the JAX package's `verify_kernel`). The only torch
    work around the two kernels is the digit packing and the a_ok mask."""
    digits = _digits_w4(s_bytes.to(torch.int32), h_bytes.to(torch.int32))
    (x, y, z, _t), a_ok = ladder(pub_bytes.contiguous(), digits)
    return finish_encode_compare(x, y, z, r_bytes) & a_ok
