"""The generic double-scalar ladder for flat batches (no cached tables).

Counterpart of `tendermint_tpu/ops/ed25519_ladder_pallas.py`. Ad-hoc
batches (light-client first contact, evidence, mempool envelopes) have
no validator tables, so every lane runs a 253-step Shamir ladder:

  table = {O, B, -A, B-A} in affine ypx/ymx/t2d precomp form (built by
  the torch prologue `_build_inputs`: one decompress, one point add and
  one batched inversion), then 253 identical steps of
      acc = madd(double(acc), table[s_bit + 2*h_bit])
  msb-first. The identity is the precomp (1, 1, 0), so every step is
  branch-free. The verdict is the table path's encode-and-compare
  (`_finish_encode_compare`) — R is never decompressed.

`ladder` launches the CUDA kernel (`csrc/ladder.cu`) for CUDA tensors
and runs its plain torch version for CPU tensors. Unlike the TPU kernel
it takes any batch size: there is no 1024-lane tile.
"""

from __future__ import annotations

import torch

from tendermint_tpu_torch.ops._build import check, kernel_lib, stream_ptr
from tendermint_tpu_torch.ops.ed25519_kernel import (
    BX,
    BY,
    D2,
    NLIMBS,
    P,
    SCALAR_BITS,
    _D2_L,
    _ONE_L,
    _const,
    _int_to_limbs,
    _scalar_bits_from_le_bytes,
    base_point,
    fe_canon,
    fe_carry,
    fe_mul,
    fe_sub,
    identity_point,
    pt_add,
    pt_decompress,
    pt_double,
    pt_neg,
)
from tendermint_tpu_torch.ops.ed25519_tables import (
    _check_cuda,
    _coords,
    _finish_encode_compare,
    fe_batch_invert,
    pt_madd,
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


def ladder(gtab, dig):
    """gtab (4, B, 60) int32, dig (B, 253) int32 -> extended acc
    (x, y, z, t), each (B, 20) int32. CUDA tensors launch the `ladder`
    kernel; CPU tensors run `_ladder_plain`."""
    if dig.device.type == "cpu":
        return _ladder_plain(gtab, dig)
    bsz = dig.shape[0]
    _check_cuda("gtab", gtab, torch.int32, (4, bsz, 3 * NLIMBS))
    _check_cuda("dig", dig, torch.int32, (bsz, SCALAR_BITS))
    if gtab.device != dig.device:
        raise ValueError("gtab and dig must be on the same device")
    gtab_t = gtab.transpose(1, 2).contiguous()  # (4, 60, B): lanes adjacent
    dig_t = dig.T.contiguous()  # (253, B)
    out = torch.empty((4, NLIMBS, bsz), dtype=torch.int32, device=dig.device)
    lib = kernel_lib()
    with torch.cuda.device(dig.device):
        rc = lib.ladder(
            gtab_t.data_ptr(), dig_t.data_ptr(), out.data_ptr(), bsz, stream_ptr(dig.device)
        )
    check(rc, "ladder")
    ladder.launches += 1
    return _coords(out)


ladder.launches = 0


def verify_kernel_ladder(pub_bytes, r_bytes, s_bytes, h_bytes):
    """Flat-batch verify, the counterpart of `verify_kernel_pallas`:
    pub, r, s, h (B, 32) uint8 tensors -> (B,) bool, cofactorless
    [S]B + [h](-A) == R by byte-compare against the R encoding (the
    same verdicts as the JAX package's `verify_kernel`)."""
    gtab, dig, a_ok = _build_inputs(pub_bytes, s_bytes, h_bytes)
    x, y, z, _t = ladder(gtab.contiguous(), dig)
    return _finish_encode_compare(x, y, z, r_bytes.to(torch.int32)) & a_ok
