"""Batched ed25519 signature verification: the torch field and curve core.

Counterpart of `tendermint_tpu/ops/ed25519_kernel.py`, with the same
function names and the same limb arithmetic, so every value agrees with
the JAX package's bit for bit:

* GF(2^255-19) elements are vectors of 20 signed 13-bit limbs in int32
  (radix 2^13). The radix is kept because the comb tables hold canonical
  13-bit limbs and the tests compare the two packages limb by limb; the
  hand kernels in `csrc/` take the same limbs at their boundary and sum
  their products in 64 bits inside.
* Curve points use extended twisted-Edwards coordinates (X, Y, Z, T),
  a = -1, with the unified hwcd-3 addition law (no branches).
* Verification checks the cofactorless equation [S]B + [h](-A) == R.
  Flat batches take the generic ladder (`ops/ed25519_ladder.py`) on
  every device: its kernel on the card, its plain version on the CPU.
* h = SHA512(R || A || M) mod L is computed on the host.

All functions act elementwise over leading batch axes; the last axis
holds the 20 limbs.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.utils import shutdown

# -- constants ---------------------------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # group order
D = (-121665 * pow(121666, P - 2, P)) % P  # Edwards d
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)
# Base point
_BY = (4 * pow(5, P - 2, P)) % P
_BX_SQ = (_BY * _BY - 1) * pow(D * _BY * _BY + 1, P - 2, P) % P
_BX = pow(_BX_SQ, (P + 3) // 8, P)
if (_BX * _BX - _BX_SQ) % P != 0:
    _BX = (_BX * SQRT_M1) % P
if _BX % 2 != 0:
    _BX = P - _BX
BX, BY = _BX, _BY

NLIMBS = 20
RADIX = 13
MASK = (1 << RADIX) - 1
# 2^260 = 2^5 * 2^255 ≡ 32*19 = 608 (mod p): the fold factor for limbs >= 20.
FOLD = 608
SCALAR_BITS = 253  # scalars are < L < 2^253


def _int_to_limbs(x: int) -> np.ndarray:
    out = np.zeros(NLIMBS, dtype=np.int32)
    for i in range(NLIMBS):
        out[i] = x & MASK
        x >>= RADIX
    return out


def _limbs_to_int(limbs) -> int:
    x = 0
    for i in reversed(range(NLIMBS)):
        x = (x << RADIX) | int(limbs[i])
    return x


_D_L = _int_to_limbs(D)
_D2_L = _int_to_limbs(D2)
_SQRT_M1_L = _int_to_limbs(SQRT_M1)
_ONE_L = _int_to_limbs(1)
_P_L = _int_to_limbs(P)
_16P_L = _int_to_limbs(16 * P)
# carry weights: limb 0 receives the carry out of limb 19 times 608
_FOLD_W = np.ones(NLIMBS, dtype=np.int32)
_FOLD_W[0] = FOLD

_CONSTS: dict = {}


def _const(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy constant as a tensor on `device`, cached per device."""
    key = (id(arr), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(arr).to(device)
        _CONSTS[key] = t
    return t


def _arange(n: int, device) -> torch.Tensor:
    key = ("arange", n, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.arange(n, dtype=torch.int32, device=device)
        _CONSTS[key] = t
    return t


# -- field arithmetic (batched over leading axes; last axis = 20 limbs) ------


def _carry_round(t):
    """One vectorized carry round with the 608 fold: every limb keeps
    its low 13 bits and receives the carry of the limb below (limb 0
    receives 608 times the carry out of limb 19). Signed arithmetic
    shifts give floor semantics for negatives."""
    c = t >> RADIX
    r = t & MASK
    return r + torch.roll(c, 1, dims=-1) * _const(_FOLD_W, t.device)


def fe_carry(t):
    """Bring limbs into the loose range [0, 2^13 + 608·k) for small k.

    Three rounds: entering magnitudes < 2^30 fall to < 2^13.6, which
    keeps the 20-term column sums of fe_mul below 2^31. Exact canonical
    form (needed only for equality/serialization) is fe_canon."""
    t = _carry_round(t)
    t = _carry_round(t)
    t = _carry_round(t)
    return t


def fe_add(a, b):
    return a + b  # callers must carry before multiplying


def fe_addc(a, b):
    return fe_carry(a + b)


def fe_sub(a, b):
    """a - b, re-normalized to the loose range (limbs may be ≥ 0 or tiny-)."""
    return fe_carry(fe_carry(a - b))


def fe_neg(a):
    return fe_carry(fe_carry(-a))


# rows per fe_mul pass: bounds the (rows, 20, 40) int32 product scratch
# (3.4 GB at 2^20 rows) when the table build multiplies millions of rows
_MUL_CHUNK = 1 << 20


def _mul_rows(a, b):
    """(n, 20) x (n, 20) -> (n, 20) product, carried.

    The 20x20 limb products are formed in one broadcast multiply against
    b padded to 40 limbs; reading that (n, 20, 40) block as (n, 800),
    dropping the last 20 entries and re-reading it as (n, 20, 39) shifts
    row i right by i, so a sum over rows yields the 39 schoolbook
    columns. A handful of launches per multiply instead of one per
    limb."""
    n = a.shape[0]
    width = 2 * NLIMBS - 1
    bp = F.pad(b, (0, NLIMBS))
    prod = a[:, :, None] * bp[:, None, :]
    cols = prod.reshape(n, 2 * NLIMBS * NLIMBS)[:, : NLIMBS * width]
    cols = cols.reshape(n, NLIMBS, width).sum(dim=1, dtype=torch.int32)
    # One vectorized carry round bounds every column < 2^18.2, so the
    # 608 fold below cannot overflow.
    c = cols >> RADIX
    r = cols & MASK
    r = r + F.pad(c[:, :-1], (1, 0))
    lo = r[:, :NLIMBS]
    hi = torch.cat([r[:, NLIMBS:], c[:, -1:]], dim=1)  # cols 20..39
    return fe_carry(lo + FOLD * hi)


def fe_mul(a, b):
    """Schoolbook 20x20 limb product, 39 columns, folded mod 2^255-19.

    Inputs must satisfy the loose invariant (limbs from fe_carry), so
    every column sum fits int32 — the same bound the JAX package's
    fe_mul relies on, and the same results limb for limb."""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    a2 = a.reshape(-1, NLIMBS)
    b2 = b.reshape(-1, NLIMBS)
    n = a2.shape[0]
    if n <= _MUL_CHUNK:
        out = _mul_rows(a2, b2)
    else:
        out = torch.cat(
            [
                _mul_rows(a2[lo : lo + _MUL_CHUNK], b2[lo : lo + _MUL_CHUNK])
                for lo in range(0, n, _MUL_CHUNK)
            ]
        )
    return out.reshape(shape)


def fe_sq(a):
    return fe_mul(a, a)


def fe_cmov(a, b, flag):
    """flag ? b : a, elementwise over the batch (flag shape (...,))."""
    return torch.where(flag[..., None], b, a)


def _carry_exact(a):
    """Sequential 20-step carry: limbs exactly in [0, 2^13), 608-folded.
    Only used by fe_canon (equality / serialization)."""
    for _ in range(2):
        limbs = []
        c = torch.zeros_like(a[..., 0])
        for i in range(NLIMBS):
            v = a[..., i] + c
            c = v >> RADIX
            limbs.append(v & MASK)
        a = torch.stack(limbs, dim=-1)
        a[..., 0] += FOLD * c
    return a


def fe_canon(a):
    """Fully canonical representative in [0, p)."""
    a = fe_carry(a)
    # Loose limbs can be slightly negative; +16p makes the value positive
    # without changing it mod p, and keeps everything under 2^260.
    a = _carry_exact(a + _const(_16P_L, a.device))
    # Fold bits >= 255 down: limb 19 holds bits 247..259, so k = top 5 bits.
    for _ in range(2):
        k = a[..., 19] >> 8
        a[..., 19] &= 0xFF
        a[..., 0] += 19 * k  # 2^255 ≡ 19 (mod p)
        a = _carry_exact(a)
    ge = _fe_ge_p(a)
    a = torch.where(ge[..., None], a - _const(_P_L, a.device), a)
    return _carry_exact(a)


def _fe_ge_p(a):
    """value(a) >= p, for a with limbs in [0, 2^13) and value < 2^256."""
    gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in reversed(range(NLIMBS)):
        pi = int(_P_L[i])
        gt = gt | (eq & (a[..., i] > pi))
        eq = eq & (a[..., i] == pi)
    return gt | eq


def fe_eq(a, b):
    """Constant-shape equality mod p."""
    return torch.all(fe_canon(a) == fe_canon(b), dim=-1)


def fe_is_zero(a):
    return torch.all(fe_canon(a) == 0, dim=-1)


def _sq_n(x, n):
    for _ in range(n):
        # the longest run of steps in a table build or a plain verify:
        # a background thread stops here when asked (`utils/shutdown.py`)
        shutdown.check()
        x = fe_sq(x)
    return x


def _pow_chain(a):
    """Shared prefix of the inversion and square-root chains:
    (z11, z2_250_0) = (a^11, a^(2^250 - 1))."""
    z2 = fe_sq(a)
    z9 = fe_mul(_sq_n(z2, 2), a)
    z11 = fe_mul(z9, z2)
    z2_5_0 = fe_mul(fe_sq(z11), z9)
    z2_10_0 = fe_mul(_sq_n(z2_5_0, 5), z2_5_0)
    z2_20_0 = fe_mul(_sq_n(z2_10_0, 10), z2_10_0)
    z2_40_0 = fe_mul(_sq_n(z2_20_0, 20), z2_20_0)
    z2_50_0 = fe_mul(_sq_n(z2_40_0, 10), z2_10_0)
    z2_100_0 = fe_mul(_sq_n(z2_50_0, 50), z2_50_0)
    z2_200_0 = fe_mul(_sq_n(z2_100_0, 100), z2_100_0)
    z2_250_0 = fe_mul(_sq_n(z2_200_0, 50), z2_50_0)
    return z11, z2_250_0


def fe_invert(a):
    """a^(p-2) via the standard curve25519 addition chain (11 muls, 254 sqs)."""
    z11, z2_250_0 = _pow_chain(a)
    return fe_mul(_sq_n(z2_250_0, 5), z11)


def fe_pow_p58(a):
    """a^((p-5)/8), used by the combined sqrt(u/v) in decompression."""
    _z11, z2_250_0 = _pow_chain(a)
    return fe_mul(_sq_n(z2_250_0, 2), a)


# -- byte <-> limb conversion -------------------------------------------------


def bytes_to_fe(b):
    """(..., 32) uint8 little-endian -> (..., 20) int32 limbs (bit 255 kept)."""
    b = b.to(torch.int32)
    dev = b.device
    bits = (b[..., :, None] >> _arange(8, dev)) & 1  # (..., 32, 8)
    bits = bits.reshape(b.shape[:-1] + (256,))
    bits = F.pad(bits, (0, NLIMBS * RADIX - 256))
    bits = bits.reshape(b.shape[:-1] + (NLIMBS, RADIX))
    return (bits << _arange(RADIX, dev)).sum(dim=-1, dtype=torch.int32)


def fe_to_bytes(a):
    """Canonical little-endian 32 bytes from limbs: (..., 20) -> (..., 32) i32."""
    a = fe_canon(a)
    dev = a.device
    bits = (a[..., :, None] >> _arange(RADIX, dev)) & 1  # (..., 20, 13)
    bits = bits.reshape(a.shape[:-1] + (NLIMBS * RADIX,))[..., :256]
    bits = bits.reshape(a.shape[:-1] + (32, 8))
    return (bits << _arange(8, dev)).sum(dim=-1, dtype=torch.int32)


# -- point ops: extended twisted Edwards (X, Y, Z, T), a = -1 ----------------
# A point is a tuple of four fe's, each (..., 20).


def pt_add(p, q):
    """Unified addition (add-2008-hwcd-3, a=-1): 9M; branch-free."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a_ = fe_mul(fe_sub(y1, x1), fe_sub(y2, x2))
    b_ = fe_mul(fe_carry(y1 + x1), fe_carry(y2 + x2))
    c_ = fe_mul(fe_mul(t1, _const(_D2_L, t1.device)), t2)
    d_ = fe_mul(fe_carry(z1 + z1), z2)
    e_ = fe_sub(b_, a_)
    f_ = fe_sub(d_, c_)
    g_ = fe_carry(d_ + c_)
    h_ = fe_carry(b_ + a_)
    return (fe_mul(e_, f_), fe_mul(g_, h_), fe_mul(f_, g_), fe_mul(e_, h_))


def pt_double(p):
    """dbl-2008-hwcd, a=-1: 4M + 4S."""
    x1, y1, z1, _ = p
    a_ = fe_sq(x1)
    b_ = fe_sq(y1)
    c_ = fe_carry(2 * fe_sq(z1))
    h_ = fe_carry(a_ + b_)
    e_ = fe_sub(h_, fe_sq(fe_carry(x1 + y1)))
    g_ = fe_sub(a_, b_)
    f_ = fe_carry(c_ + g_)
    return (fe_mul(e_, f_), fe_mul(g_, h_), fe_mul(f_, g_), fe_mul(e_, h_))


def pt_neg(p):
    x, y, z, t = p
    return (fe_neg(x), y, z, fe_neg(t))


def _broadcast_const(arr: np.ndarray, shape, device) -> torch.Tensor:
    return _const(arr, device).expand(shape)


def pt_decompress(y_bytes):
    """Decode 32-byte point encodings -> (point, ok_mask).

    y_bytes: (..., 32) uint8/int32. Returns extended coords and a bool
    mask of valid encodings (on-curve, canonical y, consistent sign).
    Branch-free: invalid lanes still produce *some* point; callers must
    AND the mask into the final verdict.
    """
    y_bytes = y_bytes.to(torch.int32)
    sign = (y_bytes[..., 31] >> 7) & 1
    y_clean = y_bytes.clone()
    y_clean[..., 31] &= 0x7F
    y = bytes_to_fe(y_clean)
    dev = y.device
    y_noncanon = _fe_ge_p(y)  # canonical check: y < p
    one = _broadcast_const(_ONE_L, y.shape, dev)
    y2 = fe_sq(y)
    u = fe_sub(y2, one)  # y^2 - 1
    v = fe_addc(fe_mul(y2, _const(_D_L, dev)), one)  # d*y^2 + 1
    # x = u v^3 (u v^7)^((p-5)/8); then fix by sqrt(-1) if needed.
    v3 = fe_mul(fe_sq(v), v)
    v7 = fe_mul(fe_sq(v3), v)
    x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)))
    vxx = fe_mul(v, fe_sq(x))
    ok_direct = fe_eq(vxx, u)
    ok_flip = fe_eq(vxx, fe_neg(u))
    x = fe_cmov(x, fe_mul(x, _const(_SQRT_M1_L, dev)), ok_flip & ~ok_direct)
    on_curve = ok_direct | ok_flip
    # sign: RFC 8032 — if x == 0 and sign bit set, reject.
    x_bytes = fe_to_bytes(x)
    x_is_zero = fe_is_zero(x)
    x_odd = (x_bytes[..., 0] & 1) == 1
    need_neg = x_odd != (sign == 1)
    x = fe_cmov(x, fe_neg(x), need_neg)
    bad_sign_zero = x_is_zero & (sign == 1)
    ok = on_curve & ~y_noncanon & ~bad_sign_zero
    t = fe_mul(x, y)
    z = one.clone()
    return (x, y, z, t), ok


def identity_point(shape, device):
    """Extended identity (0, 1, 1, 0), each coordinate `shape + (20,)`."""
    zero = torch.zeros(tuple(shape) + (NLIMBS,), dtype=torch.int32, device=device)
    one = zero.clone()
    one[..., 0] = 1
    return (zero, one, one.clone(), zero.clone())


def base_point(shape, device):
    """The base point B in extended coordinates, broadcast to `shape`."""
    full = tuple(shape) + (NLIMBS,)
    return tuple(
        _broadcast_const(c, full, device)
        for c in (_BX_L, _BY_L, _ONE_L, _BT_L)
    )


_BX_L = _int_to_limbs(BX)
_BY_L = _int_to_limbs(BY)
_BT_L = _int_to_limbs(BX * BY % P)


def _scalar_bits_from_le_bytes(s_bytes):
    """(..., 32) uint8 LE -> (..., 253) int32 bits, LSB first."""
    s = s_bytes.to(torch.int32)
    bits = (s[..., :, None] >> _arange(8, s.device)) & 1
    return bits.reshape(s.shape[:-1] + (256,))[..., :SCALAR_BITS]


# -- host-side batch entry points ---------------------------------------------


def _reduce_mod_l_le(data: bytes) -> bytes:
    return (int.from_bytes(data, "little") % L).to_bytes(32, "little")


def prepare_batch(pubkeys, msgs, sigs):
    """Host prep: compute h = SHA512(R||A||M) mod L; canonicality checks.

    Returns (pub, r, s, h) uint8 arrays of shape (B, 32) and a (B,) bool
    mask `precheck` that is False for signatures malformed beyond what
    the device checks (wrong length, S >= L).
    """
    n = len(pubkeys)
    pub = np.zeros((n, 32), dtype=np.uint8)
    r = np.zeros((n, 32), dtype=np.uint8)
    s = np.zeros((n, 32), dtype=np.uint8)
    h = np.zeros((n, 32), dtype=np.uint8)
    precheck = np.zeros(n, dtype=bool)
    for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
        if len(pk) != 32 or len(sig) != 64:
            continue
        s_int = int.from_bytes(sig[32:], "little")
        if s_int >= L:
            # Deliberate strictness (RFC 8032 §5.1.7): non-canonical
            # S >= L is rejected, removing signature malleability; the
            # host verifier applies the same rule.
            continue
        precheck[i] = True
        pub[i] = np.frombuffer(pk, dtype=np.uint8)
        r[i] = np.frombuffer(sig[:32], dtype=np.uint8)
        s[i] = np.frombuffer(sig[32:], dtype=np.uint8)
        hh = hashlib.sha512(sig[:32] + pk + msg).digest()
        h[i] = np.frombuffer(_reduce_mod_l_le(hh), dtype=np.uint8)
    return pub, r, s, h, precheck


def bucket_size(n: int) -> int:
    """Pad batch sizes to power-of-two buckets (min 8)."""
    size = 8
    while size < n:
        size *= 2
    return size


def launch_batch_verify(pubkeys, msgs, sigs, device=None):
    """Async half of `batch_verify`: host prep + device launch only.

    Returns `(device_verdict, precheck, n)` with the verdict not yet
    synchronised: the launches are queued on the current CUDA stream and
    the caller is free to do host work while the card computes.
    `materialize_batch_verify` blocks on the copy back. Every bucket
    takes `ed25519_ladder.verify_kernel_ladder`: on the card its ladder
    kernel, on the CPU the kernel's plain version.
    """
    dev = resolve_device(device)
    n = len(pubkeys)
    pub, r, s, h, precheck = prepare_batch(pubkeys, msgs, sigs)
    size = bucket_size(n)
    if size != n:
        pad = np.zeros((size - n, 32), dtype=np.uint8)
        pub, r, s, h = (np.concatenate([a, pad]) for a in (pub, r, s, h))
    pub, r, s, h = (torch.from_numpy(a).to(dev) for a in (pub, r, s, h))
    # imported here: the ladder module builds on this one
    from tendermint_tpu_torch.ops.ed25519_ladder import verify_kernel_ladder

    return verify_kernel_ladder(pub, r, s, h), precheck, n


def materialize_batch_verify(launched) -> np.ndarray:
    """Blocking half: copy the verdict to the host, mask prechecks."""
    verdict, precheck, n = launched
    return verdict.cpu().numpy()[:n] & precheck


def batch_verify(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """Verify a batch of ed25519 signatures; returns (B,) bool."""
    if len(pubkeys) == 0:
        return np.zeros(0, dtype=bool)
    return materialize_batch_verify(
        launch_batch_verify(pubkeys, msgs, sigs, device=device)
    )
