"""Pure-Python ed25519 (RFC 8032): the port's host verifier and signer.

A copy of `tendermint_tpu/crypto/ed25519_ref.py`, kept here because the
port imports nothing of the JAX package. It needs no third-party
package, so it also signs on machines without `cryptography`.

Verification is COFACTORLESS ([S]B - [h]A == R by encoding compare),
matching the batched device kernels (`ops/ed25519_kernel.py`,
`ops/ed25519_tables.py`), so verdicts agree across backends. Arithmetic
uses Python ints in extended homogeneous coordinates.
"""

from __future__ import annotations

import functools as _functools
import hashlib

P = 2**255 - 19  # field prime
L = 2**252 + 27742317777372353535851937790883648493  # group order
D = (-121665 * pow(121666, P - 2, P)) % P  # curve constant -121665/121666

# base point
_BY = 4 * pow(5, P - 2, P) % P
_BX: int


def _recover_x(y: int, sign: int) -> int | None:
    """x from y per RFC 8032 §5.1.3; None when no square root exists."""
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P)
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
        if (x * x - x2) % P != 0:
            return None
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
_B = (_BX, _BY, 1, _BX * _BY % P)  # extended (X, Y, Z, T), Z=1
_IDENT = (0, 1, 1, 0)


def _pt_add(p, q):
    """add-2008-hwcd-3 on extended coordinates (a=-1 twist form)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * D % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _pt_double(p):
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1)
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _scalar_mult(s: int, p) -> tuple:
    acc = _IDENT
    while s:
        if s & 1:
            acc = _pt_add(acc, p)
        p = _pt_double(p)
        s >>= 1
    return acc


# -- speed: fixed-base comb + windowed variable-base ---------------------------
#
# * fixed-base comb for B: 32 radix-256 digit tables, [S]B = <=32 adds,
#   zero doublings (tables built lazily once per process);
# * window-4 multiplication for the variable base A: 15 precomputed
#   multiples, 63 nibbles msb-first -> 252 doublings + <=63 adds instead
#   of 253 doublings + ~127 adds.

_BASE_COMB: list[list[tuple]] | None = None


def _base_comb() -> list[list[tuple]]:
    global _BASE_COMB
    if _BASE_COMB is None:
        tables = []
        base = _B
        for _ in range(32):
            row = [_IDENT]
            acc = _IDENT
            for _d in range(255):
                acc = _pt_add(acc, base)
                row.append(acc)
            tables.append(row)
            for _ in range(8):
                base = _pt_double(base)
        _BASE_COMB = tables
    return _BASE_COMB


def _mult_base(s: int) -> tuple:
    """[s]B via the comb: one table add per radix-256 digit."""
    tables = _base_comb()
    acc = _IDENT
    i = 0
    while s:
        d = s & 0xFF
        if d:
            acc = _pt_add(acc, tables[i][d])
        s >>= 8
        i += 1
    return acc


def _mult_var(s: int, p) -> tuple:
    """[s]p for an arbitrary point: fixed window of 4 bits."""
    pre = [_IDENT, p]
    for _d in range(2, 16):
        pre.append(_pt_add(pre[-1], p))
    acc = _IDENT
    started = False
    for shift in range(252, -4, -4):
        if started:
            acc = _pt_double(_pt_double(_pt_double(_pt_double(acc))))
        d = (s >> shift) & 0xF
        if d:
            acc = _pt_add(acc, pre[d])
            started = True
    return acc


def _encode_point(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return ((y | ((x & 1) << 255))).to_bytes(32, "little")


def _decode_point(data: bytes) -> tuple | None:
    if len(data) != 32:
        return None
    enc = int.from_bytes(data, "little")
    y = enc & ((1 << 255) - 1)
    x = _recover_x(y, enc >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def is_small_order(pub: bytes) -> bool:
    """True when `pub` is NOT a safe signing identity: undecodable,
    non-canonical (y >= p), or a torsion point of order dividing 8.

    Small-order keys are the classic ed25519 adversarial input: for the
    all-zero key (order 4), h = H(R, A, M) mod 4 lands on 0 for ~1/4 of
    messages, making (zero key, zero sig) "verify" against arbitrary
    payloads through cofactorless verifies — a keyless forgery. The
    host verify path screens signer keys through this check."""
    if len(pub) != 32:
        return True
    if (int.from_bytes(pub, "little") & ((1 << 255) - 1)) >= P:
        return True  # non-canonical encoding
    pt = _decode_point(pub)
    if pt is None:
        return True
    q = _pt_double(_pt_double(_pt_double(pt)))  # [8]A
    # identity in extended coordinates: X/Z == 0 and Y/Z == 1
    return q[0] % P == 0 and (q[1] - q[2]) % P == 0


def _sha512_int(*chunks: bytes) -> int:
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "little")


# holds a 10,000-validator set's keys: signing for such a set in tests
# and in chip_smoke.py would otherwise derive each public key again
@_functools.lru_cache(maxsize=16384)
def _expand_seed(seed: bytes) -> tuple[int, bytes, bytes]:
    """Seed -> (clamped scalar a, prefix, pub) per RFC 8032 §5.1.5."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:], _encode_point(_mult_base(a))


def public_from_seed(seed: bytes) -> bytes:
    return _expand_seed(seed)[2]


def sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix, pub = _expand_seed(seed)
    r = _sha512_int(prefix, msg) % L
    r_enc = _encode_point(_mult_base(r))
    h = _sha512_int(r_enc, pub, msg) % L
    s = (r + h * a) % L
    return r_enc + s.to_bytes(32, "little")


@_functools.lru_cache(maxsize=8192)
def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactorless verify: encode([S]B - [h]A) == R bytes. Memoized:
    verification is a pure function and callers re-check triples."""
    if len(sig) != 64:
        return False
    if is_small_order(pub):  # keyless-forgery screen (see is_small_order)
        return False
    a_pt = _decode_point(pub)
    if a_pt is None:
        return False
    r_enc, s_enc = sig[:32], sig[32:]
    s = int.from_bytes(s_enc, "little")
    if s >= L:  # malleability check, same as the device path's precheck
        return False
    h = _sha512_int(r_enc, pub, msg) % L
    neg_a = (P - a_pt[0], a_pt[1], a_pt[2], P - a_pt[3])
    check = _pt_add(_mult_base(s), _mult_var(h, neg_a))
    return _encode_point(check) == r_enc
