"""A model of the radix-2^26 field code of the port's CUDA kernels
(`tendermint_tpu_torch/csrc/fe25519_r26.cuh`) in Python integers.

The kernels cannot run without a card, so the arithmetic they rely on is
checked here step for step: packing 20 x 13-bit boundary limbs into 10 x
26-bit limbs, the 10 x 10 columns split into low and high halves, the
high columns carried before the x608 fold, the two carry rounds (as the
one-thread code runs them and as the ten threads of a group run them
with shuffles), the way back to the boundary form, and the canonical
form. Results are held against Python integers mod p, every
intermediate is held inside int64, and interval bounds show that the
loose range is closed under the point formulas' operands (sums and
differences of up to four loose values).
"""

from __future__ import annotations

import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

P = 2**255 - 19
NL = 10
RADIX = 26
MASK = (1 << RADIX) - 1
FOLD = 608
I64 = 1 << 63
I32 = 1 << 31
# the loose range the header states for a product's output
LOOSE0 = (-(2**22.6), 2**26.2)
LOOSE = (-(2**16.7), 2**26 + 2**16.7)


def value(limbs, radix=RADIX) -> int:
    return sum(int(x) << (radix * i) for i, x in enumerate(limbs))


def fits64(x: int) -> bool:
    return -I64 <= x < I64


# -- the header's operations ---------------------------------------------------


def pack13(l13):
    return [l13[2 * i] + (l13[2 * i + 1] << 13) for i in range(NL)]


def columns(a, b):
    """lo[k] = column k, hi[k] = column k + 10 (hi[9] = 0)."""
    lo, hi = [0] * NL, [0] * NL
    for i in range(NL):
        for j in range(NL):
            if i + j < NL:
                lo[i + j] += a[i] * b[j]
            else:
                hi[i + j - NL] += a[i] * b[j]
    return lo, hi


def group_columns(a, b):
    """Thread k of a group: ten products a[i] * b[(k - i) mod 10],
    i <= k into lo, i > k into hi, by masking the factor a[i]; even and
    odd i in separate sums (each inside int64), added at the end."""
    lo, hi = [0] * NL, [0] * NL
    for k in range(NL):
        parts = [[0, 0], [0, 0]]  # [lo, hi][i & 1]
        for i in range(NL):
            a_lo = a[i] if i <= k else 0
            parts[0][i & 1] += a_lo * b[(k - i) % NL]
            parts[1][i & 1] += (a[i] - a_lo) * b[(k - i) % NL]
            assert all(fits64(x) for row in parts for x in row)
        lo[k], hi[k] = sum(parts[0]), sum(parts[1])
    return lo, hi


def take(x, k):
    return FOLD * x if k == 0 else x


def carry(lo, hi, check=None):
    """The two carry rounds: from_below(v)[k] is v[k - 1] (v[9] for
    k = 0), a shuffle in the group, an index in one thread."""
    t = [lo[k] + FOLD * (hi[k] & MASK) for k in range(NL)]
    s = [(t[k] >> RADIX) + FOLD * (hi[k] >> RADIX) for k in range(NL)]
    u = [(t[k] & MASK) + take(s[k - 1], k) for k in range(NL)]
    out = [(u[k] & MASK) + take(u[k - 1] >> RADIX, k) for k in range(NL)]
    if check is not None:
        check.extend(t + s + u + [take(x, 0) for x in s] + lo + hi)
    return out


def fe_mul(a, b, check=None):
    lo, hi = columns(a, b)
    return carry(lo, hi, check)


def gmul(a, b, check=None):
    lo, hi = group_columns(a, b)
    return carry(lo, hi, check)


def to_boundary(v):
    """radix 2^26 -> 20 x 13 limbs, two sequential passes with the fold."""
    c = []
    for x in v:
        c += [x & 8191, x >> 13]
    for _ in range(2):
        cy = 0
        for i in range(2 * NL):
            x = c[i] + cy
            cy = x >> 13
            c[i] = x & 8191
        c[0] += FOLD * cy
    return c


def carry_seq(v):
    cy = 0
    for i in range(NL):
        x = v[i] + cy
        cy = x >> RADIX
        v[i] = x & MASK
    v[0] += FOLD * cy


def canon(v):
    v = list(v)
    carry_seq(v)
    carry_seq(v)
    v[0] += MASK + 1 - 304
    for i in range(1, NL - 1):
        v[i] += MASK
    v[NL - 1] += (1 << 25) - 1
    for _ in range(3):
        carry_seq(v)
        top = v[NL - 1] >> 21
        v[NL - 1] &= (1 << 21) - 1
        v[0] += 19 * top
    carry_seq(v)
    ge = v[0] >= MASK + 1 - 19 and v[NL - 1] == (1 << 21) - 1 and all(
        v[i] == MASK for i in range(1, NL - 1)
    )
    if ge:
        v = [v[0] - (MASK + 1 - 19)] + [0] * (NL - 1)
    return v


# -- interval bounds -------------------------------------------------------------


def out_intervals(m):
    """Output intervals of a product whose operands have |limb k| <= m[k],
    and the largest magnitude of any intermediate."""
    cl, ch = [0] * NL, [0] * NL
    for i in range(NL):
        for j in range(NL):
            if i + j < NL:
                cl[i + j] += m[i] * m[j]
            else:
                ch[i + j - NL] += m[i] * m[j]
    worst = max(cl + ch)
    t = [(-cl[k], cl[k] + FOLD * MASK) for k in range(NL)]
    s = [
        ((t[k][0] >> RADIX) - FOLD * (-(-ch[k] >> RADIX)), (t[k][1] >> RADIX) + FOLD * (ch[k] >> RADIX))
        for k in range(NL)
    ]
    u = []
    for k in range(NL):
        lo_s, hi_s = s[k - 1]
        lo_s, hi_s = (FOLD * lo_s, FOLD * hi_s) if k == 0 else (lo_s, hi_s)
        u.append((lo_s, MASK + hi_s))
    out = []
    for k in range(NL):
        lo_c, hi_c = u[k - 1][0] >> RADIX, u[k - 1][1] >> RADIX
        lo_c, hi_c = (FOLD * lo_c, FOLD * hi_c) if k == 0 else (lo_c, hi_c)
        out.append((lo_c, MASK + hi_c))
    for lo_, hi_ in t + s + u:
        worst = max(worst, abs(lo_), abs(hi_))
    return out, worst


def loose_fixed_point():
    """Start from canonical limbs; operands are sums of up to four
    values of the current range; iterate until the range is closed."""
    iv = [(0, MASK)] * NL
    for _ in range(8):
        m = [4 * max(abs(lo), abs(hi)) for lo, hi in iv]
        new, worst = out_intervals(m)
        new = [(min(a[0], b[0]), max(a[1], b[1])) for a, b in zip(iv, new)]
        if new == iv:
            return iv, m, worst
        iv = new
    raise AssertionError("the loose range did not close")


def test_loose_range_is_closed_and_every_intermediate_fits_int64():
    iv, m, worst = loose_fixed_point()
    assert worst < 2**59.4  # three bits of room below int64's limit
    assert all(x < 2**28.2 for x in m) and 2**28.2 < I32  # operands fit the kernels' int32 limbs
    assert LOOSE0[0] <= iv[0][0] and iv[0][1] <= LOOSE0[1]
    for lo, hi in iv[1:]:
        assert LOOSE[0] <= lo and hi <= LOOSE[1]


# -- worst-case and random inputs -----------------------------------------------

LOOSE_INT = [(int(LOOSE0[0]) + 1, int(LOOSE0[1]))] + [(int(LOOSE[0]) + 1, int(LOOSE[1]))] * (NL - 1)


def _operand(rng: random.Random, terms: int):
    """A sum or difference of `terms` loose values, each limb near an
    end of its range."""
    out = [0] * NL
    for _ in range(terms):
        sign = rng.choice((1, -1))
        for k, (lo, hi) in enumerate(LOOSE_INT):
            out[k] += sign * rng.choice((lo, hi, rng.randint(lo, hi)))
    return out


def _check_product(a, b, fn):
    inter = []
    out = fn(a, b, inter)
    assert all(fits64(x) for x in inter)
    assert value(out) % P == value(a) * value(b) % P
    for k, x in enumerate(out):
        lo, hi = LOOSE0 if k == 0 else LOOSE
        assert lo < x < hi
    return out


@pytest.mark.parametrize("terms", [1, 2, 3, 4])
def test_worst_case_operands(terms):
    rng = random.Random(260 + terms)
    ends = [[hi for _, hi in LOOSE_INT], [lo for lo, _ in LOOSE_INT]]
    cases = [([terms * x for x in e1], [terms * x for x in e2]) for e1 in ends for e2 in ends]
    cases += [(_operand(rng, terms), _operand(rng, terms)) for _ in range(200)]
    for a, b in cases:
        one = _check_product(a, b, fe_mul)
        assert _check_product(a, b, gmul) == one  # the group computes the same limbs


@settings(max_examples=300, deadline=None)
@given(
    st.lists(st.integers(-(2**30), 2**30), min_size=NL, max_size=NL),
    st.lists(st.integers(-(2**28), 2**28), min_size=NL, max_size=NL),
)
def test_random_operands(a, b):
    a[0] = max(min(a[0], 2**30), -(2**30))
    inter = []
    out = fe_mul(a, b, inter)
    assert all(fits64(x) for x in inter)
    assert value(out) % P == value(a) * value(b) % P
    assert gmul(a, b) == out


@settings(max_examples=200, deadline=None)
@given(st.integers(0, P - 1), st.integers(0, P - 1))
def test_boundary_round_trip(x, y):
    """Canonical 13-bit limbs pack to exact 26-bit limbs; a product goes
    back to the boundary range the torch finish multiplies as it is."""
    l13 = [(x >> (13 * i)) & 8191 for i in range(20)]
    a = pack13(l13)
    assert a == [(x >> (26 * i)) & MASK for i in range(NL)]
    b = pack13([(y >> (13 * i)) & 8191 for i in range(20)])
    out = to_boundary(fe_mul(a, b))
    assert value(out, 13) % P == x * y % P
    assert -608 <= out[0] < 8192 + 608
    assert all(0 <= v < 8192 for v in out[1:])


@pytest.mark.parametrize(
    "x", [0, 1, 19, P - 1, P, P + 1, 2**255 - 1, 2**255, 2**260 - 1, -1, -608, 2 * P, 16 * P - 1]
)
def test_canon_edges(x):
    limbs = [(x >> (26 * i)) & MASK for i in range(NL)]
    if x < 0:  # a small negative value as a negative limb 0
        limbs = [x] + [0] * (NL - 1)
    got = canon(limbs)
    assert all(0 <= v <= MASK for v in got)
    assert value(got) == x % P


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 2**100), st.integers(0, 2**100))
def test_canon_of_loose_products(x, y):
    rng = random.Random(x ^ y)
    a, b = _operand(rng, 2), _operand(rng, 3)
    got = canon(fe_mul(a, b))
    assert value(got) == value(a) * value(b) % P


# -- the finish (`csrc/finish.cu`): load, block tree, invert, canonical form, encode


def load_fe(l13):
    """20 boundary limbs (any int32 values) -> loose radix-2^26 limbs:
    packed in int64, then two sequential carry passes."""
    v = [l13[2 * i] + (l13[2 * i + 1] << 13) for i in range(NL)]
    assert all(fits64(x) for x in v)
    carry_seq(v)
    carry_seq(v)
    return v


def sq_n(x, n, check):
    for _ in range(n):
        x = gmul(x, x, check)
    return x


def invert(z, check):
    """z^(p - 2) with the chain of `ginvert` (group form): 254 squarings,
    11 multiplies."""
    z2 = gmul(z, z, check)
    z9 = gmul(sq_n(z2, 2, check), z, check)
    z11 = gmul(z9, z2, check)
    z5 = gmul(gmul(z11, z11, check), z9, check)
    z10 = gmul(sq_n(z5, 5, check), z5, check)
    z20 = gmul(sq_n(z10, 10, check), z10, check)
    z40 = gmul(sq_n(z20, 20, check), z20, check)
    z50 = gmul(sq_n(z40, 10, check), z10, check)
    z100 = gmul(sq_n(z50, 50, check), z50, check)
    z200 = gmul(sq_n(z100, 100, check), z100, check)
    z250 = gmul(sq_n(z200, 50, check), z50, check)
    return gmul(sq_n(z250, 5, check), z11, check)


def byte_of(v, j):
    """Byte j of a canonical element, as the kernel cuts it."""
    bit = 8 * j
    i, off = divmod(bit, RADIX)
    b = v[i] >> off
    if off > RADIX - 8 and i + 1 < NL:
        b |= v[i + 1] << (RADIX - off)
    return b & 0xFF


def finish(lanes, per_block=32):
    """The kernel's verdicts for one call: `lanes` a list of (x13, y13,
    z13, r), r a 32-byte string. Per block of `per_block` lanes: the
    loaded Z values (a Z of 0 mod p, and the lanes past the last, as 1)
    multiplied up a heap (node i = node 2i * node 2i + 1), the root
    inverted once, 1/child = 1/parent * sibling back down, then each
    lane's x, y times its 1/Z, canonical form, encoding and comparison;
    every lane false when a Z was 0. Every intermediate is held in
    int64."""
    inter = []
    one = [1] + [0] * (NL - 1)
    verdicts, saw_zero = [], False
    for b0 in range(0, len(lanes), per_block):
        block = lanes[b0 : b0 + per_block]
        prod = [None] * per_block + [load_fe(z13) for _x, _y, z13, _r in block]
        for i in range(per_block, per_block + len(block)):
            if not any(canon(prod[i])):
                saw_zero = True
                prod[i] = one
        prod += [one] * (2 * per_block - len(prod))
        for i in range(per_block - 1, 0, -1):
            prod[i] = fe_mul(prod[2 * i], prod[2 * i + 1], inter)
        inv = [None, invert(prod[1], inter)]
        for c in range(2, 2 * per_block):
            inv.append(fe_mul(inv[c >> 1], prod[c ^ 1], inter))
        for t, (x13, y13, _z13, r) in enumerate(block):
            zinv = inv[per_block + t]
            xc = canon(fe_mul(load_fe(x13), zinv, inter))
            yc = canon(fe_mul(load_fe(y13), zinv, inter))
            same = all(r[j] == byte_of(yc, j) for j in range(31))
            verdicts.append(same and (r[31] & 0x7F) == byte_of(yc, 31) and (r[31] >> 7) & 1 == xc[0] & 1)
    assert all(fits64(x) for x in inter)
    return [v and not saw_zero for v in verdicts]


def limbs13(x):
    return [(x >> (13 * i)) & 8191 for i in range(20)]


@pytest.mark.parametrize(
    "z", [1, 2, 19, P - 1, P - 2, 2**255 - 20, 2**254, 121665, 3**100 % P] + [
        random.Random(7 + i).randrange(1, P) for i in range(6)
    ]
)
def test_inversion_chain(z):
    inter = []
    got = invert(load_fe(limbs13(z)), inter)
    assert all(fits64(x) for x in inter)
    assert value(canon(got)) == pow(z, P - 2, P)


def _loose_variants(x):
    """x < 2^260 as 13-bit limbs, canonical and with a borrow that puts
    limb 0 above 2^13 (the finish takes any int32 limbs)."""
    out = [limbs13(x)]
    for i in range(1, 20):
        if out[0][i]:
            v = list(out[0])
            v[i] -= 1
            v[i - 1] += 8192
            out.append(v)
            break
    return out


@pytest.mark.parametrize(
    "x", [0, 1, P - 1, P, P + 1, 2**255 - 1, 2**255, 2 * P + 5, 2**260 - 1],
    ids=["0", "1", "p-1", "p", "p+1", "2^255-1", "2^255", "2p+5", "2^260-1"],
)
def test_canonical_form_and_encoding(x):
    """canon + byte_of give `fe_to_bytes`'s bytes and x's parity."""
    from tendermint_tpu_torch.ops.ed25519_kernel import fe_to_bytes
    import torch

    want = (x % P).to_bytes(32, "little")
    for l13 in _loose_variants(x):
        c = canon(load_fe(l13))
        assert value(c) == x % P and all(0 <= v <= MASK for v in c)
        assert bytes(byte_of(c, j) for j in range(32)) == want
        assert c[0] & 1 == (x % P) & 1
    if x < 2**260 - 8192:  # the torch code takes its loose range
        got = fe_to_bytes(torch.tensor([limbs13(x)], dtype=torch.int32))
        assert bytes(got[0].tolist()) == want


@settings(max_examples=100, deadline=None)
@given(st.lists(st.booleans(), min_size=20, max_size=20))
def test_boundary_extremes_load(ends):
    """Chain outputs at the ends of the boundary range: limb 0 at -608 or
    2^13 + 607, limbs 1..19 at 0 or 2^13 - 1."""
    l13 = [(8192 + 607 if ends[0] else -608)] + [8191 if e else 0 for e in ends[1:]]
    x = sum(v << (13 * i) for i, v in enumerate(l13))
    v = load_fe(l13)
    assert v[0] >= -608 and v[0] < 2**26 + 608 and all(0 <= t <= MASK for t in v[1:])
    c = canon(v)
    assert value(c) == x % P
    assert bytes(byte_of(c, j) for j in range(32)) == (x % P).to_bytes(32, "little")


def test_finish_verdicts_on_hand_made_lanes():
    """The model's verdicts on `finish_edge_lanes` (sign bit set and
    cleared, flipped, y >= p, the identity, the order-4 point), alone and
    spread over three blocks of 32 among lanes of those points again;
    and with a Z = 0 lane in the call, false on every lane whatever R is."""
    from tendermint_tpu_torch.testing import finish_edge_lanes

    x, y, z, r, want = finish_edge_lanes()
    rows = [([int(v) for v in x[i]], [int(v) for v in y[i]], [int(v) for v in z[i]], bytes(r[i])) for i in range(len(want))]
    assert finish(rows) == list(want)
    spread = (rows * 8)[:70]
    assert finish(spread) == (list(want) * 8)[:70]
    zero = [0] * 20
    assert finish([(zero, zero, zero, bytes(32))]) == [False]
    assert finish([(zero, limbs13(1), zero, (1).to_bytes(32, "little"))]) == [False]
    with_zero = list(spread)
    with_zero[40] = (zero, zero, zero, bytes(32))  # R = 0: the JAX tree's verdict there is true
    assert finish(with_zero) == [False] * 70
