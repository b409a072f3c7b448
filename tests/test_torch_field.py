"""The port's torch field and curve core against the JAX package's.

Same inputs (made from a numpy seed) go through the JAX functions,
called eagerly on the CPU, and their `tendermint_tpu_torch` counterparts
with CPU tensors. Every value is an integer, and the port repeats the
JAX limb arithmetic operation for operation, so results must agree
exactly, limb for limb.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.ops import ed25519_kernel as J
from tendermint_tpu.ops import ed25519_ladder_pallas as JL
from tendermint_tpu.ops import ed25519_tables as JT
from tendermint_tpu_torch.ops import ed25519_kernel as T
from tendermint_tpu_torch.ops import ed25519_tables as TT

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

P = T.P
EDGE_VALUES = [0, 1, 2, P - 1, P, P + 1, 2**255 - 1, 2**255 - 19 + 18]


def _loose(rng, n: int) -> np.ndarray:
    """Field elements in the loose range fe_carry produces: random
    canonical values, the edge values, and limbs that are slightly
    negative or slightly above 2^13."""
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    canon = np.stack([T._int_to_limbs(v) for v in vals + EDGE_VALUES])
    noisy = rng.integers(-600, (1 << 13) + 600, size=(n, 20), dtype=np.int32)
    return np.concatenate([canon, noisy]).astype(np.int32)


def _affine(pt):
    """Canonical affine (x, y) limbs of an extended point."""
    zinv = T.fe_invert(T.fe_carry(pt[2]))
    return T.fe_canon(T.fe_mul(pt[0], zinv)), T.fe_canon(T.fe_mul(pt[1], zinv))


def _jax(fn, *arrays):
    out = fn(*(jnp.asarray(a) for a in arrays))
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _torch(fn, *arrays):
    out = fn(*(torch.from_numpy(np.array(a)) for a in arrays))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


@pytest.fixture(scope="module")
def fe_pair():
    rng = np.random.default_rng(1)
    return _loose(rng, 24), _loose(rng, 24)


def _keys(n: int, seed: int = 5) -> list[bytes]:
    from tendermint_tpu_torch.crypto import ed25519_ref

    rng = np.random.default_rng(seed)
    return [ed25519_ref.public_from_seed(rng.bytes(32)) for _ in range(n)]


@pytest.fixture(scope="module")
def points():
    """Two batches of valid extended points (decompressed public keys)."""
    keys = np.frombuffer(b"".join(_keys(12)), dtype=np.uint8).reshape(12, 32)
    pts, ok = T.pt_decompress(torch.from_numpy(keys.copy()))
    assert bool(ok.all())
    p = tuple(c[:6].numpy() for c in pts)
    q = tuple(c[6:].numpy() for c in pts)
    return p, q


class TestLimbs:
    def test_int_limb_round_trip(self):
        rng = np.random.default_rng(2)
        for v in EDGE_VALUES + [int.from_bytes(rng.bytes(32), "little") >> 1]:
            limbs = T._int_to_limbs(v)
            np.testing.assert_array_equal(limbs, J._int_to_limbs(v))
            assert T._limbs_to_int(limbs) == J._limbs_to_int(limbs) == v

    @pytest.mark.parametrize("n", [0, 1, 8, 9, 512, 513, 4096])
    def test_bucket_size(self, n):
        assert T.bucket_size(n) == J.bucket_size(n)

    def test_scalar_bits_match_jax(self):
        rng = np.random.default_rng(4)
        b = rng.integers(0, 256, size=(8, 32), dtype=np.uint8)
        b[:, 31] &= 0x1F  # scalars are below 2^253
        np.testing.assert_array_equal(
            _torch(T._scalar_bits_from_le_bytes, b), _jax(J._scalar_bits_from_le_bytes, b)
        )

    def test_bytes_to_fe_keeps_bit_255(self):
        rng = np.random.default_rng(3)
        b = rng.integers(0, 256, size=(16, 32), dtype=np.uint8)
        b[0, 31] |= 0x80
        np.testing.assert_array_equal(_torch(T.bytes_to_fe, b), _jax(J.bytes_to_fe, b))


class TestFieldOps:
    @pytest.mark.parametrize("name", ["fe_mul", "fe_sub", "fe_add", "fe_addc"])
    def test_binary(self, fe_pair, name):
        a, b = fe_pair
        np.testing.assert_array_equal(
            _torch(getattr(T, name), a, b), _jax(getattr(J, name), a, b)
        )

    @pytest.mark.parametrize(
        "name", ["fe_carry", "fe_neg", "fe_sq", "fe_canon", "fe_to_bytes", "fe_is_zero"]
    )
    def test_unary(self, fe_pair, name):
        a, _ = fe_pair
        np.testing.assert_array_equal(_torch(getattr(T, name), a), _jax(getattr(J, name), a))

    @pytest.mark.parametrize("name", ["fe_invert", "fe_pow_p58"])
    def test_exponent_chains(self, fe_pair, name):
        a = fe_pair[0][:8]
        np.testing.assert_array_equal(_torch(getattr(T, name), a), _jax(getattr(J, name), a))

    def test_fe_eq(self, fe_pair):
        a, b = fe_pair
        # a value equals itself plus p: compare across representations
        a_plus_p = a + T._int_to_limbs(P)[None, :]
        for x, y in ((a, b), (a, a_plus_p)):
            np.testing.assert_array_equal(_torch(T.fe_eq, x, y), _jax(J.fe_eq, x, y))
        assert _torch(T.fe_eq, a, a_plus_p).all()

    def test_fe_canon_is_canonical(self, fe_pair):
        a, _ = fe_pair
        canon = _torch(T.fe_canon, a)
        for row_in, row_out in zip(a, canon):
            value = sum(int(v) << (13 * i) for i, v in enumerate(row_in)) % P
            assert T._limbs_to_int(row_out) == value

    def test_batch_invert_matches_jax(self, fe_pair):
        a, _ = fe_pair
        a = a[:13]  # not a power of two: exercises the padding
        got = _torch(TT.fe_batch_invert, _torch(T.fe_carry, a))
        want = _jax(JT.fe_batch_invert, _jax(J.fe_carry, a))
        np.testing.assert_array_equal(got, want)
        prod = _torch(T.fe_canon, _torch(T.fe_mul, got, _torch(T.fe_carry, a)))
        nonzero = _torch(T.fe_is_zero, a) == 0
        assert (prod[nonzero][:, 0] == 1).all() and (prod[nonzero][:, 1:] == 0).all()


class TestPointOps:
    @pytest.mark.parametrize("name", ["pt_add", "pt_double", "pt_neg"])
    def test_point_op(self, points, name):
        p, q = points
        args = (p, q) if name == "pt_add" else (p,)
        got = getattr(T, name)(*(tuple(torch.from_numpy(c) for c in pt) for pt in args))
        want = getattr(J, name)(*(tuple(jnp.asarray(c) for c in pt) for pt in args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_pt_madd_matches_jax(self, points):
        p, q = points
        qx, qy, qz, _ = (torch.from_numpy(c) for c in q)
        zinv = TT.fe_batch_invert(T.fe_carry(qz))
        x, y = T.fe_mul(qx, zinv), T.fe_mul(qy, zinv)
        entry = (
            T.fe_canon(T.fe_carry(y + x)),
            T.fe_canon(T.fe_sub(y, x)),
            T.fe_canon(T.fe_mul(T.fe_mul(x, y), torch.from_numpy(T._D2_L))),
        )
        got = TT.pt_madd(tuple(torch.from_numpy(c) for c in p), entry)
        want = JT.pt_madd(
            tuple(jnp.asarray(c) for c in p), tuple(jnp.asarray(e.numpy()) for e in entry)
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # and the mixed add is the unified add of the same point
        full = T.pt_add(tuple(torch.from_numpy(c) for c in p), tuple(torch.from_numpy(c) for c in q))
        for g, w in zip(_affine(got), _affine(full)):
            assert torch.equal(g, w)

    def test_identity_and_base_point(self, points):
        """Adding the identity leaves a point as it is; the base point
        is the RFC 8032 generator."""
        p, _ = points
        tp = tuple(torch.from_numpy(c) for c in p)
        summed = T.pt_add(tp, T.identity_point((len(p[0]),), "cpu"))
        for g, w in zip(_affine(summed), _affine(tp)):
            assert torch.equal(g, w)
        bx, by = (T._limbs_to_int(c[0]) for c in _affine(T.base_point((1,), "cpu")))
        assert (bx, by) == (T.BX, T.BY) and T.BY == 4 * pow(5, P - 2, P) % P


def _encodings() -> tuple[np.ndarray, list[str]]:
    """Point encodings covering every branch of decompression."""
    encs, names = [], []
    for k in _keys(3, seed=9):
        encs.append(k)
        names.append("valid")
    ident = b"\x01" + b"\x00" * 31
    encs += [
        ident,  # identity: x = 0, sign 0
        b"\x01" + b"\x00" * 30 + b"\x80",  # identity with the sign bit: x = 0, sign 1
        b"\x00" * 32,  # y = 0: a point of order 4
        (P + 1).to_bytes(32, "little"),  # non-canonical y = p + 1
        (2**255 - 1).to_bytes(32, "little"),  # y >= p
        (2).to_bytes(32, "little"),  # y = 2: x^2 is not a square
        b"\xff" * 32,  # all ones: non-canonical, sign 1
    ]
    names += ["identity", "sign_of_zero", "order4", "noncanon", "y_ge_p", "off_curve", "ones"]
    return np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 32), names


def test_pt_decompress_matches_jax():
    encs, names = _encodings()
    got_pt, got_ok = T.pt_decompress(torch.from_numpy(encs.copy()))
    want_pt, want_ok = J.pt_decompress(jnp.asarray(encs))
    got_ok = got_ok.numpy()
    np.testing.assert_array_equal(got_ok, np.asarray(want_ok))
    for g, w in zip(got_pt, want_pt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    expect_ok = {"valid": True, "identity": True, "order4": True}
    for name, ok in zip(names, got_ok):
        assert bool(ok) == expect_ok.get(name, False), name


class TestPlaneMath:
    """The port's chain step against the Pallas bodies' plane math
    (`_mul_planes`, `_madd_planes`, `_double_planes`), called eagerly on
    (n,)-shaped planes: the hand kernels implement the same step."""

    @staticmethod
    def _planes(a):
        return [jnp.asarray(a[:, i]) for i in range(20)]

    @staticmethod
    def _unplane(planes):
        return np.stack([np.asarray(p) for p in planes], axis=-1)

    def test_mul_planes(self, fe_pair):
        a, b = fe_pair
        want = self._unplane(JT._mul_planes(self._planes(a), self._planes(b)))
        np.testing.assert_array_equal(_torch(T.fe_mul, a, b), want)

    def test_madd_planes(self, points):
        p, q = points
        entry = tuple(np.asarray(c) for c in (q[1], q[0], q[2]))  # any canonical-size limbs
        entry = tuple(_torch(T.fe_canon, e) for e in entry)
        want = JT._madd_planes(
            tuple(self._planes(c) for c in p), *(self._planes(e) for e in entry)
        )
        got = TT.pt_madd(
            tuple(torch.from_numpy(c) for c in p), tuple(torch.from_numpy(e) for e in entry)
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), self._unplane(w))

    def test_double_planes(self, points):
        p, _ = points
        want = JL._double_planes(tuple(self._planes(c) for c in p))
        got = T.pt_double(tuple(torch.from_numpy(c) for c in p))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), self._unplane(w))
