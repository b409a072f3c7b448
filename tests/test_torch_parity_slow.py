"""The port's plain torch path against the JAX package's compiled
kernels: `verify_tables_kernel` (impl="xla", and impl="fused", which
runs the Pallas kernel interpreted on the CPU), the port's flat ladder
against the jitted `verify_kernel`, the Pallas ladder kernel
interpreted (with stand-in point formulas), and the hash plane's jitted
batch hashes and device trees against the port's plain versions.

These compile XLA:CPU programs (and interpret Pallas) for many minutes,
so they are marked `kernel` and `slow` and stay out of tier-1. Run with:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parity_slow.py -m 'kernel and slow'
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.crypto.keys import gen_priv_key
from tendermint_tpu.ops import ed25519_kernel as J
from tendermint_tpu.ops import ed25519_ladder_pallas as JL
from tendermint_tpu.ops import ed25519_tables as JT
from tendermint_tpu_torch.ops import ed25519_ladder as TL
from tendermint_tpu_torch.ops import ed25519_tables as TT

pytestmark = [pytest.mark.kernel, pytest.mark.slow]

BAD_KEY = b"\xff" * 31 + b"\x7f"


def _privs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [gen_priv_key(rng.bytes(32)) for _ in range(n)]


@pytest.fixture(scope="module")
def stacked():
    """128 validators x 8 commits: the smallest shape the fused Pallas
    kernel tiles (N % 128 == 0, K % 8 == 0)."""
    privs = _privs(128, seed=61)
    pubs = [p.pub_key.data for p in privs]
    pubs[5] = BAD_KEY
    commits = []
    for k in range(8):
        msgs = [b"h%d-v%d" % (k, i) for i in range(128)]
        sigs = [p.sign(m) for p, m in zip(privs, msgs)]
        commits.append((msgs, sigs))
    commits[0][1][1] = bytes([commits[0][1][1][0] ^ 1]) + commits[0][1][1][1:]
    commits[1][0][2] = commits[1][1][2] = None
    s, h, r, pre = TT.prepare_commit_lanes(pubs, commits)
    tables, ok = JT.host_build_key_tables(pubs)
    return tables, ok, s, h, r, pre


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_verify_tables_kernel(stacked, impl):
    tables, ok, s, h, r, pre = stacked
    want = np.asarray(
        JT.verify_tables_kernel(jnp.asarray(tables), jnp.asarray(s), jnp.asarray(h), jnp.asarray(r), impl=impl)
    )
    port_t, _ = TT.tables_from_jax(tables, ok, device="cpu")
    lanes = [torch.from_numpy(a) for a in (s, h, r)]
    for port_impl in ("entries", "fused"):
        got = TT.verify_tables_kernel(port_t, *lanes, impl=port_impl).numpy()
        np.testing.assert_array_equal(got, want)
    mask = want & pre & np.tile(ok, 8)
    assert not mask[1] and not mask[128 + 2] and not mask[5] and mask.sum() == 8 * 127 - 2


@pytest.fixture(scope="module")
def flat():
    privs = _privs(8, seed=62)
    triples = []
    for i, p in enumerate(privs):
        m = b"flat-%d" % i
        triples.append((p.pub_key.data, m, p.sign(m)))
    pk, m, s = triples[1]
    triples[1] = (pk, m, bytes([s[0] ^ 1]) + s[1:])
    triples[2] = (BAD_KEY, triples[2][1], triples[2][2])
    # the all-zero key's keyless signature (R = identity, S = 0)
    sig = b"\x01" + b"\x00" * 63
    for i in range(64):
        msg = b"keyless-%d" % i
        hh = int.from_bytes(hashlib.sha512(sig[:32] + b"\x00" * 32 + msg).digest(), "little") % J.L
        if hh % 4 == 0:
            triples[3] = (b"\x00" * 32, msg, sig)
            break
    pubs, msgs, sigs = zip(*triples)
    return J.prepare_batch(pubs, msgs, sigs)


def test_verify_kernel(flat):
    """The port's flat path (`verify_kernel_ladder`, plain on the CPU)
    against the JAX package's jitted `verify_kernel`."""
    pub, r, s, h, _pre = flat
    want = np.asarray(J.verify_kernel(*(jnp.asarray(a) for a in (pub, r, s, h))))
    got = TL.verify_kernel_ladder(*(torch.from_numpy(a) for a in (pub, r, s, h))).numpy()
    np.testing.assert_array_equal(got, want)
    # like the JAX device kernel, the plain lane accepts the zero key
    assert list(want) == [True, False, False, True, True, True, True, True]


TOY_STEPS = 6


def _cheap_double_planes(acc):
    return tuple([2 * p for p in coord] for coord in acc)


def _cheap_madd_planes(acc, ypx, ymx, t2d):
    x, y, z, t = acc
    return (
        [a + e for a, e in zip(x, ypx)],
        [a + e for a, e in zip(y, ymx)],
        [a + e for a, e in zip(z, t2d)],
        [a + e1 - e2 for a, e1, e2 in zip(t, ypx, ymx)],
    )


def _cheap_double(p):
    return tuple(2 * c for c in p)


def _cheap_madd(acc, entry):
    (x, y, z, t), (ypx, ymx, t2d) = acc, entry
    return (x + ypx, y + ymx, z + t2d, t + ypx - ymx)


@pytest.mark.parametrize("lanes", [8, 16], ids=["one_tile", "two_tiles"])
def test_ladder_pallas_interpret_matches_plain_ladder(monkeypatch, lanes):
    """The Pallas ladder kernel (`_ladder_pallas`, interpreted) against
    the port's plain ladder on the same per-lane tables and digits: the
    step-0 identity reset, the msb-first step order, the digit select,
    double-then-add, the last-step write and the lane layout.

    With the real field math the interpreted kernel does not finish
    compiling on the CPU within a quarter of an hour, even for a
    3-step ladder. So, as `tests/test_ladder_pallas_interpret.py` does,
    both sides swap the point formulas for the same cheap invertible
    arithmetic and run TOY_STEPS steps on one or two (8, 1)-plane tiles.
    The formulas themselves are held limb for limb against the kernel
    body's `_double_planes` and `_madd_planes` in
    `tests/test_torch_field.py::TestPlaneMath`, and full-length verdicts
    against the jitted `verify_kernel` above."""
    monkeypatch.setattr(JL, "SCALAR_BITS", TOY_STEPS)
    monkeypatch.setattr(JL, "_double_planes", _cheap_double_planes)
    monkeypatch.setattr(JL, "_madd_planes", _cheap_madd_planes)
    monkeypatch.setattr(TL, "SCALAR_BITS", TOY_STEPS)
    monkeypatch.setattr(TL, "pt_double", _cheap_double)
    monkeypatch.setattr(TL, "pt_madd", _cheap_madd)
    rng = np.random.default_rng(64 + lanes)
    gtab = rng.integers(0, 1 << 8, size=(4, lanes, 60), dtype=np.int32)
    dig = rng.integers(0, 4, size=(lanes, TOY_STEPS), dtype=np.int32)
    tiles = lanes // 8
    # (4, B, 60) -> (tiles, 4, 60, 8, w); (B, steps) -> (tiles, steps, 8, w)
    jg = np.transpose(gtab.reshape(4, tiles, 8, 1, 60), (1, 0, 4, 2, 3))
    jd = np.transpose(dig.reshape(tiles, 8, 1, TOY_STEPS), (0, 3, 1, 2))
    want = JL._ladder_pallas(jnp.asarray(jg), jnp.asarray(jd), 1, interpret=True)
    got = TL._ladder_plain(torch.from_numpy(gtab), torch.from_numpy(dig))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the hash plane: jitted JAX hashes and trees against the plain versions


def _hash_msgs(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in (0, 1, 55, 56, 64, 111, 112, 128, 250, 305, 700)]


@pytest.mark.parametrize("name", ["sha256", "ripemd160", "sha512"])
def test_batch_hash_words_match_jax(name):
    from tendermint_tpu.ops import padding as JP
    from tendermint_tpu.ops.ripemd160_kernel import ripemd160_batch_jax
    from tendermint_tpu.ops.sha256_kernel import sha256_batch_jax
    from tendermint_tpu.ops.sha512_kernel import sha512_batch_jax
    from tendermint_tpu_torch.ops import ripemd160_kernel as TR
    from tendermint_tpu_torch.ops import sha256_kernel as T256
    from tendermint_tpu_torch.ops import sha512_kernel as T512

    pad, jax_fn, port_fn = {
        "sha256": (JP.pad_sha256, sha256_batch_jax, T256.sha256_batch),
        "ripemd160": (JP.pad_ripemd160, ripemd160_batch_jax, TR.ripemd160_batch),
        "sha512": (JP.pad_sha512, sha512_batch_jax, T512.sha512_batch),
    }[name]
    blocks, n = pad(_hash_msgs(81))
    n[0] = 0  # a pad row
    want = np.asarray(jax_fn(blocks, n))
    got = T256.to_u32(port_fn(blocks, n, "cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algo", ["sha256", "ripemd160"])
def test_forest_and_tree_words_match_jax(algo):
    from tendermint_tpu.ops import merkle_kernel as JM
    from tendermint_tpu_torch.ops import merkle_kernel as TM
    from tendermint_tpu_torch.ops.sha256_kernel import to_u32

    rng = np.random.default_rng(82)
    trees = [[rng.bytes(int(k)) for k in rng.integers(0, 200, n)] for n in (1, 2, 5, 8, 3)]
    assert TM.merkle_roots_forest(trees, algo, "cpu") == JM.merkle_roots_forest(trees, algo)
    items = trees[2] + trees[3]
    assert TM.leaf_hashes_device(items, algo, "cpu") == JM.leaf_hashes_device(items, algo)
    width = TM.WIDTHS[algo]
    leaves = rng.integers(0, 2**32, (13, width), dtype=np.uint64).astype(np.uint32)
    for count in (None, 9):
        want = np.asarray(JM.merkle_root_from_leaf_words(leaves, count, algo))
        got = to_u32(TM.merkle_root_from_leaf_words(leaves, count, algo, "cpu"))
        np.testing.assert_array_equal(got, want)
