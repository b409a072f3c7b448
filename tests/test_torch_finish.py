"""The encode-and-compare finish: its block algorithm and its Z = 0 rule,
against the JAX package.

The `finish_encode_compare` kernel (`csrc/finish.cu`) inverts with one
product tree a block of `finish_lanes_per_block` lanes, a Z that is 0
mod p replaced by 1, and makes a call with such a lane false on every
lane. `_block_inverses` below models that algorithm in torch (same lanes
a block, same heap order, same substitution) and is held against the
per-lane `fe_invert` and the JAX `fe_batch_invert`. The Z = 0 rule is
held against the JAX `_finish_encode_compare` on a mixed batch, beside a
model of the kernel before the rule, which inverted each lane on its own
and so kept a real verdict on every lane with Z != 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519_tables as JT
from tendermint_tpu_torch.ops import ed25519_kernel as T
from tendermint_tpu_torch.ops import ed25519_tables as TT
from tendermint_tpu_torch.testing import MIXED_ZERO_LANE, finish_mixed_lanes

torch.set_num_threads(1)

P = T.P
H100_SMS = 132


def _one(n):
    one = torch.zeros((n, T.NLIMBS), dtype=torch.int32)
    one[:, 0] = 1
    return one


def _block_inverses(z, lanes):
    """The kernel's inversion on (B, 20) boundary limbs: per block of
    `lanes` lanes a heap (node i = node 2i * node 2i + 1, leaves at
    lanes + t, padded with 1), a zero Z replaced by 1, one `fe_invert` of
    the root, then 1/child = 1/parent * sibling back down. Returns the
    (B, 20) inverses and whether a Z was 0."""
    bsz = z.shape[0]
    blocks = -(-bsz // lanes)
    zero = T.fe_is_zero(z)
    leaves = torch.where(zero[:, None], _one(bsz), T.fe_carry(z))
    leaves = torch.cat([leaves, _one(blocks * lanes - bsz)]).view(blocks, lanes, T.NLIMBS)
    prod = torch.zeros((blocks, 2 * lanes, T.NLIMBS), dtype=torch.int32)
    prod[:, lanes:] = leaves
    n = lanes // 2
    while n >= 1:
        prod[:, n : 2 * n] = T.fe_mul(prod[:, 2 * n : 4 * n : 2], prod[:, 2 * n + 1 : 4 * n : 2])
        n //= 2
    inv = torch.zeros_like(prod)
    inv[:, 1] = T.fe_invert(prod[:, 1])
    n = 1
    while n < lanes:
        parents = inv[:, n : 2 * n].repeat_interleave(2, dim=1)
        siblings = prod[:, 2 * n : 4 * n].reshape(blocks, n, 2, T.NLIMBS).flip(2).reshape(blocks, 2 * n, T.NLIMBS)
        inv[:, 2 * n : 4 * n] = T.fe_mul(parents, siblings)
        n *= 2
    return inv[:, lanes:].reshape(-1, T.NLIMBS)[:bsz], bool(zero.any())


def _verdicts(x, y, zinv, r):
    """encode(x * zinv, y * zinv) == r, lane by lane (r int32 bytes)."""
    x_aff = T.fe_canon(T.fe_mul(x, zinv))
    y_bytes = T.fe_to_bytes(T.fe_mul(y, zinv))
    r_clean = r.clone()
    r_clean[:, 31] &= 0x7F
    return torch.all(y_bytes == r_clean, dim=-1) & ((x_aff[:, 0] & 1) == ((r[:, 31] >> 7) & 1))


def _kernel_model(x, y, z, r):
    """The redesigned kernel: block inverses at the card's lanes a block,
    then false on every lane when any Z was 0."""
    zinv, saw_zero = _block_inverses(z, TT.finish_lanes_per_block(z.shape[0], H100_SMS))
    return _verdicts(x, y, zinv, r) & (not saw_zero)


def _per_lane_model(x, y, z, r):
    """The kernel before the rule: each lane's own Z^(p-2) (0 for Z = 0),
    and a lane false only where its own Z was 0."""
    return _verdicts(x, y, T.fe_invert(T.fe_carry(z)), r) & ~T.fe_is_zero(z)


def _random_fe(rng, n):
    """n canonical nonzero field elements as 13-bit limbs."""
    vals = [int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1 for _ in range(n)]
    return torch.from_numpy(np.stack([T._int_to_limbs(v) for v in vals]))


# the JAX batch tree's canonical inverses and the JAX finish's verdicts,
# compiled once (every call here has the mixed batch's shape)
_jax_tree_and_finish = jax.jit(
    lambda x, y, z, r: (JT.fe_canon(JT.fe_batch_invert(JT.fe_carry(z))), JT._finish_encode_compare(x, y, z, r))
)


def _jax(x, y, z, r):
    """(inverses, verdicts) of the JAX package on torch inputs."""
    inv, ok = _jax_tree_and_finish(*(jnp.asarray(c.numpy()) for c in (x, y, z, r.int())))
    return np.asarray(inv), np.asarray(ok)


@pytest.mark.parametrize(
    "bsz,sms,lanes",
    [(16000, 132, 64), (10000, 132, 64), (4096, 132, 32), (1, 132, 32), (100000, 132, 256), (5000, 16, 256)],
)
def test_lanes_per_block(bsz, sms, lanes):
    """The largest power of two in [32, 256] that leaves no SM without a
    block, else 32: the window's 16k lanes and the commit's 10k take 64,
    the flat bucket's 4,096 take 32."""
    assert TT.finish_lanes_per_block(bsz, sms) == lanes


@pytest.fixture(scope="module")
def random_z():
    """300 random Z (a partial last block at every lanes a block) and
    their inverses by the per-lane `fe_invert`, canonical."""
    z = _random_fe(np.random.default_rng(100), 300)
    return z, T.fe_canon(T.fe_invert(z))


@pytest.mark.parametrize("lanes", [32, 64, 128, 256])
@pytest.mark.parametrize("bsz", [1, 77, 300])
def test_block_model_inverts_like_fe_invert(random_z, bsz, lanes):
    """On random Z the block algorithm gives every lane the inverse that
    the per-lane `fe_invert` gives it."""
    z, want = random_z
    got, saw_zero = _block_inverses(z[:bsz], lanes)
    assert not saw_zero
    assert torch.equal(T.fe_canon(got), want[:bsz])
    assert torch.equal(T.fe_canon(T.fe_mul(got, z[:bsz])), _one(bsz))


def test_block_model_substitutes_one_for_a_zero_z():
    """A zero Z becomes 1 in its block: the other lanes of that block and
    of the next keep their inverses, the zero lane gets 1."""
    rng = np.random.default_rng(7)
    z = _random_fe(rng, 70)
    z[40] = 0
    z[41] = torch.from_numpy(T._int_to_limbs(P))  # p itself is 0 mod p
    got, saw_zero = _block_inverses(z, 32)
    assert saw_zero
    keep = torch.ones(70, dtype=torch.bool)
    keep[40:42] = False
    assert torch.equal(T.fe_canon(got[keep]), T.fe_canon(T.fe_invert(z[keep])))
    assert torch.equal(T.fe_canon(got[40:42]), _one(2))


@pytest.fixture(scope="module")
def mixed():
    """`finish_mixed_lanes` as torch tensors: lane 40 (block 1 of three
    of 32) has Z = 0 and R = 0."""
    return tuple(torch.from_numpy(a) for a in finish_mixed_lanes())


def test_block_model_inverts_like_the_jax_tree(mixed):
    """The block model at the card's lanes a block against the JAX batch
    tree `fe_batch_invert`, on the mixed batch's Z with lane 40 given a Z
    (the JAX tree pads the whole batch to 128 lanes, the model each block
    to 32)."""
    x, y, z, r, _want = mixed
    z = z.clone()
    z[MIXED_ZERO_LANE] = torch.from_numpy(T._int_to_limbs(5))
    lanes = TT.finish_lanes_per_block(z.shape[0], H100_SMS)
    assert lanes == 32
    got, saw_zero = _block_inverses(z, lanes)
    assert not saw_zero
    np.testing.assert_array_equal(T.fe_canon(got).numpy(), _jax(x, y, z, r)[0])


def test_mixed_zero_z_batch_against_jax(mixed):
    """With a Z = 0 lane in the batch the JAX tree inverts every lane to
    0: every lane compares encode(0, 0) with its R, so only the lanes
    whose R is 32 zero bytes are true. The kernel before the rule kept a
    real verdict on every lane with Z != 0; the port, now on every
    device, is false on every lane: it agrees with JAX except at the
    R = 0 lanes."""
    x, y, z, r, want = mixed
    jax_v = _jax(x, y, z, r)[1]
    zero_r = (r == 0).all(dim=1).numpy()  # lane 40 and the edge lane (sqrt(-1), 0)
    assert zero_r.sum() == 2
    np.testing.assert_array_equal(jax_v, zero_r)

    old = _per_lane_model(x, y, z, r.int()).numpy()
    want_old = want.numpy().copy()
    want_old[MIXED_ZERO_LANE] = False
    np.testing.assert_array_equal(old, want_old)
    assert (old & ~jax_v).sum() == want_old.sum() - 1  # looser than JAX on every true lane but one

    port = TT.finish_encode_compare(x, y, z, r).numpy()
    assert not port.any()
    np.testing.assert_array_equal(port != jax_v, zero_r)
    assert not TT._finish_encode_compare(x, y, z, r.int()).any()
    assert not _kernel_model(x, y, z, r.int()).any()


def test_mixed_batch_without_the_zero_matches_jax_and_the_model(mixed):
    """The same batch with lane 40 given a Z: the port, the block model
    and JAX agree lane for lane, and give the known verdicts (lane 40
    true: (0, 0) encodes to 32 zero bytes)."""
    x, y, z, r, want = mixed
    z = z.clone()
    z[MIXED_ZERO_LANE] = torch.from_numpy(T._int_to_limbs(5))
    want = want.numpy()
    jax_v = _jax(x, y, z, r)[1]
    np.testing.assert_array_equal(jax_v, want)
    np.testing.assert_array_equal(TT.finish_encode_compare(x, y, z, r).numpy(), want)
    np.testing.assert_array_equal(_kernel_model(x, y, z, r.int()).numpy(), want)
    np.testing.assert_array_equal(_per_lane_model(x, y, z, r.int()).numpy(), want)
