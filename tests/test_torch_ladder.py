"""The port's generic ladder against the JAX package's Pallas ladder
prologue and the RFC 8032 host reference.

`_build_inputs` (per-lane {O, B, -A, B-A} tables and msb-first digits)
is held against the JAX prologue called eagerly at 1024 lanes, after
un-tiling the JAX (tiles, ..., 8, w) layout; the plain ladder's verdicts
against `ed25519_ref.verify`.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.crypto.keys import gen_priv_key
from tendermint_tpu.ops import ed25519_ladder_pallas as JL
from tendermint_tpu_torch.crypto import ed25519_ref
from tendermint_tpu_torch.ops import ed25519_kernel as T
from tendermint_tpu_torch.ops import ed25519_ladder as TL
from tendermint_tpu_torch.ops import ed25519_tables as TT

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

BAD_KEY = b"\xff" * 31 + b"\x7f"
ZERO_KEY = b"\x00" * 32


def _triples(n: int, n_keys: int, seed: int):
    """n signed triples over n_keys keys, with a forged signature, an
    S >= L, an invalid key and a wrong-length signature planted."""
    rng = np.random.default_rng(seed)
    privs = [gen_priv_key(rng.bytes(32)) for _ in range(n_keys)]
    triples = []
    for i in range(n):
        p = privs[i % n_keys]
        msg = rng.bytes(40)
        triples.append((p.pub_key.data, msg, p.sign(msg)))
    pk, msg, sig = triples[1]
    triples[1] = (pk, msg, bytes([sig[0] ^ 1]) + sig[1:])
    pk, msg, sig = triples[2]
    s = int.from_bytes(sig[32:], "little") + T.L
    triples[2] = (pk, msg, sig[:32] + s.to_bytes(32, "little"))
    pk, msg, sig = triples[3]
    triples[3] = (BAD_KEY, msg, sig)
    pk, msg, sig = triples[4]
    triples[4] = (pk, msg, sig[:63])
    return triples


def _prepared(triples):
    pubs, msgs, sigs = zip(*triples)
    return T.prepare_batch(pubs, msgs, sigs)


def test_build_inputs_matches_jax_prologue():
    lanes, tile = 1024, 1024
    pub, _r, s, h, _pre = _prepared(_triples(lanes, 16, seed=31))
    gtab, dig, a_ok = TL._build_inputs(*(torch.from_numpy(a) for a in (pub, s, h)))
    jg, jd, jok = JL._build_inputs(jnp.asarray(pub), jnp.asarray(s), jnp.asarray(h), tile)
    w = tile // 8
    # (tiles, 4, 60, 8, w) -> (4, B, 60); (tiles, 253, 8, w) -> (B, 253)
    jg = np.transpose(np.asarray(jg), (1, 0, 3, 4, 2)).reshape(4, lanes, 60)
    jd = np.transpose(np.asarray(jd), (0, 2, 3, 1)).reshape(lanes, 253)
    assert w * 8 == lanes
    np.testing.assert_array_equal(gtab.numpy(), jg)
    np.testing.assert_array_equal(dig.numpy(), jd)
    np.testing.assert_array_equal(a_ok.numpy(), np.asarray(jok))
    assert not a_ok[3] and a_ok[0]


def test_ladder_digits_are_msb_first():
    s = np.zeros((2, 32), dtype=np.uint8)
    h = np.zeros((2, 32), dtype=np.uint8)
    s[0, 31] = 0x10  # bit 252 of lane 0
    h[1, 0] = 0x01  # bit 0 of lane 1
    dig = TL._ladder_digits(torch.from_numpy(s), torch.from_numpy(h)).numpy()
    want = np.asarray(JL._ladder_digits(jnp.asarray(s), jnp.asarray(h)))
    np.testing.assert_array_equal(dig, want)
    assert dig[0, 0] == 1 and dig[0, 1:].sum() == 0
    assert dig[1, -1] == 2 and dig[1, :-1].sum() == 0


def _host_verdicts(triples):
    return np.array([ed25519_ref.verify(pk, m, s) for pk, m, s in triples])


@pytest.mark.parametrize("fn", ["verify_kernel_ladder", "batch_verify"])
def test_plain_verdicts_match_host_reference(fn):
    """The ladder (`ed25519_ladder.verify_kernel_ladder`) on CPU tensors,
    and the flat entry point over it (`ed25519_kernel.batch_verify`)."""
    triples = _triples(8, 8, seed=32)
    if fn == "verify_kernel_ladder":
        pub, r, s, h, pre = _prepared(triples)
        got = TL.verify_kernel_ladder(*(torch.from_numpy(a) for a in (pub, r, s, h))).numpy() & pre
    else:
        got = T.batch_verify(*zip(*triples), device="cpu")
    want = _host_verdicts(triples)
    np.testing.assert_array_equal(got, want)
    assert list(want) == [True, False, False, False, False, True, True, True]


def _digits(s, h):
    return TT._digits_w4(torch.from_numpy(s).int(), torch.from_numpy(h).int())


def test_ladder_plain_is_the_wrapper_on_cpu():
    triples = _triples(8, 8, seed=33)
    pub, _r, s, h, _pre = _prepared(triples)
    pub, dig = torch.from_numpy(pub), _digits(s, h)
    before = TL.ladder.launches
    got, ok = TL.ladder(pub, dig)
    want, want_ok = TL._ladder_w4_plain(pub, dig)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(ok, want_ok)
    assert TL.ladder.launches == before  # CPU tensors never launch a kernel


def _zero_key_lane():
    """The all-zero key (a point of order 4) 'signing' with R = identity
    and S = 0: cofactorless verification accepts it when h = 0 mod 4."""
    sig = b"\x01" + b"\x00" * 63
    for i in range(64):
        msg = b"keyless-%d" % i
        h = int.from_bytes(hashlib.sha512(sig[:32] + ZERO_KEY + msg).digest(), "little") % T.L
        if h % 4 == 0:
            return ZERO_KEY, msg, sig
    raise AssertionError("no message with h = 0 mod 4 in 64 tries")


def _affine(point):
    """Canonical affine (x, y) of each lane, and T * Z == X * Y."""
    x, y, z, t = (c.contiguous() for c in point)
    zinv = T.fe_invert(T.fe_carry(z))
    xy = torch.stack([T.fe_canon(T.fe_mul(x, zinv)), T.fe_canon(T.fe_mul(y, zinv))])
    return xy, T.fe_eq(T.fe_mul(t, z), T.fe_mul(x, y))


def test_window_comb_ladder_matches_the_jax_algorithm():
    """The card's algorithm (decompression, 4-bit window, comb) gives the
    point of the oracle that mirrors the JAX prologue and its 253-step
    ladder on every lane whose key decodes, and the host reference's
    verdicts on every lane: forged, S >= L, invalid encoding, short
    signature and a small-order key planted."""
    triples = _triples(8, 8, seed=34)
    triples[6] = _zero_key_lane()
    pub, r, s, h, pre = _prepared(triples)
    pub_t = torch.from_numpy(pub)
    got, ok = TL._ladder_w4_plain(pub_t, _digits(s, h))
    gtab, dig, want_ok = TL._build_inputs(pub_t, *(torch.from_numpy(a) for a in (s, h)))
    want = TL._ladder_plain(gtab, dig)
    (g_xy, g_tz), (w_xy, _w_tz) = _affine(got), _affine(want)
    np.testing.assert_array_equal(ok.numpy(), want_ok.numpy())
    assert bool(g_tz.all())
    np.testing.assert_array_equal(g_xy[:, ok].numpy(), w_xy[:, ok].numpy())
    verdict = TL.finish_encode_compare(*got[:3], torch.from_numpy(r)) & ok
    np.testing.assert_array_equal(verdict.numpy() & pre, _host_verdicts(triples) | (np.arange(8) == 6))
    assert list(verdict.numpy() & pre) == [True, False, False, False, False, True, True, True]


# encodings at the edges of the decoder's rules
_EDGE_KEYS = {
    "y_is_p": (T.P).to_bytes(32, "little"),
    "y_is_p_plus_1": (T.P + 1).to_bytes(32, "little"),
    "y_max": b"\xff" * 31 + b"\x7f",
    "y_is_p_minus_1": (T.P - 1).to_bytes(32, "little"),
    "identity": b"\x01" + b"\x00" * 31,
    "identity_signed": b"\x01" + b"\x00" * 30 + b"\x80",
    "order4": b"\x00" * 32,
    "order4_signed": b"\x00" * 31 + b"\x80",
    "off_curve": (2).to_bytes(32, "little"),
}


def test_kernel_decompression_keeps_the_rules_of_pt_decompress():
    rng = np.random.default_rng(35)
    keys = list(_EDGE_KEYS.values()) + [rng.bytes(32) for _ in range(7)]
    keys += [ed25519_ref.public_from_seed(rng.bytes(32)) for _ in range(4)]
    pub = torch.from_numpy(np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 32).copy())
    neg_a, ok = TL._decompress_neg(pub)
    a_pt, want_ok = T.pt_decompress(pub)
    np.testing.assert_array_equal(ok.numpy(), want_ok.numpy())
    assert not ok[:3].any() and ok[-4:].all()
    # accepted lanes hold -A; rejected lanes the identity
    want_x = torch.where(want_ok[:, None], T.fe_canon(T.fe_neg(a_pt[0])), 0)
    np.testing.assert_array_equal(T.fe_canon(neg_a[0]).numpy(), want_x.numpy())
