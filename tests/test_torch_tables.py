"""The port's comb-table path against the JAX package's.

Table builds, comb tables, lane prep and the two chains' plain versions
are held against the JAX functions on the same numpy-seeded inputs:
table entries byte for byte, chain outputs limb for limb (the JAX
composition `_select_entries` -> `_sum_entries_xla` ->
`_finish_encode_compare` for the entries chain; a loop of `pt_madd`
over the w=4 combs' entries for the fused chain), verdicts exactly; the
encode-and-compare finish on chain outputs and hand-made lanes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.crypto.keys import gen_priv_key
from tendermint_tpu.ops import ed25519_tables as JT
from tendermint_tpu_torch.ops import ed25519_tables as TT
from tendermint_tpu_torch.testing import finish_edge_lanes

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

BAD_KEY = b"\xff" * 31 + b"\x7f"  # y = 2^255 - 1 >= p: undecodable
IDENT_KEY = b"\x01" + b"\x00" * 31  # the identity point
L = TT.L


def _signers(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [gen_priv_key(rng.bytes(32)) for _ in range(n)]


@pytest.fixture(scope="module")
def valset():
    """Four validators, the third with an invalid encoding, and two
    commits with a forged, an absent, an S >= L and a short signature."""
    privs = _signers(4, seed=21)
    pubs = [p.pub_key.data for p in privs]
    pubs[2] = BAD_KEY
    commits = []
    for k in range(2):
        msgs = [b"height-%d-val-%d" % (k, i) for i in range(4)]
        sigs = [p.sign(m) for p, m in zip(privs, msgs)]
        commits.append((msgs, sigs))
    msgs0, sigs0 = commits[0]
    sigs0[1] = bytes([sigs0[1][0] ^ 1]) + sigs0[1][1:]  # forged
    msgs1, sigs1 = commits[1]
    msgs1[0] = sigs1[0] = None  # absent
    s = int.from_bytes(sigs1[3][32:], "little") + L
    sigs1[3] = sigs1[3][:32] + s.to_bytes(32, "little")  # S >= L
    expected = np.array([[1, 0, 0, 1], [0, 1, 0, 0]], dtype=bool)
    return pubs, commits, expected


@pytest.fixture(scope="module")
def tables(valset):
    pubs, _, _ = valset
    arr = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(len(pubs), 32)
    return TT.build_key_tables(arr, device="cpu")


def test_build_key_tables_matches_jax_host_build():
    keys = [p.pub_key.data for p in _signers(3, seed=22)] + [BAD_KEY, IDENT_KEY]
    arr = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(5, 32)
    got_t, got_ok = TT.build_key_tables(arr, device="cpu")
    want_t, want_ok = JT.host_build_key_tables(keys)
    assert got_t.dtype == torch.int16 and tuple(got_t.shape) == (64, 16, 60, 5)
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    assert list(got_ok) == [True, True, True, False, True]


def test_build_key_tables_chunks_agree(tables, valset, monkeypatch):
    pubs, _, _ = valset
    arr = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(len(pubs), 32)
    monkeypatch.setattr(TT, "BUILD_CHUNK", 3)
    chunked, ok = TT.build_key_tables(arr, device="cpu")
    np.testing.assert_array_equal(chunked.numpy(), tables[0].numpy())
    np.testing.assert_array_equal(ok, tables[1])


def test_host_build_key_tables_matches_jax():
    keys = [p.pub_key.data for p in _signers(2, seed=23)] + [BAD_KEY, b"\x01" * 31]
    got = TT.host_build_key_tables(keys)
    want = JT.host_build_key_tables(keys)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [0, 1, 2, 255, 2**200 + 12345, L - 1, L])
def test_host_scalar_mul_and_affine_match_jax(k):
    got = TT.host_scalar_mul(k, TT._B_EXT)
    assert got == JT.host_scalar_mul(k, JT._B_EXT)
    assert TT.host_affine(got) == JT.host_affine(got)
    if k % L == 0:
        assert TT.host_affine(got) == (0, 1)  # [L]B is the identity


@pytest.mark.parametrize(
    "pub", [BAD_KEY, IDENT_KEY, b"\x00" * 32, (2).to_bytes(32, "little")],
    ids=["y_ge_p", "identity", "order4", "off_curve"],
)
def test_host_decompress_matches_jax(pub):
    assert TT._host_decompress(pub) == JT._host_decompress(pub)


@pytest.mark.parametrize("name", ["sb_table_w4", "b_table"])
def test_comb_tables_match_jax(name):
    got, want = getattr(TT, name)(), getattr(JT, name)()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_prepare_commit_lanes_matches_jax(valset):
    pubs, commits, _ = valset
    pubs = list(pubs)
    pubs[0] = pubs[0][:31]  # short pubkey: precheck False
    got = TT.prepare_commit_lanes(pubs, commits)
    want = JT.prepare_commit_lanes(pubs, commits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_prepare_commit_lanes_rejects_ragged_commit(valset):
    pubs, commits, _ = valset
    with pytest.raises(ValueError):
        TT.prepare_commit_lanes(pubs, [(commits[0][0][:3], commits[0][1][:3])])


class TestTablesFromJax:
    def test_round_trip(self, tables, valset):
        pubs, _, _ = valset
        jt, jok = JT.host_build_key_tables(pubs)
        t, ok = TT.tables_from_jax(jt, jok, device="cpu")
        np.testing.assert_array_equal(t.numpy(), tables[0].numpy())
        np.testing.assert_array_equal(ok, tables[1])

    def test_same_verdicts_as_port_built(self, tables, valset):
        pubs, commits, _ = valset
        jt, jok = JT.host_build_key_tables(pubs)
        converted, _ = TT.tables_from_jax(jt, jok, device="cpu")
        s, h, r, _pre = TT.prepare_commit_lanes(pubs, commits)
        lanes = [torch.from_numpy(a) for a in (s, h, r)]
        for impl in ("entries", "fused"):
            np.testing.assert_array_equal(
                TT.verify_tables_kernel(converted, *lanes, impl=impl).numpy(),
                TT.verify_tables_kernel(tables[0], *lanes, impl=impl).numpy(),
            )

    @pytest.mark.parametrize(
        "mutate",
        [
            lambda t, ok: (t.astype(np.int32), ok),
            lambda t, ok: (t[:, :8], ok),
            lambda t, ok: (t, ok[:-1]),
            lambda t, ok: (t + np.int16(8192), ok),
        ],
        ids=["dtype", "shape", "ok_len", "limb_range"],
    )
    def test_rejects_malformed(self, valset, mutate):
        jt, jok = JT.host_build_key_tables(valset[0][:2])
        with pytest.raises(ValueError):
            TT.tables_from_jax(*mutate(jt, jok), device="cpu")


def test_select_entries_matches_jax(tables, valset):
    pubs, commits, _ = valset
    s, h, _r, _pre = TT.prepare_commit_lanes(pubs, commits)
    got = TT._select_entries(tables[0], torch.from_numpy(s).int(), torch.from_numpy(h).int())
    want = JT._select_entries(
        jnp.asarray(tables[0].numpy()), jnp.asarray(s.astype(np.int32)), jnp.asarray(h.astype(np.int32))
    )
    # the port's layout is lane-minor: (96, 60, B) against the JAX (96, B, 60)
    np.testing.assert_array_equal(got.permute(0, 2, 1).numpy(), np.asarray(want))


_jax_madd = jax.jit(JT.pt_madd)  # one step compiled once, called per step
_jax_finish = jax.jit(JT._finish_encode_compare)  # compiled once a shape


def _jax_chain(entries, r):
    """The JAX composition: madd loop from the identity, then the
    encode-and-compare finish. entries: (steps, B, 60) numpy."""
    acc = JT._identity_like(jnp.asarray(entries[0, :, :1]))
    for e in entries:
        e = jnp.asarray(e)
        acc = _jax_madd(acc, (e[:, :20], e[:, 20:40], e[:, 40:]))
    verdict = _jax_finish(*acc[:3], jnp.asarray(r.astype(np.int32)))
    return acc, np.asarray(verdict)


def _check_chain(got_acc, want_acc):
    for g, w in zip(got_acc, want_acc):
        np.testing.assert_array_equal(g.contiguous().numpy(), np.asarray(w))


def test_entries_chain_matches_jax_composition(tables, valset):
    """The wrapper's CPU path, `_sum_entries_plain(_select_entries(...))`,
    against the JAX `_select_entries` + `_sum_entries_xla`, limb for limb."""
    pubs, commits, expected = valset
    s, h, r, pre = TT.prepare_commit_lanes(pubs, commits)
    got_acc = TT.sum_entries(tables[0], torch.from_numpy(s).int(), torch.from_numpy(h).int())
    ent = JT._select_entries(
        jnp.asarray(tables[0].numpy()), jnp.asarray(s.astype(np.int32)), jnp.asarray(h.astype(np.int32))
    )
    want_acc = JT._sum_entries_xla(ent)
    _check_chain(got_acc, want_acc)
    want_v = np.asarray(_jax_finish(*want_acc[:3], jnp.asarray(r.astype(np.int32))))
    got_v = TT.verify_tables_kernel(tables[0], *(torch.from_numpy(a) for a in (s, h, r)), impl="entries")
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    mask = got_v.numpy() & pre & np.tile(tables[1], 2)
    np.testing.assert_array_equal(mask.reshape(2, 4), expected)


def test_fused_chain_matches_jax_composition(tables, valset):
    pubs, commits, expected = valset
    s, h, r, pre = TT.prepare_commit_lanes(pubs, commits)
    digits = TT._digits_w4(torch.from_numpy(s).int(), torch.from_numpy(h).int())
    np.testing.assert_array_equal(
        digits.numpy(),
        np.asarray(JT._digits_w4(jnp.asarray(s.astype(np.int32)), jnp.asarray(h.astype(np.int32)))),
    )
    got_acc = TT.fused_chain(tables[0], digits)
    # JAX side: the fused kernel's selection written out with numpy
    d = digits.numpy()
    sb = JT.sb_table_w4()
    tab = tables[0].numpy().astype(np.int32)
    col = np.arange(d.shape[0]) % tab.shape[3]
    ent = np.stack(
        [sb[step, d[:, step]] for step in range(64)]
        + [tab[w, d[:, 64 + w], :, col] for w in range(64)]
    )
    want_acc, want_v = _jax_chain(ent, r)
    _check_chain(got_acc, want_acc)
    got_v = TT.verify_tables_kernel(tables[0], *(torch.from_numpy(a) for a in (s, h, r)), impl="fused")
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    mask = got_v.numpy() & pre & np.tile(tables[1], 2)
    np.testing.assert_array_equal(mask.reshape(2, 4), expected)


def test_verify_tables_kernel_rejects_ragged_lanes(tables):
    lanes = torch.zeros((6, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        TT.verify_tables_kernel(tables[0], lanes, lanes, lanes)
    with pytest.raises(ValueError):
        TT.verify_tables_kernel(tables[0], lanes[:4], lanes[:4], lanes[:4], impl="pallas")


def test_build_key_tables_needs_a_device_or_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        TT.build_key_tables(np.zeros((1, 32), dtype=np.uint8))


@pytest.mark.parametrize("lanes", [0, 3, 7])
def test_fused_chain_takes_whole_commits_only(lanes):
    """Lane b takes validator b mod N: no lanes, fewer lanes than N or a
    part of a commit is refused on the CPU as on the card."""
    tbl = torch.zeros((TT.A_NWIN, 16, 60, 5), dtype=torch.int16)
    with pytest.raises(ValueError):
        TT.fused_chain(tbl, torch.zeros((lanes, TT.NSTEPS_W4), dtype=torch.int32))


@pytest.mark.parametrize("lanes", [0, 3, 7])
def test_sum_entries_takes_whole_commits_only(lanes):
    """The entries chain refuses what the fused chain refuses."""
    tbl = torch.zeros((TT.A_NWIN, 16, 60, 5), dtype=torch.int16)
    zeros = torch.zeros((lanes, 32), dtype=torch.int32)
    with pytest.raises(ValueError):
        TT.sum_entries(tbl, zeros, zeros)


def test_finish_encode_compare_matches_jax(tables, valset):
    """The wrapper's CPU path against the JAX `_finish_encode_compare`, in
    one batch: the entries chain's outputs and the hand-made lanes of
    `finish_edge_lanes`, whose verdicts are known; R as uint8 and int32."""
    pubs, commits, _expected = valset
    s, h, r, _pre = TT.prepare_commit_lanes(pubs, commits)
    chain = TT.sum_entries(tables[0], torch.from_numpy(s).int(), torch.from_numpy(h).int())
    ex, ey, ez, er, verdicts = finish_edge_lanes()
    x, y, z = (torch.cat([c, torch.from_numpy(e)]) for c, e in zip(chain, (ex, ey, ez)))
    rr = np.concatenate([r, er])
    want = np.asarray(_jax_finish(*(jnp.asarray(c.numpy()) for c in (x, y, z)), jnp.asarray(rr.astype(np.int32))))
    for r_t in (torch.from_numpy(rr), torch.from_numpy(rr).int()):
        np.testing.assert_array_equal(TT.finish_encode_compare(x, y, z, r_t).numpy(), want)
    np.testing.assert_array_equal(want[len(r):], verdicts)


def test_finish_encode_compare_is_false_where_z_is_zero():
    """The JAX tree inverts every lane to 0 when one Z is 0, so its
    verdict is true for an all-zero R there; the plain version and the
    wrapper's CPU path, like the kernel, make a batch with a Z = 0 lane
    false on every lane, and the lanes without it keep their verdicts."""
    ex, ey, ez, er, verdicts = (torch.from_numpy(a) for a in finish_edge_lanes())
    zero = torch.zeros((2, 20), dtype=torch.int32)
    y0 = zero.clone()
    y0[1, 0] = 1
    r0 = torch.zeros((2, 32), dtype=torch.uint8)
    r0[1, 0] = 1
    tree = np.asarray(_jax_finish(*(jnp.asarray(c.numpy()) for c in (zero, y0, zero, r0.int()))))
    assert tree.tolist() == [True, False]
    assert TT._finish_encode_compare(zero, y0, zero, r0.int()).tolist() == [False, False]
    assert TT.finish_encode_compare(zero, y0, zero, r0).tolist() == [False, False]
    x, y, z = (torch.cat([zero, c]) for c in (ex, ey, ez))
    got = TT.finish_encode_compare(x, torch.cat([y0, ey]), z, torch.cat([r0, er]))
    assert not got.any()
    assert torch.equal(TT.finish_encode_compare(ex, ey, ez, er), verdicts)
