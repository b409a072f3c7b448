"""Hand kernels against their plain torch versions, on the CUDA card.

Every test here needs a card and skips without one (the kernels have no
CPU mode; their plain versions are held against JAX in the CPU tests).
Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Outputs are integers, so kernel and plain version must agree exactly on
the canonical coordinates (affine x, y for the two kernels that add in
another order than their plain versions) and on the verdicts. The
machine with the card has no jax: run this file with `--noconftest`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519_ref
from tendermint_tpu_torch.ops import ed25519_kernel as T
from tendermint_tpu_torch.ops import ed25519_ladder as TL
from tendermint_tpu_torch.ops import ed25519_tables as TT

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def signed():
    rng = np.random.default_rng(51)
    seeds = [rng.bytes(32) for _ in range(16)]
    pubs = [ed25519_ref.public_from_seed(s) for s in seeds]
    msgs = [[rng.bytes(64) for _ in seeds] for _ in range(8)]
    sigs = [[ed25519_ref.sign(s, m) for s, m in zip(seeds, row)] for row in msgs]
    sigs[0][3] = bytes([sigs[0][3][0] ^ 1]) + sigs[0][3][1:]
    return pubs, list(zip(msgs, sigs))


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(T.fe_canon(g.contiguous()), T.fe_canon(w.contiguous()))


def _affine(point):
    x, y, z, t = (c.contiguous() for c in point)
    zinv = TT.fe_batch_invert(T.fe_carry(z))
    assert bool(T.fe_eq(T.fe_mul(t, z), T.fe_mul(x, y)).all())  # T * Z == X * Y
    return torch.stack([T.fe_canon(T.fe_mul(x, zinv)), T.fe_canon(T.fe_mul(y, zinv))])


def _same_affine(got, want):
    assert torch.equal(_affine(got), _affine(want))


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    uniq = [ed25519_ref.public_from_seed(rng.bytes(32)) for _ in range(min(n, 64))]
    return np.frombuffer(b"".join(uniq[i % len(uniq)] for i in range(n)), np.uint8).reshape(n, 32).copy()


def _nibbles(lanes, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 16, (lanes, TT.NSTEPS_W4), dtype=np.int32)).to(dev)


def _lanes(pubs, commits, dev):
    s, h, r, _pre = TT.prepare_commit_lanes(pubs, commits)
    return tuple(torch.from_numpy(a).to(dev).int() for a in (s, h, r))


def test_madd_chain_entries_matches_plain(dev, signed):
    pubs, commits = signed
    tables, _ok = TT.build_key_tables(np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 32), device=dev)
    s, h, r = _lanes(pubs, commits[:1], dev)
    ent = TT._select_entries(tables, s, h)
    before = TT.sum_entries.launches
    got = TT.sum_entries(ent)
    assert TT.sum_entries.launches == before + 1
    _same(got, TT._sum_entries_plain(ent))
    verdict = TT._finish_encode_compare(*got[:3], r).cpu().numpy()
    assert not verdict[3] and verdict.sum() == len(pubs) - 1


def test_madd_chain_fused_matches_plain(dev, signed):
    pubs, commits = signed
    tables, _ok = TT.build_key_tables(np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 32), device=dev)
    s, h, r = _lanes(pubs, commits, dev)
    dig = TT._digits_w4(s, h).contiguous()
    before = TT.fused_chain.launches
    got = TT.fused_chain(tables, dig)
    assert TT.fused_chain.launches == before + 1
    _same_affine(got, TT._fused_chain_plain(tables, dig))
    verdict = TT._finish_encode_compare(*got[:3], r).cpu().numpy()
    assert not verdict[3] and verdict.sum() == verdict.size - 1


@pytest.mark.parametrize("n", [1000, 13])
@pytest.mark.parametrize("k", [1, 8, 16])
def test_madd_chain_fused_shapes(dev, n, k):
    """A ragged validator tile (13 = 8 + 5) and every commit grouping."""
    tables, _ok = TT.build_key_tables(_keys(n, 52), device=dev)
    dig = _nibbles(n * k, 53 + k, dev)
    got = TT.fused_chain(tables, dig)
    _same_affine(got, TT._fused_chain_plain(tables, dig))


def test_ladder_matches_plain(dev, signed):
    pubs, commits = signed
    msgs, sigs = commits[0]
    pub, r, s, h, _pre = T.prepare_batch(pubs, msgs, sigs)
    pub, r, s, h = (torch.from_numpy(a).to(dev) for a in (pub, r, s, h))
    dig = TT._digits_w4(s.int(), h.int())
    before = TL.ladder.launches
    got, ok = TL.ladder(pub, dig)
    assert TL.ladder.launches == before + 1
    want, want_ok = TL._ladder_w4_plain(pub, dig)
    _same_affine(got, want)
    assert torch.equal(ok, want_ok) and bool(ok.all())
    gtab, odig, _ok = TL._build_inputs(pub, s, h)  # the JAX-mirroring oracle
    _same_affine(got, TL._ladder_plain(gtab.contiguous(), odig))
    verdict = TT._finish_encode_compare(*got[:3], r.int()).cpu().numpy()
    assert not verdict[3] and verdict.sum() == len(pubs) - 1


@pytest.mark.parametrize("lanes", [1, 31, 512, 4096])
def test_ladder_shapes(dev, lanes):
    """Any lane count (three lanes a warp, twelve a block), with keys that
    do not decode (y >= p, x = 0 with the sign bit) and small-order keys."""
    pub = _keys(lanes, 54)
    if lanes > 8:
        pub[3] = 0xFF
        pub[3, 31] = 0x7F
        pub[4] = 0
        pub[4, 0] = 1
        pub[5] = 0
        pub[6] = 0
        pub[6, 0] = 2
        pub[7] = 0
        pub[7, 0] = 1
        pub[7, 31] = 0x80
    pub_t = torch.from_numpy(pub).to(dev)
    dig = _nibbles(lanes, 55, dev)
    got, ok = TL.ladder(pub_t, dig)
    want, want_ok = TL._ladder_w4_plain(pub_t, dig)
    _same_affine(got, want)
    assert torch.equal(ok, want_ok)
    assert torch.equal(ok, T.pt_decompress(pub_t)[1])


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    ent = torch.zeros((TT.NSTEPS, 60, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        TT.sum_entries(ent.to(torch.int64))
    with pytest.raises(ValueError):
        TT.sum_entries(ent[:, :, ::2])
    with pytest.raises(ValueError):
        TT.sum_entries(ent.transpose(1, 2).contiguous())
    tables = torch.zeros((64, 16, 60, 4), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        TT.fused_chain(tables.int(), torch.zeros((8, 128), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        TT.fused_chain(tables, torch.zeros((8, 127), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        TT.fused_chain(tables.cpu(), torch.zeros((8, 128), dtype=torch.int32, device=dev))
    for lanes in (0, 2, 6):  # no lanes, fewer than N, not whole commits
        with pytest.raises(ValueError):
            TT.fused_chain(tables, torch.zeros((lanes, 128), dtype=torch.int32, device=dev))
    pub = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    dig = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        TL.ladder(pub.int(), dig)
    with pytest.raises(ValueError):
        TL.ladder(pub, dig.long())
    with pytest.raises(ValueError):
        TL.ladder(pub[:4], dig)
    with pytest.raises(ValueError):
        TL.ladder(pub.cpu(), dig)


def test_verifier_on_the_card_launches_each_kernel(dev, signed):
    from tendermint_tpu_torch.services.verifier import TableBatchVerifier

    pubs, commits = signed
    v = TableBatchVerifier(min_device_batch=0)
    counts = (TT.sum_entries.launches, TT.fused_chain.launches, TL.ladder.launches)
    single = v.verify_commits(pubs, commits[:1])
    stacked = v.verify_commits(pubs, commits)
    flat = v.verify_batch([(pubs[i], commits[1][0][i], commits[1][1][i]) for i in range(len(pubs))])
    assert (TT.sum_entries.launches, TT.fused_chain.launches, TL.ladder.launches) == tuple(
        c + 1 for c in counts
    )
    assert not single[0, 3] and single.sum() == len(pubs) - 1
    assert not stacked[0, 3] and stacked.sum() == stacked.size - 1
    assert flat.all()
