"""Hand kernels against their plain torch versions, on the CUDA card.

Every test here needs a card and skips without one (the kernels have no
CPU mode; their plain versions are held against JAX in the CPU tests).
Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Outputs are integers, so kernel and plain version must agree exactly on
the canonical coordinates and on the verdicts.
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
    _same(got, TT._fused_chain_plain(tables, dig))


def test_ladder_matches_plain(dev, signed):
    pubs, commits = signed
    msgs, sigs = commits[0]
    pub, r, s, h, _pre = T.prepare_batch(pubs, msgs, sigs)
    pub, r, s, h = (torch.from_numpy(a).to(dev) for a in (pub, r, s, h))
    gtab, dig, _ok = TL._build_inputs(pub, s, h)
    before = TL.ladder.launches
    got = TL.ladder(gtab.contiguous(), dig)
    assert TL.ladder.launches == before + 1
    _same(got, TL._ladder_plain(gtab, dig))


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
        TL.ladder(torch.zeros((4, 8, 60), dtype=torch.int32, device=dev),
                  torch.zeros((8, 252), dtype=torch.int32, device=dev))


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
