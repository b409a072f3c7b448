"""The port's votes, vote sets, validator sets and evidence against the
JAX package's.

The JAX package's own scenarios (`tests/test_validator_set.py`,
`test_vote_set.py` and the type-level cases of `test_evidence.py`) run
again on `tendermint_tpu_torch.types`. Differential tests build seeded
votes, commits, validator-set changes and evidence in both packages and
require byte-equal encodings and sign bytes, equal hashes and the same
proposer sequence. The verification matrix drives
`verify_commit` / `verify_commit_batched` / `verify_commit_batched_async`
/ `verify_commit_any` / `DuplicateVoteEvidence.verify` /
`verify_evidence_batch` of both packages on the same commits and proofs
(a forged lane, an absent vote, a wrong height, a wrong round, too little
power, ...) and requires the same outcome, compared as the exception's
class name and message, through four verifiers: the JAX package's host
verifier, the port's, and the port's `default_verifier(device="cpu")` at
the default minimum batch (its host loop) and at 0 (the plain torch
chains and ladder).

Objects cross from the JAX package to the port by their wire form only
(`encode()` into the port's `decode()`); a validator set is rebuilt from
its validators' (address, pub_key, voting_power, accum). Everything is
exact.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from tendermint_tpu import types as J
from tendermint_tpu.crypto import PrivKey as JPrivKey
from tendermint_tpu.crypto import PubKey as JPubKey
from tendermint_tpu.services.verifier import HostBatchVerifier as JHostVerifier
from tendermint_tpu.types import evidence as J_evidence
from tendermint_tpu_torch import types as P
from tendermint_tpu_torch.codec import Reader
from tendermint_tpu_torch.crypto import PrivKey, PubKey
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.services.batcher import CoalescingVerifier
from tendermint_tpu_torch.testing import det_priv_keys, lockrank_report, make_block_id, make_validators, signed_vote
from tendermint_tpu_torch.testing import make_commit as _make_commit
from tendermint_tpu_torch.types import evidence as P_evidence
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence, decode_evidence, verify_evidence_batch

torch.set_num_threads(1)

CHAIN_ID = "test-chain"
HOST = V.HostBatchVerifier()


def make_commit(val_set, privs, height, round_, block_id):
    return _make_commit(val_set, privs, height, round_, block_id, verifier=HOST)


def byzantine_signed_vote(priv, index, height, round_, type_, block_id, timestamp=1000):
    """Signed past the double-sign guard (a Byzantine validator)."""
    vote = P.Vote(validator_address=priv.address, validator_index=index, height=height, round=round_,
                  timestamp=timestamp, type=type_, block_id=block_id)
    return vote.with_signature(priv._signer.sign(vote.sign_bytes(CHAIN_ID)))


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


# -- the bridge: JAX objects into the port by their wire form ---------------


def p_vote(v):
    return None if v is None else P.Vote.decode(v.encode())


def p_block_id(bid):
    return P.BlockID.decode_from(Reader(bid.encode()))


def p_commit(c):
    return P.Commit.decode_from(Reader(c.encode()))


def p_valset(vs):
    return P.ValidatorSet([P.Validator(v.address, PubKey(v.pub_key.data), v.voting_power, v.accum) for v in vs])


def outcome(fn):
    """None, or the raised exception as (class name, message)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is part of what is compared
        return type(e).__name__, str(e)
    return None


# -- tests/test_validator_set.py ------------------------------------------


def test_sorted_by_address():
    vs, _ = make_validators(10)
    addrs = [v.address for v in vs.validators]
    assert addrs == sorted(addrs) and vs.total_voting_power == 100


def test_proposer_rotation_equal_power_cycles():
    vs, _ = make_validators(4)
    seen = []
    for _ in range(8):
        vs.increment_accum(1)
        seen.append(vs.proposer.address)
    assert all(c == 2 for c in Counter(seen).values())


def test_proposer_rotation_weighted():
    _, privs = make_validators(3)
    vals = [P.Validator(p.address, p.pub_key, w) for p, w in zip(privs, [1, 1, 8])]
    vs = P.ValidatorSet(vals)
    seen = Counter()
    for _ in range(10):
        vs.increment_accum(1)
        seen[vs.proposer.address] += 1
    assert seen[vals[2].address] == 8


def test_hash_changes_with_membership():
    vs, _ = make_validators(4)
    h1 = vs.hash()
    assert h1 != make_validators(5)[0].hash() and len(h1) == 32


def test_verify_commit_ok():
    vs, privs = make_validators(4)
    bid = make_block_id()
    vs.verify_commit(CHAIN_ID, bid, 5, make_commit(vs, privs, 5, 0, bid), verifier=HOST)


def test_verify_commit_insufficient_power():
    vs, privs = make_validators(4)
    bid = make_block_id()
    votes = [signed_vote(privs[i], i, 5, 0, P.VOTE_TYPE_PRECOMMIT, bid) for i in range(2)] + [None, None]
    with pytest.raises(P.ValidationError, match="insufficient voting power: 20 of 40"):
        vs.verify_commit(CHAIN_ID, bid, 5, P.Commit(block_id=bid, precommits=votes), verifier=HOST)


def test_verify_commit_bad_signature():
    vs, privs = make_validators(4)
    bid = make_block_id()
    commit = make_commit(vs, privs, 5, 0, bid)
    commit.precommits[0] = commit.precommits[0].with_signature(bytes(64))
    with pytest.raises(P.ValidationError, match="invalid commit signature from validator 0"):
        vs.verify_commit(CHAIN_ID, bid, 5, commit, verifier=HOST)


def test_verify_commit_wrong_height():
    vs, privs = make_validators(4)
    bid = make_block_id()
    with pytest.raises(P.ValidationError, match="commit height 5 != 6"):
        vs.verify_commit(CHAIN_ID, bid, 6, make_commit(vs, privs, 5, 0, bid), verifier=HOST)


def test_verify_commit_any_small_change():
    vs, privs = make_validators(4)
    bid = make_block_id()
    vs.verify_commit_any(vs, CHAIN_ID, bid, 7, make_commit(vs, privs, 7, 0, bid), verifier=HOST)


def test_apply_changes():
    vs, _ = make_validators(4)
    target = vs.validators[0]
    vs.apply_changes([P.Validator(target.address, target.pub_key, 0)])
    assert vs.size() == 3 and not vs.has_address(target.address)
    v1 = vs.validators[0]
    vs.apply_changes([P.Validator(v1.address, v1.pub_key, 99)])
    assert vs.get_by_address(v1.address)[1].voting_power == 99
    with pytest.raises(P.ValidationError, match="removing unknown validator"):
        vs.apply_changes([P.Validator(target.address, target.pub_key, 0)])


def test_duplicate_address_rejected():
    vs, _ = make_validators(2)
    with pytest.raises(P.ValidationError, match="duplicate validator address"):
        P.ValidatorSet(list(vs.validators) + [vs.validators[0]])


def test_verify_commit_any_requires_new_set_quorum():
    vs, privs = make_validators(4)
    whale = P.PrivValidator(det_priv_keys(5)[4])
    new_vs = P.ValidatorSet(list(vs.validators) + [P.Validator(whale.address, whale.pub_key, 120)])
    bid = make_block_id()
    precommits = [None] * new_vs.size()
    for i, val in enumerate(new_vs.validators):
        if vs.has_address(val.address):
            p = next(p for p in privs if p.address == val.address)
            precommits[i] = signed_vote(p, i, 9, 0, P.VOTE_TYPE_PRECOMMIT, bid)
    commit = P.Commit(block_id=bid, precommits=precommits)
    with pytest.raises(P.ValidationError, match="insufficient new voting power: 40 of 160"):
        vs.verify_commit_any(new_vs, CHAIN_ID, bid, 9, commit, verifier=HOST)


# -- tests/test_vote_set.py -----------------------------------------------


def new_set(n=4, height=1, round_=0, type_=P.VOTE_TYPE_PREVOTE, power=10):
    vs, privs = make_validators(n, power)
    return P.VoteSet(CHAIN_ID, height, round_, type_, vs), privs


def test_quorum_exact_two_thirds_plus_one():
    vote_set, privs = new_set()
    bid = make_block_id()
    for i in range(2):
        vote_set.add_vote(signed_vote(privs[i], i, 1, 0, P.VOTE_TYPE_PREVOTE, bid), verifier=HOST)
        assert not vote_set.has_two_thirds_majority()
    vote_set.add_vote(signed_vote(privs[2], 2, 1, 0, P.VOTE_TYPE_PREVOTE, bid), verifier=HOST)
    assert vote_set.has_two_thirds_majority() and vote_set.two_thirds_majority() == bid


def test_nil_votes_count_toward_any_not_majority():
    vote_set, privs = new_set()
    nil = P.BlockID.zero()
    for i in range(3):
        vote_set.add_vote(signed_vote(privs[i], i, 1, 0, P.VOTE_TYPE_PREVOTE, nil), verifier=HOST)
    assert vote_set.has_two_thirds_any() and vote_set.two_thirds_majority() == nil


def test_split_votes_no_majority():
    vote_set, privs = new_set()
    a, b = make_block_id(b"a"), make_block_id(b"b")
    for i, bid in enumerate((a, a, b, b)):
        vote_set.add_vote(signed_vote(privs[i], i, 1, 0, P.VOTE_TYPE_PREVOTE, bid), verifier=HOST)
    assert vote_set.has_two_thirds_any() and not vote_set.has_two_thirds_majority()
    assert vote_set.has_all()


def test_duplicate_vote_not_added():
    vote_set, privs = new_set()
    v = signed_vote(privs[0], 0, 1, 0, P.VOTE_TYPE_PREVOTE, make_block_id(), timestamp=123)
    assert vote_set.add_vote(v, verifier=HOST)
    assert not vote_set.add_vote(v, verifier=HOST)


def test_conflicting_vote_raises_evidence():
    vote_set, privs = new_set()
    a, b = make_block_id(b"a"), make_block_id(b"b")
    vote_set.add_vote(byzantine_signed_vote(privs[0], 0, 1, 0, P.VOTE_TYPE_PREVOTE, a), verifier=HOST)
    with pytest.raises(P.ErrVoteConflictingVotes) as ei:
        vote_set.add_vote(byzantine_signed_vote(privs[0], 0, 1, 0, P.VOTE_TYPE_PREVOTE, b), verifier=HOST)
    assert ei.value.vote_a.block_id == a and ei.value.vote_b.block_id == b


def test_conflicting_vote_tracked_after_peer_maj23():
    vote_set, privs = new_set()
    a, b = make_block_id(b"a"), make_block_id(b"b")
    vote_set.add_vote(byzantine_signed_vote(privs[0], 0, 1, 0, P.VOTE_TYPE_PREVOTE, a), verifier=HOST)
    vote_set.set_peer_maj23("peer1", b)
    with pytest.raises(P.ErrVoteConflictingVotes):
        vote_set.add_vote(byzantine_signed_vote(privs[0], 0, 1, 0, P.VOTE_TYPE_PREVOTE, b), verifier=HOST)
    ba = vote_set.bit_array_by_block_id(b)
    assert ba is not None and ba.get(0)


def test_wrong_height_round_type_rejected():
    vote_set, privs = new_set(height=5, round_=2)
    bid = make_block_id()
    for h, r, t in ((4, 2, P.VOTE_TYPE_PREVOTE), (5, 1, P.VOTE_TYPE_PREVOTE), (5, 2, P.VOTE_TYPE_PRECOMMIT)):
        with pytest.raises(P.ErrVoteUnexpectedStep):
            vote_set.add_vote(signed_vote(privs[0], 0, h, r, t, bid), verifier=HOST)


def test_wrong_address_rejected():
    vote_set, privs = new_set()
    with pytest.raises(P.ErrVoteInvalidValidatorAddress):
        vote_set.add_vote(signed_vote(privs[1], 0, 1, 0, P.VOTE_TYPE_PREVOTE, make_block_id()), verifier=HOST)


def test_bad_signature_rejected():
    vote_set, privs = new_set()
    v = signed_vote(privs[0], 0, 1, 0, P.VOTE_TYPE_PREVOTE, make_block_id())
    with pytest.raises(P.ErrVoteInvalidSignature):
        vote_set.add_vote(v.with_signature(bytes(64)), verifier=HOST)


def test_make_commit():
    vote_set, privs = new_set(type_=P.VOTE_TYPE_PRECOMMIT)
    bid = make_block_id()
    for i in range(3):
        vote_set.add_vote(signed_vote(privs[i], i, 1, 0, P.VOTE_TYPE_PRECOMMIT, bid), verifier=HOST)
    commit = vote_set.make_commit()
    assert commit.block_id == bid and commit.size() == 4
    assert sum(1 for v in commit.precommits if v is not None) == 3
    commit.validate_basic()


def test_make_commit_requires_majority():
    vote_set, _ = new_set(type_=P.VOTE_TYPE_PRECOMMIT)
    with pytest.raises(P.ValidationError, match="cannot MakeCommit without"):
        vote_set.make_commit()
    with pytest.raises(P.ValidationError, match="from a prevote set"):
        new_set()[0].make_commit()


def test_66_percent_is_not_enough():
    vs, privs = make_validators(3, power=10)
    vote_set = P.VoteSet(CHAIN_ID, 1, 0, P.VOTE_TYPE_PREVOTE, vs)
    bid = make_block_id()
    for i in range(2):
        vote_set.add_vote(signed_vote(privs[i], i, 1, 0, P.VOTE_TYPE_PREVOTE, bid), verifier=HOST)
    assert not vote_set.has_two_thirds_majority()
    vote_set.add_vote(signed_vote(privs[2], 2, 1, 0, P.VOTE_TYPE_PREVOTE, bid), verifier=HOST)
    assert vote_set.has_two_thirds_majority()


# -- evidence: test_evidence.py's TestDuplicateVoteEvidence -----------------

PRIV = PrivKey(b"\x07" * 32)


def ev_vote(priv=PRIV, height=3, round_=0, block_hash=b"\xaa" * 20, timestamp=123):
    vote = P.Vote(validator_address=priv.pub_key.address, validator_index=0, height=height, round=round_,
                  timestamp=timestamp, type=P.VOTE_TYPE_PRECOMMIT,
                  block_id=P.BlockID(block_hash, P.PartSetHeader.zero()))
    return vote.with_signature(priv.sign(vote.sign_bytes(CHAIN_ID)))


def dup_evidence(priv=PRIV, height=3):
    return DuplicateVoteEvidence.make(ev_vote(priv, height, block_hash=b"\xaa" * 20),
                                      ev_vote(priv, height, block_hash=b"\xbb" * 20))


def ev_valset(*privs):
    return P.ValidatorSet([P.Validator(p.pub_key.address, p.pub_key, 10) for p in privs])


class _Recorder(V.HostBatchVerifier):
    def __init__(self):
        super().__init__()
        self.calls = []

    def verify_batch(self, triples):
        self.calls.append(len(triples))
        return super().verify_batch(triples)


def test_canonical_order_makes_detection_order_irrelevant():
    a, b = ev_vote(block_hash=b"\xaa" * 20), ev_vote(block_hash=b"\xbb" * 20)
    assert DuplicateVoteEvidence.make(a, b).hash() == DuplicateVoteEvidence.make(b, a).hash()


def test_evidence_roundtrip():
    ev = dup_evidence()
    assert decode_evidence(ev.encode()) == ev


def test_unknown_tag_rejected():
    with pytest.raises(P.ValidationError, match="unknown evidence tag 0x7f"):
        decode_evidence(b"\x7f\x00")


def test_validate_rejects_agreeing_votes():
    a = ev_vote()
    with pytest.raises(P.ValidationError, match="no conflict"):
        DuplicateVoteEvidence(vote_a=a, vote_b=a).validate_basic()


def test_validate_rejects_cross_validator_pairs():
    with pytest.raises(P.ValidationError, match="different validators"):
        DuplicateVoteEvidence.make(ev_vote(PRIV), ev_vote(PrivKey(b"\x08" * 32), block_hash=b"\xbb" * 20)).validate_basic()


def test_validate_rejects_cross_step_pairs():
    with pytest.raises(P.ValidationError, match="different steps"):
        DuplicateVoteEvidence.make(ev_vote(height=3), ev_vote(height=4, block_hash=b"\xbb" * 20)).validate_basic()


def test_verify_runs_one_two_lane_batch():
    rec = _Recorder()
    dup_evidence().verify(CHAIN_ID, ev_valset(PRIV), verifier=rec)
    assert rec.calls == [2]


def test_verify_rejects_forged_signature():
    ev = DuplicateVoteEvidence.make(ev_vote(), ev_vote(block_hash=b"\xbb" * 20).with_signature(bytes(64)))
    with pytest.raises(P.ValidationError, match="forged"):
        ev.verify(CHAIN_ID, ev_valset(PRIV), verifier=HOST)


def test_verify_rejects_unknown_validator():
    with pytest.raises(P.ValidationError, match="not in validator set"):
        dup_evidence().verify(CHAIN_ID, ev_valset(PrivKey(b"\x09" * 32)))


def test_batch_verify_many_proofs_one_launch():
    rec = _Recorder()
    verify_evidence_batch(CHAIN_ID, [dup_evidence(height=h) for h in (2, 3, 4)], [ev_valset(PRIV)], verifier=rec)
    assert rec.calls == [6]


# -- differential: encodings, hashes, proposer rotation ---------------------


def _vote_fields(rng):
    return dict(
        validator_address=rng.bytes(20), validator_index=int(rng.integers(0, 10**4)),
        height=int(rng.integers(1, 2**62)), round=int(rng.integers(0, 2**20)),
        timestamp=int(rng.integers(-(2**62), 2**62)), type=int(rng.integers(1, 3)),
        signature=rng.bytes(int(rng.choice([0, 64]))),
    )


def _bid(pkg, rng):
    return pkg.BlockID(rng.bytes(int(rng.choice([0, 20, 32]))),
                       pkg.PartSetHeader(total=int(rng.integers(0, 2**16)), hash=rng.bytes(int(rng.choice([0, 20])))))


@pytest.mark.parametrize("seed", range(5))
def test_votes_and_commits_encode_sign_and_hash_as_the_jax_package_does(seed):
    rng = np.random.default_rng(500 + seed)
    chain = "".join(chr(int(c)) for c in rng.integers(33, 127, int(rng.integers(1, 30))))
    state = rng.bit_generator.state
    pbid = _bid(P, rng)
    rng.bit_generator.state = state
    jbid = _bid(J, rng)
    assert pbid.encode() == jbid.encode() and pbid.key() == jbid.key() and str(pbid) == str(jbid)
    pvotes, jvotes = [], []
    for _ in range(int(rng.integers(1, 12))):
        if rng.integers(0, 5) == 0:
            pvotes.append(None), jvotes.append(None)
            continue
        f = _vote_fields(rng)
        pv, jv = P.Vote(block_id=pbid, **f), J.Vote(block_id=jbid, **f)
        assert pv.encode() == jv.encode() and pv.sign_bytes(chain) == jv.sign_bytes(chain)
        assert str(pv) == str(jv) and P.Vote.decode(jv.encode()) == pv
        assert outcome(pv.validate_basic) == outcome(jv.validate_basic)
        pvotes.append(pv), jvotes.append(jv)
    pc, jc = P.Commit(block_id=pbid, precommits=pvotes), J.Commit(block_id=jbid, precommits=jvotes)
    assert pc.encode() == jc.encode() and pc.hash() == jc.hash()
    assert p_commit(jc).encode() == jc.encode()
    assert (pc.height(), pc.round(), pc.bit_array().to_int()) == (jc.height(), jc.round(), jc.bit_array().to_int())
    assert outcome(pc.validate_basic) == outcome(jc.validate_basic)


def _seeded_valset(rng, n):
    keys = [JPrivKey(rng.bytes(32)) for _ in range(n)]
    vals = [J.Validator(k.pub_key.address, k.pub_key, int(w)) for k, w in zip(keys, rng.integers(1, 100, n))]
    return J.ValidatorSet(vals)


@pytest.mark.parametrize("seed", range(4))
def test_validator_set_changes_hash_and_propose_as_the_jax_package_does(seed):
    """Seeded membership and power changes between runs of
    `increment_accum`: the same hashes, encodings, proposers (100 steps
    in all) and errors."""
    rng = np.random.default_rng(600 + seed)
    jvs = _seeded_valset(rng, int(rng.integers(1, 12)))
    pvs = p_valset(jvs)
    assert pvs.hash() == jvs.hash() and repr(pvs) == repr(jvs)
    assert pvs.proposer.address == jvs.proposer.address
    seq_p, seq_j = [], []
    for step in range(10):
        for _ in range(10):
            pvs.increment_accum(1), jvs.increment_accum(1)
            seq_p.append(pvs.proposer.address), seq_j.append(jvs.proposer.address)
        assert [(v.address, v.accum) for v in pvs] == [(v.address, v.accum) for v in jvs]
        changes = []
        for _ in range(int(rng.integers(0, 4))):
            kind = int(rng.integers(0, 4))
            if kind == 0 or len(jvs) < 2:  # add a new validator
                k = JPrivKey(rng.bytes(32))
                changes.append((k.pub_key.address, k.pub_key.data, int(rng.integers(1, 100))))
            elif kind == 1:  # remove one
                v = jvs.validators[int(rng.integers(0, len(jvs)))]
                changes.append((v.address, v.pub_key.data, 0))
            elif kind == 2:  # change a power
                v = jvs.validators[int(rng.integers(0, len(jvs)))]
                changes.append((v.address, v.pub_key.data, int(rng.integers(1, 100))))
            else:  # remove one the set does not hold
                changes.append((rng.bytes(20), JPrivKey(rng.bytes(32)).pub_key.data, 0))
        pc = [P.Validator(a, PubKey(k), w) for a, k, w in changes]
        jc = [J.Validator(a, JPubKey(k), w) for a, k, w in changes]
        assert outcome(lambda: pvs.apply_changes(pc)) == outcome(lambda: jvs.apply_changes(jc)), step
        # an invalid change list leaves both sets equally half-applied
        assert pvs.hash() == jvs.hash()
        assert [v.encode() for v in pvs] == [v.encode() for v in jvs]
        assert pvs.total_voting_power == jvs.total_voting_power
    assert seq_p == seq_j and len(seq_p) == 100
    assert pvs.copy().hash() == jvs.copy().hash()


@pytest.mark.parametrize("seed", range(3))
def test_evidence_encodes_and_hashes_as_the_jax_package_does(seed):
    rng = np.random.default_rng(700 + seed)
    key = rng.bytes(32)
    pk, jk = PrivKey(key), JPrivKey(key)
    evs_p, evs_j = [], []
    for _ in range(int(rng.integers(1, 5))):
        h, r, t = int(rng.integers(1, 10**6)), int(rng.integers(0, 5)), int(rng.integers(1, 3))
        pair = []
        for _side in range(2):
            f = dict(validator_address=pk.pub_key.address, validator_index=3, height=h, round=r,
                     timestamp=int(rng.integers(0, 2**40)), type=t)
            hsh, total, phash = rng.bytes(20), int(rng.integers(0, 4)), rng.bytes(20)
            pv = P.Vote(block_id=P.BlockID(hsh, P.PartSetHeader(total, phash)), **f)
            jv = J.Vote(block_id=J.BlockID(hsh, J.PartSetHeader(total, phash)), **f)
            pair.append((pv.with_signature(pk.sign(pv.sign_bytes(CHAIN_ID))),
                         jv.with_signature(jk.sign(jv.sign_bytes(CHAIN_ID)))))
        (pa, ja), (pb, jb) = pair
        pe, je = DuplicateVoteEvidence.make(pb, pa), J_evidence.DuplicateVoteEvidence.make(jb, ja)
        assert pe.encode() == je.encode() and pe.hash() == je.hash() and str(pe) == str(je)
        assert decode_evidence(je.encode()) == pe
        evs_p.append(pe), evs_j.append(je)
    assert P_evidence.evidence_hash(evs_p) == J_evidence.evidence_hash(evs_j)


@pytest.mark.parametrize("seed", range(3))
def test_vote_sets_tally_as_the_jax_package_does(seed):
    """A seeded stream of votes, Byzantine ones and forgeries included,
    into both packages' vote sets: every add gives the same outcome and
    leaves the same tallies; a commit, when there is one, encodes alike."""
    rng = np.random.default_rng(800 + seed)
    n = int(rng.integers(3, 7))
    keys = [JPrivKey(rng.bytes(32)) for _ in range(n)]
    jvs = J.ValidatorSet([J.Validator(k.pub_key.address, k.pub_key, int(w)) for k, w in zip(keys, rng.integers(1, 20, n))])
    by_addr = {k.pub_key.address: k for k in keys}
    ordered = [by_addr[v.address] for v in jvs.validators]
    type_ = int(rng.integers(1, 3))
    jset = J.VoteSet(CHAIN_ID, 4, 1, type_, jvs)
    pset = P.VoteSet(CHAIN_ID, 4, 1, type_, p_valset(jvs))
    blocks = [J.BlockID(bytes([c]) * 32, J.PartSetHeader(1, bytes([c]) * 20)) for c in (1, 2)] + [J.BlockID.zero()]
    jhost = JHostVerifier()
    for step in range(4 * n):
        if rng.integers(0, 6) == 0:
            b = blocks[int(rng.integers(0, 3))]
            peer = f"peer{int(rng.integers(0, 3))}"
            jset.set_peer_maj23(peer, b)
            pset.set_peer_maj23(peer, p_block_id(b))
        i = int(rng.integers(0, n))
        idx = i if rng.integers(0, 8) else int(rng.integers(0, n + 2))
        vote = J.Vote(ordered[i].pub_key.address, idx, 4, int(rng.choice([1, 1, 1, 1, 2])),
                      int(rng.integers(0, 3)), type_, blocks[int(rng.integers(0, 3))])
        vote = vote.with_signature(ordered[i].sign(vote.sign_bytes(CHAIN_ID)))
        if rng.integers(0, 8) == 0:
            vote = vote.with_signature(bytes([vote.signature[0] ^ 1]) + vote.signature[1:])
        added = {}
        got = outcome(lambda: added.setdefault("port", pset.add_vote(p_vote(vote), verifier=HOST)))
        want = outcome(lambda: added.setdefault("jax", jset.add_vote(vote, verifier=jhost)))
        assert got == want and added.get("port") == added.get("jax"), step
        assert (pset.sum, pset.bit_array().to_int(), pset.has_two_thirds_any(), pset.has_all()) == (
            jset.sum, jset.bit_array().to_int(), jset.has_two_thirds_any(), jset.has_all())
        pm, jm = pset.two_thirds_majority(), jset.two_thirds_majority()
        assert (pm and pm.encode()) == (jm and jm.encode())
        assert repr(pset) == repr(jset)
    if type_ == J.VOTE_TYPE_PRECOMMIT and jset.has_two_thirds_majority():
        assert pset.make_commit().encode() == jset.make_commit().encode()
    assert outcome(pset.make_commit) == outcome(jset.make_commit) or jset.has_two_thirds_majority()


# -- the verification matrix ------------------------------------------------

N_VALS = 7
MATRIX_HEIGHT = 11


@pytest.fixture(scope="module")
def chain():
    """A 7-validator JAX chain (uneven powers) and its commits, each
    planted with one fault, as (block_id, height, commit) entries; the
    same set rebuilt in the port."""
    keys = [JPrivKey(bytes([i]) * 32) for i in range(1, N_VALS + 1)]
    powers = [10, 20, 10, 30, 10, 10, 20]  # 110 in all: quorum > 73.3
    jvs = J.ValidatorSet([J.Validator(k.pub_key.address, k.pub_key, w) for k, w in zip(keys, powers)])
    by_addr = {k.pub_key.address: k for k in keys}
    ordered = [by_addr[v.address] for v in jvs.validators]

    def commit(height, tag, signers, round_of=lambda i: 0):
        bid = J.BlockID(bytes([tag]) * 32, J.PartSetHeader(2, bytes([tag + 1]) * 20))
        pre = [None] * N_VALS
        for i in signers:
            v = J.Vote(jvs.validators[i].address, i, height, round_of(i), 1000 + i, J.VOTE_TYPE_PRECOMMIT, bid)
            pre[i] = v.with_signature(ordered[i].sign(v.sign_bytes(CHAIN_ID)))
        return bid, height, J.Commit(block_id=bid, precommits=pre)

    everyone = range(N_VALS)
    good = commit(MATRIX_HEIGHT, 0x30, everyone)
    forged = commit(MATRIX_HEIGHT, 0x30, everyone)
    forged[2].precommits[4] = forged[2].precommits[4].with_signature(bytes(64))
    # the absent vote leaves 90 of 110: still a quorum
    absent = commit(MATRIX_HEIGHT, 0x30, [i for i in everyone if i != 1])
    wrong_round = commit(MATRIX_HEIGHT, 0x30, everyone, round_of=lambda i: int(i == 5))
    # 10 + 30 + 10 + 20 = 70 of 110: too little
    low_power = commit(MATRIX_HEIGHT, 0x30, [2, 3, 4, 6])
    cases = {
        "good": (good, MATRIX_HEIGHT),
        "forged": (forged, MATRIX_HEIGHT),
        "absent": (absent, MATRIX_HEIGHT),
        "wrong_height": (good, MATRIX_HEIGHT + 1),
        "wrong_round": (wrong_round, MATRIX_HEIGHT),
        "low_power": (low_power, MATRIX_HEIGHT),
    }
    window_head = commit(MATRIX_HEIGHT - 1, 0x40, everyone)
    return jvs, cases, window_head


@pytest.fixture(scope="module")
def stacks():
    """The port's default stack on the CPU at the default minimum batch
    and at 0; each call gets a fresh coalescer (an empty signature cache)
    over the stack's resilient layer and tables."""
    saved = dict(V._DEFAULTS)
    out = {}
    for name, min_batch in (("port-stack", None), ("port-chains", 0)):
        V._DEFAULTS.clear()
        stack = V.default_verifier(device="cpu")
        if min_batch is not None:
            stack.inner.primary._min_batch = min_batch
        out[name] = stack
    V._DEFAULTS.clear()
    V._DEFAULTS.update(saved)
    yield out
    for stack in out.values():
        stack.close()


def _port_verifiers(stacks):
    yield "port-host", HOST, None
    for name, stack in stacks.items():
        v = CoalescingVerifier(stack.inner)
        yield name, v, v


def _run(api, vs, entry, height, head, verifier):
    (bid, _h, commit), (hbid, hh, hcommit) = entry, head
    if api == "verify_commit":
        return lambda: vs.verify_commit(CHAIN_ID, bid, height, commit, verifier=verifier)
    if api == "batched":
        return lambda: vs.verify_commit_batched(CHAIN_ID, [(hbid, hh, hcommit), (bid, height, commit)], verifier=verifier)
    if api == "batched_async":
        return lambda: vs.verify_commit_batched_async(
            CHAIN_ID, [(hbid, hh, hcommit), (bid, height, commit)], verifier=verifier, consumer="fastsync").result()
    return lambda: vs.verify_commit_any(vs, CHAIN_ID, bid, height, commit, verifier=verifier, consumer="light")


@pytest.mark.parametrize("api", ["verify_commit", "batched", "batched_async", "verify_commit_any"])
@pytest.mark.parametrize("case", ["good", "forged", "absent", "wrong_height", "wrong_round", "low_power"])
def test_verification_outcomes_match_the_jax_package(chain, stacks, case, api):
    jvs, cases, head = chain
    (bid, h, commit), height = cases[case]
    want = outcome(_run(api, jvs, (bid, h, commit), height, head, JHostVerifier()))
    assert (want is None) == (case in ("good", "absent"))
    pvs = p_valset(jvs)
    entry = (p_block_id(bid), h, p_commit(commit))
    phead = (p_block_id(head[0]), head[1], p_commit(head[2]))
    for name, verifier, coalescer in _port_verifiers(stacks):
        try:
            got = outcome(_run(api, pvs, entry, height, phead, verifier))
        finally:
            if coalescer is not None:
                coalescer.coalescer.close()
        assert got == want, name
    for name, stack in stacks.items():
        snap = stack.inner.snapshot()
        assert snap["fallback_calls"] == 0 and snap["total_failures"] == 0, name


@pytest.fixture(scope="module")
def evidence_cases():
    """JAX proofs against a 4-validator set: good ones, a forged vote, an
    offender outside the set, a pair of different steps, agreeing votes."""
    keys = [JPrivKey(bytes([0x20 + i]) * 32) for i in range(4)]
    stranger = JPrivKey(b"\x2f" * 32)
    jvs = J.ValidatorSet([J.Validator(k.pub_key.address, k.pub_key, 10) for k in keys])

    def vote(key, height, tag, round_=0):
        v = J.Vote(key.pub_key.address, 0, height, round_, 5, J.VOTE_TYPE_PREVOTE,
                   J.BlockID(bytes([tag]) * 20, J.PartSetHeader.zero()))
        return v.with_signature(key.sign(v.sign_bytes(CHAIN_ID)))

    def dup(key, height, round_b=0):
        return J_evidence.DuplicateVoteEvidence.make(vote(key, height, 0xA1), vote(key, height, 0xB2, round_b))

    good = [dup(keys[i], 3 + i) for i in range(3)]
    forged = J_evidence.DuplicateVoteEvidence(vote_a=good[1].vote_a, vote_b=good[1].vote_b.with_signature(bytes(64)))
    agree = J_evidence.DuplicateVoteEvidence(vote_a=good[2].vote_a, vote_b=good[2].vote_a)
    return jvs, {
        "good": good,
        "forged": [good[0], forged, good[2]],
        "unknown": [good[0], dup(stranger, 4)],
        "steps": [dup(keys[3], 6, round_b=1)],
        "agreeing": [good[0], agree],
    }


@pytest.mark.parametrize("api", ["verify", "verify_evidence_batch"])
@pytest.mark.parametrize("case", ["good", "forged", "unknown", "steps", "agreeing"])
def test_evidence_outcomes_match_the_jax_package(evidence_cases, stacks, case, api):
    jvs, cases = evidence_cases
    jevs = cases[case]

    def run(mod, evs, vs, verifier):
        if api == "verify":
            return lambda: [ev.verify(CHAIN_ID, vs, verifier=verifier) for ev in evs]
        return lambda: mod.verify_evidence_batch(CHAIN_ID, evs, [None, vs], verifier=verifier)

    want = outcome(run(J_evidence, jevs, jvs, JHostVerifier()))
    assert (want is None) == (case == "good")
    pevs = [decode_evidence(ev.encode()) for ev in jevs]
    for name, verifier, coalescer in _port_verifiers(stacks):
        try:
            got = outcome(run(P_evidence, pevs, p_valset(jvs), verifier))
        finally:
            if coalescer is not None:
                coalescer.coalescer.close()
        assert got == want, name


# -- the default verifier ---------------------------------------------------


def test_missing_verifier_is_the_card_stack_and_raises_without_a_card(chain, evidence_cases, monkeypatch):
    """`verifier=None` reaches the port's `default_verifier()`, the card's
    stack: without a card every such call raises, and none answers on
    the host (the JAX package's default would be its host verifier)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(V, "_DEFAULTS", {})
    jvs, cases, head = chain
    (bid, h, commit), height = cases["good"]
    pvs = p_valset(jvs)
    entry = (p_block_id(bid), h, p_commit(commit))
    phead = (p_block_id(head[0]), head[1], p_commit(head[2]))
    ejvs, ecases = evidence_cases
    pev = decode_evidence(ecases["good"][0].encode())
    vote_set = P.VoteSet(CHAIN_ID, h, 0, P.VOTE_TYPE_PRECOMMIT, pvs)
    calls = [_run(api, pvs, entry, height, phead, None)
             for api in ("verify_commit", "batched", "batched_async", "verify_commit_any")]
    calls += [
        lambda: vote_set.add_vote(entry[2].precommits[0]),
        lambda: pev.verify(CHAIN_ID, p_valset(ejvs)),
        lambda: verify_evidence_batch(CHAIN_ID, [pev], [p_valset(ejvs)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()
    assert V._DEFAULTS == {}
    # with the verifier given, the same calls answer
    _run("verify_commit", pvs, entry, height, phead, HOST)()
    assert vote_set.add_vote(entry[2].precommits[0], verifier=HOST)
