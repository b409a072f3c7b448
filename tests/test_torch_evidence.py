"""The port's evidence pool and reactor (`tendermint_tpu_torch/evidence/`)
against the JAX package's.

The JAX package's own `tests/test_evidence.py` runs again on the port:
`DuplicateVoteEvidence` (canonical order, encoding, the checks, the
proof's two signatures as one batch), the params, evidence in blocks,
the pool (dedup, callbacks, retirement, expiry, its WAL across a
restart and a torn tail) and evidence through `validate_block` and
`BeginBlock`, on the port's `HostBatchVerifier`.

Across the packages, seeded: the same evidence sequence into a JAX and
a port `EvidencePool` gives the same admissions, exceptions (class name
and message), pending lists, encodings and WAL bytes; the evidence
reactor's messages encode alike. Tolerance: exact.
"""

from __future__ import annotations

import os

import pytest

from tendermint_tpu_torch.crypto import PrivKey
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.testing import TEST_CHAIN_ID as CHAIN_ID, ChainSim, lockrank_report, time_limit_fixture
from tendermint_tpu_torch.types.block import Block, Commit, EvidenceData
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    decode_evidence,
    evidence_hash,
    verify_evidence_batch,
)
from tendermint_tpu_torch.types.params import ConsensusParams, EvidenceParams
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.types.tx import Txs
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))


# -- tests/test_evidence.py ----------------------------------------------------------


PRIV = PrivKey(b"\x07" * 32)


def signed_vote(
    priv=PRIV,
    height=3,
    round_=0,
    type_=VOTE_TYPE_PRECOMMIT,
    block_hash=b"\xaa" * 20,
    index=0,
    chain_id=CHAIN_ID,
    timestamp=123,
):
    vote = Vote(
        validator_address=priv.pub_key.address,
        validator_index=index,
        height=height,
        round=round_,
        timestamp=timestamp,
        type=type_,
        block_id=BlockID(block_hash, PartSetHeader.zero()),
    )
    return vote.with_signature(priv.sign(vote.sign_bytes(chain_id)))


def duplicate_vote_evidence(priv=PRIV, height=3, chain_id=CHAIN_ID):
    return DuplicateVoteEvidence.make(
        signed_vote(priv, height=height, block_hash=b"\xaa" * 20, chain_id=chain_id),
        signed_vote(priv, height=height, block_hash=b"\xbb" * 20, chain_id=chain_id),
    )


class _ValSet:
    """Minimal validator-set stand-in for unit verification."""

    def __init__(self, privs):
        import types as _t

        self._vals = {
            p.pub_key.address: _t.SimpleNamespace(
                address=p.pub_key.address, pub_key=p.pub_key, voting_power=10
            )
            for p in privs
        }

    def size(self):
        return len(self._vals)

    def get_by_address(self, address):
        val = self._vals.get(address)
        if val is None:
            return -1, None
        return 0, val


class TestDuplicateVoteEvidence:
    def test_canonical_order_makes_detection_order_irrelevant(self):
        a = signed_vote(block_hash=b"\xaa" * 20)
        b = signed_vote(block_hash=b"\xbb" * 20)
        assert (
            DuplicateVoteEvidence.make(a, b).hash()
            == DuplicateVoteEvidence.make(b, a).hash()
        )

    def test_roundtrip(self):
        ev = duplicate_vote_evidence()
        assert decode_evidence(ev.encode()) == ev

    def test_unknown_tag_rejected(self):
        with pytest.raises(ValidationError):
            decode_evidence(b"\x7f\x00")

    def test_validate_rejects_agreeing_votes(self):
        a = signed_vote(block_hash=b"\xaa" * 20)
        with pytest.raises(ValidationError, match="no conflict"):
            DuplicateVoteEvidence(vote_a=a, vote_b=a).validate_basic()

    def test_validate_rejects_cross_validator_pairs(self):
        other = PrivKey(b"\x08" * 32)
        with pytest.raises(ValidationError, match="different validators"):
            DuplicateVoteEvidence.make(
                signed_vote(PRIV, block_hash=b"\xaa" * 20),
                signed_vote(other, block_hash=b"\xbb" * 20),
            ).validate_basic()

    def test_validate_rejects_cross_step_pairs(self):
        with pytest.raises(ValidationError, match="different steps"):
            DuplicateVoteEvidence.make(
                signed_vote(height=3, block_hash=b"\xaa" * 20),
                signed_vote(height=4, block_hash=b"\xbb" * 20),
            ).validate_basic()

    def test_verify_runs_one_two_lane_batch(self):
        """The proof's two signatures verify as ONE 2-lane batch through
        the BatchVerifier seam (ISSUE 9 tentpole requirement)."""
        calls = []

        class Recorder(HostBatchVerifier):
            def verify_batch(self, triples):
                calls.append(len(triples))
                return super().verify_batch(triples)

        ev = duplicate_vote_evidence()
        ev.verify(CHAIN_ID, _ValSet([PRIV]), verifier=Recorder())
        assert calls == [2]

    def test_verify_rejects_forged_signature(self):
        a = signed_vote(block_hash=b"\xaa" * 20)
        b = signed_vote(block_hash=b"\xbb" * 20)
        forged = Vote(
            validator_address=b.validator_address,
            validator_index=b.validator_index,
            height=b.height,
            round=b.round,
            timestamp=b.timestamp,
            type=b.type,
            block_id=b.block_id,
            signature=bytes(64),
        )
        ev = DuplicateVoteEvidence.make(a, forged)
        with pytest.raises(ValidationError, match="forged"):
            ev.verify(CHAIN_ID, _ValSet([PRIV]), verifier=HostBatchVerifier())

    def test_verify_rejects_unknown_validator(self):
        ev = duplicate_vote_evidence()
        with pytest.raises(ValidationError, match="not in validator set"):
            ev.verify(CHAIN_ID, _ValSet([PrivKey(b"\x09" * 32)]))

    def test_batch_verify_many_proofs_one_launch(self):
        calls = []

        class Recorder(HostBatchVerifier):
            def verify_batch(self, triples):
                calls.append(len(triples))
                return super().verify_batch(triples)

        evs = [duplicate_vote_evidence(height=h) for h in (2, 3, 4)]
        verify_evidence_batch(
            CHAIN_ID, evs, [_ValSet([PRIV])], verifier=Recorder()
        )
        assert calls == [6]  # 3 proofs x 2 lanes, ONE launch


class TestEvidenceParams:
    def test_dict_roundtrip(self):
        p = ConsensusParams()
        p.evidence = EvidenceParams(max_age=7, max_evidence=3)
        again = ConsensusParams.from_dict(p.to_dict())
        assert again.evidence.max_age == 7
        assert again.evidence.max_evidence == 3

    def test_legacy_dict_defaults(self):
        p = ConsensusParams.from_dict({"block_size": {"max_txs": 5}})
        assert p.evidence.max_age == EvidenceParams().max_age

    def test_validate_rejects_nonpositive_age(self):
        p = ConsensusParams()
        p.evidence = EvidenceParams(max_age=0)
        with pytest.raises(ValidationError):
            p.validate()


class TestBlockEvidence:
    def _block(self, evidence=None):
        return Block.make_block(
            height=1,
            chain_id=CHAIN_ID,
            txs=Txs([b"t1"]),
            last_commit=Commit.empty(),
            last_block_id=BlockID.zero(),
            time=1,
            validators_hash=b"\x01" * 20,
            app_hash=b"",
            evidence=evidence,
        )

    def test_evidence_free_block_keeps_legacy_wire_and_hash(self):
        """Backward compatibility: no evidence -> byte-identical wire
        form and header hash, so stored history stays decodable and
        hash-stable across this PR."""
        b = self._block()
        assert b.header.evidence_hash == b""
        decoded = Block.decode(b.encode())
        assert decoded.hash() == b.hash()
        assert len(decoded.evidence) == 0

    def test_evidence_changes_header_hash_and_roundtrips(self):
        ev = duplicate_vote_evidence(height=1)
        b = self._block(evidence=[ev])
        assert b.header.evidence_hash == evidence_hash([ev])
        assert b.hash() != self._block().hash()
        decoded = Block.decode(b.encode())
        assert decoded.hash() == b.hash()
        assert list(decoded.evidence) == [ev]
        decoded.validate_basic()

    def test_tampered_evidence_fails_validate_basic(self):
        ev = duplicate_vote_evidence(height=1)
        b = self._block(evidence=[ev])
        b.evidence = EvidenceData(evidence=[])  # strip after header fill
        with pytest.raises(ValidationError, match="evidence_hash"):
            b.validate_basic()


class TestEvidencePool:
    def test_add_dedup_and_callback(self, tmp_path):
        pool = EvidencePool(verifier=HostBatchVerifier(), chain_id=CHAIN_ID)
        seen = []
        pool.on_evidence_added = seen.append
        ev = duplicate_vote_evidence()
        assert pool.add_evidence(ev, val_set=_ValSet([PRIV]))
        assert not pool.add_evidence(ev, val_set=_ValSet([PRIV]))  # dup
        assert pool.depth() == 1 and seen == [ev]
        assert pool.pending_evidence() == [ev]

    def test_invalid_evidence_raises(self):
        pool = EvidencePool(verifier=HostBatchVerifier(), chain_id=CHAIN_ID)
        a = signed_vote(block_hash=b"\xaa" * 20)
        bad = Vote(
            validator_address=a.validator_address,
            validator_index=0,
            height=a.height,
            round=0,
            timestamp=9,
            type=a.type,
            block_id=BlockID(b"\xbb" * 20, PartSetHeader.zero()),
            signature=bytes(64),
        )
        with pytest.raises(ValidationError):
            pool.add_evidence(
                DuplicateVoteEvidence.make(a, bad), val_set=_ValSet([PRIV])
            )
        assert pool.depth() == 0

    def test_update_retires_committed_and_prunes_expired(self):
        pool = EvidencePool(
            params=EvidenceParams(max_age=5),
            verifier=HostBatchVerifier(),
            chain_id=CHAIN_ID,
        )
        committed = duplicate_vote_evidence(height=9)
        stale = duplicate_vote_evidence(height=2)
        vs = _ValSet([PRIV])
        pool.add_evidence(committed, val_set=vs)
        pool.add_evidence(stale, val_set=vs)
        assert pool.depth() == 2
        pool.update(10, [committed])  # height 2 is now > max_age old
        assert pool.depth() == 0
        assert pool.has(committed)  # remembered, not re-addable
        assert not pool.add_evidence(committed, val_set=vs)

    def test_wal_survives_restart_and_skips_committed(self, tmp_path):
        wal = str(tmp_path / "evidence.wal")
        vs = _ValSet([PRIV])
        pool = EvidencePool(wal_path=wal, verifier=HostBatchVerifier(), chain_id=CHAIN_ID)
        keep = duplicate_vote_evidence(height=4)
        done = duplicate_vote_evidence(height=3)
        pool.add_evidence(keep, val_set=vs)
        pool.add_evidence(done, val_set=vs)
        pool.update(5, [done])
        pool.close()

        reopened = EvidencePool(
            wal_path=wal, verifier=HostBatchVerifier(), chain_id=CHAIN_ID
        )
        assert reopened.pending_evidence() == [keep]
        assert reopened.has(done)  # committed marker replayed
        reopened.close()

    def test_torn_wal_tail_truncated(self, tmp_path):
        wal = str(tmp_path / "evidence.wal")
        pool = EvidencePool(wal_path=wal, verifier=HostBatchVerifier(), chain_id=CHAIN_ID)
        ev = duplicate_vote_evidence(height=4)
        pool.add_evidence(ev, val_set=_ValSet([PRIV]))
        pool.close()
        size = os.path.getsize(wal)
        with open(wal, "ab") as f:
            f.write(b"\x01\xff\xff")  # torn partial record
        reopened = EvidencePool(
            wal_path=wal, verifier=HostBatchVerifier(), chain_id=CHAIN_ID
        )
        assert reopened.pending_evidence() == [ev]
        reopened.close()
        assert os.path.getsize(wal) == size  # tail healed

    def test_expired_at_admission_is_dropped_not_error(self):
        pool = EvidencePool(
            params=EvidenceParams(max_age=3),
            verifier=HostBatchVerifier(),
            chain_id=CHAIN_ID,
            best_height_fn=lambda: 100,
        )
        assert not pool.add_evidence(
            duplicate_vote_evidence(height=2), val_set=_ValSet([PRIV])
        )
        assert pool.depth() == 0


class TestBlockValidationAndBeginBlock:
    """Evidence through the real execution pipeline: validate_block's
    policy gate + batched proof verify, and BeginBlock reporting."""

    def _sim_with_evidence(self):
        sim = ChainSim(n_vals=4, verifier=HostBatchVerifier())
        sim.advance()
        # the proposing validator double-signs height 1
        offender = sim.privs[0]
        ev = DuplicateVoteEvidence.make(
            signed_vote(offender._signer._priv_key, height=1, block_hash=b"\xaa" * 20),
            signed_vote(offender._signer._priv_key, height=1, block_hash=b"\xbb" * 20),
        )
        return sim, ev

    def test_block_with_valid_evidence_applies_and_reports_to_app(self):
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.state.execution import apply_block

        class RecordingApp(KVStoreApp):
            def __init__(self):
                super().__init__()
                self.byzantine = []

            def begin_block(self, block_hash, header, evidence=()):
                self.byzantine.extend(evidence)
                return super().begin_block(block_hash, header)

        sim, ev = self._sim_with_evidence()
        app = RecordingApp()
        conns = local_client_creator(app)()
        block, parts = sim.make_next_block(evidence=[ev])
        apply_block(
            sim.state,
            block,
            parts.header,
            conns.consensus,
            verifier=HostBatchVerifier(),
        )
        assert app.byzantine == [ev]

    def test_legacy_two_arg_app_still_works(self):
        """Apps overriding the pre-evidence begin_block(hash, header)
        signature keep working — the client only passes evidence to apps
        that accept it."""
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.state.execution import apply_block

        class LegacyApp(KVStoreApp):
            def __init__(self):
                super().__init__()
                self.began = 0

            def begin_block(self, block_hash, header):
                self.began += 1

        sim, ev = self._sim_with_evidence()
        app = LegacyApp()
        conns = local_client_creator(app)()
        block, parts = sim.make_next_block(evidence=[ev])
        apply_block(
            sim.state,
            block,
            parts.header,
            conns.consensus,
            verifier=HostBatchVerifier(),
        )
        assert app.began == 1

    def test_validate_block_rejects_forged_evidence(self):
        from tendermint_tpu_torch.state.execution import validate_block

        sim, ev = self._sim_with_evidence()
        forged = DuplicateVoteEvidence(
            vote_a=ev.vote_a,
            vote_b=ev.vote_b.with_signature(bytes(64)),
        )
        block, _ = sim.make_next_block(evidence=[forged])
        with pytest.raises(ValidationError):
            validate_block(sim.state, block, verifier=HostBatchVerifier())

    def test_validate_block_rejects_expired_evidence(self):
        from tendermint_tpu_torch.state.execution import validate_block

        sim, ev = self._sim_with_evidence()
        sim.state.consensus_params.evidence = EvidenceParams(max_age=0)
        sim.advance()  # evidence height 1, block height 3: age > 0
        block, _ = sim.make_next_block(evidence=[ev])
        with pytest.raises(ValidationError, match="expired evidence"):
            validate_block(sim.state, block, verifier=HostBatchVerifier())

    def test_validate_block_rejects_over_cap_evidence(self):
        from tendermint_tpu_torch.state.execution import validate_block

        sim, ev = self._sim_with_evidence()
        sim.state.consensus_params.evidence = EvidenceParams(max_evidence=0)
        block, _ = sim.make_next_block(evidence=[ev])
        with pytest.raises(ValidationError, match="max 0"):
            validate_block(sim.state, block, verifier=HostBatchVerifier())


# -- across the packages ---------------------------------------------------------------


def _evidence_stream():
    """Wire forms of a seeded evidence sequence, made with the JAX
    package's types: valid proofs at several heights by two validators,
    a repeat, a forged signature, a cross-validator pair, one by a key
    outside the set, and one too old for `max_age`."""
    from tendermint_tpu.crypto import PrivKey as JPrivKey
    from tendermint_tpu.types.block_id import BlockID as JBlockID
    from tendermint_tpu.types.evidence import DuplicateVoteEvidence as JDuplicateVoteEvidence
    from tendermint_tpu.types.part_set import PartSetHeader as JPartSetHeader
    from tendermint_tpu.types.vote import Vote as JVote
    from tests.helpers import make_validators as j_make_validators

    _vs, privs = j_make_validators(4)

    def vote(key, idx, height, block_hash, sig=None):
        v = JVote(validator_address=key.pub_key.address, validator_index=idx, height=height, round=0,
                  timestamp=1000 + height, type=VOTE_TYPE_PRECOMMIT,
                  block_id=JBlockID(block_hash, JPartSetHeader.zero()))
        return v.with_signature(sig if sig is not None else key.sign(v.sign_bytes(CHAIN_ID)))

    def dup(key, idx, height, forge=False, other=None):
        b = vote(other or key, idx, height, b"\xbb" * 20, sig=bytes(64) if forge else None)
        return JDuplicateVoteEvidence.make(vote(key, idx, height, b"\xaa" * 20), b).encode()

    keys = [p._signer._priv_key for p in privs]
    stream = [dup(keys[1], 1, 6), dup(keys[2], 2, 7), dup(keys[1], 1, 6), dup(keys[1], 1, 8),
              dup(keys[3], 3, 7, forge=True), dup(keys[2], 2, 8, other=keys[3]),
              dup(JPrivKey(b"\x77" * 32), 0, 8), dup(keys[0], 0, 1), dup(keys[0], 0, 9)]
    return stream


def _pool_outcomes(pkg: str, stream, wal):
    import importlib

    pool_mod = importlib.import_module(pkg + ".evidence.pool")
    ev_mod = importlib.import_module(pkg + ".types.evidence")
    params = importlib.import_module(pkg + ".types.params")
    verifier = importlib.import_module(pkg + ".services.verifier")
    helpers = importlib.import_module("tests.helpers") if pkg == "tendermint_tpu" else importlib.import_module(
        pkg + ".testing")
    vs, _privs = helpers.make_validators(4)
    pool = pool_mod.EvidencePool(wal_path=str(wal), params=params.EvidenceParams(max_age=5),
                                 verifier=verifier.HostBatchVerifier(), chain_id=CHAIN_ID,
                                 best_height_fn=lambda: 10)
    out = {"added": []}
    try:
        for wire in stream:
            ev = ev_mod.decode_evidence(wire)
            try:
                out["added"].append(pool.add_evidence(ev, val_set=vs))
            except Exception as exc:  # the outcome is the class name and message
                out["added"].append((type(exc).__name__, str(exc)))
        out["pending"] = [e.encode() for e in pool.pending_evidence()]
        out["first2"] = [e.encode() for e in pool.pending_evidence(2)]
        out["depth"] = pool.depth()
        committed = [ev_mod.decode_evidence(stream[0])]
        pool.update(12, committed)
        out["after"] = [e.encode() for e in pool.pending_evidence()]
        out["has"] = [pool.has(ev_mod.decode_evidence(w)) for w in stream]
    finally:
        pool.close()
    out["wal"] = open(wal, "rb").read()
    reopened = pool_mod.EvidencePool(wal_path=str(wal), verifier=verifier.HostBatchVerifier(), chain_id=CHAIN_ID)
    out["reopened"] = [e.encode() for e in reopened.pending_evidence()]
    reopened.close()
    return out


def test_same_evidence_gives_equal_pools_in_both_packages(tmp_path):
    """The same evidence sequence (crossing as `encode()` into each
    package's `decode_evidence`) into a JAX and a port `EvidencePool` on
    their host verifiers: the same admissions and exceptions (class name
    and message), pending lists, encodings, retirements, WAL bytes and
    the pool reopened from its WAL."""
    stream = _evidence_stream()
    j = _pool_outcomes("tendermint_tpu", stream, tmp_path / "j.wal")
    p = _pool_outcomes("tendermint_tpu_torch", stream, tmp_path / "p.wal")
    assert p == j
    assert True in p["added"] and False in p["added"]
    assert any(isinstance(a, tuple) for a in p["added"]) and p["wal"]


def test_evidence_reactor_messages_encode_alike():
    """The evidence reactor's list message: the port's bytes are the JAX
    reactor's, each decodes the other's, and a bad message fails alike."""
    from tendermint_tpu.evidence import reactor as J_reactor
    from tendermint_tpu.types.evidence import decode_evidence as j_decode
    from tendermint_tpu_torch.evidence import reactor

    assert reactor.EVIDENCE_CHANNEL == J_reactor.EVIDENCE_CHANNEL
    stream = _evidence_stream()
    for k in (0, 1, 3, len(stream)):
        p_list = [decode_evidence(w) for w in stream[:k]]
        wire = reactor.encode_evidence_list(p_list)
        assert wire == J_reactor.encode_evidence_list([j_decode(w) for w in stream[:k]])
        assert [e.encode() for e in J_reactor.decode_evidence_list(wire)] == stream[:k]
        assert reactor.decode_evidence_list(wire) == p_list
    for bad in (b"\x02\x00", b"\x01\x02\x01", b""):
        outcomes = []
        for mod in (reactor, J_reactor):
            try:
                outcomes.append(("ok", len(mod.decode_evidence_list(bad))))
            except Exception as exc:
                outcomes.append((type(exc).__name__, str(exc)))
        assert outcomes[0] == outcomes[1]
