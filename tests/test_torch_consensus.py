"""The port's consensus (`tendermint_tpu_torch/consensus/`: `ConsensusState`,
its WAL, round state, ticker and config) and the height ledger
(`telemetry/heightlog.py`) against the JAX package's.

The JAX package's own scenarios run again on the port, each
`ConsensusState` on the port's `HostBatchVerifier` (a port consensus
given no verifier takes the card's stack): `tests/test_consensus.py`
(progress, locking, heartbeats, the WAL's crash recovery, the vote
storm's batched drain), `test_pol_safety.py`, `test_ticker.py`,
`test_wal_rotation.py` and `test_heightlog.py`; and
`test_peer_score.py`'s round-claim flood on the port's `HeightVoteSet`.
The cases that need modules the port does not carry yet wait for those
slices: the heartbeat's websocket JSON (`rpc`), `cut_wal_until` (`cmd`)
and the nemesis net's ledger (`testing`).

Across the packages, seeded and with `time.time_ns` fixed: the same
scripted proposals and votes into a JAX and a port `ConsensusState`
give byte-equal WAL files, blocks, seen commits, state JSON, app
hashes and event sequences; WAL records and round-state events encode
alike. Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import time

import pytest

from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.client import local_client_creator
from tendermint_tpu_torch.blockchain import BlockStore
from tendermint_tpu_torch.consensus import (
    ConsensusConfig,
    ConsensusState,
    MockTicker,
    TimeoutTicker,
)
from tendermint_tpu_torch.consensus.round_state import RoundStepType
from tendermint_tpu_torch.consensus.ticker import AdaptiveTimeouts
from tendermint_tpu_torch.consensus.wal import WAL, EndHeightMessage, MsgRecord
from tendermint_tpu_torch.db.kv import MemDB
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.state import make_genesis_state
from tendermint_tpu_torch.telemetry import heightlog
from tendermint_tpu_torch.telemetry.heightlog import HeightLedger, VoteArrivalRollup
from tendermint_tpu_torch.testing import lockrank_report, make_genesis, time_limit_fixture
from tendermint_tpu_torch.types import events as ev
from tendermint_tpu_torch.types.block import Block, Commit
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.tx import Txs
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE, Vote
from tendermint_tpu_torch.tools.finality_report import build_report, load_records
from tools import finality_report as J_finality_report

CHAIN = "cons-test"


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


# -- tests/test_consensus.py ------------------------------------------------------


class Fixture:
    """One in-process consensus node + scripted co-validators."""

    def __init__(
        self,
        n_vals=4,
        wal_path=None,
        db=None,
        store_db=None,
        config=None,
        real_ticker=False,
        verifier=None,
    ):
        self.genesis, self.privs = make_genesis(n_vals, chain_id=CHAIN)
        self.db = db if db is not None else MemDB()
        self.store = BlockStore(store_db if store_db is not None else MemDB())
        state = make_genesis_state(self.db, self.genesis)
        state.save()
        self.app = KVStoreApp()
        conns = local_client_creator(self.app)()
        self.config = config or ConsensusConfig.test_config()
        # our validator is privs[0] (valset order)
        self.cs = ConsensusState(
            config=self.config,
            state=state,
            app_conn=conns.consensus,
            block_store=self.store,
            priv_validator=self.privs[0],
            wal_path=wal_path,
            ticker=TimeoutTicker() if real_ticker else MockTicker(),
            verifier=verifier if verifier is not None else HostBatchVerifier(),
        )
        self.events: "queue.Queue[tuple[str, object]]" = queue.Queue()
        for name in (
            ev.EVENT_NEW_ROUND_STEP,
            ev.EVENT_NEW_BLOCK,
            ev.EVENT_LOCK,
            ev.EVENT_UNLOCK,
            ev.EVENT_RELOCK,
            ev.EVENT_POLKA,
        ):
            self.cs.event_switch.add_listener(
                "test", name, lambda data, n=name: self.events.put((n, data))
            )

    def wait_event(self, name, timeout=10.0, pred=None):
        deadline = time.time() + timeout
        while True:
            remaining = deadline - time.time()
            assert remaining > 0, f"timed out waiting for {name}"
            got, data = self.events.get(timeout=remaining)
            if got == name and (pred is None or pred(data)):
                return data

    def wait_step(self, step_name, timeout=10.0):
        return self.wait_event(
            ev.EVENT_NEW_ROUND_STEP, timeout, lambda d: d.step == step_name
        )

    def wait_height(self, height, timeout=20.0):
        while True:
            data = self.wait_event(ev.EVENT_NEW_BLOCK, timeout)
            if data.block.header.height >= height:
                return data.block

    def inject_votes(self, type_, block_id, val_indices, height=None, round_=0):
        """Sign + inject votes from co-validators (scripted signers)."""
        height = height if height is not None else self.cs.height
        for i in val_indices:
            vote = Vote(
                validator_address=self.privs[i].address,
                validator_index=i,
                height=height,
                round=round_,
                timestamp=time.time_ns(),
                type=type_,
                block_id=block_id,
            )
            vote = self.privs[i].sign_vote(CHAIN, vote)
            self.cs.add_vote(vote, peer_id=f"peer{i}")

    def proposal_block_id(self, timeout=10.0):
        """Wait until our node has a complete proposal block; return its id."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            rs = self.cs.get_round_state()
            if rs.proposal_block is not None:
                return BlockID(
                    rs.proposal_block.hash(), rs.proposal_block_parts.header
                )
            time.sleep(0.01)
        raise AssertionError("no complete proposal block")

    def stop(self):
        self.cs.stop()


class TestSoloValidator:
    def test_commits_blocks_alone(self):
        f = Fixture(n_vals=1)
        try:
            f.cs.start()
            block = f.wait_height(3)
            assert block.header.height >= 3
            assert f.store.height >= 3
            assert f.cs.state.last_block_height >= 3
        finally:
            f.stop()

    def test_raising_listener_does_not_stall_consensus(self):
        # EventSwitch.fire must isolate listener exceptions: a raising
        # NewBlock subscriber fires between commit and _schedule_round0,
        # and an escaping exception there would stall the node at the
        # new height (round-2 advisor finding).
        f = Fixture(n_vals=1, real_ticker=True)

        def bomb(_data):
            raise RuntimeError("subscriber bug")

        f.cs.event_switch.add_listener("bomb", ev.EVENT_NEW_BLOCK, bomb)
        try:
            f.cs.start()
            f.wait_height(3)  # keeps committing despite the raising listener
        finally:
            f.stop()

    def test_app_state_follows(self):
        f = Fixture(n_vals=1)
        try:
            f.cs.start()
            f.wait_height(2)
            assert f.app._height >= 2 or f.cs.state.app_hash == b""
        finally:
            f.stop()


class TestPipelinedFinalize:
    """Cross-height pipelined commit (PR 14): the apply launches as a
    dispatch handle, H+1 enters on a speculated state, and the join
    barrier swaps the applied truth in before anything reads it."""

    def test_pipelined_commit_records_overlap_and_joins(self):
        f = Fixture(n_vals=1)
        try:
            f.cs.start()
            f.wait_height(3)
            recs = f.cs.height_ledger.recent()
            pipelined = [r for r in recs if r.get("pipelined")]
            assert pipelined, "no height took the pipelined tail"
            for r in pipelined:
                assert "apply_overlap_s" in r
            assert f.cs.pipeline_stats["joins"] >= len(pipelined)
            # EVENT_NEW_BLOCK fires at the join: applied state visible
            assert f.cs.state.last_block_height >= 3
            assert f.store.height >= 3
        finally:
            f.stop()

    def test_env_opt_out_restores_serial(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_PIPELINE", "0")
        f = Fixture(n_vals=1)
        try:
            assert not f.cs.pipeline_enabled
            f.cs.start()
            f.wait_height(2)
            assert not any(
                r.get("pipelined") for r in f.cs.height_ledger.recent()
            )
        finally:
            f.stop()

    def test_endblock_valset_change_rebuilds_speculation(self):
        """EndBlock rotating the validator set mid-pipeline: the join
        barrier must rebuild the speculated H+1 round state (fresh
        HeightVoteSet against the post-EndBlock set) and consensus must
        keep committing under the new set."""
        from tendermint_tpu_torch.abci.types import Validator as ABCIValidator

        f = Fixture(n_vals=1)
        pub = f.cs.validators.validators[0].pub_key.data
        orig_end_block = f.app.end_block

        def end_block(height):
            orig_end_block(height)
            # bump our own power from height 2 on (idempotent after the
            # first application -> exactly one speculation mismatch)
            return [ABCIValidator(pub, 20)] if height >= 2 else []

        f.app.end_block = end_block
        try:
            f.cs.start()
            f.wait_height(4)
            assert f.cs.pipeline_stats["valset_rebuilds"] >= 1
            assert f.cs.validators.validators[0].voting_power == 20
        finally:
            f.stop()


class TestQuorumProgress:
    def test_four_validators_commit_with_injected_votes(self):
        f = Fixture(n_vals=4)
        try:
            f.cs.start()
            # we are one of 4 proposers; wait for OUR proposal at h1 r0
            # (privs[0] proposes round 0 by accum rotation from genesis)
            bid = f.proposal_block_id()
            f.inject_votes(VOTE_TYPE_PREVOTE, bid, [1, 2, 3])
            f.inject_votes(VOTE_TYPE_PRECOMMIT, bid, [1, 2, 3])
            block = f.wait_height(1)
            assert block.header.height == 1
            # seen commit persisted
            assert f.store.load_seen_commit(1).is_commit()
        finally:
            f.stop()

    def test_nil_precommits_go_to_next_round(self):
        f = Fixture(n_vals=4, real_ticker=True)
        try:
            f.cs.start()
            f.proposal_block_id()
            nil = BlockID(b"", PartSetHeader.zero())
            # everyone prevotes+precommits nil -> next round, same height
            f.inject_votes(VOTE_TYPE_PREVOTE, nil, [1, 2, 3])
            f.inject_votes(VOTE_TYPE_PRECOMMIT, nil, [1, 2, 3])
            deadline = time.time() + 10
            while time.time() < deadline:
                rs = f.cs.get_round_state()
                if rs.round >= 1:
                    break
                time.sleep(0.01)
            assert f.cs.get_round_state().round >= 1
            assert f.cs.get_round_state().height == 1
        finally:
            f.stop()


class TestLocking:
    def test_lock_held_against_different_block_next_round(self):
        """Once locked by a polka, we must keep prevoting the locked
        block in later rounds (reference TestLockNoPOL essence)."""
        f = Fixture(n_vals=4, real_ticker=True)
        try:
            f.cs.start()
            bid = f.proposal_block_id()
            # polka for our block at round 0 -> we lock
            f.inject_votes(VOTE_TYPE_PREVOTE, bid, [1, 2, 3])
            f.wait_event(ev.EVENT_LOCK)
            rs = f.cs.get_round_state()
            assert rs.locked_round == 0
            assert rs.locked_block.hash() == bid.hash
            # our own precommit is for the locked block (EVENT_LOCK fires
            # before the precommit is signed and added: poll for it; the
            # JAX test reads it at once and races the same way)
            deadline = time.time() + 10
            pc = None
            while pc is None and time.time() < deadline:
                pc = f.cs.votes.precommits(0).get_by_address(f.privs[0].address)
                time.sleep(0 if pc is not None else 0.01)
            assert pc is not None and pc.block_id.hash == bid.hash
            # drive to round 1 with nil precommits from others
            nil = BlockID(b"", PartSetHeader.zero())
            f.inject_votes(VOTE_TYPE_PRECOMMIT, nil, [1, 2, 3])
            deadline = time.time() + 10
            while time.time() < deadline and f.cs.get_round_state().round < 1:
                time.sleep(0.01)
            # in round 1 we must have prevoted the LOCKED block again
            deadline = time.time() + 10
            pv = None
            while time.time() < deadline:
                pvs = f.cs.votes.prevotes(1)
                pv = pvs.get_by_address(f.privs[0].address) if pvs else None
                if pv is not None:
                    break
                time.sleep(0.01)
            assert pv is not None, "no round-1 prevote from locked validator"
            assert pv.block_id.hash == bid.hash
        finally:
            f.stop()

    def test_unlock_on_nil_polka(self):
        """A +2/3 nil-prevote polka in a later round releases the lock
        (reference TestLockPOLUnlock essence)."""
        f = Fixture(n_vals=4, real_ticker=True)
        try:
            f.cs.start()
            bid = f.proposal_block_id()
            f.inject_votes(VOTE_TYPE_PREVOTE, bid, [1, 2, 3])
            f.wait_event(ev.EVENT_LOCK)
            nil = BlockID(b"", PartSetHeader.zero())
            f.inject_votes(VOTE_TYPE_PRECOMMIT, nil, [1, 2, 3])
            deadline = time.time() + 10
            while time.time() < deadline and f.cs.get_round_state().round < 1:
                time.sleep(0.01)
            # round 1: others polka nil -> we must unlock and precommit nil
            f.inject_votes(VOTE_TYPE_PREVOTE, nil, [1, 2, 3], round_=1)
            f.wait_event(ev.EVENT_UNLOCK)
            rs = f.cs.get_round_state()
            assert rs.locked_block is None and rs.locked_round == -1
        finally:
            f.stop()


class TestProposalHeartbeat:
    def test_heartbeats_fire_while_waiting_for_txs(self):
        """No-empty-blocks mode: the validator emits signed heartbeats
        while the chain idles, sequence increments, signature verifies
        (reference consensus/state.go:686,707-738)."""
        cfg = ConsensusConfig.test_config()
        cfg.create_empty_blocks = False
        cfg.proposal_heartbeat_interval = 0.05
        f = Fixture(n_vals=1, config=cfg)
        hbs: "queue.Queue" = queue.Queue()
        f.cs.event_switch.add_listener(
            "hb-test", ev.EVENT_PROPOSAL_HEARTBEAT, hbs.put
        )
        f.cs.start()
        try:
            first = hbs.get(timeout=5)
            second = hbs.get(timeout=5)
            assert second.sequence > first.sequence
            assert first.validator_address == f.privs[0].address
            assert first.validator_index == 0
            assert f.privs[0].pub_key.verify(
                first.sign_bytes(CHAIN), first.signature
            )
            # consensus is genuinely idle: no block was created
            assert f.cs.height == 1
            assert f.cs.step == RoundStepType.NEW_ROUND
        finally:
            f.cs.stop()

    def test_heartbeat_message_round_trip(self):
        from tendermint_tpu_torch.consensus.reactor import (
            ProposalHeartbeatMessage,
            decode_message,
        )
        from tendermint_tpu_torch.types.heartbeat import Heartbeat

        hb = Heartbeat(
            validator_address=b"\x11" * 20,
            validator_index=3,
            height=7,
            round=1,
            sequence=42,
            signature=b"\x22" * 64,
        )
        msg = decode_message(ProposalHeartbeatMessage(hb).encode())
        assert isinstance(msg, ProposalHeartbeatMessage)
        assert msg.heartbeat == hb


class TestWALRecovery:
    def test_wal_records_and_endheight(self, tmp_path):
        wal_path = str(tmp_path / "cs.wal")
        f = Fixture(n_vals=1, wal_path=wal_path)
        try:
            f.cs.start()
            f.wait_height(2)
        finally:
            f.stop()
        recs = list(WAL.iter_records(wal_path))
        heights = [r.height for r in recs if isinstance(r, EndHeightMessage)]
        assert 1 in heights and 2 in heights
        votes = [r for r in recs if isinstance(r, MsgRecord) and isinstance(r.msg, Vote)]
        assert votes, "own votes must be WAL'd"

    def test_poisoned_wal_does_not_brick_restart(self, tmp_path):
        """Inputs are WAL'd BEFORE validation, so an invalid peer vote can
        be on disk; replay must tolerate it like the live loop does
        (reference replay.go logs-and-continues) instead of raising out of
        start() on every restart."""
        wal_path = str(tmp_path / "cs.wal")
        db, store_db = MemDB(), MemDB()
        f = Fixture(n_vals=1, wal_path=wal_path, db=db, store_db=store_db)
        try:
            f.cs.start()
            f.wait_height(2)
        finally:
            f.stop()
        from tendermint_tpu_torch.state import load_state

        state = load_state(db)
        h0 = state.last_block_height
        # poison: garbage-signature vote for the in-progress height,
        # appended as if a peer sent it just before the crash
        bad = Vote(
            validator_address=f.privs[0].address,
            validator_index=0,
            height=h0 + 1,
            round=0,
            timestamp=time.time_ns(),
            type=VOTE_TYPE_PREVOTE,
            block_id=BlockID(b"", PartSetHeader.zero()),
            signature=b"\x01" * 64,
        )
        w = WAL(wal_path)
        w.save(MsgRecord(bad, "badpeer"))
        w.close()
        conns = local_client_creator(KVStoreApp())()
        from tendermint_tpu_torch.state.execution import exec_commit_block

        store = BlockStore(store_db)
        for h in range(1, h0 + 1):
            exec_commit_block(conns.consensus, store.load_block(h))
        cs2 = ConsensusState(
            config=ConsensusConfig.test_config(),
            state=state,
            app_conn=conns.consensus,
            block_store=store,
            priv_validator=f.privs[0],
            wal_path=wal_path,
            ticker=TimeoutTicker(),
            verifier=HostBatchVerifier(),
        )
        got = queue.Queue()
        cs2.event_switch.add_listener("t", ev.EVENT_NEW_BLOCK, lambda d: got.put(d))
        cs2.start()  # must NOT raise on the poisoned record
        try:
            data = got.get(timeout=10)
            assert data.block.header.height == h0 + 1
        finally:
            cs2.stop()

    def test_restart_resumes_from_wal_and_store(self, tmp_path):
        wal_path = str(tmp_path / "cs.wal")
        db, store_db = MemDB(), MemDB()
        f = Fixture(n_vals=1, wal_path=wal_path, db=db, store_db=store_db)
        try:
            f.cs.start()
            f.wait_height(2)
        finally:
            f.stop()
        # restart on the same dbs + WAL; must pick up after last ENDHEIGHT
        from tendermint_tpu_torch.state import load_state

        state = load_state(db)
        h0 = state.last_block_height
        f2 = Fixture.__new__(Fixture)
        Fixture.__init__(f2, n_vals=1, wal_path=wal_path, db=db, store_db=store_db)
        # __init__ created a fresh genesis state; rebuild cs from saved state
        f2.stop()
        conns = local_client_creator(KVStoreApp())()
        # replay chain into the fresh app (handshake's job; done manually here)
        from tendermint_tpu_torch.state.execution import exec_commit_block

        store = BlockStore(store_db)
        for h in range(1, h0 + 1):
            exec_commit_block(conns.consensus, store.load_block(h))
        # real ticker: if the pre-crash node signed a proposal that never
        # hit the WAL, the privval refuses to re-sign it (reference
        # `types/priv_validator.go:249-251` — proposals include time and
        # can be lost); the node then recovers via the round-1 timeout
        # path, which needs real timeouts to fire.
        cs2 = ConsensusState(
            config=ConsensusConfig.test_config(),
            state=state,
            app_conn=conns.consensus,
            block_store=store,
            priv_validator=f.privs[0],
            wal_path=wal_path,
            ticker=TimeoutTicker(),
            verifier=HostBatchVerifier(),
        )
        got = queue.Queue()
        cs2.event_switch.add_listener(
            "t", ev.EVENT_NEW_BLOCK, lambda d: got.put(d)
        )
        cs2.start()
        try:
            data = got.get(timeout=10)
            assert data.block.header.height == h0 + 1
        finally:
            cs2.stop()


class CountingVerifier:
    """Host verifier that records every verify_batch size."""

    def __init__(self):
        self._inner = HostBatchVerifier()
        self.calls = []

    def verify_batch(self, triples):
        self.calls.append(len(triples))
        return self._inner.verify_batch(triples)


class TestVoteStormBatchDrain:
    def test_storm_verifies_as_one_batch(self):
        """A backlog of same-(height, round, type) votes must be verified
        as one device batch through the accumulate->flush seam instead of
        N batch-of-one calls (VERDICT r4 weak #8, SURVEY §7 hard part 3);
        per-vote attribution is preserved — a planted bad signature still
        only rejects its own vote."""
        n = 1000
        v = CountingVerifier()
        f = Fixture(n_vals=n, verifier=v)
        try:
            # enqueue the full storm BEFORE the loop starts so it is one
            # consecutive backlog run (prevote nil, height 1, round 0)
            bad_index = None
            for i in range(1, n):  # privs[0] is the node itself
                vote = Vote(
                    validator_address=f.privs[i].address,
                    validator_index=i,
                    height=1,
                    round=0,
                    timestamp=time.time_ns(),
                    type=VOTE_TYPE_PREVOTE,
                    block_id=BlockID.zero(),
                )
                vote = f.privs[i].sign_vote(CHAIN, vote)
                if bad_index is None:
                    # corrupt the FIRST storm vote's signature
                    import dataclasses

                    bad_index = i
                    vote = dataclasses.replace(
                        vote,
                        signature=vote.signature[:8]
                        + bytes([vote.signature[8] ^ 1])
                        + vote.signature[9:],
                    )
                f.cs.add_vote(vote, peer_id=f"peer{i}")
            f.cs.start()
            deadline = time.time() + 30
            while time.time() < deadline:
                pv = f.cs.votes.prevotes(0) if f.cs.votes else None
                if pv is not None and pv.bit_array().count() >= n - 2:
                    break
                time.sleep(0.05)
            pv = f.cs.votes.prevotes(0)
            # every good vote tallied; the corrupted one rejected
            assert pv.bit_array().count() >= n - 2
            assert pv.get_by_index(bad_index) is None
            assert pv.get_by_index(bad_index + 1) is not None
            # ONE big batched verify replaced ~n singles: the storm may
            # split across a few drains (loop races the enqueue tail, the
            # bad lane re-verifies solo) but must not degrade to singles
            big = [c for c in v.calls if c >= f.cs.VOTE_DRAIN_MIN]
            assert sum(big) >= (n - 1) * 0.9, (len(v.calls), v.calls[:10])
            assert len(v.calls) <= 20, f"{len(v.calls)} verify calls"
        finally:
            f.stop()


class TestVotePreverifyFailureHalts:
    """A deliberate difference against the JAX package, which degrades a
    failed preverify to all-False and re-verifies each vote of the run
    alone (below the stack's minimum batch, on the host): the port
    halts consensus with FatalConsensusError instead."""

    def test_a_raising_preverify_halts_consensus(self):
        from tendermint_tpu_torch.consensus.state import FatalConsensusError

        class FailedHandle:
            def result(self, timeout=None):
                raise RuntimeError("launch lost")

            def then(self, fn):
                return self

        class RaisingVerifier(HostBatchVerifier):
            def verify_batch_async(self, triples, queue=None, consumer="default"):
                return FailedHandle()

        n = 12
        f = Fixture(n_vals=n, verifier=RaisingVerifier())
        try:
            for i in range(1, n):
                vote = Vote(
                    validator_address=f.privs[i].address,
                    validator_index=i,
                    height=1,
                    round=0,
                    timestamp=time.time_ns(),
                    type=VOTE_TYPE_PREVOTE,
                    block_id=BlockID.zero(),
                )
                f.cs.add_vote(f.privs[i].sign_vote(CHAIN, vote), peer_id=f"peer{i}")
            f.cs.start()
            deadline = time.time() + 10
            while f.cs.fatal_error is None and time.time() < deadline:
                time.sleep(0.01)
            err = f.cs.fatal_error
            assert type(err) is FatalConsensusError, err
            assert str(err) == "vote preverify failed"
            assert type(err.__cause__) is RuntimeError
            assert str(err.__cause__) == "launch lost"
            # no vote of the run was tallied on the host
            assert f.cs.votes.prevotes(0).bit_array().count() == 0
        finally:
            f.stop()


# -- tests/test_pol_safety.py -----------------------------------------------------


NIL = BlockID(b"", PartSetHeader.zero())


def wait_round(f, round_, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if f.cs.get_round_state().round >= round_:
            return
        time.sleep(0.01)
    raise AssertionError(f"never reached round {round_}")


def inject_late_votes(f, type_, block_id, indices, round_):
    """Inject votes for an OLD round: signed via the raw signer since
    the honest double-sign guard (correctly) refuses round regressions."""
    from tendermint_tpu_torch.testing import byzantine_signed_vote

    for i in indices:
        vote = byzantine_signed_vote(
            f.privs[i], i, f.cs.height, round_, type_, block_id, CHAIN
        )
        f.cs.add_vote(vote, peer_id=f"late{i}")


def wait_own_prevote(f, round_, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        pvs = f.cs.votes.prevotes(round_)
        pv = pvs.get_by_address(f.privs[0].address) if pvs else None
        if pv is not None:
            return pv
        time.sleep(0.01)
    raise AssertionError(f"no own prevote in round {round_}")


def make_alt_block(f, txs=(b"alt-tx",)):
    """A valid-but-different block for the fixture's current height."""
    st = f.cs.state
    return Block.make_block(
        height=st.last_block_height + 1,
        chain_id=CHAIN,
        txs=Txs(list(txs)),
        last_commit=Commit.empty(),
        last_block_id=st.last_block_id,
        time=time.time_ns(),
        validators_hash=st.validators.hash(),
        app_hash=st.app_hash,
    )


def inject_proposal(f, block, round_, pol_round=-1):
    """Craft + inject a proposal signed by the CURRENT proposer."""
    parts = block.make_part_set()
    prop = Proposal(
        height=block.header.height,
        round=round_,
        block_parts_header=parts.header,
        pol_round=pol_round,
        pol_block_id=NIL if pol_round < 0 else BlockID.zero(),
        timestamp=time.time_ns(),
    )
    proposer_addr = f.cs.validators.proposer.address
    priv = next(p for p in f.privs if p.address == proposer_addr)
    sig = priv._signer.sign(prop.sign_bytes(CHAIN))
    f.cs.set_proposal(prop.with_signature(sig), peer_id="test")
    for i in range(parts.total):
        f.cs.add_proposal_block_part(
            block.header.height, round_, parts.get_part(i), peer_id="test"
        )
    return BlockID(block.hash(), parts.header)


class TestPOLSafety:
    def test_old_polka_cannot_steal_newer_lock(self):
        """TestLockPOLSafety2 essence: locked at round 1, a round-2
        proposal carrying a round-0 POL for a DIFFERENT block must not
        unlock us — we keep prevoting the round-1 lock."""
        f = Fixture(n_vals=4, real_ticker=True)
        try:
            f.cs.start()
            # round 0: our proposal B1 exists but we see NO polka for it;
            # everyone precommits nil -> round 1
            b1_id = f.proposal_block_id()
            f.inject_votes(VOTE_TYPE_PRECOMMIT, NIL, [1, 2, 3])
            wait_round(f, 1)

            # round 1: we are proposer again (accum math keeps the first
            # address for r0 AND r1) and propose a fresh block B2; polka
            # for B2 -> we lock B2 at round 1
            b2_id = f.proposal_block_id()
            assert b2_id.hash != b1_id.hash
            f.inject_votes(VOTE_TYPE_PREVOTE, b2_id, [1, 2, 3], round_=1)
            f.wait_event(ev.EVENT_LOCK)
            rs = f.cs.get_round_state()
            assert rs.locked_round == 1
            assert rs.locked_block.hash() == b2_id.hash

            # drive to round 2
            f.inject_votes(VOTE_TYPE_PRECOMMIT, NIL, [1, 2, 3], round_=1)
            wait_round(f, 2)

            # round 2: the adversary reveals an OLD round-0 polka for B1
            # and proposes a competing block claiming that stale POL
            inject_late_votes(f, VOTE_TYPE_PREVOTE, b1_id, [1, 2, 3], round_=0)
            alt = make_alt_block(f, txs=(b"other-branch",))
            inject_proposal(f, alt, round_=2, pol_round=0)

            # our round-2 prevote must be the LOCKED block, not the
            # proposal with the stale POL
            pv = wait_own_prevote(f, 2)
            assert pv.block_id.hash == b2_id.hash, "lock was stolen by old POL"
            rs = f.cs.get_round_state()
            assert rs.locked_round == 1
            assert rs.locked_block.hash() == b2_id.hash
        finally:
            f.stop()

    def test_late_old_polka_does_not_create_lock(self):
        """TestLockPOLSafety1 essence: we never saw the round-0 polka and
        precommitted nil; when those round-0 prevotes arrive AFTER we
        moved to round 1, no retroactive lock may form."""
        f = Fixture(n_vals=4, real_ticker=True)
        try:
            f.cs.start()
            b1_id = f.proposal_block_id()
            # round 0 passes with nil precommits (polka withheld from us)
            f.inject_votes(VOTE_TYPE_PRECOMMIT, NIL, [1, 2, 3])
            wait_round(f, 1)
            assert f.cs.get_round_state().locked_block is None

            # the old round-0 polka for B1 arrives late
            inject_late_votes(f, VOTE_TYPE_PREVOTE, b1_id, [1, 2, 3], round_=0)
            time.sleep(0.3)  # give the loop time to (wrongly) react
            rs = f.cs.get_round_state()
            assert rs.locked_block is None and rs.locked_round == -1
        finally:
            f.stop()

    def test_conflicting_votes_tolerated_first_vote_wins(self):
        """Slashing-detection setup (`state_test.go:917`): equivocating
        prevotes from one validator must not crash consensus; the first
        vote is retained."""
        from tendermint_tpu_torch.testing import byzantine_signed_vote, make_block_id

        f = Fixture(n_vals=4, real_ticker=True)
        try:
            f.cs.start()
            bid = f.proposal_block_id()
            other = make_block_id(b"equivocation-target")
            v1 = byzantine_signed_vote(
                f.privs[1], 1, 1, 0, VOTE_TYPE_PREVOTE, bid, CHAIN
            )
            v2 = byzantine_signed_vote(
                f.privs[1], 1, 1, 0, VOTE_TYPE_PREVOTE, other, CHAIN
            )
            f.cs.add_vote(v1, peer_id="byz")
            f.cs.add_vote(v2, peer_id="byz")
            time.sleep(0.3)
            assert f.cs.fatal_error is None  # bad peer input never halts
            kept = f.cs.votes.prevotes(0).get_by_address(f.privs[1].address)
            assert kept is not None and kept.block_id.hash == bid.hash
        finally:
            f.stop()

    def test_halt_recovers_via_late_round0_precommit(self):
        """TestHalt1 essence: round 0 ends without visible quorum (2 B,
        1 nil, 1 withheld); after we move to round 1, the withheld
        round-0 precommit for B arrives -> +2/3 at round 0 -> commit."""
        f = Fixture(n_vals=4, real_ticker=True)
        try:
            f.cs.start()
            bid = f.proposal_block_id()
            # polka: we lock + precommit B
            f.inject_votes(VOTE_TYPE_PREVOTE, bid, [1, 2, 3])
            f.wait_event(ev.EVENT_LOCK)
            # only val1 precommits B with us; val2 nil; val3 withheld
            f.inject_votes(VOTE_TYPE_PRECOMMIT, bid, [1])
            f.inject_votes(VOTE_TYPE_PRECOMMIT, NIL, [2])
            wait_round(f, 1)  # precommit-wait timeout fires
            assert f.cs.get_round_state().height == 1
            # withheld round-0 precommit arrives late -> commit height 1
            inject_late_votes(f, VOTE_TYPE_PRECOMMIT, bid, [3], round_=0)
            blk = f.wait_height(1)
            assert blk.header.height == 1
        finally:
            f.stop()

    def test_commit_step_names_the_committed_blocks_parts(self):
        """Round 0 ends without a visible quorum, the node proposes a
        block of its own in round 1, then the withheld round-0 precommit
        completes +2/3 for the round-0 block. When the COMMIT step is
        announced (the reactor then sends its CommitStepMessage), the
        node's `proposal_block_parts` must be the committed block's,
        not its own round-1 proposal's: a deliberate difference from
        the JAX package, which announces the step first."""
        f = Fixture(n_vals=4, real_ticker=True)
        named = []

        def on_step(data):
            rs = f.cs.get_round_state()
            if rs.step == RoundStepType.COMMIT:
                named.append(rs.proposal_block_parts.header if rs.proposal_block_parts else None)

        f.cs.event_switch.add_listener("probe", ev.EVENT_NEW_ROUND_STEP, on_step)
        try:
            f.cs.start()
            b1_id = f.proposal_block_id()
            b1_parts = f.cs.get_round_state().proposal_block_parts
            f.inject_votes(VOTE_TYPE_PRECOMMIT, b1_id, [1, 2])
            wait_round(f, 1)
            b2_id = f.proposal_block_id()
            assert b2_id.hash != b1_id.hash
            inject_late_votes(f, VOTE_TYPE_PRECOMMIT, b1_id, [3], round_=0)
            f.wait_step("Commit")
            assert named == [b1_id.parts_header]
            # the parts a peer sends for that header complete the commit
            for i in range(b1_parts.total):
                f.cs.add_proposal_block_part(1, 0, b1_parts.get_part(i), peer_id="peer1")
            assert f.wait_height(1).hash() == b1_id.hash
        finally:
            f.stop()


def _wal_record_offsets(path: str) -> list[int]:
    """Byte offsets of every record boundary (after each record)."""
    with open(path, "rb") as fh:
        data = fh.read()
    offsets, off = [], 0
    while off + 8 <= len(data):
        _, length = struct.unpack_from(">II", data, off)
        if off + 8 + length > len(data):
            break
        off += 8 + length
        offsets.append(off)
    return offsets


def _snapshot_db(db: MemDB) -> dict:
    return dict(db._data)


def _restore_db(snapshot: dict) -> MemDB:
    db = MemDB()
    db._data.update(snapshot)
    return db


class TestWALPrefixReplay:
    def test_restart_from_every_wal_prefix(self, tmp_path):
        """Reference `consensus/replay_test.go:55-63`: a node must
        recover from a crash at ANY WAL position. Run a solo validator
        a few heights, then restart from the state/store/WAL as they
        were, with the WAL truncated at every record boundary."""
        wal_path = str(tmp_path / "cs.wal")
        db, store_db = MemDB(), MemDB()
        f = Fixture(
            n_vals=1, wal_path=wal_path, db=db, store_db=store_db, real_ticker=True
        )
        f.cs.start()
        f.wait_height(3)
        f.stop()

        with open(wal_path, "rb") as fh:
            wal_bytes = fh.read()
        offsets = _wal_record_offsets(wal_path)
        assert len(offsets) > 10
        db_snap, store_snap = _snapshot_db(db), _snapshot_db(store_db)
        base_height = BlockStore(_restore_db(store_snap)).height

        # every record boundary + a mid-record torn write
        cuts = offsets + [offsets[-1] - 3]
        for cut in cuts:
            trunc = str(tmp_path / f"wal-{cut}.wal")
            with open(trunc, "wb") as fh:
                fh.write(wal_bytes[:cut])
            f2 = Fixture(
                n_vals=1,
                wal_path=trunc,
                db=_restore_db(db_snap),
                store_db=_restore_db(store_snap),
                real_ticker=True,
            )
            try:
                f2.cs.start()
                assert f2.cs.fatal_error is None
                f2.wait_height(base_height + 1, timeout=20)
            finally:
                f2.stop()


# -- tests/test_ticker.py ----------------------------------------------------------


def _ledger_with_phases(n, propose_s=0.010, prevote_s=0.005, precommit_s=0.005):
    led = heightlog.HeightLedger()
    for h in range(1, n + 1):
        led.record(
            {
                "height": h,
                "phases": {
                    "propose": {"s": propose_s},
                    "prevote": {"s": prevote_s},
                    "precommit": {"s": precommit_s},
                },
            }
        )
    return led


def _rollup(peer_delays: dict):
    """peer -> list of observed arrival delays (seconds)."""
    r = heightlog.VoteArrivalRollup()
    for peer, delays in peer_delays.items():
        for d in delays:
            r.observe(peer, d)
    return r


class TestAdaptiveTimeouts:
    def test_cold_start_falls_back_to_fixed(self):
        cfg = ConsensusConfig()  # adaptive on by default
        at = AdaptiveTimeouts(cfg, rollup=_rollup({}), ledger=heightlog.HeightLedger())
        # empty rollup + empty ledger: every phase sleeps the fixed ladder
        assert at.propose_timeout(0) == cfg.propose_timeout(0)
        assert at.prevote_timeout(0) == cfg.prevote_timeout(0)
        assert at.precommit_timeout(0) == cfg.precommit_timeout(0)
        assert at.commit_timeout() == cfg.commit_timeout()

    def test_too_few_heights_falls_back(self):
        cfg = ConsensusConfig()
        led = _ledger_with_phases(AdaptiveTimeouts.MIN_HEIGHTS - 1)
        at = AdaptiveTimeouts(cfg, rollup=_rollup({"p1": [0.001]}), ledger=led)
        assert at.propose_timeout(0) == cfg.propose_timeout(0)
        assert at.commit_timeout() == cfg.commit_timeout()

    def test_derivation_engages_and_floors(self):
        cfg = ConsensusConfig(timeout_derived_floor=2)
        led = _ledger_with_phases(16, propose_s=0.010)
        rollup = _rollup({f"p{i}": [0.001] * 4 for i in range(4)})
        at = AdaptiveTimeouts(cfg, rollup=rollup, ledger=led)
        # propose: p95 of 10ms phase * SAFETY(3) = 30ms, under the 3000ms fixed
        assert at.propose_timeout(0) == pytest.approx(0.030, rel=0.01)
        # commit: 1ms median-of-means * 3 = 3ms, over the 2ms floor
        assert at.commit_timeout() == pytest.approx(0.003, rel=0.01)
        # floor: sub-floor measurements can't spin the ticker
        tiny = _rollup({f"p{i}": [0.0001] for i in range(4)})
        at_tiny = AdaptiveTimeouts(cfg, rollup=tiny, ledger=led)
        assert at_tiny.commit_timeout() == pytest.approx(0.002, rel=0.01)

    def test_clamped_to_configured_ceiling(self):
        """Inflated measurements (e.g. every peer slow) derive AT MOST
        the configured fixed value — the operator's ladder is a hard
        ceiling, not a suggestion."""
        cfg = ConsensusConfig()
        led = _ledger_with_phases(
            16, propose_s=900.0, prevote_s=900.0, precommit_s=900.0
        )
        rollup = _rollup({f"p{i}": [50.0] * 4 for i in range(4)})
        at = AdaptiveTimeouts(cfg, rollup=rollup, ledger=led)
        assert at.propose_timeout(0) == cfg.propose_timeout(0)
        assert at.prevote_timeout(1) == cfg.prevote_timeout(1)
        assert at.commit_timeout() == cfg.commit_timeout()

    def test_byzantine_outlier_cannot_inflate(self):
        """One peer stamping absurd vote timestamps (delays clamped to
        MAX_ARRIVAL_S at observation) moves nothing: the estimate is
        the median of per-peer means, so a minority of liars is
        ignored entirely."""
        cfg = ConsensusConfig()
        led = _ledger_with_phases(16)
        honest = {f"p{i}": [0.002] * 8 for i in range(4)}
        at_honest = AdaptiveTimeouts(cfg, rollup=_rollup(honest), ledger=led)
        baseline = at_honest.commit_timeout()
        poisoned = dict(honest)
        poisoned["byz"] = [heightlog.MAX_ARRIVAL_S] * 64
        at_poisoned = AdaptiveTimeouts(cfg, rollup=_rollup(poisoned), ledger=led)
        assert at_poisoned.commit_timeout() == pytest.approx(baseline, rel=0.01)

    def test_opt_out_config_and_env(self, monkeypatch):
        led = _ledger_with_phases(16, propose_s=0.010)
        rollup = _rollup({f"p{i}": [0.001] * 4 for i in range(4)})
        cfg_off = ConsensusConfig(adaptive_timeouts=False)
        at = AdaptiveTimeouts(cfg_off, rollup=rollup, ledger=led)
        assert at.propose_timeout(0) == cfg_off.propose_timeout(0)
        cfg_on = ConsensusConfig()
        monkeypatch.setenv("TENDERMINT_TPU_ADAPTIVE_TIMEOUTS", "0")
        at_env = AdaptiveTimeouts(cfg_on, rollup=rollup, ledger=led)
        assert at_env.propose_timeout(0) == cfg_on.propose_timeout(0)

    def test_derived_gauge_exported(self):
        from tendermint_tpu_torch.telemetry import REGISTRY

        cfg = ConsensusConfig()
        led = _ledger_with_phases(16, propose_s=0.010)
        at = AdaptiveTimeouts(cfg, rollup=_rollup({}), ledger=led)
        at.propose_timeout(0)
        fam = REGISTRY.get("tendermint_consensus_timeout_derived_seconds")
        vals = {labels[0]: snap for labels, snap in fam.samples()}
        assert vals["propose"] == pytest.approx(0.030, rel=0.01)


# -- tests/test_wal_rotation.py ----------------------------------------------------


def _vote(height):
    return Vote(
        validator_address=b"\x01" * 20,
        validator_index=0,
        height=height,
        round=0,
        timestamp=1000,
        type=VOTE_TYPE_PREVOTE,
        block_id=BlockID(b"\x02" * 32, PartSetHeader(total=1, hash=b"\x03" * 20)),
        signature=b"\x04" * 64,
    )


class TestWALRotation:
    def test_rotates_at_height_boundaries_and_replays_across(self, tmp_path):
        path = str(tmp_path / "cs.wal")
        wal = WAL(path, max_file_bytes=400, max_segments=100)
        for h in range(1, 8):
            wal.save(MsgRecord(_vote(h), "peerX"))
            wal.save(EndHeightMessage(h))
        # in-progress height 8: one vote after the last marker
        wal.save(MsgRecord(_vote(8), "peerX"))
        wal.close()
        segments = WAL.segment_paths(path)
        assert len(segments) > 2, "no rotation happened"
        # every record survives, in order, across segments
        recs = list(WAL.iter_records(path))
        heights = [r.height for r in recs if isinstance(r, EndHeightMessage)]
        assert heights == list(range(1, 8))
        # replay for the in-progress height finds the marker even though
        # it may live in an earlier (rotated) segment
        replay = WAL.records_since_last_end_height(path, height=8)
        assert replay is not None and len(replay) == 1
        assert isinstance(replay[0], MsgRecord) and replay[0].msg.height == 8

    def test_prunes_oldest_segments(self, tmp_path):
        path = str(tmp_path / "cs.wal")
        wal = WAL(path, max_file_bytes=200, max_segments=2)
        for h in range(1, 12):
            wal.save(MsgRecord(_vote(h), "p"))
            wal.save(EndHeightMessage(h))
        wal.close()
        segments = WAL.segment_paths(path)
        assert len(segments) <= 3  # 2 rotated + live
        # recent heights still replayable
        replay = WAL.records_since_last_end_height(path, height=11)
        assert replay is not None

    def test_corrupt_rotated_segment_raises(self, tmp_path):
        # corruption in a NON-tail segment is data loss mid-stream, not
        # a crash tail: replay must fail loudly, not yield a gapped log
        import pytest

        path = str(tmp_path / "cs.wal")
        wal = WAL(path, max_file_bytes=200, max_segments=10)
        for h in range(1, 8):
            wal.save(MsgRecord(_vote(h), "p"))
            wal.save(EndHeightMessage(h))
        wal.close()
        segments = WAL.segment_paths(path)
        assert len(segments) > 2
        victim = segments[0]
        data = bytearray(open(victim, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(victim, "wb").write(bytes(data))
        with pytest.raises(ValueError, match="corrupt WAL segment"):
            list(WAL.iter_records(path))


# -- tests/test_heightlog.py -------------------------------------------------------


def _hrec(height, node="n0", finality=0.2, path="vote_gather", t=None):
    # t_commit defaults to NOW: the process-global ledger registry is
    # shared with earlier tests' live-net records, and recent_records()
    # keeps the newest-by-commit-time window — ancient synthetic stamps
    # would sort themselves out of it
    import time as _time

    if t is None:
        t = _time.time() + height * 1e-3
    return {
        "height": height,
        "node": node,
        "round": 0,
        "txs": 0,
        "t_start": t - 0.2,
        "t_commit": t,
        "height_s": 0.2,
        "finality_s": finality if height > 1 else None,
        "phases": {
            "new_height": {"s": 0.1, "work_s": 0.0, "wait_s": 0.1},
            "prevote": {"s": 0.1, "work_s": 0.02, "wait_s": 0.08},
        },
        "path": {"vote_gather": 0.1},
        "critical_path": path,
        "laggard": {"validator": "aabbcc", "index": 1, "delay_s": 0.01},
    }


class TestHeightLedger:
    def test_ring_bounds(self):
        led = HeightLedger(capacity=4)
        for h in range(1, 11):
            led.record(_hrec(h))
        assert len(led) == 4
        assert [r["height"] for r in led.recent()] == [7, 8, 9, 10]
        assert led.last()["height"] == 10
        assert led.recent(height=9)[0]["height"] == 9

    def test_node_id_stamped(self):
        led = HeightLedger(node_id="nodeX")
        led.record({"height": 1, "t_commit": 1.0})
        assert led.last()["node"] == "nodeX"

    def test_jsonl_persistence_and_reload(self, tmp_path):
        path = str(tmp_path / "heights.jsonl")
        led = HeightLedger(path=path, node_id="n0")
        for h in range(1, 6):
            led.record(_hrec(h))
        led.close()
        # torn final line from a crash must not poison the reload
        with open(path, "a") as f:
            f.write('{"height": 99, "trunc')
        led2 = HeightLedger(path=path, node_id="n0")
        assert [r["height"] for r in led2.recent()] == [1, 2, 3, 4, 5]
        led2.close()

    def test_compaction_keeps_newest(self, tmp_path):
        path = str(tmp_path / "heights.jsonl")
        led = HeightLedger(path=path, capacity=8)
        for h in range(1, 40):
            led.record(_hrec(h))
        led.close()
        with open(path) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        assert len(lines) <= 16  # 2x capacity compaction bound
        assert lines[-1]["height"] == 39

    def test_finality_window(self):
        led = HeightLedger()
        for h in range(1, 6):
            led.record(_hrec(h, finality=0.1 * h))
        # height 1 has finality None and is excluded
        assert led.finality_window(10) == pytest.approx([0.2, 0.3, 0.4, 0.5])

    def test_record_never_raises_after_close(self):
        led = HeightLedger()
        led.close()
        led.record(_hrec(1))  # no-op, no exception
        assert len(led) == 0

    def test_registry_recent_records_merges(self):
        import time as _time

        a = HeightLedger(node_id="a")
        b = HeightLedger(node_id="b")
        # stamped slightly in the future so earlier tests' live-net
        # records (shared process-global registry) can't crowd them out
        a.record(_hrec(1, node="a", t=_time.time() + 50.0))
        b.record(_hrec(1, node="b", t=_time.time() + 51.0))
        recs = heightlog.recent_records(64)
        mine = [r for r in recs if r.get("node") in ("a", "b")]
        assert len(mine) == 2
        assert mine[-1]["node"] == "b"  # commit-time ordered

    def test_dump_all_atomic_file(self, tmp_path):
        led = HeightLedger(node_id="dumper")
        led.record(_hrec(3, node="dumper"))
        path = heightlog.dump_all(str(tmp_path), reason="unit test!")
        assert path is not None and os.path.exists(path)
        dump = json.load(open(path))
        nodes = {l["node"] for l in dump["ledgers"]}
        assert "dumper" in nodes
        assert dump["reason"] == "unit test!"

    def test_work_totals_keys(self):
        totals = heightlog.work_totals()
        assert set(totals) == {"verify", "hash", "coalescer", "dispatch"}
        assert all(v >= 0.0 for v in totals.values())


class TestVoteArrivalRollup:
    def test_rollup_stats(self):
        r = VoteArrivalRollup()
        r.observe("peerA", 0.010)
        r.observe("peerA", 0.030)
        r.observe("peerB", 0.005)
        snap = r.snapshot()
        assert snap["peerA"]["count"] == 2
        assert snap["peerA"]["max_ms"] == 30.0
        assert snap["peerA"]["mean_ms"] == 20.0
        assert r.max_delay() == pytest.approx(0.030)

    def test_peer_flood_bounded(self):
        r = VoteArrivalRollup()
        for i in range(2 * VoteArrivalRollup.MAX_PEERS):
            r.observe(f"peer{i}", 0.001)
        assert len(r.snapshot()) == VoteArrivalRollup.MAX_PEERS


class TestFlightDumpEmbedsLedger:
    def test_dump_carries_height_records(self, tmp_path):
        from tendermint_tpu_torch.telemetry.flightrec import FLIGHT

        led = HeightLedger(node_id="flight-test")
        led.record(_hrec(7, node="flight-test"))
        path = FLIGHT.dump(reason="heightlog-unit", dir=str(tmp_path))
        assert path is not None
        dump = json.load(open(path))
        assert "heights" in dump
        assert any(r.get("node") == "flight-test" for r in dump["heights"])


class TestFinalityReport:
    def test_merge_jsonl_and_dump_dedup(self, tmp_path):
        jl = tmp_path / "a.jsonl"
        with open(jl, "w") as f:
            for h in (1, 2, 3):
                f.write(json.dumps(_hrec(h, node="n0")) + "\n")
        # a dump overlapping the jsonl (same node/heights) must dedupe
        dump = {
            "reason": "x",
            "ledgers": [
                {"node": "n1", "records": [_hrec(2, node="n1"), _hrec(3, node="n1")]}
            ],
        }
        dp = tmp_path / "heightledger-x-1.json"
        dp.write_text(json.dumps(dump))
        recs = load_records([str(jl), str(jl), str(dp)])
        assert len(recs) == 5  # 3 from n0 + 2 from n1, self-dedup
        assert recs == J_finality_report.load_records([str(jl), str(jl), str(dp)])
        report = build_report(recs)
        assert report == J_finality_report.build_report(recs)
        assert report["summary"]["nodes"] == ["n0", "n1"]
        assert report["summary"]["heights"] == 3
        assert report["summary"]["critical_path_counts"]["vote_gather"] == 5
        assert report["summary"]["laggard_counts"]["aabbcc"] == 5
        assert report["summary"]["finality_ms"]["p50"] is not None

    def test_height_and_last_filters(self):
        recs = [_hrec(h) for h in range(1, 10)]
        assert list(build_report(recs, height=4)["heights"]) == [4]
        assert list(build_report(recs, last=2)["heights"]) == [8, 9]
        for kwargs in ({"height": 4}, {"last": 2}):
            assert build_report(recs, **kwargs) == J_finality_report.build_report(recs, **kwargs)

    def test_render_and_cli(self, tmp_path, capsys):
        from tendermint_tpu_torch.tools import finality_report

        jl = tmp_path / "h.jsonl"
        with open(jl, "w") as f:
            for h in (1, 2):
                f.write(json.dumps(_hrec(h)) + "\n")
        assert finality_report.main(["--ledgers", str(jl)]) == 0
        out = capsys.readouterr().out
        assert "height 2" in out and "laggard=aabbcc" in out
        # the repo's `tools/finality_report.py` prints the same report
        assert J_finality_report.main(["--ledgers", str(jl)]) == 0
        assert capsys.readouterr().out == out




# -- across the packages -------------------------------------------------------------


def _package(pkg: str):
    """The modules a scripted consensus run needs, from `pkg`."""
    import importlib
    import types as _types

    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    helpers = importlib.import_module("tests.helpers") if pkg == "tendermint_tpu" else imp("testing")
    return _types.SimpleNamespace(
        apps=imp("abci.apps"), client=imp("abci.client"), store=imp("blockchain.store"), cons=imp("consensus"),
        rs=imp("consensus.round_state"), wal=imp("consensus.wal"), kv=imp("db.kv"), mempool=imp("mempool"),
        state=imp("state"), ev=imp("types.events"), types=imp("types"), verifier=imp("services.verifier"),
        make_genesis=helpers.make_genesis,
    )


_EVENTS = ("NewRoundStep", "CompleteProposal", "Polka", "Lock", "Unlock", "Relock", "Vote", "NewBlock")


def _event_view(name, data):
    if hasattr(data, "block"):
        return (name, data.block.hash())
    if hasattr(data, "vote"):
        return (name, data.vote.encode())
    return (name, data.height, data.round, str(data.step))


def _scripted_run(pkg: str, tmp_path, heights: int = 3):
    """A node of 4 validators (privs[0], `MockTicker`, the serial
    finalize and fixed timeouts, so every step waits for the script)
    driven message by message: each height's proposal (the node's own,
    or one the test signs for the round's proposer, with its own txs),
    then the other validators' prevotes and precommits one at a time,
    each after the node has taken the last. Returns the node's WAL
    bytes, blocks, seen commits, state JSON, app hash and events."""
    m = _package(pkg)
    gen, privs = m.make_genesis(4, chain_id=CHAIN)
    state = m.state.make_genesis_state(m.kv.MemDB(), gen)
    state.save()
    app = m.apps.KVStoreApp()
    conns = m.client.local_client_creator(app)()
    store = m.store.BlockStore(m.kv.MemDB())
    mp = m.mempool.Mempool(conns.mempool, ingress_batch=False)
    for i in range(6):
        assert mp.check_tx(b"pool%d=v%d" % (i, i)).is_ok
    cfg = m.cons.ConsensusConfig.test_config()
    cfg.pipeline_commit = False
    cfg.adaptive_timeouts = False
    wal_path = str(tmp_path / pkg / "cs.wal")
    cs = m.cons.ConsensusState(
        config=cfg, state=state, app_conn=conns.consensus, block_store=store, mempool=mp,
        priv_validator=privs[0], wal_path=wal_path, ticker=m.cons.MockTicker(),
        verifier=m.verifier.HostBatchVerifier(),
    )
    events = []
    for name in _EVENTS:
        cs.event_switch.add_listener("diff", name, lambda d, n=name: events.append(_event_view(n, d)))

    def wait(pred, what):
        deadline = time.time() + 20
        while not pred():
            assert cs.fatal_error is None, cs.fatal_error
            assert time.time() < deadline, f"{pkg}: timed out waiting for {what}"
            time.sleep(0.002)

    def tallied(type_, idx):
        votes = cs.votes
        vs = votes.prevotes(0) if type_ == VOTE_TYPE_PREVOTE else votes.precommits(0)
        return vs is not None and vs.get_by_index(idx) is not None

    def vote(h, type_, idx, bid):
        v = m.types.Vote(privs[idx].address, idx, h, 0, time.time_ns(), type_, bid)
        cs.add_vote(privs[idx].sign_vote(CHAIN, v), peer_id=f"peer{idx}")

    propose_step = m.rs.RoundStepType.PROPOSE
    cs.start()
    try:
        for h in range(1, heights + 1):
            wait(lambda: cs.height == h and cs.step >= propose_step, f"height {h}")
            proposer = cs.validators.proposer.address
            if proposer == privs[0].address:
                wait(lambda: cs.get_round_state().proposal_block is not None, "the node's proposal")
                rs = cs.get_round_state()
                bid = m.types.BlockID(rs.proposal_block.hash(), rs.proposal_block_parts.header)
            else:
                st = cs.state
                block = m.types.Block.make_block(
                    height=h, chain_id=CHAIN, txs=m.types.Txs([b"h%d-%d=x" % (h, i) for i in range(3)]),
                    last_commit=store.load_seen_commit(h - 1) if h > 1 else m.types.Commit.empty(),
                    last_block_id=st.last_block_id, time=time.time_ns(), validators_hash=st.validators.hash(),
                    app_hash=st.app_hash,
                )
                parts = block.make_part_set()
                prop = m.types.Proposal(height=h, round=0, block_parts_header=parts.header, pol_round=-1,
                                        pol_block_id=m.types.BlockID(b"", m.types.PartSetHeader.zero()),
                                        timestamp=time.time_ns())
                priv = next(p for p in privs if p.address == proposer)
                cs.set_proposal(prop.with_signature(priv._signer.sign(prop.sign_bytes(CHAIN))), peer_id="test")
                for i in range(parts.total):
                    cs.add_proposal_block_part(h, 0, parts.get_part(i), peer_id="test")
                bid = m.types.BlockID(block.hash(), parts.header)
            wait(lambda: tallied(VOTE_TYPE_PREVOTE, 0), "the node's prevote")
            for idx in (1, 2, 3):
                vote(h, VOTE_TYPE_PREVOTE, idx, bid)
                wait(lambda: tallied(VOTE_TYPE_PREVOTE, idx), f"prevote {idx}")
                if idx == 2:  # the polka: the node's precommit goes first
                    wait(lambda: tallied(VOTE_TYPE_PRECOMMIT, 0), "the node's precommit")
            vote(h, VOTE_TYPE_PRECOMMIT, 1, bid)
            wait(lambda: tallied(VOTE_TYPE_PRECOMMIT, 1), "precommit 1")
            vote(h, VOTE_TYPE_PRECOMMIT, 2, bid)
            wait(lambda: store.height >= h and cs.height == h + 1, f"the commit of height {h}")
        wait(lambda: cs.step >= propose_step, "the next height's round")
    finally:
        cs.stop()
        mp.close()
    wal = b"".join(open(p, "rb").read() for p in m.wal.WAL.segment_paths(wal_path))
    return {
        "wal": wal,
        "blocks": [store.load_block(h).encode() for h in range(1, heights + 1)],
        "seen_commits": [store.load_seen_commit(h).encode() for h in range(1, heights + 1)],
        "state": cs.state.to_json(),
        "app_hash": cs.state.app_hash,
        "events": events,
        "records": len(list(m.wal.WAL.iter_records(wal_path))),
    }


def test_scripted_heights_are_byte_equal_in_both_packages(tmp_path, monkeypatch):
    """The same scripted proposals and votes, seeded keys and a fixed
    `time.time_ns`, into a JAX and a port `ConsensusState`: byte-equal
    WAL files, blocks, seen commits, state JSON and app hashes, and the
    same event sequence; each package's WAL reads back in the other."""
    import types as _types

    import tendermint_tpu.consensus.state as J_state_mod
    import tendermint_tpu_torch.consensus.state as P_state_mod

    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_321_000_000_000)
    # the wall clock consensus reads (a height's start, so the WAL'd
    # timeout's duration), fixed in the two consensus modules alone
    frozen = _types.SimpleNamespace(time=lambda: 1_700_000_321.0, time_ns=time.time_ns,
                                    perf_counter=time.perf_counter, monotonic=time.monotonic, sleep=time.sleep)
    monkeypatch.setattr(J_state_mod, "time_mod", frozen)
    monkeypatch.setattr(P_state_mod, "time_mod", frozen)
    jax_run = _scripted_run("tendermint_tpu", tmp_path)
    port_run = _scripted_run("tendermint_tpu_torch", tmp_path)
    assert port_run["records"] > 30 and len(port_run["blocks"]) == 3
    assert port_run["app_hash"] == jax_run["app_hash"] != b""
    for key in ("blocks", "seen_commits", "state", "wal", "records"):
        assert port_run[key] == jax_run[key], key
    # the node's own vote fires its event from the signing thread, a
    # peer's from the receive loop: the same votes, in either order
    steps = [[e for e in run["events"] if e[0] != "Vote"] for run in (port_run, jax_run)]
    votes = [sorted(e for e in run["events"] if e[0] == "Vote") for run in (port_run, jax_run)]
    assert steps[0] == steps[1] and len(steps[0]) > 20
    assert votes[0] == votes[1] and len(votes[0]) == 3 * 7
    from tendermint_tpu.consensus.wal import WAL as JWAL

    jrecs = list(JWAL.iter_records(str(tmp_path / "tendermint_tpu" / "cs.wal")))
    precs = list(WAL.iter_records(str(tmp_path / "tendermint_tpu_torch" / "cs.wal")))
    assert [type(r).__name__ for r in precs] == [type(r).__name__ for r in jrecs]
