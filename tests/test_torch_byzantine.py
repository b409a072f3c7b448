"""The port's Byzantine adversaries (`tendermint_tpu_torch/testing/byzantine.py`)
against the port's own nodes on the CPU, and its frame fuzzer.

The JAX package's `tests/test_byzantine.py` and `tests/test_frame_fuzz.py`
run again on the port, each case with its JAX marker: the equivocator's
evidence committed within five heights (and after the offender
crashes), a conflicting vote that tips the quorum, the conflicting
proposer, the garbage-signature flood (banned, breaker closed), ingress
recovery after a flood, the lying fast-sync peer, the mutated-frame
corpus through the port's codecs and 10,000 mutated frames against a
live pair.

Across the packages, from seeds: `mutate_frame` outputs, the golden
frames, `forge_fullcommit` encodings, the equivocator's and the
conflicting proposer's signed messages (sign bytes and signatures),
the flooder's forged votes and envelopes and the liar's forged blocks
are byte for byte the JAX package's. The port's declared difference:
`wait_evidence_committed` sleeps between polls. Tolerance: exact.
"""

from __future__ import annotations

import random
import time

import pytest

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.p2p.connection import build_frame, parse_frame
from tendermint_tpu_torch.services.resilient import ResilientVerifier
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.telemetry import REGISTRY
from tendermint_tpu_torch.telemetry.flightrec import FLIGHT
from tendermint_tpu_torch.testing import (
    ConflictingProposer,
    Equivocator,
    FrameFuzzer,
    GarbageSigFlooder,
    LyingFastSyncPeer,
    lockrank_report,
    own_default_stacks,
    time_limit_fixture,
)
from tendermint_tpu_torch.testing import Nemesis as PortNemesis
from tendermint_tpu_torch.testing.byzantine import committed_evidence, mutate_frame, wait_evidence_committed
from tendermint_tpu_torch.types.errors import TMError
from tendermint_tpu_torch.utils.circuit import CircuitBreaker


class Nemesis(PortNemesis):
    """The port's `Nemesis` on the CPU: a node given no verifier verifies
    on a cache of its own over `default_verifier("cpu")`'s backend."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


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
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(240))


@pytest.fixture(autouse=True)
def _own_default_stacks():
    """Nodes given no verifier verify over `default_verifier("cpu")`: each test
    runs on stacks of its own (`testing.own_default_stacks`)."""
    with own_default_stacks():
        yield


def _resilient_factory(threshold=2, reset_s=0.5):
    def factory(_i):
        return ResilientVerifier(
            HostBatchVerifier(),
            breaker=CircuitBreaker(
                failure_threshold=threshold, reset_timeout_s=reset_s
            ),
            max_retries=0,
        )

    return factory


# -- tests/test_byzantine.py -----------------------------------------------------------


class TestEquivocation:
    def test_equivocator_evidence_committed_within_five_heights(self, tmp_path):
        """THE acceptance scenario: a 4-validator net with one
        equivocating validator — honest nodes detect the conflicting
        votes, pool DuplicateVoteEvidence (verified through the batched
        verify seam), gossip it on channel 0x38, and commit it in a
        block within <= 5 heights of the offense; no fork, continuous
        progress, and the flight recorder holds the detection event."""
        with Nemesis(4, home=str(tmp_path)) as net:
            net.wait_height(2, timeout=60)
            eq = Equivocator(net, 3).start()
            try:
                honest = [0, 1, 2]
                found = wait_evidence_committed(
                    net, eq.address, nodes=honest, within_heights=5, timeout=60
                )
                assert eq.equivocations > 0
                # every honest node committed the SAME offender's proof
                for node_idx, height in found.items():
                    evs = [
                        e
                        for h, e in committed_evidence(net, node_idx)
                        if h == height
                    ]
                    assert any(e.address == eq.address for e in evs)
                # liveness continues past the punishment
                net.wait_progress(delta=2, timeout=60)
                net.check_invariants()  # no fork
                # the black box recorded both ends of the pipeline
                assert FLIGHT.recent(kind="evidence_detected")
                assert FLIGHT.recent(kind="evidence_added")
            finally:
                eq.stop()

    def test_equivocation_survives_offender_crash(self, tmp_path):
        """Evidence already pooled must survive the network losing the
        offender: pools are WAL-backed and gossip re-offers pending
        proofs, so commitment happens even after the byzantine node
        goes dark."""
        with Nemesis(4, home=str(tmp_path)) as net:
            net.wait_height(2, timeout=60)
            eq = Equivocator(net, 3).start()
            try:
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline and not any(
                    net.nodes[i].evidence_pool.depth()
                    or committed_evidence(net, i)
                    for i in (0, 1, 2)
                ):
                    time.sleep(0.05)
            finally:
                eq.stop()
            net.crash(3)  # the offender vanishes; 3 honest nodes remain
            wait_evidence_committed(
                net, eq.address, nodes=[0, 1, 2], timeout=60
            )
            net.wait_progress(delta=1, nodes=[0, 1, 2], timeout=60)
            net.check_invariants()


class TestConflictTipsQuorum:
    def test_conflicting_vote_that_tips_quorum_still_commits(self):
        """Deterministic regression for the liveness wedge the full-net
        equivocation runs exposed: a conflicting vote for a
        peer-maj23-tracked block is TALLIED first and raises second
        (`VoteSet._add_verified_vote`), so the +2/3 it just tipped must
        still drive the commit transitions — the evidence handler cannot
        simply swallow the exception, or the height wedges forever (no
        later vote re-triggers; duplicates don't re-add)."""
        import time as _time

        from tendermint_tpu_torch.types.block_id import BlockID
        from tendermint_tpu_torch.types.part_set import PartSetHeader
        from tendermint_tpu_torch.types.vote import (
            VOTE_TYPE_PRECOMMIT,
            VOTE_TYPE_PREVOTE,
            Vote,
        )
        from tests.test_torch_consensus import CHAIN, Fixture

        fx = Fixture(n_vals=4)
        fx.cs.start()
        try:
            bid = fx.proposal_block_id()
            # polka: everyone prevotes the block; our node precommits it
            fx.inject_votes(VOTE_TYPE_PREVOTE, bid, [1, 2, 3])
            fx.wait_step("Precommit")
            pc = fx.cs.votes.precommits(0)

            # validator 3 equivocates: its FAKE precommit lands first,
            # occupying its slot in the canonical vote list
            fake_bid = BlockID(b"\xbe\xef" * 16, PartSetHeader.zero())
            fake = Vote(
                validator_address=fx.privs[3].address,
                validator_index=3,
                height=fx.cs.height,
                round=0,
                timestamp=_time.time_ns(),
                type=VOTE_TYPE_PRECOMMIT,
                block_id=fake_bid,
            )
            fake = fake.with_signature(
                fx.privs[3]._signer.sign(fake.sign_bytes(CHAIN))
            )
            fx.cs.add_vote(fake, peer_id="peer3")
            deadline = _time.time() + 10
            while _time.time() < deadline and pc.get_by_index(3) is None:
                _time.sleep(0.01)
            assert pc.get_by_index(3) is not None

            # a peer claims +2/3 for the REAL block: conflicts against it
            # now tally before raising (reference SetPeerMaj23 semantics)
            pc.set_peer_maj23("claimer", bid)
            # ours + validator 1 = 20/40: below quorum...
            fx.inject_votes(VOTE_TYPE_PRECOMMIT, bid, [1])
            # ...validator 3's REAL precommit tips it to 30/40 >= +2/3
            # AND raises ErrVoteConflictingVotes in the same call
            fx.inject_votes(VOTE_TYPE_PRECOMMIT, bid, [3])
            # pre-fix: permanent wedge here (MockTicker fires no
            # round-skip rescue); post-fix: the height commits
            fx.wait_height(1, timeout=15)
            # the equivocation was still recorded on its way through
            assert FLIGHT.recent(kind="evidence_detected")
        finally:
            fx.cs.stop()


class TestConflictingProposer:
    def test_split_proposal_keeps_safety_and_liveness(self, tmp_path):
        with Nemesis(4, home=str(tmp_path)) as net:
            net.wait_height(2, timeout=60)
            cp = ConflictingProposer(net, 1).start()
            try:
                deadline = time.monotonic() + 45
                while time.monotonic() < deadline and cp.conflicts < 2:
                    time.sleep(0.05)
                assert cp.conflicts >= 1, "proposer never got a turn"
                net.wait_progress(delta=3, timeout=60)
                net.check_invariants()
            finally:
                cp.stop()


class TestGarbageSigFlood:
    def test_flooder_banned_breaker_stays_closed(self, tmp_path):
        """Satellite + acceptance: a sustained forged-sig flood through
        the vote drain AND mempool ingress debits the peer into a ban
        while `tendermint_breaker_state{kind=verify}` stays 0 — False
        verdicts are ADVERSARIAL INPUT, never device failures, so one
        attacker cannot DoS the TPU fast path into host crypto."""
        trips_before = REGISTRY.counter_value(
            "tendermint_breaker_transitions_total", kind="verify", to="open"
        )
        with Nemesis(
            4, home=str(tmp_path), verifier_factory=_resilient_factory()
        ) as net:
            net.wait_height(2, timeout=60)
            flooder = GarbageSigFlooder(net.nodes[0], net.chain_id)
            try:
                # sustained: keep refilling the channel queue until banned
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline and not flooder.banned():
                    flooder.flood_votes(64)
                    flooder.flood_txs(64)
                    time.sleep(0.05)
                assert flooder.banned(), "flooder never banned"
                assert not flooder.reconnect(), "banned peer re-admitted"
                # bad_sig offenses were scored...
                assert (
                    REGISTRY.counter_value(
                        "tendermint_p2p_peer_misbehavior_total", kind="bad_sig"
                    )
                    > 0
                )
                assert (
                    REGISTRY.counter_value("tendermint_p2p_peer_bans_total") > 0
                )
                # ...and the breaker NEVER conflated them with device
                # faults: no trips, every node still closed (= 0)
                assert (
                    REGISTRY.counter_value(
                        "tendermint_breaker_transitions_total",
                        kind="verify",
                        to="open",
                    )
                    == trips_before
                )
                assert all(
                    n.cs.verifier.breaker.state == "closed" for n in net.nodes
                )
                assert (
                    REGISTRY.counter_value("tendermint_breaker_state", kind="verify")
                    == 0
                )
                # honest consensus traffic was never starved
                net.wait_progress(delta=2, timeout=60)
                net.check_invariants()
            finally:
                flooder.stop()


class TestIngressFloodRecovery:
    def test_admission_throughput_recovers_after_flood(self):
        """Acceptance: honest-tx admission throughput after a forged-sig
        flood recovers to within 2x of the pre-flood rate, and the
        verify breaker never opens (the flood degrades nothing)."""
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.crypto.keys import gen_priv_key
        from tendermint_tpu_torch.mempool.ingress import SIGNED_TX_MAGIC, make_signed_tx
        from tendermint_tpu_torch.mempool.mempool import Mempool

        verifier = ResilientVerifier(
            HostBatchVerifier(),
            breaker=CircuitBreaker(failure_threshold=2, reset_timeout_s=0.5),
            max_retries=0,
        )
        conns = local_client_creator(KVStoreApp())()
        pool = Mempool(conns.mempool, verifier=verifier, ingress_batch=True)
        priv = gen_priv_key(b"\x11" * 32)
        try:
            def admit_rate(n, tag):
                t0 = time.perf_counter()
                last = None
                for i in range(n):
                    last = pool.check_tx_async(
                        make_signed_tx(priv, b"%s-%d=%d" % (tag, i, i))
                    )
                last.wait(30)
                return n / (time.perf_counter() - t0)

            before = admit_rate(300, b"pre")
            # the flood: forged envelopes, every signature invalid
            bad_sig = REGISTRY.counter_value(
                "tendermint_mempool_txs_total", result="bad_sig"
            )
            last = None
            for i in range(2000):
                forged = (
                    SIGNED_TX_MAGIC
                    + bytes(32)
                    + bytes(64)
                    + b"flood-%d" % i
                )
                last = pool.check_tx_async(forged)
            res = last.wait(30)
            assert not res.is_ok
            assert (
                REGISTRY.counter_value(
                    "tendermint_mempool_txs_total", result="bad_sig"
                )
                - bad_sig
                >= 2000
            )
            # adversarial False verdicts are not device failures
            assert verifier.breaker.state == "closed"
            after = admit_rate(300, b"post")
            assert after >= before / 2, (
                f"admission throughput did not recover: "
                f"{before:.0f} -> {after:.0f} tx/s"
            )
        finally:
            pool.close()


class TestLyingFastSyncPeer:
    def test_forged_chain_rejected_and_liar_banned(self):
        """A fast-syncing node offered a forged chain must apply NONE of
        it, ban the liar (forged_block debit), and finish syncing from
        the honest peer."""
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.blockchain import BlockchainReactor, BlockStore
        from tendermint_tpu_torch.db.kv import MemDB
        from tendermint_tpu_torch.p2p import NodeInfo, Switch, connect_switches
        from tendermint_tpu_torch.services.verifier import default_verifier
        from tendermint_tpu_torch.state import make_genesis_state

        from tendermint_tpu_torch.testing import TEST_CHAIN_ID as CHAIN_ID
        from tendermint_tpu_torch.testing import ChainSim

        sim = ChainSim(n_vals=4, verifier=HostBatchVerifier())
        store = BlockStore(MemDB())
        for _ in range(40):
            block = sim.advance()
            store.save_block(block, block.make_part_set(), sim.commits[-1])

        server = Switch(NodeInfo(node_id="server", moniker="s", chain_id=CHAIN_ID))
        server.add_reactor(
            "blockchain",
            BlockchainReactor(
                state=sim.state,
                store=store,
                app_conn=sim.conns.consensus,
                fast_sync=False,
            ),
        )
        server.start()

        fresh_state = make_genesis_state(MemDB(), sim.genesis)
        fresh_state.save()
        fresh_store = BlockStore(MemDB())
        conns = local_client_creator(KVStoreApp())()
        client_reactor = BlockchainReactor(
            state=fresh_state,
            store=fresh_store,
            app_conn=conns.consensus,
            fast_sync=True,
            verifier=default_verifier("cpu"),
        )
        client = Switch(NodeInfo(node_id="fresh", moniker="f", chain_id=CHAIN_ID))
        client.add_reactor("blockchain", client_reactor)
        client.start()
        liar = LyingFastSyncPeer(client, CHAIN_ID, claim_height=500)
        try:
            connect_switches(server, client)
            deadline = time.time() + 90
            while time.time() < deadline and fresh_store.height < 39:
                time.sleep(0.05)
            assert fresh_store.height >= 39, "victim never synced honest chain"
            # forged blocks never entered the store
            for h in (1, 20, 39):
                assert (
                    fresh_store.load_block(h).hash() == store.load_block(h).hash()
                )
            assert liar.blocks_served > 0, "liar was never even asked"
            deadline = time.time() + 30
            while time.time() < deadline and not liar.banned():
                time.sleep(0.05)
            assert liar.banned(), "lying peer was not banned"
        finally:
            liar.stop()
            server.stop()
            client.stop()


# -- tests/test_frame_fuzz.py ----------------------------------------------------------

# the complete set of error types wire-facing decoders may raise; a
# KeyError/IndexError/struct.error/MemoryError escaping a decoder IS
# the bug this corpus hunts
DEFINED_ERRORS = (ValueError, TMError)


def golden_frames() -> list[bytes]:
    """Real frames from every wire codec in the system."""
    from tendermint_tpu_torch.consensus.reactor import (
        DATA_CHANNEL,
        STATE_CHANNEL,
        VOTE_CHANNEL,
        HasVoteMessage,
        NewRoundStepMessage,
        VoteMessage,
    )
    from tendermint_tpu_torch.blockchain.reactor import BLOCKCHAIN_CHANNEL, _enc
    from tendermint_tpu_torch.evidence.reactor import (
        EVIDENCE_CHANNEL,
        encode_evidence_list,
    )
    from tendermint_tpu_torch.mempool.reactor import MEMPOOL_CHANNEL, encode_tx_message
    from tendermint_tpu_torch.telemetry.tracectx import TraceContext
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.part_set import PartSetHeader
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PREVOTE, Vote

    vote = Vote(
        validator_address=b"\x01" * 20,
        validator_index=0,
        height=3,
        round=0,
        timestamp=1,
        type=VOTE_TYPE_PREVOTE,
        block_id=BlockID(b"\x02" * 20, PartSetHeader.zero()),
        signature=b"\x03" * 64,
    )
    frames = [
        build_frame(STATE_CHANNEL, NewRoundStepMessage(3, 0, 1, -1).encode()),
        build_frame(STATE_CHANNEL, HasVoteMessage(3, 0, 1, 2).encode()),
        build_frame(VOTE_CHANNEL, VoteMessage(vote).encode()),
        build_frame(DATA_CHANNEL, b"\x05" + b"\x00" * 16),
        build_frame(BLOCKCHAIN_CHANNEL, _enc(0x01, 7)),
        build_frame(MEMPOOL_CHANNEL, encode_tx_message(b"tx-payload")),
        build_frame(EVIDENCE_CHANNEL, encode_evidence_list([])),
        # traced frame: context block trailing the payload
        build_frame(
            VOTE_CHANNEL,
            VoteMessage(vote).encode(),
            ctx=TraceContext(
                trace_id=b"\x00\xff" * 8, span_id=b"\x01" * 8, origin="fuzz"
            ),
        ),
    ]
    return frames


def reactor_decoders():
    from tendermint_tpu_torch.blockchain import reactor as bc
    from tendermint_tpu_torch.consensus import reactor as cons
    from tendermint_tpu_torch.evidence import reactor as evr
    from tendermint_tpu_torch.mempool import reactor as mp

    return {
        cons.STATE_CHANNEL: cons.decode_message,
        cons.DATA_CHANNEL: cons.decode_message,
        cons.VOTE_CHANNEL: cons.decode_message,
        cons.VOTE_SET_BITS_CHANNEL: cons.decode_message,
        bc.BLOCKCHAIN_CHANNEL: lambda p: bc.decode_message(p),
        mp.MEMPOOL_CHANNEL: mp.decode_tx_message,
        evr.EVIDENCE_CHANNEL: evr.decode_evidence_list,
    }


class TestFrameFuzzCorpus:
    def test_mutated_frames_raise_only_defined_errors(self):
        """5000 deterministic mutations through parse_frame + the owning
        reactor's codec: every failure must be a defined error type."""
        rng = random.Random(0xF00D)
        golden = golden_frames()
        decoders = reactor_decoders()
        parsed_ok = 0
        decode_failures = 0
        for i in range(5000):
            frame = mutate_frame(rng.choice(golden), rng)
            try:
                chan_id, payload, _ctx = parse_frame(frame)
            except DEFINED_ERRORS:
                continue
            parsed_ok += 1
            decoder = decoders.get(chan_id)
            if decoder is None:
                continue  # unknown channel: the recv loop drops it
            try:
                decoder(payload)
            except DEFINED_ERRORS:
                decode_failures += 1
        # the corpus must actually exercise both outcomes
        assert parsed_ok > 1000
        assert decode_failures > 100

    def test_trace_block_garbage_never_kills_the_frame(self):
        """A frame with a corrupt trailing trace block still delivers
        its payload (tracing is forensic, never load-bearing)."""
        rng = random.Random(7)
        base = build_frame(0x22, b"payload-bytes")
        for _ in range(200):
            garbage = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 24)))
            chan_id, payload, ctx = parse_frame(base + garbage)
            assert chan_id == 0x22
            assert payload == b"payload-bytes"

    def test_codec_roundtrip_survives_mutation(self):
        """Writer->mutate->Reader: decoding arbitrary corruption of a
        valid document raises only defined errors."""
        rng = random.Random(99)
        doc = (
            Writer()
            .uvarint(7)
            .string("hello")
            .bytes(b"\x00" * 33)
            .svarint(-12345)
            .bool(True)
            .build()
        )
        for _ in range(2000):
            data = mutate_frame(doc, rng)
            r = Reader(data)
            try:
                r.uvarint()
                r.string()
                r.bytes()
                r.svarint()
                r.bool()
                r.expect_done()
            except DEFINED_ERRORS:
                pass


class TestLiveFrameFuzz:
    """Acceptance scenario (`tests/test_frame_fuzz.py`): >= 10k mutated frames against a live peer
    pair — zero reader-thread deaths, zero node crashes, only the
    fuzzing peer disconnected."""

    def test_ten_thousand_frames_against_live_pair(self):
        import threading

        from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
        from tendermint_tpu_torch.p2p.peer import NodeInfo
        from tendermint_tpu_torch.p2p.switch import Reactor, Switch, connect_switches

        chain = "fuzz-chain"

        class Chatter(Reactor):
            """Keeps real traffic flowing between the honest pair so
            reader-thread health is observable DURING the fuzz."""

            def __init__(self):
                super().__init__()
                self.received = 0

            def get_channels(self):
                return [ChannelDescriptor(0x22), ChannelDescriptor(0x20)]

            def receive(self, chan_id, peer, payload):
                self.received += 1

        victim_reactor, honest_reactor = Chatter(), Chatter()
        victim = Switch(NodeInfo(node_id="victim", moniker="v", chain_id=chain))
        victim.add_reactor("chat", victim_reactor)
        honest = Switch(NodeInfo(node_id="honest", moniker="h", chain_id=chain))
        honest.add_reactor("chat", honest_reactor)
        victim.start()
        honest.start()
        threads_before = threading.active_count()
        try:
            connect_switches(victim, honest)
            fuzzer = FrameFuzzer(victim, chain, seed=0xBEEF)
            sent = fuzzer.run(10_000)
            assert sent >= 10_000
            fuzzer.stop()
            # only fuzzing identities were dropped: the honest link lives
            assert any(p.id == "honest" for p in victim.peers())
            # reader threads on the honest link still deliver frames
            base = victim_reactor.received
            honest.peers()[0].try_send(0x22, b"ping")
            deadline = time.time() + 10
            while time.time() < deadline and victim_reactor.received == base:
                time.sleep(0.01)
            assert victim_reactor.received > base, "victim reader thread died"
            # dead fuzz connections released their threads (no leak of
            # live readers: each dropped conn's threads exit)
            time.sleep(0.2)
            assert threading.active_count() < threads_before + 40
        finally:
            victim.stop()
            honest.stop()


# -- the port's declared difference: the evidence poll sleeps ---------------------------


def test_the_evidence_poll_sleeps_between_reads(monkeypatch):
    """`wait_evidence_committed` pauses between its reads of the stores
    (the JAX copy spins and starves the nodes it waits on): a poll that
    finds nothing sleeps, then gives up with the JAX package's message."""
    import types

    from tendermint_tpu_torch.testing import byzantine

    reads, sleeps = [], []
    store = types.SimpleNamespace(base=1, height=0, load_block=lambda h: None)
    net = types.SimpleNamespace(nodes=[types.SimpleNamespace(store=store)], violations=[], heights=lambda: [0])
    real = byzantine.committed_evidence
    monkeypatch.setattr(byzantine, "committed_evidence", lambda n, i: reads.append(i) or real(n, i))
    monkeypatch.setattr(byzantine.time, "sleep", lambda s: sleeps.append(s))
    with pytest.raises(TimeoutError, match="not committed on nodes \\[0\\] within 0.01s"):
        wait_evidence_committed(net, b"\x07" * 20, timeout=0.01)
    assert reads and len(sleeps) >= len(reads) - 1 and set(sleeps) == {0.05}


# -- across the packages ---------------------------------------------------------------

CHAIN = "byz-chain"


def test_golden_frames_and_mutations_equal_the_jax_package():
    """`FrameFuzzer.golden_frames()` and `mutate_frame` under seeded
    generators: the same bytes, frame for frame."""
    from tendermint_tpu.testing import byzantine as J

    golden = FrameFuzzer.golden_frames(None)
    assert golden == J.FrameFuzzer.golden_frames(None)
    for seed in range(20):
        ours, theirs = random.Random(seed), random.Random(seed)
        for _ in range(200):
            frame = golden[ours.randrange(len(golden))]
            assert frame == golden[theirs.randrange(len(golden))]
            assert mutate_frame(frame, ours) == J.mutate_frame(frame, theirs)


def _honest_fullcommits(n: int = 3):
    """FullCommits of a 4-validator JAX chain, and the keys in set order."""
    from tendermint_tpu.certifiers.certifier import FullCommit as JFullCommit
    from tests.helpers import ChainSim as JChainSim

    sim = JChainSim(n_vals=4, chain_id=CHAIN)
    vals = sim.state.validators
    fcs = [JFullCommit(header=sim.advance().header, commit=sim.commits[-1], validators=vals) for _ in range(n)]
    return fcs, sim._privs_in_valset_order()


def test_forge_fullcommit_encodings_equal_the_jax_package():
    """The forged FullCommit of each honest commit and each compromised
    validator encodes to the JAX package's bytes; a JAX FullCommit
    reaches the port as its encoding."""
    from tendermint_tpu.testing.byzantine import forge_fullcommit as j_forge
    from tendermint_tpu_torch.certifiers.certifier import FullCommit
    from tendermint_tpu_torch.testing import forge_fullcommit
    from tendermint_tpu_torch.testing.nemesis import make_genesis

    fcs, j_privs = _honest_fullcommits()
    _, privs = make_genesis(4, chain_id=CHAIN)
    by_addr = {p.address: p for p in privs}
    for jfc in fcs:
        fc = FullCommit.decode(jfc.encode())
        for jp in j_privs:
            assert forge_fullcommit(fc, by_addr[jp.address], CHAIN).encode() == j_forge(jfc, jp, CHAIN).encode()
    with pytest.raises(ValueError, match="compromised validator not in the honest valset"):
        forge_fullcommit(FullCommit.decode(fcs[0].encode()), make_genesis(5, CHAIN, n_active=4)[1][4], CHAIN)


def _adversary_node(pkg: str, rs, sent: list):
    """A stand-in for a Nemesis node: the round state `rs`, the chain's
    validator 1 as its key, every broadcast and send recorded in `sent`."""
    import types

    if pkg == "jax":
        from tendermint_tpu.testing.nemesis import make_genesis
    else:
        from tendermint_tpu_torch.testing.nemesis import make_genesis
    _, privs = make_genesis(4, chain_id=CHAIN)
    peer = types.SimpleNamespace(try_send=lambda chan, msg: sent.append((chan, msg)) or True)
    cs = types.SimpleNamespace(get_round_state=lambda: rs, is_proposer=lambda: True,
                               state=types.SimpleNamespace(chain_id=CHAIN))
    switch = types.SimpleNamespace(broadcast=lambda chan, msg: sent.append((chan, msg)), peers=lambda: [peer] * 3)
    return types.SimpleNamespace(priv_validator=privs[1], cs=cs, switch=switch)


def _round_state(pkg: str, height: int, round_: int, own_block: bool):
    """Validator 1's own prevote and precommit at (height, round_), for a
    block or for nil, with the 4-validator set and a proposal."""
    import types

    if pkg == "jax":
        from tendermint_tpu.testing.nemesis import make_genesis
        from tendermint_tpu.types import BlockID, PartSetHeader, Proposal, Vote
    else:
        from tendermint_tpu_torch.testing.nemesis import make_genesis
        from tendermint_tpu_torch.types import BlockID, PartSetHeader, Proposal, Vote
    genesis, privs = make_genesis(4, chain_id=CHAIN)
    vals = genesis.validator_set()
    idx, _ = vals.get_by_address(privs[1].address)
    bid = BlockID(bytes([height]) * 32, PartSetHeader(total=1, hash=b"\x05" * 20)) if own_block else BlockID.zero()
    own = {}
    for type_ in (1, 2):
        vote = Vote(validator_address=privs[1].address, validator_index=idx, height=height, round=round_,
                    timestamp=1_700_000_000_000 + height, type=type_, block_id=bid)
        own[type_] = vote.with_signature(privs[1]._signer.sign(vote.sign_bytes(CHAIN)))
    sets = {t: types.SimpleNamespace(get_by_index=lambda i, v=v: v if i == idx else None) for t, v in own.items()}
    votes = types.SimpleNamespace(prevotes=lambda r: sets[1], precommits=lambda r: sets[2])
    proposal = Proposal(height=height, round=round_, block_parts_header=PartSetHeader(total=1, hash=b"\x06" * 20),
                        pol_round=-1, pol_block_id=BlockID.zero(), timestamp=1_700_000_000_500 + height)
    return types.SimpleNamespace(votes=votes, validators=vals, round=round_, height=height, proposal=proposal)


@pytest.mark.parametrize("height,round_,own_block", [(2, 0, True), (3, 1, False), (7, 2, True)])
def test_the_adversaries_signed_messages_equal_the_jax_package(height, round_, own_block):
    """The equivocator's conflicting prevote and precommit and the
    conflicting proposer's second proposal, for the same round state:
    the same messages on the same channels, byte for byte (ed25519
    signatures are deterministic), and sign bytes the signing key
    verifies."""
    import types

    from tendermint_tpu.testing import byzantine as J
    from tendermint_tpu_torch.consensus.reactor import decode_message

    out = {}
    for pkg, eq_cls, cp_cls in (("jax", J.Equivocator, J.ConflictingProposer),
                                ("port", Equivocator, ConflictingProposer)):
        sent: list = []
        net = types.SimpleNamespace(nodes=[None, _adversary_node(pkg, _round_state(pkg, height, round_, own_block), sent)])
        eq, cp = eq_cls(net, 1), cp_cls(net, 1)
        eq._equivocate_once()
        eq._equivocate_once()  # each (height, round, type) is signed once
        cp._maybe_conflict()
        cp._maybe_conflict()
        assert (eq.equivocations, cp.conflicts) == (2, 1)
        out[pkg] = sent
    assert out["port"] == out["jax"] and len(out["port"]) == 2 + 1
    from tendermint_tpu_torch.testing.nemesis import make_genesis

    pub = make_genesis(4, chain_id=CHAIN)[1][1].pub_key
    for _chan, msg in out["port"]:
        m = decode_message(msg)
        signed = getattr(m, "vote", None) or getattr(m, "proposal")
        assert pub.verify(signed.sign_bytes(CHAIN), signed.signature)


def test_the_flooder_and_the_liar_forge_the_jax_packages_bytes():
    """Seeded `GarbageSigFlooder` votes and signed-tx envelopes, and the
    `LyingFastSyncPeer`'s forged blocks, are the JAX package's bytes."""
    import types

    from tendermint_tpu.p2p.peer import NodeInfo as JNodeInfo
    from tendermint_tpu.p2p.switch import Switch as JSwitch
    from tendermint_tpu.testing import byzantine as J
    from tendermint_tpu_torch.p2p.peer import NodeInfo
    from tendermint_tpu_torch.p2p.switch import Switch

    out = {}
    for pkg, flooder_cls, switch_cls, info_cls in (("jax", J.GarbageSigFlooder, JSwitch, JNodeInfo),
                                                   ("port", GarbageSigFlooder, Switch, NodeInfo)):
        sent: list = []
        victim_switch = switch_cls(info_cls(node_id="victim", moniker="v", chain_id=CHAIN))
        victim_switch.start()
        rs = _round_state(pkg, 5, 1, True)
        victim = types.SimpleNamespace(switch=victim_switch, cs=types.SimpleNamespace(get_round_state=lambda rs=rs: rs))
        flooder = flooder_cls(victim, CHAIN, seed=11)
        try:
            flooder._peer = types.SimpleNamespace(try_send=lambda chan, msg: sent.append((chan, msg)) or True)
            assert flooder.flood_votes(6, impersonate_index=2) == 6 and flooder.flood_txs(6) == 6
        finally:
            flooder.stop()
            victim_switch.stop()
        out[pkg] = sent
    assert out["port"] == out["jax"]
    for h in (1, 2, 9):
        ours = LyingFastSyncPeer._forged_block(types.SimpleNamespace(chain_id=CHAIN), h)
        theirs = J.LyingFastSyncPeer._forged_block(types.SimpleNamespace(chain_id=CHAIN), h)
        assert ours.encode() == theirs.encode() and ours.hash() == theirs.hash()
