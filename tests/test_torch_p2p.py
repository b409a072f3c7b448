"""The port's p2p layer against the JAX package's.

The JAX package's own scenarios run again on `tendermint_tpu_torch.p2p`,
`utils.flowrate` and `telemetry.gossiplog`: `tests/test_p2p.py` (pipes,
the multiplexed connection, keepalive, the switch), `test_peer_score.py`
(scores, bans, a malformed or oversize frame dropping only its sender),
`test_gossiplog.py` (the rollup's bounds, the golden bytes, a sampled-out
switch) and `test_log_flowrate.py`. The node's persistent-peer matching
runs in `test_torch_port_node.py`, the PEX reactor's gossip tags in
`test_torch_pex.py`; the gossip tables are held to the JAX package's
and to the port's blockchain, consensus, mempool and evidence reactors.

Across the packages: the wire forms are byte-equal (`NodeInfo`, frames
with and without a trace block), and a JAX `Switch` and a port `Switch`
connect over localhost TCP in both dial directions, with and without a
SecretConnection, exchange frames on a channel both ways, refuse a peer
whose claimed `node_id` is not its authenticated key, and drop the link
when a sealed frame is tampered with in flight.
"""

from __future__ import annotations

import io
import logging
import queue
import socket
import struct
import threading
import time

import pytest

from tendermint_tpu import p2p as J_p2p
from tendermint_tpu.crypto.keys import PrivKey as JPrivKey
from tendermint_tpu.p2p import connection as J_connection
from tendermint_tpu.p2p import tcp as J_tcp
from tendermint_tpu.telemetry import gossiplog as J_gossiplog
from tendermint_tpu.telemetry import tracectx as J_tracectx
from tendermint_tpu.utils import lockrank as J_lockrank
from tendermint_tpu_torch.crypto.keys import PrivKey
from tendermint_tpu_torch.p2p import (
    ChannelDescriptor,
    FuzzConfig,
    FuzzedEndpoint,
    MConnection,
    NodeInfo,
    Reactor,
    Switch,
    connect_switches,
    make_connected_switches,
    pipe_pair,
)
from tendermint_tpu_torch.p2p import tcp
from tendermint_tpu_torch.p2p.connection import MAX_FRAME_SIZE, build_frame, parse_frame
from tendermint_tpu_torch.p2p.score import MISBEHAVIOR_WEIGHTS, PeerScorer
from tendermint_tpu_torch.p2p.transport import EndpointClosed
from tendermint_tpu_torch.telemetry import REGISTRY, tracectx
from tendermint_tpu_torch.telemetry.gossiplog import (
    CHANNEL_NAMES,
    KIND_TAGS,
    GossipRollup,
    channel_name,
    classify,
    enabled_from_env,
)
from tendermint_tpu_torch.testing import join_all, lockrank_report, time_limit_fixture
from tendermint_tpu_torch.utils.flowrate import Monitor
from tendermint_tpu_torch.utils.log import kv, logger, setup_logging


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


def wait_until(pred, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


# -- tests/test_p2p.py ---------------------------------------------------------


class TestTransport:
    def test_pipe_roundtrip(self):
        a, b = pipe_pair()
        a.send(b"hello")
        assert b.recv(timeout=1) == b"hello"
        b.send(b"world")
        assert a.recv(timeout=1) == b"world"

    def test_close_wakes_receiver(self):
        a, b = pipe_pair()
        got = queue.Queue()

        def rx():
            try:
                b.recv()
            except EndpointClosed:
                got.put("closed")

        t = threading.Thread(target=rx, daemon=True)
        t.start()
        time.sleep(0.05)
        a.close()
        assert got.get(timeout=2) == "closed"

    def test_fuzzed_drop_all(self):
        a, b = pipe_pair()
        fz = FuzzedEndpoint(a, FuzzConfig(prob_drop_rw=1.0, seed=1))
        fz.send(b"dropped")
        with pytest.raises(TimeoutError):
            b.recv(timeout=0.2)

    def test_fuzzed_draws_follow_the_jax_sequence(self):
        """The same seed drops the same sends in both packages."""
        cfg = dict(prob_drop_rw=0.5, prob_dup=0.3, seed=7)

        def delivered(pkg_pipe, pkg_fuzz, pkg_cfg):
            a, b = pkg_pipe()
            fz = pkg_fuzz(a, pkg_cfg(**cfg))
            for i in range(40):
                fz.send(b"%d" % i)
            got = []
            while True:
                try:
                    got.append(b.recv(timeout=0.05))
                except TimeoutError:
                    return got

        port = delivered(pipe_pair, FuzzedEndpoint, FuzzConfig)
        jax = delivered(J_p2p.pipe_pair, J_p2p.FuzzedEndpoint, J_p2p.FuzzConfig)
        assert port == jax and 0 < len(port) < 60


class TestMConnection:
    def test_multiplex_two_channels(self):
        ea, eb = pipe_pair()
        got = queue.Queue()
        chans = [ChannelDescriptor(0x20), ChannelDescriptor(0x21)]
        ca = MConnection(ea, chans, lambda c, p: None)
        cb = MConnection(eb, chans, lambda c, p: got.put((c, p)))
        ca.start()
        cb.start()
        try:
            ca.send(0x20, b"state")
            ca.send(0x21, b"data")
            seen = {got.get(timeout=2), got.get(timeout=2)}
            assert seen == {(0x20, b"state"), (0x21, b"data")}
        finally:
            ca.stop()
            cb.stop()

    def test_ping_pong_keeps_idle_link_alive(self):
        ea, eb = pipe_pair()
        errs = queue.Queue()
        kw = dict(ping_interval=0.1, pong_timeout=0.2)
        ca = MConnection(ea, [ChannelDescriptor(1)], lambda c, p: None, lambda e: errs.put(("a", e)), **kw)
        cb = MConnection(eb, [ChannelDescriptor(1)], lambda c, p: None, lambda e: errs.put(("b", e)), **kw)
        ca.start()
        cb.start()
        try:
            time.sleep(0.8)  # several ping intervals with zero app traffic
            assert errs.empty(), f"keepalive failed: {errs.get_nowait()}"
            assert ca._running and cb._running
        finally:
            ca.stop()
            cb.stop()

    def test_dead_peer_detected_by_ping_timeout(self):
        ea, eb = pipe_pair()  # eb: open but nobody home
        errs = queue.Queue()
        ca = MConnection(ea, [ChannelDescriptor(1)], lambda c, p: None, lambda e: errs.put(e),
                         ping_interval=0.1, pong_timeout=0.15)
        ca.start()
        try:
            exc = errs.get(timeout=3)
            assert isinstance(exc, TimeoutError)
            assert not ca._running
        finally:
            ca.stop()

    def test_ctrl_channel_id_reserved(self):
        from tendermint_tpu_torch.p2p.connection import CTRL_CHANNEL

        ea, _eb = pipe_pair()
        with pytest.raises(ValueError, match="reserved"):
            MConnection(ea, [ChannelDescriptor(CTRL_CHANNEL)], lambda c, p: None)

    def test_on_error_fires_on_link_death(self):
        ea, eb = pipe_pair()
        errs = queue.Queue()
        ca = MConnection(ea, [ChannelDescriptor(1)], lambda c, p: None)
        cb = MConnection(eb, [ChannelDescriptor(1)], lambda c, p: None, lambda e: errs.put(e))
        ca.start()
        cb.start()
        try:
            ca.stop()  # closes the shared pipe
            errs.get(timeout=2)  # cb notices
        finally:
            cb.stop()


class EchoReactor(Reactor):
    CH = 0x77

    def __init__(self):
        super().__init__()
        self.received = queue.Queue()
        self.peers_added = []
        self.peers_removed = []

    def get_channels(self):
        return [ChannelDescriptor(self.CH)]

    def add_peer(self, peer):
        self.peers_added.append(peer)

    def remove_peer(self, peer, reason):
        self.peers_removed.append((peer, reason))

    def receive(self, chan_id, peer, payload):
        if payload == b"explode":
            raise RuntimeError("bad message")
        self.received.put((peer.id, payload))


def _mk_switch(i, chain_id="p2p-test"):
    sw = Switch(NodeInfo(node_id=f"node{i}", moniker=f"m{i}", chain_id=chain_id))
    sw.add_reactor("echo", EchoReactor())
    return sw


class TestSwitch:
    def test_two_switches_exchange(self):
        s0, s1 = make_connected_switches(2, _mk_switch)
        try:
            r0: EchoReactor = s0.reactor("echo")
            r1: EchoReactor = s1.reactor("echo")
            assert s0.n_peers() == 1 and s1.n_peers() == 1
            s0.broadcast(EchoReactor.CH, b"ping")
            assert r1.received.get(timeout=2) == ("node0", b"ping")
            s1.peers()[0].send(EchoReactor.CH, b"pong")
            assert r0.received.get(timeout=2) == ("node1", b"pong")
        finally:
            s0.stop()
            s1.stop()

    def test_chain_mismatch_rejected(self):
        s0 = _mk_switch(0)
        s1 = _mk_switch(1, chain_id="other-chain")
        s0.start()
        s1.start()
        try:
            with pytest.raises(ValueError, match="chain_id mismatch"):
                connect_switches(s0, s1)
            assert s0.n_peers() == 0
        finally:
            s0.stop()
            s1.stop()

    def test_duplicate_peer_rejected(self):
        s0, s1 = make_connected_switches(2, _mk_switch)
        try:
            with pytest.raises(ValueError, match="duplicate"):
                connect_switches(s0, s1)
        finally:
            s0.stop()
            s1.stop()

    def test_peer_filter_rejects_before_registration(self):
        s0 = _mk_switch(0)
        s1 = _mk_switch(1)
        s1.peer_filter = lambda info, addr: "blocklisted" if info.node_id == "node0" else None
        s0.start()
        s1.start()
        try:
            with pytest.raises(ValueError, match="peer filtered: blocklisted"):
                connect_switches(s0, s1)
            assert s1.n_peers() == 0
            s2 = _mk_switch(2)
            s2.start()
            try:
                connect_switches(s2, s1)
                assert s1.n_peers() == 1
            finally:
                s2.stop()
        finally:
            s0.stop()
            s1.stop()

    def test_raising_reactor_drops_peer(self):
        s0, s1 = make_connected_switches(2, _mk_switch)
        try:
            r1: EchoReactor = s1.reactor("echo")
            s0.broadcast(EchoReactor.CH, b"explode")
            wait_until(lambda: s1.n_peers() == 0, msg="peer dropped")
            assert len(r1.peers_removed) == 1
        finally:
            s0.stop()
            s1.stop()

    def test_full_mesh(self):
        switches = make_connected_switches(4, _mk_switch)
        try:
            for s in switches:
                assert s.n_peers() == 3
            switches[0].broadcast(EchoReactor.CH, b"hello-all")
            for s in switches[1:]:
                r: EchoReactor = s.reactor("echo")
                assert r.received.get(timeout=2) == ("node0", b"hello-all")
        finally:
            for s in switches:
                s.stop()


# -- tests/test_peer_score.py -----------------------------------------------------

SCORE_CHAIN = "score-chain"


class ScoreEchoReactor(Reactor):
    def __init__(self, chan=0x10):
        super().__init__()
        self.chan = chan
        self.received: list[bytes] = []

    def get_channels(self):
        return [ChannelDescriptor(self.chan)]

    def receive(self, chan_id, peer, payload):
        if payload == b"explode":
            raise ValueError("bad payload")
        self.received.append(payload)


def make_score_switch(n, reactor=None):
    sw = Switch(NodeInfo(node_id=f"peer{n}", moniker=f"p{n}", chain_id=SCORE_CHAIN))
    sw.add_reactor("echo", reactor if reactor is not None else ScoreEchoReactor())
    sw.start()
    return sw


def _misbehavior(kind):
    return REGISTRY.counter_value("tendermint_p2p_peer_misbehavior_total", kind=kind)


class TestPeerScorer:
    def test_accumulates_and_bans_at_threshold(self):
        clock = [0.0]
        s = PeerScorer(threshold=100, half_life_s=60, clock=lambda: clock[0])
        assert not s.debit("p", "bad_sig")  # 10
        for _ in range(8):
            s.debit("p", "bad_sig")
        assert not s.is_banned("p")
        assert s.debit("p", "bad_sig")  # crosses 100
        assert s.is_banned("p")

    def test_score_decays_with_half_life(self):
        clock = [0.0]
        s = PeerScorer(threshold=100, half_life_s=10, clock=lambda: clock[0])
        s.debit("p", "bad_frame")  # 25
        clock[0] = 10.0
        assert s.score("p") == pytest.approx(12.5)
        clock[0] = 1000.0
        assert s.score("p") < 0.01

    def test_ban_expires(self):
        clock = [0.0]
        s = PeerScorer(ban_duration_s=30, clock=lambda: clock[0])
        s.ban("p")
        assert s.is_banned("p")
        clock[0] = 31.0
        assert not s.is_banned("p")

    def test_severe_kinds_ban_fast(self):
        s = PeerScorer(threshold=100)
        assert s.debit("liar", "forged_block")
        assert s.is_banned("liar")

    def test_weights_cover_the_registered_taxonomy(self):
        for kind in ("bad_frame", "oversize_frame", "bad_msg", "bad_sig", "bad_vote", "forged_block",
                     "bad_evidence", "flood"):
            assert MISBEHAVIOR_WEIGHTS[kind] > 0
            assert _misbehavior(kind) >= 0  # the series exists from import

    def test_scorer_matches_the_jax_scorer(self):
        """The same offenses on the same clock give the same scores and
        the same ban decisions."""
        from tendermint_tpu.p2p.score import PeerScorer as JPeerScorer

        clock = [0.0]
        ours = PeerScorer(threshold=100, half_life_s=7.0, clock=lambda: clock[0])
        theirs = JPeerScorer(threshold=100, half_life_s=7.0, clock=lambda: clock[0])
        kinds = sorted(MISBEHAVIOR_WEIGHTS) + ["unknown_kind"]
        for step in range(40):
            clock[0] = step * 1.3
            kind = kinds[(step * 5) % len(kinds)]
            peer = f"p{step % 3}"
            assert ours.debit(peer, kind) == theirs.debit(peer, kind)
            assert ours.score(peer) == theirs.score(peer)
            assert ours.is_banned(peer) == theirs.is_banned(peer)


class TestSwitchMisbehavior:
    def test_threshold_ban_disconnects_and_refuses_reconnect(self):
        a, b = make_score_switch(1), make_score_switch(2)
        try:
            connect_switches(a, b)
            assert a.n_peers() == 1
            for _ in range(20):
                a.report_misbehavior("peer2", "bad_sig")
            wait_until(lambda: a.n_peers() == 0, msg="banned peer dropped")
            assert a.scorer.is_banned("peer2")
            with pytest.raises(ValueError, match="banned"):
                connect_switches(a, b)
        finally:
            a.stop()
            b.stop()

    def test_reactor_exception_scores_and_drops_peer(self):
        before = _misbehavior("bad_msg")
        a, b = make_score_switch(3), make_score_switch(4)
        try:
            connect_switches(a, b)
            b.peers()[0].try_send(0x10, b"explode")
            wait_until(lambda: a.n_peers() == 0, msg="offender dropped")
            assert _misbehavior("bad_msg") > before
            assert not a.scorer.is_banned("peer4")  # one offense != ban
        finally:
            a.stop()
            b.stop()


class TestReaderResilience:
    def _victim_with_raw_peer(self, reactor=None, node_id="raw-peer"):
        victim = make_score_switch(5, reactor)
        ea, eb = pipe_pair()
        victim.add_peer_endpoint(NodeInfo(node_id=node_id, moniker="raw", chain_id=SCORE_CHAIN), ea,
                                 outbound=False)
        return victim, eb

    def test_malformed_frame_drops_only_offender(self):
        reactor = ScoreEchoReactor()
        victim, raw = self._victim_with_raw_peer(reactor)
        honest = make_score_switch(6)
        before = _misbehavior("bad_frame")
        try:
            connect_switches(victim, honest)
            assert victim.n_peers() == 2
            raw.send(b"\x10\xff\xff\xff\xff\x7f")  # a length that lies
            wait_until(lambda: victim.n_peers() == 1, msg="offender dropped")
            assert _misbehavior("bad_frame") > before
            honest.peers()[0].try_send(0x10, b"still-alive")
            wait_until(lambda: b"still-alive" in reactor.received, msg="honest traffic flows")
        finally:
            victim.stop()
            honest.stop()

    def test_oversize_frame_drops_peer(self):
        victim, raw = self._victim_with_raw_peer(node_id="raw-big")
        before = _misbehavior("oversize_frame")
        try:
            assert victim.n_peers() == 1
            raw.send(b"\x00" * (MAX_FRAME_SIZE + 1))
            wait_until(lambda: victim.n_peers() == 0, msg="oversize sender dropped")
            assert _misbehavior("oversize_frame") > before
        finally:
            victim.stop()

    def test_repeat_bad_frame_offender_gets_banned(self):
        victim = make_score_switch(7)
        try:
            for _ in range(6):
                ea, eb = pipe_pair()
                try:
                    victim.add_peer_endpoint(NodeInfo(node_id="cycler", moniker="c", chain_id=SCORE_CHAIN), ea,
                                             outbound=False)
                except ValueError:
                    break  # banned mid-cycle: exactly the point
                eb.send(b"\x10\xff\xff\xff\xff\x7f")
                wait_until(lambda: victim.n_peers() == 0, msg="dropped")
            assert victim.scorer.is_banned("cycler")
        finally:
            victim.stop()


class TestVoteSetClaimBounds:
    def test_claim_created_tallies_are_capped(self):
        from tendermint_tpu_torch.types.block_id import BlockID
        from tendermint_tpu_torch.types.part_set import PartSetHeader
        from tendermint_tpu_torch.types.vote import VOTE_TYPE_PREVOTE
        from tendermint_tpu_torch.types.vote_set import VoteSet
        from tendermint_tpu_torch.testing import make_validators

        vals, _ = make_validators(4)
        vs = VoteSet(SCORE_CHAIN, 1, 0, VOTE_TYPE_PREVOTE, vals)
        for i in range(200):
            vs.set_peer_maj23(f"flooder{i}", BlockID(i.to_bytes(20, "big"), PartSetHeader.zero()))
        assert len(vs.votes_by_block) <= VoteSet.MAX_PEER_CLAIMS + 1

    def test_height_vote_set_refuses_round_claim_flood(self):
        from tendermint_tpu_torch.consensus.round_state import HeightVoteSet
        from tendermint_tpu_torch.testing import make_validators
        from tendermint_tpu_torch.types.block_id import BlockID
        from tendermint_tpu_torch.types.part_set import PartSetHeader
        from tendermint_tpu_torch.types.vote import VOTE_TYPE_PREVOTE

        vals, _ = make_validators(4)
        hvs = HeightVoteSet(SCORE_CHAIN, 1, vals)
        bid = BlockID(b"\x01" * 20, PartSetHeader.zero())
        for r in range(2, 500):
            hvs.set_peer_maj23(r, VOTE_TYPE_PREVOTE, "flooder", bid)
        # 1 base round pair + round 1 (catchup window) + 2 per-peer
        # catchup rounds: far below the 500 a flood asked for
        assert len(hvs._round_vote_sets) <= 6


# -- tests/test_gossiplog.py --------------------------------------------------------


class TestKindTablesMatchReactors:
    """The port's static tables against the JAX package's (whose own test
    holds them to every reactor) and against the port's reactors."""

    def test_tables_equal_the_jax_tables(self):
        assert CHANNEL_NAMES == J_gossiplog.CHANNEL_NAMES
        assert KIND_TAGS == J_gossiplog.KIND_TAGS

    def test_ported_reactors_match(self):
        import tendermint_tpu_torch.blockchain.reactor as bc
        import tendermint_tpu_torch.p2p.connection as conn

        assert CHANNEL_NAMES[bc.BLOCKCHAIN_CHANNEL] == "blockchain"
        assert CHANNEL_NAMES[conn.CTRL_CHANNEL] == "ctrl"
        assert KIND_TAGS[bc.BLOCKCHAIN_CHANNEL] == {
            bc._MSG_BLOCK_REQUEST: "block_request",
            bc._MSG_BLOCK_RESPONSE: "block_response",
            bc._MSG_NO_BLOCK: "no_block",
            bc._MSG_STATUS_REQUEST: "status_request",
            bc._MSG_STATUS_RESPONSE: "status_response",
        }
        assert KIND_TAGS[conn.CTRL_CHANNEL] == {conn._PING[0]: "ping", conn._PONG[0]: "pong"}

    def test_consensus_mempool_evidence_reactors_match(self):
        """The JAX cross-checks of the tables against the consensus,
        mempool and evidence reactors, on the port's reactors."""
        import tendermint_tpu_torch.consensus.reactor as cns
        import tendermint_tpu_torch.evidence.reactor as evr
        import tendermint_tpu_torch.mempool.reactor as mp

        names = {
            cns.STATE_CHANNEL: "cns_state",
            cns.DATA_CHANNEL: "cns_data",
            cns.VOTE_CHANNEL: "cns_vote",
            cns.VOTE_SET_BITS_CHANNEL: "cns_votebits",
            mp.MEMPOOL_CHANNEL: "mempool",
            evr.EVIDENCE_CHANNEL: "evidence",
        }
        assert {ch: CHANNEL_NAMES[ch] for ch in names} == names
        tags = {
            cns.STATE_CHANNEL: {
                cns._MSG_NEW_ROUND_STEP: "new_round_step",
                cns._MSG_COMMIT_STEP: "commit_step",
                cns._MSG_HAS_VOTE: "has_vote",
                cns._MSG_VOTE_SET_MAJ23: "vote_set_maj23",
                cns._MSG_PROPOSAL_HEARTBEAT: "proposal_heartbeat",
            },
            cns.DATA_CHANNEL: {
                cns._MSG_PROPOSAL: "proposal",
                cns._MSG_PROPOSAL_POL: "proposal_pol",
                cns._MSG_BLOCK_PART: "block_part",
            },
            cns.VOTE_CHANNEL: {cns._MSG_VOTE: "vote"},
            cns.VOTE_SET_BITS_CHANNEL: {cns._MSG_VOTE_SET_BITS: "vote_set_bits"},
            mp.MEMPOOL_CHANNEL: {mp._MSG_TX: "tx"},
            evr.EVIDENCE_CHANNEL: {evr._MSG_EVIDENCE_LIST: "evidence_list"},
        }
        assert {ch: KIND_TAGS[ch] for ch in tags} == tags

    def test_kind_vocabulary_is_cataloged(self):
        from tendermint_tpu_torch.telemetry.metrics import GOSSIP_CHANNELS, GOSSIP_KINDS

        kinds = {k for tags in KIND_TAGS.values() for k in tags.values()}
        assert kinds | {"other"} == set(GOSSIP_KINDS)
        assert set(CHANNEL_NAMES.values()) | {"other"} == set(GOSSIP_CHANNELS)

    def test_classify_unknowns_stay_bounded(self):
        assert classify(0x22, b"\x06rest") == "vote"
        assert classify(0x22, b"\x07rest") == "other"
        assert classify(0x99, b"\x01") == "other"
        assert classify(0x22, b"") == "other"
        assert channel_name(0x30) == "mempool"
        assert channel_name(0x99) == "other"


class TestRollupBounds:
    def test_peer_rows_fold_into_overflow(self):
        g = GossipRollup(enabled=True)
        for i in range(GossipRollup.MAX_PEERS + 10):
            g.record(f"peer{i}", "recv", 0x22, b"\x06v", 64)
        snap = g.snapshot()
        assert len(snap["peers"]) == GossipRollup.MAX_PEERS + 1
        assert snap["peers"][GossipRollup._OVERFLOW]["cns_vote/vote/recv"] == [10, 640]
        assert snap["channels"]["cns_vote"]["recv_msgs"] == GossipRollup.MAX_PEERS + 10

    def test_first_seen_evicts_oldest_height(self):
        g = GossipRollup(enabled=True)
        for h in range(1, GossipRollup.MAX_FIRST_HEIGHTS + 3):
            g.first_seen("vote", h, 0, 0)
        snap = g.snapshot()
        heights = {int(k.split("/")[1]) for k in snap["first_seen"]}
        assert len(heights) == GossipRollup.MAX_FIRST_HEIGHTS
        assert min(heights) == 3
        g.first_seen("vote", 1, 0, 0)
        assert len(g.snapshot()["first_seen"]) == len(snap["first_seen"])

    def test_first_seen_per_height_cap(self):
        g = GossipRollup(enabled=True)
        g.MAX_FIRST_PER_HEIGHT = 4
        for i in range(10):
            g.first_seen("vote", 5, 0, i)
        assert len(g.snapshot()["first_seen"]) == 4

    def test_first_seen_earliest_stamp_wins(self):
        g = GossipRollup(enabled=True)
        g.first_seen("vote", 5, 0, 1)
        t0 = g.snapshot()["first_seen"]["vote/5/0/1"]
        time.sleep(0.02)
        g.first_seen("vote", 5, 0, 1)
        assert g.snapshot()["first_seen"]["vote/5/0/1"] == t0

    def test_record_is_thread_safe(self):
        g = GossipRollup(enabled=True)

        def pump(pid):
            for _ in range(500):
                g.record(pid, "recv", 0x30, b"\x01tx", 32)

        threads = [threading.Thread(target=pump, args=(f"p{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        join_all(threads, 60)
        assert g.snapshot()["channels"]["mempool"]["recv_msgs"] == 2000

    def test_snapshot_equals_the_jax_rollup(self):
        """One traffic sequence through both packages' rollups: the same
        tables, factors and headline (timestamps aside)."""
        ours, theirs = GossipRollup(enabled=True), J_gossiplog.GossipRollup(enabled=True)
        seq = [("p1", "recv", 0x22, b"\x06v", 64), ("p2", "send", 0x21, b"\x05part", 4096),
               ("p1", "recv", 0x30, b"\x01tx", 40), ("p3", "recv", 0x40, b"\x02blk", 200_000),
               ("p2", "recv", 0x38, b"\x01ev", 100), ("p1", "send", 0xFF, b"\x01", 3)]
        for g in (ours, theirs):
            for args in seq:
                g.record(*args)
            g.redundant("vote", 64)
            g.redundant("evidence", 100)
        a, b = ours.snapshot(), theirs.snapshot()
        for key in ("peers", "channels", "kinds", "redundant"):
            assert a[key] == b[key], key
        assert ours.redundancy_factors() == theirs.redundancy_factors()
        assert ours.headline() == theirs.headline()


class TestDisabledRollup:
    def test_disabled_is_a_noop(self):
        g = GossipRollup(enabled=False)
        g.record("p", "recv", 0x22, b"\x06v", 64)
        g.redundant("vote", 64)
        g.first_seen("vote", 1, 0, 0)
        snap = g.snapshot()
        assert snap["enabled"] is False
        assert snap["peers"] == {} and snap["redundant"] == {} and snap["first_seen"] == {}
        assert g.headline() == {"enabled": False}
        assert g.redundancy_factors() == {}

    def test_env_knob(self, monkeypatch):
        monkeypatch.delenv("TENDERMINT_TPU_GOSSIPLOG", raising=False)
        assert enabled_from_env() is True
        monkeypatch.setenv("TENDERMINT_TPU_GOSSIPLOG", "0")
        assert enabled_from_env() is False
        assert GossipRollup().enabled is False
        monkeypatch.setenv("TENDERMINT_TPU_GOSSIPLOG", "1")
        assert GossipRollup().enabled is True


class TestRedundancyFactors:
    def test_delivered_over_useful(self):
        g = GossipRollup(enabled=True)
        for _ in range(10):
            g.record("p", "recv", 0x22, b"\x06v", 64)
        for _ in range(4):
            g.redundant("vote", 64)
        assert g.redundancy_factors()["vote"] == round(10 / 6, 3)

    def test_wire_kind_join_for_evidence(self):
        g = GossipRollup(enabled=True)
        for _ in range(4):
            g.record("p", "recv", 0x38, b"\x01ev", 100)
        g.redundant("evidence", 100)
        assert g.redundancy_factors()["evidence"] == round(4 / 3, 3)

    def test_fallback_without_wire_traffic(self):
        g = GossipRollup(enabled=True)
        g.redundant("tx", 32)
        g.redundant("tx", 32)
        assert g.redundancy_factors()["tx"] == 3.0

    def test_headline_names_top_waste(self):
        g = GossipRollup(enabled=True)
        g.record("p", "recv", 0x21, b"\x05part", 4096)
        g.redundant("vote", 64)
        g.redundant("block_part", 4096)
        g.redundant("block_part", 4096)
        h = g.headline()
        assert h["top_redundant_kind"] == "block_part"
        assert h["top_redundant_msgs"] == 2
        assert h["hottest_channel"] == "cns_data"
        assert h["hottest_channel_bytes"] == 4096


class _Tap:
    """Endpoint wrapper that records every raw wire write, unmodified."""

    def __init__(self, inner):
        self._inner = inner
        self.frames = []

    def send(self, data):
        self.frames.append(bytes(data))
        self._inner.send(data)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class TestGoldenBytes:
    PAYLOADS = [
        (0x22, b"\x06" + b"v" * 80),
        (0x21, b"\x05" + b"p" * 200),
        (0x30, b"\x01" + b"t" * 33),
        (0x22, b"\x06" + b"w" * 80),
    ]

    def _pump(self, on_traffic, mconn=MConnection, pipes=pipe_pair, desc=ChannelDescriptor):
        ea, eb = pipes()
        tap = _Tap(ea)
        got = queue.Queue()
        chans = [desc(0x21), desc(0x22), desc(0x30)]
        ca = mconn(tap, chans, lambda c, p: None, ping_interval=0, on_traffic=on_traffic)
        cb = mconn(eb, chans, lambda c, p: got.put((c, p)), ping_interval=0)
        ca.start()
        cb.start()
        try:
            for chan, payload in self.PAYLOADS:
                ca.send(chan, payload)
                assert got.get(timeout=2) == (chan, payload)
        finally:
            ca.stop()
            cb.stop()
        return tap.frames

    def test_frames_byte_identical_with_accounting(self):
        g = GossipRollup(enabled=True)
        instrumented = self._pump(lambda d, c, p, n: g.record("peer", d, c, p, n))
        plain = self._pump(None)
        assert instrumented == plain
        snap = g.snapshot()
        assert snap["kinds"]["vote"]["send_msgs"] == 2
        assert snap["kinds"]["block_part"]["send_msgs"] == 1
        assert snap["kinds"]["tx"]["send_msgs"] == 1
        assert sum(st["send_bytes"] for st in snap["channels"].values()) == sum(len(f) for f in instrumented)

    def test_frames_equal_the_jax_connections(self):
        ours = self._pump(None)
        theirs = self._pump(None, J_p2p.MConnection, J_p2p.pipe_pair, J_p2p.ChannelDescriptor)
        assert ours == theirs

    def test_build_frame_ignores_gossip_env(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_GOSSIPLOG", "1")
        on = build_frame(0x22, b"\x06payload")
        monkeypatch.setenv("TENDERMINT_TPU_GOSSIPLOG", "0")
        off = build_frame(0x22, b"\x06payload")
        assert on == off


class _Echo(Reactor):
    def __init__(self, chan_id):
        super().__init__()
        self.chan_id = chan_id
        self.got = queue.Queue()

    def get_channels(self):
        return [ChannelDescriptor(self.chan_id)]

    def receive(self, chan_id, peer, data):
        self.got.put(bytes(data))


class TestInterop:
    def test_instrumented_and_sampled_out_switches_interop(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_GOSSIPLOG", "0")
        plain = Switch(NodeInfo("p" * 40, "plain", "interop"))
        monkeypatch.setenv("TENDERMINT_TPU_GOSSIPLOG", "1")
        inst = Switch(NodeInfo("i" * 40, "inst", "interop"))
        assert plain.gossip.enabled is False and inst.gossip.enabled is True
        plain.ping_interval = inst.ping_interval = 0
        er_p = plain.add_reactor("echo", _Echo(0x22))
        er_i = inst.add_reactor("echo", _Echo(0x22))
        plain.start()
        inst.start()
        try:
            pp, pi = connect_switches(plain, inst)
            assert pp.send(0x22, b"\x06from-plain")
            assert pi.send(0x22, b"\x06from-inst")
            assert er_i.got.get(timeout=2) == b"\x06from-plain"
            assert er_p.got.get(timeout=2) == b"\x06from-inst"
            wait_until(lambda: inst.gossip.snapshot()["kinds"].get("vote", {}).get("recv_msgs", 0) >= 1,
                       msg="instrumented recv accounting")
            snap = inst.gossip.snapshot()
            assert snap["kinds"]["vote"]["send_msgs"] >= 1
            assert "p" * 40 in snap["peers"]
            assert plain.gossip.snapshot()["peers"] == {}
        finally:
            plain.stop()
            inst.stop()


# -- tests/test_log_flowrate.py -------------------------------------------------------


class TestLogging:
    def test_per_module_levels(self):
        buf = io.StringIO()
        setup_logging("state:info,consensus:debug,*:error", stream=buf)
        kv(logger("state"), logging.INFO, "state info")
        kv(logger("state"), logging.DEBUG, "state debug")
        kv(logger("consensus"), logging.DEBUG, "cs debug")
        kv(logger("p2p"), logging.INFO, "p2p info")
        kv(logger("p2p"), logging.ERROR, "p2p err")
        out = buf.getvalue()
        assert "state info" in out and "state debug" not in out
        assert "cs debug" in out
        assert "p2p info" not in out and "p2p err" in out
        buf2 = io.StringIO()
        setup_logging("*:error", stream=buf2)
        kv(logger("consensus"), logging.DEBUG, "now filtered")
        assert "now filtered" not in buf2.getvalue()

    def test_kv_format(self):
        buf = io.StringIO()
        setup_logging("blockchain:info,*:error", stream=buf)
        kv(logger("blockchain"), logging.INFO, "fast-sync progress", height=42, blocks_per_s=7.5)
        line = buf.getvalue().strip()
        assert 'module=blockchain msg="fast-sync progress"' in line
        assert "height=42" in line and "blocks_per_s=7.5" in line
        assert line.startswith("ts=")
        setup_logging("*:error")


class TestFlowrate:
    def test_totals_and_rate(self):
        m = Monitor(window_s=0.05)
        for _ in range(10):
            m.update(1000)
        assert m.total == 10_000
        time.sleep(0.08)
        assert m.rate > 0

    def test_throttle_caps_rate(self):
        m = Monitor(limit_bytes_per_s=50_000, window_s=0.2)
        start = time.monotonic()
        sent = 0
        while sent < 25_000:
            m.throttle()
            m.update(5_000)
            sent += 5_000
        elapsed = time.monotonic() - start
        assert elapsed >= 0.3, f"throttle too weak: {elapsed:.3f}s"

    def test_unlimited_never_sleeps(self):
        m = Monitor()
        start = time.monotonic()
        for _ in range(1000):
            m.throttle()
            m.update(10_000)
        assert time.monotonic() - start < 0.5

    def test_rate_equals_the_jax_monitor_on_one_clock(self):
        from tendermint_tpu.utils.flowrate import Monitor as JMonitor

        clock = [0.0]
        ours = Monitor(window_s=1.0, time_fn=lambda: clock[0])
        theirs = JMonitor(window_s=1.0, time_fn=lambda: clock[0])
        for step in range(30):
            clock[0] = step * 0.37
            for m in (ours, theirs):
                m.update(1000 + 137 * step)
            assert (ours.total, ours.rate) == (theirs.total, theirs.rate)


# -- the wire, across the packages ------------------------------------------------------


def test_node_info_encodes_as_the_jax_package_does():
    for info in (dict(node_id="ab" * 20, moniker="m", chain_id="c"),
                 dict(node_id="x", moniker="ü", chain_id="c2", version="9", channels=(0x40, 0xFF),
                      listen_addr="127.0.0.1:26656")):
        ours, theirs = NodeInfo(**info), J_p2p.NodeInfo(**info)
        assert ours.encode() == theirs.encode()
        assert NodeInfo.decode(theirs.encode()) == ours
        assert ours.compatible_with(NodeInfo(**{**info, "node_id": "other"})) == theirs.compatible_with(
            J_p2p.NodeInfo(**{**info, "node_id": "other"}))


@pytest.mark.parametrize("traced", [False, True])
def test_frames_cross_both_parsers(traced):
    ctx = tracectx.TraceContext(b"\x01" * 8, b"\x02" * 8, "node-7") if traced else None
    jctx = J_tracectx.TraceContext(b"\x01" * 8, b"\x02" * 8, "node-7") if traced else None
    ours = build_frame(0x40, b"\x02" + b"b" * 300, ctx)
    theirs = J_connection.build_frame(0x40, b"\x02" + b"b" * 300, jctx)
    assert ours == theirs
    chan, payload, got = parse_frame(theirs)
    assert (chan, payload) == (0x40, b"\x02" + b"b" * 300)
    assert (got.trace if got else None) == (jctx.trace if jctx else None)


# -- a JAX node and a port node over localhost TCP --------------------------------------

CHAN = 0x42
TCP_CHAIN = "tcp-interop"


def _node(pkg: str, seed: int, node_id: str | None = None):
    """A started switch of either package with an echo reactor, and its
    node key (the key's address is its node id unless `node_id` lies)."""
    if pkg == "port":
        key, sw_cls, info_cls, reactor = PrivKey(bytes([seed]) * 32), Switch, NodeInfo, _Echo(CHAN)
    else:
        key, sw_cls, info_cls = JPrivKey(bytes([seed]) * 32), J_p2p.Switch, J_p2p.NodeInfo

        class _JEcho(J_p2p.Reactor):
            def __init__(self):
                super().__init__()
                self.got = queue.Queue()

            def get_channels(self):
                return [J_p2p.ChannelDescriptor(CHAN)]

            def receive(self, chan_id, peer, data):
                self.got.put(bytes(data))

        reactor = _JEcho()
    sw = sw_cls(info_cls(node_id=node_id or key.pub_key.address.hex(), moniker=f"{pkg}{seed}", chain_id=TCP_CHAIN))
    sw.ping_interval = 0
    sw.add_reactor("echo", reactor)
    sw.start()
    return sw, reactor, key


def _net(pkg):
    return tcp if pkg == "port" else J_tcp


@pytest.fixture(autouse=True)
def _jax_tcp_write_lock_layered(monkeypatch):
    """The JAX package's TCP write lock with the port's `seq=1`: the JAX
    sanitizer otherwise reports its own SecretConnection-over-TCP
    layering as a rank inversion (pinned below), which would fail every
    cross-package secret link under the suite's guard."""
    monkeypatch.setattr(J_tcp, "ranked_lock", lambda name: J_lockrank.ranked_lock(name, seq=1))


def test_the_secret_over_tcp_layering_is_declared_in_the_port_only(monkeypatch):
    """Deliberate difference: both packages hold the SecretEndpoint's
    write lock while the TcpEndpoint's is taken, both named
    `p2p.conn.write`. The JAX sanitizer records that as a rank
    inversion; the port's TCP lock carries seq 1, so its sanitizer
    records nothing."""
    monkeypatch.undo()  # the JAX transport as it ships
    J_lockrank.drain()
    for pkg in ("jax", "port"):
        srv, _, srv_key = _node(pkg, 41)
        cli, _, cli_key = _node(pkg, 42)
        lis = _net(pkg).TcpListener(srv, "tcp://127.0.0.1:0", priv_key=srv_key)
        try:
            _net(pkg).dial(cli, f"127.0.0.1:{lis.port}", priv_key=cli_key)
            wait_until(lambda: srv.n_peers() == 1, msg="linked")
        finally:
            _stop(lis, cli, srv)
    jax_kinds = {v["kind"] for v in J_lockrank.drain()}
    assert jax_kinds == {"rank_inversion"}
    assert lockrank_report() == ""


def _stop(*things):
    for t in things:
        t.stop()


@pytest.mark.parametrize("secret", [False, True], ids=["plain", "secret"])
@pytest.mark.parametrize("dialer", ["port", "jax"])
def test_jax_and_port_nodes_link_over_tcp(dialer, secret):
    listener_pkg = "jax" if dialer == "port" else "port"
    srv, srv_echo, srv_key = _node(listener_pkg, 11)
    cli, cli_echo, cli_key = _node(dialer, 12)
    lis = _net(listener_pkg).TcpListener(srv, "tcp://127.0.0.1:0", priv_key=srv_key if secret else None)
    try:
        peer = _net(dialer).dial(cli, f"127.0.0.1:{lis.port}", priv_key=cli_key if secret else None)
        assert peer.id == srv_key.pub_key.address.hex()
        wait_until(lambda: srv.n_peers() == 1, msg="listener registered the dialer")
        ep = peer._conn._endpoint
        if secret:
            assert ep.remote_pub_key.data == srv_key.pub_key.data
            assert srv.peers()[0]._conn._endpoint.remote_pub_key.data == cli_key.pub_key.data
        else:
            assert getattr(ep, "remote_pub_key", None) is None
        for i in range(3):
            assert peer.send(CHAN, b"to-listener-%d" % i)
            assert srv.peers()[0].send(CHAN, b"to-dialer-%d" % i)
        assert [srv_echo.got.get(timeout=5) for _ in range(3)] == [b"to-listener-%d" % i for i in range(3)]
        assert [cli_echo.got.get(timeout=5) for _ in range(3)] == [b"to-dialer-%d" % i for i in range(3)]
    finally:
        _stop(lis, cli, srv)


@pytest.mark.parametrize("liar", ["port", "jax"])
def test_a_false_node_id_is_refused_across_packages(liar):
    """The authenticated key must own the claimed node id: the honest
    side's `_check_identity` refuses the liar, as dialer and as
    listener."""
    honest_pkg = "jax" if liar == "port" else "port"
    honest, _, honest_key = _node(honest_pkg, 21)
    lying, _, lying_key = _node(liar, 22, node_id="ee" * 20)
    # the liar dials: the honest listener refuses to register it
    lis = _net(honest_pkg).TcpListener(honest, "tcp://127.0.0.1:0", priv_key=honest_key)
    try:
        _net(liar).dial(lying, f"127.0.0.1:{lis.port}", priv_key=lying_key)
        wait_until(lambda: lying.n_peers() == 0, msg="refused link closed on the liar")
        assert honest.n_peers() == 0
    finally:
        lis.stop()
    # the honest node dials the liar: dial itself raises
    lis = _net(liar).TcpListener(lying, "tcp://127.0.0.1:0", priv_key=lying_key)
    try:
        with pytest.raises(ValueError, match="authenticated identity"):
            _net(honest_pkg).dial(honest, f"127.0.0.1:{lis.port}", priv_key=honest_key)
        assert honest.n_peers() == 0
    finally:
        _stop(lis, lying, honest)
    # and the check itself gives the same verdict in both packages
    ep = type("Ep", (), {"remote_pub_key": honest_key.pub_key})()
    bad = NodeInfo(node_id="ee" * 20, moniker="x", chain_id=TCP_CHAIN)
    with pytest.raises(ValueError) as ours:
        tcp._check_identity(ep, bad)
    with pytest.raises(ValueError) as theirs:
        J_tcp._check_identity(ep, J_p2p.NodeInfo(node_id="ee" * 20, moniker="x", chain_id=TCP_CHAIN))
    assert str(ours.value) == str(theirs.value)


class _TamperProxy:
    """A localhost relay that forwards length-prefixed frames both ways
    and flips one byte of the `tamper_at`-th frame from dialer to
    listener (frames 1-3 are the ephemeral key, the auth frame and the
    NodeInfo)."""

    def __init__(self, target_port: int, tamper_at: int) -> None:
        self._target = target_port
        self._tamper_at = tamper_at
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self._socks = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        try:
            a, _ = self._srv.accept()
        except OSError:
            return
        b = socket.create_connection(("127.0.0.1", self._target))
        self._socks += [a, b]
        threading.Thread(target=self._pump, args=(a, b, self._tamper_at), daemon=True).start()
        threading.Thread(target=self._pump, args=(b, a, 0), daemon=True).start()

    @staticmethod
    def _read(s, n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise OSError("closed")
            buf += chunk
        return buf

    def _pump(self, src, dst, tamper_at):
        seen = 0
        try:
            while True:
                head = self._read(src, 4)
                body = bytearray(self._read(src, struct.unpack(">I", head)[0]))
                seen += 1
                if seen == tamper_at:
                    body[0] ^= 0xFF
                dst.sendall(head + bytes(body))
        except OSError:
            for s in (src, dst):
                _shut(s)

    def stop(self):
        self._srv.close()
        for s in self._socks:
            _shut(s)


def _shut(s):
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    s.close()


@pytest.mark.parametrize("receiver", ["port", "jax"])
def test_a_tampered_sealed_frame_closes_the_link(receiver):
    sender_pkg = "jax" if receiver == "port" else "port"
    rx, rx_echo, rx_key = _node(receiver, 31)
    tx, _, tx_key = _node(sender_pkg, 32)
    lis = _net(receiver).TcpListener(rx, "tcp://127.0.0.1:0", priv_key=rx_key)
    proxy = _TamperProxy(lis.port, tamper_at=5)
    try:
        peer = _net(sender_pkg).dial(tx, f"127.0.0.1:{proxy.port}", priv_key=tx_key)
        wait_until(lambda: rx.n_peers() == 1, msg="handshake through the relay")
        assert peer.send(CHAN, b"intact")  # frame 4
        assert rx_echo.got.get(timeout=5) == b"intact"
        assert peer.send(CHAN, b"tampered")  # frame 5: its tag no longer matches
        wait_until(lambda: rx.n_peers() == 0, msg="receiver dropped the link")
        wait_until(lambda: tx.n_peers() == 0, msg="sender saw the link close")
        assert rx_echo.got.empty()
    finally:
        _stop(proxy, lis, tx, rx)
