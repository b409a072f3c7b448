"""The port's consensus reactor (`tendermint_tpu_torch/consensus/reactor.py`)
and its nets against the JAX package's.

The JAX package's own `tests/test_reactor.py` runs again on the port:
heartbeats over the wire, four validators committing ten blocks, a late
joiner catching up by gossip alone, and an equivocating proposer the
honest nodes survive, every node on the port's `HostBatchVerifier` (a
port consensus given no verifier takes the card's stack). The JAX
package's `tests/test_heightlog.py` acceptance net (every committed
height's ledger record consistent, the nodes' persisted ledgers merged
by the port's `tools/finality_report.py` as the repo's merges them) runs
on four port validators.

Across the packages: every consensus message encodes as the JAX
reactor's does and decodes the JAX reactor's bytes (a JAX object crosses
only as `encode()` into the port's `decode_message`), and a net of two
JAX and two port validators over in-process links commits three
heights with byte-equal blocks. Tolerance: exact.
"""

from __future__ import annotations

import time

import pytest

from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.client import local_client_creator
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.consensus.config import ConsensusConfig
from tendermint_tpu_torch.consensus.reactor import (
    BlockPartMessage,
    ConsensusReactor,
    DATA_CHANNEL,
    ProposalMessage,
)
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.ticker import TimeoutTicker
from tendermint_tpu_torch.db.kv import MemDB
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.p2p import NodeInfo, Switch, connect_switches
from tendermint_tpu_torch.state import make_genesis_state
from tendermint_tpu_torch.types import Txs
from tendermint_tpu_torch.types.block import Block, Commit
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.proposal import Proposal

from tendermint_tpu_torch.testing import TEST_CHAIN_ID as CHAIN, time_limit_fixture
from tendermint_tpu_torch.testing import lockrank_report, make_genesis


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


# -- tests/test_reactor.py ------------------------------------------------------------


def wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


class Node:
    """One full in-process node: consensus state + reactor + switch."""

    def __init__(self, index: int, genesis, privs, config=None, heightlog=None):
        self.index = index
        self.db = MemDB()
        self.store = BlockStore(MemDB())
        state = make_genesis_state(self.db, genesis)
        state.save()
        self.app = KVStoreApp()
        conns = local_client_creator(self.app)()
        self.cs = ConsensusState(
            config=config or ConsensusConfig.test_config(),
            state=state,
            app_conn=conns.consensus,
            block_store=self.store,
            priv_validator=privs[index],
            ticker=TimeoutTicker(),
            verifier=HostBatchVerifier(),
            heightlog=heightlog,
        )
        self.reactor = ConsensusReactor(self.cs)
        self.switch = Switch(
            NodeInfo(node_id=f"node{index}", moniker=f"val{index}", chain_id=CHAIN)
        )
        self.switch.add_reactor("consensus", self.reactor)

    def start(self):
        self.switch.start()  # reactor.on_start starts the consensus loop

    def stop(self):
        self.switch.stop()

    @property
    def height(self) -> int:
        return self.cs.height


def make_network(n_nodes: int, n_vals: int | None = None, start=True):
    genesis, privs = make_genesis(n_vals or n_nodes, chain_id=CHAIN)
    nodes = [Node(i, genesis, privs) for i in range(n_nodes)]
    if start:
        for node in nodes:
            node.start()
        for i in range(n_nodes):
            for j in range(i + 1, n_nodes):
                connect_switches(nodes[i].switch, nodes[j].switch)
    return nodes, genesis, privs


def stop_all(nodes):
    for n in nodes:
        n.stop()


class TestHeartbeatGossip:
    def test_heartbeat_travels_the_wire(self):
        """No-empty-blocks idle chain: the proposer's signed heartbeats
        are broadcast on the STATE channel and the receiving node
        verifies them (reference reactor.go:338-349,219-222)."""
        import queue

        from tendermint_tpu_torch.consensus.reactor import ProposalHeartbeatMessage

        genesis, privs = make_genesis(2, chain_id=CHAIN)
        cfg = ConsensusConfig.test_config()
        cfg.create_empty_blocks = False
        cfg.proposal_heartbeat_interval = 0.05
        nodes = [Node(i, genesis, privs, config=cfg) for i in range(2)]

        # spy on node1's state-channel traffic without disturbing dispatch
        seen: "queue.Queue" = queue.Queue()
        orig = nodes[1].reactor._receive_state

        def spying(peer, ps, msg):
            if isinstance(msg, ProposalHeartbeatMessage):
                seen.put(msg.heartbeat)
            return orig(peer, ps, msg)

        nodes[1].reactor._receive_state = spying
        for n in nodes:
            n.start()
        try:
            connect_switches(nodes[0].switch, nodes[1].switch)
            hb = seen.get(timeout=15)
            # signed by a validator of the live set over the chain id
            idx = hb.validator_index
            assert privs[idx].pub_key.verify(
                hb.sign_bytes(CHAIN), hb.signature
            )
            assert hb.height >= 1
            # chain is genuinely idle (no txs, no empty blocks)
            assert all(n.height == 1 for n in nodes)
        finally:
            stop_all(nodes)


class TestMultiNodeConsensus:
    def test_four_nodes_commit_ten_blocks(self):
        nodes, _, _ = make_network(4)
        try:
            wait_until(
                lambda: all(n.height >= 11 for n in nodes),
                timeout=120,
                msg="all nodes at height 11",
            )
            # identical chains: same stored block hash at every height
            for h in range(1, 11):
                hashes = {n.store.load_block(h).hash() for n in nodes}
                assert len(hashes) == 1, f"fork at height {h}"
            # replicated app state agrees
            app_hashes = {n.cs.state.app_hash for n in nodes}
            assert len(app_hashes) == 1
        finally:
            stop_all(nodes)

    def test_late_joiner_catches_up(self):
        # 3 of 4 validators run ahead (75% power: quorum without the 4th)
        nodes, genesis, privs = make_network(3, n_vals=4, start=False)
        for n in nodes:
            n.start()
        for i in range(3):
            for j in range(i + 1, 3):
                connect_switches(nodes[i].switch, nodes[j].switch)
        late = None
        try:
            wait_until(
                lambda: all(n.height >= 5 for n in nodes),
                timeout=120,
                msg="head nodes at height 5",
            )
            late = Node(3, genesis, privs)
            late.start()
            for n in nodes:
                connect_switches(n.switch, late.switch)
            # late node must replicate past height 5 purely via catchup
            # gossip (stored seen-commit votes + stored block parts)
            wait_until(
                lambda: late.height >= 6,
                timeout=120,
                msg="late node caught up",
            )
            for h in range(1, 5):
                assert (
                    late.store.load_block(h).hash()
                    == nodes[0].store.load_block(h).hash()
                )
        finally:
            stop_all(nodes)
            if late is not None:
                late.stop()

    def test_node_that_moved_rounds_commits_the_earlier_rounds_block(self):
        """A node that missed a height's votes moves on through the rounds
        until it proposes a block of its own, then learns from catch-up
        gossip that round 0 committed another block. Its COMMIT step must
        name the committed block's parts, so that the peers, already past
        the height, send them: named after its own proposal, the peers
        never did and the node stayed at that height for good while the
        others went on."""
        nodes, _, _ = make_network(4, start=False)
        slow = nodes[2].cs
        add_vote = slow.add_vote
        deaf = {"height": None, "since": None, "heard": False}

        def deaf_add_vote(vote, peer_id=""):
            # height 3's votes stay unheard until node 2 holds its own
            # proposal of a later round (at most 20 s)
            if deaf["height"] is None and slow.height >= 3:
                deaf.update(height=slow.height, since=time.time())
            if vote.height == deaf["height"] and not deaf["heard"]:
                rs = slow.get_round_state()
                own = rs.round >= 1 and rs.proposal is not None and rs.proposal.round == rs.round
                if not own and time.time() - deaf["since"] < 20:
                    return
                deaf["heard"] = own or "timed out"
            return add_vote(vote, peer_id)

        slow.add_vote = deaf_add_vote
        for n in nodes:
            n.start()
        for i in range(4):
            for j in range(i + 1, 4):
                connect_switches(nodes[i].switch, nodes[j].switch)
        try:
            wait_until(lambda: deaf["heard"], timeout=40, msg="node 2's own proposal of a later round")
            assert deaf["heard"] is True, deaf
            wait_until(lambda: nodes[2].height > deaf["height"] + 1, timeout=20,
                       msg=f"node 2 past height {deaf['height']}")
            assert min(n.height for n in nodes[:2]) > deaf["height"] + 1
            for h in range(1, nodes[2].height):
                assert nodes[2].store.load_block(h).hash() == nodes[0].store.load_block(h).hash()
        finally:
            stop_all(nodes)

class TestByzantineProposer:
    def test_equivocating_proposer_network_recovers(self):
        """Node 0 sends CONFLICTING proposals to different peers whenever
        it is the proposer (reference `byzantine_test.go:29-60`): no round
        it proposes can gather a polka, but honest rounds keep committing
        and every honest node stays on one chain."""
        nodes, _, _ = make_network(4)
        byz = nodes[0]

        def byzantine_decide(height, round_):
            rs = byz.cs.get_round_state()
            blocks = []
            for variant in (b"byz-a", b"byz-b"):
                block = Block.make_block(
                    height=height,
                    chain_id=CHAIN,
                    txs=Txs([variant]),
                    last_commit=rs.last_commit.make_commit()
                    if rs.last_commit is not None and height > 1
                    else Commit.empty(),
                    last_block_id=byz.cs.state.last_block_id,
                    time=time.time_ns(),
                    validators_hash=rs.validators.hash(),
                    app_hash=byz.cs.state.app_hash,
                )
                parts = block.make_part_set()
                prop = Proposal(
                    height=height,
                    round=round_,
                    block_parts_header=parts.header,
                    pol_round=-1,
                    pol_block_id=BlockID.zero(),
                    timestamp=time.time_ns(),
                )
                # sign around the double-sign guard (Byzantine behavior)
                sig = byz.cs.priv_validator._signer.sign(prop.sign_bytes(CHAIN))
                blocks.append((prop.with_signature(sig), parts))
            peers = byz.switch.peers()
            for i, peer in enumerate(peers):
                prop, parts = blocks[0] if i < len(peers) - 1 else blocks[1]
                peer.try_send(DATA_CHANNEL, ProposalMessage(prop).encode())
                for pi in range(parts.total):
                    peer.try_send(
                        DATA_CHANNEL,
                        BlockPartMessage(height, round_, parts.get_part(pi)).encode(),
                    )
            # its own consensus state gets no proposal -> prevotes nil

        byz.cs.decide_proposal_fn = byzantine_decide
        try:
            honest = nodes[1:]
            wait_until(
                lambda: all(n.height >= 6 for n in honest),
                timeout=180,
                msg="honest nodes commit despite equivocation",
            )
            for h in range(1, 6):
                hashes = {n.store.load_block(h).hash() for n in honest}
                assert len(hashes) == 1, f"fork at height {h}"
        finally:
            stop_all(nodes)


# -- tests/test_heightlog.py's live net, on port validators -----------------------


def test_every_height_has_consistent_ledger_record(tmp_path):
    """The JAX package's acceptance scenario of the height ledger on a
    net of four port validators: every committed height has a record
    whose phases sum to its commit-to-commit gap within tolerance, with
    a critical path and a laggard; the persisted ledgers merge into one
    finality report."""
    import os

    from tendermint_tpu_torch.telemetry import REGISTRY
    from tendermint_tpu_torch.telemetry.heightlog import HeightLedger
    from tendermint_tpu_torch.tools.finality_report import build_report, load_records, render_text
    from tools import finality_report as J_finality_report

    genesis, privs = make_genesis(4, chain_id=CHAIN)
    nodes = []
    for i in range(4):
        ledger = HeightLedger(path=str(tmp_path / f"node{i}" / "heights.jsonl"), node_id=f"node{i}")
        nodes.append(Node(i, genesis, privs, heightlog=ledger))
    fin0 = REGISTRY.counter_value("tendermint_consensus_commits_total")
    for n in nodes:
        n.start()
    for i in range(4):
        for j in range(i + 1, 4):
            connect_switches(nodes[i].switch, nodes[j].switch)
    try:
        wait_until(lambda: all(n.height >= 7 for n in nodes), timeout=60, msg="all nodes at height 7")
        for node in nodes:
            top = node.store.height
            deadline = time.time() + 5
            while time.time() < deadline:
                recs = {r["height"]: r for r in node.cs.height_ledger.recent()}
                if top in recs:
                    break
                time.sleep(0.02)
            for h in range(1, top + 1):
                assert h in recs, f"node{node.index} missing record for {h}"
            for h in range(2, top + 1):
                r = recs[h]
                assert r["critical_path"], r
                assert r["finality_s"] is not None
                phase_sum = sum(p["s"] for p in r["phases"].values())
                if r.get("pipelined"):
                    phase_sum -= r.get("apply_overlap_s") or 0.0
                gap = r["finality_s"]
                assert abs(phase_sum - gap) <= max(0.30 * gap, 0.1), (h, phase_sum, gap)
                for p in r["phases"].values():
                    assert p["wait_s"] + p["work_s"] == pytest.approx(p["s"], abs=5e-6)
            assert any(r.get("laggard") for r in recs.values())
            assert node.cs.vote_arrivals.snapshot()
        assert REGISTRY.get("tendermint_finality_seconds").value["count"] > 0
        assert REGISTRY.counter_value("tendermint_consensus_commits_total") > fin0
    finally:
        stop_all(nodes)
        for node in nodes:
            node.cs.height_ledger.close()
    recs = load_records([os.path.join(str(tmp_path), "node*", "heights.jsonl")])
    assert recs == J_finality_report.load_records([os.path.join(str(tmp_path), "node*", "heights.jsonl")])
    report = build_report(recs)
    assert report == J_finality_report.build_report(recs)
    assert render_text(report) == J_finality_report.render_text(report)
    assert len(report["summary"]["nodes"]) == 4
    assert report["summary"]["finality_ms"]["p50"] is not None
    assert report["summary"]["critical_path_counts"]


# -- across the packages -------------------------------------------------------------


def _jax_messages():
    """Wire forms of every consensus message, made with the JAX package's
    types."""
    from tendermint_tpu.consensus import reactor as J
    from tendermint_tpu.types.block_id import BlockID as JBlockID
    from tendermint_tpu.types.heartbeat import Heartbeat as JHeartbeat
    from tendermint_tpu.types.part_set import PartSetHeader as JPSH
    from tendermint_tpu.types.proposal import Proposal as JProposal
    from tendermint_tpu.types.tx import Txs as JTxs
    from tendermint_tpu.types.block import Block as JBlock, Commit as JCommit
    from tendermint_tpu.types.vote import Vote as JVote
    from tendermint_tpu.utils.bit_array import BitArray as JBitArray
    from tests.helpers import make_validators as j_make_validators

    vs, privs = j_make_validators(4)
    block = JBlock.make_block(height=5, chain_id=CHAIN, txs=JTxs([b"a=1", b"b=2"]), last_commit=JCommit.empty(),
                              last_block_id=JBlockID.zero(), time=1_700_000_000_000_000_000,
                              validators_hash=vs.hash(), app_hash=b"\x07" * 32)
    parts = block.make_part_set()
    bid = JBlockID(block.hash(), parts.header)
    vote = privs[2].sign_vote(CHAIN, JVote(privs[2].address, 2, 5, 1, 1_700_000_000_000_000_001, 2, bid))
    prop = JProposal(height=5, round=1, block_parts_header=parts.header, pol_round=0, pol_block_id=bid,
                     timestamp=1_700_000_000_000_000_002)
    prop = prop.with_signature(privs[1]._signer.sign(prop.sign_bytes(CHAIN)))
    hb = JHeartbeat(validator_address=privs[0].address, validator_index=0, height=5, round=1, sequence=9,
                    signature=b"\x11" * 64)
    bits = JBitArray(4, 0b1010)
    return [
        J.NewRoundStepMessage(5, 1, 3, 0).encode(),
        J.NewRoundStepMessage(1, 0, 1, -1).encode(),
        J.CommitStepMessage(5, parts.header, bits).encode(),
        J.CommitStepMessage(5, JPSH.zero(), None).encode(),
        J.ProposalMessage(prop).encode(),
        J.ProposalPOLMessage(5, 0, bits).encode(),
        J.BlockPartMessage(5, 1, parts.get_part(0)).encode(),
        J.VoteMessage(vote).encode(),
        J.HasVoteMessage(5, 1, 2, 3).encode(),
        J.VoteSetMaj23Message(5, 1, 1, bid).encode(),
        J.VoteSetBitsMessage(5, 1, 2, bid, bits).encode(),
        J.VoteSetBitsMessage(5, 1, 2, JBlockID.zero(), None).encode(),
        J.ProposalHeartbeatMessage(hb).encode(),
    ]


def test_consensus_messages_encode_alike():
    """Every consensus message the JAX reactor writes decodes in the port
    to the same message, which encodes back to the same bytes; each
    package's decoder fails alike on a bad tag and a cut message."""
    from tendermint_tpu.consensus import reactor as J
    from tendermint_tpu_torch.consensus import reactor as P

    assert (P.STATE_CHANNEL, P.DATA_CHANNEL, P.VOTE_CHANNEL, P.VOTE_SET_BITS_CHANNEL) == (
        J.STATE_CHANNEL, J.DATA_CHANNEL, J.VOTE_CHANNEL, J.VOTE_SET_BITS_CHANNEL)
    wires = _jax_messages()
    for wire in wires:
        msg = P.decode_message(wire)
        assert type(msg).__name__ == type(J.decode_message(wire)).__name__
        assert msg.encode() == wire
    for bad in (b"\x7f", wires[7][:-3], b""):
        outcomes = []
        for mod in (P, J):
            try:
                outcomes.append(("ok", mod.decode_message(bad).encode()))
            except Exception as exc:
                outcomes.append((type(exc).__name__, str(exc)))
        assert outcomes[0] == outcomes[1]


def _jax_node(index, genesis_wire, privs):
    """A JAX validator: consensus state + reactor + switch, on the JAX
    host verifier."""
    from tendermint_tpu.abci.apps import KVStoreApp as JKVStoreApp
    from tendermint_tpu.abci.client import local_client_creator as j_client
    from tendermint_tpu.blockchain.store import BlockStore as JBlockStore
    from tendermint_tpu.consensus import ConsensusConfig as JConfig
    from tendermint_tpu.consensus.reactor import ConsensusReactor as JReactor
    from tendermint_tpu.consensus.state import ConsensusState as JState
    from tendermint_tpu.consensus.ticker import TimeoutTicker as JTicker
    from tendermint_tpu.db.kv import MemDB as JMemDB
    from tendermint_tpu.p2p import NodeInfo as JNodeInfo, Switch as JSwitch
    from tendermint_tpu.services.verifier import HostBatchVerifier as JHost
    from tendermint_tpu.state import make_genesis_state as j_genesis_state
    from tendermint_tpu.types.genesis import GenesisDoc as JGenesisDoc

    import types as _types

    node = _types.SimpleNamespace(index=index)
    state = j_genesis_state(JMemDB(), JGenesisDoc.from_json(genesis_wire))
    state.save()
    node.store = JBlockStore(JMemDB())
    node.cs = JState(config=JConfig.test_config(), state=state, app_conn=j_client(JKVStoreApp())().consensus,
                     block_store=node.store, priv_validator=privs[index], ticker=JTicker(), verifier=JHost())
    node.switch = JSwitch(JNodeInfo(node_id=f"node{index}", moniker=f"val{index}", chain_id=CHAIN))
    node.switch.add_reactor("consensus", JReactor(node.cs))
    return node


def test_mixed_net_of_jax_and_port_validators_commits_equal_blocks():
    """Two JAX and two port validators of one genesis (the same keys),
    linked pairwise over in-process pipes, each side reading the other's
    `NodeInfo` from its wire form: three heights commit with byte-equal
    blocks on all four."""
    from tendermint_tpu.p2p import NodeInfo as JNodeInfo
    from tests.helpers import make_genesis as j_make_genesis
    from tendermint_tpu_torch.p2p import pipe_pair
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    j_gen, j_privs = j_make_genesis(4, chain_id=CHAIN)
    genesis, privs = make_genesis(4, chain_id=CHAIN)
    assert GenesisDoc.from_json(j_gen.to_json()).to_json() == genesis.to_json() == j_gen.to_json()
    nodes = [_jax_node(0, j_gen.to_json(), j_privs), _jax_node(1, j_gen.to_json(), j_privs),
             Node(2, genesis, privs), Node(3, genesis, privs)]

    def info_for(local, remote):
        cls = JNodeInfo if local.index < 2 else NodeInfo
        return cls.decode(remote.switch.node_info.encode())

    for n in nodes:
        n.switch.start()
    for i in range(4):
        for j in range(i + 1, 4):
            ea, eb = pipe_pair()
            nodes[i].switch.add_peer_endpoint(info_for(nodes[i], nodes[j]), ea, outbound=True)
            nodes[j].switch.add_peer_endpoint(info_for(nodes[j], nodes[i]), eb, outbound=False)
    try:
        wait_until(lambda: all(n.cs.height >= 4 for n in nodes), timeout=60, msg="all nodes at height 4")
    finally:
        for n in nodes:
            n.switch.stop()
    for h in range(1, 4):
        assert len({n.store.load_block(h).encode() for n in nodes}) == 1, f"blocks differ at height {h}"
    assert len({(n.store.load_block(3).header.app_hash, n.store.load_block(3).header.validators_hash)
                for n in nodes}) == 1
