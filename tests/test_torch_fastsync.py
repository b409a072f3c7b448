"""The port's block store, pool and fast-sync reactor against the JAX
package's.

The JAX package's `tests/test_fastsync.py` runs again on
`tendermint_tpu_torch.blockchain`: the pool's scheduling, timeouts,
slow-peer eviction and redo; the software pipeline at depths 1-3, a
linkage break and a forged verdict mid-pipeline (the older window
applies, the rest drains unapplied), a validator-set rotation, device
faults that fall back in order; and a 200-block store synced into a
fresh node over the p2p network. The chains are the port's `ChainSim`
on its host verifier; the reactors verify on the port's CPU stack
(`default_verifier(device="cpu")`), at the default minimum batch and at
0, where each window of 16 commits is one `madd_chain_fused` (its plain
version on the CPU) and one finish.

Across the packages, over localhost TCP: a port node fast-syncs a JAX
node's chain through a SecretConnection, a JAX node fast-syncs the same
chain from a port server over a plain link, and the two synced nodes
end with equal block hashes, state JSON and app hash. A JAX object
reaches the port only as `encode()` -> `decode()` (blocks, commits) or
JSON (the genesis document).
"""

from __future__ import annotations

import dataclasses
import time
import types

import pytest
import torch

from tendermint_tpu.abci.apps import KVStoreApp as JKVStoreApp
from tendermint_tpu.abci.client import local_client_creator as j_local_client_creator
from tendermint_tpu.blockchain import BlockchainReactor as JBlockchainReactor
from tendermint_tpu.blockchain import BlockStore as JBlockStore
from tendermint_tpu.crypto.keys import PrivKey as JPrivKey
from tendermint_tpu.db.kv import MemDB as JMemDB
from tendermint_tpu.p2p import NodeInfo as JNodeInfo
from tendermint_tpu.p2p import Switch as JSwitch
from tendermint_tpu.p2p import tcp as J_tcp
from tendermint_tpu.state import make_genesis_state as j_make_genesis_state
from tendermint_tpu.utils import lockrank as J_lockrank
from tendermint_tpu_torch import types as P
from tendermint_tpu_torch.abci.apps import KVStoreApp, PersistentKVStoreApp
from tendermint_tpu_torch.abci.client import local_client_creator
from tendermint_tpu_torch.blockchain import BlockchainReactor, BlockPool, BlockStore
from tendermint_tpu_torch.crypto.keys import PrivKey
from tendermint_tpu_torch.db.kv import MemDB
from tendermint_tpu_torch.ops import ed25519_tables as tab
from tendermint_tpu_torch.p2p import NodeInfo, Switch, connect_switches, tcp
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.services.batcher import CoalescingVerifier
from tendermint_tpu_torch.state import make_genesis_state
from tendermint_tpu_torch.testing import (
    ChainSim,
    SyncingNode,
    chain_store,
    forge_newest_precommit,
    lockrank_report,
    make_block_id,
    preloaded_reactor,
    serving_switch,
    time_limit_fixture,
)
from tendermint_tpu_torch.types.genesis import GenesisDoc

from tests.helpers import ChainSim as JChainSim

torch.set_num_threads(1)

HOST = V.HostBatchVerifier()
CHAIN = "test-chain"


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


def wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="module")
def stacks():
    """The port's default stack on the CPU at the default minimum batch
    and at 0 (the plain torch chains and finish)."""
    saved = dict(V._DEFAULTS)
    out = {}
    for name, min_batch in (("stack", None), ("chains", 0)):
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


def _fresh(stack):
    """A coalescer of its own (an empty signature cache) over `stack`'s
    resilient layer and tables."""
    return CoalescingVerifier(stack.inner)


def _sim(n_heights, app=None, txs_at=None):
    sim = ChainSim(n_vals=4, app=app, verifier=HOST)
    for h in range(1, n_heights + 1):
        sim.advance(txs=(txs_at or {}).get(h))
    return sim


@pytest.fixture(scope="module")
def chain48():
    return _sim(48)


@pytest.fixture(scope="module")
def chain40():
    return _sim(40)


# -- tests/test_fastsync.py: BlockPool ------------------------------------------------------


class TestBlockPool:
    def test_schedules_up_to_cap(self):
        pool = BlockPool(start_height=1, max_pending=8)
        pool.set_peer_height("p1", 100)
        pool.set_peer_height("p2", 100)
        reqs, evict = pool.schedule_requests(now=0.0)
        assert len(reqs) == 8 and not evict
        assert {h for _, h in reqs} == set(range(1, 9))
        assert {p for p, _ in reqs} == {"p1", "p2"}
        assert pool.schedule_requests(now=1.0) == ([], [])

    def test_timeout_evicts_peer_and_reassigns(self):
        pool = BlockPool(start_height=1, max_pending=4)
        pool.set_peer_height("p1", 100)
        reqs, evict = pool.schedule_requests(now=0.0)
        assert {p for p, _ in reqs} == {"p1"} and not evict
        pool.set_peer_height("p2", 100)
        reqs2, evict2 = pool.schedule_requests(now=100.0)
        assert evict2 == ["p1"]
        assert {p for p, _ in reqs2} == {"p2"}
        assert {h for _, h in reqs2} == set(range(1, 5))
        assert pool.num_peers() == 1

    def test_slow_drip_peer_evicted_below_min_recv_rate(self):
        clock = [0.0]
        pool = BlockPool(start_height=1, max_pending=8, time_fn=lambda: clock[0])
        pool.set_peer_height("slow", 100)
        pool.set_peer_height("fast", 100)
        reqs, evict = pool.schedule_requests(now=clock[0])
        assert not evict and {p for p, _ in reqs} == {"slow", "fast"}
        by_peer = {}
        for p, h in reqs:
            by_peer.setdefault(p, []).append(h)

        def blk(h):
            return types.SimpleNamespace(header=types.SimpleNamespace(height=h))

        for t in (1.0, 2.0, 3.0, 4.0, 5.0):
            clock[0] = t
            for h in by_peer["fast"]:
                pool.add_block("fast", blk(h), size=8000)
            by_peer["fast"] = []
        pool.add_block("slow", blk(by_peer["slow"][0]), size=100)
        reqs2, evict2 = pool.schedule_requests(now=clock[0])
        assert evict2 == ["slow"]
        assert pool.num_peers() == 1
        assert reqs2 and {p for p, _ in reqs2} == {"fast"}

    def test_rejects_unrequested_blocks(self):
        pool = BlockPool(start_height=1)
        pool.set_peer_height("p1", 10)
        pool.schedule_requests(now=0.0)
        fake = types.SimpleNamespace(header=types.SimpleNamespace(height=1))
        assert not pool.add_block("stranger", fake)
        assert pool.add_block(pool._requests[1].peer_id, fake)
        assert pool.peek(1) == [fake]

    def test_redo_drops_suffix_and_names_peer(self):
        pool = BlockPool(start_height=1)
        pool.set_peer_height("p1", 10)
        pool.schedule_requests(now=0.0)
        for h in range(1, 4):
            blk = types.SimpleNamespace(header=types.SimpleNamespace(height=h))
            pool.add_block(pool._requests[h].peer_id, blk)
        assert len(pool.peek(3)) == 3
        assert pool.redo(2) == "p1"
        assert len(pool.peek(3)) == 1

    def test_schedule_equals_the_jax_pool(self):
        """One sequence of peers, blocks and clock ticks through both
        packages' pools: the same requests, evictions and heights."""
        from tendermint_tpu.blockchain import BlockPool as JBlockPool

        clock = [0.0]
        pools = [cls(start_height=1, max_pending=12, time_fn=lambda: clock[0]) for cls in (BlockPool, JBlockPool)]
        trace = [[], []]
        for step in range(30):
            clock[0] = step * 2.5
            for pool, out in zip(pools, trace):
                if step == 0:
                    pool.set_peer_height("a", 60)
                    pool.set_peer_height("b", 40)
                if step == 9:
                    pool.set_peer_height("c", 80)
                reqs, evict = pool.schedule_requests(now=clock[0])
                for p, h in sorted(reqs):
                    if p != "b" or h % 3:  # "b" never serves every third height
                        pool.add_block(p, types.SimpleNamespace(header=types.SimpleNamespace(height=h)),
                                       size=30_000)
                while pool.peek(1):
                    pool.pop()
                out.append((sorted(reqs), evict, pool.height, pool.num_peers(), pool.is_caught_up()))
        assert trace[0] == trace[1]


# -- tests/test_fastsync.py: the pipeline --------------------------------------------------


def _stack_verifier(stacks, name):
    return HOST if name == "host" else _fresh(stacks[name])


def _close(v):
    if isinstance(v, CoalescingVerifier):
        v.coalescer.close()


@pytest.fixture
def counted(monkeypatch):
    """Launch counts of the chains and the finish on the CPU (the
    wrappers count only their CUDA launches), by counting shims."""
    calls = {"madd_chain_fused": 0, "madd_chain_entries": 0, "finish_encode_compare": 0}

    def shim(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tab, "fused_chain", shim("madd_chain_fused", tab.fused_chain))
    monkeypatch.setattr(tab, "sum_entries", shim("madd_chain_entries", tab.sum_entries))
    monkeypatch.setattr(tab, "finish_encode_compare", shim("finish_encode_compare", tab.finish_encode_compare))
    return calls


class TestFastSyncPipeline:
    @pytest.mark.parametrize("verifier", ["host", "stack"])
    def test_pipelined_sync_applies_full_chain(self, chain48, stacks, verifier):
        for depth in (1, 2, 3):
            v = _stack_verifier(stacks, verifier)
            try:
                reactor, state, store = preloaded_reactor(chain48, local_client_creator(KVStoreApp())().consensus,
                                                          v, depth=depth)
                reactor._try_sync()
            finally:
                _close(v)
            assert store.height == 47, f"depth {depth}"
            assert state.last_block_height == 47
            for h in (1, 20, 47):
                assert store.load_block(h).hash() == chain48.blocks[h - 1].hash()

    def test_windows_launch_the_fused_chain_and_the_finish(self, chain48, stacks, counted):
        """At minimum batch 0 each window of 16 commits is one fused
        chain and one finish; no window takes the entries chain."""
        v = _fresh(stacks["chains"])
        try:
            reactor, _state, store = preloaded_reactor(chain48, local_client_creator(KVStoreApp())().consensus, v)
            reactor._try_sync()
        finally:
            _close(v)
        assert store.height == 47
        # windows of 16, 16 and 15 commits (the tip waits for its successor)
        assert counted == {"madd_chain_fused": 3, "madd_chain_entries": 0, "finish_encode_compare": 3}

    def test_linkage_break_mid_pipeline_applies_intact_prefix_only(self, stacks):
        sim = _sim(40)
        bad = dataclasses.replace(sim.blocks[20].last_commit, block_id=make_block_id(b"forged"))
        sim.blocks[20] = dataclasses.replace(sim.blocks[20], last_commit=bad)
        v = _fresh(stacks["stack"])
        try:
            reactor, _state, store = preloaded_reactor(sim, local_client_creator(KVStoreApp())().consensus, v)
            reactor._try_sync()
        finally:
            _close(v)
        assert store.height == 16
        assert store.load_block(20) is None
        assert reactor.pool.height == 17
        assert all(b.header.height < 20 for b in reactor.pool.peek(50))

    @pytest.mark.parametrize("verifier", ["stack", "chains"])
    def test_forged_verdict_mid_pipeline_drains_without_applying(self, stacks, verifier):
        sim = _sim(40)
        commit = sim.blocks[20].last_commit
        for i in range(3):
            commit.precommits[i] = commit.precommits[i].with_signature(bytes(64))
        v = _fresh(stacks[verifier])
        try:
            reactor, _state, store = preloaded_reactor(sim, local_client_creator(KVStoreApp())().consensus, v)
            reactor._try_sync()
        finally:
            _close(v)
        assert store.height == 16
        assert store.load_block(17) is None
        assert store.load_block(20) is None

    def test_one_forged_precommit_fails_its_window_on_the_chains(self, stacks, counted):
        """One forged signature in height 20's commit, inside block 21
        before it was hashed, so the linkage holds: window 1 applies,
        window 2 launches and its verdict is false at the join, and it
        drains unapplied (the shape of `chip_smoke.py`'s forged step)."""
        sim = ChainSim(n_vals=4, verifier=HOST)
        for _ in range(20):
            sim.advance()
        forge_newest_precommit(sim, 1)
        sim.advance(commit_preverified=True)
        for _ in range(12):
            sim.advance()
        v = _fresh(stacks["chains"])
        redone = []
        try:
            reactor, _state, store = preloaded_reactor(sim, local_client_creator(KVStoreApp())().consensus, v)
            real_redo = reactor._redo
            reactor._redo = lambda height: (redone.append(height), real_redo(height))
            reactor._try_sync()
        finally:
            _close(v)
        assert store.height == 16 and store.load_block(17) is None
        assert redone == [17]  # the window, not a linkage break at 21
        assert counted == {"madd_chain_fused": 2, "madd_chain_entries": 0, "finish_encode_compare": 2}

    def test_valset_rotation_boundary_drains_and_crosses(self, stacks):
        sim = ChainSim(n_vals=4, app=PersistentKVStoreApp(), verifier=HOST)
        for _ in range(20):
            sim.advance()
        pub = sim.state.validators.validators[0].pub_key.data.hex()
        sim.advance(txs=[f"val:{pub}/25".encode()])
        assert sim.state.validators.hash() != sim.blocks[0].header.validators_hash
        for _ in range(19):
            sim.advance()
        v = _fresh(stacks["stack"])
        try:
            reactor, state, store = preloaded_reactor(sim, local_client_creator(PersistentKVStoreApp())().consensus, v)
            reactor._try_sync()
        finally:
            _close(v)
        assert store.height == 39
        assert state.validators.hash() == sim.state.validators.hash()

    def test_device_faults_mid_pipeline_fall_back_in_order(self, chain48):
        from tendermint_tpu_torch.services.resilient import ResilientVerifier
        from tendermint_tpu_torch.utils import fail
        from tendermint_tpu_torch.utils.circuit import CircuitBreaker

        verifier = ResilientVerifier(
            V.TableBatchVerifier(device="cpu", min_device_batch=10**6),
            breaker=CircuitBreaker(failure_threshold=100, reset_timeout_s=60),
        )
        fail.clear_device_faults()
        fail.set_device_fault("verify", 2)
        try:
            reactor, _state, store = preloaded_reactor(chain48, local_client_creator(KVStoreApp())().consensus,
                                                       verifier)
            reactor._try_sync()
        finally:
            fail.clear_device_faults()
            verifier.close()
        assert store.height == 47
        assert verifier._dispatch.fallback_calls == 2

    def test_verifier_none_is_the_card_stack(self, chain48):
        """`verifier=None` is the port's `default_verifier()`, the card's
        stack: without a card the first window raises, and the sync
        thread's catch-all would log and retry."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        reactor, _state, store = preloaded_reactor(chain48, local_client_creator(KVStoreApp())().consensus, None)
        with pytest.raises(RuntimeError):
            reactor._try_sync()
        assert store.height == 0

    def test_the_reactor_uses_the_ports_fastsync_queue(self, chain48, stacks):
        from tendermint_tpu_torch.services.dispatch import DispatchQueue

        v = _fresh(stacks["stack"])
        try:
            reactor, _state, _store = preloaded_reactor(chain48, local_client_creator(KVStoreApp())().consensus, v)
            q = reactor._queue()
            assert isinstance(q, DispatchQueue) and q.name == "fastsync"
            assert reactor._queue() is q
            reactor.on_stop()
        finally:
            _close(v)


def test_adaptive_pipeline_depth_reads_the_ports_telemetry(monkeypatch):
    from tendermint_tpu_torch.blockchain import reactor as R

    monkeypatch.setenv("TENDERMINT_TPU_PIPELINE_DEPTH", "3")
    assert R.adaptive_pipeline_depth() == 3
    monkeypatch.delenv("TENDERMINT_TPU_PIPELINE_DEPTH")
    seen = []
    monkeypatch.setattr("tendermint_tpu_torch.services.dispatch.measured_launch_apply_ratio",
                        lambda q: seen.append(q) or 2.4)
    assert R.adaptive_pipeline_depth() == 3
    monkeypatch.setattr("tendermint_tpu_torch.services.dispatch.measured_launch_apply_ratio", lambda q: None)
    assert R.adaptive_pipeline_depth() == 2
    monkeypatch.setattr("tendermint_tpu_torch.services.dispatch.measured_launch_apply_ratio", lambda q: 9.0)
    assert R.adaptive_pipeline_depth() == 4
    assert seen == ["fastsync"]


def test_messages_encode_as_the_jax_reactor_does(chain40):
    from tendermint_tpu.blockchain import reactor as JR

    from tendermint_tpu_torch.blockchain import reactor as R

    block = chain40.blocks[5]
    for tag, args in ((R._MSG_BLOCK_REQUEST, (7,)), (R._MSG_NO_BLOCK, (9,)), (R._MSG_STATUS_REQUEST, ()),
                      (R._MSG_STATUS_RESPONSE, (40,)), (R._MSG_BLOCK_RESPONSE, (block.encode(),))):
        wire = R._enc(tag, *args)
        assert wire == JR._enc(tag, *args)
        kind, arg = R.decode_message(JR._enc(tag, *args))
        assert kind == JR.decode_message(wire)[0]
        if kind == "block_response":
            assert arg.hash() == block.hash()
    with pytest.raises(ValueError, match="unknown blockchain message tag"):
        R.decode_message(b"\x09")


# -- the store --------------------------------------------------------------------------------


def test_store_keys_and_values_equal_the_jax_store(chain40):
    """The port's store, fed the chain, holds the same keys and bytes as
    the JAX store fed the same blocks by their wire form."""
    from tendermint_tpu.types.block import Block as JBlock
    from tendermint_tpu.types.block import Commit as JCommit
    from tendermint_tpu.codec.binary import Reader as JReader

    ours = chain_store(chain40, db=MemDB())
    jdb = JMemDB()
    theirs = JBlockStore(jdb)
    for block, commit in zip(chain40.blocks, chain40.commits):
        jb = JBlock.decode(block.encode())
        theirs.save_block(jb, jb.make_part_set(), JCommit.decode_from(JReader(commit.encode())))
    assert ours.height == theirs.height == 40
    assert list(ours._db.iterate(b"")) == list(jdb.iterate(b""))
    for h in (1, 17, 40):
        assert ours.load_block(h).hash() == chain40.blocks[h - 1].hash()
        assert ours.load_block_meta(h).encode() == theirs.load_block_meta(h).encode()
        assert ours.load_seen_commit(h).encode() == theirs.load_seen_commit(h).encode()


# -- tests/test_fastsync.py: end to end over the p2p network ----------------------------------


def test_syncs_200_block_store_into_fresh_node(stacks):
    sim = _sim(200)
    store = chain_store(sim)
    assert store.height == 200
    server = serving_switch(store, "server", CHAIN)
    v = _fresh(stacks["stack"])
    node = SyncingNode(sim.genesis, "fresh", local_client_creator(KVStoreApp())().consensus, v)
    try:
        connect_switches(server, node.switch)
        wait_until(lambda: node.store.height >= 199, timeout=120, msg="fresh node synced")
        assert node.reactor.state.last_block_height >= 199
        for h in (1, 50, 199):
            assert node.store.load_block(h).hash() == store.load_block(h).hash()
        assert node.reactor.blocks_synced >= 199
        assert node.caught_up.wait(timeout=30), "caught-up fired"
    finally:
        server.stop()
        node.stop()
        _close(v)


# -- across the packages, over localhost TCP ---------------------------------------------------

CROSS_HEIGHTS = 40


@pytest.fixture(scope="module")
def jax_chain():
    """A JAX chain of 40 heights with txs, in a JAX block store."""
    sim = JChainSim(n_vals=4)
    store = JBlockStore(JMemDB())
    for h in range(1, CROSS_HEIGHTS + 1):
        txs = [f"k{h}={h * 7}".encode(), f"tx-{h}".encode() * 3][: 1 + h % 2] if h % 5 else None
        block = sim.advance(txs=txs)
        store.save_block(block, block.make_part_set(), sim.commits[-1])
    return sim, store


def _port_genesis(jsim):
    return GenesisDoc.from_json(jsim.genesis.to_json())


def _layered(name):
    return J_lockrank.ranked_lock(name, seq=1)


@pytest.fixture(scope="module")
def synced(jax_chain, stacks):
    """Both directions: a port node syncs from a JAX server through a
    SecretConnection, a JAX node syncs from a port server over plain TCP.
    The JAX package's TCP write lock takes the port's `seq=1` here (see
    `tests/test_torch_p2p.py`)."""
    jsim, jstore = jax_chain
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J_tcp, "ranked_lock", _layered)
        # 1. JAX server -> port node, secret
        jkey, pkey = JPrivKey(b"\x31" * 32), PrivKey(b"\x32" * 32)
        jsrv = JSwitch(JNodeInfo(node_id=jkey.pub_key.address.hex(), moniker="jax-server", chain_id=CHAIN))
        jsrv.add_reactor("blockchain", JBlockchainReactor(state=jsim.state, store=jstore,
                                                          app_conn=jsim.conns.consensus, fast_sync=False))
        jsrv.start()
        lis = J_tcp.TcpListener(jsrv, "tcp://127.0.0.1:0", priv_key=jkey)
        v = _fresh(stacks["stack"])
        node = SyncingNode(_port_genesis(jsim), pkey.pub_key.address.hex(),
                           local_client_creator(KVStoreApp())().consensus, v)
        try:
            peer = tcp.dial(node.switch, f"127.0.0.1:{lis.port}", priv_key=pkey)
            out["port_peer_key"] = peer._conn._endpoint.remote_pub_key.data
            assert node.caught_up.wait(timeout=120), "the port node caught up"
            out["port"] = node
        finally:
            lis.stop()
            jsrv.stop()
            node.stop()
            _close(v)
        # 2. port server -> JAX node, plain: the port's store holds the
        # JAX chain by its wire form
        pstore = BlockStore(MemDB())
        for h in range(1, jstore.height + 1):
            block = P.Block.decode(jstore.load_block(h).encode())
            pstore.save_block(block, block.make_part_set(), _port_commit(jstore.load_seen_commit(h)))
        psrv = serving_switch(pstore, "port-server", CHAIN)
        plis = tcp.TcpListener(psrv, "tcp://127.0.0.1:0")
        jstate = j_make_genesis_state(JMemDB(), jsim.genesis)
        jstate.save()
        jfresh = JBlockStore(JMemDB())
        jcaught = []
        jreactor = JBlockchainReactor(state=jstate, store=jfresh,
                                      app_conn=j_local_client_creator(JKVStoreApp())().consensus, fast_sync=True,
                                      on_caught_up=jcaught.append)
        jnode = JSwitch(JNodeInfo(node_id="jax-fresh", moniker="jax-fresh", chain_id=CHAIN))
        jnode.add_reactor("blockchain", jreactor)
        jnode.start()
        try:
            J_tcp.dial(jnode, f"127.0.0.1:{plis.port}")
            wait_until(lambda: bool(jcaught), timeout=120, msg="the JAX node caught up")
            out["jax"] = types.SimpleNamespace(state=jcaught[0], store=jfresh, reactor=jreactor)
        finally:
            plis.stop()
            psrv.stop()
            jnode.stop()
    return out


def _port_commit(jcommit):
    from tendermint_tpu_torch.codec.binary import Reader

    return P.Commit.decode_from(Reader(jcommit.encode()))


def test_a_port_node_syncs_a_jax_chain_through_a_secret_connection(jax_chain, synced):
    jsim, jstore = jax_chain
    node = synced["port"]
    assert synced["port_peer_key"] == JPrivKey(b"\x31" * 32).pub_key.data
    assert node.store.height == CROSS_HEIGHTS - 1
    for h in range(1, CROSS_HEIGHTS):
        assert node.store.load_block(h).hash() == jstore.load_block(h).hash()
    assert node.state.app_hash == jstore.load_block(CROSS_HEIGHTS).header.app_hash


def test_a_jax_node_syncs_from_a_port_server(jax_chain, synced):
    jsim, jstore = jax_chain
    j = synced["jax"]
    assert j.store.height == CROSS_HEIGHTS - 1
    for h in range(1, CROSS_HEIGHTS):
        assert j.store.load_block(h).hash() == jstore.load_block(h).hash()
    assert j.state.app_hash == jstore.load_block(CROSS_HEIGHTS).header.app_hash


def test_both_synced_nodes_agree_byte_for_byte(synced):
    port, jax = synced["port"], synced["jax"]
    assert port.state.to_json() == jax.state.to_json()
    assert port.state.app_hash == jax.state.app_hash
    assert [port.store.load_block(h).hash() for h in range(1, CROSS_HEIGHTS)] == [
        jax.store.load_block(h).hash() for h in range(1, CROSS_HEIGHTS)]
    assert list(port.store._db.iterate(b"")) == list(jax.store._db.iterate(b""))
