"""The port's handshake replay (`tendermint_tpu_torch/consensus/replay.py`)
and a port node's recovery at every fail point, against the JAX package's.

The JAX package's `tests/test_replay.py` runs again on the port: the
handshake matrix on a recorded 4-block chain (replay all, some, none,
the final block through the mock app or for real, a store two ahead of
the state, genesis `InitChain`), and the crash matrix: a solo port
validator on SQLite dies at each of the 7 fail points of a height and a
clean restart must handshake, recover from its WAL and commit two more
blocks. Each fail point runs in one fresh process that imports the port
once: a forked child runs with `FAIL_TEST_INDEX` set and must exit 1 at
the fail point, then the process itself restarts the node on the same
files. The consensus runs on the port's `HostBatchVerifier` (given no
verifier it would take the card's stack).

Across the packages, seeded and with `time.time_ns` fixed: one chain
through each package's `ChainSim`, then each package's `Handshaker`
from every app height, gives the same replay counts, app hashes, app
info and byte-equal state JSON. Tolerance: exact.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.abci.client import local_client_creator
from tendermint_tpu_torch.blockchain import BlockStore
from tendermint_tpu_torch.consensus.replay import Handshaker, HandshakeError
from tendermint_tpu_torch.db.kv import MemDB
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.state import apply_block
from tendermint_tpu_torch.testing import ChainSim, lockrank_report, time_limit_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# -- tests/test_replay.py -----------------------------------------------------------


N = 4  # chain length for the matrix


class _Chain:
    """A recorded 4-block chain + state snapshots at N-1 and N."""

    def __init__(self):
        self.sim = ChainSim(n_vals=3, verifier=HostBatchVerifier())
        self.store = BlockStore(MemDB())
        self.parts = []
        for i in range(N):
            block, ps = self.sim.make_next_block(txs=[b"h%d=%d" % (i + 1, i)])
            commit = self.sim._commit_for(block, ps)
            if i == N - 1:
                self.state_before_last = self.sim.state.copy()
            apply_block(self.sim.state, block, ps.header, self.sim.conns.consensus, verifier=HostBatchVerifier())
            self.store.save_block(block, ps, commit)
            self.sim.blocks.append(block)
            self.sim.commits.append(commit)
        self.final_state = self.sim.state

    def fresh_app_at(self, height: int):
        """A new app replayed to `height` (its own independent instance)."""
        app = KVStoreApp()
        conns = local_client_creator(app)()
        from tendermint_tpu_torch.state.execution import exec_commit_block

        for h in range(1, height + 1):
            exec_commit_block(conns.consensus, self.store.load_block(h))
        return app, conns


@pytest.fixture(scope="module")
def chain():
    return _Chain()


class TestHandshakeMatrix:
    def _handshake(self, chain, state, app_height):
        app, conns = chain.fresh_app_at(app_height)
        h = Handshaker(state, chain.store, verifier=HostBatchVerifier())
        app_hash = h.handshake(conns)
        return app, conns, h, app_hash

    def test_replay_all(self, chain):
        state = chain.final_state.copy()
        app, conns, h, app_hash = self._handshake(chain, state, 0)
        assert h.n_blocks_replayed == N
        assert app_hash == state.app_hash
        assert conns.query.info_sync().last_block_height == N

    def test_replay_some(self, chain):
        state = chain.final_state.copy()
        app, conns, h, app_hash = self._handshake(chain, state, 2)
        assert h.n_blocks_replayed == N - 2
        assert app_hash == state.app_hash

    def test_replay_none(self, chain):
        state = chain.final_state.copy()
        app, conns, h, app_hash = self._handshake(chain, state, N)
        assert h.n_blocks_replayed == 0
        assert app_hash == state.app_hash

    def test_final_block_via_mock_app(self, chain):
        """App committed block N but state didn't save: state catches up
        from saved ABCIResponses without re-executing the real app."""
        state = chain.state_before_last.copy()
        state.db = chain.final_state.db  # responses live here
        app, conns = chain.fresh_app_at(N)
        before_txs = dict(app._data)
        h = Handshaker(state, chain.store, verifier=HostBatchVerifier())
        app_hash = h.handshake(conns)
        assert state.last_block_height == N
        assert app_hash == chain.final_state.app_hash
        assert app._data == before_txs  # real app was not re-mutated

    def test_final_block_via_real_replay(self, chain):
        """State saved N-1, app also behind: final block replays for real."""
        state = chain.state_before_last.copy()
        state.db = MemDB()  # fresh db; apply_block will save into it
        app, conns = chain.fresh_app_at(N - 1)
        h = Handshaker(state, chain.store, verifier=HostBatchVerifier())
        app_hash = h.handshake(conns)
        assert state.last_block_height == N
        assert app_hash == chain.final_state.app_hash
        assert conns.query.info_sync().last_block_height == N

    def test_store_ahead_of_state_by_two_rejected(self, chain):
        state = chain.state_before_last.copy()
        state.last_block_height = N - 3
        app, conns = chain.fresh_app_at(0)
        with pytest.raises(HandshakeError):
            Handshaker(state, chain.store, verifier=HostBatchVerifier()).handshake(conns)

    def test_genesis_init_chain(self):
        sim = ChainSim(n_vals=3, verifier=HostBatchVerifier())
        store = BlockStore(MemDB())
        app = KVStoreApp()
        inited = []
        app.init_chain = lambda validators: inited.append(len(validators))
        conns = local_client_creator(app)()
        Handshaker(sim.state, store, verifier=HostBatchVerifier()).handshake(conns)
        assert inited == [3]


_CRASH_SCRIPT = textwrap.dedent(
    """
    import os, sys, time, queue
    sys.path.insert(0, {repo!r})
    home = {home!r}
    from tendermint_tpu_torch.db.kv import SQLiteDB
    from tendermint_tpu_torch.abci.apps import PersistentKVStoreApp
    from tendermint_tpu_torch.abci.client import local_client_creator
    from tendermint_tpu_torch.blockchain import BlockStore
    from tendermint_tpu_torch.consensus import ConsensusConfig, ConsensusState, TimeoutTicker
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.services.verifier import HostBatchVerifier
    from tendermint_tpu_torch.state import load_state, make_genesis_state
    from tendermint_tpu_torch.testing import make_genesis
    from tendermint_tpu_torch.types import events as ev
    from tendermint_tpu_torch.utils import lockrank

    def run_node():
        state_db = SQLiteDB(home + "/state.db")
        store = BlockStore(SQLiteDB(home + "/blockstore.db"))
        app = PersistentKVStoreApp(SQLiteDB(home + "/app.db"))
        conns = local_client_creator(app)()
        gen, privs = make_genesis(1, chain_id="crash-chain")
        state = load_state(state_db)
        if state is None:
            state = make_genesis_state(state_db, gen)
            state.save()
        state.db = state_db
        Handshaker(state, store, verifier=HostBatchVerifier()).handshake(conns)
        cs = ConsensusState(
            config=ConsensusConfig.test_config(), state=state,
            app_conn=conns.consensus, block_store=store,
            priv_validator=privs[0], wal_path=home + "/cs.wal",
            ticker=TimeoutTicker(), verifier=HostBatchVerifier(),
        )
        got = queue.Queue()
        cs.event_switch.add_listener("t", ev.EVENT_NEW_BLOCK, lambda d: got.put(d))
        cs.start()
        start_h = state.last_block_height
        deadline = time.time() + 30
        while time.time() < deadline:
            data = got.get(timeout=30)
            if data.block.header.height >= start_h + 2:
                print("REACHED", data.block.header.height, flush=True)
                break
        cs.stop()

    # the crash: a child of this process runs the node with the fail
    # point armed and must die there with exit code 1
    pid = os.fork()
    if pid == 0:
        os.environ["FAIL_TEST_INDEX"] = {fail_index!r}
        try:
            run_node()
        finally:
            os._exit(0)
    _, status = os.waitpid(pid, 0)
    print("CRASHED", os.waitstatus_to_exitcode(status), flush=True)
    # restart clean: must handshake, recover, and commit 2 more blocks
    run_node()
    assert not lockrank.drain()
    assert "jax" not in sys.modules and "tendermint_tpu" not in sys.modules
    """
)


class TestCrashRecoveryMatrix:
    @pytest.mark.parametrize("fail_index", range(0, 7))
    def test_kill_at_fail_point_then_recover(self, tmp_path, fail_index):
        """Run a solo node that crashes at fail point `fail_index`, then
        restart without injection and require progress (the reference's
        test_failure_indices matrix)."""
        home = str(tmp_path)
        script = tmp_path / "node.py"
        script.write_text(_CRASH_SCRIPT.format(repo=REPO, home=home, fail_index=str(fail_index)))
        env = dict(os.environ)
        env.pop("FAIL_TEST_INDEX", None)
        env.pop("FAIL_TEST_SOFT", None)
        p = subprocess.run(
            [sys.executable, str(script)], env=env, capture_output=True, text=True,
            timeout=120,
        )
        assert "CRASHED 1\n" in p.stdout, f"index {fail_index} did not crash: {p.stdout}\n{p.stderr}"
        assert f"FAIL_TEST_INDEX={fail_index}: exiting at fail point" in p.stderr
        assert p.returncode == 0, f"recovery failed at index {fail_index}:\n{p.stdout}\n{p.stderr}"
        assert "REACHED" in p.stdout.split("CRASHED 1\n", 1)[1]


# -- across the packages ----------------------------------------------------------


def _recorded_chain(sim, apply_block_fn, store, **apply_kw):
    states = []
    for i in range(N):
        block, ps = sim.make_next_block(txs=[b"h%d=%d" % (i + 1, i), b"k%d=v" % i])
        commit = sim._commit_for(block, ps)
        states.append(sim.state.copy())
        apply_block_fn(sim.state, block, ps.header, sim.conns.consensus, **apply_kw)
        store.save_block(block, ps, commit)
        sim.blocks.append(block)
        sim.commits.append(commit)
    return states


@pytest.fixture(scope="module")
def twin_chains():
    """The same 4-block chain through each package's `ChainSim`, with
    `time.time_ns` fixed so the precommits' timestamps agree."""
    import time as time_mod

    from tendermint_tpu.blockchain import BlockStore as JBlockStore
    from tendermint_tpu.db.kv import MemDB as JMemDB
    from tendermint_tpu.state import apply_block as j_apply_block
    from tests.helpers import ChainSim as JChainSim

    saved = time_mod.time_ns
    time_mod.time_ns = lambda: 1_700_000_123_000_000_000
    try:
        jsim, jstore = JChainSim(n_vals=3), JBlockStore(JMemDB())
        jstates = _recorded_chain(jsim, j_apply_block, jstore)
        psim, pstore = ChainSim(n_vals=3, verifier=HostBatchVerifier()), BlockStore(MemDB())
        pstates = _recorded_chain(psim, apply_block, pstore, verifier=HostBatchVerifier())
    finally:
        time_mod.time_ns = saved
    for h in range(1, N + 1):
        assert pstore.load_block(h).encode() == jstore.load_block(h).encode()
    return (jsim, jstore, jstates), (psim, pstore, pstates)


def _handshake_outcome(pkg, sim, store, states, app_height, state_at):
    import importlib

    apps = importlib.import_module(pkg + ".abci.apps")
    client = importlib.import_module(pkg + ".abci.client")
    execution = importlib.import_module(pkg + ".state.execution")
    replay = importlib.import_module(pkg + ".consensus.replay")
    kv = importlib.import_module(pkg + ".db.kv")
    app = apps.KVStoreApp()
    conns = client.local_client_creator(app)()
    for h in range(1, app_height + 1):
        execution.exec_commit_block(conns.consensus, store.load_block(h))
    state = (sim.state if state_at == N else states[state_at]).copy()
    if state_at < N:
        state.db = kv.MemDB()
    kw = {"verifier": HostBatchVerifier()} if pkg == "tendermint_tpu_torch" else {}
    h = replay.Handshaker(state, store, **kw)
    try:
        app_hash = h.handshake(conns)
    except Exception as exc:  # the outcome is the class name and message
        return ("raised", type(exc).__name__, str(exc))
    info = conns.query.info_sync()
    return (h.n_blocks_replayed, app_hash, state.to_json(), info.last_block_height, info.last_block_app_hash,
            sorted(app._data.items()))


@pytest.mark.parametrize("state_at,app_height", [(N, 0), (N, 2), (N, N), (N - 1, N - 1), (N - 1, 0), (1, 3)])
def test_handshake_replays_alike_in_both_packages(twin_chains, state_at, app_height):
    (jsim, jstore, jstates), (psim, pstore, pstates) = twin_chains
    j = _handshake_outcome("tendermint_tpu", jsim, jstore, jstates, app_height, state_at)
    p = _handshake_outcome("tendermint_tpu_torch", psim, pstore, pstates, app_height, state_at)
    assert p == j
