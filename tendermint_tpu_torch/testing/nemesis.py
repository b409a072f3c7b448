"""Nemesis: a chaos harness for multi-node in-process consensus networks.

Runs N full consensus nodes (ConsensusState + reactor + Switch, the
`tests/test_reactor.py` topology promoted to a reusable harness) in one
process and attacks them while INVARIANT CHECKERS run continuously:

* **no-fork** — every height stored by 2+ nodes has exactly one block
  hash across all block stores;
* **commit agreement** — each node's seen-commit for a height certifies
  the block it stored at that height;
* **eventual progress** — after faults clear, the network keeps
  committing (asserted by `wait_height` / `wait_progress`).

Fault primitives compose (Jepsen-nemesis style, hence the name):

* `partition(groups)` / `heal()` — switch-level link black-holing via
  runtime `LinkChaos` flags (`p2p/transport.py`); new links inherit the
  live partition, so a restarting node cannot tunnel across it;
* `delay(i, j, s)` / `duplicate(i, j, p)` — per-link latency and
  duplicate delivery (delayed sends may reorder, like a real path);
* `FuzzConfig` — probabilistic background faults on every link
  (reference `p2p/fuzz.go`), composed under the chaos wrapper;
* `crash(i)` / `restart(i)` — stop a node abruptly and rebuild it from
  its surviving stores + WAL (crash recovery is the code under test,
  not a harness feature); `crash_at_fail_point(idx)` arms the existing
  `FAIL_TEST_INDEX` machinery in soft mode so the node's consensus
  thread dies mid-persistence-step, in process;
* `truncate_wal_tail(i)` / `corrupt_wal_tail(i)` — damage the crashed
  node's WAL the way a torn write would, before restarting it;
* device fault injection (`utils/fail.py` TENDERMINT_TPU_DEVICE_FAIL /
  `set_device_fault`) — trips the resilient-dispatch circuit breaker
  (`services/resilient.py`) mid-height; the invariants then prove the
  host-fallback keeps both safety AND liveness.

Degradation cycles are asserted on the EXPORTED telemetry
(`breaker_baseline` / `assert_breaker_tripped` /
`assert_breaker_recovered` for the host-fallback ladder;
`mesh_baseline` / `assert_mesh_degraded` / `assert_mesh_restored` for
the sharded-mesh survivor re-mesh cycle a `shard<i>` fault drives; plus
`wait_telemetry_above` for counters like round skips): what an
operator's dashboard would show is what the chaos suite checks
(docs/OBSERVABILITY.md).

Forensics: chaos runs force distributed-trace sampling
(`tracectx.force_all`) so every message is attributable, and an
invariant violation dumps the flight recorder
(`telemetry/flightrec.py`) to the harness home — the dump path is
appended to the InvariantViolation message, so a red run points at its
own black box (`tools/trace_timeline.py --flight <dump> --height H`).
"""

from __future__ import annotations

import os
import threading
import time

from tendermint_tpu_torch.p2p.peer import NodeInfo
from tendermint_tpu_torch.p2p.switch import Switch, connect_switches
from tendermint_tpu_torch.p2p.transport import (
    ChaosEndpoint,
    FuzzConfig,
    FuzzedEndpoint,
    LinkChaos,
)
from tendermint_tpu_torch.utils.log import kv, logger
import logging

_log = logger("nemesis")

# seconds `Nemesis.restart` waits for a crashed node's links to drop
RESTART_DROP_TIMEOUT_S = 30.0


class InvariantViolation(AssertionError):
    """A safety invariant broke under chaos — the bug this harness hunts."""


def make_genesis(n_vals: int, chain_id: str, n_active: int | None = None):
    """Deterministic genesis + index-aligned priv validators (the
    `tests/helpers.py` fixture shape, owned here so the harness is
    importable outside the test tree).

    `n_active` caps how many of the `n_vals` keys enter the GENESIS
    valset; the rest form a standby pool for churn scenarios — their
    nodes run as non-validators until an EndBlock rotation admits them
    (returned privs stay index-aligned: valset order first, then the
    standby pool in deterministic key order)."""
    from tendermint_tpu_torch.crypto import PrivKey
    from tendermint_tpu_torch.types import PrivValidator, Validator, ValidatorSet
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    privs = [
        PrivValidator(PrivKey(i.to_bytes(32, "little")))
        for i in range(1, n_vals + 1)
    ]
    active = privs if n_active is None else privs[:n_active]
    vs = ValidatorSet(
        [
            Validator(address=p.address, pub_key=p.pub_key, voting_power=10)
            for p in active
        ]
    )
    by_addr = {p.address: p for p in active}
    ordered = [by_addr[v.address] for v in vs.validators] + [
        p for p in privs if p.address not in by_addr
    ]
    genesis = GenesisDoc(
        chain_id=chain_id,
        genesis_time=1_700_000_000_000_000_000,
        validators=[
            GenesisValidator(pub_key=v.pub_key, power=v.voting_power)
            for v in vs.validators
        ],
    )
    return genesis, ordered


class FaultedApplyApp:
    """KVStore app whose commit RAISES from `fail_from_height` on — the
    in-process stand-in for a breaker-faulted/corrupted ABCI apply
    landing mid-pipeline. The pipelined finalize must drain at the join
    barrier (FatalConsensusError) and halt the node with its persisted
    state still at the last honestly-applied height: the speculative
    H+1 round state never reaches disk, a signature, or a commit."""

    def __new__(cls, fail_from_height: int = 0):
        from tendermint_tpu_torch.abci.apps import KVStoreApp

        class _App(KVStoreApp):
            def commit(self) -> object:
                if fail_from_height and self._height >= fail_from_height:
                    raise RuntimeError(
                        f"injected faulted apply at height {self._height}"
                    )
                return super().commit()

        return _App()


class ForgedHashApp:
    """KVStore app that returns a FORGED app hash from
    `fail_from_height` on — a node whose local execution diverges (the
    fork attempt the no-fork invariants must prove impossible). The
    forged node prevotes nil on every honest proposal (its state
    disagrees), and when the honest +2/3 commits anyway, its own apply
    of the honest block fails validation and halts it — the forged
    state never propagates into a committed block."""

    def __new__(cls, fail_from_height: int = 0):
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.types import Result

        class _App(KVStoreApp):
            def commit(self) -> Result:
                if fail_from_height and self._height >= fail_from_height:
                    return Result(data=b"\xde\xad\xbe\xef" * 5)
                return super().commit()

        return _App()


def one_bad_app_factory(bad_index: int, bad_app_cls, n_nodes: int, **kwargs):
    """An `app_factory` for `Nemesis.full_node_factory` that hands node
    `bad_index` a misbehaving app and everyone else the honest KVStore.
    Construction order == node index (the factory is called once per
    node, in order)."""
    from tendermint_tpu_torch.abci.apps import KVStoreApp

    counter = iter(range(n_nodes))

    def factory():
        i = next(counter)
        return bad_app_cls(**kwargs) if i == bad_index else KVStoreApp()

    return factory


class NemesisNode:
    """One rebuildable in-process node: durable stores + disposable
    runtime (consensus state, reactor, switch are rebuilt on restart;
    state DB, block store DB, app instance, and the on-disk WAL
    survive, exactly the crash-recovery contract of a real node)."""

    def __init__(
        self,
        index: int,
        genesis,
        privs,
        home: str,
        chain_id: str,
        config=None,
        verifier=None,
        hasher=None,
        app_factory=None,
        device=None,
    ) -> None:
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.db.kv import MemDB
        from tendermint_tpu_torch.state import make_genesis_state

        self.index = index
        self.chain_id = chain_id
        self.genesis = genesis
        self.priv_validator = privs[index] if index < len(privs) else None
        self.config = config or self.default_config()
        self.verifier = verifier
        # given no verifier, each run of the node verifies on a stack of
        # its own (`own_stack`), built in `_build` and closed in `stop`
        self.own_verifier = verifier is None
        self.device = device
        self.hasher = hasher
        self.state_db = MemDB()
        self.store_db = MemDB()
        # app-side persistence is the app's concern (the reference
        # Handshaker replays it back in sync); modeling a durable app
        # keeps the harness focused on consensus-side recovery
        self.app = (app_factory or KVStoreApp)()
        self.wal_path = os.path.join(home, f"node{index}", "cs.wal")
        os.makedirs(os.path.dirname(self.wal_path), exist_ok=True)
        state = make_genesis_state(self.state_db, genesis)
        state.save()
        self.running = False
        self._build()

    @staticmethod
    def default_config():
        """test_config timeouts, but PACED commits: at full test speed
        (skip_timeout_commit, 10 ms) a healthy 4-node chain commits
        ~50 heights/s — faster than one-height-at-a-time consensus
        catchup can ever walk, so a partitioned/restarted node would
        never rejoin a long-running net. ~4 heights/s leaves catchup
        (and CI machines under load) decisive headroom."""
        from tendermint_tpu_torch.consensus.config import ConsensusConfig

        cfg = ConsensusConfig.test_config()
        cfg.timeout_commit = 250
        cfg.skip_timeout_commit = False
        # keep the deliberate pacing: measured-latency timeouts would
        # shrink the 250 ms commit wait right back to full test speed
        # and starve consensus catchup of its headroom
        cfg.adaptive_timeouts = False
        return cfg

    @staticmethod
    def own_stack(device):
        """The verifier of a node given none: `default_verifier(device)`'s
        backend (its resilient layer and table caches, shared by the
        process) under a signature cache and coalescer of the node's own,
        as a node in a process of its own has. On one shared cache every
        node finds each vote already proven by another: no commit of
        theirs launches, and on the card at minimum batch 0 rounds
        stalled. With TENDERMINT_TPU_COALESCE=0 the stack has no cache
        and is the node's as it is."""
        from tendermint_tpu_torch.services.batcher import CoalescingVerifier
        from tendermint_tpu_torch.services.verifier import default_verifier

        stack = default_verifier(device)
        return CoalescingVerifier(stack.inner) if isinstance(stack, CoalescingVerifier) else stack

    def _build(self) -> None:
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.blockchain.store import BlockStore
        from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
        from tendermint_tpu_torch.consensus.state import ConsensusState
        from tendermint_tpu_torch.consensus.ticker import TimeoutTicker
        from tendermint_tpu_torch.evidence import EvidencePool, EvidenceReactor
        from tendermint_tpu_torch.state.state import load_state

        from tendermint_tpu_torch.telemetry.heightlog import HeightLedger

        if self.own_verifier:
            self.verifier = self.own_stack(self.device)
        state = load_state(self.state_db)
        self.store = BlockStore(self.store_db)
        self.conns = local_client_creator(self.app)()
        # finality ledger persists next to the WAL (tail reloads across
        # crash/restart; tools/finality_report.py merges the nodes')
        self.height_ledger = HeightLedger(
            path=os.path.join(os.path.dirname(self.wal_path), "heights.jsonl"),
            node_id=f"node{self.index}",
        )
        # evidence WAL survives crash/restart next to the consensus WAL
        self.evidence_pool = EvidencePool(
            wal_path=os.path.join(os.path.dirname(self.wal_path), "evidence.wal"),
            params=state.consensus_params.evidence,
            verifier=self.verifier,
            chain_id=self.chain_id,
        )
        self.cs = ConsensusState(
            config=self.config,
            state=state,
            app_conn=self.conns.consensus,
            block_store=self.store,
            priv_validator=self.priv_validator,
            wal_path=self.wal_path,
            ticker=TimeoutTicker(),
            verifier=self.verifier,
            hasher=self.hasher,
            evidence_pool=self.evidence_pool,
            heightlog=self.height_ledger,
        )
        self.reactor = ConsensusReactor(self.cs)
        self.switch = Switch(
            NodeInfo(
                node_id=f"node{self.index}",
                moniker=f"nemesis{self.index}",
                chain_id=self.chain_id,
            )
        )
        self.switch.add_reactor("consensus", self.reactor)
        self.switch.add_reactor("evidence", EvidenceReactor(self.evidence_pool))

    def start(self) -> None:
        self.switch.start()  # reactor.on_start starts the consensus loop
        self.running = True

    def stop(self) -> None:
        if self.running:
            self.switch.stop()
            self.evidence_pool.close()
            self.height_ledger.close()
            if self.own_verifier and hasattr(self.verifier, "coalescer"):
                self.verifier.coalescer.close()
            self.running = False

    def crash(self) -> None:
        """Abrupt teardown: peers cut, loop stopped, WAL left exactly as
        the last fsync'd record (no clean end-of-height marker is
        written — ConsensusState only marks committed heights, so the
        tail is whatever the 'crash' interrupted)."""
        self.stop()

    def restart(self) -> None:
        """Rebuild from surviving stores; `_catchup_replay` replays the
        WAL tail for the in-progress height before the loop starts."""
        if self.running:
            raise RuntimeError(f"node{self.index} is running; crash() first")
        self._build()
        self.start()

    @property
    def height(self) -> int:
        return self.cs.height


class FullNemesisNode:
    """One rebuildable in-process FULL node (`node.Node`): fast-sync +
    mempool + RPC + state-sync reactors under chaos, not just the
    ConsensusState core `NemesisNode` drives.

    Durable pieces survive restart exactly like a real deployment: the
    MemDB-backed state/blockstore/txindex/snapshot DBs, the app
    instance, and the on-disk WALs under `home/fullnode<i>/`. The
    runtime (Node with its switch, reactors, RPC listener) is rebuilt.
    In-process wiring: `p2p.laddr` is empty (no TCP listener) and the
    harness links switches over chaos-wrapped pipes.
    """

    def __init__(
        self,
        index: int,
        genesis,
        privs,
        home: str,
        chain_id: str,
        config=None,
        verifier=None,
        hasher=None,
        app_factory=None,
        config_mutator=None,
        device=None,
    ) -> None:
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.config import Config
        from tendermint_tpu_torch.db.kv import MemDB

        self.index = index
        self.chain_id = chain_id
        self.genesis = genesis
        self.priv_validator = privs[index] if index < len(privs) else None
        self.home = os.path.join(home, f"fullnode{index}")
        os.makedirs(self.home, exist_ok=True)
        self.app = (app_factory or KVStoreApp)()
        self.verifier = verifier
        self.hasher = hasher
        self.device = device
        self._dbs: dict[str, object] = {}
        self._memdb = MemDB
        if config is None:
            config = Config.test_config(self.home)
            config.base.moniker = f"fullnemesis{index}"
            config.p2p.laddr = ""  # harness-wired pipes, no TCP accept
            config.p2p.pex = False
            config.rpc.grpc_laddr = ""
            config.consensus = NemesisNode.default_config()
        if config_mutator is not None:
            config_mutator(config)
        self.config = config
        self.running = False
        self._build()

    def _db_provider(self, name: str):
        db = self._dbs.get(name)
        if db is None:
            db = self._dbs[name] = self._memdb()
        return db

    def _build(self) -> None:
        from tendermint_tpu_torch.node.node import Node

        self.node = Node(
            self.config,
            genesis=self.genesis,
            priv_validator=self.priv_validator,
            app=self.app,
            db_provider=self._db_provider,
            verifier=self.verifier,
            hasher=self.hasher,
            device=self.device,
        )

    # -- the informal node interface the harness drives --------------------

    @property
    def switch(self):
        return self.node.switch

    @property
    def store(self):
        return self.node.block_store

    @property
    def cs(self):
        return self.node.consensus

    @property
    def evidence_pool(self):
        return self.node.evidence_pool

    @property
    def height(self) -> int:
        return self.node.block_store.height

    @property
    def rpc_port(self) -> int:
        return self.node.rpc_port

    def start(self) -> None:
        self.node.start()
        self.running = True

    def stop(self) -> None:
        if self.running:
            self.node.stop()
            self.running = False

    def crash(self) -> None:
        """Abrupt teardown; WALs keep whatever the last fsync wrote."""
        self.stop()

    def restart(self) -> None:
        if self.running:
            raise RuntimeError(f"fullnode{self.index} is running; crash() first")
        self._build()
        self.start()


class Nemesis:
    """N-node in-process network + fault primitives + live invariants.

    Use as a context manager: `with Nemesis(4, home=tmp) as net: ...` —
    exit stops everything and re-raises any invariant violation the
    background monitor recorded. `node_factory` swaps the node type:
    the default drives consensus cores (`NemesisNode`), pass
    `Nemesis.full_node_factory()` to drive complete `node.Node`
    instances (fast-sync + mempool + RPC + state-sync under chaos).
    """

    def __init__(
        self,
        n_nodes: int,
        n_vals: int | None = None,
        home: str | None = None,
        config=None,
        fuzz: FuzzConfig | None = None,
        chain_id: str = "nemesis-chain",
        verifier_factory=None,
        hasher_factory=None,
        monitor_interval_s: float = 0.25,
        node_factory=None,
        n_active: int | None = None,
        device=None,
    ) -> None:
        import tempfile

        self.chain_id = chain_id
        self.home = home or tempfile.mkdtemp(prefix="nemesis-")
        self.fuzz = fuzz
        genesis, privs = make_genesis(
            n_vals or n_nodes, chain_id=chain_id, n_active=n_active
        )
        self.genesis, self.privs = genesis, privs
        self.node_factory = node_factory or NemesisNode
        self.nodes = [
            self.node_factory(
                i,
                genesis,
                privs,
                self.home,
                chain_id,
                config=config,
                verifier=verifier_factory(i) if verifier_factory else None,
                hasher=hasher_factory(i) if hasher_factory else None,
                device=device,
            )
            for i in range(n_nodes)
        ]
        # (i, j) i<j -> (chaos i->j, chaos j->i); flags survive re-links
        self._links: dict[tuple[int, int], tuple[LinkChaos, LinkChaos]] = {}
        self._partition: list[set[int]] | None = None
        self._topology = None  # WanTopology; reshapes recreated links
        self._monitor_interval = monitor_interval_s
        self._monitor: threading.Thread | None = None
        self._monitor_stop = threading.Event()
        self.violations: list[str] = []

    @staticmethod
    def core_node_factory(app_factory=None):
        """A `node_factory` building consensus-core `NemesisNode`s with
        a custom ABCI app per node (e.g. the churn app rotating the
        valset at EndBlock). The factory is called once per node, in
        index order — `one_bad_app_factory` composes."""

        def factory(i, genesis, privs, home, chain_id, config=None, verifier=None, hasher=None, device=None):
            return NemesisNode(
                i,
                genesis,
                privs,
                home,
                chain_id,
                config=config,
                verifier=verifier,
                hasher=hasher,
                app_factory=app_factory,
                device=device,
            )

        return factory

    @staticmethod
    def full_node_factory(app_factory=None, config_mutator=None):
        """A `node_factory` building `FullNemesisNode`s; `config_mutator`
        edits each node's Config before composition (snapshot intervals,
        state-sync trust roots, ...)."""

        def factory(i, genesis, privs, home, chain_id, config=None, verifier=None, hasher=None, device=None):
            return FullNemesisNode(
                i,
                genesis,
                privs,
                home,
                chain_id,
                config=config,
                verifier=verifier,
                hasher=hasher,
                app_factory=app_factory,
                config_mutator=config_mutator,
                device=device,
            )

        return factory

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "Nemesis":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(check=exc_type is None)

    def start(self) -> None:
        # chaos runs sample EVERY trace context: when an invariant
        # trips, the flight-recorder dump + span logs must attribute
        # every message in flight, not 1-in-64 of them
        from tendermint_tpu_torch.telemetry import tracectx
        from tendermint_tpu_torch.telemetry.flightrec import FLIGHT

        tracectx.force_all(True)
        FLIGHT.set_dump_dir(self.home)
        for node in self.nodes:
            node.start()
        for i in range(len(self.nodes)):
            for j in range(i + 1, len(self.nodes)):
                self._connect(i, j)
        self._monitor_stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="nemesis-invariants", daemon=True
        )
        self._monitor.start()

    def stop(self, check: bool = True) -> None:
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        for node in self.nodes:
            node.stop()
        from tendermint_tpu_torch.telemetry import tracectx

        tracectx.force_all(False)
        if check:
            self.assert_invariants()

    # -- wiring --------------------------------------------------------------

    def _chaos_pair(self, i: int, j: int) -> tuple[LinkChaos, LinkChaos]:
        key = (min(i, j), max(i, j))
        if key not in self._links:
            self._links[key] = (LinkChaos(seed=key[0]), LinkChaos(seed=key[1]))
            if self._partition is not None and self._crosses_partition(i, j):
                for c in self._links[key]:
                    c.partitioned = True
            if self._topology is not None:
                # recreated links (restart) must re-inherit the WAN shape
                self._topology.shape(self._links[key][0], key[0], key[1])
                self._topology.shape(self._links[key][1], key[1], key[0])
        return self._links[key]

    def link_chaos(self, i: int, j: int) -> LinkChaos:
        """The live LinkChaos governing direction i -> j (asymmetric
        routes are two calls)."""
        pair = self._chaos_pair(i, j)
        return pair[0] if i < j else pair[1]

    def set_topology(self, topology) -> None:
        """Shape every link (delay / jitter / bandwidth, per direction)
        from a WAN topology (`testing/topology.py`). Stored so links
        recreated by `restart()` inherit the shaping, exactly like the
        live partition flags."""
        self._topology = topology
        for (i, j), (c_ij, c_ji) in self._links.items():
            topology.shape(c_ij, i, j)
            topology.shape(c_ji, j, i)
        kv(
            _log,
            logging.INFO,
            "topology applied",
            name=getattr(topology, "name", "custom"),
            links=len(self._links),
        )

    def _connect(self, i: int, j: int) -> None:
        c_ij, c_ji = self._chaos_pair(i, j)

        def wrap(ea, eb):
            if self.fuzz is not None:
                ea = FuzzedEndpoint(ea, self.fuzz)
                eb = FuzzedEndpoint(eb, self.fuzz)
            return ChaosEndpoint(ea, c_ij), ChaosEndpoint(eb, c_ji)

        connect_switches(self.nodes[i].switch, self.nodes[j].switch, wrap=wrap)

    # -- fault primitives ----------------------------------------------------

    def _crosses_partition(self, i: int, j: int) -> bool:
        assert self._partition is not None
        for group in self._partition:
            if i in group and j in group:
                return False
        return True

    def partition(self, *groups) -> None:
        """Split the network into isolated groups, e.g.
        `partition({0, 1}, {2, 3})`. Links inside a group stay clean;
        links across groups black-hole in both directions. A node in no
        listed group is isolated entirely."""
        self._partition = [set(g) for g in groups]
        for (i, j), (c_ij, c_ji) in self._links.items():
            cut = self._crosses_partition(i, j)
            c_ij.partitioned = cut
            c_ji.partitioned = cut
        kv(_log, logging.INFO, "partition", groups=str(groups))

    def heal(self) -> None:
        """Remove the partition (other per-link chaos keeps its settings)."""
        self._partition = None
        for c_ij, c_ji in self._links.values():
            c_ij.partitioned = False
            c_ji.partitioned = False
        kv(_log, logging.INFO, "heal", links=len(self._links))

    def delay(self, i: int, j: int, seconds: float, both_ways: bool = True) -> None:
        c_ij, c_ji = self._chaos_pair(i, j)
        c_ij.delay_s = seconds
        if both_ways:
            c_ji.delay_s = seconds

    def duplicate(self, i: int, j: int, prob: float, both_ways: bool = True) -> None:
        c_ij, c_ji = self._chaos_pair(i, j)
        c_ij.dup_prob = prob
        if both_ways:
            c_ji.dup_prob = prob

    def crash(self, i: int) -> None:
        self.nodes[i].crash()

    def restart(self, i: int) -> None:
        """Restart a crashed node and re-link it to every running node
        (links inherit the live partition state)."""
        node = self.nodes[i]
        self.wait_dropped(i)
        node.restart()
        for j, other in enumerate(self.nodes):
            if j == i or not other.running:
                continue
            key = (min(i, j), max(i, j))
            self._links.pop(key, None)  # old endpoints died with the crash
            self._connect(*key)

    def wait_dropped(self, i: int, timeout: float = RESTART_DROP_TIMEOUT_S) -> None:
        """Wait until no running node holds node `i` as a peer any more: a
        switch refuses a peer id it still holds ("duplicate peer",
        `p2p/switch.py`), so a node restarted before its old links drop
        would be refused. Raises TimeoutError past `timeout` seconds."""
        name = self.nodes[i].switch.node_info.node_id
        deadline = time.monotonic() + timeout
        while any(
            name in {p.id for p in n.switch.peers()}
            for j, n in enumerate(self.nodes)
            if j != i and n.running
        ):
            if time.monotonic() > deadline:
                raise TimeoutError(f"node{i}'s links still up {timeout} s after its crash")
            time.sleep(0.01)

    def add_node(self, node) -> int:
        """Admit a late joiner (e.g. a fresh node that will state-sync
        in): start it and link it to every running node. Links inherit
        the live partition — declare the joiner's group in `partition`
        BEFORE adding it, or it starts fully isolated."""
        i = len(self.nodes)
        self.nodes.append(node)
        if not node.running:
            node.start()
        for j, other in enumerate(self.nodes[:i]):
            if other.running:
                self._connect(j, i)
        return i

    def crash_at_fail_point(self, index: int) -> None:
        """Arm the process-wide fail-point counter (`utils/fail.py`) in
        SOFT mode: the `index`-th fail_point() call from now raises
        SimulatedCrash, killing that node's consensus thread mid-step.
        Counts are process-global — all nodes' persistence steps share
        the sequence, like the reference's kill-at-every-index matrix."""
        from tendermint_tpu_torch.utils import fail

        fail.reset_for_testing()
        os.environ["FAIL_TEST_SOFT"] = "1"
        os.environ["FAIL_TEST_INDEX"] = str(index)

    def clear_fail_point(self) -> None:
        os.environ.pop("FAIL_TEST_INDEX", None)
        os.environ.pop("FAIL_TEST_SOFT", None)

    # -- WAL damage ----------------------------------------------------------

    def truncate_wal_tail(self, i: int, nbytes: int = 16) -> None:
        """Chop `nbytes` off the crashed node's live WAL file — the torn
        tail a mid-write crash leaves. Replay must tolerate it."""
        node = self.nodes[i]
        if node.running:
            raise RuntimeError("truncate_wal_tail on a running node")
        size = os.path.getsize(node.wal_path)
        with open(node.wal_path, "ab") as f:
            f.truncate(max(0, size - nbytes))

    def corrupt_wal_tail(self, i: int, nbytes: int = 16) -> None:
        """Flip the last `nbytes` of the crashed node's WAL (bit rot /
        torn write with garbage). The CRC framing must reject the tail."""
        node = self.nodes[i]
        if node.running:
            raise RuntimeError("corrupt_wal_tail on a running node")
        size = os.path.getsize(node.wal_path)
        if size == 0:
            return
        n = min(nbytes, size)
        with open(node.wal_path, "r+b") as f:
            f.seek(size - n)
            tail = f.read(n)
            f.seek(size - n)
            f.write(bytes(b ^ 0xFF for b in tail))

    # -- telemetry invariants ------------------------------------------------
    #
    # Chaos assertions on the EXPORTED numbers, not harness internals:
    # what an operator's dashboard would show is what the invariant
    # checks. Counters are process-global (telemetry/metrics.py), so in
    # this multi-node-per-process harness they sum across nodes —
    # baselines make the deltas per-scenario.

    @staticmethod
    def telemetry_value(name: str, **labels) -> float:
        """Current value of an exported counter/gauge series (0 when the
        series has never been touched)."""
        from tendermint_tpu_torch.telemetry import REGISTRY

        return REGISTRY.counter_value(name, **labels)

    def breaker_baseline(self, kind: str = "verify") -> dict:
        """Snapshot the breaker telemetry before injecting a fault; pass
        to `assert_breaker_tripped` / `assert_breaker_recovered`."""
        return {
            "kind": kind,
            "trips": self.telemetry_value(
                "tendermint_breaker_transitions_total", kind=kind, to="open"
            ),
            "recoveries": self.telemetry_value(
                "tendermint_breaker_transitions_total", kind=kind, to="closed"
            ),
            "fallbacks": self.telemetry_value(
                "tendermint_device_fallback_calls_total", kind=kind
            ),
        }

    def assert_breaker_tripped(self, baseline: dict, min_trips: int = 1) -> None:
        kind = baseline["kind"]
        trips = (
            self.telemetry_value(
                "tendermint_breaker_transitions_total", kind=kind, to="open"
            )
            - baseline["trips"]
        )
        fallbacks = (
            self.telemetry_value(
                "tendermint_device_fallback_calls_total", kind=kind
            )
            - baseline["fallbacks"]
        )
        if trips < min_trips:
            raise InvariantViolation(
                f"breaker[{kind}]: expected >= {min_trips} trips via telemetry, saw {trips}"
            )
        if fallbacks <= 0:
            raise InvariantViolation(
                f"breaker[{kind}]: tripped but no fallback calls exported"
            )

    def assert_breaker_recovered(
        self, baseline: dict, min_recoveries: int = 1
    ) -> None:
        kind = baseline["kind"]
        recoveries = (
            self.telemetry_value(
                "tendermint_breaker_transitions_total", kind=kind, to="closed"
            )
            - baseline["recoveries"]
        )
        if recoveries < min_recoveries:
            raise InvariantViolation(
                f"breaker[{kind}]: expected >= {min_recoveries} recoveries "
                f"via telemetry, saw {recoveries}"
            )

    def mesh_baseline(self) -> dict:
        """Snapshot the sharded-mesh telemetry before injecting a
        per-shard fault (`TENDERMINT_TPU_DEVICE_FAIL=shard<i>`); pass
        to `assert_mesh_degraded` / `assert_mesh_restored`."""
        return {
            "faults": self.telemetry_value("tendermint_mesh_shard_faults_total"),
            "shrinks": self.telemetry_value(
                "tendermint_mesh_remesh_total", direction="shrink"
            ),
            "restores": self.telemetry_value(
                "tendermint_mesh_remesh_total", direction="restore"
            ),
        }

    def assert_mesh_degraded(
        self, baseline: dict, min_faults: int = 1, timeout: float = 30.0
    ) -> None:
        """The shrink half of the cycle, via exported telemetry: shard
        faults observed AND survivor re-meshes performed — the chip
        loss was absorbed BELOW the breaker."""
        self.wait_telemetry_above(
            "tendermint_mesh_shard_faults_total",
            baseline["faults"] + min_faults - 1,
            timeout=timeout,
        )
        self.wait_telemetry_above(
            "tendermint_mesh_remesh_total",
            baseline["shrinks"],
            timeout=timeout,
            direction="shrink",
        )

    def assert_mesh_restored(
        self, baseline: dict, min_restores: int = 1, timeout: float = 30.0
    ) -> None:
        """The recover half: re-probe brought full meshes back."""
        self.wait_telemetry_above(
            "tendermint_mesh_remesh_total",
            baseline["restores"] + min_restores - 1,
            timeout=timeout,
            direction="restore",
        )

    def wait_telemetry_above(
        self, name: str, threshold: float, timeout: float = 30.0, **labels
    ) -> float:
        """Block until an exported series exceeds `threshold` (e.g. the
        round-skip counter during a starvation scenario)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.violations:
                raise InvariantViolation(self.violations[0])
            v = self.telemetry_value(name, **labels)
            if v > threshold:
                return v
            time.sleep(0.05)
        raise TimeoutError(
            f"{name}{labels or ''} stayed <= {threshold} for {timeout}s "
            f"(now {self.telemetry_value(name, **labels)})"
        )

    # -- invariants ----------------------------------------------------------

    def heights(self) -> list[int]:
        return [n.store.height for n in self.nodes]

    def _violation(self, msg: str) -> InvariantViolation:
        """Build the violation AND dump the forensics: the flight
        recorder's ring of round transitions / flushes / launches, plus
        the height ledgers' per-height critical-path records. Both dump
        paths ride the assertion message so a red CI run is
        self-diagnosing (`tools/trace_timeline.py --flight`,
        `tools/finality_report.py --ledgers`)."""
        from tendermint_tpu_torch.telemetry import heightlog
        from tendermint_tpu_torch.telemetry.flightrec import FLIGHT

        path = FLIGHT.dump(reason="invariant-violation", dir=self.home)
        if path:
            msg = f"{msg} [flight recorder: {path}]"
        hpath = heightlog.dump_all(self.home, reason="invariant-violation")
        if hpath:
            msg = f"{msg} [height ledger: {hpath}]"
        return InvariantViolation(msg)

    def check_no_fork(self) -> None:
        """One block hash per height across every store that has it."""
        top = max(self.heights(), default=0)
        for h in range(1, top + 1):
            seen: dict[bytes, int] = {}
            for node in self.nodes:
                meta = node.store.load_block_meta(h)
                if meta is not None:
                    seen.setdefault(bytes(meta.block_id.hash), node.index)
            if len(seen) > 1:
                raise self._violation(
                    f"FORK at height {h}: {[(v, k.hex()[:12]) for k, v in seen.items()]}"
                )

    def check_commit_agreement(self) -> None:
        """Every stored seen-commit certifies the block stored at that
        height (a node must never store a commit for one block and the
        data of another)."""
        for node in self.nodes:
            for h in range(1, node.store.height + 1):
                meta = node.store.load_block_meta(h)
                commit = node.store.load_seen_commit(h)
                if meta is None or commit is None:
                    continue
                if bytes(commit.block_id.hash) != bytes(meta.block_id.hash):
                    raise self._violation(
                        f"node{node.index} height {h}: seen-commit certifies "
                        f"{commit.block_id.hash.hex()[:12]} but stored block is "
                        f"{meta.block_id.hash.hex()[:12]}"
                    )

    def check_invariants(self) -> None:
        self.check_no_fork()
        self.check_commit_agreement()

    def assert_invariants(self) -> None:
        """Raise the first violation the background monitor recorded,
        then re-check once on the final state."""
        if self.violations:
            raise InvariantViolation(self.violations[0])
        self.check_invariants()

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(self._monitor_interval):
            try:
                self.check_invariants()
            except InvariantViolation as e:
                self.violations.append(str(e))
                kv(_log, logging.ERROR, "invariant violated", error=str(e)[:200])
                return  # state is already poisoned; keep the first report

    # -- progress ------------------------------------------------------------

    def wait_height(
        self,
        height: int,
        nodes: list[int] | None = None,
        timeout: float = 60.0,
    ) -> None:
        """Block until the given nodes' stores reach `height` (eventual
        progress — e.g. after heal). Raises on timeout or violation."""
        targets = nodes if nodes is not None else range(len(self.nodes))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.violations:
                raise InvariantViolation(self.violations[0])
            if all(self.nodes[i].store.height >= height for i in targets):
                return
            time.sleep(0.05)
        self._dump_stall_forensics()
        raise TimeoutError(
            f"heights {self.heights()} did not reach {height} in {timeout}s"
        )

    def _dump_stall_forensics(self) -> None:
        """A progress timeout on an UNpartitioned in-process net usually
        means one node's consensus thread is wedged or blocked — dump
        every thread's stack (plus the flight recorder) so the red run
        carries its own diagnosis, like invariant violations already do."""
        import faulthandler
        import sys

        from tendermint_tpu_torch.telemetry.flightrec import FLIGHT

        try:
            sys.stderr.write(
                f"nemesis stall: heights={self.heights()} — thread stacks:\n"
            )
            faulthandler.dump_traceback(file=sys.stderr)
            FLIGHT.dump(reason="nemesis-stall", dir=self.home)
        except Exception:
            pass  # forensics must never mask the timeout itself

    def wait_progress(
        self,
        delta: int = 1,
        nodes: list[int] | None = None,
        timeout: float = 60.0,
    ) -> int:
        """Wait for `delta` MORE committed heights on the given nodes;
        returns the new minimum height."""
        targets = list(nodes if nodes is not None else range(len(self.nodes)))
        base = min(self.nodes[i].store.height for i in targets)
        self.wait_height(base + delta, nodes=targets, timeout=timeout)
        return min(self.nodes[i].store.height for i in targets)
