"""Node: assemble every subsystem from config + genesis and run it
(reference `node/node.go:114-353`).

Composition order mirrors the reference: DBs -> priv validator ->
genesis -> state -> ABCI conns + handshake -> mempool -> reactors
(blockchain, consensus, mempool) -> switch -> p2p listener -> RPC.

The port's copy of `tendermint_tpu/node/node.py`. `Node(...,
device=None)` resolves `verifier=None` to `default_verifier(device)` and
`hasher=None` to `auto_hasher(device)`: the CUDA card's stack unless the
caller names a device (`device="cpu"` in the tests); without a card and
without a device the constructor raises, it never picks a host backend.
The node's telemetry (span log, flight recorder, height ledger, launch
ledger, profiler, `/metrics` gauges) is the port's own.
"""

from __future__ import annotations

import os
import threading

from tendermint_tpu_torch.abci.client import local_client_creator
from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config import Config
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.ticker import TimeoutTicker
from tendermint_tpu_torch.db.kv import DB, SQLiteDB
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.p2p.node_key import NodeKey
from tendermint_tpu_torch.p2p.peer import NodeInfo
from tendermint_tpu_torch.p2p.switch import Switch
from tendermint_tpu_torch.p2p.tcp import TcpListener, dial
from tendermint_tpu_torch.rpc.core import make_routes
from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.state.state import State, load_state, make_genesis_state
from tendermint_tpu_torch.state.txindex import KVTxIndexer
from tendermint_tpu_torch.types import events as ev
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.priv_validator import PrivValidatorFS


class Node:
    """One full node. `start()` brings up p2p + RPC + (fast-sync then)
    consensus; `stop()` tears everything down."""

    def __init__(
        self,
        config: Config,
        genesis: GenesisDoc | None = None,
        priv_validator=None,
        app=None,
        client_creator=None,
        db_provider=None,
        verifier=None,
        node_key=None,
        hasher=None,
        device=None,
    ) -> None:
        self.config = config
        cfg = config
        if verifier is None:
            # resolve the process default ONCE (the card's stack, or
            # `device`'s) so warming and every component share the same
            # instance — the CLI path passes None
            from tendermint_tpu_torch.services.verifier import default_verifier

            verifier = default_verifier(device)
        from tendermint_tpu_torch.utils.log import setup_logging

        setup_logging(cfg.base.log_level)

        def _db(name: str) -> DB:
            if db_provider is not None:
                return db_provider(name)
            return SQLiteDB(cfg.db_path(name))

        # genesis + priv validator (reference LoadOrGen + genesisDocProvider)
        self.genesis = (
            genesis
            if genesis is not None
            else GenesisDoc.from_file(cfg.genesis_path())
        )
        self.priv_validator = (
            priv_validator
            if priv_validator is not None
            else PrivValidatorFS.load_or_gen(cfg.priv_validator_path())
        )
        # Dedicated transport identity, NOT the validator signing key:
        # keeps consensus signatures and p2p handshake signatures under
        # different keys and lets remote-signer topologies (validator key
        # never on this host) still run encrypted p2p.
        self.node_key = (
            node_key
            if node_key is not None
            else NodeKey.load_or_gen(cfg.node_key_path())
        )
        self.node_id = self.node_key.node_id

        # span-timeline persistence: replay the pre-restart window into
        # the tracer (post-mortems survive the process), then sink every
        # new span to the bounded JSONL ring under the data dir
        from tendermint_tpu_torch.telemetry import TRACER
        from tendermint_tpu_torch.telemetry.spanlog import persist_spans

        self._span_log = persist_spans(
            TRACER, os.path.join(cfg.home, cfg.base.db_dir, "spans.jsonl")
        )
        # flight recorder: black-box dumps land next to the span log;
        # SIGUSR2 snapshots a live node (no-op off the main thread)
        from tendermint_tpu_torch.telemetry.flightrec import FLIGHT, install_signal_dump

        FLIGHT.set_node_id(self.node_id)
        FLIGHT.set_dump_dir(os.path.join(cfg.home, cfg.base.db_dir))
        install_signal_dump()
        # finality observatory: one persisted record per committed
        # height (phases, critical path, laggard) under the data dir —
        # `/health`'s SLO window and tools/finality_report.py read it
        from tendermint_tpu_torch.telemetry.heightlog import HeightLedger

        self.height_ledger = HeightLedger(
            path=os.path.join(cfg.home, cfg.base.db_dir, "heights.jsonl"),
            node_id=self.node_id,
        )
        # device observatory: the process-wide launch ledger persists
        # under this node's data dir (one record per device launch —
        # `dump_telemetry?launches=N`, tools/device_report.py)
        from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG

        LAUNCHLOG.attach(
            os.path.join(cfg.home, cfg.base.db_dir, "launches.jsonl"),
            node_id=self.node_id,
        )

        # state + stores
        self.state_db = _db("state")
        st = load_state(self.state_db)
        if st is None:
            st = make_genesis_state(self.state_db, self.genesis)
            st.save()
        self.state: State = st
        self.block_store = BlockStore(_db("blockstore"))

        # app conns + crash-recovery handshake (reference NewAppConns +
        # Handshaker). `client_creator` selects the process boundary:
        # in-proc (default) or `abci.socket.socket_client_creator` for
        # an app/sidecar in its own process (reference proxy/client.go)
        if client_creator is None:
            if app is None:
                from tendermint_tpu_torch.abci.apps import KVStoreApp

                app = KVStoreApp()
            client_creator = local_client_creator(app)
        self.app = app
        self.app_conns = client_creator()
        Handshaker(self.state, self.block_store, verifier=verifier).handshake(
            self.app_conns
        )

        # mempool + tx index. The shared verifier makes CheckTx windows
        # the verify spine's fifth consumer (consumer="mempool"):
        # admission signature batches coalesce with consensus/fastsync/
        # statesync/rpc launches and share the VerifiedSigCache.
        self.mempool = Mempool(
            self.app_conns.mempool,
            height=self.state.last_block_height,
            cache_size=cfg.mempool.cache_size,
            wal_dir=cfg.mempool_wal_path() if cfg.mempool.wal_dir else None,
            recheck=cfg.mempool.recheck,
            node_id=self.node_id,
            lanes=cfg.mempool.lanes or None,
            verifier=verifier,
            ingress_batch=cfg.mempool.ingress_batch,
            signed_txs=cfg.mempool.signed_txs,
        )
        # re-validate txs that were in flight before a crash; the WAL is
        # compacted to the survivors so it cannot grow across restarts
        self.mempool.replay_wal()
        self.tx_indexer = KVTxIndexer(_db("txindex"))
        self.event_switch = ev.EventSwitch()

        # replica mode (tendermint_tpu/lightclient/): never join
        # consensus, follow the chain via fast-sync tail + FullCommit
        # subscription, serve light-client reads. The validator key is
        # deliberately unused — a replica must not be able to sign.
        self.is_replica = bool(cfg.replica.enable)
        if self.is_replica:
            self.priv_validator = None

        # fast-sync only when peers could be ahead AND we are not the
        # solo validator (reference node.go:174-205)
        solo = (
            self.priv_validator is not None
            and len(self.state.validators) == 1
            and self.state.validators.validators[0].address
            == self.priv_validator.address
        )
        fast_sync = cfg.base.fast_sync and (self.is_replica or not solo)
        # state-sync bootstrap: only a FRESH node (nothing committed
        # locally) may skip history, and it needs fast-sync for the tail
        state_sync = (
            cfg.statesync.enable and fast_sync and self.state.last_block_height == 0
        )

        # Device tree hasher for proposal data_hash/part sets on the card
        # or `device` (reference SimpleHash hot spots `types/tx.go:33-46`,
        # `types/part_set.go:95-122`).
        if hasher is None:
            from tendermint_tpu_torch.services.hasher import auto_hasher

            hasher = auto_hasher(device)
        self.hasher = hasher
        # background-build or load the kernel library and run each route
        # once, so the first real verify doesn't stall on it (a no-op on
        # the CPU)
        if hasattr(verifier, "warm_kernels"):
            verifier.warm_kernels()

        # evidence pool: WAL-backed so pending proofs survive a crash;
        # consensus wires the validator-set/height resolvers in its ctor
        from tendermint_tpu_torch.evidence import EvidencePool, EvidenceReactor

        self.evidence_pool = EvidencePool(
            wal_path=cfg.evidence_wal_path(),
            params=self.state.consensus_params.evidence,
            verifier=verifier,
            chain_id=self.genesis.chain_id,
        )
        if self.is_replica:
            # replicas run NO consensus machinery at all: no round
            # state, no WAL, no vote signing — the follow-mode
            # fast-sync below is the only way their state advances
            self.consensus = None
            self.consensus_reactor = None
            # the evidence pool still needs its height clock + valset
            # resolver (forged-FullCommit evidence is admitted here);
            # best-effort like consensus's resolver — an unknown height
            # falls back to the live set, it never raises into the
            # gossip path (that would debit an honest relaying peer)
            self.evidence_pool.best_height_fn = lambda: self.block_store.height

            def _replica_evidence_valset(h: int):
                from tendermint_tpu_torch.types.errors import ValidationError

                try:
                    return self.current_state.load_validators(h)
                except ValidationError:
                    return self.current_state.validators

            self.evidence_pool.val_set_fn = _replica_evidence_valset
        else:
            self.consensus = ConsensusState(
                config=cfg.consensus,
                state=self.state,
                app_conn=self.app_conns.consensus,
                block_store=self.block_store,
                mempool=self.mempool,
                priv_validator=self.priv_validator,
                event_switch=self.event_switch,
                wal_path=cfg.wal_path(),
                ticker=TimeoutTicker(),
                verifier=verifier,
                tx_indexer=self.tx_indexer,
                hasher=hasher,
                evidence_pool=self.evidence_pool,
                heightlog=self.height_ledger,
            )
            self.consensus_reactor = ConsensusReactor(
                self.consensus, fast_sync=fast_sync
            )
        self.evidence_reactor = EvidenceReactor(self.evidence_pool)
        self.blockchain_reactor = BlockchainReactor(
            state=self.state,
            store=self.block_store,
            app_conn=self.app_conns.consensus,
            fast_sync=fast_sync,
            on_caught_up=self._on_caught_up,
            verifier=verifier,
            tx_indexer=self.tx_indexer,
            hasher=hasher,
            deferred=state_sync,
            follow=self.is_replica,
        )
        self.mempool_reactor = MempoolReactor(
            self.mempool, broadcast=cfg.mempool.broadcast
        )

        # state sync: every node serves its snapshot store on the 0x60
        # channel; `state_sync` additionally runs the bootstrap routine
        # (discover -> anchor -> chunks -> restore -> fast-sync tail)
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
        from tendermint_tpu_torch.statesync.snapshot import SnapshotStore
        from tendermint_tpu_torch.statesync.trust import TrustAnchor, TrustOptions

        self.snapshot_store = SnapshotStore(
            _db("snapshots"),
            hasher=hasher,
            chunk_size=cfg.statesync.chunk_size,
            keep_recent=cfg.statesync.snapshot_keep_recent,
        )
        trust_anchor = TrustAnchor(
            chain_id=self.genesis.chain_id,
            base_validators=self.genesis.validator_set(),
            options=TrustOptions.from_config(cfg.statesync),
            verifier=verifier,
        )
        self.statesync_reactor = StateSyncReactor(
            snapshot_store=self.snapshot_store,
            block_store=self.block_store,
            state=self.state,
            sync=state_sync,
            trust_anchor=trust_anchor,
            state_db=self.state_db,
            app_restore_fn=getattr(self.app, "restore_state", None),
            app_snapshot_fn=getattr(self.app, "snapshot_state", None),
            on_synced=self._on_state_synced,
            hasher=hasher,
            snapshot_interval=cfg.statesync.snapshot_interval,
            retain_blocks=cfg.statesync.retain_blocks,
            discovery_time_s=cfg.statesync.discovery_time_s,
            chunk_request_timeout_s=cfg.statesync.chunk_request_timeout_s,
            chunk_inflight_per_peer=cfg.statesync.chunk_inflight_per_peer,
            giveup_time_s=cfg.statesync.giveup_time_s,
        )
        if cfg.statesync.snapshot_interval > 0:
            # runs on the consensus thread right after each commit, so
            # consensus state and app state snapshot at the same height
            self.event_switch.add_listener(
                "statesync", ev.EVENT_NEW_BLOCK, lambda _data: self._maybe_snapshot()
            )

        # light-client serving layer (ROADMAP item 1): every node serves
        # certified FullCommits on the 0x68 channel; replicas
        # additionally subscribe to the push stream and certify it
        # through a bisecting light-client pin before caching/serving —
        # the cache is positives-only, so a forged FullCommit can never
        # pin trust.
        from tendermint_tpu_torch.db.fullcommit import FullCommitStore
        from tendermint_tpu_torch.lightclient import (
            BisectingCertifier,
            CertifiedCommitCache,
            LightClientReactor,
            PeerProvider,
        )

        self.fullcommit_store = FullCommitStore(_db("fullcommits"))
        self.fullcommit_cache = CertifiedCommitCache(
            cfg.replica.fullcommit_cache_size, store=self.fullcommit_store
        )
        self.lightclient_reactor = LightClientReactor(
            chain_id=self.genesis.chain_id,
            block_store=self.block_store,
            state=self.state,
            cache=self.fullcommit_cache,
            subscribe=self.is_replica,
            evidence_pool=self.evidence_pool,
            verifier=verifier,
        )
        self.lightclient_certifier = None
        if self.is_replica:
            # subjective init: the statesync trust pin when configured,
            # else the genesis valset (fine for young chains — same
            # fallback the statesync TrustAnchor documents)
            self.lightclient_certifier = BisectingCertifier(
                self.genesis.chain_id,
                validators=self.genesis.validator_set(),
                height=0,
                trusted=self.fullcommit_cache,
                source=PeerProvider(self.lightclient_reactor),
                verifier=verifier,
                trust_period_ns=int(cfg.statesync.trust_period_s * 1e9),
            )
            self.lightclient_reactor.certifier = self.lightclient_certifier
        if not self.is_replica:
            # push freshly committed FullCommits to subscribed replicas
            # (runs on the consensus thread right after the commit is
            # stored; no-op without subscribers)
            self.event_switch.add_listener(
                "lightclient",
                ev.EVENT_NEW_BLOCK,
                lambda data: self._announce_fullcommit(data),
            )

        self.switch = Switch(
            NodeInfo(
                node_id=self.node_id,
                moniker=cfg.base.moniker,
                chain_id=self.genesis.chain_id,
            )
        )
        self.switch.send_rate = cfg.p2p.send_rate
        self.switch.recv_rate = cfg.p2p.recv_rate
        self.switch.ping_interval = cfg.p2p.ping_interval_s
        self.switch.pong_timeout = cfg.p2p.pong_timeout_s
        if cfg.p2p.filter_peers:
            # ABCI-driven peer admission (reference node/node.go:259-281):
            # the app vets each peer via Query before registration. The
            # reference filters on addr and pubkey; node ids here are the
            # transport identity (address of the node key), so the id
            # filter is the pubkey filter's analog.
            def _abci_peer_filter(remote_info, remote_addr):
                # addr filter uses the SOCKET's remote address (the peer
                # cannot choose it); self-reported listen_addr would let
                # a banned host dodge the blocklist
                paths = [f"/p2p/filter/id/{remote_info.node_id}"]
                if remote_addr:
                    paths.insert(0, f"/p2p/filter/addr/{remote_addr}")
                for path in paths:
                    res = self.app_conns.query.query_sync(path, b"")
                    if not res.is_ok:
                        return f"app rejected peer ({path}): code {res.code}"
                return None

            self.switch.peer_filter = _abci_peer_filter
        self.switch.add_reactor("blockchain", self.blockchain_reactor)
        if self.consensus_reactor is not None:
            self.switch.add_reactor("consensus", self.consensus_reactor)
        self.switch.add_reactor("mempool", self.mempool_reactor)
        self.switch.add_reactor("evidence", self.evidence_reactor)
        self.switch.add_reactor("statesync", self.statesync_reactor)
        if cfg.replica.serve_lightclient or self.is_replica:
            self.switch.add_reactor("lightclient", self.lightclient_reactor)
        self.pex_reactor = None
        if cfg.p2p.pex:
            from tendermint_tpu_torch.p2p.addrbook import AddrBook
            from tendermint_tpu_torch.p2p.pex import PEXReactor

            self.addr_book = AddrBook(os.path.join(cfg.home, "addrbook.json"))
            self.pex_reactor = PEXReactor(
                self.addr_book,
                max_peers=cfg.p2p.max_num_peers,
                node_key=self._node_key,
                ensure_interval_s=cfg.p2p.pex_ensure_interval_s,
            )
            self.switch.add_reactor("pex", self.pex_reactor)

        self.listener: TcpListener | None = None
        self.rpc: RPCServer | None = None
        self.grpc = None

        # persistent-peer reconnection (reference `reconnectToPeer
        # p2p/switch.go:290-320`: bounded retries with backoff). Seeds-only
        # topologies otherwise never heal a dropped link.
        self._persistent_addrs: set[str] = {
            a.strip()
            for a in cfg.p2p.persistent_peers.split(",")
            if a.strip()
        }
        self._persistent_lock = threading.Lock()
        self._persistent_dialing: set[str] = set()
        self._peer_addr: dict[str, str] = {}  # node_id -> dialed persistent addr
        self._p2p_running = False
        if self._persistent_addrs:
            self.switch.on_peer_removed = self._on_peer_removed

    # -- lifecycle ---------------------------------------------------------

    def _on_caught_up(self, state) -> None:
        """Fast-sync finished: start consensus (reference
        `SwitchToConsensus`). Replicas never get here — their follow-
        mode fast-sync has no caught-up exit."""
        if self.consensus_reactor is not None:
            self.consensus_reactor.switch_to_consensus(state)

    def _announce_fullcommit(self, data) -> None:
        """EVENT_NEW_BLOCK listener: push the just-committed height's
        FullCommit to 0x68 subscribers (cheap without subscribers)."""
        try:
            height = (
                data.block.header.height
                if data is not None and getattr(data, "block", None) is not None
                else self.block_store.height
            )
            self.lightclient_reactor.announce_height(height)
        except Exception:
            import logging

            logging.getLogger(__name__).exception("fullcommit announce failed")

    def _on_state_synced(self, state) -> None:
        """State sync ended: with a restored state, adopt it and
        fast-sync only the tail; with None (gave up), fall back to plain
        fast-sync from the current (genesis) state."""
        if state is not None:
            self.state = state
            self.statesync_reactor.state = state
        self.blockchain_reactor.begin_fast_sync(state)

    def _maybe_snapshot(self) -> None:
        try:
            self.statesync_reactor.maybe_take_snapshot(
                self.current_state, app=self.app
            )
        except Exception:
            import logging

            logging.getLogger(__name__).exception("snapshot failed")

    @property
    def _node_key(self):
        """Long-lived node identity key for SecretConnection handshakes —
        the dedicated node_key.json key (node_id is derived from it, so
        the encrypted transport's identity check pins peers to their
        ids), never the validator signing key."""
        if not self.config.p2p.secret_connections:
            return None
        return self.node_key.priv_key

    def start(self) -> None:
        if self.config.p2p.laddr:
            # bind BEFORE reactors start so the advertised listen_addr
            # (NodeInfo/PEX) carries the real port — but don't ACCEPT
            # until the reactors are running (an early inbound peer
            # would hit pre-start reactors)
            self.listener = TcpListener(
                self.switch,
                self.config.p2p.laddr,
                priv_key=self._node_key,
                start=False,
            )
            if self.config.p2p.external_address:
                self.switch.listen_addr = self.config.p2p.external_address
            else:
                host = self.config.p2p.laddr.split("://", 1)[-1].rpartition(":")[0]
                # single-host fallback only — multi-machine deployments
                # must set p2p.external_address or peers learn loopback
                adv_host = "127.0.0.1" if host in ("0.0.0.0", "") else host
                self.switch.listen_addr = f"{adv_host}:{self.listener.port}"
        # live-view gauges (peer count, p2p rates, mempool depth) read
        # through this node at scrape time (`GET /metrics`)
        from tendermint_tpu_torch.telemetry.metrics import bind_node_gauges

        bind_node_gauges(self)
        # contention observatory: continuous profiling when the env
        # knob asks for it (TENDERMINT_TPU_PROFILE_HZ > 0); the
        # process-global sampler outlives any one node, so stop() never
        # tears it down
        from tendermint_tpu_torch.telemetry.profiler import maybe_start_env

        maybe_start_env()
        self.switch.start()  # reactors start; consensus starts unless fast-syncing
        if self.listener is not None:
            self.listener.start_accepting()
        if self.config.rpc.laddr:
            self.rpc = RPCServer(
                make_routes(self),
                self.config.rpc.laddr,
                event_switch=self.event_switch,
            )
            self.rpc.start()
        if self.config.rpc.grpc_laddr:
            from tendermint_tpu_torch.rpc.grpc_api import GRPCBroadcastServer

            self.grpc = GRPCBroadcastServer(self, self.config.rpc.grpc_laddr)
            self.grpc.start()
        for seed in filter(None, self.config.p2p.seeds.split(",")):
            self.dial_seed(seed.strip())
        self._p2p_running = True
        for addr in self._persistent_addrs:
            self._spawn_persistent_dial(addr)

    def dial_seed(self, addr: str) -> None:
        """Dial one seed address; failures are logged, not raised (the
        reference dials seeds with per-seed error handling). Also the
        dial_seeds RPC's worker."""
        try:
            dial(self.switch, addr, priv_key=self._node_key)
        except Exception:
            import logging

            logging.getLogger(__name__).warning("dial %s failed", addr)

    # -- persistent peers ---------------------------------------------------

    @staticmethod
    def _split_persistent_addr(addr: str) -> tuple[str | None, str]:
        """`id@host:port` -> (expected node_id, dialable addr); plain
        `host:port` -> (None, addr). The id form is the reference's
        persistent_peers syntax and pins reconnects to a transport
        identity instead of a (possibly NAT-shared) host."""
        head, sep, rest = addr.partition("@")
        if sep and head and "://" not in head and ":" not in head:
            return head, rest
        return None, addr

    def _on_peer_removed(self, peer, reason) -> None:
        """Heal dropped persistent links (reference `p2p/switch.go:290-320`)."""
        addr = self._peer_addr.pop(peer.id, None)
        if addr is None:
            for cand in self._persistent_addrs:
                expected_id, dial_addr = self._split_persistent_addr(cand)
                if expected_id == peer.id or (
                    expected_id is None
                    and peer.node_info.listen_addr == dial_addr
                ):
                    # inbound persistent peer (they dialed us): ours to heal
                    addr = cand
                    break
        if addr is None or not self._p2p_running:
            return
        self._spawn_persistent_dial(addr)

    def _adopt_inbound_persistent(self, addr: str) -> None:
        """Map an already-connected peer to its persistent address so a
        later drop gets redialed (they-dialed-first / race cases).
        Match precedence: pinned node_id (`id@host:port` form), then
        advertised listen_addr, then socket host — but the bare host
        match only when it is unambiguous (exactly one unmapped
        candidate), since several NAT'd peers can share one IP and a
        wrong mapping makes a later drop redial the wrong address."""
        expected_id, dial_addr = self._split_persistent_addr(addr)
        candidates = [p for p in self.switch.peers() if p.id not in self._peer_addr]
        if expected_id is not None:
            for p in candidates:
                if p.id == expected_id:
                    self._peer_addr[p.id] = addr
                    return
            return  # pinned id not connected: nothing safe to adopt
        for p in candidates:
            if p.node_info.listen_addr == dial_addr:
                self._peer_addr[p.id] = addr
                return
        host = dial_addr.split("://")[-1].rsplit(":", 1)[0]
        by_host = [
            p
            for p in candidates
            if p.remote_addr and p.remote_addr.rsplit(":", 1)[0] == host
        ]
        if len(by_host) == 1:
            self._peer_addr[by_host[0].id] = addr

    def _spawn_persistent_dial(self, addr: str) -> None:
        with self._persistent_lock:
            if addr in self._persistent_dialing:
                return  # a redial loop for this address is already running
            self._persistent_dialing.add(addr)
        threading.Thread(
            target=self._persistent_dial_loop,
            args=(addr,),
            name=f"persistent-dial-{addr}",
            daemon=True,
        ).start()

    def _persistent_dial_loop(self, addr: str) -> None:
        import logging
        import time

        from tendermint_tpu_torch.utils.backoff import backoff_delay

        cfg = self.config.p2p
        log = logging.getLogger(__name__)
        expected_id, dial_addr = self._split_persistent_addr(addr)
        try:
            for attempt in range(max(1, cfg.reconnect_max_attempts)):
                if not self._p2p_running:
                    return
                try:
                    peer = dial(self.switch, dial_addr, priv_key=self._node_key)
                    if expected_id is not None and peer.id != expected_id:
                        self.switch.stop_peer(peer, "persistent peer id mismatch")
                        raise ConnectionError(
                            f"dialed {dial_addr}: got id {peer.id[:12]}, "
                            f"want {expected_id[:12]}"
                        )
                    self._peer_addr[peer.id] = addr
                    # the peer may have died between registration and the
                    # mapping write above — then _on_peer_removed already
                    # ran, found no mapping, and nobody would redial
                    if self.switch._peers.get(peer.id) is not peer:
                        self._peer_addr.pop(peer.id, None)
                        raise ConnectionError("peer dropped during dial")
                    return
                except Exception as e:
                    if "duplicate peer" in str(e):
                        # already connected (e.g. they dialed us first):
                        # adopt the live peer so a later drop still heals
                        self._adopt_inbound_persistent(addr)
                        return
                    # capped exponential backoff with jitter (reference
                    # reconnect backoff p2p/switch.go:290-320)
                    time.sleep(
                        backoff_delay(attempt, cfg.reconnect_base_backoff_s)
                    )
            log.warning(
                "giving up on persistent peer %s after %d attempts",
                addr,
                cfg.reconnect_max_attempts,
            )
        finally:
            with self._persistent_lock:
                self._persistent_dialing.discard(addr)

    def stop(self) -> None:
        self._p2p_running = False  # stop persistent-peer redial loops
        if self.grpc is not None:
            self.grpc.stop()
        if self.rpc is not None:
            self.rpc.stop()
        if self.listener is not None:
            self.listener.stop()
        self.switch.stop()
        self.mempool.close()
        self.evidence_pool.close()
        self.app_conns.close()
        if getattr(self, "_span_log", None) is not None:
            from tendermint_tpu_torch.telemetry import TRACER

            TRACER.clear_sink(self._span_log.append)
            self._span_log.close()
        if getattr(self, "height_ledger", None) is not None:
            self.height_ledger.close()

    def health(self) -> dict:
        """The `/health` snapshot (telemetry/health.py): readiness +
        degradation checks + the rolling finality SLO, all node-local."""
        from tendermint_tpu_torch.telemetry.health import build_health

        return build_health(self)

    # -- convenience -------------------------------------------------------

    @property
    def current_state(self) -> State:
        """The live chain state. Consensus REBINDS its state on every
        commit (finalize copies then adopts), so `self.state` only
        tracks fast-sync's in-place mutations — RPC must read through
        here or it serves startup-time state forever."""
        if self.consensus is not None and self.consensus.state is not None:
            return self.consensus.state
        return self.state

    @property
    def rpc_port(self) -> int:
        return self.rpc.port if self.rpc else 0

    @property
    def p2p_port(self) -> int:
        return self.listener.port if self.listener else 0

    def wait_height(self, height: int, timeout: float = 60.0) -> None:
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.block_store.height >= height:
                return
            time.sleep(0.05)
        raise TimeoutError(f"node did not reach height {height}")
