"""Switch: reactor registry + peer lifecycle + channel dispatch.

Reference `p2p/switch.go:20-28,60-76,106-121`. Reactors register
channel descriptors; incoming frames dispatch to the reactor owning the
channel. `make_connected_switches` / `connect_switches` wire N switches
over in-memory pipes — the reference's net.Pipe test harness
(`p2p/switch.go:502-534`) promoted to the primary local transport.

The port's copy of `tendermint_tpu/p2p/switch.py`. It keeps the
reference's behaviours, the duplicate-peer refusal included (a
restarted peer whose old link has not yet dropped is refused once), and
a bare `Switch` has no rate cap (`send_rate` / `recv_rate` 0).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.peer import NodeInfo, Peer
from tendermint_tpu_torch.p2p.score import PeerMisbehavior, PeerScorer
from tendermint_tpu_torch.p2p.transport import Endpoint, pipe_pair
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.telemetry.gossiplog import GossipRollup
from tendermint_tpu_torch.utils.lockrank import ranked_rlock
from tendermint_tpu_torch.utils.log import kv, logger


class Reactor:
    """Plugin seam (reference `p2p/switch.go:20-28`)."""

    def __init__(self) -> None:
        self.switch: "Switch | None" = None

    def set_switch(self, switch: "Switch") -> None:
        self.switch = switch

    def get_channels(self) -> list[ChannelDescriptor]:
        raise NotImplementedError

    def add_peer(self, peer: Peer) -> None:  # noqa: B027 — optional hook
        pass

    def remove_peer(self, peer: Peer, reason) -> None:  # noqa: B027
        pass

    def receive(self, chan_id: int, peer: Peer, payload: bytes) -> None:
        raise NotImplementedError

    def on_start(self) -> None:  # noqa: B027
        pass

    def on_stop(self) -> None:  # noqa: B027
        pass


class Switch:
    def __init__(self, node_info: NodeInfo) -> None:
        self._base_info = node_info
        self._reactors: dict[str, Reactor] = {}
        self._chan_to_reactor: dict[int, Reactor] = {}
        self._descriptors: list[ChannelDescriptor] = []
        # Leaf lock by design: held only over _peers dict surgery, never
        # across reactor callbacks, peer.start/stop, or sends (lockrank
        # "p2p.switch" — near the top of the rank table).
        self._peers: dict[str, Peer] = {}
        self._mtx = ranked_rlock("p2p.switch")
        self._running = False
        self.listen_addr = node_info.listen_addr  # set once the listener binds
        # per-peer flow caps, bytes/s (0 = unlimited; reference 500 kB/s)
        self.send_rate = 0
        self.recv_rate = 0
        # keepalive cadence (reference pingTimeout `p2p/connection.go:312`);
        # 0 disables pings (in-proc test meshes don't need them)
        from tendermint_tpu_torch.p2p.connection import (
            DEFAULT_PING_INTERVAL,
            DEFAULT_PONG_TIMEOUT,
        )

        self.ping_interval = DEFAULT_PING_INTERVAL
        self.pong_timeout = DEFAULT_PONG_TIMEOUT
        # fires after a peer is fully removed: fn(peer, reason). The node
        # hangs persistent-peer reconnection off this (reference
        # `reconnectToPeer p2p/switch.go:290-320`).
        self.on_peer_removed = None
        # optional admission hook (ABCI peer filters, reference
        # `node/node.go:259-281`): fn(remote_info, remote_addr) -> error
        # string or None; a non-None return rejects the peer before
        # registration. remote_addr is the SOCKET's remote address ("" on
        # in-memory transports) — never the peer's self-reported one.
        self.peer_filter = None
        # adversarial-input defense: per-peer misbehavior scores + bans
        # (p2p/score.py). Reactors and the connection layer report
        # offenses through report_misbehavior; crossing the threshold
        # disconnects AND refuses reconnection until the ban decays.
        self.scorer = PeerScorer()
        # gossip observatory (telemetry/gossiplog.py): per-peer/channel/
        # kind traffic + redundancy rollup. Owned here so every peer's
        # connection and every reactor's dedup site stamp ONE table;
        # TENDERMINT_TPU_GOSSIPLOG=0 samples the whole node out.
        self.gossip = GossipRollup()

    @property
    def node_info(self) -> NodeInfo:
        # advertise the registered channels + dialable address
        return NodeInfo(
            node_id=self._base_info.node_id,
            moniker=self._base_info.moniker,
            chain_id=self._base_info.chain_id,
            version=self._base_info.version,
            channels=tuple(d.id for d in self._descriptors),
            listen_addr=self.listen_addr,
        )

    # -- reactors ----------------------------------------------------------

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        """Register + claim channels (reference `AddReactor :106-121`)."""
        for d in reactor.get_channels():
            if d.id in self._chan_to_reactor:
                raise ValueError(f"channel {d.id:#x} already claimed")
            self._chan_to_reactor[d.id] = reactor
            self._descriptors.append(d)
        self._reactors[name] = reactor
        reactor.set_switch(self)
        return reactor

    def reactor(self, name: str) -> Reactor:
        return self._reactors[name]

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._running = True
        for r in self._reactors.values():
            r.on_start()

    def stop(self) -> None:
        self._running = False
        with self._mtx:
            peers = list(self._peers.values())
        for p in peers:
            self.stop_peer(p, "switch stopping")
        for r in self._reactors.values():
            r.on_stop()

    # -- peers -------------------------------------------------------------

    def peers(self) -> list[Peer]:
        with self._mtx:
            return list(self._peers.values())

    def n_peers(self) -> int:
        with self._mtx:
            return len(self._peers)

    def send_rate_total(self) -> float:
        """Aggregate live-peer send rate, bytes/s — the flowrate
        monitors rolled up for the telemetry gauges."""
        return sum(p.send_monitor.rate for p in self.peers())

    def recv_rate_total(self) -> float:
        return sum(p.recv_monitor.rate for p in self.peers())

    def send_queue_depth_total(self) -> int:
        """Frames queued for send across all peers — rollup for the
        `tendermint_p2p_send_queue_depth` gauge (per-peer label series
        would be unbounded cardinality; see telemetry/metrics.py)."""
        return sum(p.send_queue_depth() for p in self.peers())

    def send_queue_depth_max(self) -> int:
        """Deepest single-peer send queue (one slow peer vs global
        backpressure)."""
        return max((p.send_queue_depth() for p in self.peers()), default=0)

    def send_queue_depths(self) -> dict[str, int]:
        """Per-peer depths for diagnostics (dump_telemetry RPC), keyed
        by peer id — deliberately NOT exported as labeled series."""
        return {p.id: p.send_queue_depth() for p in self.peers()}

    def add_peer_endpoint(
        self, remote_info: NodeInfo, endpoint: Endpoint, outbound: bool
    ) -> Peer:
        """Attach a connected endpoint as a peer (version/chain/dup checks
        per reference `addPeer :216-260`)."""
        reason = self.node_info.compatible_with(remote_info)
        if reason is not None:
            endpoint.close()
            raise ValueError(f"incompatible peer: {reason}")
        if self.scorer.is_banned(remote_info.node_id):
            endpoint.close()
            raise ValueError(f"peer banned: {remote_info.node_id[:12]}")
        if self.peer_filter is not None:
            reason = self.peer_filter(
                remote_info, getattr(endpoint, "remote_addr", "")
            )
            if reason is not None:
                endpoint.close()
                raise ValueError(f"peer filtered: {reason}")
        with self._mtx:
            if remote_info.node_id in self._peers:
                endpoint.close()
                raise ValueError(f"duplicate peer {remote_info.node_id}")
            peer = Peer(
                remote_info,
                endpoint,
                self._descriptors,
                self._dispatch,
                self._on_peer_error,
                outbound,
                send_limit=self.send_rate,
                recv_limit=self.recv_rate,
                ping_interval=self.ping_interval,
                pong_timeout=self.pong_timeout,
                local_node_id=self._base_info.node_id,
                gossip=self.gossip,
            )
            self._peers[remote_info.node_id] = peer
        # Reactors install their per-peer state BEFORE the recv loop
        # starts: a frame dispatched in the gap would find no PeerState
        # and be silently dropped — at genesis a dropped NewRoundStep
        # wedged vote gossip for good (found by the nemesis harness).
        # Outbound sends queue in the channel buffers until start().
        for r in self._reactors.values():
            r.add_peer(peer)
        peer.start()
        kv(
            logger("p2p"),
            logging.INFO,
            "peer connected",
            peer=remote_info.moniker,
            id=remote_info.node_id[:12],
            outbound=outbound,
        )
        return peer

    def stop_peer(self, peer: Peer, reason) -> None:
        with self._mtx:
            if self._peers.get(peer.id) is not peer:
                return
            del self._peers[peer.id]
        peer.stop()
        kv(
            logger("p2p"),
            logging.INFO,
            "peer disconnected",
            id=peer.id[:12],
            reason=str(reason)[:60],
        )
        for r in self._reactors.values():
            r.remove_peer(peer, reason)
        if self.on_peer_removed is not None:
            self.on_peer_removed(peer, reason)

    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        """Reference `StopPeerForError` — reactors call this on bad
        messages; the peer is dropped everywhere."""
        self.stop_peer(peer, reason)

    # -- misbehavior ---------------------------------------------------------

    def report_misbehavior(
        self, peer, kind: str, detail: str = "", weight: int | None = None
    ) -> None:
        """Debit one classified offense against a peer (`Peer` or node
        id). Crossing the ban threshold bans + disconnects it; below
        threshold the peer stays connected (score decay forgives honest
        noise). Severe kinds carry weights that ban in 1-2 offenses
        (p2p/score.py MISBEHAVIOR_WEIGHTS)."""
        peer_obj = peer if isinstance(peer, Peer) else None
        peer_id = peer_obj.id if peer_obj is not None else str(peer or "")
        if not peer_id:
            return  # internal / self-originated input: never self-ban
        _metrics.PEER_MISBEHAVIOR.labels(kind=kind).inc()
        kv(
            logger("p2p"),
            logging.WARNING,
            "peer misbehavior",
            id=peer_id[:12],
            kind=kind,
            score=round(self.scorer.score(peer_id), 1),
            detail=detail[:80],
        )
        if self.scorer.debit(peer_id, kind, weight=weight):
            self.ban_peer(peer_id, reason=f"misbehavior threshold ({kind})")

    def ban_peer(self, peer_id: str, reason: str = "banned") -> None:
        """Ban + disconnect by node id (idempotent)."""
        self.scorer.ban(peer_id)
        _metrics.PEER_BANS.inc()
        kv(logger("p2p"), logging.WARNING, "peer banned", id=peer_id[:12], reason=reason)
        with self._mtx:
            peer = self._peers.get(peer_id)
        if peer is not None:
            self.stop_peer(peer, reason)

    def _on_peer_error(self, peer: Peer, exc) -> None:
        if isinstance(exc, PeerMisbehavior):
            # connection-layer offense (bad/oversize frame): debit the
            # score BEFORE the drop so repeat offenders get banned and
            # cannot cycle reconnect->garbage->disconnect forever
            self.report_misbehavior(peer, exc.kind, detail=exc.detail)
        self.stop_peer(peer, exc)

    def _dispatch(self, chan_id: int, peer: Peer, payload: bytes) -> None:
        reactor = self._chan_to_reactor.get(chan_id)
        if reactor is None:
            return
        try:
            reactor.receive(chan_id, peer, payload)
        except Exception as e:
            # a reactor exploding on a message is peer-fault by default:
            # the frame parsed but its payload didn't survive the
            # reactor's decode/validate — score it, then drop the peer
            self.report_misbehavior(peer, "bad_msg", detail=str(e))
            self.stop_peer_for_error(peer, e)

    # -- broadcast ---------------------------------------------------------

    def broadcast(self, chan_id: int, payload: bytes) -> None:
        for p in self.peers():
            p.try_send(chan_id, payload)


def connect_switches(a: Switch, b: Switch, wrap=None) -> tuple[Peer, Peer]:
    """Wire two switches over an in-memory pipe (reference
    `Connect2Switches p2p/switch.go:526-534`).

    `wrap`, when given, maps the two raw endpoints to (possibly
    fault-injecting) replacements before the peers attach — the seam
    chaos harnesses (`testing/nemesis.py`) use to own a link's faults:
    `wrap(endpoint_a, endpoint_b) -> (endpoint_a', endpoint_b')`."""
    ea, eb = pipe_pair()
    if wrap is not None:
        ea, eb = wrap(ea, eb)
    pa = a.add_peer_endpoint(b.node_info, ea, outbound=True)
    pb = b.add_peer_endpoint(a.node_info, eb, outbound=False)
    return pa, pb


def make_connected_switches(
    n: int, init: Callable[[int], Switch], full_mesh: bool = True
) -> list[Switch]:
    """N started switches, fully meshed (reference
    `MakeConnectedSwitches p2p/switch.go:502-524`)."""
    switches = [init(i) for i in range(n)]
    for s in switches:
        s.start()
    if full_mesh:
        for i in range(n):
            for j in range(i + 1, n):
                connect_switches(switches[i], switches[j])
    return switches
