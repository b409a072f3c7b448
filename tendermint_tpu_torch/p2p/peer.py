"""Peer: one remote node = NodeInfo + multiplexed connection.

Reference `p2p/peer.go:17` — here the secret-connection handshake is a
transport concern (the in-memory transport is already authenticated by
construction); NodeInfo exchange happens at connect time through the
Switch.

The port's copy of `tendermint_tpu/p2p/peer.py`; `NodeInfo` encodes to
the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor, MConnection
from tendermint_tpu_torch.p2p.transport import Endpoint


@dataclass(frozen=True)
class NodeInfo:
    """Reference `p2p/peer.go` NodeInfo (identity + compat handshake).
    `listen_addr` is the peer's dialable address ("host:port", empty for
    non-listening nodes) — PEX gossips it to other peers."""

    node_id: str  # hex of the node key address
    moniker: str
    chain_id: str
    version: str = "0.1.0"
    channels: tuple[int, ...] = ()
    listen_addr: str = ""

    def encode(self) -> bytes:
        w = (
            Writer()
            .string(self.node_id)
            .string(self.moniker)
            .string(self.chain_id)
            .string(self.version)
        )
        w.uvarint(len(self.channels))
        for c in self.channels:
            w.uvarint(c)
        w.string(self.listen_addr)
        return w.build()

    @classmethod
    def decode(cls, data: bytes) -> "NodeInfo":
        r = Reader(data)
        node_id, moniker, chain_id, version = (
            r.string(),
            r.string(),
            r.string(),
            r.string(),
        )
        channels = tuple(r.uvarint() for _ in range(r.uvarint()))
        listen_addr = r.string() if not r.done() else ""
        return cls(node_id, moniker, chain_id, version, channels, listen_addr)

    def compatible_with(self, other: "NodeInfo") -> str | None:
        """None if compatible, else the reason (reference
        `NodeInfo.CompatibleWith`)."""
        if self.chain_id != other.chain_id:
            return f"chain_id mismatch: {self.chain_id} != {other.chain_id}"
        if self.node_id == other.node_id:
            return "self-connection"
        return None


class Peer:
    """A connected peer: send/receive by channel + a KV store that
    reactors use for per-peer state (reference peer.Set/Get, used for
    `PeerState`)."""

    def __init__(
        self,
        node_info: NodeInfo,
        endpoint: Endpoint,
        channels: list[ChannelDescriptor],
        on_receive,
        on_error,
        outbound: bool,
        send_limit: int = 0,
        recv_limit: int = 0,
        ping_interval: float | None = None,
        pong_timeout: float | None = None,
        local_node_id: str = "",
        gossip=None,
    ) -> None:
        self.node_info = node_info
        self.outbound = outbound
        self.data: dict[str, object] = {}  # reactor KV (PeerState lives here)
        kw = {}
        if ping_interval is not None:
            kw["ping_interval"] = ping_interval
        if pong_timeout is not None:
            kw["pong_timeout"] = pong_timeout
        if gossip is not None and gossip.enabled:
            # gossip observatory: bind OUR view of the remote id to every
            # frame the connection sees (disabled rollup -> no hook at
            # all, the sampled-out fast path)
            remote = node_info.node_id
            kw["on_traffic"] = (
                lambda direction, chan_id, payload, frame_len: gossip.record(
                    remote, direction, chan_id, payload, frame_len
                )
            )
        self._conn = MConnection(
            endpoint,
            channels,
            lambda ch, payload: on_receive(ch, self, payload),
            lambda exc: on_error(self, exc),
            send_limit=send_limit,
            recv_limit=recv_limit,
            local_node_id=local_node_id,
            **kw,
        )

    @property
    def send_monitor(self):
        return self._conn.send_monitor

    @property
    def recv_monitor(self):
        return self._conn.recv_monitor

    def send_queue_depth(self) -> int:
        return self._conn.send_queue_depth()

    @property
    def remote_addr(self) -> str:
        """Socket-level remote address ("" for in-memory transports)."""
        return getattr(self._conn._endpoint, "remote_addr", "")

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def start(self) -> None:
        self._conn.start()

    def stop(self) -> None:
        self._conn.stop()

    def send(self, chan_id: int, payload: bytes, ctx=None) -> bool:
        """`ctx` (a `telemetry.tracectx.TraceContext`) rides the frame;
        None falls back to the calling thread's ambient context."""
        return self._conn.send(chan_id, payload, ctx=ctx)

    def try_send(self, chan_id: int, payload: bytes, ctx=None) -> bool:
        return self._conn.try_send(chan_id, payload, ctx=ctx)

    def get(self, key: str, default=None):
        return self.data.get(key, default)

    def set(self, key: str, value) -> None:
        self.data[key] = value

    def __repr__(self) -> str:
        return f"Peer({self.node_info.moniker}:{self.id[:8]})"
