"""Multiplexed prioritized channels over one endpoint.

The reference's MConnection (`p2p/connection.go:66-114`) carries N
logical channels with byte IDs and priorities over one TCP conn, with
send-queue backpressure and flow limits. Same design here over the
`transport.Endpoint` seam: a send thread drains per-channel queues
weighted by priority; a recv thread parses frames and hands
(chan_id, payload) to the owner's on_receive callback.

Frame format (TCP-ready, though the in-memory pipe preserves framing
anyway): uvarint chan_id || uvarint len || payload [|| trace block].

The trace block is OPTIONAL and trailing — `telemetry/tracectx.py`'s
TraceContext wire encoding. Codec-backward-compatible by construction:
a frame without it is byte-identical to the old format and decodes
unchanged; a receiver that doesn't know the block ignores trailing
bytes; a decode failure drops the context (counted), never the frame.
Sampled-out messages carry no context bytes at all. (tmlint rule W001
checks this trailing-optional discipline statically for every decoder.)

Concurrency: this class is deliberately LOCK-FREE — channels are
`queue.Queue`s, wakeups are Events, and per-link state is owned by the
send/recv/ping threads. The locks it leans on live in its
collaborators and rank near the top of the utils/lockrank.py table:
the flowrate monitors ("p2p.flowrate") and the endpoint write locks
("p2p.conn.write"), both leaves acquired under nothing else.

The port's copy of `tendermint_tpu/p2p/connection.py`: the same frame
format, trace block (the port's `tracectx`, byte for byte the JAX
package's), keepalive and channel scheduling, so a port peer and a JAX
peer exchange frames.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.p2p.score import PeerMisbehavior
from tendermint_tpu_torch.p2p.transport import Endpoint, EndpointClosed
from tendermint_tpu_torch.telemetry import TRACER
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.telemetry import tracectx as _trace
from tendermint_tpu_torch.telemetry.tracectx import TraceContext
from tendermint_tpu_torch.utils.flowrate import Monitor


def build_frame(chan_id: int, payload: bytes, ctx: TraceContext | None = None) -> bytes:
    """One wire frame; `ctx=None` produces the exact legacy bytes."""
    w = Writer().uvarint(chan_id).bytes(payload)
    if ctx is not None:
        w.raw(ctx.encode_wire())
    return w.build()


def parse_frame(frame: bytes) -> tuple[int, bytes, TraceContext | None]:
    """(chan_id, payload, trace context or None). Absent or
    undecodable trailing block ⇒ no context (the frame itself always
    survives — tracing is forensic, never load-bearing)."""
    r = Reader(frame)
    chan_id = r.uvarint()
    payload = r.bytes()
    ctx = None
    if not r.done():
        try:
            ctx = TraceContext.decode_wire(r)
        except Exception:
            _metrics.TRACE_DROPPED.inc()
    return chan_id, payload, ctx

# Hard per-frame size cap: whole blocks ride fast-sync responses (21 MB
# block cap + framing overhead), nothing legitimate exceeds this. An
# oversize frame is adversarial by definition — the sender is dropped
# (and scored) before the payload is even parsed.
MAX_FRAME_SIZE = 32 * 1024 * 1024

# Internal keepalive channel (reference sends dedicated packetTypePing/
# packetTypePong frames, `p2p/connection.go:312-345`; here they ride a
# reserved channel id no reactor may claim).
CTRL_CHANNEL = 0xFF
_PING = b"\x01"
_PONG = b"\x02"
# Reference pingTimeout is 40s; pong grace on top before declaring dead.
DEFAULT_PING_INTERVAL = 40.0
DEFAULT_PONG_TIMEOUT = 20.0


@dataclass(frozen=True)
class ChannelDescriptor:
    """Reference `p2p/connection.go` ChannelDescriptor."""

    id: int
    priority: int = 1
    send_queue_capacity: int = 64


class _Channel:
    def __init__(self, desc: ChannelDescriptor) -> None:
        self.desc = desc
        # (payload, trace context or None, enqueue perf_counter) — the
        # timestamp feeds tendermint_p2p_send_wait_seconds when the
        # send loop dequeues (the wait twin of the depth gauges)
        self.queue: "queue.Queue[tuple[bytes, TraceContext | None, float]]" = (
            queue.Queue(maxsize=desc.send_queue_capacity)
        )
        self.recently_sent = 0


class MConnection:
    """One peer link: channel-multiplexed, priority-scheduled sends.

    on_receive(chan_id, payload) runs on the recv thread; on_error(exc)
    fires once when either side dies (the Switch uses it to drop the
    peer — reference `stopForError p2p/connection.go:212-219`).
    """

    def __init__(
        self,
        endpoint: Endpoint,
        channels: list[ChannelDescriptor],
        on_receive,
        on_error=None,
        send_limit: int = 0,
        recv_limit: int = 0,
        ping_interval: float = DEFAULT_PING_INTERVAL,
        pong_timeout: float = DEFAULT_PONG_TIMEOUT,
        local_node_id: str = "",
        on_traffic=None,
    ) -> None:
        # who WE are, for `p2p.hop` span attribution (the Switch wires
        # its node id through Peer; "" on bare test connections)
        self.local_node_id = local_node_id
        # gossip observatory hook: on_traffic(direction, chan_id,
        # payload, frame_len) fires per frame AFTER the wire bytes are
        # fixed — it observes, never alters (Peer binds the remote id
        # and forwards into the switch's GossipRollup; None = sampled
        # out, zero per-frame overhead)
        self._on_traffic = on_traffic
        # per-connection throughput stats + optional rate caps
        # (reference flowrate.Monitor at p2p/connection.go:72-73)
        self.send_monitor = Monitor(send_limit)
        self.recv_monitor = Monitor(recv_limit)
        self._endpoint = endpoint
        if any(d.id == CTRL_CHANNEL for d in channels):
            raise ValueError(f"channel id {CTRL_CHANNEL:#x} is reserved for keepalive")
        self._channels: dict[int, _Channel] = {
            d.id: _Channel(d) for d in channels
        }
        # keepalive frames outrank data so a saturated link still pongs
        self._ctrl = _Channel(
            ChannelDescriptor(id=CTRL_CHANNEL, priority=100, send_queue_capacity=4)
        )
        self._channels[CTRL_CHANNEL] = self._ctrl
        self._on_receive = on_receive
        self._on_error = on_error
        self._send_wake = threading.Event()
        self._running = False
        self._stopped = False  # terminal: refuses sends; pre-start queues them
        self._threads: list[threading.Thread] = []
        self._err_once = threading.Event()
        self.ping_interval = ping_interval
        self.pong_timeout = pong_timeout
        self._last_recv = time.monotonic()
        self._ping_stop = threading.Event()

    def start(self) -> None:
        self._running = True
        self._last_recv = time.monotonic()
        loops = [(self._send_loop, "send"), (self._recv_loop, "recv")]
        if self.ping_interval > 0:
            loops.append((self._ping_loop, "ping"))
        for fn, name in loops:
            t = threading.Thread(target=fn, name=f"mconn-{name}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._running = False
        self._stopped = True
        self._ping_stop.set()
        self._endpoint.close()
        self._send_wake.set()

    # -- sending -----------------------------------------------------------

    def send(
        self,
        chan_id: int,
        payload: bytes,
        timeout: float = 5.0,
        ctx: TraceContext | None = None,
    ) -> bool:
        """Queue for send; blocks up to timeout on a full channel queue
        (reference `Send` blocks, `TrySend` doesn't). Sends BEFORE
        start() queue up and flush once the send loop runs — reactors
        greet a new peer (add_peer step messages) before it starts.
        `ctx` (or, when None, the calling thread's ambient trace
        context) is captured NOW and framed with the payload — the send
        loop runs on its own thread."""
        ch = self._channels.get(chan_id)
        if ch is None:
            raise ValueError(f"unknown channel {chan_id:#x}")
        if self._stopped:
            return False
        if ctx is None:
            ctx = _trace.current()
        try:
            ch.queue.put((payload, ctx, time.perf_counter()), timeout=timeout)
        except queue.Full:
            return False
        self._send_wake.set()
        return True

    def try_send(
        self, chan_id: int, payload: bytes, ctx: TraceContext | None = None
    ) -> bool:
        ch = self._channels.get(chan_id)
        if ch is None:
            raise ValueError(f"unknown channel {chan_id:#x}")
        if self._stopped:
            return False
        if ctx is None:
            ctx = _trace.current()
        try:
            ch.queue.put_nowait((payload, ctx, time.perf_counter()))
        except queue.Full:
            return False
        self._send_wake.set()
        return True

    def send_queue_depth(self) -> int:
        """Frames queued across all channels — the backpressure signal
        the `tendermint_p2p_send_queue_*` gauges roll up."""
        return sum(ch.queue.qsize() for ch in self._channels.values())

    def _pick_channel(self) -> _Channel | None:
        """Least-recently-sent-relative-to-priority scheduling (the
        reference's sendSomePacketMsgs weighting)."""
        best: _Channel | None = None
        best_ratio = float("inf")
        for ch in self._channels.values():
            if ch.queue.empty():
                continue
            ratio = ch.recently_sent / max(ch.desc.priority, 1)
            if ratio < best_ratio:
                best_ratio = ratio
                best = ch
        return best

    def _send_loop(self) -> None:
        try:
            while self._running:
                ch = self._pick_channel()
                if ch is None:
                    # decay counters while idle so one burst doesn't
                    # starve a channel forever
                    for c in self._channels.values():
                        c.recently_sent //= 2
                    self._send_wake.wait(timeout=0.05)
                    self._send_wake.clear()
                    continue
                try:
                    payload, ctx, t_enq = ch.queue.get_nowait()
                except queue.Empty:
                    continue
                _metrics.P2P_SEND_WAIT.observe(time.perf_counter() - t_enq)
                frame = build_frame(ch.desc.id, payload, ctx)
                if ctx is not None:
                    _metrics.TRACE_PROPAGATED.inc()
                self.send_monitor.throttle()
                self._endpoint.send(frame)
                self.send_monitor.update(len(frame))
                # process-wide throughput counter alongside the per-peer
                # monitor (rates come from the monitors at scrape time)
                _metrics.P2P_SENT_BYTES.inc(len(frame))
                if self._on_traffic is not None:
                    self._on_traffic("send", ch.desc.id, payload, len(frame))
                ch.recently_sent += len(payload)
        except EndpointClosed:
            self._die(None)
        except Exception as e:  # transport failure kills the peer
            self._die(e)

    # -- receiving ---------------------------------------------------------

    def _recv_loop(self) -> None:
        try:
            while self._running:
                frame = self._endpoint.recv()
                self.recv_monitor.update(len(frame))
                _metrics.P2P_RECV_BYTES.inc(len(frame))
                # inbound flow control: delay further reads once over
                # the cap (the sender blocks on TCP backpressure)
                self.recv_monitor.throttle()
                # Adversarial-input boundary: a malformed, truncated, or
                # oversized frame is THIS PEER's fault — surface a typed
                # PeerMisbehavior through on_error (the switch debits
                # its score and drops only this peer) instead of letting
                # the parse error masquerade as a transport failure or,
                # worse, crash the reader thread.
                if len(frame) > MAX_FRAME_SIZE:
                    self._die(
                        PeerMisbehavior(
                            "oversize_frame", f"{len(frame)} bytes"
                        )
                    )
                    return
                try:
                    chan_id, payload, ctx = parse_frame(frame)
                except Exception as e:
                    self._die(PeerMisbehavior("bad_frame", str(e)))
                    return
                self._last_recv = time.monotonic()
                if self._on_traffic is not None:
                    self._on_traffic("recv", chan_id, payload, len(frame))
                if chan_id == CTRL_CHANNEL:
                    # keepalive (reference recvRoutine ping/pong handling
                    # `p2p/connection.go:412-425`): answer pings; any pong
                    # already refreshed _last_recv above
                    if payload == _PING:
                        try:
                            self._ctrl.queue.put_nowait((_PONG, None, time.perf_counter()))
                            self._send_wake.set()
                        except queue.Full:
                            pass  # a pong is already queued
                    continue
                if chan_id not in self._channels:
                    continue  # unknown channel: drop (fuzz/future-proof)
                if ctx is None:
                    self._on_receive(chan_id, payload)
                else:
                    # one hop span per traced frame, then process with
                    # the re-parented context ambient so reactor →
                    # mempool/consensus work (and any gossip-out it
                    # triggers) stays on this trace
                    now = time.time()
                    TRACER.add(
                        "p2p.hop",
                        now,
                        now,
                        trace=ctx.trace,
                        origin=ctx.origin,
                        node=self.local_node_id,
                        chan=chan_id,
                    )
                    with _trace.use(ctx.rehop()):
                        self._on_receive(chan_id, payload)
        except EndpointClosed:
            self._die(None)
        except Exception as e:
            self._die(e)

    # -- keepalive ---------------------------------------------------------

    def _ping_loop(self) -> None:
        """Ping idle peers; kill the conn when nothing (not even a pong)
        arrives for ping_interval + pong_timeout (reference pingTimeout,
        `p2p/connection.go:312-345`). Without this an idle-but-dead peer
        holds its slot until some send fails."""
        tick = min(1.0, self.ping_interval / 4)
        last_ping = 0.0
        while self._running and not self._ping_stop.wait(timeout=tick):
            now = time.monotonic()
            idle = now - self._last_recv
            if idle > self.ping_interval + self.pong_timeout:
                self._die(TimeoutError(f"peer silent for {idle:.1f}s (ping timeout)"))
                return
            # one ping per interval, not per tick — re-ping only after the
            # previous one has gone unanswered a full interval
            if idle > self.ping_interval and now - last_ping > self.ping_interval:
                last_ping = now
                try:
                    self._ctrl.queue.put_nowait((_PING, None, time.perf_counter()))
                    self._send_wake.set()
                except queue.Full:
                    pass  # a ping is already in flight

    def _die(self, exc: Exception | None) -> None:
        if self._err_once.is_set():
            return
        self._err_once.set()
        self._running = False
        self._stopped = True
        self._ping_stop.set()
        self._endpoint.close()
        if self._on_error is not None:
            self._on_error(exc)
