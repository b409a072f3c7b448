"""Byte transports: in-memory pipes + fault injection.

The in-memory pipe fills the slot of the reference's `net.Pipe` test
transport (`p2p/switch.go:502-534` MakeConnectedSwitches wiring); the
`Endpoint` interface is what a TCP/secret-connection transport plugs
into later. `FuzzedEndpoint` is the network fault injector (reference
`p2p/fuzz.go:19-47`: probabilistic drops, delays, connection death).

The port's copy of `tendermint_tpu/p2p/transport.py`, with the same
fault knobs and RNG draw order and the same lazy metrics import (the
port's `telemetry.metrics`).
"""

from __future__ import annotations

import heapq
import logging
import queue
import random
import threading
import time
from dataclasses import dataclass

from tendermint_tpu_torch.utils.log import kv, logger

_log = logger("transport")


class EndpointClosed(Exception):
    pass


class Endpoint:
    """One end of a bidirectional message-framed byte link.

    send() never blocks forever (bounded queue, drop-on-close); recv()
    blocks until a frame arrives or the link closes (raises
    EndpointClosed). Framing is preserved: one send -> one recv.
    """

    def __init__(self, out_q: "queue.Queue", in_q: "queue.Queue") -> None:
        self._out = out_q
        self._in = in_q
        self._closed = threading.Event()

    def send(self, data: bytes, timeout: float = 10.0) -> bool:
        if self._closed.is_set():
            raise EndpointClosed
        try:
            self._out.put(data, timeout=timeout)
            return True
        except queue.Full:
            return False

    def recv(self, timeout: float | None = None) -> bytes:
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            if self._closed.is_set() and self._in.empty():
                raise EndpointClosed
            remaining = 0.05
            if deadline is not None:
                remaining = min(remaining, deadline - time.monotonic())
                if remaining <= 0:
                    raise TimeoutError
            try:
                item = self._in.get(timeout=remaining)
            except queue.Empty:
                continue
            if item is _CLOSE:
                self._closed.set()
                raise EndpointClosed
            return item

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        # wake the far side's recv
        try:
            self._out.put_nowait(_CLOSE)
        except queue.Full:
            pass
        # wake our own blocked recv
        try:
            self._in.put_nowait(_CLOSE)
        except queue.Full:
            pass

    @property
    def closed(self) -> bool:
        return self._closed.is_set()


_CLOSE = object()


def pipe_pair(capacity: int = 1024) -> tuple[Endpoint, Endpoint]:
    """Two connected in-memory endpoints (the net.Pipe analog)."""
    a_to_b: "queue.Queue" = queue.Queue(maxsize=capacity)
    b_to_a: "queue.Queue" = queue.Queue(maxsize=capacity)
    return Endpoint(a_to_b, b_to_a), Endpoint(b_to_a, a_to_b)


class _TokenBucket:
    """Virtual-clock token bucket: rate `bps` bits/s, burst
    `burst_bytes` of idle credit. `wait(nbytes, now)` returns how long
    the caller's delivery must lag `now` for the link to have drained
    this message — 0 while burst credit lasts. Thread-safe; zero or
    negative rate means uncapped (never waits)."""

    def __init__(self) -> None:
        self._vt = 0.0  # virtual time the modeled queue drains
        self._lock = threading.Lock()

    def wait(self, nbytes: int, now: float, bps: float, burst_bytes: int) -> float:
        if bps <= 0:
            return 0.0
        ser_s = nbytes * 8.0 / bps
        burst_s = max(0, burst_bytes) * 8.0 / bps
        with self._lock:
            self._vt = max(self._vt, now - burst_s) + ser_s
            return max(0.0, self._vt - now)


@dataclass
class FuzzConfig:
    """Reference `p2p/fuzz.go` FuzzConnConfig, grown WAN-shaped knobs.

    All-zero defaults are a byte-for-byte no-op (golden-tested): the
    added fields only change behavior when set, so existing fuzz
    configurations keep their exact semantics and RNG draw sequence.
    """

    prob_drop_rw: float = 0.0  # drop an individual send
    prob_drop_conn: float = 0.0  # kill the link on a send
    prob_sleep: float = 0.0  # delay a send
    max_sleep_s: float = 0.05
    prob_dup: float = 0.0  # deliver a send twice (gossip must be idempotent)
    # uniform [0, jitter_s) extra sender-side latency on EVERY send
    # (unlike prob_sleep's occasional max_sleep_s nap)
    jitter_s: float = 0.0
    # token-bucket bandwidth cap, bits/s; 0 = uncapped. The sender
    # blocks for the serialization wait — fuzzed links model sender-side
    # backpressure, chaos links (LinkChaos) model in-flight delay
    bandwidth_bps: float = 0.0
    bandwidth_burst_bytes: int = 16 * 1024
    seed: int | None = None


class FuzzedEndpoint:
    """Wrap an Endpoint with probabilistic faults (network fault
    injection for tests — reference `p2p/fuzz.go:19-47`)."""

    def __init__(self, inner: Endpoint, config: FuzzConfig) -> None:
        self._inner = inner
        self._cfg = config
        self._rng = random.Random(config.seed)
        self._bucket = _TokenBucket()

    def send(self, data: bytes, timeout: float = 10.0) -> bool:
        c = self._cfg
        if c.prob_drop_conn and self._rng.random() < c.prob_drop_conn:
            self._inner.close()
            raise EndpointClosed
        if c.prob_drop_rw and self._rng.random() < c.prob_drop_rw:
            return True  # silently dropped
        if c.prob_sleep and self._rng.random() < c.prob_sleep:
            time.sleep(self._rng.uniform(0, c.max_sleep_s))
        if c.jitter_s:
            time.sleep(self._rng.uniform(0, c.jitter_s))
        if c.bandwidth_bps:
            wait = self._bucket.wait(
                len(data), time.monotonic(), c.bandwidth_bps,
                c.bandwidth_burst_bytes,
            )
            if wait > 0:
                time.sleep(wait)
        if c.prob_dup and self._rng.random() < c.prob_dup:
            self._inner.send(data, timeout)
        return self._inner.send(data, timeout)

    def recv(self, timeout: float | None = None) -> bytes:
        return self._inner.recv(timeout)

    def close(self) -> None:
        self._inner.close()

    @property
    def closed(self) -> bool:
        return self._inner.closed


class _DeliveryWheel:
    """One process-global scheduler thread for every delayed chaos
    delivery. The old shape — one `threading.Timer` per delayed send —
    spawned a short-lived OS thread per message; at WAN delays on every
    link that is thousands of concurrent threads for a few seconds of
    simulated flight. The wheel holds (due, seq, endpoint, frame)
    entries in a heap and ONE daemon thread sleeps until the earliest
    due time, so steady-state thread count is O(1) for the whole
    process regardless of in-flight sends (regression-tested in
    tests/test_topology.py).

    Ordering: deliveries pop strictly by due time (seq breaks ties in
    submission order), so a fixed `delay_s` path preserves FIFO — like
    a real fixed-latency pipe — while `jitter_s` spreads due times and
    reorders, like a real congested path. Delivery callbacks run
    OUTSIDE the wheel lock; a closed endpoint never kills the thread.

    The wheel thread must NEVER block on a receiver: a full inbound
    queue on one link would head-of-line-block delivery for every
    other link in the process. Deliveries are attempted non-blocking;
    a congested receiver gets the frame RESCHEDULED `RETRY_S` later
    (a queue holding the frame — congestion becomes latency), and
    after `MAX_TRIES` the frame is dropped like a saturated path drops
    packets (gossip re-transmits; counted as result="congested").
    """

    RETRY_S = 0.05  # requeue delay when the receiver's queue is full
    MAX_TRIES = 100  # ~5s of sustained congestion before dropping

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._heap: list[tuple[float, int, object, bytes, int]] = []
        self._seq = 0
        self._thread: threading.Thread | None = None

    def schedule(
        self, due: float, endpoint: "ChaosEndpoint", data: bytes, tries: int = 0
    ) -> None:
        with self._cond:
            heapq.heappush(self._heap, (due, self._seq, endpoint, data, tries))
            self._seq += 1
            depth = len(self._heap)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._wheel_loop,
                    name="link-delivery-wheel",
                    daemon=True,
                )
                self._thread.start()
            self._cond.notify()
        _metrics().LINK_INFLIGHT.set(depth)

    def pending(self) -> int:
        with self._cond:
            return len(self._heap)

    def _wheel_loop(self) -> None:
        while True:
            with self._cond:
                while not self._heap:
                    self._cond.wait()
                due = self._heap[0][0]
                now = time.monotonic()
                if due > now:
                    self._cond.wait(timeout=due - now)
                    continue
                _, _, endpoint, data, tries = heapq.heappop(self._heap)
                depth = len(self._heap)
            _metrics().LINK_INFLIGHT.set(depth)
            try:
                if not endpoint._late_send(data):  # receiver congested
                    if tries < self.MAX_TRIES:
                        self.schedule(
                            time.monotonic() + self.RETRY_S, endpoint, data,
                            tries + 1,
                        )
                    else:
                        _metrics().LINK_SENDS.labels(result="congested").inc()
            except Exception as e:  # a dead link must not stop the wheel
                kv(_log, logging.WARNING, "wheel delivery failed",
                   error=type(e).__name__)


_WHEEL = _DeliveryWheel()

_METRICS = None


def _metrics():
    """Lazy metrics import: transport is a leaf module and telemetry
    pulls in the registry; bind once on first chaos delivery."""
    global _METRICS
    if _METRICS is None:
        from tendermint_tpu_torch.telemetry import metrics as m

        _METRICS = m
    return _METRICS


class LinkChaos:
    """Runtime-mutable fault knobs for ONE direction of a link.

    Unlike FuzzConfig (fixed probabilities for a connection's lifetime)
    these are flipped live by a chaos harness (`testing/nemesis.py`) or
    shaped per-link by a WAN topology (`testing/topology.py`):
    partition a running network, heal it, add delay / jitter /
    duplication / a bandwidth cap for a window, all without touching
    the peers' connection state. All-zero knobs are a byte-for-byte
    no-op (golden-tested): sends pass straight through with no RNG
    draws and nothing rides the delivery wheel.
    """

    def __init__(self, seed: int | None = None) -> None:
        self.partitioned = False  # black-hole every send (partition)
        self.delay_s = 0.0  # defer each delivery by this much (one-way)
        self.jitter_s = 0.0  # + uniform [0, jitter_s) per delivery
        self.dup_prob = 0.0  # deliver twice
        self.drop_prob = 0.0  # drop individual sends
        self.bandwidth_bps = 0.0  # token-bucket cap, bits/s; 0 = uncapped
        self.bandwidth_burst_bytes = 16 * 1024
        self._rng = random.Random(seed)
        self._bucket = _TokenBucket()

    def bandwidth_wait(self, nbytes: int, now: float) -> float:
        return self._bucket.wait(
            nbytes, now, self.bandwidth_bps, self.bandwidth_burst_bytes
        )


class ChaosEndpoint:
    """Endpoint wrapper governed by a live LinkChaos.

    Partitioned links swallow sends silently (a partition loses
    packets; it does not error — the consensus gossip layer must treat
    silence and loss identically). Delayed deliveries ride the shared
    delivery wheel (`_WHEEL`) instead of a per-send timer thread;
    bandwidth serialization waits are folded into the delivery time
    (the sender never blocks — in-flight queueing shows up as latency,
    which is what a WAN path does to a message-framed overlay).
    Composes over FuzzedEndpoint for probabilistic background faults
    plus harness-controlled chaos on one link.
    """

    def __init__(self, inner, chaos: LinkChaos) -> None:
        self._inner = inner
        self.chaos = chaos

    def send(self, data: bytes, timeout: float = 10.0) -> bool:
        c = self.chaos
        if c.partitioned:
            _metrics().LINK_SENDS.labels(result="partitioned").inc()
            return True  # black hole
        if c.drop_prob and c._rng.random() < c.drop_prob:
            _metrics().LINK_SENDS.labels(result="dropped").inc()
            return True
        copies = 2 if (c.dup_prob and c._rng.random() < c.dup_prob) else 1
        if copies == 2:
            _metrics().LINK_SENDS.labels(result="dup").inc()
        base = c.delay_s
        bw_wait = 0.0
        if c.bandwidth_bps > 0:
            # both copies of a dup consume link capacity
            bw_wait = c.bandwidth_wait(len(data) * copies, time.monotonic())
            _metrics().LINK_BANDWIDTH_WAIT.observe(bw_wait)
            base += bw_wait
        if base <= 0 and c.jitter_s <= 0:
            ok = True
            for _ in range(copies):
                ok = self._inner.send(data, timeout)
            return ok
        m = _metrics()
        now = time.monotonic()
        for _ in range(copies):
            d = base
            if c.jitter_s > 0:
                d += c._rng.uniform(0, c.jitter_s)
            m.LINK_DELIVERY_DELAY.observe(d)
            _WHEEL.schedule(now + d, self, data)
        m.LINK_SENDS.labels(result="delayed").inc(copies)
        return True

    def _late_send(self, data: bytes) -> bool:
        """Wheel-side delivery. NON-BLOCKING: returns False when the
        receiver's queue is full so the wheel can reschedule instead of
        stalling every other link; True when delivered or dropped for
        cause (partition started mid-flight, link closed)."""
        try:
            if self.chaos.partitioned:  # partition may have started
                return True
            return self._inner.send(data, timeout=0.0)
        except EndpointClosed:
            return True

    def recv(self, timeout: float | None = None) -> bytes:
        return self._inner.recv(timeout)

    def close(self) -> None:
        self._inner.close()

    @property
    def closed(self) -> bool:
        return self._inner.closed
