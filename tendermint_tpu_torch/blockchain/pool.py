"""BlockPool: parallel block download with peer accounting.

Reference `blockchain/pool.go:49-64` — up to `max_pending` outstanding
height requests spread over peers, per-request timeouts with
reassignment, sorted assembly. The reference runs one goroutine per
in-flight height; here a single scheduler tick (driven by the reactor's
sync loop) computes which requests to (re)send — same behavior, no
thread-per-height.

The pool is pure bookkeeping: the reactor supplies a `send_request`
callback and feeds `add_block`; verification/apply happens in the
reactor's sync loop (batched through the device verifier — the whole point
of fast-sync, BASELINE config 3).

The port's copy of `tendermint_tpu/blockchain/pool.py`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from tendermint_tpu_torch.utils.flowrate import Monitor

REQUEST_TIMEOUT_S = 15.0  # reference peerTimeout (pool.go:33)
MAX_PENDING_PER_PEER = 50  # reference maxPendingRequestsPerPeer (pool.go:31)
MAX_PENDING = 1000  # reference maxTotalRequesters (pool.go:29-30)
MIN_RECV_RATE = 10240  # bytes/s floor before eviction (pool.go:33)
# how long a peer may hold pending requests before the rate floor
# applies (stands in for the reference's e*minRecvRate REMA seeding,
# which keeps fresh peers above the floor for the first seconds)
MIN_RECV_GRACE_S = 4.0


@dataclass
class _Request:
    peer_id: str
    sent_at: float


class _PeerRec:
    __slots__ = ("height", "monitor")

    def __init__(self, height: int, time_fn) -> None:
        self.height = height
        self.monitor = Monitor(window_s=1.0, time_fn=time_fn)


class BlockPool:
    def __init__(
        self,
        start_height: int,
        max_pending: int = MAX_PENDING,
        time_fn=time.monotonic,
    ) -> None:
        # next height we still need to hand to the executor
        self.height = start_height
        self._lock = threading.RLock()
        self._blocks: dict[int, tuple[object, str]] = {}  # height -> (block, peer)
        self._requests: dict[int, _Request] = {}
        self._peers: dict[str, _PeerRec] = {}  # peer_id -> record
        self._max_pending = max_pending
        self._time_fn = time_fn

    # -- peers ---------------------------------------------------------------

    def set_peer_height(self, peer_id: str, height: int) -> None:
        with self._lock:
            rec = self._peers.get(peer_id)
            if rec is None:
                self._peers[peer_id] = _PeerRec(height, self._time_fn)
            else:
                rec.height = height

    def remove_peer(self, peer_id: str) -> None:
        """Forget the peer; its in-flight requests become reassignable."""
        with self._lock:
            self._peers.pop(peer_id, None)
            for h in [h for h, r in self._requests.items() if r.peer_id == peer_id]:
                del self._requests[h]

    def max_peer_height(self) -> int:
        with self._lock:
            return max((r.height for r in self._peers.values()), default=0)

    def num_peers(self) -> int:
        with self._lock:
            return len(self._peers)

    # -- scheduling ------------------------------------------------------------

    def schedule_requests(
        self, now: float | None = None
    ) -> tuple[list[tuple[str, int]], list[str]]:
        """One scheduler tick -> (requests to send, peers to evict).

        A request that exceeds REQUEST_TIMEOUT_S evicts its peer — the
        reference's `bpRequester` timeout drops the peer outright
        (`pool.go:115ff`), which is also the byzantine defense: a peer
        advertising a height it never serves would otherwise pin
        `max_peer_height` above reach and keep fast-sync from ever
        completing. A peer that DOES respond but below MIN_RECV_RATE
        (10 kB/s, `pool.go:33,121-126`) is evicted too once its oldest
        pending request is older than MIN_RECV_GRACE_S — a slow-drip
        peer must not throttle the whole sync to its trickle. Freed
        heights reschedule to the remaining peers in the same tick
        (reference `makeRequestersRoutine`)."""
        now = now if now is not None else self._time_fn()
        out: list[tuple[str, int]] = []
        evict: list[str] = []
        with self._lock:
            if not self._peers:
                return [], []
            oldest: dict[str, float] = {}
            for h, req in list(self._requests.items()):
                if now - req.sent_at > REQUEST_TIMEOUT_S:
                    if req.peer_id in self._peers and req.peer_id not in evict:
                        evict.append(req.peer_id)
                cur = oldest.get(req.peer_id)
                if cur is None or req.sent_at < cur:
                    oldest[req.peer_id] = req.sent_at
            for peer_id, sent_at in oldest.items():
                if peer_id in evict or peer_id not in self._peers:
                    continue
                if now - sent_at <= MIN_RECV_GRACE_S:
                    continue
                rate = self._peers[peer_id].monitor.rate
                # rate == 0 means no response COMPLETED yet — a large
                # first block may still be in flight, so only the hard
                # 15 s timeout may evict then (the reference makes the
                # same zero-rate exception, pool.go:122-123)
                if rate != 0 and rate < MIN_RECV_RATE:
                    evict.append(peer_id)
            for peer_id in evict:
                self._peers.pop(peer_id, None)
                for h in [
                    h for h, r in self._requests.items() if r.peer_id == peer_id
                ]:
                    del self._requests[h]
            # new + freed requests
            h = self.height
            target = self.max_peer_height()
            while len(self._requests) < self._max_pending and h <= target:
                if h not in self._blocks and h not in self._requests:
                    peer = self._pick_peer(h)
                    if peer is None:
                        break
                    self._requests[h] = _Request(peer, now)
                    out.append((peer, h))
                h += 1
        return out, evict

    def _pick_peer(self, height: int, exclude: str | None = None) -> str | None:
        """Least-loaded peer that advertises the height."""
        loads: dict[str, int] = {p: 0 for p in self._peers}
        for req in self._requests.values():
            if req.peer_id in loads:
                loads[req.peer_id] += 1
        best, best_load = None, None
        for p, rec in self._peers.items():
            if p == exclude or rec.height < height:
                continue
            if loads[p] >= MAX_PENDING_PER_PEER:
                continue
            if best_load is None or loads[p] < best_load:
                best, best_load = p, loads[p]
        return best

    # -- data ------------------------------------------------------------------

    def add_block(self, peer_id: str, block, size: int = 0) -> bool:
        """Accept a response only for a height we requested from that
        peer (reference `AddBlock pool.go:203-224`); `size` (the wire
        payload bytes) feeds the peer's recv-rate monitor."""
        height = block.header.height
        with self._lock:
            req = self._requests.get(height)
            if req is None or req.peer_id != peer_id:
                return False
            del self._requests[height]
            self._blocks[height] = (block, peer_id)
            rec = self._peers.get(peer_id)
            if rec is not None and size > 0:
                rec.monitor.update(size)
        return True

    def peek(self, n: int, from_height: int | None = None) -> list:
        """Up to n CONSECUTIVE blocks starting at `from_height`
        (default self.height). The offset form lets the fast-sync
        pipeline prep window K+1 while window K's blocks — still below
        self.height+... — wait un-popped for their in-flight verdict."""
        start = self.height if from_height is None else from_height
        with self._lock:
            out = []
            for h in range(start, start + n):
                if h not in self._blocks:
                    break
                out.append(self._blocks[h][0])
            return out

    def pop(self) -> None:
        """Advance past self.height (block was applied)."""
        with self._lock:
            self._blocks.pop(self.height, None)
            self._requests.pop(self.height, None)
            self.height += 1

    def redo(self, height: int) -> str | None:
        """A block failed verification: drop it (and everything after —
        they chain off it) and return the peer that sent it so the
        switch can drop the peer (reference `RedoRequest`)."""
        with self._lock:
            bad_peer = None
            if height in self._blocks:
                bad_peer = self._blocks[height][1]
            for h in list(self._blocks):
                if h >= height:
                    del self._blocks[h]
            for h in list(self._requests):
                if h >= height:
                    del self._requests[h]
            return bad_peer

    def is_caught_up(self) -> bool:
        """Within one block of every peer's tip (with at least one peer
        heard from — reference `IsCaughtUp pool.go:170-185`). The TIP
        block itself cannot fast-sync: its commit travels in its
        successor's LastCommit, so consensus takes over for it."""
        with self._lock:
            if not self._peers:
                return False
            return self.height >= self.max_peer_height()
