"""PEX reactor: peer-exchange discovery on channel 0x00.

Reference `p2p/pex_reactor.go` — new peers land in the address book,
address requests are answered with a random selection, and an
ensure-peers loop dials book addresses until the switch reaches its
target peer count.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.p2p.addrbook import AddrBook, NetAddress
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.peer import Peer
from tendermint_tpu_torch.p2p.switch import Reactor

PEX_CHANNEL = 0x00

_MSG_REQUEST = 0x01
_MSG_ADDRS = 0x02

_MAX_ADDRS_PER_MSG = 32


def encode_request() -> bytes:
    return Writer().uvarint(_MSG_REQUEST).build()


def encode_addrs(addrs: list[NetAddress]) -> bytes:
    w = Writer().uvarint(_MSG_ADDRS).uvarint(len(addrs))
    for a in addrs:
        w.string(a.node_id).string(a.addr)
    return w.build()


def decode_message(payload: bytes):
    r = Reader(payload)
    tag = r.uvarint()
    if tag == _MSG_REQUEST:
        return ("request", None)
    if tag == _MSG_ADDRS:
        n = min(r.uvarint(), _MAX_ADDRS_PER_MSG)
        return ("addrs", [NetAddress(r.string(), r.string()) for _ in range(n)])
    raise ValueError(f"unknown pex message {tag:#x}")


class PEXReactor(Reactor):
    def __init__(
        self,
        book: AddrBook,
        dial_fn=None,
        max_peers: int = 10,
        node_key=None,
        ensure_interval_s: float = 30.0,
    ) -> None:
        super().__init__()
        self.book = book
        self.max_peers = max_peers
        self.node_key = node_key
        self.ensure_interval_s = ensure_interval_s
        self._dial_fn = dial_fn
        self._running = False
        # peer_id -> monotonic time of our last addr request to it.
        # Requests are re-issuable (rate-limited): a one-shot request can
        # race the remote book's own fills — e.g. our request reaches B
        # before B registered a third node — and discovery would deadlock
        # with both sides waiting for gossip that never re-fires.
        self._requested: dict[str, float] = {}
        # wakes the ensure loop the moment new addresses arrive, so
        # discovery latency is bounded by gossip, not the poll interval
        # (also what makes multi-node PEX tests deterministic instead of
        # racing wall-clock ticks)
        self._wake = threading.Event()

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(PEX_CHANNEL, priority=1)]

    def on_start(self) -> None:
        self._running = True
        threading.Thread(
            target=self._ensure_peers_routine, name="pex-ensure", daemon=True
        ).start()

    def on_stop(self) -> None:
        self._running = False
        self._wake.set()  # unblock the ensure loop so it exits promptly
        self.book.flush()

    def add_peer(self, peer: Peer) -> None:
        # a connected peer's own listen address is book-worthy, but a
        # SELF-CLAIMED inbound address stays in a NEW bucket until WE
        # successfully dial it — promoting unproven addresses to OLD
        # would let NAT'd/malicious peers poison the proven set
        if peer.node_info.listen_addr:
            self.book.add_address(
                NetAddress(peer.id, peer.node_info.listen_addr), src_id=peer.id
            )
            if peer.outbound:
                self.book.mark_good(peer.id)
        # ask it for more addresses
        self._request_addrs(peer)

    def _request_addrs(self, peer: Peer) -> None:
        import time as _time

        now = _time.monotonic()
        if now - self._requested.get(peer.id, -1e9) < self.REREQUEST_MIN_S:
            return
        self._requested[peer.id] = now
        peer.try_send(PEX_CHANNEL, encode_request())

    def remove_peer(self, peer: Peer, reason) -> None:
        self._requested.pop(peer.id, None)
        self._wake.set()  # top back up promptly after a peer drops

    def receive(self, chan_id: int, peer: Peer, payload: bytes) -> None:
        kind, arg = decode_message(payload)
        if kind == "request":
            peer.try_send(
                PEX_CHANNEL, encode_addrs(self.book.sample(_MAX_ADDRS_PER_MSG))
            )
        elif kind == "addrs":
            me = self.switch.node_info.node_id if self.switch else ""
            added = False
            for addr in arg:
                if addr.node_id != me:
                    added |= self.book.add_address(addr, src_id=peer.id)
            if added:
                # only GENUINELY new book entries wake the loop —
                # already-known gossip must not trigger re-dial passes
                self._wake.set()

    # -- ensure-peers loop -------------------------------------------------

    def _dial(self, addr: NetAddress):
        if self._dial_fn is not None:
            return self._dial_fn(addr)
        from tendermint_tpu_torch.p2p.tcp import dial

        return dial(self.switch, addr.addr, priv_key=self.node_key)

    # wake-driven passes may not repeat faster than this — failed dials
    # return in milliseconds, so without a floor a book full of dead
    # addresses would be hammered in a tight burst
    MIN_PASS_SPACING_S = 1.0

    def _ensure_peers_routine(self) -> None:
        """Reference `ensurePeersRoutine`: top up outbound connections
        from the book while below target. Event-driven: fresh gossip
        wakes the loop instead of waiting out the poll interval, with a
        minimum spacing between passes as dial-storm backoff."""
        import time as _time

        last_pass = 0.0
        while self._running:
            self._wake.wait(timeout=self.ensure_interval_s)
            self._wake.clear()
            if not self._running:
                return
            spacing = min(self.MIN_PASS_SPACING_S, self.ensure_interval_s)
            since = _time.monotonic() - last_pass
            if since < spacing:
                _time.sleep(spacing - since)
                if not self._running:
                    return
            self.ensure_peers()
            last_pass = _time.monotonic()

    # dial attempts per top-up pass: bounds how long one pass can block
    # on unreachable addresses (each TCP connect can take its full
    # timeout) so stop() and fresh-gossip wakeups aren't starved
    MAX_DIALS_PER_PASS = 10

    # minimum spacing between addr requests to the SAME peer — re-asking
    # lets a pass recover from request/registration races without
    # becoming request spam (reference ensurePeers asks a random peer
    # whenever the book can't cover the deficit)
    REREQUEST_MIN_S = 1.0

    def ensure_peers(self) -> None:
        """One top-up pass: dial distinct book addresses until the peer
        target is met, candidates run out, or the per-pass dial budget
        is spent (the reference dials the whole deficit per tick,
        `pex_reactor.go` ensurePeers)."""
        if self.switch is None:
            return
        have = {p.id for p in self.switch.peers()}
        tried: set[str] = set()
        while self._running and len(have) < self.max_peers:
            if len(tried) >= self.MAX_DIALS_PER_PASS:
                # deficit continues next pass (interval tick or the next
                # genuine wake) — self-waking here would defeat the
                # dial-storm backoff
                return
            addr = self.book.pick_address(exclude=have | tried)
            if addr is None:
                # book can't cover the deficit: re-ask a connected peer
                # for addresses (rate-limited per peer) — the reference's
                # ensurePeers does the same when short of candidates
                peers = self.switch.peers()
                if peers:
                    import random as _random

                    self._request_addrs(_random.choice(peers))
                return
            tried.add(addr.node_id)
            self.book.mark_attempt(addr.node_id)
            try:
                peer = self._dial(addr)
            # tmlint: disable=T001 -- dial failures are normal churn: mark_attempt already recorded it and the book evicts flaky addresses
            except Exception:
                continue
            if peer is None:
                continue  # dial_fn signalled failure: stays unproven
            # promote ONLY if the authenticated identity matches the book
            # entry — otherwise gossip pointed this node_id at someone
            # else's address (eclipse attempt): purge it
            if peer.id != addr.node_id:
                self.book.remove(addr.node_id)
                if self.switch is not None:
                    self.switch.stop_peer_for_error(peer, "pex id mismatch")
                continue
            self.book.mark_good(addr.node_id)
            have.add(addr.node_id)
