"""Mempool gossip reactor: stream valid txs to peers (reference
`mempool/reactor.go:20,27,74,114-152`, channel 0x30).

One broadcast thread per peer walks the mempool's append-order list via
the `get_after(index, wait=True)` seam (the reference blocks on
`clist.NextWait`); received txs feed `check_tx` (dup-cache +
app-validated before joining the pool).
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.peer import Peer
from tendermint_tpu_torch.p2p.switch import Reactor

MEMPOOL_CHANNEL = 0x30

_MSG_TX = 0x01


def encode_tx_message(tx: bytes) -> bytes:
    return Writer().uvarint(_MSG_TX).bytes(tx).build()


def decode_tx_message(payload: bytes) -> bytes:
    r = Reader(payload)
    if r.uvarint() != _MSG_TX:
        raise ValueError("unknown mempool message")
    return r.bytes()


class MempoolReactor(Reactor):
    PEER_KEY = "mempool_peer_alive"

    def __init__(self, mempool, broadcast: bool = True) -> None:
        super().__init__()
        self.mempool = mempool
        self.broadcast = broadcast
        self._running = False

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(MEMPOOL_CHANNEL, priority=1)]

    def on_start(self) -> None:
        self._running = True

    def on_stop(self) -> None:
        self._running = False

    def add_peer(self, peer: Peer) -> None:
        if not self.broadcast:
            return
        peer.set(self.PEER_KEY, True)
        threading.Thread(
            target=self._broadcast_routine,
            args=(peer,),
            name=f"mempool-bcast-{peer.id}",
            daemon=True,
        ).start()

    def remove_peer(self, peer: Peer, reason) -> None:
        peer.set(self.PEER_KEY, None)

    def receive(self, chan_id: int, peer: Peer, payload: bytes) -> None:
        tx = decode_tx_message(payload)
        # bad txs answer with a code; gossip just drops them (reference
        # `Receive :74-86` ignores CheckTx results from peers). The
        # non-blocking submit keeps the recv thread off the verify
        # window: the tx joins the next ingress batch and this thread
        # goes back to draining frames (the sender's trace context is
        # ambient here and captured at submit).
        #
        # Adversarial-input hook: a FORGED envelope signature from a
        # gossiping peer is an attack on the verify spine (each one buys
        # a device lane) — debit the sender's misbehavior score at the
        # window join so a garbage-sig flooder gets banned while honest
        # traffic keeps flowing. App rejections stay unpenalized.
        cb = None
        if self.switch is not None:
            from tendermint_tpu_torch.abci.types import CodeType

            switch, peer_id, nbytes = self.switch, peer.id, len(payload)

            def cb(res, _switch=switch, _peer_id=peer_id, _nbytes=nbytes):
                if res.code == CodeType.UNAUTHORIZED:
                    _switch.report_misbehavior(_peer_id, "bad_sig", detail="gossiped tx")
                elif res.code == CodeType.TX_IN_CACHE:
                    # gossip observatory: a dup-cache hit on re-arrival
                    # means a peer shipped a tx we already hold — the
                    # redundancy counter makes that wasted wire traffic
                    # visible (local RPC re-submits never reach here)
                    _switch.gossip.redundant("tx", _nbytes)

        submit = getattr(self.mempool, "check_tx_async", None)
        (submit or self.mempool.check_tx)(tx, cb)

    def _broadcast_routine(self, peer: Peer) -> None:
        """Reference `broadcastTxRoutine :114-152`. The cursor is the
        mempool's intake counter (commit-time compaction renumbers list
        positions but never counters). A traced tx's admission context
        rides the frame, so the receiving node's CheckTx joins the same
        trace."""
        cursor = 0
        trace_for = getattr(self.mempool, "trace_for", None)
        while self._running and peer.get(self.PEER_KEY):
            for counter, tx in self.mempool.get_after(
                cursor, wait=True, timeout=0.2
            ):
                ctx = trace_for(tx) if trace_for is not None else None
                peer.send(MEMPOOL_CHANNEL, encode_tx_message(tx), ctx=ctx)
                cursor = max(cursor, counter)
