"""Evidence gossip reactor (reference `evidence/reactor.go`, channel 0x38).

Push-plus-retry gossip in the repo's house style (the consensus
reactor's `_on_vote_event` rationale): every newly admitted piece of
evidence is pushed to all peers immediately, a new peer gets the whole
pending set on connect, and a slow background tick re-offers pending
evidence — the clist-walk of the reference collapsed onto the pool's
ordered pending set, with the pool's dedup making every re-offer
idempotent. Gossip loops are impossible by construction: a node only
re-broadcasts evidence that NEWLY entered its pool.

Invalid evidence from a peer is an attack (forged proofs cost us a
2-lane verify each): the peer is reported to the switch's misbehavior
scorer and dropped.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.peer import Peer
from tendermint_tpu_torch.p2p.switch import Reactor
from tendermint_tpu_torch.types.errors import ErrEvidenceUnprovable, ValidationError
from tendermint_tpu_torch.types.evidence import decode_evidence

EVIDENCE_CHANNEL = 0x38

_MSG_EVIDENCE_LIST = 0x01

_REBROADCAST_INTERVAL_S = 0.5
# evidence per gossip frame; a list message stays well under frame caps
_GOSSIP_BATCH = 32


def encode_evidence_list(evidence: list) -> bytes:
    w = Writer().uvarint(_MSG_EVIDENCE_LIST).uvarint(len(evidence))
    for ev in evidence:
        w.bytes(ev.encode())
    return w.build()


def decode_evidence_list(payload: bytes) -> list:
    r = Reader(payload)
    if r.uvarint() != _MSG_EVIDENCE_LIST:
        raise ValueError("unknown evidence message")
    n = r.uvarint()
    if n > 4 * _GOSSIP_BATCH:
        raise ValueError(f"evidence list too long ({n})")
    out = [decode_evidence(r.bytes()) for _ in range(n)]
    r.expect_done()
    return out


class EvidenceReactor(Reactor):
    def __init__(self, pool) -> None:
        super().__init__()
        self.pool = pool
        pool.on_evidence_added = self._on_evidence_added
        self._running = False
        self._stop = threading.Event()

    # -- reactor interface ---------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(EVIDENCE_CHANNEL, priority=3)]

    def on_start(self) -> None:
        self._running = True
        self._stop.clear()
        threading.Thread(
            target=self._rebroadcast_routine, name="evidence-gossip", daemon=True
        ).start()

    def on_stop(self) -> None:
        self._running = False
        self._stop.set()

    def add_peer(self, peer: Peer) -> None:
        self._send_pending(peer)

    def receive(self, chan_id: int, peer: Peer, payload: bytes) -> None:
        evidence = decode_evidence_list(payload)
        for ev in evidence:
            try:
                added = self.pool.add_evidence(ev)
                if not added and self.switch is not None:
                    # pool dedup (already pending or already committed):
                    # the rebroadcast routine re-offers pending batches
                    # by design, so re-arrivals are common — the gossip
                    # observatory counts what that retry policy costs
                    self.switch.gossip.redundant("evidence", len(ev.encode()))
            except ErrEvidenceUnprovable:
                # offender outside every retained valset (rotation /
                # max-age horizon): unverifiable here, NOT the relaying
                # peer's crime — drop without a debit
                continue
            except ValidationError as e:
                # a forged proof is adversarial input, not noise
                if self.switch is not None:
                    self.switch.report_misbehavior(
                        peer, "bad_evidence", detail=str(e)
                    )
                return

    # -- gossip --------------------------------------------------------------

    def _on_evidence_added(self, ev) -> None:
        if self.switch is None:
            return
        self.switch.broadcast(EVIDENCE_CHANNEL, encode_evidence_list([ev]))

    def _send_pending(self, peer: Peer) -> None:
        pending = self.pool.pending_evidence(_GOSSIP_BATCH)
        if pending:
            peer.try_send(EVIDENCE_CHANNEL, encode_evidence_list(pending))

    def _rebroadcast_routine(self) -> None:
        """Retry/catchup backfill: a push dropped on a full queue or a
        partition must not strand evidence forever."""
        while self._running and not self._stop.wait(_REBROADCAST_INTERVAL_S):
            if self.switch is None:
                continue
            pending = self.pool.pending_evidence(_GOSSIP_BATCH)
            if not pending:
                continue
            msg = encode_evidence_list(pending)
            for peer in self.switch.peers():
                peer.try_send(EVIDENCE_CHANNEL, msg)
