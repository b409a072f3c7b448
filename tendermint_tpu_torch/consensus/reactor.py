"""Consensus gossip reactor: replicate votes/proposals/parts over p2p.

Reference `consensus/reactor.go:21-25,98-125` — four prioritized
channels (State 0x20, Data 0x21, Vote 0x22, VoteSetBits 0x23), a
`PeerState` mirror of each peer's round progress (`:767-1100`), and
three gossip routines per peer: block data (`gossipDataRoutine:418`),
votes (`gossipVotesRoutine:542`), and 2/3-majority set reconciliation
(`queryMaj23Routine:652`).

The reactor is pure control plane: it moves signed artifacts; all
signature verification stays in the ConsensusState/VoteSet path (which
batches through the TPU verifier seam).

The port's copy of `tendermint_tpu/consensus/reactor.py`, on the port's
`Switch`, `Peer` and `ChannelDescriptor`; its wire forms are the JAX
reactor's, byte for byte.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.consensus.round_state import RoundStepType
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.peer import Peer
from tendermint_tpu_torch.p2p.switch import Reactor
from tendermint_tpu_torch.types import events as ev
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.heartbeat import Heartbeat
from tendermint_tpu_torch.types.part_set import Part, PartSetHeader
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE, Vote
from tendermint_tpu_torch.utils.bit_array import BitArray
from tendermint_tpu_torch.utils.log import kv as _log_kv, logger as _log
import logging as _logging

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

_MSG_NEW_ROUND_STEP = 0x01
_MSG_COMMIT_STEP = 0x02
_MSG_PROPOSAL = 0x03
_MSG_PROPOSAL_POL = 0x04
_MSG_BLOCK_PART = 0x05
_MSG_VOTE = 0x06
_MSG_HAS_VOTE = 0x07
_MSG_VOTE_SET_MAJ23 = 0x08
_MSG_VOTE_SET_BITS = 0x09
_MSG_PROPOSAL_HEARTBEAT = 0x20  # reference msgTypeProposalHeartbeat

_GOSSIP_SLEEP_S = 0.05  # reference peerGossipSleepDuration=100ms, scaled down
_MAJ23_SLEEP_S = 0.5  # reference peerQueryMaj23SleepDuration=2s, scaled


def _w_bits(w: Writer, ba: BitArray | None) -> Writer:
    if ba is None:
        return w.uvarint(0)
    return w.uvarint(ba.size).uvarint(ba.to_int())


def _r_bits(r: Reader) -> BitArray | None:
    n = r.uvarint()
    if n == 0:
        return None
    return BitArray(n, r.uvarint())


# -- wire messages ------------------------------------------------------------


@dataclass(frozen=True)
class NewRoundStepMessage:
    """Reference `NewRoundStepMessage` (`consensus/reactor.go:1163`)."""

    height: int
    round: int
    step: int
    last_commit_round: int

    def encode(self) -> bytes:
        return (
            Writer()
            .uvarint(_MSG_NEW_ROUND_STEP)
            .uvarint(self.height)
            .uvarint(self.round)
            .uvarint(self.step)
            .svarint(self.last_commit_round)
            .build()
        )


@dataclass(frozen=True)
class CommitStepMessage:
    """Peer entered commit: advertises the committed parts header + which
    parts it already has (reference `CommitStepMessage:1184`)."""

    height: int
    parts_header: PartSetHeader
    parts: BitArray | None

    def encode(self) -> bytes:
        w = Writer().uvarint(_MSG_COMMIT_STEP).uvarint(self.height)
        w.raw(self.parts_header.encode())
        return _w_bits(w, self.parts).build()


@dataclass(frozen=True)
class ProposalMessage:
    proposal: Proposal

    def encode(self) -> bytes:
        return Writer().uvarint(_MSG_PROPOSAL).bytes(self.proposal.encode()).build()


@dataclass(frozen=True)
class ProposalPOLMessage:
    """Prevote bits for the proposal's POL round (reference `:1219`)."""

    height: int
    proposal_pol_round: int
    proposal_pol: BitArray

    def encode(self) -> bytes:
        w = (
            Writer()
            .uvarint(_MSG_PROPOSAL_POL)
            .uvarint(self.height)
            .uvarint(self.proposal_pol_round)
        )
        return _w_bits(w, self.proposal_pol).build()


@dataclass(frozen=True)
class BlockPartMessage:
    height: int
    round: int
    part: Part

    def encode(self) -> bytes:
        return (
            Writer()
            .uvarint(_MSG_BLOCK_PART)
            .uvarint(self.height)
            .uvarint(self.round)
            .bytes(self.part.encode())
            .build()
        )


@dataclass(frozen=True)
class VoteMessage:
    vote: Vote

    def encode(self) -> bytes:
        return Writer().uvarint(_MSG_VOTE).bytes(self.vote.encode()).build()


@dataclass(frozen=True)
class HasVoteMessage:
    height: int
    round: int
    type: int
    index: int

    def encode(self) -> bytes:
        return (
            Writer()
            .uvarint(_MSG_HAS_VOTE)
            .uvarint(self.height)
            .uvarint(self.round)
            .uvarint(self.type)
            .uvarint(self.index)
            .build()
        )


@dataclass(frozen=True)
class VoteSetMaj23Message:
    """Claim: +2/3 for block_id at (height, round, type) (reference `:1895`)."""

    height: int
    round: int
    type: int
    block_id: BlockID

    def encode(self) -> bytes:
        return (
            Writer()
            .uvarint(_MSG_VOTE_SET_MAJ23)
            .uvarint(self.height)
            .uvarint(self.round)
            .uvarint(self.type)
            .raw(self.block_id.encode())
            .build()
        )


@dataclass(frozen=True)
class ProposalHeartbeatMessage:
    """Signed proposer liveness ping, gossiped while the chain idles in
    no-empty-blocks mode (reference `:1149` msgTypeProposalHeartbeat,
    `reactor.go:219-220,338-343`)."""

    heartbeat: Heartbeat

    def encode(self) -> bytes:
        return (
            Writer()
            .uvarint(_MSG_PROPOSAL_HEARTBEAT)
            .bytes(self.heartbeat.encode())
            .build()
        )


@dataclass(frozen=True)
class VoteSetBitsMessage:
    """Answer to a Maj23 claim: which of those votes we have (`:1922`)."""

    height: int
    round: int
    type: int
    block_id: BlockID
    votes: BitArray | None

    def encode(self) -> bytes:
        w = (
            Writer()
            .uvarint(_MSG_VOTE_SET_BITS)
            .uvarint(self.height)
            .uvarint(self.round)
            .uvarint(self.type)
            .raw(self.block_id.encode())
        )
        return _w_bits(w, self.votes).build()


def decode_message(payload: bytes):
    r = Reader(payload)
    tag = r.uvarint()
    if tag == _MSG_NEW_ROUND_STEP:
        return NewRoundStepMessage(
            height=r.uvarint(),
            round=r.uvarint(),
            step=r.uvarint(),
            last_commit_round=r.svarint(),
        )
    if tag == _MSG_COMMIT_STEP:
        height = r.uvarint()
        header = PartSetHeader.decode_from(r)
        return CommitStepMessage(height, header, _r_bits(r))
    if tag == _MSG_PROPOSAL:
        return ProposalMessage(Proposal.decode(r.bytes()))
    if tag == _MSG_PROPOSAL_POL:
        return ProposalPOLMessage(r.uvarint(), r.uvarint(), _r_bits(r))
    if tag == _MSG_BLOCK_PART:
        return BlockPartMessage(r.uvarint(), r.uvarint(), Part.decode(r.bytes()))
    if tag == _MSG_VOTE:
        return VoteMessage(Vote.decode(r.bytes()))
    if tag == _MSG_HAS_VOTE:
        return HasVoteMessage(r.uvarint(), r.uvarint(), r.uvarint(), r.uvarint())
    if tag == _MSG_VOTE_SET_MAJ23:
        return VoteSetMaj23Message(
            r.uvarint(), r.uvarint(), r.uvarint(), BlockID.decode_from(r)
        )
    if tag == _MSG_VOTE_SET_BITS:
        return VoteSetBitsMessage(
            r.uvarint(),
            r.uvarint(),
            r.uvarint(),
            BlockID.decode_from(r),
            _r_bits(r),
        )
    if tag == _MSG_PROPOSAL_HEARTBEAT:
        return ProposalHeartbeatMessage(Heartbeat.decode(r.bytes()))
    raise ValueError(f"unknown consensus message tag {tag:#x}")


# -- peer state ---------------------------------------------------------------


class PeerState:
    """Our mirror of one peer's round progress (reference
    `consensus/reactor.go:767-1100`). All mutation under one lock;
    gossip routines read consistent snapshots.
    """

    def __init__(self, peer: Peer) -> None:
        self.peer = peer
        self._lock = threading.RLock()
        self.height = 0
        self.round = 0
        self.step = RoundStepType.NEW_HEIGHT
        self.last_commit_round = -1
        # proposal progress at (height, round)
        self.proposal = False
        self.proposal_parts_header: PartSetHeader | None = None
        self.proposal_parts: BitArray | None = None
        self.proposal_pol_round = -1
        self.proposal_pol: BitArray | None = None
        # commit-step parts progress (catchup gossip target)
        self.commit_parts_header: PartSetHeader | None = None
        self.commit_parts: BitArray | None = None
        # which votes the peer has: (height, round, type) -> BitArray
        self._vote_bits: dict[tuple[int, int, int], BitArray] = {}

    # -- reads -------------------------------------------------------------

    def snapshot(self) -> "PeerState":
        with self._lock:
            s = object.__new__(PeerState)
            s.peer = self.peer
            s._lock = self._lock
            s.height = self.height
            s.round = self.round
            s.step = self.step
            s.last_commit_round = self.last_commit_round
            s.proposal = self.proposal
            s.proposal_parts_header = self.proposal_parts_header
            s.proposal_parts = (
                self.proposal_parts.copy() if self.proposal_parts else None
            )
            s.proposal_pol_round = self.proposal_pol_round
            s.proposal_pol = self.proposal_pol
            s.commit_parts_header = self.commit_parts_header
            s.commit_parts = (
                self.commit_parts.copy() if self.commit_parts else None
            )
            s._vote_bits = {k: v.copy() for k, v in self._vote_bits.items()}
            return s

    def vote_bits(self, height: int, round_: int, type_: int, n: int) -> BitArray:
        with self._lock:
            key = (height, round_, type_)
            ba = self._vote_bits.get(key)
            if ba is None or ba.size != n:
                ba = BitArray(n)
                self._vote_bits[key] = ba
            return ba

    # -- writes (from receive path + our own sends) ------------------------

    def apply_new_round_step(self, msg: NewRoundStepMessage) -> None:
        with self._lock:
            new_hr = (msg.height, msg.round) != (self.height, self.round)
            if new_hr:
                self.proposal = False
                self.proposal_parts_header = None
                self.proposal_parts = None
                self.proposal_pol_round = -1
                self.proposal_pol = None
            if msg.height != self.height:
                self.commit_parts_header = None
                self.commit_parts = None
                # prune vote bitmaps below height-1
                self._vote_bits = {
                    k: v
                    for k, v in self._vote_bits.items()
                    if k[0] >= msg.height - 1
                }
            self.height = msg.height
            self.round = msg.round
            self.step = msg.step
            self.last_commit_round = msg.last_commit_round

    def apply_commit_step(self, msg: CommitStepMessage) -> None:
        with self._lock:
            if self.height != msg.height:
                return
            self.commit_parts_header = msg.parts_header
            self.commit_parts = msg.parts or BitArray(msg.parts_header.total)

    def apply_proposal(self, msg: ProposalMessage) -> None:
        with self._lock:
            p = msg.proposal
            if (p.height, p.round) != (self.height, self.round):
                return
            if self.proposal:
                return
            self.proposal = True
            self.proposal_parts_header = p.block_parts_header
            self.proposal_parts = BitArray(p.block_parts_header.total)
            self.proposal_pol_round = p.pol_round

    def apply_proposal_pol(self, msg: ProposalPOLMessage) -> None:
        with self._lock:
            if self.height != msg.height:
                return
            if self.proposal_pol_round != msg.proposal_pol_round:
                return
            self.proposal_pol = msg.proposal_pol

    def set_has_proposal_part(self, height: int, index: int) -> None:
        with self._lock:
            if self.height == height and self.proposal_parts is not None:
                if index < self.proposal_parts.size:
                    self.proposal_parts.set(index, True)
            if (
                self.commit_parts is not None
                and self.height == height
                and index < self.commit_parts.size
            ):
                self.commit_parts.set(index, True)

    def set_has_vote(self, height: int, round_: int, type_: int, index: int, n: int) -> None:
        ba = self.vote_bits(height, round_, type_, n)
        with self._lock:
            if index < ba.size:
                ba.set(index, True)

    def clear_height_bits(self, height: int) -> None:
        """Liveness insurance: forget what we sent for `height` so the
        gossip routines retry. Any send that raced the peer's height/
        round transition is dropped at the peer but stays marked here —
        periodic clearing (the maj23 tick) bounds how long such
        poisoning can wedge a round; duplicate resends dedup at the
        receiver's VoteSet."""
        with self._lock:
            for key in [k for k in self._vote_bits if k[0] == height]:
                del self._vote_bits[key]

    def apply_vote_set_bits(self, msg: VoteSetBitsMessage, our_votes: BitArray | None) -> None:
        """Update the peer's vote bitmap from a VoteSetBits answer
        (reference `ApplyVoteSetBitsMessage`): claimed bits REPLACE our
        mirror for votes we ourselves hold (we can cross-check those by
        sending them), while previously-marked bits outside our own set
        are kept — a false claim therefore cannot permanently suppress
        gossip of votes we actually have."""
        if msg.votes is None:
            return
        ba = self.vote_bits(msg.height, msg.round, msg.type, msg.votes.size)
        with self._lock:
            if our_votes is None:
                ba.update(msg.votes)
            else:
                other = ba.sub(our_votes)
                ba.update(other.or_(msg.votes))


# -- the reactor --------------------------------------------------------------


class ConsensusReactor(Reactor):
    """Wires a ConsensusState into the Switch (reference
    `consensus/reactor.go`)."""

    PEER_STATE_KEY = "consensus_peer_state"

    def __init__(self, cs, fast_sync: bool = False) -> None:
        super().__init__()
        self.cs = cs
        self.fast_sync = fast_sync
        self._running = False
        self._threads: list[threading.Thread] = []

    # -- reactor interface -------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        # priorities per reference `GetChannels :98-125`
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=5),
            ChannelDescriptor(DATA_CHANNEL, priority=10),
            ChannelDescriptor(VOTE_CHANNEL, priority=5),
            ChannelDescriptor(VOTE_SET_BITS_CHANNEL, priority=1),
        ]

    def on_start(self) -> None:
        self._running = True
        # adversarial vote input (forged sigs, bogus validator claims)
        # surfaces inside the consensus loop, not here — route it back
        # to the switch's misbehavior scorer by peer id
        self.cs.on_peer_misbehavior = self._report_peer_misbehavior
        # gossip observatory: the consensus loop stamps redundant
        # vote/part deliveries and first-seen propagation into the
        # switch-owned rollup (same wiring seam as misbehavior above)
        self.cs.gossip = self.switch.gossip if self.switch is not None else None
        es = self.cs.event_switch
        es.add_listener("reactor", ev.EVENT_NEW_ROUND_STEP, self._on_new_round_step)
        es.add_listener("reactor", ev.EVENT_VOTE, self._on_vote_event)
        es.add_listener(
            "reactor", ev.EVENT_COMPLETE_PROPOSAL, self._on_complete_proposal
        )
        es.add_listener(
            "reactor", ev.EVENT_PROPOSAL_HEARTBEAT, self._on_proposal_heartbeat
        )
        if not self.fast_sync:
            self.cs.start()

    def on_stop(self) -> None:
        self._running = False
        self.cs.event_switch.remove_listener("reactor")
        self.cs.stop()

    def _report_peer_misbehavior(self, peer_id: str, kind: str, detail: str = "") -> None:
        if self.switch is not None and peer_id:
            self.switch.report_misbehavior(peer_id, kind, detail=detail)

    def switch_to_consensus(self, state) -> None:
        """Fast-sync caught up: adopt the synced state and start the
        consensus loop (reference `SwitchToConsensus
        consensus/reactor.go:79-96`)."""
        self.fast_sync = False
        if state.last_block_height > 0:
            self.cs.update_to_state(state)
        self.cs.start()

    def add_peer(self, peer: Peer) -> None:
        ps = PeerState(peer)
        peer.set(self.PEER_STATE_KEY, ps)
        # tell the new peer where we are
        peer.try_send(STATE_CHANNEL, self._our_step_message().encode())
        for fn, name in (
            (self._gossip_data_routine, "data"),
            (self._gossip_votes_routine, "votes"),
            (self._query_maj23_routine, "maj23"),
        ):
            # daemon threads exit via _peer_alive when the peer drops;
            # not retained (a churning peer set would leak the list)
            threading.Thread(
                target=fn, args=(peer, ps), name=f"gossip-{name}-{peer.id}", daemon=True
            ).start()

    def remove_peer(self, peer: Peer, reason) -> None:
        peer.set(self.PEER_STATE_KEY, None)  # gossip routines observe and exit

    # -- event broadcast ---------------------------------------------------

    def _our_step_message(self) -> NewRoundStepMessage:
        rs = self.cs.get_round_state()
        last_commit_round = (
            rs.last_commit.round if rs.last_commit is not None else -1
        )
        return NewRoundStepMessage(rs.height, rs.round, rs.step, last_commit_round)

    def _on_new_round_step(self, data) -> None:
        if self.switch is None:
            return
        # the event payload carries names only — take a fresh snapshot
        rs = self.cs.get_round_state()
        last_commit_round = (
            rs.last_commit.round if rs.last_commit is not None else -1
        )
        msg = NewRoundStepMessage(rs.height, rs.round, rs.step, last_commit_round)
        self.switch.broadcast(STATE_CHANNEL, msg.encode())
        if rs.step == RoundStepType.COMMIT and rs.proposal_block_parts is not None:
            commit_msg = CommitStepMessage(
                rs.height,
                rs.proposal_block_parts.header,
                rs.proposal_block_parts.parts_bit_array.copy(),
            )
            self.switch.broadcast(STATE_CHANNEL, commit_msg.encode())

    def _on_vote_event(self, data) -> None:
        """Push-path vote propagation. The reference only broadcasts
        HasVote and relies on the 100ms-poll gossip routines for the
        votes themselves; under the Python threading model the polling
        loops are latency-bound (GIL churn across ~10 threads/peer), so
        the reactor pushes every newly-added vote immediately and keeps
        the poll routines as retry/catchup backfill."""
        if self.switch is None:
            return
        vote = data.vote
        has = HasVoteMessage(vote.height, vote.round, vote.type, vote.validator_index)
        vmsg = VoteMessage(vote).encode()
        n = len(self.cs.get_round_state().validators)
        for peer in self.switch.peers():
            ps: PeerState | None = peer.get(self.PEER_STATE_KEY)
            if ps is None:
                continue
            # Only push to peers AT the vote's height. A peer at any
            # other height drops the vote on its height check (its
            # last-commit catchup only accepts votes for height-1, never
            # height+1) while we mark it delivered — permanently
            # poisoning the sent-bits so gossip never resends (observed:
            # late joiners wedged forever at the height where live
            # pushes started, and end-of-height races wedging a round).
            if ps.height != vote.height:
                continue
            theirs = ps.vote_bits(vote.height, vote.round, vote.type, n)
            if not theirs.get(vote.validator_index):
                if peer.try_send(VOTE_CHANNEL, vmsg):
                    ps.set_has_vote(
                        vote.height, vote.round, vote.type, vote.validator_index, n
                    )
            peer.try_send(STATE_CHANNEL, has.encode())

    def _on_complete_proposal(self, data) -> None:
        """Push the completed proposal + parts to peers at our height
        (same GIL-latency rationale as `_on_vote_event`; the reference's
        poll loop `gossipDataRoutine:418` remains as backfill)."""
        if self.switch is None:
            return
        rs = self.cs.get_round_state()
        for peer in self.switch.peers():
            ps: PeerState | None = peer.get(self.PEER_STATE_KEY)
            if ps is not None:
                self._push_proposal_to(peer, ps, rs)

    def _push_proposal_to(self, peer: Peer, ps: PeerState, rs) -> None:
        """Send our current proposal + the parts this peer is missing,
        if the peer is at our height."""
        if rs.proposal is None or rs.proposal_block_parts is None:
            return
        prs = ps.snapshot()
        if prs.height != rs.height:
            return
        if not prs.proposal:
            pmsg = ProposalMessage(rs.proposal)
            if peer.try_send(DATA_CHANNEL, pmsg.encode()):
                ps.apply_proposal(pmsg)
            prs = ps.snapshot()
        for i in range(rs.proposal_block_parts.total):
            if prs.proposal_parts is not None and prs.proposal_parts.get(i):
                continue
            part = rs.proposal_block_parts.get_part(i)
            if part is None:
                continue
            if peer.try_send(
                DATA_CHANNEL,
                BlockPartMessage(rs.height, rs.round, part).encode(),
            ):
                ps.set_has_proposal_part(rs.height, i)

    def _push_catchup(self, peer: Peer, ps: PeerState) -> None:
        """Event-driven gossip handoff (the cross-height pipeline's peer
        half): the moment a peer announces a height/round advance, push
        the proposal, parts, and votes it is missing at its new position
        instead of letting it rediscover them on the next 50 ms poll
        tick. The poll routines remain as retry/backfill — this is the
        same push-over-poll rationale as `_on_vote_event`, applied to
        the commit→NewHeight handoff where a peer finishing height H
        used to miss every push for H+1 that happened while it was
        still finalizing."""
        if self.fast_sync or not self._running:
            return
        # runs on the peer's RECV thread: never stall it behind a
        # drowning peer's send queue — the poll routines backfill
        if peer.send_queue_depth() > 64:
            return
        rs = self.cs.get_round_state()
        prs = ps.snapshot()
        if prs.height != rs.height:
            return
        # Only the PROPOSER pushes the block here: if every peer pushed
        # its copy to every newly-advanced peer, each height's block
        # would cross the wire once per connection (measured ~2.5x
        # loaded finality regression). Non-proposers contribute the
        # cheap part — votes — and the poll routines backfill parts.
        if self.cs.is_proposer():
            self._push_proposal_to(peer, ps, rs)
        # one missing vote per call; bits advance so the loop terminates
        n = 2 * len(rs.validators) + 2
        for _ in range(n):
            if not self._gossip_votes_same_height(peer, ps, rs, ps.snapshot()):
                break

    # -- receive -----------------------------------------------------------

    def receive(self, chan_id: int, peer: Peer, payload: bytes) -> None:
        ps: PeerState | None = peer.get(self.PEER_STATE_KEY)
        if ps is None:
            return
        msg = decode_message(payload)
        if chan_id == STATE_CHANNEL:
            self._receive_state(peer, ps, msg)
        elif chan_id == DATA_CHANNEL:
            self._receive_data(peer, ps, msg)
        elif chan_id == VOTE_CHANNEL:
            self._receive_vote(peer, ps, msg)
        elif chan_id == VOTE_SET_BITS_CHANNEL:
            self._receive_vote_set_bits(peer, ps, msg)

    def _on_proposal_heartbeat(self, hb: Heartbeat) -> None:
        """Broadcast our own heartbeats to every peer (reference
        `broadcastProposalHeartbeatMessage reactor.go:344-349`)."""
        if not self._running or self.switch is None:
            return
        self.switch.broadcast(
            STATE_CHANNEL, ProposalHeartbeatMessage(hb).encode()
        )

    def _receive_state(self, peer: Peer, ps: PeerState, msg) -> None:
        if isinstance(msg, NewRoundStepMessage):
            prev = ps.snapshot()
            ps.apply_new_round_step(msg)
            if msg.height != prev.height:
                # the peer finished a height: hand it whatever it now
                # lacks at its new one, without waiting for a gossip
                # poll tick (round/step-only changes stay with the
                # normal push+poll paths — pushing on every step
                # transition measurably congests loaded nets)
                self._push_catchup(peer, ps)
        elif isinstance(msg, CommitStepMessage):
            ps.apply_commit_step(msg)
        elif isinstance(msg, HasVoteMessage):
            n = len(self.cs.get_round_state().validators)
            ps.set_has_vote(msg.height, msg.round, msg.type, msg.index, n)
        elif isinstance(msg, ProposalHeartbeatMessage):
            # Verify and log; do NOT re-fire the local event — only a
            # node's own heartbeats are broadcast (re-firing would gossip
            # forever between peers). Reference `reactor.go:219-222`.
            hb = msg.heartbeat
            rs = self.cs.get_round_state()
            val = None
            if 0 <= hb.validator_index < len(rs.validators):
                val = rs.validators.validators[hb.validator_index]
            if val is None or val.address != hb.validator_address:
                return
            if not val.pub_key.verify(
                hb.sign_bytes(self.cs.state.chain_id), hb.signature
            ):
                return
            _log_kv(
                _log("consensus"),
                _logging.DEBUG,
                "peer proposal heartbeat",
                peer=peer.id[:12],
                height=hb.height,
                round=hb.round,
                seq=hb.sequence,
            )
        elif isinstance(msg, VoteSetMaj23Message):
            rs = self.cs.get_round_state()
            if rs.height != msg.height or rs.votes is None:
                return
            # record the claim (triggers conflict-evidence tracking)
            rs.votes.set_peer_maj23(msg.round, msg.type, peer.id, msg.block_id)
            # answer with which of those votes we have
            vs = (
                rs.votes.prevotes(msg.round)
                if msg.type == VOTE_TYPE_PREVOTE
                else rs.votes.precommits(msg.round)
            )
            our_bits = vs.bit_array_by_block_id(msg.block_id) if vs else None
            answer = VoteSetBitsMessage(
                msg.height, msg.round, msg.type, msg.block_id, our_bits
            )
            peer.try_send(VOTE_SET_BITS_CHANNEL, answer.encode())

    def _receive_data(self, peer: Peer, ps: PeerState, msg) -> None:
        if self.fast_sync:
            return  # reference ignores consensus gossip during fast-sync
        if isinstance(msg, ProposalMessage):
            ps.apply_proposal(msg)
            self.cs.set_proposal(msg.proposal, peer.id)
        elif isinstance(msg, ProposalPOLMessage):
            ps.apply_proposal_pol(msg)
        elif isinstance(msg, BlockPartMessage):
            ps.set_has_proposal_part(msg.height, msg.part.index)
            self.cs.add_proposal_block_part(msg.height, msg.round, msg.part, peer.id)

    def _receive_vote(self, peer: Peer, ps: PeerState, msg) -> None:
        if self.fast_sync or not isinstance(msg, VoteMessage):
            return
        vote = msg.vote
        n = len(self.cs.get_round_state().validators)
        ps.set_has_vote(vote.height, vote.round, vote.type, vote.validator_index, n)
        self.cs.add_vote(vote, peer.id)

    def _receive_vote_set_bits(self, peer: Peer, ps: PeerState, msg) -> None:
        if not isinstance(msg, VoteSetBitsMessage):
            return
        rs = self.cs.get_round_state()
        our_votes = None
        if rs.height == msg.height and rs.votes is not None:
            vs = (
                rs.votes.prevotes(msg.round)
                if msg.type == VOTE_TYPE_PREVOTE
                else rs.votes.precommits(msg.round)
            )
            our_votes = vs.bit_array_by_block_id(msg.block_id) if vs else None
        ps.apply_vote_set_bits(msg, our_votes)

    # -- gossip: block data ------------------------------------------------

    def _peer_alive(self, peer: Peer) -> bool:
        return self._running and peer.get(self.PEER_STATE_KEY) is not None

    def _gossip_data_routine(self, peer: Peer, ps: PeerState) -> None:
        while self._peer_alive(peer):
            rs = self.cs.get_round_state()
            prs = ps.snapshot()

            # 1. send proposal block parts the peer is missing (same h/r)
            if (
                rs.proposal_block_parts is not None
                and rs.height == prs.height
                and prs.proposal_parts is not None
                and prs.proposal_parts_header is not None
                and rs.proposal_block_parts.has_header(prs.proposal_parts_header)
            ):
                ours = rs.proposal_block_parts.parts_bit_array.copy()
                idx, ok = ours.sub(prs.proposal_parts).pick_random()
                if ok:
                    part = rs.proposal_block_parts.get_part(idx)
                    if part is not None:
                        msg = BlockPartMessage(rs.height, rs.round, part)
                        if peer.send(DATA_CHANNEL, msg.encode()):
                            ps.set_has_proposal_part(rs.height, idx)
                        continue

            # 2. peer lags: feed parts of the stored block for its height
            if prs.height > 0 and prs.height < rs.height:
                if self._gossip_catchup_part(peer, prs):
                    continue

            # 3. send the proposal itself (+ POL bits)
            if (
                rs.proposal is not None
                and rs.height == prs.height
                and rs.round == prs.round
                and not prs.proposal
            ):
                if peer.send(
                    DATA_CHANNEL, ProposalMessage(rs.proposal).encode()
                ):
                    ps.apply_proposal(ProposalMessage(rs.proposal))
                if rs.proposal.pol_round >= 0 and rs.votes is not None:
                    pol = rs.votes.prevotes(rs.proposal.pol_round)
                    if pol is not None:
                        peer.try_send(
                            DATA_CHANNEL,
                            ProposalPOLMessage(
                                rs.height, rs.proposal.pol_round, pol.bit_array()
                            ).encode(),
                        )
                continue

            time.sleep(_GOSSIP_SLEEP_S)

    def _gossip_catchup_part(self, peer: Peer, prs: "PeerState") -> bool:
        """Send one stored-block part for a lagging peer (reference
        `gossipDataForCatchup :499-540`). The peer normally advertises
        its commit parts header via CommitStepMessage; if that one-shot
        message was lost (race with the first NewRoundStep), a peer
        stuck in commit step adopts OUR stored header — the +2/3
        precommit parts header is unique per height, so it must match."""
        if prs.commit_parts_header is None or prs.commit_parts is None:
            if prs.step != RoundStepType.COMMIT:
                return False
            meta = self.cs.block_store.load_block_meta(prs.height)
            if meta is None:
                return False
            ps: PeerState | None = peer.get(self.PEER_STATE_KEY)
            if ps is None:
                return False
            ps.apply_commit_step(
                CommitStepMessage(prs.height, meta.block_id.parts_header, None)
            )
            prs = ps.snapshot()
            if prs.commit_parts_header is None or prs.commit_parts is None:
                return False
        meta = self.cs.block_store.load_block_meta(prs.height)
        if meta is None or meta.block_id.parts_header != prs.commit_parts_header:
            return False
        missing = prs.commit_parts.not_()
        idx, ok = missing.pick_random()
        if not ok:
            return False
        part = self.cs.block_store.load_block_part(prs.height, idx)
        if part is None:
            return False
        msg = BlockPartMessage(prs.height, prs.round, part)
        if peer.send(DATA_CHANNEL, msg.encode()):
            ps: PeerState | None = peer.get(self.PEER_STATE_KEY)
            if ps is not None:
                ps.set_has_proposal_part(prs.height, idx)
        return True

    # -- gossip: votes -----------------------------------------------------

    def _gossip_votes_routine(self, peer: Peer, ps: PeerState) -> None:
        while self._peer_alive(peer):
            rs = self.cs.get_round_state()
            prs = ps.snapshot()

            sent = False
            if rs.height == prs.height:
                sent = self._gossip_votes_same_height(peer, ps, rs, prs)
            elif rs.height == prs.height + 1 and rs.last_commit is not None:
                # peer is finishing our previous height: its precommits
                # are our last_commit
                sent = self._send_vote_from_set(
                    peer, ps, rs.last_commit, prs.height, rs.last_commit.round,
                    VOTE_TYPE_PRECOMMIT,
                )
            elif rs.height > prs.height + 1 or (
                rs.height == prs.height + 1 and rs.last_commit is None
            ):
                sent = self._gossip_catchup_commit_vote(peer, ps, prs)
            if not sent:
                time.sleep(_GOSSIP_SLEEP_S)

    def _gossip_votes_same_height(self, peer, ps, rs, prs) -> bool:
        if rs.votes is None:
            return False
        # order per reference gossipVotesForHeight :607-652
        if prs.step == RoundStepType.NEW_HEIGHT and rs.last_commit is not None:
            if self._send_vote_from_set(
                peer, ps, rs.last_commit, rs.height - 1, rs.last_commit.round,
                VOTE_TYPE_PRECOMMIT,
            ):
                return True
        if (
            prs.step <= RoundStepType.PROPOSE
            and prs.proposal_pol_round >= 0
        ):
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and self._send_vote_from_set(
                peer, ps, pol, rs.height, prs.proposal_pol_round, VOTE_TYPE_PREVOTE
            ):
                return True
        if prs.step <= RoundStepType.PREVOTE_WAIT and prs.round <= rs.round:
            pv = rs.votes.prevotes(prs.round)
            if pv is not None and self._send_vote_from_set(
                peer, ps, pv, rs.height, prs.round, VOTE_TYPE_PREVOTE
            ):
                return True
        if prs.step <= RoundStepType.PRECOMMIT_WAIT and prs.round <= rs.round:
            pc = rs.votes.precommits(prs.round)
            if pc is not None and self._send_vote_from_set(
                peer, ps, pc, rs.height, prs.round, VOTE_TYPE_PRECOMMIT
            ):
                return True
        # catchup: peer in an older round
        if prs.round >= 0 and prs.round < rs.round:
            pv = rs.votes.prevotes(prs.round)
            if pv is not None and self._send_vote_from_set(
                peer, ps, pv, rs.height, prs.round, VOTE_TYPE_PREVOTE
            ):
                return True
            pc = rs.votes.precommits(prs.round)
            if pc is not None and self._send_vote_from_set(
                peer, ps, pc, rs.height, prs.round, VOTE_TYPE_PRECOMMIT
            ):
                return True
        return False

    def _send_vote_from_set(self, peer, ps, vote_set, height, round_, type_) -> bool:
        n = len(vote_set.val_set) if hasattr(vote_set, "val_set") else vote_set.bit_array().size
        theirs = ps.vote_bits(height, round_, type_, n)
        with ps._lock:
            missing = vote_set.bit_array().sub(theirs)
        idx, ok = missing.pick_random()
        if not ok:
            return False
        vote = vote_set.get_by_index(idx)
        if vote is None:
            return False
        if peer.send(VOTE_CHANNEL, VoteMessage(vote).encode()):
            ps.set_has_vote(height, round_, type_, idx, n)
            return True
        return False

    def _gossip_catchup_commit_vote(self, peer, ps, prs) -> bool:
        """Peer is ≥2 heights behind: replay precommits from the stored
        seen-commit for its height (reference `:577-595`)."""
        if prs.height == 0:
            return False
        commit = self.cs.block_store.load_seen_commit(prs.height)
        if commit is None:
            commit = self.cs.block_store.load_block_commit(prs.height)
        if commit is None:
            return False
        n = len(commit.precommits)
        theirs = ps.vote_bits(prs.height, commit.round(), VOTE_TYPE_PRECOMMIT, n)
        have = BitArray(n)
        for i, pc in enumerate(commit.precommits):
            if pc is not None:
                have.set(i, True)
        with ps._lock:
            missing = have.sub(theirs)
        idx, ok = missing.pick_random()
        if not ok:
            return False
        vote = commit.precommits[idx]
        if peer.send(VOTE_CHANNEL, VoteMessage(vote).encode()):
            ps.set_has_vote(prs.height, commit.round(), VOTE_TYPE_PRECOMMIT, idx, n)
            return True
        return False

    # -- gossip: maj23 queries --------------------------------------------

    def _query_maj23_routine(self, peer: Peer, ps: PeerState) -> None:
        """Periodically tell peers which vote sets we see majorities in so
        they can send us exactly the votes we miss (reference `:652-739`)."""
        last_hrs = None
        while self._peer_alive(peer):
            time.sleep(_MAJ23_SLEEP_S)
            rs = self.cs.get_round_state()
            prs = ps.snapshot()
            # Clear the sent-vote mirror ONLY when the peer has made no
            # height/round/step progress for a full tick — a send that
            # raced its transition may have been dropped, so retrying is
            # the liveness insurance. Clearing unconditionally (as the
            # old code did) re-sent every vote of the height to every
            # peer twice a second in steady state.
            cur = (prs.height, prs.round, prs.step)
            if cur == last_hrs:
                ps.clear_height_bits(prs.height)
            last_hrs = cur
            # Re-announce our own step every tick: a NewRoundStep lost
            # on a lossy link (or swallowed by a partition) leaves the
            # peer's mirror of US stale, which disables every gossip
            # path toward us — we cannot detect that from our side, so
            # the retry must be unconditional. 20 idempotent bytes per
            # 0.5 s per peer buys partition-heal and late-join liveness.
            peer.try_send(STATE_CHANNEL, self._our_step_message().encode())
            if rs.votes is None or rs.height != prs.height:
                continue
            for round_ in (rs.round, prs.round, prs.proposal_pol_round):
                if round_ is None or round_ < 0:
                    continue
                for type_, vs in (
                    (VOTE_TYPE_PREVOTE, rs.votes.prevotes(round_)),
                    (VOTE_TYPE_PRECOMMIT, rs.votes.precommits(round_)),
                ):
                    if vs is None:
                        continue
                    maj = vs.two_thirds_majority()
                    if maj is None:
                        continue
                    peer.try_send(
                        STATE_CHANNEL,
                        VoteSetMaj23Message(rs.height, round_, type_, maj).encode(),
                    )
