"""Byzantine adversaries: the "B" in BFT, made executable.

Every chaos primitive in `testing/nemesis.py` is *benign-faulty* —
crashes, partitions, torn WALs, dying devices. These adversaries are
actively MALICIOUS participants, plugged into the same `Nemesis`
harness, each modeling one attack class from the threat model
(docs/BYZANTINE.md):

* `Equivocator` — a validator that double-signs: for every vote its
  honest consensus loop casts, a conflicting vote (same height/round/
  type, different block) is signed with the raw key — bypassing the
  PrivValidator double-sign guard through the Signer seam, exactly what
  a compromised signer would do — and broadcast to all peers. Honest
  nodes must detect the pair (`ErrVoteConflictingVotes`), pool
  `DuplicateVoteEvidence`, gossip it on channel 0x38, and COMMIT it
  within a few heights: `wait_evidence_committed` is the invariant.
* `ConflictingProposer` — signs a second, different proposal for the
  same (height, round) and feeds it to a subset of peers. Splits the
  first-proposal race; safety (no fork) and liveness (rounds recover)
  must hold.
* `GarbageSigFlooder` — a non-validator peer hammering the victim's
  verify spine with forged-signature votes and forged signed-tx
  envelopes. The victim must score-ban the peer, and — the audit this
  PR exists for — the adversarial False verdicts must NEVER trip the
  CircuitBreaker into host crypto (a flood must not DoS the TPU fast
  path for everyone else).
* `LyingFastSyncPeer` — advertises a far-ahead height and serves forged
  blocks on the blockchain channel. The fast-syncing victim must reject
  the chain (commit verification), ban the liar, and keep syncing from
  honest peers.
* `FrameFuzzer` — speaks raw bytes on the wire: golden frames mutated
  by bit flips, length-field lies, truncation, and trailing garbage.
  Only the fuzzing peer may be disconnected; reader threads and nodes
  must survive arbitrary input.

All adversaries are deterministic given their seed (mutations use a seeded
RNG; timing comes from the harness).
"""

from __future__ import annotations

import random
import threading
import time

from tendermint_tpu_torch.consensus.reactor import (
    DATA_CHANNEL,
    STATE_CHANNEL,
    VOTE_CHANNEL,
    VOTE_SET_BITS_CHANNEL,
    ProposalMessage,
    VoteMessage,
)
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor, build_frame
from tendermint_tpu_torch.p2p.peer import NodeInfo
from tendermint_tpu_torch.p2p.switch import Reactor, Switch, connect_switches
from tendermint_tpu_torch.testing.nemesis import InvariantViolation, Nemesis
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import (
    VOTE_TYPE_PRECOMMIT,
    VOTE_TYPE_PREVOTE,
    Vote,
)
from tendermint_tpu_torch.utils.log import kv, logger
import logging

_log = logger("byzantine")

# a fabricated "other block" for conflicting votes: any hash different
# from whatever the honest vote carried
_FAKE_HASH = b"\xbe\xef" * 16


class _SinkReactor(Reactor):
    """Claims channels so an attacker switch can SEND on them; inbound
    frames are dropped (adversaries don't follow protocols)."""

    def __init__(self, channels: list[int]) -> None:
        super().__init__()
        self._descs = [ChannelDescriptor(c, priority=1) for c in channels]
        self.received: list[tuple[int, bytes]] = []
        self.on_receive = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return self._descs

    def receive(self, chan_id: int, peer, payload: bytes) -> None:
        cb = self.on_receive
        if cb is not None:
            cb(chan_id, peer, payload)


def make_attacker_switch(
    chain_id: str, channels: list[int], name: str = "attacker"
) -> tuple[Switch, _SinkReactor]:
    """A bare switch an adversary drives by hand (no consensus state)."""
    sw = Switch(
        NodeInfo(node_id=f"{name}-{random.randrange(1 << 48):012x}",
                 moniker=name, chain_id=chain_id)
    )
    sink = _SinkReactor(channels)
    sw.add_reactor("sink", sink)
    sw.start()
    return sw, sink


# -- evidence invariants ------------------------------------------------------


def committed_evidence(net: Nemesis, node_idx: int) -> list[tuple[int, object]]:
    """(height, evidence) pairs committed in one node's block store."""
    store = net.nodes[node_idx].store
    out = []
    for h in range(max(1, getattr(store, "base", 1)), store.height + 1):
        block = store.load_block(h)
        if block is None:
            continue
        for ev in block.evidence:
            out.append((h, ev))
    return out


def wait_evidence_committed(
    net: Nemesis,
    address: bytes,
    nodes: list[int] | None = None,
    within_heights: int | None = None,
    timeout: float = 60.0,
) -> dict[int, int]:
    """Block until every listed node's store holds a committed
    `DuplicateVoteEvidence` naming `address`; returns {node: height}.
    `within_heights` additionally asserts commitment latency: the
    evidence must land no more than that many heights after the
    equivocation height it proves."""
    targets = list(nodes if nodes is not None else range(len(net.nodes)))
    deadline = time.monotonic() + timeout
    found: dict[int, int] = {}
    while time.monotonic() < deadline:
        if net.violations:
            raise InvariantViolation(net.violations[0])
        for i in targets:
            if i in found:
                continue
            for h, ev in committed_evidence(net, i):
                if (
                    isinstance(ev, DuplicateVoteEvidence)
                    and ev.address == address
                ):
                    if within_heights is not None and h - ev.height > within_heights:
                        raise InvariantViolation(
                            f"node{i}: evidence for height {ev.height} only "
                            f"committed at {h} (> {within_heights} heights late)"
                        )
                    found[i] = h
                    break
        if len(found) == len(targets):
            return found
        time.sleep(0.05)
    raise TimeoutError(
        f"evidence for {address.hex()[:12]} not committed on nodes "
        f"{sorted(set(targets) - set(found))} within {timeout}s "
        f"(found: {found}, heights: {net.heights()})"
    )


# -- the equivocator ----------------------------------------------------------


class Equivocator:
    """Drives one Nemesis validator node to double-sign.

    The node's consensus loop runs HONESTLY (it proposes, votes, and
    commits like everyone else); this adversary watches its vote sets and,
    for every vote the node casts, raw-signs a CONFLICTING vote for a
    fabricated block and broadcasts it to all peers — the compromised-
    signer attack. The PrivValidator's HRS guard is bypassed via the
    Signer seam, which is the realistic threat: the guard lives in
    front of the key, an attacker with the key doesn't call it."""

    def __init__(self, net: Nemesis, index: int) -> None:
        self.net = net
        self.node = net.nodes[index]
        self.index = index
        priv = self.node.priv_validator
        if priv is None:
            raise ValueError(f"node{index} is not a validator")
        self._signer = priv._signer  # raw key access: no double-sign guard
        self.address = priv.address
        self._signed: set[tuple[int, int, int]] = set()
        self.equivocations = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Equivocator":
        self._thread = threading.Thread(
            target=self._run, name=f"equivocator-{self.index}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            try:
                self._equivocate_once()
            except Exception:
                # the adversary must not crash the harness; consensus
                # state reads race height transitions by design
                pass

    def _equivocate_once(self) -> None:
        cs = self.node.cs
        rs = cs.get_round_state()
        if rs.votes is None or rs.validators is None:
            return
        idx, _val = rs.validators.get_by_address(self.address)
        if idx < 0:
            return
        chain_id = cs.state.chain_id
        for type_, vs in (
            (VOTE_TYPE_PREVOTE, rs.votes.prevotes(rs.round)),
            (VOTE_TYPE_PRECOMMIT, rs.votes.precommits(rs.round)),
        ):
            if vs is None:
                continue
            own = vs.get_by_index(idx)
            if own is None:
                continue  # the honest half hasn't voted yet
            key = (own.height, own.round, type_)
            if key in self._signed:
                continue
            self._signed.add(key)
            # conflict = same (h, r, type), different block
            other = (
                BlockID(_FAKE_HASH, PartSetHeader.zero())
                if own.block_id.key() != BlockID(_FAKE_HASH, PartSetHeader.zero()).key()
                else BlockID.zero()
            )
            fake = Vote(
                validator_address=self.address,
                validator_index=idx,
                height=own.height,
                round=own.round,
                timestamp=own.timestamp + 1,
                type=type_,
                block_id=other,
            )
            fake = fake.with_signature(self._signer.sign(fake.sign_bytes(chain_id)))
            self.node.switch.broadcast(VOTE_CHANNEL, VoteMessage(fake).encode())
            self.equivocations += 1
            kv(
                _log,
                logging.INFO,
                "equivocated",
                node=self.index,
                height=own.height,
                round=own.round,
                type=type_,
            )


# -- the conflicting proposer -------------------------------------------------


class ConflictingProposer:
    """When its node is the round's proposer, signs a SECOND proposal
    for the same (height, round) with a fabricated parts header and
    sends it to half the peers — the split-the-proposal attack. Peers
    that adopt the fake first can never complete it (no parts exist),
    prevote nil, and the round must recover without a fork."""

    def __init__(self, net: Nemesis, index: int) -> None:
        self.net = net
        self.node = net.nodes[index]
        self.index = index
        priv = self.node.priv_validator
        if priv is None:
            raise ValueError(f"node{index} is not a validator")
        self._signer = priv._signer
        self._sent: set[tuple[int, int]] = set()
        self.conflicts = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ConflictingProposer":
        self._thread = threading.Thread(
            target=self._run, name=f"conflicting-proposer-{self.index}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            try:
                self._maybe_conflict()
            except Exception:
                pass

    def _maybe_conflict(self) -> None:
        cs = self.node.cs
        rs = cs.get_round_state()
        if rs.proposal is None or not cs.is_proposer():
            return
        key = (rs.height, rs.round)
        if key in self._sent:
            return
        self._sent.add(key)
        fake = Proposal(
            height=rs.height,
            round=rs.round,
            block_parts_header=PartSetHeader(total=1, hash=_FAKE_HASH),
            pol_round=-1,
            pol_block_id=BlockID.zero(),
            timestamp=rs.proposal.timestamp + 1,
        )
        fake = fake.with_signature(
            self._signer.sign(fake.sign_bytes(cs.state.chain_id))
        )
        peers = self.node.switch.peers()
        msg = ProposalMessage(fake).encode()
        for peer in peers[: max(1, len(peers) // 2)]:
            peer.try_send(DATA_CHANNEL, msg)
        self.conflicts += 1


# -- the garbage-signature flooder --------------------------------------------


class GarbageSigFlooder:
    """A connected-but-malicious non-validator peer pushing forged
    signatures into the victim: votes impersonating a real validator
    with random sigs (drains through the consensus vote-batch path) and
    signed-tx envelopes with corrupted sigs (drains through the mempool
    ingress windows). Tracks what the victim should do about it:
    `banned()` flips once the victim's scorer bans the attacker id."""

    def __init__(self, victim_node, chain_id: str, seed: int = 7) -> None:
        from tendermint_tpu_torch.mempool.reactor import MEMPOOL_CHANNEL

        self.victim = victim_node
        self._rng = random.Random(seed)
        self._mempool_channel = MEMPOOL_CHANNEL
        self.switch, self._sink = make_attacker_switch(
            chain_id,
            [STATE_CHANNEL, DATA_CHANNEL, VOTE_CHANNEL,
             VOTE_SET_BITS_CHANNEL, MEMPOOL_CHANNEL],
            name="flooder",
        )
        self.attacker_id = self.switch.node_info.node_id
        # connect_switches(victim, attacker): pb is the attacker's
        # handle for sending INTO the victim
        _pa, self._peer = connect_switches(victim_node.switch, self.switch)
        self.votes_sent = 0
        self.txs_sent = 0

    def flood_votes(self, n: int, impersonate_index: int = 0) -> int:
        """Forged-sig votes at the victim's live (height, round) so they
        reach the signature stage (structural checks pass, the batch
        verdict comes back False, the re-verify raises bad-sig)."""
        rs = self.victim.cs.get_round_state()
        if rs.validators is None:
            return 0
        val = rs.validators.validators[impersonate_index]
        sent = 0
        for _ in range(n):
            vote = Vote(
                validator_address=val.address,
                validator_index=impersonate_index,
                height=rs.height,
                round=rs.round,
                timestamp=self._rng.randrange(1 << 50),
                type=VOTE_TYPE_PREVOTE,
                block_id=BlockID.zero(),
                signature=bytes(self._rng.randrange(256) for _ in range(64)),
            )
            if not self._peer.try_send(VOTE_CHANNEL, VoteMessage(vote).encode()):
                break
            sent += 1
        self.votes_sent += sent
        return sent

    def flood_txs(self, n: int) -> int:
        """Forged signed-tx envelopes into the gossip ingress path."""
        from tendermint_tpu_torch.mempool.ingress import SIGNED_TX_MAGIC
        from tendermint_tpu_torch.mempool.reactor import encode_tx_message

        sent = 0
        for i in range(n):
            fake = (
                SIGNED_TX_MAGIC
                + bytes(self._rng.randrange(256) for _ in range(32))  # pubkey
                + bytes(self._rng.randrange(256) for _ in range(64))  # sig
                + b"flood-%d" % i
            )
            if not self._peer.try_send(
                self._mempool_channel, encode_tx_message(fake)
            ):
                break
            sent += 1
        self.txs_sent += sent
        return sent

    def banned(self) -> bool:
        return self.victim.switch.scorer.is_banned(self.attacker_id)

    def connected(self) -> bool:
        return any(p.id == self.attacker_id for p in self.victim.switch.peers())

    def reconnect(self) -> bool:
        """Try to reattach (a banned attacker must be REFUSED)."""
        try:
            _pa, self._peer = connect_switches(self.victim.switch, self.switch)
            return True
        except ValueError:
            return False

    def stop(self) -> None:
        self.switch.stop()


# -- the lying fast-sync peer -------------------------------------------------


class LyingFastSyncPeer:
    """Serves a forged chain on the blockchain channel: advertises a
    far-ahead height and answers block requests with self-consistent-
    looking blocks whose commits cannot verify. A fast-syncing victim
    must reject them (`forged_block` debit -> ban) without applying a
    single forged block."""

    def __init__(self, victim_switch: Switch, chain_id: str, claim_height: int = 1000) -> None:
        from tendermint_tpu_torch.blockchain.reactor import BLOCKCHAIN_CHANNEL

        self.claim_height = claim_height
        self.chain_id = chain_id
        self.blocks_served = 0
        self._chan = BLOCKCHAIN_CHANNEL
        self.switch, self._sink = make_attacker_switch(
            chain_id, [BLOCKCHAIN_CHANNEL], name="liar"
        )
        self.attacker_id = self.switch.node_info.node_id
        self._sink.on_receive = self._serve
        self.victim_switch = victim_switch
        _pa, self._peer = connect_switches(victim_switch, self.switch)

    def _serve(self, chan_id: int, peer, payload: bytes) -> None:
        from tendermint_tpu_torch.blockchain.reactor import decode_message, _enc

        try:
            kind, arg = decode_message(payload)
        except Exception:
            return
        if kind == "status_request":
            peer.try_send(self._chan, _enc(0x05, self.claim_height))
        elif kind == "block_request":
            peer.try_send(self._chan, _enc(0x02, self._forged_block(arg).encode()))
            self.blocks_served += 1

    def _forged_block(self, height: int):
        """A structurally valid block whose lineage cannot verify: the
        last_commit's block id never matches the predecessor the victim
        computes, so the window linkage check fails and the server is
        treated as serving a forged chain."""
        from tendermint_tpu_torch.types.block import Block, Commit
        from tendermint_tpu_torch.types.tx import Txs

        last_commit = Commit.empty()
        if height > 1:
            fake_vote = Vote(
                validator_address=b"\x01" * 20,
                validator_index=0,
                height=height - 1,
                round=0,
                timestamp=1,
                type=VOTE_TYPE_PRECOMMIT,
                block_id=BlockID(_FAKE_HASH, PartSetHeader(total=1, hash=_FAKE_HASH)),
                signature=b"\x02" * 64,
            )
            last_commit = Commit(
                block_id=fake_vote.block_id, precommits=[fake_vote]
            )
        return Block.make_block(
            height=height,
            chain_id=self.chain_id,
            txs=Txs([b"forged"]),
            last_commit=last_commit,
            last_block_id=BlockID(_FAKE_HASH, PartSetHeader(total=1, hash=_FAKE_HASH)),
            time=height,
            validators_hash=_FAKE_HASH[:20],
            app_hash=b"",
        )

    def banned(self) -> bool:
        return self.victim_switch.scorer.is_banned(self.attacker_id)

    def stop(self) -> None:
        self.switch.stop()


# -- the frame fuzzer ---------------------------------------------------------


def mutate_frame(frame: bytes, rng: random.Random) -> bytes:
    """One deterministic wire mutation: bit flip, truncation, length-
    field lie, duplication, or trailing garbage — the same corpus the
    tier-1 codec fuzz test uses (`tests/test_frame_fuzz.py`)."""
    mode = rng.randrange(6)
    b = bytearray(frame)
    if mode == 0 and b:  # single bit flip
        i = rng.randrange(len(b))
        b[i] ^= 1 << rng.randrange(8)
        return bytes(b)
    if mode == 1 and len(b) > 1:  # truncate
        return bytes(b[: rng.randrange(1, len(b))])
    if mode == 2:  # trailing garbage
        return bytes(b) + bytes(rng.randrange(256) for _ in range(rng.randrange(1, 16)))
    if mode == 3:  # length-field lie: prepend a huge uvarint length
        from tendermint_tpu_torch.codec.binary import encode_uvarint

        return encode_uvarint(rng.randrange(1, 3)) + encode_uvarint(
            1 << rng.randrange(20, 40)
        ) + bytes(b[:4])
    if mode == 4 and b:  # splice two halves reversed
        k = rng.randrange(len(b))
        return bytes(b[k:] + b[:k])
    return bytes(rng.randrange(256) for _ in range(rng.randrange(1, 64)))  # pure noise


class FrameFuzzer:
    """Feeds mutated frames straight into a victim switch's reader as a
    registered peer. The victim will (rightly) disconnect the fuzzing
    identity on the first offense; `run()` transparently reconnects
    under fresh identities until `n_frames` have been delivered. A
    banned identity is never readmitted — `rejected_reconnects` counts
    the bans working."""

    def __init__(self, victim_switch: Switch, chain_id: str, seed: int = 1234) -> None:
        self.victim_switch = victim_switch
        self.chain_id = chain_id
        self.rng = random.Random(seed)
        self._endpoint = None
        self._identity = 0
        self.frames_sent = 0
        self.reconnects = 0
        self.rejected_reconnects = 0

    def _connect(self) -> bool:
        from tendermint_tpu_torch.p2p.transport import pipe_pair

        ea, eb = pipe_pair()
        info = NodeInfo(
            node_id=f"fuzzer-{self._identity:06d}",
            moniker="fuzzer",
            chain_id=self.chain_id,
        )
        self._identity += 1
        try:
            self.victim_switch.add_peer_endpoint(info, ea, outbound=False)
        except ValueError:
            self.rejected_reconnects += 1
            return False
        # drain the victim's outbound gossip so its send loop never
        # blocks on us (an adversary that stops reading is just a slow
        # peer; that's not what this adversary tests)
        def _drain(endpoint=eb):
            try:
                while True:
                    endpoint.recv()
            except Exception:
                pass

        threading.Thread(target=_drain, daemon=True).start()
        self._endpoint = eb
        self.reconnects += 1
        return True

    def golden_frames(self) -> list[bytes]:
        """Valid frames to mutate: a spread of real channel ids and
        payload shapes (the victim's claimed channels + unknown ones)."""
        payloads = [b"", b"\x01", b"\x06" + b"\x00" * 40, bytes(range(32))]
        frames = []
        for chan in (STATE_CHANNEL, DATA_CHANNEL, VOTE_CHANNEL, 0x51, 0x38):
            for p in payloads:
                frames.append(build_frame(chan, p))
        return frames

    def run(self, n_frames: int = 10_000) -> int:
        """Deliver `n_frames` mutated frames; returns how many were
        actually written before any final disconnect."""
        golden = self.golden_frames()
        sent = 0
        while sent < n_frames:
            if self._endpoint is None and not self._connect():
                # every fresh identity refused (unlikely: ids rotate);
                # back off and retry
                time.sleep(0.01)
                continue
            frame = mutate_frame(self.rng.choice(golden), self.rng)
            try:
                self._endpoint.send(frame)
                sent += 1
            except Exception:
                self._endpoint = None  # victim dropped us; reincarnate
        self.frames_sent += sent
        return sent

    def stop(self) -> None:
        if self._endpoint is not None:
            try:
                self._endpoint.close()
            except Exception:
                pass


# -- the forged-FullCommit server ---------------------------------------------


def forge_fullcommit(honest_fc, compromised_priv, chain_id: str):
    """A forged FullCommit at an already-committed height: a forged
    header (wrong app_hash) carrying ONE genuine precommit — the
    compromised validator double-signing the forged block — and no
    other signatures. Certification must reject it (a single validator
    can never be its own +2/3 quorum), and the genuine double-sign is
    exactly the slashable proof `extract_double_sign_evidence` mines
    out of the rejection (the read path's attribution pipeline)."""
    from dataclasses import replace as _replace

    from tendermint_tpu_torch.certifiers.certifier import FullCommit
    from tendermint_tpu_torch.types.block import Commit

    forged_header = _replace(honest_fc.header, app_hash=b"\xde\xad\xbe\xef" * 5)
    forged_bid = BlockID(
        forged_header.hash(),
        PartSetHeader(total=1, hash=forged_header.hash()[:20]),
    )
    vals = honest_fc.validators
    idx, _val = vals.get_by_address(compromised_priv.address)
    if idx < 0:
        raise ValueError("compromised validator not in the honest valset")
    round_ = honest_fc.commit.round()
    honest_pc = honest_fc.commit.precommits[idx]
    vote = Vote(
        validator_address=compromised_priv.address,
        validator_index=idx,
        height=honest_fc.height(),
        round=round_,
        timestamp=honest_pc.timestamp + 1 if honest_pc is not None else 1,
        type=VOTE_TYPE_PRECOMMIT,
        block_id=forged_bid,
    )
    sig = compromised_priv._signer.sign(vote.sign_bytes(chain_id))
    precommits: list = [None] * len(vals.validators)
    precommits[idx] = vote.with_signature(sig)
    return FullCommit(
        header=forged_header,
        commit=Commit(block_id=forged_bid, precommits=precommits),
        validators=vals,
    )


class ForgedCommitPusher:
    """A malicious peer pushing forged FullCommits at a subscribing
    victim on the light-client channel (0x68) — the compromised-replica
    attack. The victim's push certifier must reject the forgery
    (`forged_fullcommit` debit -> instant ban at weight 100) AND route
    the embedded genuine double-sign into its evidence pool, from where
    0x38 gossip carries it to the validators for commitment."""

    def __init__(self, victim_node, forged_fc) -> None:
        from tendermint_tpu_torch.lightclient.reactor import (
            LIGHTCLIENT_CHANNEL,
            _enc_fc_announce,
        )

        self.forged_fc = forged_fc
        self._chan = LIGHTCLIENT_CHANNEL
        self._frame = _enc_fc_announce(forged_fc)
        self.victim_switch = victim_node.switch
        self.switch, self._sink = make_attacker_switch(
            victim_node.genesis.chain_id, [LIGHTCLIENT_CHANNEL], name="forger"
        )
        self.attacker_id = self.switch.node_info.node_id
        _pa, self._peer = connect_switches(self.victim_switch, self.switch)

    def push(self) -> None:
        self._peer.try_send(self._chan, self._frame)

    def banned(self) -> bool:
        return self.victim_switch.scorer.is_banned(self.attacker_id)

    def stop(self) -> None:
        self.switch.stop()
