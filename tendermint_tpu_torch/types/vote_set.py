"""VoteSet: the signature-accumulating 2/3-quorum tracker.

Reference `types/vote_set.go` — the consensus HOT LOOP: `addVote:137-196`
verifies one ed25519 signature per vote then tallies. Here verification goes
through a pluggable verifier so live consensus can use the host path (1 sig,
latency-bound) while replay/fast-sync paths feed whole commits through the
card's batch verifier. Conflict detection, peer-claimed-majority bookkeeping and
quorum semantics follow the reference.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.crypto import PubKey
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.errors import (
    ErrVoteConflictingVotes,
    ErrVoteInvalidSignature,
    ErrVoteInvalidValidatorAddress,
    ErrVoteInvalidValidatorIndex,
    ErrVoteNonDeterministicSignature,
    ErrVoteUnexpectedStep,
    ValidationError,
)
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote, is_vote_type_valid
from tendermint_tpu_torch.utils.bit_array import BitArray


class _BlockVotes:
    """Per-block-ID tally (reference `blockVotes`)."""

    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: list[Vote | None] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, power: int) -> None:
        if self.votes[vote.validator_index] is None:
            self.bit_array.set(vote.validator_index, True)
            self.votes[vote.validator_index] = vote
            self.sum += power

    def get_by_index(self, i: int) -> Vote | None:
        return self.votes[i]


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int, type_: int, val_set: ValidatorSet):
        if height < 1:
            raise ValidationError("VoteSet height must be >= 1")
        if not is_vote_type_valid(type_):
            raise ValidationError(f"invalid vote type {type_}")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.type = type_
        self.val_set = val_set
        self._lock = threading.RLock()
        n = val_set.size()
        self.votes_bit_array = BitArray(n)
        self.votes: list[Vote | None] = [None] * n
        self.sum = 0  # total power of all added votes (any block)
        self.maj23: BlockID | None = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}
        # insertion-ordered keys of claim-created (still-empty) tallies,
        # for bounded eviction — see MAX_PEER_CLAIMS
        self._claim_keys: list[bytes] = []

    # -- add ----------------------------------------------------------------

    def add_vote(self, vote: Vote | None, verifier=None, preverified: bool = False) -> bool:
        """Add one vote; returns True if it changed the set. Raises VoteError
        subclasses on invalid/conflicting votes (reference `AddVote:126-196`).

        `preverified=True` skips the signature check: the caller already
        verified this exact (pubkey, sign_bytes, sig) in a device batch
        (the consensus loop's vote-storm drain) — every structural check
        still runs."""
        if vote is None:
            raise ValidationError("nil vote")
        with self._lock:
            return self._add_vote(vote, verifier, preverified)

    def _add_vote(self, vote: Vote, verifier, preverified: bool = False) -> bool:
        idx = vote.validator_index
        if idx < 0:
            raise ErrVoteInvalidValidatorIndex(f"negative index {idx}")
        if (vote.height, vote.round, vote.type) != (self.height, self.round, self.type):
            raise ErrVoteUnexpectedStep(
                f"vote {vote.height}/{vote.round}/{vote.type} != "
                f"set {self.height}/{self.round}/{self.type}"
            )
        val = self.val_set.get_by_index(idx)
        if val is None:
            raise ErrVoteInvalidValidatorIndex(f"index {idx} >= {self.val_set.size()}")
        if val.address != vote.validator_address:
            raise ErrVoteInvalidValidatorAddress(
                f"vote address {vote.validator_address.hex()} != validator {val.address.hex()}"
            )

        # Duplicate / conflict detection before paying for verification.
        existing = self._get_vote(idx, vote.block_id)
        if existing is not None and existing.signature == vote.signature:
            return False  # exact duplicate

        # Signature check — host single verify or device batch-of-one
        # (skipped when the receive loop batch-verified this vote already)
        if not preverified:
            self._verify_signature(vote, val.pub_key, verifier)

        return self._add_verified_vote(vote, val.voting_power)

    def _verify_signature(self, vote: Vote, pub_key: PubKey, verifier) -> None:
        msg = vote.sign_bytes(self.chain_id)
        if verifier is None:
            from tendermint_tpu_torch.services.verifier import default_verifier

            verifier = default_verifier()
        ok = bool(verifier.verify_batch([(pub_key.data, msg, vote.signature)])[0])
        if not ok:
            raise ErrVoteInvalidSignature(f"invalid signature on {vote}")

    def _add_verified_vote(self, vote: Vote, power: int) -> bool:
        idx = vote.validator_index
        conflicting: Vote | None = None

        existing = self.votes[idx]
        if existing is not None:
            if existing.block_id == vote.block_id:
                # ed25519 is deterministic per key: two different signatures
                # over identical sign-bytes means a malleated/invalid replay.
                raise ErrVoteNonDeterministicSignature(
                    "same vote content with different signature"
                )
            conflicting = existing
        else:
            self.votes[idx] = vote
            self.votes_bit_array.set(idx, True)
            self.sum += power

        key = vote.block_id.key()
        bv = self.votes_by_block.get(key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                # A conflict only tracks against blocks a peer claimed maj23
                # for (reference :236-240).
                raise ErrVoteConflictingVotes(conflicting, vote)
        else:
            if conflicting is not None:
                raise ErrVoteConflictingVotes(conflicting, vote)
            bv = _BlockVotes(peer_maj23=False, num_validators=self.val_set.size())
            self.votes_by_block[key] = bv

        old_sum = bv.sum
        quorum = self.val_set.total_voting_power * 2 // 3 + 1
        bv.add_verified_vote(vote, power)

        # Did this vote tip a block over 2/3?
        if old_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            # Promote this block's votes into the canonical vote list
            # (conflicts resolved in favor of the maj23 block — ref :262-269).
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v
        if conflicting is not None:
            raise ErrVoteConflictingVotes(conflicting, vote)
        return True

    def _get_vote(self, idx: int, block_id: BlockID) -> Vote | None:
        v = self.votes[idx]
        if v is not None and v.block_id == block_id:
            return v
        bv = self.votes_by_block.get(block_id.key())
        if bv is not None:
            return bv.get_by_index(idx)
        return None

    # -- peer claims --------------------------------------------------------

    # Bound on claim-created tallies a flooding peer set can force into
    # votes_by_block: each fresh fake block-id claim allocates a
    # validator-sized _BlockVotes, so without a cap N peers x unlimited
    # claims is unbounded per-round memory. Oldest still-EMPTY claim
    # tallies are evicted past the cap; tallies holding real votes are
    # never dropped (losing votes would be a safety regression).
    MAX_PEER_CLAIMS = 8

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims 2/3 majority for block_id; start tracking its votes
        even across conflicts (reference `SetPeerMaj23`). One claim per
        peer per vote set; claim-created tallies are bounded (a flooding
        peer cannot grow per-round state without limit)."""
        with self._lock:
            if peer_id in self.peer_maj23s:
                return
            self.peer_maj23s[peer_id] = block_id
            key = block_id.key()
            bv = self.votes_by_block.get(key)
            if bv is not None:
                bv.peer_maj23 = True
                return
            self.votes_by_block[key] = _BlockVotes(
                peer_maj23=True, num_validators=self.val_set.size()
            )
            self._claim_keys.append(key)
            while len(self._claim_keys) > self.MAX_PEER_CLAIMS:
                old = self._claim_keys.pop(0)
                stale = self.votes_by_block.get(old)
                if stale is not None and stale.sum == 0 and old != key:
                    del self.votes_by_block[old]

    # -- queries ------------------------------------------------------------

    def get_by_index(self, idx: int) -> Vote | None:
        with self._lock:
            return self.votes[idx] if 0 <= idx < len(self.votes) else None

    def get_by_address(self, address: bytes) -> Vote | None:
        idx, _ = self.val_set.get_by_address(address)
        return self.get_by_index(idx) if idx >= 0 else None

    def has_two_thirds_majority(self) -> bool:
        with self._lock:
            return self.maj23 is not None

    def two_thirds_majority(self) -> BlockID | None:
        with self._lock:
            return self.maj23

    def has_two_thirds_any(self) -> bool:
        """>2/3 of power has voted for *something* (incl. conflicting blocks)."""
        with self._lock:
            return self.sum * 3 > self.val_set.total_voting_power * 2

    def has_all(self) -> bool:
        with self._lock:
            return self.sum == self.val_set.total_voting_power

    def bit_array(self) -> BitArray:
        with self._lock:
            return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        with self._lock:
            bv = self.votes_by_block.get(block_id.key())
            return bv.bit_array.copy() if bv is not None else None

    # -- commit construction -------------------------------------------------

    def make_commit(self) -> Commit:
        """Seal the +2/3 precommits into a Commit (reference `MakeCommit`)."""
        if self.type != VOTE_TYPE_PRECOMMIT:
            raise ValidationError("cannot MakeCommit from a prevote set")
        with self._lock:
            if self.maj23 is None:
                raise ValidationError("cannot MakeCommit without +2/3 majority")
            precommits = [
                v if (v is not None and v.block_id == self.maj23) else None
                for v in self.votes
            ]
            return Commit(block_id=self.maj23, precommits=precommits)

    def __repr__(self) -> str:
        return (
            f"VoteSet{{{self.height}/{self.round}/{self.type} "
            f"{self.votes_bit_array} sum={self.sum}}}"
        )
