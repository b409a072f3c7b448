"""Round-state types (reference `consensus/types/`): the step enum, the
RoundState snapshot, and HeightVoteSet (prevotes+precommits per round).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any

from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE, Vote
from tendermint_tpu_torch.types.vote_set import VoteSet


class RoundStepType:
    """Reference `consensus/types/state.go` RoundStepType."""

    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8

    NAMES = {
        1: "NewHeight",
        2: "NewRound",
        3: "Propose",
        4: "Prevote",
        5: "PrevoteWait",
        6: "Precommit",
        7: "PrecommitWait",
        8: "Commit",
    }

    @classmethod
    def name(cls, step: int) -> str:
        return cls.NAMES.get(step, f"Unknown({step})")


@dataclass
class RoundState:
    """Immutable-ish snapshot of the consensus internals
    (reference `consensus/types/state.go` RoundState)."""

    height: int
    round: int
    step: int
    start_time: float
    commit_time: float
    validators: ValidatorSet
    proposal: Any = None
    proposal_block: Any = None
    proposal_block_parts: Any = None
    locked_round: int = -1
    locked_block: Any = None
    locked_block_parts: Any = None
    votes: "HeightVoteSet | None" = None
    commit_round: int = -1
    last_commit: VoteSet | None = None
    last_validators: ValidatorSet | None = None

    def round_state_event(self):
        from tendermint_tpu_torch.types.events import EventDataRoundState

        return EventDataRoundState(
            height=self.height,
            round=self.round,
            step=RoundStepType.name(self.step),
            round_state=self,
        )


class HeightVoteSet:
    """All VoteSets for one height: prevotes + precommits keyed by round
    (reference `consensus/types/height_vote_set.go:30-39`).

    Peers can only make us instantiate vote sets for 2 rounds above
    `self.round` (catchup cap `:105-126`) — otherwise a byzantine peer
    could force unbounded allocations.
    """

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.round = 0
        self._lock = threading.RLock()
        self._round_vote_sets: dict[int, dict[int, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self._add_round(0)

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            return
        self._round_vote_sets[round_] = {
            VOTE_TYPE_PREVOTE: VoteSet(
                self.chain_id, self.height, round_, VOTE_TYPE_PREVOTE, self.val_set
            ),
            VOTE_TYPE_PRECOMMIT: VoteSet(
                self.chain_id, self.height, round_, VOTE_TYPE_PRECOMMIT, self.val_set
            ),
        }

    def set_round(self, round_: int) -> None:
        """Ensure vote sets exist up to round+1 (reference `SetRound`)."""
        with self._lock:
            if round_ < self.round:
                raise ValidationError("set_round cannot decrease round")
            for r in range(self.round, round_ + 2):
                self._add_round(r)
            self.round = round_

    def add_vote(
        self, vote: Vote, peer_id: str = "", verifier=None, preverified: bool = False
    ) -> bool:
        with self._lock:
            if not self._is_vote_allowed(vote, peer_id):
                return False
            vs = self._get(vote.round, vote.type)
            if vs is None:
                self._add_round(vote.round)
                vs = self._get(vote.round, vote.type)
        return vs.add_vote(vote, verifier=verifier, preverified=preverified)

    def _is_vote_allowed(self, vote: Vote, peer_id: str) -> bool:
        if vote.round <= self.round + 1:
            return True
        # catchup: each peer may open at most 2 future rounds
        rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
        if vote.round in rounds:
            return True
        if len(rounds) < 2:
            rounds.append(vote.round)
            self._add_round(vote.round)
            return True
        return False

    def _get(self, round_: int, type_: int) -> VoteSet | None:
        d = self._round_vote_sets.get(round_)
        return d[type_] if d else None

    def prevotes(self, round_: int) -> VoteSet | None:
        with self._lock:
            return self._get(round_, VOTE_TYPE_PREVOTE)

    def precommits(self, round_: int) -> VoteSet | None:
        with self._lock:
            return self._get(round_, VOTE_TYPE_PRECOMMIT)

    def pol_info(self) -> tuple[int, BlockID | None]:
        """Highest round with a prevote polka (reference `POLInfo`)."""
        with self._lock:
            for r in sorted(self._round_vote_sets, reverse=True):
                vs = self._get(r, VOTE_TYPE_PREVOTE)
                bid = vs.two_thirds_majority() if vs else None
                if bid is not None:
                    return r, bid
        return -1, None

    def set_peer_maj23(self, round_: int, type_: int, peer_id: str, block_id: BlockID) -> None:
        """Record a peer's +2/3 claim. Future-round claims ride the SAME
        per-peer catchup allowance as votes (at most 2 rounds above
        round+1 per peer) — without the gate a flooding peer could mint
        a fresh VoteSet pair per claimed round, unbounded per-height
        state (`consensus/reactor.py` Maj23 receive path)."""
        with self._lock:
            if round_ > self.round + 1:
                rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
                if round_ not in rounds:
                    if len(rounds) >= 2:
                        return  # claim flood: refuse the allocation
                    rounds.append(round_)
            self._add_round(round_)
            vs = self._get(round_, type_)
        if vs is not None:
            vs.set_peer_maj23(peer_id, block_id)
