"""Consensus core (reference `consensus/`): the BFT state machine, its
write-ahead log, timeout scheduling, and crash recovery."""

from tendermint_tpu_torch.consensus.config import ConsensusConfig
from tendermint_tpu_torch.consensus.round_state import (
    HeightVoteSet,
    RoundState,
    RoundStepType,
)
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.ticker import MockTicker, TimeoutTicker
from tendermint_tpu_torch.consensus.wal import WAL, EndHeightMessage

__all__ = [
    "WAL",
    "ConsensusConfig",
    "ConsensusState",
    "EndHeightMessage",
    "HeightVoteSet",
    "MockTicker",
    "RoundState",
    "RoundStepType",
    "TimeoutTicker",
]
