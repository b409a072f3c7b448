"""Domain types (reference layer 1, `types/` — SURVEY.md §1).

The port's copy of `tendermint_tpu.types`, with the same modules, names,
encodings, sign bytes, hashes and errors. Plain Python: the types reach
the card only through the port's seams, a `BatchVerifier`
(`services.verifier.default_verifier`) and a `TreeHasher`
(`services.hasher.default_hasher`), which callers pass in. A missing
`verifier=` means the port's `default_verifier()`, the card's stack,
which raises on a machine without a card; a missing `hasher=` means the
host tree, as in the JAX package.
"""

from tendermint_tpu_torch.types.block import Block, Commit, Data, Header
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.errors import (
    ErrDoubleSign,
    ErrVoteConflictingVotes,
    ErrVoteInvalidSignature,
    ErrVoteInvalidValidatorAddress,
    ErrVoteInvalidValidatorIndex,
    ErrVoteNonDeterministicSignature,
    ErrVoteUnexpectedStep,
    TMError,
    ValidationError,
    VoteError,
)
from tendermint_tpu_torch.types.events import EventCache, EventSwitch
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.heartbeat import Heartbeat
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.part_set import DEFAULT_PART_SIZE, Part, PartSet, PartSetHeader
from tendermint_tpu_torch.types.priv_validator import (
    STEP_NONE,
    STEP_PRECOMMIT,
    STEP_PREVOTE,
    STEP_PROPOSE,
    PrivValidator,
    PrivValidatorFS,
    Signer,
)
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.tx import Tx, TxProof, Txs, tx_hash
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import (
    VOTE_TYPE_PRECOMMIT,
    VOTE_TYPE_PREVOTE,
    Vote,
    is_vote_type_valid,
)
from tendermint_tpu_torch.types.vote_set import VoteSet

__all__ = [
    "Block",
    "BlockID",
    "Commit",
    "ConsensusParams",
    "Data",
    "DEFAULT_PART_SIZE",
    "ErrDoubleSign",
    "ErrVoteConflictingVotes",
    "ErrVoteInvalidSignature",
    "ErrVoteInvalidValidatorAddress",
    "ErrVoteInvalidValidatorIndex",
    "ErrVoteNonDeterministicSignature",
    "ErrVoteUnexpectedStep",
    "EventCache",
    "EventSwitch",
    "GenesisDoc",
    "GenesisValidator",
    "Header",
    "Heartbeat",
    "Part",
    "PartSet",
    "PartSetHeader",
    "PrivValidator",
    "PrivValidatorFS",
    "Proposal",
    "Signer",
    "STEP_NONE",
    "STEP_PRECOMMIT",
    "STEP_PREVOTE",
    "STEP_PROPOSE",
    "TMError",
    "Tx",
    "TxProof",
    "Txs",
    "tx_hash",
    "ValidationError",
    "Validator",
    "ValidatorSet",
    "Vote",
    "VoteError",
    "VoteSet",
    "VOTE_TYPE_PRECOMMIT",
    "VOTE_TYPE_PREVOTE",
    "is_vote_type_valid",
]
