"""Chain state + block execution (reference `state/`): the port's copy of
`tendermint_tpu.state`, with the same exports."""

from tendermint_tpu_torch.state.state import ABCIResponses, State, load_state, make_genesis_state
from tendermint_tpu_torch.state.execution import (
    BlockExecutionError,
    apply_block,
    exec_commit_block,
    validate_block,
)

__all__ = [
    "ABCIResponses",
    "BlockExecutionError",
    "State",
    "apply_block",
    "exec_commit_block",
    "load_state",
    "make_genesis_state",
    "validate_block",
]
