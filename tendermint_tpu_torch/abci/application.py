"""ABCI application base class (role of abci types.Application)."""

from __future__ import annotations

from tendermint_tpu_torch.abci.types import Result, ResultInfo, ResultQuery, Validator


class Application:
    """Override what you need; defaults are no-op OK responses."""

    # -- query connection ----------------------------------------------------

    def echo(self, msg: str) -> str:
        return msg

    def info(self) -> ResultInfo:
        return ResultInfo()

    def set_option(self, key: str, value: str) -> str:
        return ""

    def query(self, path: str, data: bytes, height: int = 0, prove: bool = False) -> ResultQuery:
        return ResultQuery()

    # -- mempool connection --------------------------------------------------

    def check_tx(self, tx: bytes) -> Result:
        return Result()

    # -- consensus connection ------------------------------------------------

    def init_chain(self, validators: list[Validator]) -> None:
        pass

    def begin_block(self, block_hash: bytes, header, evidence=()) -> None:
        """`evidence` is the block's committed misbehavior proofs
        (`types/evidence.py` DuplicateVoteEvidence — the reference's
        ByzantineValidators); apps that slash override and inspect it.
        Legacy 2-arg overrides keep working: the client only passes the
        evidence kwarg to apps whose signature accepts it."""
        pass

    def deliver_tx(self, tx: bytes) -> Result:
        return Result()

    def end_block(self, height: int) -> list[Validator]:
        return []

    def commit(self) -> Result:
        """Returns the app hash for the next block header."""
        return Result()

    # -- state sync (optional) ----------------------------------------------

    def snapshot_state(self) -> bytes | None:
        """Serialize the committed app state for a snapshot
        (`statesync/snapshot.py`). None = this app opts out of serving
        snapshots; the state-sync reactor then never offers any."""
        return None

    def restore_state(self, data: bytes) -> None:
        """Adopt app state from a verified snapshot. Only called after
        the chunk tree AND the trust anchor checks passed."""
        raise NotImplementedError(f"{type(self).__name__} cannot restore state")
