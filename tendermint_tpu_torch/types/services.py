"""Service interfaces decoupling consensus from mempool/blockstore
implementations (reference `types/services.go:21-33,67-71`)."""

from __future__ import annotations

from typing import Callable, Protocol

from tendermint_tpu_torch.types.tx import Tx, Txs


class MempoolI(Protocol):
    """What consensus needs from a mempool (reference `types.Mempool`)."""

    def lock(self) -> None: ...
    def unlock(self) -> None: ...
    def size(self) -> int: ...
    def check_tx(self, tx: Tx, cb: Callable | None = None) -> None: ...
    def reap(self, max_txs: int) -> Txs: ...
    def update(self, height: int, txs: Txs) -> None: ...
    def flush(self) -> None: ...
    def tx_available(self) -> bool: ...
    def enable_txs_available(self) -> None: ...


class NopMempool:
    """No-op mempool (reference `types.MockMempool`) for replay/tests."""

    def lock(self) -> None:
        pass

    def unlock(self) -> None:
        pass

    def size(self) -> int:
        return 0

    def check_tx(self, tx: Tx, cb: Callable | None = None) -> None:
        pass

    def check_tx_async(self, tx: Tx, cb: Callable | None = None) -> None:
        pass

    def reap(self, max_txs: int) -> Txs:
        return Txs()

    def update(self, height: int, txs: Txs) -> None:
        pass

    def flush(self) -> None:
        pass

    def tx_available(self) -> bool:
        return False

    def enable_txs_available(self) -> None:
        pass


class BlockStoreI(Protocol):
    """What consensus/state need from block storage (reference `types.BlockStoreRPC`)."""

    @property
    def height(self) -> int: ...
    def load_block(self, height: int): ...
    def load_block_meta(self, height: int): ...
    def load_block_part(self, height: int, index: int): ...
    def load_block_commit(self, height: int): ...
    def load_seen_commit(self, height: int): ...
    def save_block(self, block, part_set, seen_commit) -> None: ...
