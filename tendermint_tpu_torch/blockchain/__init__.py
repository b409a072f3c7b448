"""Block storage + fast-sync (reference `blockchain/`); the port's copy of
`tendermint_tpu/blockchain/__init__.py`, with the same exports."""

from tendermint_tpu_torch.blockchain.pool import BlockPool
from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
from tendermint_tpu_torch.blockchain.store import BlockMeta, BlockStore

__all__ = ["BlockMeta", "BlockPool", "BlockStore", "BlockchainReactor"]
