"""Mempool (reference `mempool/`)."""

from tendermint_tpu_torch.mempool.ingress import (
    IngressBatcher,
    make_signed_tx,
    parse_signed_tx,
)
from tendermint_tpu_torch.mempool.mempool import Mempool, TxCache

__all__ = [
    "IngressBatcher",
    "Mempool",
    "TxCache",
    "make_signed_tx",
    "parse_signed_tx",
]
