"""ABCI: the application/consensus process seam.

The reference talks to its application over the ABCI socket/gRPC
protocol through three logical connections (consensus/mempool/query,
`proxy/app_conn.go:11-41`). Here the same seam exists with an in-process
client (reference's local client) — a future gRPC transport slots in
behind `ClientCreator` without touching consumers.

The port's copy of `tendermint_tpu.abci`'s in-process half, with the
same exports. The socket and gRPC transports import `p2p` at module
level and come with the port's `p2p`.
"""

from tendermint_tpu_torch.abci.types import (
    CodeType,
    Result,
    ResultInfo,
    ResultQuery,
    Validator as ABCIValidator,
    OK,
)
from tendermint_tpu_torch.abci.application import Application
from tendermint_tpu_torch.abci.client import (
    AppConnConsensus,
    AppConnMempool,
    AppConnQuery,
    AppConns,
    local_client_creator,
)

__all__ = [
    "Application",
    "AppConnConsensus",
    "AppConnMempool",
    "AppConnQuery",
    "AppConns",
    "ABCIValidator",
    "CodeType",
    "OK",
    "Result",
    "ResultInfo",
    "ResultQuery",
    "local_client_creator",
]
