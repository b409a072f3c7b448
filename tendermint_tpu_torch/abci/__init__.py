"""ABCI: the application/consensus process seam.

The reference talks to its application over the ABCI socket/gRPC
protocol through three logical connections (consensus/mempool/query,
`proxy/app_conn.go:11-41`). Here the same seam exists with an in-process
client (reference's local client) — a future gRPC transport slots in
behind `ClientCreator` without touching consumers.

The port's copy of `tendermint_tpu.abci`, with the same exports. Its
remote transports, `abci/socket.py` and `abci/grpc_transport.py`, are
imported by module, as in the JAX package.
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
