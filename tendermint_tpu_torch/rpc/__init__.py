"""JSON-RPC API layer (reference `rpc/lib` + `rpc/core`).

The port's copy of `tendermint_tpu/rpc/__init__.py`. The same exports as
the JAX package's `rpc`.
"""

from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.rpc.core import make_routes

__all__ = ["RPCServer", "make_routes"]
