"""Remote ABCI over gRPC — the reference's second remote transport
(`proxy/client.go:62-80` offers socket AND grpc client creators;
`abci` repo `server/grpc_server.go`).

Same framed request codec as the socket transport (`abci/socket.py`
`handle_abci_request`), carried as unary-unary gRPC calls via grpcio's
generic-handler API (no protoc build step — the pattern established by
`rpc/grpc_api.py`). The node opens three independent channels
(consensus, mempool, query), mirroring the socket creator.

The port's copy of `tendermint_tpu/abci/grpc_transport.py`, with the
same service name so the two packages' clients and servers interoperate.
`grpc` is imported only inside the functions that open a server or a
channel: the port imports it nowhere else, and a node that does not
configure a gRPC transport never needs the package.
"""

from __future__ import annotations

import threading
from concurrent import futures

from tendermint_tpu_torch.abci.application import Application
from tendermint_tpu_torch.abci.socket import (
    _RemoteConsensus,
    _RemoteMempool,
    _RemoteQuery,
    handle_abci_request,
)
from tendermint_tpu_torch.codec.binary import Reader

_SERVICE = "tendermint_tpu.ABCIApplication"
_METHOD = f"/{_SERVICE}/Call"


def _identity(b: bytes) -> bytes:
    return b


class ABCIGrpcServer:
    """Serve one Application over gRPC (app-side process)."""

    def __init__(self, app: Application, laddr: str) -> None:
        import grpc

        from tendermint_tpu_torch.p2p.tcp import parse_laddr

        self.app = app
        self._lock = threading.Lock()
        host, port = parse_laddr(laddr)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        handler = grpc.method_handlers_generic_handler(
            _SERVICE,
            {
                "Call": grpc.unary_unary_rpc_method_handler(
                    self._call,
                    request_deserializer=_identity,
                    response_serializer=_identity,
                )
            },
        )
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise OSError(f"ABCI gRPC bind failed for {laddr}")
        self._server.start()

    def _call(self, request: bytes, context) -> bytes:
        return handle_abci_request(self.app, self._lock, request)

    def stop(self) -> None:
        self._server.stop(grace=0.5)


class _GrpcConn:
    """One logical ABCI connection = one gRPC channel; satisfies the
    same .call/.close contract as `_SocketConn`, so the socket
    transport's _Remote* wrappers run unchanged over it."""

    def __init__(self, addr: str, timeout: float = 30.0) -> None:
        import grpc

        self._timeout = timeout
        self._channel = grpc.insecure_channel(addr)
        self._fn = self._channel.unary_unary(
            _METHOD,
            request_serializer=_identity,
            response_deserializer=_identity,
        )

    def call(self, payload: bytes) -> Reader:
        return Reader(self._fn(payload, timeout=self._timeout))

    def close(self) -> None:
        self._channel.close()


def grpc_client_creator(addr: str):
    """ClientCreator over gRPC (reference `proxy/client.go` grpc arm of
    NewRemoteClientCreator): three independent channels to one app
    server, same AppConns shape as the socket and in-proc creators."""
    from tendermint_tpu_torch.abci.client import AppConns

    def create() -> AppConns:
        return AppConns(
            consensus=_RemoteConsensus(_GrpcConn(addr)),
            mempool=_RemoteMempool(_GrpcConn(addr)),
            query=_RemoteQuery(_GrpcConn(addr)),
        )

    return create
