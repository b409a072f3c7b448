"""gRPC broadcast API (reference `rpc/grpc/api.go:13-30` + `types.proto`).

The reference exposes a minimal gRPC surface for app developers: `Ping`
and `BroadcastTx` (which wraps BroadcastTxCommit). Implemented with
grpcio's generic handler API — message bodies use this framework's
deterministic codec rather than protoc-generated classes, so there is
no generated-code build step; the transport is standard gRPC/HTTP2.

Service: `tendermint_tpu.BroadcastAPI`
  Ping(bytes)        -> b"pong"
  BroadcastTx(tx)    -> Writer(check_code, check_log,
                               deliver_code, deliver_data, deliver_log,
                               height)

The port's copy of `tendermint_tpu/rpc/grpc_api.py`. `grpc` is imported
inside its functions only (the card's machine has none); the service
keeps the JAX name, so both packages' clients and servers interoperate.
"""

from __future__ import annotations

from concurrent import futures

from tendermint_tpu_torch.codec.binary import Reader, Writer

_SERVICE = "tendermint_tpu.BroadcastAPI"


def _identity(b: bytes) -> bytes:
    return b


class GRPCBroadcastServer:
    """Serves Ping/BroadcastTx for one node (reference `grpccore`)."""

    def __init__(self, node, laddr: str) -> None:
        import grpc

        from tendermint_tpu_torch.p2p.tcp import parse_laddr

        self._node = node
        host, port = parse_laddr(laddr)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        handler = grpc.method_handlers_generic_handler(
            _SERVICE,
            {
                "Ping": grpc.unary_unary_rpc_method_handler(
                    self._ping,
                    request_deserializer=_identity,
                    response_serializer=_identity,
                ),
                "BroadcastTx": grpc.unary_unary_rpc_method_handler(
                    self._broadcast_tx,
                    request_deserializer=_identity,
                    response_serializer=_identity,
                ),
            },
        )
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise OSError(f"gRPC bind failed for {laddr}")
        from tendermint_tpu_torch.rpc.core import make_routes

        self._routes = make_routes(node)

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=0.5)

    # -- handlers ----------------------------------------------------------

    def _ping(self, request: bytes, context) -> bytes:
        return b"pong"

    def _broadcast_tx(self, request: bytes, context) -> bytes:
        """BroadcastTx == wait-for-commit (reference wraps
        BroadcastTxCommit)."""
        import grpc

        from tendermint_tpu_torch.rpc.server import RPCError

        try:
            res = self._routes["broadcast_tx_commit"](tx=request.hex())
        except RPCError as e:
            # surface a structured failure (e.g. commit timeout) instead
            # of an opaque UNKNOWN with a server-side traceback
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED if "timed out" in e.message else grpc.StatusCode.INTERNAL, e.message)
        w = Writer()
        w.uvarint(res["check_tx"].get("code", 0))
        w.string(res["check_tx"].get("log", ""))
        deliver = res.get("deliver_tx") or {}
        w.uvarint(deliver.get("code", 0))
        w.bytes(bytes.fromhex(deliver.get("data", "")))
        w.string(deliver.get("log", ""))
        w.uvarint(res.get("height", 0))
        return w.build()


class GRPCBroadcastClient:
    """Client for the broadcast service (reference
    `rpc/grpc/client_server.go`)."""

    def __init__(self, address: str) -> None:
        import grpc

        addr = address.split("://", 1)[-1]
        self._channel = grpc.insecure_channel(addr)
        self._ping = self._channel.unary_unary(
            f"/{_SERVICE}/Ping",
            request_serializer=_identity,
            response_deserializer=_identity,
        )
        self._broadcast = self._channel.unary_unary(
            f"/{_SERVICE}/BroadcastTx",
            request_serializer=_identity,
            response_deserializer=_identity,
        )

    def ping(self, timeout: float = 10.0) -> bool:
        return self._ping(b"", timeout=timeout) == b"pong"

    def broadcast_tx(self, tx: bytes, timeout: float = 90.0) -> dict:
        r = Reader(self._broadcast(tx, timeout=timeout))
        return {
            "check_tx": {"code": r.uvarint(), "log": r.string()},
            "deliver_tx": {
                "code": r.uvarint(),
                "data": r.bytes(),
                "log": r.string(),
            },
            "height": r.uvarint(),
        }

    def close(self) -> None:
        self._channel.close()
