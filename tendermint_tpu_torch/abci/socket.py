"""Remote ABCI: run the application in its OWN process over sockets.

Fills the reference's `proxy/client.go:14-80` remote slot (socket
transport; the reference also offers gRPC). This is the framework's
process boundary — the node and the app (or a sidecar service)
communicate over three independent connections (consensus, mempool,
query) exactly like the in-proc `local_client_creator`, so either
creator plugs into `proxy`-level call sites unchanged.

Wire format: 4-byte big-endian length prefix, then
`uvarint msg_type || payload` using the deterministic codec. Each
connection is serial request/response (the reference pipelines with
Flush barriers; our async seams are thread-side, so serial per-conn
keeps the same observable ordering guarantees).

The port's copy of `tendermint_tpu/abci/socket.py`, on the port's
`p2p.tcp` framing and `abci` types: the same request codec, so a port
client talks to a JAX server and the reverse.
"""

from __future__ import annotations

import socket
import threading

from tendermint_tpu_torch.abci.application import Application
from tendermint_tpu_torch.abci.types import Result, ResultInfo, ResultQuery, Validator
from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.p2p.tcp import TcpEndpoint
from tendermint_tpu_torch.p2p.transport import EndpointClosed

_MSG_ECHO = 0x01
_MSG_INFO = 0x02
_MSG_FLUSH = 0x03
_MSG_CHECK_TX = 0x04
_MSG_DELIVER_TX = 0x05
_MSG_BEGIN_BLOCK = 0x06
_MSG_END_BLOCK = 0x07
_MSG_COMMIT = 0x08
_MSG_QUERY = 0x09
_MSG_INIT_CHAIN = 0x0A

def _enc_validators(w: Writer, vals: list[Validator]) -> Writer:
    w.uvarint(len(vals))
    for v in vals:
        w.bytes(v.pub_key).uvarint(v.power)
    return w


def _dec_validators(r: Reader) -> list[Validator]:
    return [
        Validator(pub_key=r.bytes(), power=r.uvarint())
        for _ in range(r.uvarint())
    ]


# -- server (app side) --------------------------------------------------------


class ABCISocketServer:
    """Serve one Application to any number of node connections
    (the node opens three). App callbacks run under one lock — the same
    serialization the in-proc `local_client_creator` provides."""

    def __init__(self, app: Application, laddr: str) -> None:
        from tendermint_tpu_torch.p2p.tcp import parse_laddr

        self.app = app
        self._lock = threading.Lock()
        host, port = parse_laddr(laddr)
        self._srv = socket.create_server((host, port))
        self.addr = self._srv.getsockname()
        self._conns: list[TcpEndpoint] = []
        self._running = True
        threading.Thread(target=self._accept_loop, name="abci-accept", daemon=True).start()

    @property
    def port(self) -> int:
        return self.addr[1]

    def stop(self) -> None:
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass
        for ep in list(self._conns):
            ep.close()  # unblocks serve threads parked in recv

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn,
                args=(sock,),
                name="abci-conn",
                daemon=True,
            ).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        # same length-prefixed framing as the p2p transport (one frame
        # codec to maintain — TcpEndpoint)
        ep = TcpEndpoint(sock)
        self._conns.append(ep)
        try:
            while self._running:
                ep.send(self._handle(ep.recv()))
        except (EndpointClosed, TimeoutError, OSError):
            pass
        finally:
            ep.close()
            try:
                self._conns.remove(ep)
            except ValueError:
                pass

    def _handle(self, req: bytes) -> bytes:
        return handle_abci_request(self.app, self._lock, req)


def handle_abci_request(app: Application, lock: threading.Lock, req: bytes) -> bytes:
    """Dispatch one framed ABCI request to the app — shared by every
    remote transport (socket here, gRPC in `abci/grpc_transport.py`);
    the reference likewise serves one request codec over both
    (`proxy/client.go:14-80`)."""
    r = Reader(req)
    tag = r.uvarint()
    w = Writer()
    with lock:
        if tag == _MSG_ECHO:
            w.string(app.echo(r.string()))
        elif tag == _MSG_INFO:
            info = app.info()
            w.string(info.data).string(info.version)
            w.uvarint(info.last_block_height).bytes(info.last_block_app_hash)
        elif tag == _MSG_FLUSH:
            pass
        elif tag == _MSG_CHECK_TX:
            w.raw(app.check_tx(r.bytes()).encode())
        elif tag == _MSG_DELIVER_TX:
            w.raw(app.deliver_tx(r.bytes()).encode())
        elif tag == _MSG_BEGIN_BLOCK:
            from tendermint_tpu_torch.abci.client import _accepts_evidence
            from tendermint_tpu_torch.types.block import Header
            from tendermint_tpu_torch.types.evidence import decode_evidence

            block_hash = r.bytes()
            header = Header.decode_from(Reader(r.bytes()))
            # trailing optional evidence section (absent from legacy
            # clients' requests — and hidden from legacy 2-arg apps)
            evidence = []
            if not r.done():
                evidence = [decode_evidence(r.bytes()) for _ in range(r.uvarint())]
            if _accepts_evidence(app.begin_block):
                app.begin_block(block_hash, header, evidence=evidence)
            else:
                app.begin_block(block_hash, header)
        elif tag == _MSG_END_BLOCK:
            _enc_validators(w, app.end_block(r.uvarint()))
        elif tag == _MSG_COMMIT:
            w.raw(app.commit().encode())
        elif tag == _MSG_QUERY:
            res = app.query(
                r.string(), r.bytes(), r.uvarint(), r.bool()
            )
            w.uvarint(res.code).svarint(res.index).bytes(res.key)
            w.bytes(res.value).bytes(res.proof).uvarint(res.height)
            w.string(res.log)
        elif tag == _MSG_INIT_CHAIN:
            app.init_chain(_dec_validators(r))
        else:
            raise ConnectionError(f"unknown abci message {tag:#x}")
    return w.build()


# -- client (node side) -------------------------------------------------------


class _SocketConn:
    def __init__(self, addr: str, timeout: float = 30.0) -> None:
        from tendermint_tpu_torch.p2p.tcp import parse_laddr

        host, port = parse_laddr(addr)
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(None)
        self._ep = TcpEndpoint(sock)
        self._lock = threading.Lock()

    def call(self, payload: bytes) -> Reader:
        with self._lock:
            self._ep.send(payload)
            return Reader(self._ep.recv())

    def close(self) -> None:
        self._ep.close()


class _RemoteQuery:
    def __init__(self, conn: _SocketConn) -> None:
        self._conn = conn

    def close(self) -> None:
        self._conn.close()

    def echo_sync(self, msg: str) -> str:
        return self._conn.call(Writer().uvarint(_MSG_ECHO).string(msg).build()).string()

    def info_sync(self) -> ResultInfo:
        r = self._conn.call(Writer().uvarint(_MSG_INFO).build())
        return ResultInfo(
            data=r.string(),
            version=r.string(),
            last_block_height=r.uvarint(),
            last_block_app_hash=r.bytes(),
        )

    def query_sync(self, path: str, data: bytes, height: int = 0, prove: bool = False) -> ResultQuery:
        r = self._conn.call(
            Writer()
            .uvarint(_MSG_QUERY)
            .string(path)
            .bytes(data)
            .uvarint(height)
            .bool(prove)
            .build()
        )
        return ResultQuery(
            code=r.uvarint(),
            index=r.svarint(),
            key=r.bytes(),
            value=r.bytes(),
            proof=r.bytes(),
            height=r.uvarint(),
            log=r.string(),
        )


class _RemoteMempool:
    def __init__(self, conn: _SocketConn) -> None:
        self._conn = conn

    def close(self) -> None:
        self._conn.close()

    def check_tx_async(self, tx: bytes, cb=None) -> Result:
        r = self._conn.call(Writer().uvarint(_MSG_CHECK_TX).bytes(tx).build())
        res = _read_result(r)
        if cb is not None:
            cb(res)
        return res

    def flush_sync(self) -> None:
        self._conn.call(Writer().uvarint(_MSG_FLUSH).build())

    def flush_async(self) -> None:
        self.flush_sync()


def _read_result(r: Reader) -> Result:
    return Result(code=r.uvarint(), data=r.bytes(), log=r.string())


class _RemoteConsensus:
    def __init__(self, conn: _SocketConn) -> None:
        self._conn = conn

    def close(self) -> None:
        self._conn.close()

    def init_chain_sync(self, validators) -> None:
        self._conn.call(
            _enc_validators(Writer().uvarint(_MSG_INIT_CHAIN), list(validators)).build()
        )

    def begin_block_sync(self, block_hash: bytes, header, evidence=()) -> None:
        w = (
            Writer()
            .uvarint(_MSG_BEGIN_BLOCK)
            .bytes(block_hash)
            .bytes(header.encode())
        )
        if evidence:
            w.uvarint(len(evidence))
            for ev in evidence:
                w.bytes(ev.encode())
        self._conn.call(w.build())

    def deliver_tx_async(self, tx: bytes, cb=None) -> Result:
        res = _read_result(
            self._conn.call(Writer().uvarint(_MSG_DELIVER_TX).bytes(tx).build())
        )
        if cb is not None:
            cb(res)
        return res

    def end_block_sync(self, height: int):
        r = self._conn.call(Writer().uvarint(_MSG_END_BLOCK).uvarint(height).build())
        return _dec_validators(r)

    def commit_sync(self) -> Result:
        return _read_result(self._conn.call(Writer().uvarint(_MSG_COMMIT).build()))


def socket_client_creator(addr: str):
    """ClientCreator over the socket transport (reference
    `proxy/client.go` NewRemoteClientCreator): three independent
    connections to one app server, same AppConns shape as
    `local_client_creator`."""
    from tendermint_tpu_torch.abci.client import AppConns

    def create() -> AppConns:
        return AppConns(
            consensus=_RemoteConsensus(_SocketConn(addr)),
            mempool=_RemoteMempool(_SocketConn(addr)),
            query=_RemoteQuery(_SocketConn(addr)),
        )

    return create
