"""The port's remote ABCI transports against the JAX package's.

`tendermint_tpu_torch.abci.socket` and `abci.grpc_transport` run the
JAX package's `tests/test_abci_socket.py` round trip (three connections,
every request type) over the socket and, where `grpc` is installed, over
gRPC. Its second case, a whole `Node` against a remote app, waits for
the port's node. Across the packages, a port client against a JAX server
and a JAX client against a port server give, request for request, the
responses the port's in-process client gives on a fresh app, and both
packages' `handle_abci_request` answer the same request bytes with the
same response bytes.
"""

from __future__ import annotations

import threading

import pytest

from tendermint_tpu.abci import socket as J_socket
from tendermint_tpu.abci.apps import PersistentKVStoreApp as JPersistentKVStoreApp
from tendermint_tpu_torch.abci import socket as P_socket
from tendermint_tpu_torch.abci.apps import KVStoreApp, PersistentKVStoreApp
from tendermint_tpu_torch.abci.client import local_client_creator
from tendermint_tpu_torch.abci.socket import ABCISocketServer, socket_client_creator
from tendermint_tpu_torch.abci.types import Validator as ABCIValidator
from tendermint_tpu_torch.codec.binary import Writer
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture
from tendermint_tpu_torch.types.block import Header
from tendermint_tpu_torch.types.block_id import BlockID


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))


def _grpc_modules():
    pytest.importorskip("grpc")
    from tendermint_tpu.abci import grpc_transport as J_grpc
    from tendermint_tpu_torch.abci import grpc_transport as P_grpc

    return P_grpc, J_grpc


def _server(pkg: str, transport: str, app):
    """(server, client creator of the same package) on a free port."""
    if transport == "socket":
        mod = P_socket if pkg == "port" else J_socket
        return mod.ABCISocketServer(app, "tcp://127.0.0.1:0"), mod.socket_client_creator
    P_grpc, J_grpc = _grpc_modules()
    mod = P_grpc if pkg == "port" else J_grpc
    return mod.ABCIGrpcServer(app, "tcp://127.0.0.1:0"), mod.grpc_client_creator


def _close(conns):
    for c in (conns.consensus, conns.mempool, conns.query):
        close = getattr(c, "close", None)
        if close is not None:
            close()


# -- tests/test_abci_socket.py ----------------------------------------------------------


@pytest.fixture(params=["socket", "grpc"])
def served_app(request):
    app = KVStoreApp()
    srv, creator = _server("port", request.param, app)
    yield app, creator(f"127.0.0.1:{srv.port}")
    srv.stop()


class TestSocketProxy:
    def test_three_connections_round_trip(self, served_app):
        app, creator = served_app
        conns = creator()
        try:
            assert conns.query.echo_sync("ping") == "ping"
            assert conns.query.info_sync().last_block_height == 0
            assert conns.mempool.check_tx_async(b"k=v").is_ok
            conns.mempool.flush_sync()
            conns.consensus.init_chain_sync([ABCIValidator(pub_key=b"\x01" * 32, power=10)])
            header = Header(chain_id="sock", height=1, time=1, num_txs=1, last_block_id=BlockID.zero(),
                            validators_hash=b"\x02" * 32)
            conns.consensus.begin_block_sync(b"\xaa" * 32, header)
            assert conns.consensus.deliver_tx_async(b"k=v").is_ok
            assert conns.consensus.end_block_sync(1) == []
            commit = conns.consensus.commit_sync()
            assert commit.is_ok and commit.data
            assert conns.query.query_sync("", b"k").value == b"v"
        finally:
            _close(conns)

    def test_unknown_message_is_refused(self):
        with pytest.raises(ConnectionError, match="unknown abci message"):
            P_socket.handle_abci_request(KVStoreApp(), threading.Lock(), Writer().uvarint(0x7F).build())


# -- across the packages --------------------------------------------------------------------

VAL_A, VAL_B = bytes(range(32)), bytes(range(32, 64))


def _exchange(conns) -> list:
    """Two heights of every request type through `conns`, each response
    as plain values."""
    out = [conns.query.echo_sync("héllo"), _info(conns.query.info_sync())]
    conns.consensus.init_chain_sync([ABCIValidator(pub_key=VAL_A, power=10), ABCIValidator(pub_key=VAL_B, power=5)])
    for height, txs in ((1, [b"a=1", b"b=2", f"val:{VAL_B.hex()}/0".encode()]),
                        (2, [b"a=3", f"val:{VAL_A.hex()}/7".encode(), b"not-a-pair"])):
        for tx in txs:
            out.append(_res(conns.mempool.check_tx_async(tx)))
        conns.mempool.flush_sync()
        header = Header(chain_id="abci-x", height=height, time=height * 10, num_txs=len(txs),
                        last_block_id=BlockID.zero(), validators_hash=b"\x02" * 32)
        conns.consensus.begin_block_sync(bytes([height]) * 32, header)
        out += [_res(conns.consensus.deliver_tx_async(tx)) for tx in txs]
        out.append([(v.pub_key, v.power) for v in conns.consensus.end_block_sync(height)])
        out.append(_res(conns.consensus.commit_sync()))
        out.append(_info(conns.query.info_sync()))
    for key in (b"a", b"b", b"missing"):
        q = conns.query.query_sync("", key, 0, False)
        out.append((q.code, q.index, q.key, q.value, q.proof, q.height, q.log))
    return out


def _res(r):
    return (r.code, r.data, r.log)


def _info(i):
    return (i.data, i.version, i.last_block_height, i.last_block_app_hash)


@pytest.fixture(scope="module")
def in_process_exchange():
    conns = local_client_creator(PersistentKVStoreApp())()
    return _exchange(conns)


@pytest.mark.parametrize("transport", ["socket", "grpc"])
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_cross_package_responses_equal_the_in_process_client(server_pkg, transport, in_process_exchange):
    client_pkg = "port" if server_pkg == "jax" else "jax"
    app = JPersistentKVStoreApp() if server_pkg == "jax" else PersistentKVStoreApp()
    srv, _ = _server(server_pkg, transport, app)
    conns = _creator(client_pkg, transport)(f"127.0.0.1:{srv.port}")()
    try:
        # a JAX client frames the port's header and validators by their
        # wire form (`encode()`, pub_key and power)
        assert _exchange(conns) == in_process_exchange
    finally:
        _close(conns)
        srv.stop()


def _creator(pkg: str, transport: str):
    if transport == "socket":
        return (P_socket if pkg == "port" else J_socket).socket_client_creator
    P_grpc, J_grpc = _grpc_modules()
    return (P_grpc if pkg == "port" else J_grpc).grpc_client_creator


@pytest.mark.parametrize("app_cls", ["kvstore", "persistent"])
def test_handle_abci_request_answers_byte_for_byte(app_cls):
    """The same request bytes through both packages' dispatcher, on
    fresh apps of each package, give the same response bytes."""
    from tendermint_tpu.abci.apps import KVStoreApp as JKVStoreApp

    ours = KVStoreApp() if app_cls == "kvstore" else PersistentKVStoreApp()
    theirs = JKVStoreApp() if app_cls == "kvstore" else JPersistentKVStoreApp()
    header = Header(chain_id="abci-x", height=1, time=10, num_txs=2, last_block_id=BlockID.zero(),
                    validators_hash=b"\x02" * 32)
    requests = [
        Writer().uvarint(0x01).string("echo").build(),
        Writer().uvarint(0x02).build(),
        Writer().uvarint(0x0A).uvarint(1).bytes(VAL_A).uvarint(10).build(),
        Writer().uvarint(0x04).bytes(b"k=v").build(),
        Writer().uvarint(0x03).build(),
        Writer().uvarint(0x06).bytes(b"\xaa" * 32).bytes(header.encode()).build(),
        Writer().uvarint(0x05).bytes(b"k=v").build(),
        Writer().uvarint(0x05).bytes(f"val:{VAL_B.hex()}/3".encode()).build(),
        Writer().uvarint(0x07).uvarint(1).build(),
        Writer().uvarint(0x08).build(),
        Writer().uvarint(0x09).string("").bytes(b"k").uvarint(0).bool(True).build(),
        Writer().uvarint(0x02).build(),
    ]
    for req in requests:
        assert P_socket.handle_abci_request(ours, threading.Lock(), req) == J_socket.handle_abci_request(
            theirs, threading.Lock(), req)


def test_socket_server_stop_closes_its_connections():
    srv = ABCISocketServer(KVStoreApp(), "tcp://127.0.0.1:0")
    conns = socket_client_creator(f"127.0.0.1:{srv.port}")()
    assert conns.query.echo_sync("x") == "x"
    srv.stop()
    with pytest.raises(Exception):  # noqa: B017 - the closed link's error is the transport's
        conns.query.echo_sync("y")
    _close(conns)
