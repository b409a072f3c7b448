"""The port's RPC (`tendermint_tpu_torch/rpc/`) and
`certifiers/node_provider.py` against the JAX package's.

One seeded JAX chain (4 validators, `KVStoreApp`, a `KVTxIndexer`) is
held by a JAX stub node and, by its wire and JSON forms, by a port
`testing.ReadNode` (the port has no `Node` yet; a stub carries the
fields `make_routes` reads, its config the two it reads, `rpc.unsafe`
and `base.moniker`, as the JAX `tests/test_health.py` stub does). Every
route's JSON from both packages' `make_routes` must be equal, errors
included (class, code and message); `health` apart from its clocks. A
JAX `HTTPClient` against a port `RPCServer` and a port `HTTPClient`
against a JAX `RPCServer` get what the serving package's routes answer;
`NodeProvider` over each feeds a `DynamicCertifier` of the other
package; the plain-HTTP `/health`, `/metrics` and route index; the
WebSocket handshake, frames and event JSON (the JAX
`test_consensus.py::TestProposalHeartbeat::test_heartbeat_ws_event_json`
case among them) agree, and a `WSClient` of one package follows events
fired on a server of the other; the gRPC broadcast API (`grpc` imported
inside its functions) answers `Ping` and `BroadcastTx` across the
packages. `test_rpc_client.py` itself waits for the port's `Node` (ROADMAP
A8). Tolerance: exact.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu.abci.client import local_client_creator as j_local_client_creator
from tendermint_tpu.blockchain import BlockStore as JBlockStore
from tendermint_tpu.certifiers.certifier import DynamicCertifier as JDynamicCertifier
from tendermint_tpu.certifiers.node_provider import NodeProvider as JNodeProvider
from tendermint_tpu.db.kv import MemDB as JMemDB
from tendermint_tpu.lightclient.reactor import LightClientReactor as JLightClientReactor
from tendermint_tpu.mempool import Mempool as JMempool
from tendermint_tpu.rpc import RPCServer as JRPCServer
from tendermint_tpu.rpc import make_routes as j_make_routes
from tendermint_tpu.rpc import websocket as J_ws
from tendermint_tpu.rpc.client import HTTPClient as JHTTPClient
from tendermint_tpu.rpc.client import WSClient as JWSClient
from tendermint_tpu.rpc.server import RPCError as JRPCError
from tendermint_tpu.state.txindex import KVTxIndexer as JKVTxIndexer
from tendermint_tpu.types import events as j_ev
from tendermint_tpu.types.events import EventSwitch as JEventSwitch
from tendermint_tpu_torch import types as P
from tendermint_tpu_torch.abci.apps import KVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.certifiers.certifier import DynamicCertifier, FullCommit
from tendermint_tpu_torch.certifiers.node_provider import NodeProvider
from tendermint_tpu_torch.codec.binary import Reader
from tendermint_tpu_torch.db.kv import MemDB
from tendermint_tpu_torch.lightclient import LightClientReactor
from tendermint_tpu_torch.mempool import Mempool
from tendermint_tpu_torch.rpc import RPCServer, make_routes
from tendermint_tpu_torch.rpc import websocket as ws
from tendermint_tpu_torch.rpc.client import HTTPClient, LocalClient, RPCClientError, WSClient
from tendermint_tpu_torch.rpc.server import RPCError
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.txindex import KVTxIndexer
from tendermint_tpu_torch.testing import ReadNode, lockrank_report
from tendermint_tpu_torch.types import events as ev
from tendermint_tpu_torch.types.genesis import GenesisDoc

from tests.helpers import ChainSim as JChainSim

torch.set_num_threads(1)

HEIGHTS = 10
HOST = HostBatchVerifier()


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


def _txs(h):
    return [b"rpc-%d-%d=v%d" % (h, i, h + i) for i in range(h % 4 + 1)]


@pytest.fixture(scope="module")
def nodes():
    """(JAX stub node, port `ReadNode`) over one JAX chain; the port's by
    wire and JSON forms. Both mempools are closed at the end."""
    jindexer = JKVTxIndexer(JMemDB())
    jsim = JChainSim(n_vals=4)
    jstore = JBlockStore(JMemDB())
    state_jsons = [jsim.state.to_json()]
    for h in range(1, HEIGHTS + 1):
        block = jsim.advance(txs=_txs(h), tx_indexer=jindexer)
        jstore.save_block(block, block.make_part_set(), jsim.commits[-1])
        state_jsons.append(jsim.state.to_json())
    jconns = j_local_client_creator(jsim.app)()
    jmempool = JMempool(jconns.mempool)
    jnode = SimpleNamespace(
        config=SimpleNamespace(rpc=SimpleNamespace(unsafe=False), base=SimpleNamespace(moniker="readnode")),
        genesis=jsim.genesis, block_store=jstore, current_state=jsim.state, app_conns=jconns,
        mempool=jmempool, tx_indexer=jindexer, event_switch=JEventSwitch(), switch=None, consensus=None,
        consensus_reactor=None, priv_validator=None, blockchain_reactor=None, statesync_reactor=None,
        hasher=None, node_id="rpc-node", dial_seed=lambda addr: None,
    )
    jnode.lightclient_reactor = JLightClientReactor(chain_id=jsim.chain_id, block_store=jstore, state=jsim.state)
    # the port's: blocks and commits by encode(), states by JSON (every
    # height's into one DB, for the historical validator sets), the app
    # by its snapshot, the tx index by its DB items
    pdb = MemDB()
    for sj in state_jsons:
        pstate = State.from_json(sj, db=pdb)
        pstate.save()
    pstore = BlockStore(MemDB())
    for h in range(1, HEIGHTS + 1):
        b = P.Block.decode(jstore.load_block(h).encode())
        pstore.save_block(b, b.make_part_set(), P.Commit.decode_from(Reader(jstore.load_seen_commit(h).encode())))
    app = KVStoreApp()
    app.restore_state(jsim.app.snapshot_state())
    pindex_db = MemDB()
    for k, v in jindexer._db.iterate(b""):
        pindex_db.set(k, v)
    pnode = ReadNode(GenesisDoc.from_json(jsim.genesis.to_json()), pstate, pstore, app, "rpc-node",
                     tx_indexer=KVTxIndexer(pindex_db),
                     lightclient_reactor=LightClientReactor(chain_id=jsim.chain_id, block_store=pstore, state=pstate))
    pnode.mempool = Mempool(pnode.app_conns.mempool)
    yield jnode, pnode
    jmempool.close()
    pnode.mempool.close()


def _call(routes, name, params):
    """A route's result as JSON text, or its error as (class, code,
    message)."""
    try:
        return json.dumps(routes[name](**params), sort_keys=True)
    except (RPCError, JRPCError) as e:
        return type(e).__name__, e.code, e.message


ROUTE_CASES = [
    ("status", {}),
    ("net_info", {}),
    ("block", {"height": 3}),
    ("block", {"height": "7"}),
    ("block", {"height": 99}),
    ("blockchain", {}),
    ("blockchain", {"min_height": 2, "max_height": 5}),
    ("commit", {"height": 4}),
    ("commit", {"height": HEIGHTS}),
    ("commit", {"height": 77}),
    ("full_commit", {"height": 5}),
    ("full_commit", {"height": 0}),
    ("full_commit", {"height": 500}),
    ("validators", {}),
    ("validators", {"height": 2}),
    ("abci_query", {"data": b"rpc-3-0".hex()}),
    ("abci_query", {"data": b"missing".hex(), "prove": True}),
    ("abci_info", {}),
    ("num_unconfirmed_txs", {}),
    ("unconfirmed_txs", {}),
    ("tx", {"hash": None}),
    ("tx", {"hash": None, "prove": True}),
    ("tx", {"hash": "00" * 32}),
    ("genesis", {}),
    ("dump_consensus_state", {}),
]


@pytest.mark.parametrize("name,params", ROUTE_CASES, ids=[f"{n}-{i}" for i, (n, _p) in enumerate(ROUTE_CASES)])
def test_route_json_equals_the_jax_routes(nodes, name, params):
    from tendermint_tpu_torch.types.tx import tx_hash

    jnode, pnode = nodes
    params = dict(params)
    if params.get("hash", "") is None:
        params["hash"] = tx_hash(_txs(6)[1]).hex()
    assert _call(make_routes(pnode), name, params) == _call(j_make_routes(jnode), name, params)


def test_route_tables_equal_the_jax_tables(nodes):
    jnode, pnode = nodes
    assert sorted(make_routes(pnode)) == sorted(j_make_routes(jnode))
    pnode.config.rpc.unsafe = jnode.config.rpc.unsafe = True
    try:
        assert sorted(make_routes(pnode)) == sorted(j_make_routes(jnode))
        assert "unsafe_flush_mempool" in make_routes(pnode)
    finally:
        pnode.config.rpc.unsafe = jnode.config.rpc.unsafe = False


def _unclocked(h):
    """`build_health` output without its clocks."""
    h = json.loads(json.dumps(h))
    h["device"].pop("last_launch_age_s", None)
    h["checks"]["commit_lag"].pop("lag_s", None)
    return h


def test_health_route_equals_the_jax_route_apart_from_clocks(nodes):
    jnode, pnode = nodes
    assert _unclocked(make_routes(pnode)["health"]()) == _unclocked(j_make_routes(jnode)["health"]())


def test_broadcast_tx_sync_and_the_pool_agree(nodes):
    jnode, pnode = nodes
    tx = b"broadcast-key=broadcast-value"
    got = make_routes(pnode)["broadcast_tx_sync"](tx=tx.hex())
    want = j_make_routes(jnode)["broadcast_tx_sync"](tx=tx.hex())
    assert got == want
    for name in ("num_unconfirmed_txs", "unconfirmed_txs"):
        assert _call(make_routes(pnode), name, {}) == _call(j_make_routes(jnode), name, {})
    bad = "zz"
    assert _call(make_routes(pnode), "broadcast_tx_sync", {"tx": bad}) == _call(
        j_make_routes(jnode), "broadcast_tx_sync", {"tx": bad})
    for mp in (pnode.mempool, jnode.mempool):
        mp.flush()


def test_dump_telemetry_has_the_jax_shape(nodes):
    """The dump's metric values are each package's process-wide registry;
    its sections, breakers and views are the same."""
    jnode, pnode = nodes
    params = {"spans": 4, "launches": 4, "profile": 1, "gossip": 1, "flight": 1, "heights": 1}
    got = make_routes(pnode)["dump_telemetry"](**params)
    want = j_make_routes(jnode)["dump_telemetry"](**params)
    assert sorted(got) == sorted(want)
    assert got["breakers"] == want["breakers"]
    assert sorted(got["launches"]) == sorted(want["launches"])
    assert sorted(got["profile"]) == sorted(want["profile"])


def test_unsafe_and_broadcast_routes_equal_the_jax_routes(nodes):
    jnode, pnode = nodes
    pnode.config.rpc.unsafe = jnode.config.rpc.unsafe = True
    try:
        proutes, jroutes = make_routes(pnode), j_make_routes(jnode)
        for seeds in ("", " , "):
            assert _call(proutes, "dial_seeds", {"seeds": seeds}) == _call(jroutes, "dial_seeds", {"seeds": seeds})
        tx = b"async-key=async-value"
        assert _call(proutes, "broadcast_tx_async", {"tx": tx.hex()}) == _call(
            jroutes, "broadcast_tx_async", {"tx": tx.hex()})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (pnode.mempool.size(), jnode.mempool.size()) != (1, 1):
            time.sleep(0.02)
        assert _call(proutes, "unconfirmed_txs", {}) == _call(jroutes, "unconfirmed_txs", {})
        assert _call(proutes, "unsafe_flush_mempool", {}) == _call(jroutes, "unsafe_flush_mempool", {})
        assert _call(proutes, "num_unconfirmed_txs", {}) == _call(jroutes, "num_unconfirmed_txs", {})
        threads = proutes["unsafe_dump_threads"]()
        assert threads["count"] == len(threads["threads"]) >= 1
    finally:
        pnode.config.rpc.unsafe = jnode.config.rpc.unsafe = False


def test_dump_telemetry_serves_the_ports_launch_ledger(nodes):
    from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG

    _jnode, pnode = nodes
    out = make_routes(pnode)["dump_telemetry"](launches=8, profile=1, flight=2)
    assert out["launches"]["records"] == LAUNCHLOG.recent(8)
    assert set(out["profile"]) == {"profiler", "locks", "queues"}
    assert "tendermint_rpc_requests_total" in out["metrics"]
    assert isinstance(out["flight"], list)


@pytest.fixture(scope="module")
def servers(nodes):
    """Both packages' `RPCServer`s on localhost, with their event
    switches for WebSocket subscriptions."""
    jnode, pnode = nodes
    psrv = RPCServer(make_routes(pnode), "tcp://127.0.0.1:0", event_switch=pnode.event_switch)
    jsrv = JRPCServer(j_make_routes(jnode), "tcp://127.0.0.1:0", event_switch=jnode.event_switch)
    psrv.start()
    jsrv.start()
    yield psrv, jsrv
    psrv.stop()
    jsrv.stop()


CLIENT_CALLS = [
    ("status", ()), ("block", (5,)), ("commit", (6,)), ("validators", (3,)), ("abci_info", ()),
    ("genesis", ()), ("blockchain", (1, 4)), ("abci_query", ("", b"rpc-2-1")),
]


@pytest.mark.parametrize("method,args", CLIENT_CALLS, ids=[m for m, _a in CLIENT_CALLS])
def test_clients_across_the_packages(servers, nodes, method, args):
    """A JAX `HTTPClient` on the port's server and a port `HTTPClient` on
    the JAX server get what the serving routes answer in process."""
    psrv, jsrv = servers
    jnode, pnode = nodes
    want = getattr(LocalClient(pnode), method)(*args)
    assert getattr(JHTTPClient(f"127.0.0.1:{psrv.port}"), method)(*args) == json.loads(json.dumps(want))
    assert getattr(HTTPClient(f"127.0.0.1:{jsrv.port}"), method)(*args) == json.loads(json.dumps(want))
    assert getattr(HTTPClient(f"127.0.0.1:{psrv.port}"), method)(*args) == json.loads(json.dumps(want))


def test_errors_cross_the_packages_alike(servers):
    psrv, jsrv = servers
    from tendermint_tpu.rpc.client import RPCClientError as JRPCClientError

    with pytest.raises(JRPCClientError) as je:
        JHTTPClient(f"127.0.0.1:{psrv.port}").block(404)
    with pytest.raises(RPCClientError) as pe:
        HTTPClient(f"127.0.0.1:{jsrv.port}").block(404)
    assert (je.value.code, str(je.value)) == (pe.value.code, str(pe.value)) == (-32000, "[-32000] no block at height 404")
    with pytest.raises(RPCClientError) as pe:
        HTTPClient(f"127.0.0.1:{psrv.port}")._call("no_such_route")
    with pytest.raises(JRPCClientError) as je:
        JHTTPClient(f"127.0.0.1:{jsrv.port}")._call("no_such_route")
    assert str(pe.value) == str(je.value)


def test_plain_http_health_metrics_and_index(servers):
    psrv, jsrv = servers
    bodies = []
    for port in (psrv.port, jsrv.port):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=10) as r:
            assert r.status == 200
            bodies.append(_unclocked(json.load(r)))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            bodies.append(json.load(r))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert b"tendermint_rpc_requests_total" in r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/block?height=2", timeout=10) as r:
            bodies.append(json.load(r))
    assert bodies[:3] == bodies[3:]


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_node_provider_feeds_a_certifier_across_the_packages(servers, nodes, direction):
    psrv, jsrv = servers
    jnode, pnode = nodes
    if direction == "jax_client_port_server":
        provider = JNodeProvider(JHTTPClient(f"127.0.0.1:{psrv.port}"))
        cert = JDynamicCertifier(jnode.genesis.chain_id, jnode.genesis.validator_set(), 1)
    else:
        provider = NodeProvider(HTTPClient(f"127.0.0.1:{jsrv.port}"))
        cert = DynamicCertifier(pnode.genesis.chain_id, pnode.genesis.validator_set(), 1, HOST)
    for h in range(2, HEIGHTS + 1):
        fc = provider.get_by_height(h)
        assert fc.height() == h
        assert fc.header.hash() == jnode.block_store.load_block(h).hash()
        cert.certify(fc)
    # the floor contract: a height past the tip answers the tip
    assert provider.get_by_height(HEIGHTS + 5).height() == HEIGHTS
    assert provider.latest_commit().height() == HEIGHTS


def test_node_providers_agree_byte_for_byte(servers):
    psrv, _jsrv = servers
    pp = NodeProvider(HTTPClient(f"127.0.0.1:{psrv.port}"))
    jp = JNodeProvider(JHTTPClient(f"127.0.0.1:{psrv.port}"))
    for h in (1, 4, HEIGHTS, HEIGHTS + 3):
        assert pp.get_by_height(h).encode() == jp.get_by_height(h).encode()
    full = HTTPClient(f"127.0.0.1:{psrv.port}")._call("full_commit", height=4)
    assert FullCommit.decode(bytes.fromhex(full["full_commit"])).encode() == pp.get_by_height(4).encode()


# -- websocket ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 5, 125, 126, 300, 65535, 65536, 70000])
def test_websocket_frames_equal_the_jax_codec(n):
    import io

    payload = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    assert ws.encode_frame(payload) == J_ws.encode_frame(payload)
    assert ws.encode_frame(payload, opcode=0x2) == J_ws.encode_frame(payload, opcode=0x2)
    masked = J_ws.encode_frame(payload, mask=True)
    assert ws.read_frame(io.BytesIO(masked)) == J_ws.read_frame(io.BytesIO(masked)) == (0x1, payload)
    pmasked = ws.encode_frame(payload, mask=True)
    assert J_ws.read_frame(io.BytesIO(pmasked)) == (0x1, payload)
    assert ws.read_frame(io.BytesIO(masked[:1])) is J_ws.read_frame(io.BytesIO(masked[:1])) is None


def test_websocket_accept_key_equals_the_jax_key():
    for key in ("dGhlIHNhbXBsZSBub25jZQ==", "AAAAAAAAAAAAAAAAAAAAAA==", "x"):
        assert ws.accept_key(key) == J_ws.accept_key(key)
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_heartbeat_ws_event_json():
    """The JAX `test_consensus.py::TestProposalHeartbeat` case, on the
    port: WS subscribers see heartbeats as the compact JSON view."""
    from tendermint_tpu_torch.types.heartbeat import Heartbeat

    hb = Heartbeat(validator_address=b"\xab" * 20, validator_index=1, height=5, round=0, sequence=3,
                   signature=b"\x01" * 64)
    out = ws.event_to_json(ev.EVENT_PROPOSAL_HEARTBEAT, hb)
    assert out == {"event": ev.EVENT_PROPOSAL_HEARTBEAT, "height": 5, "round": 0, "sequence": 3,
                   "validator": (b"\xab" * 20).hex()}


def test_event_json_equals_the_jax_events(nodes):
    from tendermint_tpu.types.heartbeat import Heartbeat as JHeartbeat
    from tendermint_tpu_torch.types.heartbeat import Heartbeat

    jnode, pnode = nodes
    jblock, pblock = jnode.block_store.load_block(3), pnode.block_store.load_block(3)
    jvote, pvote = jnode.block_store.load_seen_commit(3).precommits[1], pnode.block_store.load_seen_commit(3).precommits[1]
    cases = [
        (ev.EVENT_NEW_BLOCK, ev.EventDataNewBlock(pblock), j_ev.EventDataNewBlock(jblock)),
        (ev.EVENT_NEW_BLOCK_HEADER, ev.EventDataNewBlockHeader(pblock.header),
         j_ev.EventDataNewBlockHeader(jblock.header)),
        (ev.EVENT_TX, ev.EventDataTx(3, b"tx-bytes", b"d", "ok", 0), j_ev.EventDataTx(3, b"tx-bytes", b"d", "ok", 0)),
        (ev.EVENT_VOTE, ev.EventDataVote(pvote), j_ev.EventDataVote(jvote)),
        (ev.EVENT_NEW_ROUND, ev.EventDataRoundState(4, 1, "propose"), j_ev.EventDataRoundState(4, 1, "propose")),
        (ev.EVENT_PROPOSAL_HEARTBEAT,
         Heartbeat(validator_address=b"\x01" * 20, validator_index=0, height=2, round=1, sequence=9),
         JHeartbeat(validator_address=b"\x01" * 20, validator_index=0, height=2, round=1, sequence=9)),
    ]
    for name, pdata, jdata in cases:
        assert ws.event_to_json(name, pdata) == J_ws.event_to_json(name, jdata)
    assert ws.event_to_json("Other", None) == J_ws.event_to_json("Other", None)


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_websocket_subscription_across_the_packages(servers, nodes, direction):
    psrv, jsrv = servers
    jnode, pnode = nodes
    if direction == "jax_client_port_server":
        client, fire, block = JWSClient(f"127.0.0.1:{psrv.port}", reconnect=False), pnode.event_switch, \
            pnode.block_store.load_block(4)
        data = ev.EventDataNewBlock(block)
    else:
        client, fire, block = WSClient(f"127.0.0.1:{jsrv.port}", reconnect=False), jnode.event_switch, \
            jnode.block_store.load_block(4)
        data = j_ev.EventDataNewBlock(block)
    try:
        client.subscribe("NewBlock")
        deadline = time.monotonic() + 10
        got = []

        def pump():
            got.extend(list(_take(client.events(timeout=5), 1)))

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        while t.is_alive() and time.monotonic() < deadline:
            fire.fire("NewBlock", data)
            t.join(0.1)
        assert got and got[0] == ws.event_to_json("NewBlock", ev.EventDataNewBlock(pnode.block_store.load_block(4)))
    finally:
        client.close()


def _take(gen, n):
    out = []
    for item in gen:
        out.append(item)
        if len(out) >= n:
            break
    return out


# -- grpc ------------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_grpc_broadcast_across_the_packages(nodes, direction):
    """`Ping` and `BroadcastTx` of the gRPC API between the packages; the
    tx's commit is played by firing its event on the serving node's
    switch once it is in the pool."""
    pytest.importorskip("grpc")
    from tendermint_tpu.rpc.grpc_api import GRPCBroadcastClient as JClient
    from tendermint_tpu.rpc.grpc_api import GRPCBroadcastServer as JServer
    from tendermint_tpu_torch.rpc.grpc_api import GRPCBroadcastClient, GRPCBroadcastServer
    from tendermint_tpu_torch.types.tx import tx_hash

    jnode, pnode = nodes
    if direction == "jax_client_port_server":
        node, srv_cls, cli_cls, data_cls = pnode, GRPCBroadcastServer, JClient, ev.EventDataTx
    else:
        node, srv_cls, cli_cls, data_cls = jnode, JServer, GRPCBroadcastClient, j_ev.EventDataTx
    srv = srv_cls(node, "tcp://127.0.0.1:0")
    srv.start()
    tx = f"grpc-{direction}=val".encode()
    stop = threading.Event()

    def commit_when_pooled():
        while not stop.is_set():
            if node.mempool.size() > 0:
                node.event_switch.fire(ev.event_tx(tx_hash(tx)), data_cls(HEIGHTS + 1, tx, b"ok", "", 0))
            time.sleep(0.02)

    t = threading.Thread(target=commit_when_pooled, daemon=True)
    t.start()
    cli = cli_cls(f"127.0.0.1:{srv.port}")
    try:
        assert cli.ping()
        res = cli.broadcast_tx(tx, timeout=30)
        assert res == {"check_tx": {"code": 0, "log": ""},
                       "deliver_tx": {"code": 0, "data": b"ok", "log": ""}, "height": HEIGHTS + 1}
    finally:
        stop.set()
        t.join(5)
        cli.close()
        srv.stop()
        node.mempool.flush()


def test_rpc_metric_families_are_cataloged():
    from tendermint_tpu_torch.telemetry import REGISTRY

    assert REGISTRY.get("tendermint_rpc_requests_total") is not None
    assert REGISTRY.get("tendermint_rpc_request_seconds") is not None
