"""The JAX package's `tests/test_rpc_client.py` on the port's own node
(`tendermint_tpu_torch/node/node.py` on the CPU, `device="cpu"`): the
HTTP and local clients, `genesis`, `abci_info`, `unconfirmed_txs`,
`tx?prove=true` against the block's data hash, `NodeProvider` feeding
an `InquiringCertifier`, the unsafe routes (flush, dial, profiler,
threads) and their gate, the WebSocket subscription with its redial and
resubscribe, the `Tx:` event subscription and the gRPC broadcast API
(`grpc` imported inside its functions). The same assertions as the JAX
file's, on the port's classes. Tolerance: exact.
"""

import json

import pytest

from tendermint_tpu_torch.cmd import main as cli_main
from tendermint_tpu_torch.config import Config
from tendermint_tpu_torch.node import Node
from tendermint_tpu_torch.rpc.client import HTTPClient, LocalClient, RPCClientError
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture


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


@pytest.fixture()
def solo_node(tmp_path):
    home = str(tmp_path / "solo")
    cli_main(["init", "--home", home, "--chain-id", "client-test"])
    cfg = Config.test_config(home)
    cfg.base.fast_sync = False
    node = Node(cfg, device="cpu")
    node.start()
    yield node
    node.stop()


class TestClients:
    @pytest.mark.parametrize("kind", ["http", "local"])
    def test_client_interface(self, solo_node, kind):
        c = (
            HTTPClient(f"127.0.0.1:{solo_node.rpc_port}")
            if kind == "http"
            else LocalClient(solo_node)
        )
        res = c.broadcast_tx_commit(b"ck=cv")
        assert res["deliver_tx"]["code"] == 0
        st = c.status()
        assert st["sync_info"]["latest_block_height"] >= 1
        q = c.abci_query(data=b"ck")
        assert bytes.fromhex(q["value"]) == b"cv"
        blk = c.block(res["height"])
        assert blk["block"]["header"]["height"] == res["height"]
        assert len(c.validators()["validators"]) == 1
        assert c.net_info()["n_peers"] == 0
        with pytest.raises(RPCClientError):
            c.block(10_000)

    def test_genesis_round_trip(self, solo_node):
        c = LocalClient(solo_node)
        g = c.genesis()["genesis"]
        assert g["chain_id"] == "client-test"

    def test_abci_info_route(self, solo_node):
        """Reference `rpc/core/abci.go:36-42` ABCIInfo, route `routes.go:30`."""
        c = HTTPClient(f"127.0.0.1:{solo_node.rpc_port}")
        solo_node.wait_height(1)
        info = c.abci_info()
        assert "data" in info and "last_block_height" in info
        assert info["last_block_height"] >= 0

    def test_unconfirmed_txs_route(self, solo_node):
        """Reference UnconfirmedTxs (`rpc/core/mempool.go`, `routes.go:22`)."""
        c = LocalClient(solo_node)
        # park a tx that can't commit instantly by pausing consensus? simpler:
        # check_tx into the mempool directly, then list before the next block
        c.broadcast_tx_async(b"uk=uv")
        res = c.unconfirmed_txs()
        assert res["n_txs"] >= 0  # may already be reaped into a block
        if res["n_txs"]:
            assert b"uk=uv".hex() in res["txs"]

    def test_tx_prove_serves_valid_txproof(self, solo_node):
        """`tx?prove=true` returns an inclusion proof that validates against
        the block's data_hash (reference `rpc/core/tx.go` +
        `types/tx.go:71-112`)."""
        from tendermint_tpu_torch.merkle.simple import SimpleProof
        from tendermint_tpu_torch.types.tx import TxProof

        c = HTTPClient(f"127.0.0.1:{solo_node.rpc_port}")
        res = c.broadcast_tx_commit(b"pk=pv")
        assert res["deliver_tx"]["code"] == 0
        tx_hash = bytes.fromhex(res["hash"])
        got = c.tx(tx_hash, prove=True)
        assert got["height"] == res["height"]
        pj = got["proof"]
        proof = TxProof(
            root_hash=bytes.fromhex(pj["root_hash"]),
            data=bytes.fromhex(pj["data"]),
            proof=SimpleProof(
                index=int(pj["proof"]["index"]),
                total=int(pj["proof"]["total"]),
                leaf=bytes.fromhex(pj["proof"]["leaf"]),
                aunts=[bytes.fromhex(a) for a in pj["proof"]["aunts"]],
            ),
        )
        blk = c.block(res["height"])
        data_hash = bytes.fromhex(blk["block"]["header"]["data_hash"])
        assert proof.validate(data_hash)
        assert proof.data == b"pk=pv"
        # without prove, no proof key
        assert "proof" not in c.tx(tx_hash)

    def test_node_provider_feeds_light_client(self, solo_node):
        """An external light client certifies straight off a live node's
        RPC (reference certifiers/client/provider.go): NodeProvider
        fetches header+commit+valset, the Inquiring certifier verifies."""
        from tendermint_tpu_torch.certifiers import InquiringCertifier
        from tendermint_tpu_torch.certifiers.node_provider import NodeProvider
        from tendermint_tpu_torch.certifiers.provider import MemProvider

        solo_node.wait_height(3)
        c = LocalClient(solo_node)
        prov = NodeProvider(c)
        latest = prov.latest_commit()
        assert latest is not None and latest.height() >= 1
        # the RPC round-trip must preserve hash integrity
        assert latest.header.validators_hash == latest.validators.hash()
        seed = prov.get_by_height(1)
        assert seed is not None and seed.height() >= 1
        # the node's own stack on the CPU: a port certifier given no
        # verifier takes the card's
        cert = InquiringCertifier("client-test", seed, MemProvider(), prov, verifier=solo_node.consensus.verifier)
        cert.certify(latest)

    def test_unsafe_flush_mempool_and_dial_seeds_routes(self, solo_node):
        from tendermint_tpu_torch.rpc.core import make_routes

        solo_node.config.rpc.unsafe = True
        routes = make_routes(solo_node)
        assert routes["unsafe_flush_mempool"]() == {"result": "flushed"}
        with pytest.raises(Exception):
            routes["dial_seeds"](seeds="")
        # dialing an unreachable seed must not raise (background thread)
        routes["dial_seeds"](seeds="127.0.0.1:1")


class TestWALTools:
    def test_wal2json_and_cut(self, tmp_path, capsys, solo_node):
        solo_node.wait_height(3)
        wal = solo_node.config.wal_path()
        capsys.readouterr()  # drain fixture-setup output (init message)
        assert cli_main(["wal2json", wal]) == 0
        lines = [
            json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()
        ]
        kinds = {rec["type"] for rec in lines}
        assert "end_height" in kinds and "msg" in kinds
        heights = [r["height"] for r in lines if r["type"] == "end_height"]
        assert max(heights) >= 2

        out = str(tmp_path / "cut.wal")
        assert cli_main(["cut_wal_until", wal, "2", out]) == 0
        capsys.readouterr()
        assert cli_main(["wal2json", out]) == 0
        cut_lines = [
            json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()
        ]
        assert all(
            rec.get("height", 0) < 2 or rec["type"] == "round_state"
            for rec in cut_lines
        ), cut_lines


class TestUnsafeRoutes:
    def test_profiling_and_introspection(self, tmp_path):
        home = str(tmp_path / "unsafe")
        cli_main(["init", "--home", home, "--chain-id", "unsafe-test"])
        cfg = Config.test_config(home)
        cfg.base.fast_sync = False
        cfg.rpc.unsafe = True
        node = Node(cfg, device="cpu")
        node.start()
        try:
            c = LocalClient(node)
            assert c._call("unsafe_start_cpu_profiler", interval_ms=2)["started"]
            import time

            time.sleep(0.3)  # sampler sees the live node threads
            stopped = c._call("unsafe_stop_cpu_profiler")
            assert stopped["samples"] > 10
            assert stopped["profile"] and "where" in stopped["profile"][0]
            threads = c._call("unsafe_dump_threads")
            assert threads["count"] > 3  # consensus/ticker/rpc threads live
            assert any(v for v in threads["threads"].values())  # real stacks
        finally:
            node.stop()

    def test_unsafe_routes_gated(self, solo_node):
        c = LocalClient(solo_node)
        with pytest.raises(RPCClientError, match="unknown method"):
            c._call("unsafe_dump_threads")


class TestWebSocketSubscribe:
    def test_subscribe_receives_new_block_events(self, solo_node):
        from tendermint_tpu_torch.rpc.client import WSClient

        ws = WSClient(f"127.0.0.1:{solo_node.rpc_port}")
        try:
            ws.subscribe("NewBlock")
            got = []
            for ev in ws.events(timeout=30):
                got.append(ev)
                if len(got) >= 2:
                    break
            assert len(got) >= 2
            assert got[0]["event"] == "NewBlock"
            assert got[1]["height"] > got[0]["height"]
            assert len(got[0]["hash"]) == 64
        finally:
            ws.close()

    def test_ws_client_reconnects_and_resubscribes(self, solo_node):
        """Kill the WS server mid-stream: the client must transparently
        redial with backoff, re-issue its subscriptions, and keep yielding
        events (reference `rpc/lib/client/ws_client.go:46-59`)."""
        from tendermint_tpu_torch.rpc.client import WSClient
        from tendermint_tpu_torch.rpc.core import make_routes
        from tendermint_tpu_torch.rpc.server import RPCServer

        port = solo_node.rpc_port
        ws = WSClient(f"127.0.0.1:{port}", reconnect_base_backoff_s=0.05)
        try:
            ws.subscribe("NewBlock")
            first = list(_take(ws.events(timeout=30), 1))
            assert first and first[0]["event"] == "NewBlock"

            # bounce the whole RPC server on the same port
            solo_node.rpc.stop()
            solo_node.rpc = RPCServer(
                make_routes(solo_node),
                f"tcp://127.0.0.1:{port}",
                event_switch=solo_node.event_switch,
            )
            solo_node.rpc.start()

            # the dead conn must heal (resubscribe included) inside events()
            healed = list(_take(ws.events(timeout=30), 2))
            assert len(healed) == 2
            assert all(e["event"] == "NewBlock" for e in healed)
            assert healed[0]["height"] > first[0]["height"]
        finally:
            ws.close()

    def test_ws_client_reconnect_disabled_dies_with_conn(self, solo_node):
        from tendermint_tpu_torch.rpc.client import WSClient
        from tendermint_tpu_torch.rpc.core import make_routes
        from tendermint_tpu_torch.rpc.server import RPCServer

        port = solo_node.rpc_port
        ws = WSClient(f"127.0.0.1:{port}", reconnect=False)
        try:
            ws.subscribe("NewBlock")
            solo_node.rpc.stop()
            solo_node.rpc = RPCServer(
                make_routes(solo_node),
                f"tcp://127.0.0.1:{port}",
                event_switch=solo_node.event_switch,
            )
            solo_node.rpc.start()
            # already-buffered frames may still drain, but the stream must
            # END promptly instead of healing into a live one (healing
            # would keep yielding new blocks until the 30s quiet timeout).
            # A dead conn on a non-closed client is a hard error, so the
            # caller can tell "no events" from "connection lost".
            import time as _t

            t0 = _t.monotonic()
            with pytest.raises(RPCClientError):
                list(ws.events(timeout=30))
            assert _t.monotonic() - t0 < 10
        finally:
            ws.close()

    def test_tx_event_subscription(self, solo_node):
        import threading

        from tendermint_tpu_torch.rpc.client import HTTPClient, WSClient
        from tendermint_tpu_torch.types.tx import tx_hash

        raw = b"ws-key=ws-val"
        ws = WSClient(f"127.0.0.1:{solo_node.rpc_port}")
        try:
            ws.subscribe(f"Tx:{tx_hash(raw).hex()}")
            c = HTTPClient(f"127.0.0.1:{solo_node.rpc_port}")
            threading.Thread(
                target=lambda: c.broadcast_tx_commit(raw), daemon=True
            ).start()
            events = list(_take(ws.events(timeout=30), 1))
            assert events and events[0]["code"] == 0
            assert bytes.fromhex(events[0]["tx"]) == raw
        finally:
            ws.close()


def _take(gen, n):
    out = []
    for item in gen:
        out.append(item)
        if len(out) >= n:
            break
    return out


class TestGRPCBroadcast:
    def test_ping_and_broadcast_tx(self, tmp_path):
        from tendermint_tpu_torch.rpc.grpc_api import GRPCBroadcastClient

        home = str(tmp_path / "grpc")
        cli_main(["init", "--home", home, "--chain-id", "grpc-test"])
        cfg = Config.test_config(home)
        cfg.base.fast_sync = False
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
        node = Node(cfg, device="cpu")
        node.start()
        try:
            c = GRPCBroadcastClient(f"127.0.0.1:{node.grpc.port}")
            assert c.ping()
            res = c.broadcast_tx(b"grpc-key=grpc-val")
            assert res["deliver_tx"]["code"] == 0
            assert res["height"] >= 1
            q = LocalClient(node).abci_query(data=b"grpc-key")
            assert bytes.fromhex(q["value"]) == b"grpc-val"
            c.close()
        finally:
            node.stop()
