"""The port's own node (`tendermint_tpu_torch/node/node.py`) on the CPU
(`device="cpu"`), in process and as `python -m tendermint_tpu_torch node`
processes, against the JAX package's.

The JAX package's own cases run again on the port: `tests/test_node.py`
(a solo node commits and serves RPC, four nodes over TCP, persistent
peers reconnect after a drop, a SIGKILLed node process restarts and
resumes its chain), `tests/test_multiprocess.py::TestSubprocessTestnet`
(four node processes from `testnet` commit a tx), `tests/test_health.py::
TestHealthRoute` (on a port node in place of the nemesis net),
`tests/test_p2p.py::TestPersistentAddrMatching` and
`tests/test_abci_socket.py::test_node_runs_against_remote_app`. The
node's links are SecretConnections on the port's own cipher.

Across the packages: two JAX and two port `Node`s from one `testnet`
output commit byte-equal blocks with equal app hashes over TCP (the JAX
TCP write lock takes the port's `seq=1`, as in `test_torch_p2p.py`);
the solo node answers every route of `make_routes`; `/metrics` and
`dump_telemetry` read the port's registry (`PROCESS_*` and
`bind_node_gauges` included), not the JAX package's; a node process has
neither jax nor anything of `tendermint_tpu` in `sys.modules` when it
exits. Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from tendermint_tpu.p2p import tcp as J_tcp
from tendermint_tpu.utils import lockrank as J_lockrank
from tendermint_tpu_torch.cmd import main as cli_main
from tendermint_tpu_torch.config import Config, load_config
from tendermint_tpu_torch.node import Node
from tendermint_tpu_torch.p2p.peer import NodeInfo
from tendermint_tpu_torch.rpc.client import HTTPClient, LocalClient
from tendermint_tpu_torch.telemetry import REGISTRY
from tendermint_tpu_torch.testing import first_line, lockrank_report, time_limit_fixture

REPO = pathlib.Path(__file__).resolve().parents[1]


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
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(300))


def rpc(port, method, timeout=90, **params):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=json.dumps({"jsonrpc": "2.0", "id": 1, "method": method, "params": params}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.load(resp)
    if "error" in out:
        raise RuntimeError(out["error"])
    return out["result"]


def wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("PYTHONSTARTUP", None)
    return env


def _net_config(home: str) -> Config:
    """`Config.test_config` with the default consensus timeouts, fixed:
    the test timeouts (10 ms votes), and timeouts derived from the
    faster heights of solo nodes earlier in this process, expire before
    a node of several validators checks its votes, which the port's
    host path does in pure Python (about 5 ms a signature), and rounds
    never end."""
    from tendermint_tpu_torch.consensus.config import ConsensusConfig

    cfg = Config.test_config(home)
    cfg.consensus = ConsensusConfig(adaptive_timeouts=False)
    return cfg


def _solo_node(tmp_path, name="solo", fast_sync=False, unsafe=False, **kwargs) -> Node:
    home = str(tmp_path / name)
    cli_main(["init", "--home", home, "--chain-id", f"{name}-test"])
    cfg = Config.test_config(home)
    cfg.base.fast_sync = fast_sync
    cfg.rpc.unsafe = unsafe
    node = Node(cfg, device="cpu", **kwargs)
    node.start()
    return node


# -- tests/test_node.py --------------------------------------------------------------


class TestSoloNode:
    def test_commits_and_serves_rpc(self, tmp_path):
        node = _solo_node(tmp_path)
        try:
            port = node.rpc_port
            tx = b"rpc-key=rpc-val".hex()
            res = rpc(port, "broadcast_tx_commit", tx=tx)
            assert res["deliver_tx"]["code"] == 0
            assert res["height"] >= 1
            status = rpc(port, "status")
            assert status["sync_info"]["latest_block_height"] >= res["height"] - 1
            q = rpc(port, "abci_query", path="", data=b"rpc-key".hex())
            assert bytes.fromhex(q["value"]) == b"rpc-val"
            blk = rpc(port, "block", height=res["height"])
            assert blk["block"]["header"]["height"] == res["height"]
            vals = rpc(port, "validators")
            assert len(vals["validators"]) == 1
            found = rpc(port, "tx", hash=res["hash"])
            assert bytes.fromhex(found["tx"]) == b"rpc-key=rpc-val"
        finally:
            node.stop()

    def test_serves_every_route(self, tmp_path):
        """Each route of the port's `make_routes` over HTTP on a live
        node (the unsafe ones on), with the route names the JAX
        package's `make_routes` serves."""
        from types import SimpleNamespace

        from tendermint_tpu.rpc.core import make_routes as J_make_routes
        from tendermint_tpu_torch.rpc.core import make_routes

        node = _solo_node(tmp_path, unsafe=True)
        try:
            res = rpc(node.rpc_port, "broadcast_tx_commit", tx=b"every=route".hex())
            node.wait_height(res["height"] + 1)
            h = res["height"]
            args = {
                "block": {"height": h}, "commit": {"height": h}, "validators": {"height": h},
                "blockchain": {"min_height": 1, "max_height": h}, "tx": {"hash": res["hash"]},
                "abci_query": {"data": b"every".hex()}, "broadcast_tx_async": {"tx": b"a=1".hex()},
                "broadcast_tx_sync": {"tx": b"s=1".hex()}, "broadcast_tx_commit": {"tx": b"c=1".hex()},
                "dump_telemetry": {"spans": 8, "heights": 2, "launches": 4}, "dial_seeds": {"seeds": "127.0.0.1:1"},
                "unsafe_start_cpu_profiler": {"interval_ms": 5},
            }
            routes = make_routes(node)
            jax_stub = SimpleNamespace(config=SimpleNamespace(rpc=SimpleNamespace(unsafe=True)))
            assert sorted(routes) == sorted(J_make_routes(jax_stub))
            served = {}
            for name in sorted(routes):
                if name == "unsafe_stop_cpu_profiler":
                    continue  # after its start, below
                served[name] = rpc(node.rpc_port, name, **args.get(name, {}))
            served["unsafe_stop_cpu_profiler"] = rpc(node.rpc_port, "unsafe_stop_cpu_profiler")
            # the first heap call started tracemalloc; the second snapshots and stops it
            assert served["unsafe_heap_summary"]["started"]
            assert rpc(node.rpc_port, "unsafe_heap_summary")["top"]
            assert served["block"]["block"]["header"]["height"] == h
            assert bytes.fromhex(served["abci_query"]["value"]) == b"route"
            assert served["broadcast_tx_commit"]["deliver_tx"]["code"] == 0
            assert served["genesis"]["genesis"]["chain_id"] == "solo-test"
            assert served["health"]["status"] in ("ok", "degraded")
            assert set(served["dump_telemetry"]) >= {"metrics", "spans", "breakers", "heights", "launches"}
        finally:
            node.stop()


class TestTcpTestnet:
    def test_four_nodes_over_tcp(self, tmp_path):
        out = str(tmp_path / "net")
        cli_main(["testnet", "--n", "4", "--output", out, "--starting-port", "0"])
        nodes = []
        try:
            for i in range(4):
                cfg = _net_config(os.path.join(out, f"node{i}"))
                cfg.base.moniker = f"node{i}"
                nodes.append(Node(cfg, device="cpu"))
            for n in nodes:
                n.start()
            from tendermint_tpu_torch.p2p.tcp import dial

            for i in range(4):
                for j in range(i + 1, 4):
                    try:
                        dial(nodes[i].switch, f"127.0.0.1:{nodes[j].p2p_port}", priv_key=nodes[i]._node_key)
                    except ValueError as e:
                        # event-driven PEX may have meshed the pair first
                        if "duplicate peer" not in str(e):
                            raise
            wait_until(lambda: all(n.block_store.height >= 3 for n in nodes), timeout=90,
                       msg="testnet commits over TCP")
            h1 = {n.block_store.load_block(1).hash() for n in nodes}
            assert len(h1) == 1
            res = rpc(nodes[0].rpc_port, "broadcast_tx_commit", tx=b"a=b".hex())
            assert res["deliver_tx"]["code"] == 0
            info = rpc(nodes[3].rpc_port, "net_info")
            assert info["n_peers"] == 3
        finally:
            for n in nodes:
                n.stop()


@pytest.fixture()
def _jax_tcp_write_lock_layered(monkeypatch):
    """The JAX package's TCP write lock with the port's `seq=1`: the JAX
    sanitizer otherwise reports its own SecretConnection-over-TCP
    layering as a rank inversion (`test_torch_p2p.py`)."""
    monkeypatch.setattr(J_tcp, "ranked_lock", lambda name: J_lockrank.ranked_lock(name, seq=1))


def test_jax_and_port_nodes_commit_one_chain(tmp_path, _jax_tcp_write_lock_layered):
    """Two JAX and two port `Node`s from one `testnet` output, linked over
    TCP through SecretConnections, commit byte-equal blocks with equal app
    hashes, a tx sent to each package's node among them."""
    from tendermint_tpu.config import Config as JConfig
    from tendermint_tpu.node import Node as JNode
    from tendermint_tpu.services.hasher import TreeHasher as JTreeHasher
    from tendermint_tpu.services.resilient import ResilientVerifier as JResilientVerifier
    from tendermint_tpu.services.verifier import HostBatchVerifier as JHostBatchVerifier

    out = str(tmp_path / "net")
    cli_main(["testnet", "--n", "4", "--output", out, "--starting-port", "0", "--chain-id", "mixed"])
    nodes = []
    try:
        for i in range(4):
            home = os.path.join(out, f"node{i}")
            if i < 2:
                cfg = JConfig.test_config(home)
                cfg.consensus = _net_config(home).consensus  # the same timeouts on all four
                cfg.p2p.pex = False
                nodes.append(JNode(cfg, verifier=JResilientVerifier(JHostBatchVerifier()),
                                   hasher=JTreeHasher(backend="host")))
            else:
                cfg = _net_config(home)
                cfg.p2p.pex = False
                nodes.append(Node(cfg, device="cpu"))
        for n in nodes:
            n.start()
        for i in range(4):
            for j in range(i + 1, 4):
                dial = J_tcp.dial if i < 2 else __import__("tendermint_tpu_torch.p2p.tcp", fromlist=["dial"]).dial
                dial(nodes[i].switch, f"127.0.0.1:{nodes[j].p2p_port}", priv_key=nodes[i]._node_key)
        wait_until(lambda: all(n.switch.n_peers() == 3 for n in nodes), timeout=30, msg="a full mesh")
        for n in (nodes[0], nodes[3]):
            res = rpc(n.rpc_port, "broadcast_tx_commit", tx=(b"mixed-%d=yes" % n.p2p_port).hex())
            assert res["deliver_tx"]["code"] == 0
        wait_until(lambda: all(n.block_store.height >= 4 for n in nodes), timeout=90, msg="four heights")
        top = min(n.block_store.height for n in nodes)
        for h in range(1, top + 1):
            assert len({n.block_store.load_block(h).encode() for n in nodes}) == 1, h
        for h in range(1, top):
            assert len({n.block_store.load_block_commit(h).encode() for n in nodes}) == 1, h
        at_top = [n for n in nodes if n.current_state.last_block_height == top]
        hashes = {n.current_state.app_hash for n in nodes if n.current_state.last_block_height == top}
        assert at_top and len(hashes) == 1
        assert len({tuple(nodes[k].block_store.load_block(h).header.app_hash for h in range(2, top + 1))
                    for k in range(4)}) == 1
        assert {type(n).__module__.split(".")[0] for n in nodes} == {"tendermint_tpu", "tendermint_tpu_torch"}
    finally:
        for n in nodes:
            n.stop()


class TestPersistentPeers:
    def test_reconnects_after_peer_drop(self, tmp_path):
        """A dropped persistent peer is redialed with backoff until the
        link heals (reference `reconnectToPeer p2p/switch.go:290-320`)."""
        out = str(tmp_path / "net")
        cli_main(["testnet", "--n", "2", "--output", out, "--starting-port", "0"])
        cfg0 = Config.test_config(os.path.join(out, "node0"))
        cfg1 = Config.test_config(os.path.join(out, "node1"))
        for c in (cfg0, cfg1):
            c.p2p.pex = False  # isolate: only the persistent logic may redial
            c.base.fast_sync = False
        n0 = Node(cfg0, device="cpu")
        n0.start()
        try:
            cfg1.p2p.persistent_peers = f"127.0.0.1:{n0.p2p_port}"
            cfg1.p2p.reconnect_base_backoff_s = 0.05
            n1 = Node(cfg1, device="cpu")
            n1.start()
            try:
                wait_until(lambda: n0.switch.n_peers() == 1 and n1.switch.n_peers() == 1, timeout=30,
                           msg="persistent peer connects")
                n0.switch.stop_peer(n0.switch.peers()[0], "test drop")
                wait_until(lambda: n0.switch.n_peers() == 1 and n1.switch.n_peers() == 1, timeout=30,
                           msg="persistent peer reconnects after drop")
            finally:
                n1.stop()
        finally:
            n0.stop()


# a node process as `python -m tendermint_tpu_torch` runs it, reporting at
# its exit the modules of jax or of the JAX package it ever imported
_NODE_PROCESS = (
    "import atexit, runpy, sys\n"
    "atexit.register(lambda: print('FORBIDDEN', sorted(m for m in sys.modules if m == 'jax'"
    " or m.startswith(('jax.', 'tendermint_tpu.')) or m == 'tendermint_tpu'), flush=True))\n"
    "sys.argv = ['tendermint_tpu_torch'] + sys.argv[1:]\n"
    "runpy.run_module('tendermint_tpu_torch', run_name='__main__')\n"
)


# a node process's start to its "up" line: `import torch` alone takes
# seconds on a loaded host
NODE_UP_S = 120


def _node_process(home, *args, log):
    return subprocess.Popen([sys.executable, "-c", _NODE_PROCESS, "node", "--home", str(home), "--device", "cpu",
                             *map(str, args)], cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=log)


def _stop(proc) -> list:
    """SIGTERM, as an operator stops a node: exit code 0 and the
    forbidden modules it reported."""
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    lines = [ln for ln in out.decode().splitlines() if ln.startswith("FORBIDDEN")]
    assert len(lines) == 1, out
    return json.loads(lines[0].split(" ", 1)[1].replace("'", '"'))


@pytest.mark.slow  # a subprocess crash case, as its JAX twin (tests/test_node.py)
class TestCrashRecovery:
    def test_kill9_and_restart_resumes_chain(self, tmp_path):
        home = tmp_path / "crash"
        cli_main(["init", "--home", str(home), "--chain-id", "crash-test"])
        from tendermint_tpu_torch.config import write_config

        cfg = Config.test_config(str(home))
        write_config(cfg)  # the test timeouts, read back by `node`
        port = _free_port()
        errpath = tmp_path / "node_stderr.log"
        errlog = open(errpath, "ab")
        node_args = ("--rpc-laddr", f"tcp://127.0.0.1:{port}", "--p2p-laddr", "tcp://127.0.0.1:0",
                     "--fast-sync", "false")

        def height_or_none():
            try:
                return rpc(port, "status", timeout=5)["sync_info"]["latest_block_height"]
            except Exception:
                return None

        proc = _node_process(home, *node_args, log=errlog)
        try:
            assert b" up: p2p " in first_line(proc, NODE_UP_S, errpath)
            wait_until(lambda: (height_or_none() or 0) >= 2, timeout=90, msg="first run commits")
            h_before = rpc(port, "status")["sync_info"]["latest_block_height"]
        finally:
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)

        proc = _node_process(home, *node_args, log=errlog)
        try:
            assert b" up: p2p " in first_line(proc, NODE_UP_S, errpath)
            wait_until(lambda: (height_or_none() or 0) >= h_before + 2, timeout=90,
                       msg="chain resumes past pre-crash height")
            assert _stop(proc) == []
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


# -- tests/test_multiprocess.py TestSubprocessTestnet --------------------------------


@pytest.mark.slow  # a multi-process net, as its JAX twin (tests/test_multiprocess.py)
class TestSubprocessTestnet:
    def test_four_node_processes_commit_a_tx(self, tmp_path):
        """4 `python -m tendermint_tpu_torch node --device cpu` processes
        from `testnet` reach consensus over localhost TCP at the default
        config and commit a tx sent through `broadcast_tx_commit`; none of
        them imports jax or the JAX package."""
        out_dir = str(tmp_path / "net")
        base = _free_port() | 1
        subprocess.run([sys.executable, "-m", "tendermint_tpu_torch", "testnet", "--n", "4", "--output", out_dir,
                        "--starting-port", str(base)], cwd=REPO, env=_env(), check=True, capture_output=True,
                       timeout=120)
        rpc_ports = [base + 2 * i + 1 for i in range(4)]
        errlog = open(tmp_path / "nodes_stderr.log", "ab")
        procs = [_node_process(os.path.join(out_dir, f"node{i}"), log=errlog) for i in range(4)]
        try:
            deadline = time.time() + 120
            heights = {}
            while time.time() < deadline:
                try:
                    heights = {p: rpc(p, "status", timeout=5)["sync_info"]["latest_block_height"] for p in rpc_ports}
                    if all(h >= 2 for h in heights.values()):
                        break
                except Exception:
                    pass
                time.sleep(0.5)
            assert heights and all(h >= 2 for h in heights.values()), heights

            res = rpc(rpc_ports[0], "broadcast_tx_commit", tx=b"mp=ok".hex(), timeout=90)
            assert res["deliver_tx"]["code"] == 0
            deadline = time.time() + 60
            while time.time() < deadline:
                try:
                    got = rpc(rpc_ports[3], "tx", hash=res["hash"], timeout=5)
                    assert bytes.fromhex(got["tx"]) == b"mp=ok"
                    break
                except RuntimeError:
                    time.sleep(0.5)
            else:
                raise AssertionError("tx never indexed on node3")
            info = rpc(rpc_ports[3], "net_info")
            assert info["n_peers"] == 3
            assert len({json.dumps(rpc(p, "block", height=1)) for p in rpc_ports}) == 1
            assert [_stop(p) for p in procs] == [[]] * 4
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)


# -- tests/test_p2p.py TestPersistentAddrMatching ------------------------------------


class TestPersistentAddrMatching:
    """`Node` persistent-peer adoption: id-pinned (`id@host:port`)
    matching, with bare-host match only when unambiguous."""

    @staticmethod
    def _node_with_peers(peers):
        class _FakeSwitch:
            def __init__(self, ps):
                self._ps = ps

            def peers(self):
                return self._ps

        n = Node.__new__(Node)
        n._peer_addr = {}
        n.switch = _FakeSwitch(peers)
        return n

    @staticmethod
    def _peer(pid, listen_addr="", remote_addr=""):
        class _P:
            id = pid

        p = _P()
        p.node_info = NodeInfo(node_id=pid, moniker=pid, chain_id="c", listen_addr=listen_addr)
        p.remote_addr = remote_addr
        return p

    def test_split_persistent_addr(self):
        assert Node._split_persistent_addr("abc123@10.0.0.1:46656") == ("abc123", "10.0.0.1:46656")
        assert Node._split_persistent_addr("10.0.0.1:46656") == (None, "10.0.0.1:46656")
        assert Node._split_persistent_addr("tcp://10.0.0.1:46656") == (None, "tcp://10.0.0.1:46656")

    def test_id_pinned_match_beats_host_match(self):
        right = self._peer("idA", remote_addr="10.0.0.1:5555")
        wrong = self._peer("idB", remote_addr="10.0.0.1:6666")  # same NAT host
        n = self._node_with_peers([wrong, right])
        n._adopt_inbound_persistent("idA@10.0.0.1:46656")
        assert n._peer_addr == {"idA": "idA@10.0.0.1:46656"}

    def test_pinned_id_absent_adopts_nothing(self):
        other = self._peer("idB", remote_addr="10.0.0.1:6666")
        n = self._node_with_peers([other])
        n._adopt_inbound_persistent("idA@10.0.0.1:46656")
        assert n._peer_addr == {}

    def test_bare_host_match_requires_single_candidate(self):
        a = self._peer("idA", remote_addr="10.0.0.1:5555")
        b = self._peer("idB", remote_addr="10.0.0.1:6666")
        n = self._node_with_peers([a, b])
        n._adopt_inbound_persistent("10.0.0.1:46656")
        assert n._peer_addr == {}  # ambiguous: refuse to guess
        n2 = self._node_with_peers([a])
        n2._adopt_inbound_persistent("10.0.0.1:46656")
        assert n2._peer_addr == {"idA": "10.0.0.1:46656"}

    def test_listen_addr_equality_match(self):
        a = self._peer("idA", listen_addr="10.0.0.1:46656", remote_addr="10.9.9.9:1")
        b = self._peer("idB", remote_addr="10.0.0.1:2")
        n = self._node_with_peers([b, a])
        n._adopt_inbound_persistent("10.0.0.1:46656")
        assert n._peer_addr == {"idA": "10.0.0.1:46656"}


# -- tests/test_abci_socket.py test_node_runs_against_remote_app ---------------------


def test_node_runs_against_remote_app(tmp_path):
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.abci.socket import ABCISocketServer, socket_client_creator

    srv = ABCISocketServer(KVStoreApp(), "tcp://127.0.0.1:0")
    try:
        home = str(tmp_path / "remote-app-node")
        cli_main(["init", "--home", home, "--chain-id", "remote-abci"])
        cfg = Config.test_config(home)
        cfg.base.fast_sync = False
        node = Node(cfg, client_creator=socket_client_creator(f"127.0.0.1:{srv.port}"), device="cpu")
        node.start()
        try:
            c = LocalClient(node)
            res = c.broadcast_tx_commit(b"remote=yes")
            assert res["deliver_tx"]["code"] == 0
            q = c.abci_query(data=b"remote")
            assert bytes.fromhex(q["value"]) == b"yes"
            assert c.status()["sync_info"]["latest_block_height"] >= 1
        finally:
            node.stop()
    finally:
        srv.stop()


# -- tests/test_health.py TestHealthRoute, tests/test_telemetry_node.py ---------------


def test_post_json_rpc_health(tmp_path):
    """`health` is also a normal JSON-RPC method (the snapshot without
    HTTP-status semantics), read from the port's height ledger."""
    node = _solo_node(tmp_path)
    try:
        node.wait_height(2, timeout=60)
        out = rpc(node.rpc_port, "health")
        assert out["status"] in ("ok", "degraded")
        assert "finality_slo" in out and "checks" in out
        assert out["checks"]["breakers"]["ok"] and out["ready"]
        with urllib.request.urlopen(f"http://127.0.0.1:{node.rpc_port}/health", timeout=30) as resp:
            assert resp.status == 200 and json.load(resp)["ready"]
    finally:
        node.stop()


def _parse_samples(text: str) -> dict:
    """Prometheus text -> {sample_line_name{labels}: float}."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        key, _, val = line.rpartition(" ")
        try:
            out[key] = float(val)
        except ValueError:
            pass
    return out


@pytest.fixture()
def telemetry_node(tmp_path):
    from tendermint_tpu_torch.services.resilient import ResilientVerifier
    from tendermint_tpu_torch.services.verifier import HostBatchVerifier

    # resilient wrapper on host so breaker series exist on the CPU
    node = _solo_node(tmp_path, name="telemetry", verifier=ResilientVerifier(HostBatchVerifier()))
    yield node
    node.stop()


class TestMetricsScrape:
    def test_curl_metrics_is_valid_and_populated(self, telemetry_node):
        from tendermint_tpu.telemetry import REGISTRY as J_REGISTRY

        jax_height = J_REGISTRY.counter_value("tendermint_consensus_height")
        res = rpc(telemetry_node.rpc_port, "broadcast_tx_commit", tx=b"mk=mv".hex())
        assert res["deliver_tx"]["code"] == 0
        telemetry_node.wait_height(2)

        with urllib.request.urlopen(f"http://127.0.0.1:{telemetry_node.rpc_port}/metrics", timeout=30) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain; version=0.0.4")
            text = resp.read().decode()
        samples = _parse_samples(text)

        assert samples["tendermint_consensus_height"] >= 2
        assert samples['tendermint_consensus_phase_seconds_count{phase="propose"}'] >= 1
        assert samples['tendermint_consensus_phase_seconds_count{phase="commit"}'] >= 1
        assert samples["tendermint_consensus_height_seconds_count"] >= 1
        assert samples["tendermint_consensus_commits_total"] >= 1
        assert samples["tendermint_consensus_txs_committed_total"] >= 1
        assert samples['tendermint_verify_batch_size_count{backend="host"}'] >= 1
        assert samples['tendermint_hash_seconds_count{backend="host"}'] >= 1
        assert samples['tendermint_breaker_state{kind="verify"}'] == 0  # closed
        for name in ("tendermint_p2p_sent_bytes_total", "tendermint_p2p_recv_bytes_total", "tendermint_p2p_peers",
                     "tendermint_p2p_send_rate_bytes", "tendermint_mempool_size"):
            assert name in samples, name
        assert samples["tendermint_wal_fsync_seconds_count"] >= 1
        assert samples['tendermint_mempool_txs_total{result="ok"}'] >= 1
        # the process gauges and the node-bound gauges are the port's own
        assert samples["tendermint_process_rss_bytes"] > 1e6
        assert samples["tendermint_process_threads"] >= 1
        assert samples["tendermint_p2p_peers"] == 0  # a solo node: read through bind_node_gauges
        # the scrape is the port's registry; the JAX registry did not move
        assert samples["tendermint_consensus_height"] <= REGISTRY.counter_value("tendermint_consensus_height")
        assert J_REGISTRY.counter_value("tendermint_consensus_height") == jax_height

    def test_dump_telemetry_rpc(self, telemetry_node):
        telemetry_node.wait_height(1)
        out = rpc(telemetry_node.rpc_port, "dump_telemetry", spans=64, launches=8)
        assert set(out) == {"metrics", "spans", "breakers", "launches", "p2p", "vote_arrivals"}
        m = out["metrics"]
        assert m["tendermint_consensus_height"]["type"] == "gauge"
        assert m["tendermint_consensus_height"]["series"][0]["value"] >= 1
        assert "tendermint_process_open_fds" in m
        names = {s["name"] for s in out["spans"]}
        assert any(n.startswith("consensus.") for n in names), names
        span = next(s for s in out["spans"] if s["name"] == "consensus.height")
        assert span["attrs"]["height"] >= 1
        assert span["end"] >= span["start"]
        assert out["breakers"]["verifier"]["state"] == "closed"
        assert out["breakers"]["verifier"]["kind"] == "verify"
        # the launch view reads the ledger under the node's own data dir
        from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG

        assert LAUNCHLOG.path == os.path.join(telemetry_node.config.home, "data", "launches.jsonl")

    def test_dump_telemetry_span_prefix_filter(self, telemetry_node):
        telemetry_node.wait_height(1)
        out = rpc(telemetry_node.rpc_port, "dump_telemetry", spans=32, prefix="consensus.")
        assert out["spans"], "expected consensus spans after a commit"
        assert all(s["name"].startswith("consensus.") for s in out["spans"])


# -- tests/test_profiler.py TestProcessTelemetry -------------------------------------


class TestProcessTelemetry:
    def test_gauges_read_live_values(self):
        assert REGISTRY.counter_value("tendermint_process_rss_bytes") > 1e6
        assert REGISTRY.counter_value("tendermint_process_open_fds") > 0
        assert REGISTRY.counter_value("tendermint_process_threads") >= 1

    def test_gc_pause_timing(self):
        import gc

        from tendermint_tpu_torch.telemetry.process import install_gc_telemetry

        def hist_count(name):
            fam = REGISTRY.get(name)
            return sum(snap["count"] for _values, snap in fam.samples())

        assert install_gc_telemetry()
        assert install_gc_telemetry()  # idempotent
        before = hist_count("tendermint_process_gc_pause_seconds")
        gen2 = REGISTRY.counter_value("tendermint_process_gc_collections_total", gen="2")
        gc.collect()
        assert hist_count("tendermint_process_gc_pause_seconds") > before
        assert REGISTRY.counter_value("tendermint_process_gc_collections_total", gen="2") > gen2

    def test_the_process_readers_agree_with_the_jax_package(self):
        from tendermint_tpu.telemetry import process as J_process
        from tendermint_tpu_torch.telemetry import process as P_process

        assert P_process._PAGE_SIZE == J_process._PAGE_SIZE
        assert P_process.open_fds() > 0 and J_process.open_fds() > 0
        assert P_process.thread_count() == J_process.thread_count()
        assert abs(P_process.rss_bytes() - J_process.rss_bytes()) < 64 << 20


def test_home_written_by_testnet_loads_back(tmp_path):
    """`testnet`'s homes are what `node` reads: the default config with
    each node's ports and seeds."""
    out = str(tmp_path / "net")
    cli_main(["testnet", "--n", "2", "--output", out, "--starting-port", "47200"])
    cfg = load_config(os.path.join(out, "node1"))
    assert cfg.p2p.laddr == "tcp://127.0.0.1:47202" and cfg.rpc.laddr == "tcp://127.0.0.1:47203"
    assert cfg.p2p.seeds == "127.0.0.1:47200"
    assert cfg.p2p.secret_connections and cfg.p2p.pex and cfg.p2p.send_rate == 512_000
