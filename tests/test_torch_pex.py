"""The port's address book, PEX reactor and UPnP client
(`tendermint_tpu_torch/p2p/{addrbook,pex,upnp}.py`) against the JAX
package's.

The JAX package's own cases run again on the port: `tests/test_pex.py`
(the book's add, promote, persist, eviction and sampling; the ensure
pass's re-request on an exhausted book; transitive discovery among three
port nodes over TCP, on the CPU) and `tests/test_upnp.py` (probe, map and
unmap, no gateway) against that file's fake gateway: a localhost SSDP
responder and SOAP endpoint.

Across the packages: one seeded sequence of book operations (adds from
several sources, promotions, failed attempts, removals, with the book's
key, clock and random source fixed) leaves byte-equal JSON files, equal
picks and samples, and each package loads the other's file to the same
book; the PEX messages encode to the same bytes and decode alike,
malformed ones with the same error; the gossip tables name the PEX
reactor's channel and tags (`tests/test_gossiplog.py`'s cross-check).
Tolerance: exact.
"""

from __future__ import annotations

import random
import time

import numpy as np
import pytest

from tendermint_tpu.p2p import addrbook as J_addrbook
from tendermint_tpu.p2p import pex as J_pex
from tests.test_upnp import FakeGateway
from tendermint_tpu_torch.cmd import main as cli_main
from tendermint_tpu_torch.config import Config
from tendermint_tpu_torch.node import Node
from tendermint_tpu_torch.p2p import addrbook as P_addrbook
from tendermint_tpu_torch.p2p import pex as P_pex
from tendermint_tpu_torch.p2p import upnp
from tendermint_tpu_torch.p2p.addrbook import MAX_ATTEMPTS, AddrBook, NetAddress
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture

BOOK = {"jax": J_addrbook, "port": P_addrbook}
PEX = {"jax": J_pex, "port": P_pex}


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


# -- tests/test_pex.py ---------------------------------------------------------------


class TestAddrBook:
    def test_add_promote_and_persist(self, tmp_path):
        path = str(tmp_path / "addrbook.json")
        book = AddrBook(path)
        a = NetAddress("aa" * 20, "127.0.0.1:1000")
        b = NetAddress("bb" * 20, "127.0.0.1:2000")
        assert book.add_address(a, src_id="seed")
        assert book.add_address(b, src_id="seed")
        assert not book.add_address(NetAddress("", ""), "x")
        assert book.size() == 2
        book.mark_good(a.node_id)
        # old entries are not overwritten by later gossip
        assert not book.add_address(NetAddress(a.node_id, "9.9.9.9:1"), src_id="liar")
        # restart survival (saves are debounced; shutdown flushes)
        book.flush()
        book2 = AddrBook(path)
        assert book2.size() == 2
        assert book2.has(a.node_id)
        picked = {book2.pick_address().node_id for _ in range(50)}
        assert picked <= {a.node_id, b.node_id}

    def test_failed_attempts_evict_new_addresses(self, tmp_path):
        book = AddrBook(str(tmp_path / "ab.json"))
        a = NetAddress("cc" * 20, "127.0.0.1:3000")
        book.add_address(a, "seed")
        for _ in range(MAX_ATTEMPTS):
            book.mark_attempt(a.node_id)
        assert not book.has(a.node_id)  # flaky new address dropped
        # but OLD (proven) addresses survive failed attempts
        b = NetAddress("dd" * 20, "127.0.0.1:4000")
        book.add_address(b, "seed")
        book.mark_good(b.node_id)
        for _ in range(MAX_ATTEMPTS + 2):
            book.mark_attempt(b.node_id)
        assert book.has(b.node_id)

    def test_sample_bounded(self, tmp_path):
        book = AddrBook(str(tmp_path / "ab.json"))
        for i in range(40):
            book.add_address(NetAddress(f"{i:040x}", f"127.0.0.1:{5000+i}"), "seed")
        assert len(book.sample(16)) == 16


class TestReRequest:
    def test_ensure_pass_reasks_when_book_exhausted(self, tmp_path):
        """If our one addr request reached a peer before ITS book had the
        third node, discovery deadlocked: ensure_peers must re-ask a
        connected peer (rate-limited) whenever the book can't cover the
        deficit."""
        book = AddrBook(str(tmp_path / "ab.json"))
        r = P_pex.PEXReactor(book, dial_fn=lambda addr: None, max_peers=4)
        r.REREQUEST_MIN_S = 0.0  # no wall-clock in the unit test

        sent = []

        class FakePeer:
            id = "ee" * 20
            outbound = True

            class node_info:
                listen_addr = ""

            def try_send(self, chan, payload):
                sent.append((chan, payload))
                return True

        peer = FakePeer()

        class FakeSwitch:
            def peers(self):
                return [peer]

        r.switch = FakeSwitch()
        r._running = True
        r.ensure_peers()  # empty book, below target -> must re-request
        assert sent, "no addr request issued on an exhausted book"
        chan, payload = sent[-1]
        assert chan == P_pex.PEX_CHANNEL
        assert P_pex.decode_message(payload)[0] == "request"
        # rate limit: an immediate second pass must NOT spam requests
        r.REREQUEST_MIN_S = 60.0
        r._requested[peer.id] = time.monotonic()
        n = len(sent)
        r.ensure_peers()
        assert len(sent) == n


class TestPEXDiscovery:
    def test_transitive_peer_discovery(self, tmp_path):
        """A knows only B; C knows only B; PEX must connect A<->C."""
        nodes = []
        try:
            for name in ("a", "b", "c"):
                home = str(tmp_path / name)
                cli_main(["init", "--home", home, "--chain-id", "pex-chain"])
                cfg = Config.test_config(home)
                cfg.base.fast_sync = False
                cfg.base.moniker = name
                nodes.append(Node(cfg, device="cpu"))
            for n in nodes:
                n.start()
            a, b, c = nodes
            from tendermint_tpu_torch.p2p.tcp import dial

            dial(a.switch, f"127.0.0.1:{b.p2p_port}", priv_key=a._node_key)
            dial(c.switch, f"127.0.0.1:{b.p2p_port}", priv_key=c._node_key)

            deadline = time.time() + 30
            while time.time() < deadline:
                if all(n.switch.n_peers() >= 2 for n in nodes):
                    break
                time.sleep(0.2)
            assert all(n.switch.n_peers() >= 2 for n in nodes), [n.switch.n_peers() for n in nodes]
            # the books learned the transitive addresses
            assert a.addr_book.has(c.node_id) or c.addr_book.has(a.node_id)
            # the links are SecretConnections on the port's own cipher
            assert all(p._conn._endpoint.remote_pub_key is not None for n in nodes for p in n.switch.peers())
        finally:
            for n in nodes:
                n.stop()


# -- tests/test_upnp.py (its fake gateway) -------------------------------------------


class TestUPnP:
    def test_probe_maps_and_cleans_up(self):
        gw = FakeGateway()
        try:
            result = upnp.probe(port=46700, ssdp_addr=gw.ssdp_addr)
            assert result["external_ip"] == "203.0.113.7"
            assert result["port"] == 46700
            assert 46700 not in gw.mappings  # mapping was created then deleted
            actions = " ".join(gw.requests)
            assert "AddPortMapping" in actions and "DeletePortMapping" in actions
        finally:
            gw.stop()

    def test_add_and_delete_mapping(self):
        gw = FakeGateway()
        try:
            g = upnp.discover(ssdp_addr=gw.ssdp_addr)
            assert g.service_type.endswith("WANIPConnection:1")
            upnp.add_port_mapping(g, 46701, 46656)
            assert gw.mappings.get(46701) == g.local_ip
            upnp.delete_port_mapping(g, 46701)
            assert 46701 not in gw.mappings
        finally:
            gw.stop()

    def test_no_gateway_raises(self):
        with pytest.raises(upnp.UPnPError, match="no UPnP gateway"):
            upnp.discover(timeout=0.3, ssdp_addr=("127.0.0.1", 9))

    def test_cli_probe_against_the_gateway(self, monkeypatch, capsys):
        """`probe_upnp` as the command line runs it, its search sent to the
        fake gateway's SSDP address."""
        import json

        gw = FakeGateway()
        monkeypatch.setattr(upnp, "SSDP_ADDR", gw.ssdp_addr)
        try:
            assert cli_main(["probe_upnp", "--port", "46702"]) == 0
            assert json.loads(capsys.readouterr().out)["external_ip"] == "203.0.113.7"
            assert 46702 not in gw.mappings
        finally:
            gw.stop()

    def test_the_packages_send_the_gateway_the_same_requests(self):
        from tendermint_tpu.p2p import upnp as J_upnp

        seen = {}
        for pkg, mod in (("jax", J_upnp), ("port", upnp)):
            gw = FakeGateway()
            try:
                got = mod.probe(port=46703, ssdp_addr=gw.ssdp_addr)
                got["control_url"] = got["control_url"].replace(str(gw.http_port), "PORT")
                seen[pkg] = (got, list(gw.requests))
            finally:
                gw.stop()
        assert seen["jax"] == seen["port"]


# -- the book and PEX across the packages --------------------------------------------


class _Clock:
    """A module's `time` with a clock that steps 0.25 s a read."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def time(self):
        self.t += 0.25
        return self.t

    def monotonic(self):
        return self.t


def _seeded_ops(seed: int, n: int):
    rng = np.random.default_rng(seed)
    ids = [rng.bytes(20).hex() for _ in range(48)]
    ops = []
    for _ in range(n):
        kind = rng.choice(["add", "add", "add", "good", "attempt", "remove", "pick", "sample"])
        i = int(rng.integers(len(ids)))
        ops.append((str(kind), ids[i], f"10.0.{i % 7}.{i}:{26656 + i}", f"src{int(rng.integers(5))}"))
    return ops


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_book_files_are_byte_equal_for_one_seeded_sequence(tmp_path, monkeypatch, seed):
    outs, books = {}, {}
    for pkg, mod in BOOK.items():
        monkeypatch.setattr(mod, "time", _Clock())
        path = str(tmp_path / f"{pkg}.json")
        book = mod.AddrBook(path, key=b"\x07" * 8)
        book._rng = random.Random(seed)
        trace = []
        for kind, nid, addr, src in _seeded_ops(seed, 300):
            if kind == "add":
                trace.append(book.add_address(mod.NetAddress(nid, addr), src_id=src))
            elif kind == "good":
                book.mark_good(nid)
            elif kind == "attempt":
                book.mark_attempt(nid)
            elif kind == "remove":
                book.remove(nid)
            elif kind == "pick":
                got = book.pick_address(bias_old=0.5, exclude={nid})
                trace.append(got and got.to_dict())
            else:
                trace.append([a.to_dict() for a in book.sample(8)])
        book.flush()
        with open(path, "rb") as f:
            outs[pkg] = f.read()
        books[pkg] = (trace, book.size())
    assert outs["jax"] == outs["port"]
    assert books["jax"] == books["port"]
    # each package loads the other's file to the same book and writes it back unchanged
    for reader, writer in (("port", "jax"), ("jax", "port")):
        mod = BOOK[reader]
        src = str(tmp_path / f"{writer}.json")
        book = mod.AddrBook(src)
        assert book.size() == books[writer][1]
        book._dirty = True
        book.flush()
        with open(src, "rb") as f:
            assert f.read() == outs[writer]


def test_pex_messages_agree():
    rng = np.random.default_rng(7)
    addrs = [(rng.bytes(20).hex(), f"127.0.0.{i}:{26656 + i}") for i in range(40)]
    wire = {}
    for pkg, mod in PEX.items():
        book_mod = BOOK[pkg]
        wire[pkg] = (mod.encode_request(), mod.encode_addrs([book_mod.NetAddress(*a) for a in addrs]))
    assert wire["jax"] == wire["port"]
    req, msg = wire["port"]
    for mod in PEX.values():
        assert mod.decode_message(req) == ("request", None)
        kind, got = mod.decode_message(msg)
        assert kind == "addrs" and [(a.node_id, a.addr) for a in got] == addrs[:32]  # capped per message
    for bad in (b"\x07", b"\x02\x05\x03ab"):
        errs = set()
        for mod in PEX.values():
            with pytest.raises(Exception) as e:
                mod.decode_message(bad)
            errs.add((type(e.value).__name__, str(e.value)))
        assert len(errs) == 1, errs


def test_gossip_tables_name_the_port_pex_reactor():
    """`tests/test_gossiplog.py`'s cross-check of the gossip tables,
    for the PEX reactor: its channel and message tags are the ones the
    port's `telemetry/gossiplog.py` names."""
    from tendermint_tpu_torch.telemetry.gossiplog import CHANNEL_NAMES, KIND_TAGS

    assert CHANNEL_NAMES[P_pex.PEX_CHANNEL] == "pex"
    assert KIND_TAGS[P_pex.PEX_CHANNEL] == {P_pex._MSG_REQUEST: "pex_request", P_pex._MSG_ADDRS: "pex_addrs"}
