"""The port's own nemesis book and scenario library
(`tendermint_tpu_torch.testing`) on the port's backends, and the seams
where the JAX package's host plane hands its objects to the port.

The port's `Nemesis`, `NemesisNode`, `FullNemesisNode` and
`ScenarioRunner` are composed with fresh port stacks, one a node:
`CoalescingVerifier(ResilientVerifier(TableBatchVerifier()))` and a
`ResilientTreeHasher`. The JAX package's `default_verifier()` is a port
stack meanwhile, so that a JAX call would show up there; none may.

CPU cases: a 4-node core net commits with every verify and tree on the
port (and none on the JAX package's verifier or hasher); the nemesis
book's breaker trip, armed and read on the port's fault state, breakers
and registry; the library's two tier-1 scenarios through the port's
`ScenarioRunner`, its nodes on caches of their own over the port stack
(its `Nemesis` patched to take the tree hashers only); one
subprocess without the conftest (which imports jax) that runs a net of
the port's full `Node`s and ends with neither jax nor the JAX package
imported; a net of two JAX and two port `NemesisNode`s of one genesis
that commits equal blocks; the seams where the host plane hands its own
objects to the port (a JAX `DispatchQueue` as `queue=`, `.then()`
chains, `stats()`, `proofs`, `leaf_hashes_async`); the table prebuild's
exit (a process must not abort while a build runs) and `warm_kernels`
off the card.

`cuda` cases (skipped without a card; on the card machine run with
`--noconftest`, it has no jax): a 4-node net on card stacks with the
minimum device batch at 0, so that every commit and vote drain
launches; `ValidatorSet.verify_commit_batched` over a 10,000-validator
commit and `verify_commit_batched_async` over a 1,000 x 16 fast-sync
window, against the JAX host verifier; the first verify of a fresh
process with and without `warm_kernels()`.
"""

from __future__ import annotations

import dataclasses
import json
import operator
import os
import pathlib
import subprocess
import sys
import threading
import time
import types
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

from tendermint_tpu.services import dispatch as jax_dispatch
from tendermint_tpu.services import hasher as jax_hasher
from tendermint_tpu.services import verifier as jax_verifier
from tendermint_tpu.testing.nemesis import make_genesis
from tendermint_tpu.types import BlockID
from tendermint_tpu.types.errors import ValidationError
from tendermint_tpu.types.part_set import PartSet, PartSetHeader
from tendermint_tpu.types.vote import VOTE_TYPE_PRECOMMIT, Vote
from tendermint_tpu.types.vote_set import VoteSet
from tendermint_tpu.utils import fail as jax_fail
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.services import hasher as port_hasher
from tendermint_tpu_torch.services import verifier as port_verifier
from tendermint_tpu_torch.services.batcher import CoalescingVerifier
from tendermint_tpu_torch.services.resilient import ResilientVerifier
from tendermint_tpu_torch.telemetry import REGISTRY as PORT_REGISTRY
from tendermint_tpu_torch.utils import fail as port_fail
from tendermint_tpu_torch.utils.circuit import CircuitBreaker
from tendermint_tpu_torch.testing import Nemesis, lockrank_report, time_limit_fixture
from tendermint_tpu_torch.testing import scenario as scenario_mod

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CHAIN = "torch-node"
# the port's threads that a closed stack must not leave behind (the JAX
# package's coalescer threads share two of the names: threads that ran
# before the test are not counted)
PORT_THREADS = ("table-prebuild", "verify-coalescer", "verify-coalescer-join", "warm-kernels")


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


@pytest.fixture(autouse=True)
def _clean_faults():
    port_fail.clear_device_faults()
    jax_fail.clear_device_faults()
    yield
    port_fail.clear_device_faults()
    jax_fail.clear_device_faults()


class Calls:
    """Counts calls of class methods, and the seconds spent in them, by
    `package.Class.method`."""

    def __init__(self, monkeypatch):
        self.n: Counter = Counter()
        self.s: dict[str, list] = {}  # seconds of each call
        self._lock = threading.Lock()
        self._mp = monkeypatch

    def count(self, cls, *names):
        pkg = cls.__module__.split(".")[0]
        for name in names:
            real = getattr(cls, name)
            key = f"{pkg}.{cls.__name__}.{name}"

            def counted(*args, _real=real, _key=key, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _real(*args, **kwargs)
                finally:
                    with self._lock:
                        self.n[_key] += 1
                        self.s.setdefault(_key, []).append(time.perf_counter() - t0)

            self._mp.setattr(cls, name, counted)

    def jax_calls(self) -> dict:
        return {k: v for k, v in self.n.items() if k.startswith("tendermint_tpu.")}


class PortBackends:
    """Factories of port stacks, one a node, closed at teardown; the
    JAX package's default verifier and the port's default stack of the
    device are port stacks of these meanwhile."""

    def __init__(self, monkeypatch, device="cpu", min_device_batch=None):
        self._before = set(threading.enumerate())
        self.device = device
        self.min_device_batch = min_device_batch
        self.stacks: list = []
        self.calls = Calls(monkeypatch)
        self.calls.count(
            port_verifier.TableBatchVerifier,
            "launch_verify_batch", "launch_verify_commits", "prebuild", "warm_kernels",
        )
        self.calls.count(port_verifier.HostBatchVerifier, "verify_batch")
        self.calls.count(
            port_hasher.TreeHasher, "root_from_items", "root_from_hashes", "leaf_hashes", "proofs"
        )
        self.calls.count(CoalescingVerifier, "verify_batch_async", "verify_commits_async")
        self.calls.count(jax_verifier.HostBatchVerifier, "verify_batch")
        self.calls.count(
            jax_hasher.TreeHasher, "root_from_items", "root_from_hashes", "leaf_hashes", "proofs"
        )
        monkeypatch.setattr(jax_verifier, "_DEFAULT", self.verifier())
        # the port's process-wide stack of the device is one of these too:
        # a site that takes no verifier (the scenario's bisection probe)
        # counts here and is closed with the rest
        monkeypatch.setitem(port_verifier._DEFAULTS, port_verifier.resolve_device(device), self.verifier())

    def table(self):
        return port_verifier.TableBatchVerifier(device=self.device, min_device_batch=self.min_device_batch)

    def verifier(self, _i=None):
        v = CoalescingVerifier(ResilientVerifier(self.table()))
        self.stacks.append(v)
        return v

    def hasher(self, _i=None):
        return port_hasher.auto_hasher(self.device)

    def close(self):
        """Close every stack at once: each stops its table prebuilds,
        which would otherwise hold the others' closes up."""
        closing = [threading.Thread(target=v.close) for v in self.stacks]
        for t in closing:
            t.start()
        for t in closing:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in closing)
        left = [t.name for t in threading.enumerate() if t.name in PORT_THREADS and t not in self._before]
        assert not left, left


@pytest.fixture
def port(monkeypatch):
    backends = PortBackends(monkeypatch)
    yield backends
    backends.close()


def _agree(net) -> int:
    """No fork, seen commits certify stored blocks, and every node stored
    the same app hash and block hash at each height all of them have;
    returns that height."""
    net.check_invariants()
    top = min(net.heights())
    for h in range(1, top + 1):
        blocks = [node.store.load_block(h) for node in net.nodes]
        assert len({b.header.app_hash for b in blocks}) == 1, h
        assert len({b.hash() for b in blocks}) == 1, h
    return top


def _port_did_everything(calls: Calls, drains: bool = False) -> None:
    """Commits, votes and part sets went through the port (the vote
    drain's batches too, where the net drains any), the JAX package's
    verifier and hasher saw no call."""
    n = calls.n
    assert n["tendermint_tpu_torch.TableBatchVerifier.launch_verify_commits"] > 0, n
    assert n["tendermint_tpu_torch.TableBatchVerifier.launch_verify_batch"] > 0, n
    assert n["tendermint_tpu_torch.TreeHasher.proofs"] > 0, n
    if drains:
        assert n["tendermint_tpu_torch.CoalescingVerifier.verify_batch_async"] > 0, n
    assert calls.jax_calls() == {}, calls.jax_calls()


# -- 2a: a core net ----------------------------------------------------------


def test_core_net_commits_on_port_backends(port, tmp_path, monkeypatch):
    # runs of 2 same-key votes preverify in one batch (8 by default: a
    # 4-node net would drain no batch), so the vote drain reaches the
    # port's coalescer
    monkeypatch.setattr(ConsensusState, "VOTE_DRAIN_MIN", 2)
    waits = PORT_REGISTRY.get("tendermint_batcher_wait_seconds").labels(consumer="consensus")
    waits0 = waits.value["count"]
    with Nemesis(4, home=str(tmp_path), verifier_factory=port.verifier, hasher_factory=port.hasher) as net:
        net.wait_height(4, timeout=60)
        assert _agree(net) >= 4
    _port_did_everything(port.calls, drains=True)
    assert all(v.snapshot()["fallback_calls"] == 0 for v in port.stacks)
    assert waits.value["count"] > waits0  # the drain's consumer tag reached the port's coalescer


# -- 2b: the nemesis book's breaker trip -------------------------------------


def _port_counter(name, **labels) -> float:
    return PORT_REGISTRY.counter_value(name, **labels)


def _breaker_reading() -> dict:
    return {
        "trips": _port_counter("tendermint_breaker_transitions_total", kind="verify", to="open"),
        "recoveries": _port_counter("tendermint_breaker_transitions_total", kind="verify", to="closed"),
        "fallbacks": _port_counter("tendermint_device_fallback_calls_total", kind="verify"),
    }


def test_breaker_trips_mid_height_chain_keeps_committing(port, tmp_path):
    """`tests/test_nemesis.py`'s acceptance scenario on the port's
    `Nemesis` and port backends:
    faults armed on the port's fault state trip every node's breaker
    (read from the port's `ResilientVerifier`s and the port's registry),
    the chain commits on the host fallback without a fork, and the
    breakers re-close once the fault clears."""

    def factory(_i):
        v = ResilientVerifier(
            port.table(),
            breaker=CircuitBreaker(failure_threshold=2, reset_timeout_s=0.5),
            max_retries=0,
        )
        port.stacks.append(v)  # closed at teardown with the rest
        return v

    with Nemesis(4, home=str(tmp_path), verifier_factory=factory, hasher_factory=port.hasher) as net:
        net.wait_height(2, timeout=60)
        base = _breaker_reading()

        port_fail.set_device_fault("verify")
        net.wait_progress(delta=2, timeout=60)
        tripped = [n.cs.verifier.breaker.state for n in net.nodes]
        assert all(s != "closed" for s in tripped), tripped
        now = _breaker_reading()
        assert now["trips"] - base["trips"] >= len(net.nodes), (base, now)
        assert now["fallbacks"] > base["fallbacks"], (base, now)
        net.check_invariants()
        assert jax_fail._device_faults in (None, {})  # the JAX fault state stayed unarmed

        port_fail.clear_device_faults()
        net.wait_progress(delta=2, timeout=60)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if all(n.cs.verifier.breaker.state == "closed" for n in net.nodes):
                break
            time.sleep(0.1)
        states = [n.cs.verifier.breaker.state for n in net.nodes]
        assert all(s == "closed" for s in states), states
        assert _breaker_reading()["recoveries"] - base["recoveries"] >= len(net.nodes)
        net.wait_progress(delta=1, timeout=60)
    assert port.calls.jax_calls() == {}, port.calls.jax_calls()


# -- 2c: the library's tier-1 scenarios --------------------------------------


class PortScenarioRunner(scenario_mod.ScenarioRunner):
    """The port's `ScenarioRunner` on the backends' device: each node
    verifies on a cache of its own over the device's default stack, the
    backends' while the fixture runs. Its nets take the backends' tree
    hashers, which `_build_net` does not pass (nor does the JAX one), so
    that the part sets go through the port's `TreeHasher` too."""

    def __init__(self, home: str, backends: PortBackends) -> None:
        super().__init__(home=home, device=backends.device)
        self.backends = backends

    def _build_net(self, spec: dict):
        hasher = self.backends.hasher

        class PortNemesis(Nemesis):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, hasher_factory=hasher, **kwargs)

        with mock.patch.object(scenario_mod, "Nemesis", PortNemesis):
            return super()._build_net(spec)


def test_churn_small_on_port_backends(port, tmp_path):
    report = PortScenarioRunner(str(tmp_path), port).run(scenario_mod.SCENARIO_LIBRARY["churn_small"])
    assert report["ok"], report["failures"]
    assert report["epochs"] >= 3
    assert report["valset_rebuilds"] >= 3
    assert report["bisection"]["verified_to"] >= 16
    assert min(report["heights"]) >= 16
    _port_did_everything(port.calls)
    # the rotations reach the table prebuild
    assert port.calls.n["tendermint_tpu_torch.TableBatchVerifier.prebuild"] > 0


def test_slow_wan_validator_on_port_backends(port, tmp_path):
    report = PortScenarioRunner(str(tmp_path), port).run(scenario_mod.SCENARIO_LIBRARY["slow_wan_validator"])
    assert report["ok"], report["failures"]
    assert report["propose_timeout_s"]["min"] > report["max_one_way_delay_s"]
    assert report["round_skips_post_warm"] == 0
    _port_did_everything(port.calls)


# -- 2e: one genesis, two packages ------------------------------------------


def test_jax_and_port_nemesis_nodes_of_one_genesis_commit_equal_blocks(port, tmp_path):
    """Two JAX `NemesisNode`s (the JAX host verifier and tree) and two of
    the port's (port stacks), each pair from its package's `make_genesis`
    of the same chain, linked pairwise over in-process pipes, each side
    reading the other's `NodeInfo` from its wire form: all four store the
    same block hash and app hash at every height of at least four."""
    from tendermint_tpu.p2p import NodeInfo as JNodeInfo
    from tendermint_tpu.testing.nemesis import NemesisNode as JNemesisNode
    from tendermint_tpu_torch.p2p import NodeInfo, pipe_pair
    from tendermint_tpu_torch.testing.nemesis import NemesisNode
    from tendermint_tpu_torch.testing.nemesis import make_genesis as port_make_genesis

    chain = "mixed-nemesis"
    j_gen, j_privs = make_genesis(4, chain_id=chain)
    gen, privs = port_make_genesis(4, chain_id=chain)
    assert gen.to_json() == j_gen.to_json()
    nodes = [JNemesisNode(i, j_gen, j_privs, str(tmp_path), chain, verifier=jax_verifier.HostBatchVerifier(),
                          hasher=jax_hasher.TreeHasher(backend="host")) for i in (0, 1)]
    nodes += [NemesisNode(i, gen, privs, str(tmp_path), chain, verifier=port.verifier(), hasher=port.hasher())
              for i in (2, 3)]
    for n in nodes:
        n.start()
    try:
        for i in range(4):
            for j in range(i + 1, 4):
                ea, eb = pipe_pair()
                for local, remote, end, outbound in ((i, j, ea, True), (j, i, eb, False)):
                    cls = JNodeInfo if local < 2 else NodeInfo
                    info = cls.decode(nodes[remote].switch.node_info.encode())
                    nodes[local].switch.add_peer_endpoint(info, end, outbound=outbound)
        deadline = time.monotonic() + 90
        while min(n.store.height for n in nodes) < 4:
            assert time.monotonic() < deadline, [n.store.height for n in nodes]
            time.sleep(0.05)
    finally:
        for n in nodes:
            n.stop()
    top = min(n.store.height for n in nodes)
    for h in range(1, top + 1):
        blocks = [n.store.load_block(h) for n in nodes]
        assert len({b.hash() for b in blocks}) == 1, f"block hashes differ at height {h}"
        assert len({b.header.app_hash for b in blocks}) == 1, f"app hashes differ at height {h}"


# -- 2d: full nodes in a process without the conftest ------------------------

_FULL_NET = """
import json, sys, tempfile
from tendermint_tpu_torch.services.batcher import CoalescingVerifier
from tendermint_tpu_torch.services.hasher import auto_hasher
from tendermint_tpu_torch.services.resilient import ResilientVerifier
from tendermint_tpu_torch.services.verifier import TableBatchVerifier
from tendermint_tpu_torch.testing import Nemesis

warmed = []
real_warm = TableBatchVerifier.warm_kernels
def warm(self):
    warmed.append(self.device.type)
    return real_warm(self)
TableBatchVerifier.warm_kernels = warm

stacks = []
def verifier(_i=None):
    stacks.append(CoalescingVerifier(ResilientVerifier(TableBatchVerifier(device="cpu"))))
    return stacks[-1]

with tempfile.TemporaryDirectory() as home:
    with Nemesis(4, home=home, verifier_factory=verifier, hasher_factory=lambda _i: auto_hasher("cpu"),
                 node_factory=Nemesis.full_node_factory()) as net:
        net.wait_height(4, timeout=60)
        net.check_invariants()
        heights = net.heights()
        commits = sum(s.inner.snapshot()["primary_calls"] for s in stacks)
for s in stacks:
    s.close()
from tendermint_tpu_torch.utils import lockrank
violations = [lockrank.render_violation(v) for v in lockrank.drain()]
jax = sorted(m for m in sys.modules if m in ("jax", "tendermint_tpu") or m.startswith(("jax.", "tendermint_tpu.")))
print(json.dumps({"heights": heights, "warmed": warmed, "primary_calls": commits, "jax": jax,
                  "lockrank_violations": violations}))
"""


def _subprocess_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["TENDERMINT_TPU_LOCKRANK"] = "1"  # the port's sanitizer, without the conftest
    env.pop("PYTHONSTARTUP", None)
    return env


def test_full_node_net_without_conftest_imports_no_jax():
    """A net of the port's full `Node`s on port backends, in a process
    that never loads `tests/conftest.py` (which imports jax): it commits,
    every node warms its verifier, neither jax nor the JAX package is
    ever imported, and the process exits with code 0."""
    out = subprocess.run(
        [sys.executable, "-c", _FULL_NET], cwd=REPO, env=_subprocess_env(),
        capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "terminate called" not in out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert min(rep["heights"]) >= 4, rep
    assert rep["warmed"] == ["cpu"] * 4, rep
    assert rep["primary_calls"] > 0, rep
    assert rep["jax"] == [], rep
    assert rep["lockrank_violations"] == [], rep


# -- the table prebuild at exit, and warm_kernels off the card --------------

_PREBUILD_EXIT = """
import numpy as np
from tendermint_tpu_torch.services.verifier import default_verifier
rng = np.random.default_rng(7)
default_verifier(device="cpu").prebuild([rng.bytes(32) for _ in range(6)])
"""


def test_process_exits_cleanly_while_a_prebuild_runs():
    """A process that exits while a table `prebuild` runs in the
    background must exit with code 0: the build stops between steps and
    the exit waits for it (it aborted with SIGABRT, code 134, before)."""
    out = subprocess.run(
        [sys.executable, "-c", _PREBUILD_EXIT], cwd=REPO, env=_subprocess_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    assert "terminate called" not in out.stderr


def test_prebuild_builds_once_and_close_stops_it():
    v = port_verifier.TableBatchVerifier(device="cpu")
    rng = np.random.default_rng(8)
    keys = [rng.bytes(32) for _ in range(6)]
    v.prebuild(keys)
    v.prebuild(keys)  # the same set while its build runs: no second build
    assert len(v._prebuilds) == 1
    (thread,) = v._prebuilds.values()
    v.close()
    assert not thread.is_alive()
    v.prebuild(keys)  # closed: starts nothing
    assert v._prebuilds == {}


def test_warm_kernels_on_the_cpu_returns_at_once_and_starts_nothing():
    before = set(threading.enumerate())
    for v in (
        port_verifier.TableBatchVerifier(device="cpu"),
        CoalescingVerifier(ResilientVerifier(port_verifier.TableBatchVerifier(device="cpu"))),
    ):
        t0 = time.perf_counter()
        assert v.warm_kernels() is None
        assert time.perf_counter() - t0 < 0.05
        v.close()
    assert set(threading.enumerate()) <= before


# -- seams the host plane pushes into the port --------------------------------


@pytest.fixture(scope="module")
def chain():
    """A 4-validator chain: two good commits and one with a forged
    precommit at validator 2."""
    genesis, privs = make_genesis(4, chain_id=CHAIN)
    valset = genesis.validator_set()

    def commit(height, tag):
        block_id = BlockID(bytes([tag]) * 20, PartSetHeader(total=1, hash=bytes([tag + 1]) * 20))
        votes = VoteSet(CHAIN, height, 0, VOTE_TYPE_PRECOMMIT, valset)
        for i, priv in enumerate(privs):
            vote = Vote(
                validator_address=priv.address, validator_index=i, height=height, round=0,
                timestamp=1, type=VOTE_TYPE_PRECOMMIT, block_id=block_id,
            )
            votes.add_vote(priv.sign_vote(CHAIN, vote), preverified=True)
        return (block_id, height, votes.make_commit())

    good = [commit(7, 0x31), commit(8, 0x41)]
    block_id, height, c = commit(9, 0x51)
    precommits = list(c.precommits)
    precommits[2] = precommits[2].with_signature(b"\x07" * 64)
    forged = (block_id, height, dataclasses.replace(c, precommits=precommits))
    return valset, good, forged


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValidationError as e:
        return ("error", str(e))


@pytest.mark.parametrize("which", ["good", "mixed"])
def test_fastsync_window_through_a_jax_dispatch_queue(chain, port, which):
    """`verify_commit_batched_async` as the fast-sync reactor calls it: a
    JAX `DispatchQueue(name="fastsync")` as `queue=` and the consumer
    tag, on a port stack whose table backend takes the plain chains; the
    JAX queue's worker runs the port's launch, and the JAX handle's
    `.then()` chain carries the verdict to the same outcome as the JAX
    host verifier's."""
    valset, good, forged = chain
    entries = good if which == "good" else [good[0], forged]
    port.min_device_batch = 0
    stack = port.verifier()
    q = jax_dispatch.DispatchQueue(name="fastsync")
    submits = []
    real_submit = q.submit
    q.submit = lambda *a, **k: submits.append(k.get("kind")) or real_submit(*a, **k)
    try:
        want = _outcome(
            lambda: valset.verify_commit_batched(CHAIN, entries, verifier=jax_verifier.HostBatchVerifier())
        )
        handle = valset.verify_commit_batched_async(CHAIN, entries, verifier=stack, queue=q, consumer="fastsync")
        got = _outcome(lambda: handle.then(lambda ok: ok is True).result(timeout=60))
    finally:
        q.close()
    assert got == (("ok", True) if want == ("ok", None) else want)
    assert submits == ["verify"]
    assert port.calls.n["tendermint_tpu_torch.TableBatchVerifier.launch_verify_commits"] == 1
    assert stack.snapshot()["fallback_calls"] == 0


def test_coalescer_stats_reach_the_queue_wait_view(port):
    from tendermint_tpu.services.batcher import CoalescingVerifier as JaxCoalescing
    from tendermint_tpu.telemetry.views import queue_wait_summary

    stack = port.verifier()
    node = types.SimpleNamespace(consensus=types.SimpleNamespace(verifier=stack))
    got = queue_wait_summary(node)["depths"]["coalescer"]
    assert got == stack.stats()
    assert set(got) == set(JaxCoalescing(jax_verifier.HostBatchVerifier()).stats())


def test_part_set_proofs_from_the_port_hasher(port):
    """`PartSet.from_data(hasher=)` takes the port's proofs: the same
    header and part encodings as the JAX host tree's, and every part
    passes the JAX `PartSet.add_part` proof check on a receiving peer."""
    data = np.random.default_rng(9).bytes(10_000)
    got = PartSet.from_data(data, part_size=1024, hasher=port.hasher())
    want = PartSet.from_data(data, part_size=1024, hasher=jax_hasher.TreeHasher(backend="host"))
    assert got.header == want.header
    peer = PartSet(got.header)
    for i in range(got.header.total):
        assert got.get_part(i).encode() == want.get_part(i).encode()
        peer.add_part(got.get_part(i))
    assert peer.is_complete()


def test_state_sync_gate_through_a_jax_dispatch_queue(port):
    """The chunk gate (`verify_chunks_async`) on the port's resilient
    hasher with a JAX `DispatchQueue` as `queue=`: accepts the snapshot,
    and refuses a tampered chunk with the JAX hasher's error."""
    from tendermint_tpu.statesync import snapshot as J_snapshot

    hasher = port.hasher()
    jax_tree = jax_hasher.TreeHasher(backend="host")
    chunks = J_snapshot.split_chunks(np.random.default_rng(10).bytes(6000), 700)
    leaves = jax_tree.leaf_hashes(chunks)
    manifest = J_snapshot.SnapshotManifest(
        height=10, chunks=len(chunks), chunk_size=700, root=jax_tree.root_from_hashes(leaves),
        chunk_hashes=leaves, app_hash=b"\x02" * 32, chain_id=CHAIN, payload_len=6000,
    )
    bad = list(chunks)
    bad[3] = b"\x00" + bad[3][1:]
    q = jax_dispatch.DispatchQueue(name="statesync")
    try:
        assert J_snapshot.verify_chunks_async(manifest, chunks, hasher, queue=q).result(timeout=60) is True
        got = _outcome(lambda: J_snapshot.verify_chunks_async(manifest, bad, hasher, queue=q).result(timeout=60))
    finally:
        q.close()
    want = _outcome(lambda: J_snapshot.verify_chunks(manifest, bad, jax_tree))
    assert got == want and got[0] == "error"
    assert port.calls.n["tendermint_tpu_torch.TreeHasher.leaf_hashes"] == 2


# -- on the card ---------------------------------------------------------------
#
# Keys and signatures for the full-width cases come from the port's
# pure-Python RFC 8032 module in a spawn pool (the card's machine has no
# `cryptography`, so the JAX host verifier runs the same pure-Python
# code, in the same pool, for its reference verdicts).

POOL_WORKERS = 8


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's stacks launch hand kernels there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pool(card):
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(POOL_WORKERS) as p:
        yield p


def _launches() -> dict:
    from tendermint_tpu_torch.ops.ed25519_ladder import ladder
    from tendermint_tpu_torch.ops.ed25519_tables import finish_encode_compare, fused_chain, sum_entries

    return {
        "madd_chain_entries": sum_entries,
        "madd_chain_fused": fused_chain,
        "ladder": ladder,
        "finish_encode_compare": finish_encode_compare,
    }


def _report(tag: str, rep: dict) -> None:
    """One JSON line a result, for the run's log (`-s`)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ).stdout.strip()
    print(f"{tag} " + json.dumps({"card": smi, **rep}), flush=True)


class PooledJaxHost:
    """The JAX package's `HostBatchVerifier`, its batches split over a
    process pool (verdicts are per triple, so the split changes none)."""

    def __init__(self, pool) -> None:
        self.pool = pool

    def verify_batch(self, triples):
        # a worker calls the method on its own import of the class
        calls = [
            (operator.methodcaller("verify_batch", triples[i : i + 256]), jax_verifier.HostBatchVerifier())
            for i in range(0, len(triples), 256)
        ]
        parts = self.pool.starmap(operator.call, calls)
        return np.concatenate(parts) if parts else np.zeros(0, dtype=bool)


def _valset_and_commits(pool, n_vals: int, heights: list[int], seed: int, absent: tuple = ()):
    """A ValidatorSet of `n_vals` fresh keys and one commit a height,
    built with the JAX package's Vote / VoteSet; the validators at the
    indices `absent` cast no vote."""
    from tendermint_tpu.crypto.keys import PubKey
    from tendermint_tpu.types.validator_set import Validator, ValidatorSet
    from tendermint_tpu_torch.crypto import ed25519_ref

    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n_vals)]
    pubs = pool.map(ed25519_ref.public_from_seed, seeds, chunksize=256)
    seed_of = {}
    vals = []
    for s, pk in zip(seeds, pubs):
        key = PubKey(pk)
        seed_of[key.address] = s
        vals.append(Validator(address=key.address, pub_key=key, voting_power=10))
    valset = ValidatorSet(vals)
    entries = []
    for height in heights:
        block_id = BlockID(rng.bytes(20), PartSetHeader(total=1, hash=rng.bytes(20)))
        votes = [
            Vote(
                validator_address=v.address, validator_index=i, height=height, round=0,
                timestamp=1_700_000_000_000_000_000 + height, type=VOTE_TYPE_PRECOMMIT, block_id=block_id,
            )
            for i, v in enumerate(valset.validators)
            if i not in absent
        ]
        sigs = pool.starmap(
            ed25519_ref.sign, [(seed_of[v.validator_address], v.sign_bytes(CHAIN)) for v in votes], chunksize=256
        )
        vote_set = VoteSet(CHAIN, height, 0, VOTE_TYPE_PRECOMMIT, valset)
        for vote, sig in zip(votes, sigs):
            vote_set.add_vote(vote.with_signature(sig), preverified=True)
        entries.append((block_id, height, vote_set.make_commit()))
    return valset, entries


def _forged(entry, indices):
    """`entry` with the precommits at `indices` carrying a forged signature."""
    block_id, height, commit = entry
    precommits = list(commit.precommits)
    for i in indices:
        sig = precommits[i].signature
        precommits[i] = precommits[i].with_signature(bytes([sig[0] ^ 1]) + sig[1:])
    return (block_id, height, dataclasses.replace(commit, precommits=precommits))


@pytest.mark.cuda
@pytest.mark.parametrize("min_batch", [0, None], ids=["every-verify-on-the-card", "default-minimum"])
def test_node_net_on_card_stacks_launches_every_verify_kernel(card, monkeypatch, tmp_path, min_batch):
    """A 4-node net of full `Node`s (the `Node` is what calls
    `warm_kernels`) on card stacks. With the minimum device batch at 0,
    for the table backend and its flat lane alike, every commit, vote
    and vote drain of the net launches on the card: at least 10 heights,
    no fork, no fallback, every node warmed its verifier, and the entries
    chain, the ladder and the finish all launched. At the default minimum
    (512 lanes) the same net launches no verify kernel: the host answers
    a 4-validator net, and the run is its yardstick."""
    from tendermint_tpu_torch.ops import _build

    backends = PortBackends(monkeypatch, device="cuda", min_device_batch=min_batch)
    timed = Calls(monkeypatch)
    timed.count(
        port_verifier.TableBatchVerifier,
        "launch_verify_batch", "finalize_verify_batch", "launch_verify_commits", "finalize_verify_commits",
        "tables_for",
    )
    monkeypatch.setattr(ConsensusState, "VOTE_DRAIN_MIN", 2)
    try:
        net = Nemesis(
            4, home=str(tmp_path), verifier_factory=backends.verifier, hasher_factory=backends.hasher,
            node_factory=Nemesis.full_node_factory(),
        )
        for t in threading.enumerate():
            if t.name == "warm-kernels":
                t.join(timeout=120)
        assert _build._LIB is not None
        kernels = _launches()
        for fn in kernels.values():
            fn.launches = 0
        timed.s.clear()
        timed.n.clear()
        net.start()
        try:
            t0 = time.perf_counter()
            h0 = min(net.heights())
            net.wait_height(h0 + 10, timeout=120)
            elapsed = time.perf_counter() - t0
            top = _agree(net)
        finally:
            net.stop()
        launched = {name: fn.launches for name, fn in kernels.items()}
        assert backends.calls.n["tendermint_tpu_torch.TableBatchVerifier.warm_kernels"] == 4
        snaps = [v.snapshot() for v in backends.stacks]
        assert all(s["fallback_calls"] == 0 and s["total_failures"] == 0 for s in snaps), snaps
        for name in ("madd_chain_entries", "ladder", "finish_encode_compare"):
            assert (launched[name] > 0) == (min_batch == 0), launched
        assert backends.calls.jax_calls() == {}
        tables = "tendermint_tpu_torch.TableBatchVerifier.tables_for"
        verify_s = sum(sum(v) for k, v in timed.s.items() if k != tables)
        _report("node-net", {
            "min_device_batch": min_batch, "heights": top - h0, "seconds": elapsed, "heights_per_s": (top - h0) / elapsed,
            "verify_s_per_height": verify_s / (top - h0),
            "calls": {k: {"n": len(v), "sum_s": sum(v), "median_s": float(np.median(v)), "max_s": max(v)}
                      for k, v in timed.s.items()},
            "launches": launched,
        })
    finally:
        backends.close()


@pytest.mark.cuda
def test_host_plane_at_full_width_matches_the_jax_host(card, pool, monkeypatch):
    """`ValidatorSet.verify_commit_batched` over a 10,000-validator commit
    (the entries chain) and `verify_commit_batched_async` over 16 commits
    of a 1,000-validator set with a JAX `DispatchQueue(name="fastsync")`,
    as the fast-sync reactor calls it (the fused chain), on the port's
    card stack, with forged lanes planted: each outcome equals the JAX
    host verifier's, the kernel launched, no fallback. Wall times beside
    the bare backend's on the same lanes and the host plane's lane
    collection alone."""
    backends = PortBackends(monkeypatch, device="cuda")
    stack = backends.verifier()
    bare = stack.inner.primary
    reference = PooledJaxHost(pool)
    kernels = _launches()
    rep: dict = {}
    try:
        # the consensus commit: 10,000 validators (five absent), good
        # and with two forged lanes
        valset, (entry,) = _valset_and_commits(pool, 10_000, [100], seed=61, absent=(5, 6, 2000, 7000, 9999))
        pubs = [v.pub_key.data for v in valset.validators]
        bare.tables_for(tuple(pubs))
        for name, entries in (("good", [entry]), ("forged", [_forged(entry, (4321, 9000))])):
            want = _outcome(lambda: valset.verify_commit_batched(CHAIN, entries, verifier=reference))
            fn = kernels["madd_chain_entries"]
            fn.launches = 0
            walls = []
            for _ in range(3):  # each on an empty signature cache, the tables cached
                fresh = CoalescingVerifier(stack.inner)
                t0 = time.perf_counter()
                got = _outcome(lambda: valset.verify_commit_batched(CHAIN, entries, verifier=fresh))
                walls.append(time.perf_counter() - t0)
                fresh.coalescer.close()
                assert got == want, (name, got, want)
            assert fn.launches == 3
            rep[f"commit_{name}"] = {"outcome": want, "wall_s": walls}
        assert rep["commit_good"]["outcome"] == ("ok", None)
        t0 = time.perf_counter()
        collected = [valset._collect_commit_sigs(CHAIN, *entry)]
        lanes = valset._commit_lanes(collected, len(pubs))
        rep["commit_lane_collection_s"] = time.perf_counter() - t0
        bare_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            bare.verify_commits(pubs, lanes)
            bare_s.append(time.perf_counter() - t0)
        rep["commit_bare_s"] = bare_s

        # the fast-sync window: 16 commits of 1,000 validators, good and
        # with forged lanes in two of them
        wvals, window = _valset_and_commits(pool, 1_000, list(range(200, 216)), seed=62)
        wpubs = [v.pub_key.data for v in wvals.validators]
        bare.tables_for(tuple(wpubs))
        forged = list(window)
        forged[3] = _forged(window[3], (17,))
        forged[11] = _forged(window[11], (500, 999))
        for name, entries in (("good", window), ("forged", forged)):
            want = _outcome(lambda: wvals.verify_commit_batched(CHAIN, entries, verifier=reference))
            fn = kernels["madd_chain_fused"]
            fn.launches = 0
            fresh = CoalescingVerifier(stack.inner)
            q = jax_dispatch.DispatchQueue(depth=2, name="fastsync")
            t0 = time.perf_counter()
            handle = wvals.verify_commit_batched_async(CHAIN, entries, verifier=fresh, queue=q, consumer="fastsync")
            got = _outcome(lambda: handle.result(timeout=120) and None)
            wall = time.perf_counter() - t0
            q.close()
            fresh.coalescer.close()
            assert got == want, (name, got, want)
            assert fn.launches == 1
            rep[f"window_{name}"] = {"outcome": want, "wall_s": wall}
        assert rep["window_good"]["outcome"] == ("ok", None)
        t0 = time.perf_counter()
        wcollected = [wvals._collect_commit_sigs(CHAIN, *e) for e in window]
        wlanes = wvals._commit_lanes(wcollected, len(wpubs))
        rep["window_lane_collection_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bare.verify_commits(wpubs, wlanes)
        rep["window_bare_s"] = time.perf_counter() - t0
        snap = stack.snapshot()
        assert snap["fallback_calls"] == 0 and snap["total_failures"] == 0, snap
        _report("host-plane", rep)
    finally:
        backends.close()


_COLD_START = """
import json, sys, time
import numpy as np
import torch
from tendermint_tpu_torch.crypto import ed25519_ref
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.services.verifier import TableBatchVerifier

rng = np.random.default_rng(63)
seeds = [rng.bytes(32) for _ in range(512)]
pubs = [ed25519_ref.public_from_seed(s) for s in seeds]
msgs = [rng.bytes(241) for _ in seeds]
sigs = [ed25519_ref.sign(s, m) for s, m in zip(seeds, msgs)]
v = TableBatchVerifier(device="cuda")
rep = {"loaded_before": _build._LIB is not None}
if sys.argv[1] == "warm":
    t0 = time.perf_counter()
    thread = v.warm_kernels()
    rep["warm_call_s"] = time.perf_counter() - t0
    thread.join(timeout=120)
    rep["warm_s"] = time.perf_counter() - t0
    rep["loaded_after_warm"] = _build._LIB is not None
    def no_second_build(*a, **k):
        raise AssertionError("a second build")
    _build.build = no_second_build
for name, call in (
    ("flat", lambda: v.verify_batch(list(zip(pubs, msgs, sigs)))),
    ("commit", lambda: v.verify_commits(pubs, [(msgs, sigs)])),
):
    for rnd in ("first", "second"):
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        rep[f"{name}_{rnd}_s"] = time.perf_counter() - t0
        assert bool(np.all(out)), name
print(json.dumps(rep))
"""


@pytest.mark.cuda
def test_cold_start_with_and_without_warm_kernels(card):
    """A fresh process whose kernel library is built but not loaded: the
    first 512-lane flat verify and the first 512-validator commit, with
    and without `warm_kernels()` before them. With it, the call returns
    at once, the library is loaded when its thread ends, and no second
    build runs."""
    from tendermint_tpu_torch.ops import _build

    _build.build()  # built, as after an earlier process; loaded by none of the two below
    env = dict(os.environ, PYTHONPATH=str(REPO))
    reps = {}
    for mode in ("cold", "warm"):
        out = subprocess.run(
            [sys.executable, "-c", _COLD_START, mode], cwd=REPO, env=env, capture_output=True, text=True, timeout=600
        )
        assert out.returncode == 0, out.stderr[-3000:]
        reps[mode] = json.loads(out.stdout.strip().splitlines()[-1])
    assert not reps["cold"]["loaded_before"] and not reps["warm"]["loaded_before"]
    assert reps["warm"]["loaded_after_warm"]
    assert reps["warm"]["warm_call_s"] < 0.05
    _report("cold-start", reps)
