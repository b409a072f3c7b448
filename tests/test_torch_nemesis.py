"""The port's nemesis harness (`tendermint_tpu_torch/testing/nemesis.py`)
on the CPU: its `Nemesis`, `NemesisNode` and `FullNemesisNode` drive the
port's own consensus cores and `Node`s, verifying on caches of
their own over `default_verifier("cpu")` (or a host verifier factory).

The JAX package's `tests/test_nemesis.py` runs again on the port, each
case with its JAX marker: the chaos transport, the breaker trip
mid-height on the port's fault state, the starved node's round skips,
partitions and heals, crash and WAL-tail recovery, the pipelined
apply's faulted and forged cases, full-node chaos with a state-syncing
joiner, the fast-sync pipeline under device faults and ingress under
chaos.

The port's declared differences: `Nemesis`, `NemesisNode` and
`FullNemesisNode` take `device=`; each run of a `NemesisNode` given no
verifier verifies on a signature cache and coalescer of its own over
`default_verifier(device)`'s backend, the card's stack, which raises
without a card; `Nemesis.restart` waits for the crashed node's links to
drop. Across the packages: `make_genesis` docs and keys, seeded, and a
JAX and a port net of one genesis playing the same partition, crash
and WAL-replay cases to the same verdicts. Tolerance: exact.
"""

from __future__ import annotations

import time
import types

import pytest

from tendermint_tpu_torch.p2p.transport import (
    ChaosEndpoint,
    FuzzConfig,
    FuzzedEndpoint,
    LinkChaos,
    pipe_pair,
)
from tendermint_tpu_torch.services.resilient import ResilientVerifier
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.testing import Nemesis as PortNemesis
from tendermint_tpu_torch.testing import lockrank_report, own_default_stacks, time_limit_fixture
from tendermint_tpu_torch.utils import fail
from tendermint_tpu_torch.utils.circuit import CircuitBreaker


class Nemesis(PortNemesis):
    """The port's `Nemesis` on the CPU: a node given no verifier verifies
    on a cache of its own over `default_verifier("cpu")`'s backend."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


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
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(240))


@pytest.fixture(autouse=True)
def _own_default_stacks():
    """Nodes given no verifier verify over `default_verifier("cpu")`: each test
    runs on stacks of its own (`testing.own_default_stacks`)."""
    with own_default_stacks():
        yield


@pytest.fixture(autouse=True)
def _clean_faults():
    fail.clear_device_faults()
    yield
    fail.clear_device_faults()


class TestChaosTransport:
    def test_partition_black_holes_sends(self):
        a, b = pipe_pair()
        chaos = LinkChaos()
        ca = ChaosEndpoint(a, chaos)
        ca.send(b"before")
        assert b.recv(timeout=1) == b"before"
        chaos.partitioned = True
        assert ca.send(b"during")  # swallowed, not an error
        chaos.partitioned = False
        ca.send(b"after")
        assert b.recv(timeout=1) == b"after"  # 'during' is gone

    def test_duplicate_delivers_twice(self):
        a, b = pipe_pair()
        chaos = LinkChaos(seed=1)
        chaos.dup_prob = 1.0
        ChaosEndpoint(a, chaos).send(b"x")
        assert b.recv(timeout=1) == b"x"
        assert b.recv(timeout=1) == b"x"

    def test_delay_defers_delivery(self):
        a, b = pipe_pair()
        chaos = LinkChaos()
        chaos.delay_s = 0.15
        ChaosEndpoint(a, chaos).send(b"later")
        with pytest.raises(TimeoutError):
            b.recv(timeout=0.05)
        assert b.recv(timeout=1) == b"later"

    def test_fuzz_dup_probability(self):
        a, b = pipe_pair()
        fa = FuzzedEndpoint(a, FuzzConfig(prob_dup=1.0, seed=3))
        fa.send(b"d")
        assert b.recv(timeout=1) == b"d"
        assert b.recv(timeout=1) == b"d"


def _resilient_factory(threshold=2, reset_s=0.5):
    def factory(_i):
        return ResilientVerifier(
            HostBatchVerifier(),
            breaker=CircuitBreaker(
                failure_threshold=threshold, reset_timeout_s=reset_s
            ),
            max_retries=0,
        )

    return factory


class TestDeviceFaultDegradation:
    def test_breaker_trips_mid_height_chain_keeps_committing(self, tmp_path):
        """THE acceptance scenario: env-forced verifier device faults on
        a running network -> breakers trip OPEN -> blocks keep
        committing on the host fallback (no fork, height progress) ->
        fault clears -> breakers re-close. The degradation cycle is
        asserted through the EXPORTED telemetry (trip/recovery counters,
        fallback calls), not harness internals — what a dashboard would
        show is what the invariant checks."""
        with Nemesis(
            4, home=str(tmp_path), verifier_factory=_resilient_factory()
        ) as net:
            net.wait_height(2, timeout=60)
            base = net.breaker_baseline("verify")

            fail.set_device_fault("verify")  # device 'dies' mid-consensus
            net.wait_progress(delta=2, timeout=60)  # liveness on fallback
            # every node is degraded (open, or half_open between probes —
            # probes keep failing while the fault is armed)
            tripped = [n.cs.verifier.breaker.state for n in net.nodes]
            assert all(s != "closed" for s in tripped), tripped
            # ... and the degradation is observable from telemetry alone:
            # all 4 nodes' breakers tripped, fallbacks answered calls
            net.assert_breaker_tripped(base, min_trips=len(net.nodes))
            net.check_invariants()  # safety on fallback (no fork)

            fail.clear_device_faults()  # device 'recovers'
            net.wait_progress(delta=2, timeout=60)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if all(
                    n.cs.verifier.breaker.state == "closed" for n in net.nodes
                ):
                    break
                time.sleep(0.1)
            states = [n.cs.verifier.breaker.state for n in net.nodes]
            assert all(s == "closed" for s in states), states
            net.assert_breaker_recovered(base, min_recoveries=len(net.nodes))
            net.wait_progress(delta=1, timeout=60)  # still live re-upgraded


class TestRoundSkip:
    def test_starved_node_round_skips_and_rejoins(self, tmp_path):
        """The liveness gap, closed: a node cut off from all
        vote gossip (total starvation at PREVOTE/PRECOMMIT — no +2/3-any
        ever arrives to arm the *_wait timeouts) must keep cycling
        rounds via the round-skip timeout instead of wedging, and the
        skips are exported so chaos runs can assert on them."""
        from tendermint_tpu_torch.testing.nemesis import NemesisNode

        cfg = NemesisNode.default_config()
        cfg.timeout_round_skip = 400  # fast skips for the test
        cfg.timeout_round_skip_delta = 50
        with Nemesis(4, home=str(tmp_path), config=cfg) as net:
            net.wait_height(2, timeout=60)
            skips_pv = net.telemetry_value(
                "tendermint_consensus_round_skips_total", phase="prevote"
            )
            skips_pc = net.telemetry_value(
                "tendermint_consensus_round_skips_total", phase="precommit"
            )
            net.partition({0, 1, 2}, {3})  # node 3 fully starved
            # the majority keeps committing; the starved node skips at
            # PREVOTE (precommit nil) and then at PRECOMMIT (next round)
            net.wait_telemetry_above(
                "tendermint_consensus_round_skips_total",
                skips_pv,
                timeout=30,
                phase="prevote",
            )
            net.wait_telemetry_above(
                "tendermint_consensus_round_skips_total",
                skips_pc,
                timeout=30,
                phase="precommit",
            )
            net.wait_progress(delta=1, nodes=[0, 1, 2], timeout=60)
            assert net.nodes[3].cs.round > 0  # it cycled rounds, not wedged
            net.heal()
            # safety held and the skipper rejoins the chain after heal
            target = max(net.heights()) + 1
            net.wait_height(target, timeout=60)


class TestPartitionHeal:
    def test_even_split_stalls_then_heals(self, tmp_path):
        with Nemesis(4, home=str(tmp_path)) as net:
            net.wait_height(2, timeout=60)
            net.partition({0, 1}, {2, 3})  # no quorum on either side
            before = max(net.heights())
            time.sleep(1.5)
            assert max(net.heights()) <= before + 1  # at most in-flight height
            net.heal()
            net.wait_height(before + 2, timeout=60)  # progress resumes

    def test_minority_partition_keeps_majority_committing(self, tmp_path):
        with Nemesis(4, home=str(tmp_path)) as net:
            net.wait_height(2, timeout=60)
            net.partition({0, 1, 2}, {3})  # 75% quorum keeps going
            net.wait_progress(delta=2, nodes=[0, 1, 2], timeout=60)
            net.heal()
            # the isolated node catches back up after heal
            target = max(net.heights())
            net.wait_height(target, nodes=[3], timeout=60)


class TestCrashRecovery:
    def test_crash_restart_resumes_and_catches_up(self, tmp_path):
        with Nemesis(4, home=str(tmp_path)) as net:
            net.wait_height(2, timeout=60)
            net.crash(0)
            net.wait_progress(delta=1, nodes=[1, 2, 3], timeout=60)
            net.restart(0)
            target = max(net.heights()) + 1
            net.wait_height(target, timeout=60)

    def test_corrupt_wal_tail_is_tolerated_on_restart(self, tmp_path):
        with Nemesis(4, home=str(tmp_path)) as net:
            net.wait_height(2, timeout=60)
            net.crash(0)
            net.corrupt_wal_tail(0, nbytes=32)  # torn-write garbage
            net.restart(0)
            net.wait_height(max(net.heights()) + 1, timeout=60)

    def test_truncated_wal_tail_is_tolerated_on_restart(self, tmp_path):
        with Nemesis(4, home=str(tmp_path)) as net:
            net.wait_height(2, timeout=60)
            net.crash(2)
            net.truncate_wal_tail(2, nbytes=24)
            net.restart(2)
            net.wait_height(max(net.heights()) + 1, timeout=60)


@pytest.mark.slow
class TestChaosSoak:
    def test_lossy_duplicating_network_stays_consistent(self, tmp_path):
        """Background fuzz (drops + dups) on every link, a crash-restart
        and a partition cycle on top — invariants checked continuously."""
        fuzz = FuzzConfig(prob_drop_rw=0.05, prob_dup=0.10, seed=42)
        with Nemesis(4, home=str(tmp_path), fuzz=fuzz) as net:
            net.wait_height(3, timeout=120)
            net.partition({0, 3}, {1, 2})
            time.sleep(1.0)
            net.heal()
            net.wait_progress(delta=2, timeout=120)
            net.crash(1)
            net.restart(1)
            net.wait_height(max(net.heights()) + 2, timeout=120)

    def test_soft_fail_point_crashes_one_node_in_process(self, tmp_path):
        """FAIL_TEST_INDEX composition: the soft mode kills ONE node's
        consensus thread at a persistence step; restart + WAL replay
        recover it while the rest of the network keeps going."""
        with Nemesis(4, home=str(tmp_path)) as net:
            net.wait_height(2, timeout=60)
            net.crash_at_fail_point(5)
            try:
                deadline = time.monotonic() + 30
                victim = None
                while time.monotonic() < deadline and victim is None:
                    for n in net.nodes:
                        t = n.cs._thread
                        if t is not None and not t.is_alive():
                            victim = n.index
                    time.sleep(0.1)
                assert victim is not None, "no consensus thread died at fail point"
            finally:
                net.clear_fail_point()
            net.crash(victim)
            net.restart(victim)
            net.wait_height(max(net.heights()) + 1, timeout=120)


class TestPipelinedApplyChaos:
    """The pipeline's chaos gate: a forged or faulted ABCI apply
    landing MID-PIPELINE (height H's apply in flight under H+1's
    voting) must drain at the join barrier and halt that node without
    any speculative state reaching disk or a committed block — the
    no-fork invariants run continuously and the whole suite runs under
    the lock-rank sanitizer."""

    def test_faulted_apply_mid_pipeline_drains_and_halts(self, tmp_path):
        from tendermint_tpu_torch.state.state import load_state
        from tendermint_tpu_torch.testing.nemesis import (
            FaultedApplyApp,
            one_bad_app_factory,
        )

        with Nemesis(
            4,
            home=str(tmp_path),
            node_factory=Nemesis.full_node_factory(
                app_factory=one_bad_app_factory(
                    3, FaultedApplyApp, 4, fail_from_height=4
                )
            ),
        ) as net:
            # pipelining is the default config; the apply of height 4 on
            # node 3 raises on its worker — the join barrier surfaces it
            net.wait_height(6, nodes=[0, 1, 2], timeout=120)
            bad = net.nodes[3]
            deadline = time.time() + 30
            while bad.cs.fatal_error is None and time.time() < deadline:
                time.sleep(0.1)
            assert bad.cs.fatal_error is not None, "faulted apply did not halt"
            # the speculative H+1 never landed: persisted state stopped
            # at the last honestly-applied height
            st = load_state(bad.node.state_db)
            assert st.last_block_height == 3
            net.check_no_fork()

    def test_forged_apply_cannot_fork_the_chain(self, tmp_path):
        from tendermint_tpu_torch.state.state import load_state
        from tendermint_tpu_torch.testing.nemesis import (
            ForgedHashApp,
            one_bad_app_factory,
        )

        with Nemesis(
            4,
            home=str(tmp_path),
            node_factory=Nemesis.full_node_factory(
                app_factory=one_bad_app_factory(
                    3, ForgedHashApp, 4, fail_from_height=3
                )
            ),
        ) as net:
            # node 3's local execution diverges at height 3; the honest
            # +2/3 keeps committing the honest chain
            net.wait_height(6, nodes=[0, 1, 2], timeout=120)
            bad = net.nodes[3]
            # the forged node halts when the honest block's apply fails
            # validation against its diverged state
            deadline = time.time() + 30
            while bad.cs.fatal_error is None and time.time() < deadline:
                time.sleep(0.1)
            assert bad.cs.fatal_error is not None, "diverged node kept running"
            st = load_state(bad.node.state_db)
            assert st.app_hash == b"\xde\xad\xbe\xef" * 5
            # no committed header ever carried the forged hash
            honest = net.nodes[0]
            for h in range(4, honest.store.height + 1):
                meta = honest.store.load_block_meta(h)
                assert meta.header.app_hash != b"\xde\xad\xbe\xef" * 5
            net.check_no_fork()


class TestFullNodeChaos:
    """The harness driving COMPLETE `node.Node` instances (fast-sync +
    mempool + RPC + state-sync reactors) instead of bare consensus
    cores."""

    @staticmethod
    def _rpc(port, method, **params):
        import json
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/",
            data=json.dumps(
                {"jsonrpc": "2.0", "id": 1, "method": method, "params": params}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.load(resp)
        if "error" in out:
            raise RuntimeError(out["error"])
        return out["result"]

    def test_statesync_joiner_mid_partition_converges(self, tmp_path):
        """THE state-sync chaos scenario: a 4-validator full-node
        network serves snapshots; one validator is partitioned away; a
        FRESH node joins mid-partition, state-syncs from the majority
        (store base > 1 proves no genesis replay), commits a tx fed
        through the RPC layer under the partition, then the partition
        heals and everyone — including the stale validator — converges.
        Invariants (no-fork, commit agreement) run continuously."""

        def serving(cfg):
            cfg.statesync.snapshot_interval = 3

        with Nemesis(
            4,
            home=str(tmp_path),
            node_factory=Nemesis.full_node_factory(config_mutator=serving),
        ) as net:
            net.wait_height(5, timeout=90)
            assert net.nodes[0].node.snapshot_store.list_manifests()
            # isolate validator 3; 3/4 voting power keeps committing.
            # group 4 now so the joiner's links inherit correctly.
            net.partition({0, 1, 2, 4}, {3})
            stale_height = net.nodes[3].store.height
            # tx through the RPC layer while partitioned
            res = self._rpc(
                net.nodes[0].rpc_port, "broadcast_tx_sync", tx=b"chaos-k=chaos-v".hex()
            )
            assert res["code"] == 0

            from tendermint_tpu_torch.testing.nemesis import FullNemesisNode

            def joining(cfg):
                cfg.statesync.enable = True

            joiner = FullNemesisNode(
                4,
                net.genesis,
                net.privs,
                net.home,
                net.chain_id,
                config_mutator=joining,
                device="cpu",
            )
            net.add_node(joiner)
            deadline = time.monotonic() + 45
            while time.monotonic() < deadline:
                if joiner.node.statesync_reactor.restored_state is not None:
                    break
                time.sleep(0.1)
            assert joiner.node.statesync_reactor.restored_state is not None
            assert joiner.store.base > 1  # snapshot-restored, not replayed
            # the joiner converges with the majority despite the partition
            net.wait_height(
                net.nodes[0].store.height + 2, nodes=[0, 1, 2, 4], timeout=60
            )
            # RPC on the JOINER serves the restored/synced chain
            status = self._rpc(joiner.rpc_port, "status")
            assert int(status["sync_info"]["latest_block_height"]) > 1
            assert joiner.app._data.get(b"chaos-k") == b"chaos-v"

            net.heal()
            # the stale validator fast-syncs back past its partition-era
            # height and the whole net (5 nodes) keeps agreeing
            net.wait_height(stale_height + 3, timeout=90)

    def test_full_node_crash_restart_under_chaos(self, tmp_path):
        """Crash/restart of a full node (WAL + handshake recovery) with
        per-link delay chaos active — the NemesisNode crash matrix
        promoted to whole-node scope."""
        with Nemesis(
            4,
            home=str(tmp_path),
            node_factory=Nemesis.full_node_factory(),
        ) as net:
            net.wait_height(3, timeout=90)
            net.delay(0, 1, 0.05)
            net.crash(3)
            net.wait_progress(delta=2, nodes=[0, 1, 2], timeout=60)
            net.restart(3)
            net.wait_height(max(net.heights()) + 2, timeout=90)


class TestPipelineNoFork:
    """No-fork while the async dispatch PIPELINE is
    active — a fresh full node fast-syncs into a live network through
    the pipelined reactor (overlapped window verifies) while injected
    device faults knock launches out mid-flight; the no-fork /
    commit-agreement invariants run continuously in the monitor."""

    def test_fastsync_pipeline_joiner_under_device_faults_no_fork(self, tmp_path):
        from tendermint_tpu_torch.services.verifier import TableBatchVerifier
        from tendermint_tpu_torch.telemetry import REGISTRY
        from tendermint_tpu_torch.testing.nemesis import FullNemesisNode

        with Nemesis(
            3, home=str(tmp_path), node_factory=Nemesis.full_node_factory()
        ) as net:
            net.wait_height(4, timeout=90)
            overlap = REGISTRY.get("tendermint_dispatch_overlap_ratio")
            joins_before = overlap.labels(queue="fastsync").value["count"]

            # the joiner's window launches ride the breaker-guarded
            # async path; the first two fault in flight and must resolve
            # via host re-verify inside their handles
            verifier = ResilientVerifier(
                TableBatchVerifier(device="cpu", min_device_batch=10**6),
                breaker=CircuitBreaker(failure_threshold=100, reset_timeout_s=60),
                max_retries=0,
            )
            fail.set_device_fault("verify", 2)
            joiner = FullNemesisNode(
                3, net.genesis, net.privs, net.home, net.chain_id, verifier=verifier,
                device="cpu",
            )
            net.add_node(joiner)
            # the joiner pipelines the whole chain and keeps up with head
            net.wait_height(max(net.heights()) + 2, timeout=90)
            net.check_invariants()  # no fork with the pipeline active
            # both injected faults degraded through handles, not raises
            assert verifier._dispatch.fallback_calls >= 1
            # the overlap histogram saw the joiner's windows: the
            # pipeline actually engaged (not the synchronous fallback)
            assert overlap.labels(queue="fastsync").value["count"] > joins_before


class TestIngressChaos:
    """Sustained load-generator traffic keeps
    flowing through the batched ingress pipeline (sharded lanes +
    verify windows) while the network partitions AND the verify breaker
    trips to host crypto — with ZERO loss from the admitted pool (every
    CheckTx that answered OK is eventually committed) and no fork."""

    def test_sustained_ingress_through_partition_heal_and_breaker_trip(
        self, tmp_path, monkeypatch
    ):
        import itertools
        import threading

        from tendermint_tpu_torch.crypto.keys import gen_priv_key
        from tendermint_tpu_torch.mempool import make_signed_tx

        monkeypatch.setenv("TENDERMINT_TPU_MEMPOOL_LANES", "4")
        priv = gen_priv_key(b"\x33" * 32)
        with Nemesis(
            4,
            home=str(tmp_path),
            node_factory=Nemesis.full_node_factory(),
            verifier_factory=_resilient_factory(threshold=2, reset_s=0.5),
        ) as net:
            net.wait_height(2, timeout=90)
            # the full production mempool shape is active on every node
            assert net.nodes[0].node.mempool.n_lanes == 4
            assert net.nodes[0].node.mempool._ingress is not None

            admitted: list[bytes] = []
            adm_lock = threading.Lock()
            stop = threading.Event()
            seq = itertools.count()

            def pump():
                """Open-loop traffic: signed txs at a steady arrival
                rate into two intake nodes' ingress pipelines (the
                RPC-broadcast shape), regardless of admission progress."""
                for i in seq:
                    if stop.is_set() or i >= 1200:
                        return
                    tx = make_signed_tx(priv, b"ing-%d=%d" % (i, i))

                    def cb(res, tx=tx):
                        if res.is_ok:
                            with adm_lock:
                                admitted.append(tx)

                    net.nodes[i % 2].node.mempool.check_tx_async(tx, cb)
                    time.sleep(0.008)

            pump_thread = threading.Thread(target=pump, daemon=True)
            pump_thread.start()
            try:
                time.sleep(0.5)  # traffic established pre-fault
                base = net.breaker_baseline("verify")
                net.partition({0, 1, 2}, {3})  # minority isolated
                fail.set_device_fault("verify")  # device dies under load
                net.wait_progress(delta=2, nodes=[0, 1, 2], timeout=90)
                net.assert_breaker_tripped(base, min_trips=1)
                fail.clear_device_faults()
                net.heal()
                net.wait_progress(delta=2, timeout=90)
            finally:
                stop.set()
                pump_thread.join(10)
            with adm_lock:
                final_admitted = list(admitted)
            assert final_admitted, "no tx was admitted under chaos"

            # zero admitted-tx loss: every OK admission commits
            def committed_txs() -> set:
                store = net.nodes[0].store
                out = set()
                for h in range(max(1, store.base), store.height + 1):
                    blk = store.load_block(h)
                    if blk is not None:
                        out.update(bytes(t) for t in blk.data.txs)
                return out

            deadline = time.monotonic() + 120
            missing = set(final_admitted)
            while time.monotonic() < deadline and missing:
                missing = set(final_admitted) - committed_txs()
                if missing:
                    time.sleep(0.5)
            assert not missing, (
                f"{len(missing)}/{len(final_admitted)} admitted txs lost"
            )
            net.check_invariants()  # no fork through the whole episode


# -- the port's declared difference: device= -------------------------------------------


def test_a_node_given_no_verifier_takes_the_devices_default_stack(tmp_path):
    """`NemesisNode(..., device="cpu")` with no verifier verifies on a
    signature cache and coalescer of its own over `default_verifier("cpu")`'s
    backend, a new one each run, whose coalescer stops with the node; a
    `FullNemesisNode` hands `device` to its `Node`, whose verifier is the
    device's stack itself."""
    from tendermint_tpu_torch.crypto.keys import gen_priv_key
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.verifier import default_verifier
    from tendermint_tpu_torch.testing.nemesis import FullNemesisNode, NemesisNode, make_genesis

    genesis, privs = make_genesis(2, chain_id="dev-chain")
    stack = default_verifier("cpu")
    core = NemesisNode(0, genesis, privs, str(tmp_path), "dev-chain", device="cpu")
    other = NemesisNode(1, genesis, privs, str(tmp_path / "other"), "dev-chain", device="cpu")
    first = core.verifier
    assert isinstance(first, CoalescingVerifier) and core.cs.verifier is first
    assert first is not stack and first is not other.verifier
    assert first.inner is stack.inner and other.verifier.inner is stack.inner
    assert first.cache is not stack.cache and first.cache is not other.verifier.cache
    key = gen_priv_key(b"\x07" * 32)
    core.start()
    assert first.verify_batch_async([(key.pub_key.data, b"m", key.sign(b"m"))]).result(timeout=60).tolist() == [True]
    assert first.coalescer._running
    core.crash()
    assert not first.coalescer._running and not first.coalescer._flusher.is_alive()
    core.restart()
    assert core.verifier is not first and core.verifier.inner is stack.inner and core.cs.verifier is core.verifier
    core.stop()
    host = HostBatchVerifier()
    assert NemesisNode(1, genesis, privs, str(tmp_path), "dev-chain", verifier=host).verifier is host
    full = FullNemesisNode(0, genesis, privs, str(tmp_path), "dev-chain", device="cpu")
    assert full.device == "cpu" and full.cs.verifier is default_verifier("cpu")


def test_a_restart_waits_for_the_crashed_nodes_links_to_drop(tmp_path):
    """A switch refuses a peer id it still holds ("duplicate peer"):
    `Nemesis.restart` waits until no running node holds the crashed node
    as a peer, so a restart right after a crash links to every node even
    where one drops its old link late."""
    with Nemesis(3, home=str(tmp_path)) as net:
        net.wait_height(2, timeout=60)
        late = net.nodes[1].switch
        real = late.stop_peer

        def stop_peer_late(peer, reason):
            time.sleep(0.5)
            real(peer, reason)

        late.stop_peer = stop_peer_late
        victim = net.nodes[0].switch.node_info.node_id
        net.crash(0)
        assert victim in {p.id for p in late.peers()}  # the old link is still up
        net.restart(0)
        assert victim in {p.id for p in late.peers()} and net.nodes[0].switch.n_peers() == 2
        net.wait_height(max(net.heights()) + 1, timeout=60)

    def node(node_id, peers):
        return types.SimpleNamespace(running=True, switch=types.SimpleNamespace(
            node_info=types.SimpleNamespace(node_id=node_id), peers=lambda: [types.SimpleNamespace(id=p) for p in peers]))

    stuck = types.SimpleNamespace(nodes=[node("a", []), node("b", ["a"])])  # b never drops its link to a
    with pytest.raises(TimeoutError, match="links still up"):
        PortNemesis.wait_dropped(stuck, 0, timeout=0.2)


def test_nodes_without_a_device_need_the_card(tmp_path):
    """Given neither a verifier factory nor a device, the nodes take the
    card's stack: without a card, building the net raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from tendermint_tpu_torch.testing.nemesis import NemesisNode, make_genesis

    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortNemesis(2, home=str(tmp_path / "net"))
    genesis, privs = make_genesis(1, chain_id="dev-chain")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NemesisNode(0, genesis, privs, str(tmp_path), "dev-chain")
    # a verifier factory alone is enough for core nodes
    with PortNemesis(1, home=str(tmp_path / "host"), verifier_factory=lambda _i: HostBatchVerifier()) as net:
        net.wait_height(2, timeout=60)


# -- across the packages ---------------------------------------------------------------


@pytest.mark.parametrize("n_vals,n_active", [(1, None), (4, None), (6, 4), (8, 3), (5, 5)])
def test_make_genesis_equals_the_jax_package(n_vals, n_active):
    """The nemesis `make_genesis`: the same genesis doc and the same keys
    in the same order (the valset's first, then the standby pool)."""
    from tendermint_tpu.testing.nemesis import make_genesis as j_make_genesis
    from tendermint_tpu_torch.testing.nemesis import make_genesis

    gen, privs = make_genesis(n_vals, chain_id="nemesis-chain", n_active=n_active)
    j_gen, j_privs = j_make_genesis(n_vals, chain_id="nemesis-chain", n_active=n_active)
    assert gen.to_json() == j_gen.to_json()
    assert [(p.address, p.pub_key.data) for p in privs] == [(p.address, p.pub_key.data) for p in j_privs]


def _dropped(net, i: int, timeout: float = 30.0) -> None:
    """Wait until no running node holds node `i` as a peer: a switch
    refuses a peer id it still holds, so a node restarted before its old
    links drop is refused ("duplicate peer")."""
    name = net.nodes[i].switch.node_info.node_id
    deadline = time.monotonic() + timeout
    while any(name in {p.id for p in n.switch.peers()} for n in net.nodes if n.running):
        assert time.monotonic() < deadline, f"node {i}'s links still up after {timeout} s"
        time.sleep(0.01)


def _play(nemesis_cls, home, **kwargs) -> dict:
    """The book's partition, crash and WAL-replay cases on one net; the
    verdict of each (what a node must and must not do), not its timing."""
    out = {}
    with nemesis_cls(4, home=str(home), **kwargs) as net:
        net.wait_height(2, timeout=60)
        net.partition({0, 1}, {2, 3})
        before = max(net.heights())
        time.sleep(1.0)
        out["even_split_stalls"] = max(net.heights()) <= before + 1
        net.heal()
        net.wait_height(before + 2, timeout=60)
        net.partition({0, 1, 2}, {3})
        net.wait_progress(delta=2, nodes=[0, 1, 2], timeout=60)
        net.heal()
        net.wait_height(max(net.heights()), nodes=[3], timeout=60)
        out["minority_catches_up"] = True
        net.crash(0)
        _dropped(net, 0)
        net.corrupt_wal_tail(0, nbytes=32)
        net.restart(0)
        net.crash(2)
        _dropped(net, 2)
        net.truncate_wal_tail(2, nbytes=24)
        net.restart(2)
        net.wait_height(max(net.heights()) + 1, timeout=60)
        out["wal_replay_recovers"] = True
        net.check_invariants()
        out["no_fork"] = True
    out["violations"] = net.violations
    return out


def test_the_book_plays_to_the_jax_packages_verdicts(tmp_path):
    """A JAX net and a port net of the same genesis play the partition,
    crash and WAL-replay cases to the same verdicts, with no violation on
    either."""
    from tendermint_tpu.testing import Nemesis as JNemesis

    theirs = _play(JNemesis, tmp_path / "jax")
    ours = _play(Nemesis, tmp_path / "port")
    assert ours == theirs == {"even_split_stalls": True, "minority_catches_up": True,
                              "wal_replay_recovers": True, "no_fork": True, "violations": []}
