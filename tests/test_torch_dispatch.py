"""The port's async dispatch pipeline (`tendermint_tpu_torch/services/dispatch.py`
and the async surfaces of the verifier services), scenario for scenario
as `tests/test_dispatch.py` drives the JAX package's, on the CPU:
submission order, bounded-depth backpressure, cached outcomes, and the
breaker's host fallback resolving through in-flight handles.

The last test submits one seeded sequence through the JAX queue and
wrapper and through the port's, launch and finalize faults at the same
points, and requires the same verdicts, transitions and counters.
Every queue a test makes is closed when it ends.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from tendermint_tpu.services import dispatch as J_disp
from tendermint_tpu.services import resilient as J_res
from tendermint_tpu.services import verifier as J_ver
from tendermint_tpu.utils import circuit as J_circuit
from tendermint_tpu.utils import fail as J_fail
from tendermint_tpu_torch.services import dispatch as dispatch_mod
from tendermint_tpu_torch.services import resilient as P_res
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.services.dispatch import ChainedHandle, CompletedHandle, DispatchQueue
from tendermint_tpu_torch.services.resilient import ResilientVerifier
from tendermint_tpu_torch.telemetry import REGISTRY
from tendermint_tpu_torch.utils import circuit as P_circuit
from tendermint_tpu_torch.utils import fail
from tendermint_tpu_torch.utils.circuit import OPEN, CircuitBreaker
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture

from tests.helpers import det_priv_keys

torch.set_num_threads(1)


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


@pytest.fixture(autouse=True)
def _clean():
    fail.clear_device_faults()
    J_fail.clear_device_faults()
    yield
    fail.clear_device_faults()
    J_fail.clear_device_faults()


@pytest.fixture
def queue():
    """Makes dispatch queues (either package's class) and closes every
    one of them when the test ends, so no worker thread outlives it."""
    made = []

    def make(*args, cls=DispatchQueue, **kwargs):
        q = cls(*args, **kwargs)
        made.append(q)
        return q

    yield make
    for q in made:
        q.close()


def _triples(n, corrupt=()):
    out = []
    for i, k in enumerate(det_priv_keys(n)):
        msg = bytes([i]) * 8
        sig = k.sign(msg)
        if i in corrupt:
            sig = sig[:10] + bytes([sig[10] ^ 0xFF]) + sig[11:]
        out.append((k.pub_key.data, msg, sig))
    return out


def _jax_host(triples):
    return J_ver.HostBatchVerifier().verify_batch(triples)


class TestDispatchQueue:
    def test_fifo_launch_order_and_results(self, queue):
        q = queue(depth=8, name="t-fifo")
        order = []
        handles = [q.submit(lambda i=i: (order.append(i), i * 10)[1]) for i in range(8)]
        assert [h.result(60) for h in handles] == [i * 10 for i in range(8)]
        assert order == list(range(8))

    def test_depth_bounds_inflight_and_submit_blocks(self, queue):
        q = queue(depth=2, name="t-depth")
        gate = threading.Event()
        h1 = q.submit(gate.wait)
        h2 = q.submit(lambda: "second")
        third_submitted = threading.Event()

        def submit_third():
            h = q.submit(lambda: "third")
            third_submitted.set()
            h.result(60)

        t = threading.Thread(target=submit_third, daemon=True)
        t.start()
        time.sleep(0.1)
        assert not third_submitted.is_set()
        assert q.inflight() == 2
        gate.set()
        h1.result(60)
        assert third_submitted.wait(5)
        assert h2.result(60) == "second"
        t.join(timeout=5)
        assert not t.is_alive()
        assert q.inflight() == 0

    def test_stalled_queue_raises_instead_of_wedging(self, queue, monkeypatch):
        monkeypatch.setattr(dispatch_mod, "_STALL_TIMEOUT_S", 0.05)
        q = queue(depth=1, name="t-stall")
        q.submit(lambda: 1)  # never joined
        with pytest.raises(RuntimeError, match="stalled"):
            q.submit(lambda: 2)

    def test_launch_exception_delivered_at_result_and_cached(self, queue):
        q = queue(depth=2, name="t-exc")

        def boom():
            raise ValueError("kernel exploded")

        h = q.submit(boom)
        for _ in range(2):
            with pytest.raises(ValueError, match="kernel exploded"):
                h.result(60)
        assert q.submit(lambda: 7).result(60) == 7

    def test_finalize_runs_on_joining_thread(self, queue):
        q = queue(depth=2, name="t-fin")
        threads = {}

        def launch():
            threads["launch"] = threading.current_thread().name
            return 3

        def finalize(v):
            threads["finalize"] = threading.current_thread().name
            return v + 1

        assert q.submit(launch, finalize).result(60) == 4
        assert threads["launch"].startswith("dispatch-")
        assert threads["finalize"] == threading.current_thread().name

    def test_then_chains_and_caches(self, queue):
        q = queue(depth=2, name="t-then")
        calls = []

        def tally(v):
            calls.append(v)
            return v * 2

        h = q.submit(lambda: 21).then(tally)
        assert isinstance(h, ChainedHandle)
        assert h.result(60) == 42 and h.result(60) == 42
        assert calls == [21]
        h2 = q.submit(lambda: (_ for _ in ()).throw(RuntimeError("x"))).then(tally)
        with pytest.raises(RuntimeError):
            h2.result(60)

    def test_completed_handle(self):
        assert CompletedHandle(5).result(60) == 5
        assert CompletedHandle(5).done()
        assert CompletedHandle(5).then(lambda v: v + 1).result(60) == 6
        with pytest.raises(KeyError):
            CompletedHandle(exc=KeyError("k")).result(60)

    def test_close_rejects_new_submits(self, queue):
        q = queue(depth=2, name="t-close")
        h = q.submit(lambda: 1)
        q.close()
        assert h.result(60) == 1
        with pytest.raises(RuntimeError, match="closed"):
            q.submit(lambda: 2)

    def test_inflight_gauge_queue_wait_and_overlap_metrics(self, queue):
        q = queue(depth=3, name="t-metrics")
        h = q.submit(lambda: time.sleep(0.02) or 1, kind="hash")
        time.sleep(0.005)  # overlapped host work
        assert h.result(60) == 1
        assert REGISTRY.get("tendermint_dispatch_inflight").labels(queue="t-metrics").value == 0
        wait = REGISTRY.get("tendermint_dispatch_queue_wait_seconds")
        assert wait.labels(queue="t-metrics").value["count"] >= 1
        hist = REGISTRY.get("tendermint_dispatch_overlap_ratio")
        assert hist.labels(queue="t-metrics").value["count"] >= 1
        assert dispatch_mod.measured_launch_apply_ratio("t-metrics") is not None
        assert dispatch_mod.measured_launch_apply_ratio("no-such-queue") is None


class TestAsyncVerifierSurface:
    def test_host_verifier_async_matches_sync(self, queue):
        v = V.HostBatchVerifier()
        triples = _triples(6, corrupt=(2, 4))
        got = v.verify_batch_async(triples, queue=queue(depth=2, name="t-host")).result(60)
        np.testing.assert_array_equal(got, v.verify_batch(triples))
        np.testing.assert_array_equal(got, _jax_host(triples))

    def test_device_verifier_async_runs_the_plain_ladder(self, queue):
        """min_device_batch=0: the launch goes through the ladder's plain
        torch version on the CPU, on the queue's worker."""
        v = V.DeviceBatchVerifier(device="cpu", min_device_batch=0)
        triples = _triples(5, corrupt=(1,))
        got = v.verify_batch_async(triples, queue=queue(depth=2)).result(60)
        assert list(got) == [True, False, True, True, True]
        small = V.DeviceBatchVerifier(device="cpu", min_device_batch=10**6)
        assert list(small.verify_batch_async(triples, queue=queue(depth=2)).result(60)) == list(got)

    def test_table_verifier_commits_async_matches_sync(self, queue):
        v = V.TableBatchVerifier(device="cpu", min_device_batch=0)
        keys = det_priv_keys(4)
        pubs = [k.pub_key.data for k in keys]
        msgs = [bytes([i]) * 8 for i in range(4)]
        sigs = [k.sign(m) for k, m in zip(keys, msgs)]
        bad = list(sigs)
        bad[2] = bytes(64)
        lanes = [(msgs, sigs), (msgs, bad)]
        sync = v.verify_commits(pubs, lanes)
        got = v.verify_commits_async(pubs, lanes, queue=queue(depth=2)).result(60)
        np.testing.assert_array_equal(got, sync)
        assert got[0].all() and got[1].tolist() == [True, True, False, True]


class TestBreakerThroughHandles:
    """The resilient wrapper's fallback resolves THROUGH the handle: a
    faulted in-flight launch re-verifies on the host at the join."""

    def test_faulted_launch_resolves_via_host_fallback(self, queue):
        v = ResilientVerifier(
            V.DeviceBatchVerifier(device="cpu", min_device_batch=10**6),
            breaker=CircuitBreaker(failure_threshold=1, reset_timeout_s=60),
        )
        triples = _triples(6, corrupt=(0, 3))
        fail.set_device_fault("verify", 1)
        got = v.verify_batch_async(triples, queue=queue(depth=2, name="t-fault")).result(60)
        np.testing.assert_array_equal(got, _jax_host(triples))
        assert v.breaker.state == OPEN
        assert v._dispatch.fallback_calls >= 1

    def test_finalize_fault_resolves_via_host_fallback(self, queue):
        class _MaterializeBomb(V.BatchVerifier):
            def launch_verify_batch(self, triples):
                return triples

            def finalize_verify_batch(self, launched):
                raise fail.InjectedDeviceFault("transfer died mid-flight")

            def verify_batch(self, triples):
                return self.finalize_verify_batch(self.launch_verify_batch(triples))

        v = ResilientVerifier(_MaterializeBomb(), breaker=CircuitBreaker(failure_threshold=1, reset_timeout_s=60))
        triples = _triples(4, corrupt=(2,))
        got = v.verify_batch_async(triples, queue=queue(depth=2)).result(60)
        np.testing.assert_array_equal(got, _jax_host(triples))
        assert v.breaker.state == OPEN

    def test_verdicts_join_in_submission_order_under_mid_pipeline_faults(self, queue):
        v = ResilientVerifier(
            V.DeviceBatchVerifier(device="cpu", min_device_batch=10**6),
            breaker=CircuitBreaker(failure_threshold=100, reset_timeout_s=60),
        )
        q = queue(depth=3, name="t-order")
        # batch i corrupts lane i: each batch has its own verdict mask
        batches = [_triples(6, corrupt=(i,)) for i in range(6)]
        fail.set_device_fault("verify", 2)
        handles = []
        for i, triples in enumerate(batches):
            if i >= q.depth:
                got = handles[i - q.depth][1].result(60)
                np.testing.assert_array_equal(got, _jax_host(batches[i - q.depth]))
            handles.append((i, v.verify_batch_async(triples, queue=q)))
        for i, h in handles:
            got = h.result(60)
            np.testing.assert_array_equal(got, _jax_host(batches[i]))
            assert not got[i] and got.sum() == 5
        assert v._dispatch.fallback_calls == 2

    def test_commit_grid_fault_degrades_to_host_loop(self, queue):
        v = ResilientVerifier(
            V.TableBatchVerifier(device="cpu", min_device_batch=10**6),
            breaker=CircuitBreaker(failure_threshold=1, reset_timeout_s=60),
        )
        keys = det_priv_keys(4)
        pubs = [k.pub_key.data for k in keys]
        msgs = [bytes([i]) * 8 for i in range(4)]
        sigs = [k.sign(m) for k, m in zip(keys, msgs)]
        bad = list(sigs)
        bad[1] = bytes(64)
        fail.set_device_fault("verify")
        got = v.verify_commits_async(pubs, [(msgs, sigs), (msgs, bad)], queue=queue(depth=2)).result(60)
        assert got.shape == (2, 4)
        assert got[0].all() and not got[1][1] and got[1].sum() == 3
        assert v.breaker.state == OPEN


class TestVotePipelineOrdering:
    def test_preverify_handles_join_in_drain_order(self):
        """The JAX consensus drain on a port verifier: batch K+1 is
        submitted while K is in flight, on the consensus loop's own
        queue, and each mask maps back to its own batch."""
        from tendermint_tpu.consensus.state import ConsensusState
        from tendermint_tpu.types import VOTE_TYPE_PREVOTE

        from tests.helpers import make_block_id, make_validators, signed_vote

        vals, privs = make_validators(4)
        bid = make_block_id()

        class _CS:
            VOTE_PIPELINE_DEPTH = 2
            _vote_dispatch = None
            verifier = V.HostBatchVerifier()

            class _State:
                chain_id = "test-chain"

            def __init__(self):
                self.state = self._State()
                self.validators = vals
                self.height = 1
                self._vote_queue = ConsensusState._vote_queue.__get__(self)
                self._preverify_votes_async = ConsensusState._preverify_votes_async.__get__(self)

        cs = _CS()

        def run_votes(r):
            votes = [signed_vote(p, i, 1, r, VOTE_TYPE_PREVOTE, bid) for i, p in enumerate(privs)]
            if r == 1:
                votes[2] = votes[2].with_signature(bytes(64))
            return votes

        try:
            pending, masks = [], []
            for r in range(3):
                if len(pending) >= cs.VOTE_PIPELINE_DEPTH:
                    masks.append(pending.pop(0).result(60))
                pending.append(cs._preverify_votes_async(run_votes(r)))
            masks.extend(h.result(60) for h in pending)
        finally:
            cs._vote_dispatch.close()
        assert masks == [[True] * 4, [True, True, False, True], [True] * 4]


# -- the JAX pipeline and the port's, side by side -----------------------------


def _bomb_verifier(base, host, schedule):
    """A primary of `base` whose launch (stage "launch") or finalize
    (stage "finalize") raises on the calls `schedule` names."""

    class Bomb(base):
        def __init__(self):
            super().__init__()
            self.launches = 0

        def launch_verify_batch(self, triples):
            self.launches += 1
            if schedule.get(self.launches) == "launch":
                raise fail.InjectedDeviceFault("launch died")
            return (self.launches, triples)

        def finalize_verify_batch(self, launched):
            n, triples = launched
            if schedule.get(n) == "finalize":
                raise fail.InjectedDeviceFault("copy back died")
            return host.verify_batch(triples)

        def verify_batch(self, triples):
            return self.finalize_verify_batch(self.launch_verify_batch(triples))

    return Bomb()


def test_jax_and_port_pipelines_agree_handle_for_handle(queue):
    rng = np.random.default_rng(2026)
    schedule = {int(i): str(rng.choice(["launch", "finalize"])) for i in rng.choice(np.arange(1, 13), 5, replace=False)}
    injected = {int(i) for i in rng.choice(np.arange(1, 13), 2, replace=False)}
    batches = [_triples(4, corrupt=(i % 4,)) for i in range(12)]
    sides = {}
    for name, ver, res, circ, disp, fmod in (
        ("jax", J_ver, J_res, J_circuit, J_disp, J_fail),
        ("port", V, P_res, P_circuit, dispatch_mod, fail),
    ):
        transitions = []
        clock = [0.0]
        br = circ.CircuitBreaker(
            failure_threshold=2, reset_timeout_s=1.0, clock=lambda c=clock: c[0],
            on_state_change=lambda old, new, t=transitions: t.append((old, new)),
        )
        primary = _bomb_verifier(ver.BatchVerifier, ver.HostBatchVerifier(), schedule)
        rv = res.ResilientVerifier(primary, breaker=br)
        q = queue(depth=2, name=f"diff-{name}", cls=disp.DispatchQueue)
        masks, pending = [], []
        for i, triples in enumerate(batches, start=1):
            if len(pending) >= q.depth:
                masks.append(pending.pop(0).result(60).tolist())
            if i in injected:
                fmod.set_device_fault("verify", 1)
            clock[0] += 0.6
            pending.append(rv.verify_batch_async(triples, queue=q))
            while not pending[-1].done():  # launched: the fault budget was this call's
                time.sleep(0.001)
            fmod.clear_device_faults()
        masks.extend(h.result(60).tolist() for h in pending)
        sides[name] = (masks, transitions, rv.snapshot(), primary.launches)
    assert sides["jax"] == sides["port"]
    masks, transitions, snap, _ = sides["port"]
    assert masks == [_jax_host(b).tolist() for b in batches]
    assert snap["fallback_calls"] >= 5 and transitions
