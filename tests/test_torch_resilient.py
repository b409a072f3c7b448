"""The port's circuit breaker, fault injection and resilient wrappers
(`tendermint_tpu_torch/utils/{circuit,fail}.py`,
`services/resilient.py`), scenario for scenario as
`tests/test_resilient.py` drives the JAX package's, on the CPU.

The degradation contract: a sick device backend costs at most
`threshold` failed dispatches before every caller runs on the host
fallback; a recovered device is re-adopted after one successful probe;
verdicts and roots are right in every state. The table-build breaker
degrades small sets to a build on the CPU and large ones to host crypto.
Only injected faults and dispatch timeouts count as failures: a real
kernel error raises to the caller, where the JAX wrapper degrades.
The last test drives one seeded call sequence through the JAX wrapper
and the port's, faults at the same points, and requires the same
verdicts, transitions and counters.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from tendermint_tpu.services import resilient as J_res
from tendermint_tpu.services import verifier as J_ver
from tendermint_tpu.utils import circuit as J_circuit
from tendermint_tpu.utils import fail as J_fail
from tendermint_tpu_torch.services import batcher as B
from tendermint_tpu_torch.services import hasher as H
from tendermint_tpu_torch.services import resilient as P_res
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.services.resilient import ResilientTreeHasher, ResilientVerifier
from tendermint_tpu_torch.telemetry import REGISTRY
from tendermint_tpu_torch.utils import circuit as P_circuit
from tendermint_tpu_torch.utils import fail
from tendermint_tpu_torch.utils.circuit import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
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


def _triples(n, corrupt=()):
    out = []
    for i, k in enumerate(det_priv_keys(n)):
        msg = bytes([i]) * 8
        sig = k.sign(msg)
        if i in corrupt:
            sig = sig[:10] + bytes([sig[10] ^ 0xFF]) + sig[11:]
        out.append((k.pub_key.data, msg, sig))
    return out


def _flaky(base):
    """A programmable primary over `base` (either package's
    BatchVerifier): fails while `broken`, else verifies on its host."""

    class Flaky(base):
        def __init__(self, host):
            super().__init__()
            self.broken = False
            self.calls = 0
            self._host = host

        def verify_batch(self, triples):
            self.calls += 1
            if self.broken:
                raise fail.InjectedDeviceFault("device exploded")
            return self._host.verify_batch(triples)

    return Flaky


_FlakyVerifier = _flaky(V.BatchVerifier)


def _port_flaky():
    return _FlakyVerifier(V.HostBatchVerifier())


class TestCircuitBreaker:
    def test_trips_after_threshold_consecutive_failures(self):
        clock = [0.0]
        br = CircuitBreaker(failure_threshold=3, reset_timeout_s=5.0, clock=lambda: clock[0])
        assert br.state == CLOSED
        for _ in range(2):
            br.record_failure()
        assert br.state == CLOSED
        br.record_failure()
        assert br.state == OPEN
        assert not br.allow()

    def test_success_resets_failure_streak(self):
        br = CircuitBreaker(failure_threshold=2)
        br.record_failure()
        br.record_success()
        br.record_failure()
        assert br.state == CLOSED

    def test_half_open_admits_one_probe(self):
        clock = [0.0]
        br = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0, clock=lambda: clock[0])
        br.record_failure()
        assert br.state == OPEN and not br.allow()
        clock[0] = 5.1
        assert br.state == HALF_OPEN
        assert br.allow()
        assert not br.allow()  # a concurrent caller waits for the probe
        br.record_success()
        assert br.state == CLOSED and br.allow()

    def test_failed_probe_reopens_for_full_window(self):
        clock = [0.0]
        br = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0, clock=lambda: clock[0])
        br.record_failure()
        clock[0] = 5.1
        assert br.allow()
        br.record_failure()
        assert br.state == OPEN
        clock[0] = 10.0
        assert not br.allow()
        clock[0] = 10.3
        assert br.allow()

    def test_state_change_callback_snapshot_and_gauge(self):
        transitions = []
        br = CircuitBreaker(
            failure_threshold=1,
            reset_timeout_s=0.0,
            on_state_change=lambda old, new: transitions.append((old, new)),
            name="verify",
        )
        opened = REGISTRY.counter_value("tendermint_breaker_transitions_total", kind="verify", to=OPEN)
        br.record_failure()
        assert REGISTRY.counter_value("tendermint_breaker_state", kind="verify") == 2
        br.allow()
        br.record_success()
        assert (CLOSED, OPEN) in transitions
        assert transitions[-1][1] == CLOSED
        snap = br.snapshot()
        assert snap["times_opened"] == 1 and snap["total_failures"] == 1
        assert REGISTRY.counter_value("tendermint_breaker_state", kind="verify") == 0
        assert REGISTRY.counter_value("tendermint_breaker_transitions_total", kind="verify", to=OPEN) == opened + 1


class TestResilientVerifier:
    def _rv(self, primary, threshold=2, reset_s=0.05):
        return ResilientVerifier(
            primary,
            breaker=CircuitBreaker(failure_threshold=threshold, reset_timeout_s=reset_s),
            max_retries=0,
        )

    def test_verdicts_correct_in_every_state(self):
        primary = _port_flaky()
        rv = self._rv(primary)
        triples = _triples(4, corrupt=(2,))
        expect = [True, True, False, True]
        assert list(rv.verify_batch(triples)) == expect
        primary.broken = True
        assert list(rv.verify_batch(triples)) == expect
        assert list(rv.verify_batch(triples)) == expect
        assert rv.breaker.state == OPEN and rv.degraded
        calls_when_open = primary.calls
        assert list(rv.verify_batch(triples)) == expect
        assert primary.calls == calls_when_open

    def test_breaker_recloses_after_recovery(self):
        primary = _port_flaky()
        rv = self._rv(primary)
        triples = _triples(2)
        primary.broken = True
        rv.verify_batch(triples)
        rv.verify_batch(triples)
        assert rv.breaker.state == OPEN
        primary.broken = False
        time.sleep(0.06)
        assert list(rv.verify_batch(triples)) == [True, True]
        assert rv.breaker.state == CLOSED and not rv.degraded

    def test_env_fault_injection_counts_down(self):
        primary = _port_flaky()
        rv = self._rv(primary, threshold=5)
        fail.set_device_fault("verify", count=2)
        triples = _triples(2)
        before = primary.calls
        rv.verify_batch(triples)
        rv.verify_batch(triples)
        assert primary.calls == before
        assert list(rv.verify_batch(triples)) == [True, True]
        assert primary.calls == before + 1

    def test_verify_commits_host_fallback_shape(self):
        rv = self._rv(_port_flaky())  # a primary without verify_commits
        keys = det_priv_keys(3)
        pubs = [k.pub_key.data for k in keys]
        msgs = [bytes([i]) for i in range(3)]
        sigs = [k.sign(m) for k, m in zip(keys, msgs)]
        commits = [(msgs, sigs), ([msgs[0], None, msgs[2]], [sigs[0], None, sigs[2]])]
        grid = rv.verify_commits(pubs, commits)
        assert grid.shape == (2, 3)
        assert grid[0].tolist() == [True, True, True]
        assert grid[1].tolist() == [True, False, True]

    def test_dispatch_timeout_counts_as_failure(self):
        class Hanging(V.BatchVerifier):
            def verify_batch(self, triples):
                time.sleep(0.5)
                return np.ones(len(triples), dtype=bool)

        rv = ResilientVerifier(
            Hanging(),
            breaker=CircuitBreaker(failure_threshold=1, reset_timeout_s=60),
            max_retries=0,
            dispatch_timeout_s=0.1,
        )
        try:
            assert list(rv.verify_batch(_triples(1))) == [True]  # the host answered
            assert rv.breaker.state == OPEN
        finally:
            rv._dispatch._executor.shutdown(wait=True)


class TestResilientTreeHasher:
    class _FlakyHasher(H.TreeHasher):
        def __init__(self):
            super().__init__(backend="host")
            self.broken = False

        def root_from_items(self, items):
            if self.broken:
                raise fail.InjectedDeviceFault("device tree exploded")
            return super().root_from_items(items)

    def test_roots_identical_across_degradation(self):
        primary = self._FlakyHasher()
        rh = ResilientTreeHasher(
            primary, breaker=CircuitBreaker(failure_threshold=1, reset_timeout_s=60), max_retries=0
        )
        items = [bytes([i]) * 10 for i in range(7)]
        healthy = rh.root_from_items(items)
        primary.broken = True
        degraded = rh.root_from_items(items)
        assert healthy == degraded
        assert rh.breaker.state == OPEN
        assert degraded == H.TreeHasher(backend="host").root_from_items(items)

    def test_hash_fault_injection_on_the_device_hasher(self):
        """An injected hash fault answers from the host tree; the device
        hasher here is the port's plain torch tree on the CPU."""
        rh = ResilientTreeHasher(
            H.TreeHasher(device="cpu", min_device_leaves=0),
            breaker=CircuitBreaker(failure_threshold=1, reset_timeout_s=60),
            max_retries=0,
        )
        items = [b"a", b"b", b"c"]
        want = H.TreeHasher(backend="host").root_from_items(items)
        assert rh.root_from_items(items) == want  # healthy: the torch tree
        fail.set_device_fault("hash")
        assert rh.root_from_items(items) == want
        assert rh.breaker.state == OPEN
        assert rh.snapshot()["fallback_calls"] == 1


class TestFaultSpecParsing:
    def test_env_spec_kinds_and_budgets(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_DEVICE_FAIL", "verify:1,hash")
        monkeypatch.setattr(fail, "_device_faults", None)
        with pytest.raises(fail.InjectedDeviceFault):
            fail.device_fail_point("verify")
        fail.device_fail_point("verify")  # the budget of 1 is spent
        for _ in range(2):
            with pytest.raises(fail.InjectedDeviceFault):
                fail.device_fail_point("hash")  # unbounded

    def test_all_kind_hits_everything_and_the_state_is_the_ports_own(self):
        fail.set_device_fault("all")
        for kind in ("verify", "hash", "tables"):
            with pytest.raises(fail.InjectedDeviceFault):
                fail.device_fail_point(kind)
        J_fail.device_fail_point("verify")  # the JAX module is not armed
        fail.clear_device_faults()
        fail.device_fail_point("verify")
        J_fail.set_device_fault("verify")
        fail.device_fail_point("verify")  # nor does arming JAX arm the port
        with pytest.raises(J_fail.InjectedDeviceFault):
            J_fail.device_fail_point("verify")

    def test_default_factories_hand_out_the_jax_layering(self, monkeypatch):
        monkeypatch.setattr(V, "_DEFAULTS", {})
        monkeypatch.setattr(H, "_DEFAULTS", {})
        v = V.default_verifier(device="cpu")
        try:
            assert isinstance(v, B.CoalescingVerifier)
            assert isinstance(v.inner, ResilientVerifier)
            assert isinstance(v.inner.primary, V.TableBatchVerifier)
            assert isinstance(v.inner.fallback, V.HostBatchVerifier)
            assert v.inner.primary.device == torch.device("cpu")
            h = H.auto_hasher("cpu")
            assert isinstance(h, ResilientTreeHasher) and h.primary.backend == "device"
            assert h.fallback.backend == "host"
            monkeypatch.setenv("TENDERMINT_TPU_COALESCE", "0")
            monkeypatch.setattr(V, "_DEFAULTS", {})
            v2 = V.default_verifier(device="cpu")
            assert type(v2) is ResilientVerifier
            assert isinstance(v2.primary, V.TableBatchVerifier)
        finally:
            v.close()


class TestTableBuildBreaker:
    """Table construction behind its own breaker: an injected build
    fault degrades (small sets build on the CPU, large ones answer with
    host crypto) and never raises out of `verify_commits`."""

    def _commit_shape(self, n, corrupt=()):
        triples = _triples(n, corrupt=corrupt)
        return [t[0] for t in triples], [([t[1] for t in triples], [t[2] for t in triples])]

    def test_build_fault_builds_small_sets_on_the_cpu(self):
        tv = V.TableBatchVerifier(device="cpu", min_device_batch=0)
        pubs, commits = self._commit_shape(3, corrupt=(1,))
        fail.set_device_fault("tables", 1)
        tables, ok = tv._build_tables(tuple(pubs))
        assert ok.all() and tables.shape == (64, 16, 60, 3)
        snap = tv._build_breaker.snapshot()
        assert snap["total_failures"] == 1 and snap["state"] == CLOSED
        # the degraded build serves the plain torch verify chain
        want, _ = V.build_key_tables(np.frombuffer(b"".join(pubs), np.uint8).reshape(3, 32), device="cpu")
        assert torch.equal(tables, want)
        fail.set_device_fault("tables", 1)
        assert tv.verify_commits(pubs, commits).tolist() == [[True, False, True]]

    def test_build_fault_on_large_set_degrades_to_host_crypto(self):
        tv = V.TableBatchVerifier(device="cpu", min_device_batch=1)
        tv.MAX_INCREMENTAL_KEYS = 0  # every set counts as too large
        fail.set_device_fault("tables")
        pubs, commits = self._commit_shape(3, corrupt=(1,))
        out = tv.verify_commits(pubs, commits)
        assert out.tolist() == [[True, False, True]]
        assert tv._tables == {}  # nothing was built

    def test_open_build_breaker_stops_dialing_device_builds(self):
        tv = V.TableBatchVerifier(device="cpu", min_device_batch=1)
        tv.MAX_INCREMENTAL_KEYS = 0
        tv._build_breaker = CircuitBreaker(failure_threshold=2, reset_timeout_s=60)
        fail.set_device_fault("tables")
        pubs, commits = self._commit_shape(2)
        tv.verify_commits(pubs, commits)
        tv.verify_commits(pubs, commits)
        assert tv._build_breaker.state == OPEN
        fail.clear_device_faults()
        with pytest.raises(V.TableBuildError):
            tv._build_tables(tuple(pubs))
        assert tv.verify_commits(pubs, commits).all()

    def test_table_build_telemetry_counters(self):
        tv = V.TableBatchVerifier(device="cpu", min_device_batch=1)
        before = REGISTRY.counter_value("tendermint_verify_table_cache_total", event="host_build")
        pubs, _ = self._commit_shape(2)
        fail.set_device_fault("tables", 1)
        tv._build_tables(tuple(pubs))
        after = REGISTRY.counter_value("tendermint_verify_table_cache_total", event="host_build")
        assert after == before + 1


class _Broken(V.BatchVerifier):
    """A primary whose every stage raises a real (not injected) error."""

    def verify_batch(self, triples):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    launch_verify_batch = verify_batch

    def verify_commits(self, pubkeys, commits, force_fused=None):
        raise RuntimeError("nvcc failed")


class _BrokenAtJoin(V.BatchVerifier):
    def launch_verify_batch(self, triples):
        return triples

    def finalize_verify_batch(self, launched):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


class TestRealErrorsRaise:
    """Only injected faults and dispatch timeouts degrade to the host: a
    real build, launch or CUDA error of a kernel raises to the caller and
    leaves the breaker and the counters as they were."""

    @pytest.mark.parametrize("entry", ["verify_batch", "verify_commits", "async_launch", "async_finalize"])
    def test_verifier_raises_and_leaves_the_breaker_closed(self, entry):
        from tendermint_tpu_torch.services.dispatch import DispatchQueue

        rv = ResilientVerifier(
            _BrokenAtJoin() if entry == "async_finalize" else _Broken(),
            breaker=CircuitBreaker(failure_threshold=1, reset_timeout_s=60),
            max_retries=2,
        )
        failures0 = REGISTRY.counter_value("tendermint_device_dispatch_failures_total", kind="verify")
        triples = _triples(2)
        q = DispatchQueue(depth=1, name=f"t-real-{entry}")
        try:
            with pytest.raises(RuntimeError, match="nvcc|CUDA error"):
                if entry == "verify_batch":
                    rv.verify_batch(triples)
                elif entry == "verify_commits":
                    rv.verify_commits([t[0] for t in triples], [([t[1] for t in triples], [t[2] for t in triples])])
                else:
                    rv.verify_batch_async(triples, queue=q).result(timeout=20)
        finally:
            q.close()
        snap = rv.snapshot()
        assert snap["state"] == CLOSED and snap["total_failures"] == 0
        assert snap["fallback_calls"] == 0 and snap["primary_calls"] == 0
        assert REGISTRY.counter_value("tendermint_device_dispatch_failures_total", kind="verify") == failures0

    def test_hasher_raises_on_a_real_device_error(self):
        class BrokenTree(H.TreeHasher):
            def __init__(self):
                super().__init__(backend="host")

            def root_from_items(self, items):
                raise RuntimeError("CUDA error: launch failure")

        rh = ResilientTreeHasher(BrokenTree(), breaker=CircuitBreaker(failure_threshold=1, reset_timeout_s=60))
        with pytest.raises(RuntimeError, match="launch failure"):
            rh.root_from_items([b"a", b"b"])
        assert rh.breaker.state == CLOSED and rh.snapshot()["fallback_calls"] == 0

    def test_real_table_build_error_raises_through_verify_commits(self, monkeypatch):
        def broken_build(*_a, **_k):
            raise RuntimeError("CUDA error: out of memory")

        monkeypatch.setattr(V, "build_key_tables", broken_build)
        tv = V.TableBatchVerifier(device="cpu", min_device_batch=0)
        triples = _triples(2)
        with pytest.raises(RuntimeError, match="out of memory"):
            tv.verify_commits([t[0] for t in triples], [([t[1] for t in triples], [t[2] for t in triples])])
        assert tv._build_breaker.snapshot()["total_failures"] == 0 and tv._tables == {}


# -- the JAX wrapper and the port's, side by side ------------------------------


def _stack(pkg):
    """(ResilientVerifier over a flaky primary, the primary, transitions)
    of one package, on a shared fake clock."""
    ver, res, circ = pkg
    clock = [0.0]
    transitions = []
    br = circ.CircuitBreaker(
        failure_threshold=2,
        reset_timeout_s=1.0,
        clock=lambda: clock[0],
        on_state_change=lambda old, new: transitions.append((old, new)),
    )
    primary = _flaky(ver.BatchVerifier)(ver.HostBatchVerifier())
    rv = res.ResilientVerifier(primary, breaker=br, max_retries=1)
    return rv, primary, transitions, clock


def test_jax_and_port_wrappers_agree_call_for_call(monkeypatch):
    """A seeded sequence of verify_batch / verify_commits calls, with the
    primary failing on schedule, injected faults armed at the same
    points and the breakers' clocks moved together."""
    # no backoff sleeps: the schedule, not the clock, decides
    for mod in (J_res, P_res):
        monkeypatch.setattr(mod, "backoff_delay", lambda *a, **k: 0.0)
    jax_side = _stack((J_ver, J_res, J_circuit))
    port_side = _stack((V, P_res, P_circuit))
    rng = np.random.default_rng(606)
    triples = _triples(5, corrupt=(3,))
    pubs = [t[0] for t in triples]
    commits = [([t[1] for t in triples], [t[2] for t in triples])]
    trace = {"jax": [], "port": []}
    for step in range(24):
        broken = bool(rng.random() < 0.4)
        fault = int(rng.integers(0, 3)) if rng.random() < 0.2 else 0
        advance = float(rng.choice([0.0, 0.5, 1.2]))
        as_commit = bool(rng.random() < 0.3)
        for name, (rv, primary, _tr, clock), fmod in (("jax", jax_side, J_fail), ("port", port_side, fail)):
            primary.broken = broken
            if fault:
                fmod.set_device_fault("verify", fault)
            clock[0] += advance
            out = rv.verify_commits(pubs, commits) if as_commit else rv.verify_batch(triples)
            fmod.clear_device_faults()
            trace[name].append((step, np.asarray(out).tolist(), rv.breaker.state, primary.calls))
    assert trace["jax"] == trace["port"]
    assert jax_side[2] == port_side[2] and len(port_side[2]) >= 2  # the same transitions
    j_snap, p_snap = jax_side[0].snapshot(), port_side[0].snapshot()
    assert j_snap == p_snap
    assert p_snap["fallback_calls"] > 0 and p_snap["primary_calls"] > 0
