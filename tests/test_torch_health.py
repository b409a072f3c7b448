"""The port's health view, telemetry views and contention profiler
(`tendermint_tpu_torch/telemetry/{health,views,profiler}.py`) against the
JAX package's.

The JAX package's own unit cases run again on the port: `build_health`
over a duck-typed node (`tests/test_health.py` `TestBuildHealth`: ok,
an open breaker, a shrunk mesh, no peers, fast sync, a fatal consensus,
stalled commits, an SLO breach reported and not folded, the pipeline
section, an empty ledger) and the SLO's trace boost (`TestSloTraceBoost`);
the profiler's thread classification, collapsed stacks, ranked-lock
contention timing, the on-CPU split, the boost window and the env
arming, and the unified queue-wait and `profile` views
(`tests/test_profiler.py`'s unit classes; `TestProcessTelemetry` and
`TestHealthRoute` run on the port's node in `test_torch_port_node.py`).
`TestHealthTransitions` waits for the port's nemesis (ROADMAP A9).

Across the packages: `build_health` of equal stub nodes over a matrix of
node conditions (apart from its clocks), the thread vocabulary's
subsystems, collapsed lines and the views' shapes agree. Tolerance:
exact.
"""

from __future__ import annotations

import sys
import threading
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu.telemetry import health as J_health
from tendermint_tpu.telemetry import profiler as J_profiler
from tendermint_tpu.telemetry.heightlog import HeightLedger as JHeightLedger
from tendermint_tpu_torch.telemetry import REGISTRY
from tendermint_tpu_torch.telemetry import profiler as profiler_mod
from tendermint_tpu_torch.telemetry import views
from tendermint_tpu_torch.telemetry.health import build_health
from tendermint_tpu_torch.telemetry.heightlog import HeightLedger
from tendermint_tpu_torch.telemetry.profiler import (
    PROFILER,
    ContentionProfiler,
    blocked_reason,
    classify_thread,
    collapse,
)
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture
from tendermint_tpu_torch.utils import lockrank


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
def _observatory_reset():
    """Every test leaves the port's process-wide observatory disarmed and
    empty."""
    yield
    PROFILER.stop()
    PROFILER.reset()
    lockrank.reset_contention()


def _stub_node(ledger_cls=HeightLedger, **over):
    """A minimal duck-typed node for `build_health` (the JAX
    `tests/test_health.py` stub): every field its checks read."""
    ledger = over.pop("ledger", None)
    if ledger is None:
        ledger = ledger_cls()
        now = time.time()
        for h in (1, 2, 3):
            ledger.record({"height": h, "finality_s": 0.2 if h > 1 else None, "t_commit": now})
    verifier = over.pop("verifier", SimpleNamespace(snapshot=lambda: {"state": "closed"}))
    return SimpleNamespace(
        node_id="stub",
        consensus=SimpleNamespace(verifier=verifier, fatal_error=over.pop("fatal", None)),
        blockchain_reactor=SimpleNamespace(fast_sync=over.pop("fast_sync", False)),
        statesync_reactor=None,
        switch=SimpleNamespace(n_peers=lambda: over.pop("peers", 3)),
        block_store=SimpleNamespace(height=3),
        hasher=None,
        height_ledger=ledger,
    )


def _hist_count(name: str, **labels) -> int:
    fam = REGISTRY.get(name)
    if fam is None:
        return 0
    want = tuple(str(labels[n]) for n in fam.labelnames) if labels else ()
    for values, snap in fam.samples():
        if values == want:
            return snap["count"]
    return 0


# -- tests/test_health.py ----------------------------------------------------------------


class TestBuildHealth:
    def test_ok(self):
        h = build_health(_stub_node())
        assert h["status"] == "ok" and h["ready"]
        assert h["checks"]["breakers"]["states"] == {"verifier": "closed"}
        assert h["finality_slo"]["window"] == 2
        assert h["finality_slo"]["ok"]

    def test_open_breaker_degrades(self):
        h = build_health(_stub_node(verifier=SimpleNamespace(snapshot=lambda: {"state": "open"})))
        assert h["status"] == "degraded" and h["ready"]
        assert not h["checks"]["breakers"]["ok"]

    def test_mesh_shrink_degrades(self):
        node = _stub_node(verifier=SimpleNamespace(
            snapshot=lambda: {"state": "closed", "mesh": {"devices_active": 7, "devices_total": 8}}))
        h = build_health(node)
        assert h["status"] == "degraded"
        assert not h["checks"]["mesh"]["ok"]
        assert h["checks"]["mesh"]["devices_active"] == 7

    def test_zero_peers_degrades(self):
        h = build_health(_stub_node(peers=0))
        assert h["status"] == "degraded"
        assert not h["checks"]["peers"]["ok"]

    def test_fast_sync_not_ready(self):
        h = build_health(_stub_node(fast_sync=True))
        assert h["status"] == "not_ready" and not h["ready"]

    def test_fatal_consensus_not_ready(self):
        h = build_health(_stub_node(fatal=RuntimeError("boom")))
        assert h["status"] == "not_ready"
        assert h["checks"]["consensus"]["fatal"] == "RuntimeError"

    def test_stalled_commits_degrade(self):
        ledger = HeightLedger()
        ledger.record({"height": 5, "finality_s": 0.2, "t_commit": time.time() - 3600})
        h = build_health(_stub_node(ledger=ledger))
        assert h["status"] == "degraded"
        assert not h["checks"]["commit_lag"]["ok"]

    def test_slo_breach_reported_not_degrading(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_SLO_BOOST_S", "0")
        ledger = HeightLedger()
        now = time.time()
        for h in range(1, 12):
            ledger.record({"height": h, "finality_s": 5.0, "t_commit": now})
        h = build_health(_stub_node(ledger=ledger))
        assert not h["finality_slo"]["ok"]
        assert h["finality_slo"]["breaches"] == 11
        assert h["status"] == "ok"

    def test_pipeline_section_reported_not_folded(self):
        node = _stub_node()
        node.consensus.pipeline_enabled = True
        node.consensus._pending_apply = {"height": 3}
        node.consensus.pipeline_stats = {"joins": 4, "stalls": 3, "valset_rebuilds": 1, "overlap_s_total": 0.08,
                                         "last_overlap_s": 0.02}
        h = build_health(node)
        assert h["status"] == "ok"
        p = h["pipeline"]
        assert p["enabled"] and p["apply_in_flight"]
        assert p["joins"] == 4 and p["stalls"] == 3
        assert p["valset_rebuilds"] == 1
        assert p["last_overlap_ms"] == pytest.approx(20.0)
        assert p["overlap_ms_mean"] == pytest.approx(20.0)

    def test_pipeline_section_tolerates_stub(self):
        h = build_health(_stub_node())
        assert h["pipeline"]["enabled"] is False
        assert h["pipeline"]["apply_in_flight"] is False

    def test_empty_ledger_is_ok(self):
        h = build_health(_stub_node(ledger=HeightLedger()))
        assert h["status"] == "ok"
        assert h["finality_slo"]["window"] == 0

    def test_device_section_reads_the_ports_launch_ledger(self):
        from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG

        age = LAUNCHLOG.seconds_since_success()
        got = build_health(_stub_node())["device"]["last_launch_age_s"]
        assert (got is None) == (age is None)


class TestSloTraceBoost:
    @pytest.fixture(autouse=True)
    def _reset_boost(self):
        from tendermint_tpu_torch.telemetry import tracectx as tc

        tc._boost_until = 0.0
        yield
        tc._boost_until = 0.0

    def _breaching_ledger(self):
        ledger = HeightLedger()
        now = time.time()
        for h in range(1, 12):
            ledger.record({"height": h, "finality_s": 5.0, "t_commit": now})
        return ledger

    def test_breach_lights_up_tracing(self, monkeypatch):
        from tendermint_tpu_torch.telemetry import tracectx as tc

        monkeypatch.setenv("TENDERMINT_TPU_SLO_BOOST_S", "5")
        assert not tc.sampling_forced()
        h = build_health(_stub_node(ledger=self._breaching_ledger()))
        assert not h["finality_slo"]["ok"]
        assert h["finality_slo"]["trace_boosted"] is True
        assert tc.sampling_forced()
        monkeypatch.setenv(tc.SAMPLE_ENV, "0")
        assert tc.mint("slo-boost-test") is not None

    def test_healthy_window_does_not_boost(self, monkeypatch):
        from tendermint_tpu_torch.telemetry import tracectx as tc

        monkeypatch.setenv("TENDERMINT_TPU_SLO_BOOST_S", "5")
        h = build_health(_stub_node())
        assert h["finality_slo"]["ok"]
        assert "trace_boosted" not in h["finality_slo"]
        assert not tc.sampling_forced()

    def test_boost_knob_zero_disables(self, monkeypatch):
        from tendermint_tpu_torch.telemetry import tracectx as tc

        monkeypatch.setenv("TENDERMINT_TPU_SLO_BOOST_S", "0")
        h = build_health(_stub_node(ledger=self._breaching_ledger()))
        assert not h["finality_slo"]["ok"]
        assert "trace_boosted" not in h["finality_slo"]
        assert not tc.sampling_forced()


# -- tests/test_profiler.py ------------------------------------------------------------

THREAD_VOCABULARY = {
    "consensus-recv": "consensus",
    "consensus-timeout": "consensus",
    "consensus-heartbeat": "consensus",
    "gossip-votes-abcdef": "consensus",
    "mempool-ingress": "ingress",
    "mempool-ingress-join": "ingress",
    "mempool-bcast-abcdef": "p2p_send",
    "verify-coalescer": "coalescer",
    "verify-coalescer-join": "coalescer",
    "dispatch-consensus": "dispatch",
    "dispatch-default": "dispatch",
    "mconn-recv": "p2p_recv",
    "mconn-send": "p2p_send",
    "mconn-ping": "p2p_send",
    "p2p-accept": "p2p_recv",
    "p2p-handshake": "p2p_recv",
    "pex-ensure": "p2p_send",
    "persistent-dial-x": "p2p_send",
    "evidence-gossip": "p2p_send",
    "statesync": "statesync",
    "fastsync": "statesync",
    "rpc-http": "rpc",
    "abci-accept": "abci",
    "abci-conn": "abci",
    "MainThread": "main",
}


class TestClassification:
    def test_name_map_covers_node_thread_vocabulary(self):
        for name, sub in THREAD_VOCABULARY.items():
            assert classify_thread(name) == sub, name

    def test_stack_fallback_classifies_unnamed_threads(self):
        """A thread with a generic name classifies by its innermost frame
        of the package (here one under the port's `p2p/`)."""
        from tendermint_tpu_torch.p2p.connection import parse_frame

        try:
            parse_frame(None)
            pytest.fail("expected a TypeError")
        except Exception as e:
            tb = e.__traceback__
            while tb.tb_next is not None:
                tb = tb.tb_next
            frame = tb.tb_frame
        assert classify_thread("Thread-42 (worker)", frame) == "p2p_recv"

    def test_unknown_is_other(self):
        assert classify_thread("Thread-7") == "other"

    def test_blocked_reason_lock(self):
        cond = threading.Condition()
        seen = threading.Event()

        def waiter():
            with cond:
                seen.set()
                cond.wait(timeout=10)

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        assert seen.wait(5)
        time.sleep(0.05)
        frame = sys._current_frames().get(t.ident)
        assert frame is not None
        assert blocked_reason(frame) == "lock"
        with cond:
            cond.notify_all()
        t.join(5)


class TestCollapsedStacks:
    def test_collapse_golden(self):
        line = collapse("consensus", ("state.py:_receive_loop", "state.py:_handle_vote"), "on_cpu")
        assert line == "consensus;state.py:_receive_loop;state.py:_handle_vote;[on_cpu]"
        assert collapse("ingress", (), "blocked:lock") == "ingress;[blocked:lock]"

    def test_collapsed_output_golden(self):
        p = ContentionProfiler()
        with p._lock:
            p._stacks.update({"consensus;a.py:f;[on_cpu]": 3, "ingress;b.py:g;[blocked:lock]": 7,
                              "consensus;a.py:f;[blocked:other]": 3})
        assert p.collapsed() == ["ingress;b.py:g;[blocked:lock] 7", "consensus;a.py:f;[blocked:other] 3",
                                 "consensus;a.py:f;[on_cpu] 3"]


class TestLockContention:
    def test_two_threads_fighting_one_ranked_lock(self):
        lk = lockrank.RankedLock("profiler.test.lock")
        before = _hist_count("tendermint_lock_wait_seconds", lock="profiler.test.lock")
        lockrank.set_timing(True)
        try:

            def fight():
                for _ in range(60):
                    with lk:
                        time.sleep(0.001)

            ts = [threading.Thread(target=fight) for _ in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
        finally:
            lockrank.set_timing(False)
        rows = {r["lock"]: r for r in lockrank.contention_snapshot()["locks"]}
        row = rows["profiler.test.lock"]
        assert row["wait_count"] == 120
        assert row["hold_count"] == 120
        assert row["wait_s"] > 0.01
        assert row["hold_s"] > 0.1
        assert row["top_sites"], "contended waits must carry a site"
        assert row["top_sites"][0]["site"].startswith("test_torch_health.py:")
        assert _hist_count("tendermint_lock_wait_seconds", lock="profiler.test.lock") > before

    def test_disarmed_records_nothing(self):
        lk = lockrank.RankedLock("profiler.test.idle")
        assert not lockrank.timing_enabled()
        for _ in range(10):
            with lk:
                pass
        assert "profiler.test.idle" not in {r["lock"] for r in lockrank.contention_snapshot()["locks"]}

    def test_condition_integration_times_reacquire(self):
        cond = threading.Condition(lockrank.RankedLock("profiler.test.cond"))
        lockrank.set_timing(True)
        try:
            done = threading.Event()

            def waiter():
                with cond:
                    cond.wait(timeout=5)
                done.set()

            t = threading.Thread(target=waiter, daemon=True)
            t.start()
            time.sleep(0.05)
            with cond:
                cond.notify_all()
            assert done.wait(5)
            t.join(5)
        finally:
            lockrank.set_timing(False)
        rows = {r["lock"]: r for r in lockrank.contention_snapshot()["locks"]}
        assert rows["profiler.test.cond"]["hold_count"] >= 2

    def test_the_profilers_lock_has_its_rank(self):
        assert lockrank.RANKS["telemetry.profiler"] == 62
        assert PROFILER._lock.name == "telemetry.profiler"


@pytest.mark.skipif(not profiler_mod._CPU_CLOCKS, reason="per-thread CPU clocks unavailable")
class TestOnCpuSplit:
    def test_spinner_on_cpu_sleeper_blocked(self):
        stop = threading.Event()

        def spin():
            x = 0
            while not stop.is_set():
                x += 1

        def sleeper():
            while not stop.is_set():
                time.sleep(0.005)

        threading.Thread(target=spin, name="dispatch-bench-spin", daemon=True).start()
        threading.Thread(target=sleeper, name="mconn-recv-bench", daemon=True).start()
        p = ContentionProfiler()
        p.start(hz=100)
        try:
            time.sleep(0.7)
        finally:
            p.stop()
            stop.set()
        snap = p.snapshot()
        assert snap["cpu_clock"] is True
        assert snap["samples"] > 10
        assert "dispatch" in snap["subsystems"]
        assert "p2p_recv" in snap["subsystems"]
        spin_th = snap["threads"]["dispatch-bench-spin"]
        assert spin_th["subsystem"] == "dispatch"
        assert spin_th["samples"] > 5
        assert spin_th["on_cpu"] > spin_th["samples"] * 0.5, spin_th
        sleep_th = snap["threads"]["mconn-recv-bench"]
        assert sleep_th["subsystem"] == "p2p_recv"
        assert sleep_th["samples"] > 5
        assert sleep_th["on_cpu"] < sleep_th["samples"] * 0.5, sleep_th

    def test_boost_window_auto_disarms(self):
        p = ContentionProfiler()
        p.boost(duration_s=0.3, hz=50)
        assert p.running()
        assert lockrank.timing_enabled()
        deadline = time.monotonic() + 5
        while p.running() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not p.running()
        deadline = time.monotonic() + 5
        while lockrank.timing_enabled() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not lockrank.timing_enabled()

    def test_env_arming(self, monkeypatch):
        from tendermint_tpu_torch.telemetry.profiler import maybe_start_env

        monkeypatch.setenv("TENDERMINT_TPU_PROFILE_HZ", "0")
        assert maybe_start_env() is False
        monkeypatch.setenv("TENDERMINT_TPU_PROFILE_HZ", "53")
        try:
            assert maybe_start_env() is True
            assert PROFILER.running()
            assert PROFILER.hz() == 53
        finally:
            PROFILER.stop()


class TestQueueWaitView:
    def test_unified_queue_table(self):
        import numpy as np

        from tendermint_tpu_torch.services.batcher import CoalescingVerifier

        class _Fake:
            def verify_batch(self, triples):
                return np.ones(len(triples), dtype=bool)

        v = CoalescingVerifier(_Fake(), cache_size=0, window_s=0.001)
        try:
            h = v.verify_batch_async([(b"p" * 32, b"m", b"s" * 64)], consumer="consensus")
            assert bool(h.result(timeout=10).all())
        finally:
            v.close()
        table = views.queue_wait_summary(None)
        assert set(table) >= {"dispatch", "coalescer", "ingress", "consensus", "p2p_send"}
        assert table["coalescer"]["consensus"]["count"] >= 1
        row = table["coalescer"]["consensus"]
        assert row["p99_ms"] >= row["p50_ms"] >= 0

    def test_profile_view_shape(self):
        prof = views.collect(None, ["profile"])["profile"]
        assert set(prof) == {"profiler", "locks", "queues"}
        assert "subsystems" in prof["profiler"]
        assert "locks" in prof["locks"]

    def test_launches_view_reads_the_ports_ledger(self):
        from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG

        out = views.collect(None, [("launches", {"n": 4})])["launches"]
        assert out["records"] == LAUNCHLOG.recent(4)
        assert isinstance(out["summary"], dict)

    def test_unknown_and_failing_views_are_omitted(self):
        assert views.collect(None, ["no-such-view", "p2p", "vote_arrivals", "gossip"]) == {}


# -- across the packages ---------------------------------------------------------------


def _unclocked(h):
    h = dict(h)
    h["device"] = {k: v for k, v in h["device"].items() if k != "last_launch_age_s"}
    h["checks"] = dict(h["checks"])
    h["checks"]["commit_lag"] = {k: v for k, v in h["checks"]["commit_lag"].items() if k != "lag_s"}
    return h


HEALTH_CASES = {
    "ok": {},
    "open_breaker": {"verifier": "open"},
    "mesh_shrink": {"verifier": "mesh"},
    "no_peers": {"peers": 0},
    "fast_sync": {"fast_sync": True},
    "fatal": {"fatal": True},
    "stalled": {"ledger": "stalled"},
    "breach": {"ledger": "breach"},
    "empty": {"ledger": "empty"},
    "pipeline": {"pipeline": True},
}


def _case_node(case, ledger_cls):
    spec = dict(HEALTH_CASES[case])
    kw = {}
    if spec.get("verifier") == "open":
        kw["verifier"] = SimpleNamespace(snapshot=lambda: {"state": "open"})
    elif spec.get("verifier") == "mesh":
        kw["verifier"] = SimpleNamespace(
            snapshot=lambda: {"state": "closed", "mesh": {"devices_active": 3, "devices_total": 4}})
    for k in ("peers", "fast_sync"):
        if k in spec:
            kw[k] = spec[k]
    if spec.get("fatal"):
        kw["fatal"] = ValueError("halted")
    now = time.time()
    if spec.get("ledger") == "stalled":
        kw["ledger"] = ledger_cls()
        kw["ledger"].record({"height": 5, "finality_s": 0.2, "t_commit": now - 3600})
    elif spec.get("ledger") == "breach":
        kw["ledger"] = ledger_cls()
        for h in range(1, 12):
            kw["ledger"].record({"height": h, "finality_s": 5.0, "t_commit": now})
    elif spec.get("ledger") == "empty":
        kw["ledger"] = ledger_cls()
    node = _stub_node(ledger_cls=ledger_cls, **kw)
    if spec.get("pipeline"):
        node.consensus.pipeline_enabled = True
        node.consensus._pending_apply = {"height": 3}
        node.consensus.pipeline_stats = {"joins": 4, "stalls": 3, "valset_rebuilds": 1, "overlap_s_total": 0.08,
                                         "last_overlap_s": 0.02}
    return node


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_build_health_equals_the_jax_health(case, monkeypatch):
    monkeypatch.setenv("TENDERMINT_TPU_SLO_BOOST_S", "0")
    got = build_health(_case_node(case, HeightLedger))
    want = J_health.build_health(_case_node(case, JHeightLedger))
    assert _unclocked(got) == _unclocked(want)


def test_thread_classes_equal_the_jax_profiler():
    names = list(THREAD_VOCABULARY) + ["Thread-7", "worker", "lightclient-push", "rpc-profiler", "tpu-profiler"]
    assert [classify_thread(n) for n in names] == [J_profiler.classify_thread(n) for n in names]


def test_collapsed_lines_equal_the_jax_profiler():
    cases = [("consensus", ("a.py:f", "b.py:g"), "on_cpu"), ("other", (), "blocked:io"), ("rpc", ("x.py:h",), "x")]
    for sub, stack, state in cases:
        assert collapse(sub, stack, state) == J_profiler.collapse(sub, stack, state)


def test_idle_snapshots_have_the_jax_shape():
    port, jax = ContentionProfiler().snapshot(), J_profiler.ContentionProfiler().snapshot()
    assert sorted(port) == sorted(jax)
    assert {k: port[k] for k in port if k != "cpu_clock"} == {k: jax[k] for k in jax if k != "cpu_clock"}


def test_the_profile_metric_families_are_cataloged():
    assert REGISTRY.get("tendermint_profile_samples_total") is not None
    assert REGISTRY.get("tendermint_profile_tick_seconds") is not None
