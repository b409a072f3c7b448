"""The port's lock-rank sanitizer (`tendermint_tpu_torch/utils/lockrank.py`)
against the JAX package's `tests/test_lockrank.py` scenarios (its mempool
acceptance run aside: the mempool is not ported), on the lock names the
port builds; the two sanitizers over one acquisition script (violation
kinds and messages equal, exactly); the contention timing; and the port's
lock names held to the JAX package's (the `batcher.shard` seqs and the
`dispatch.global` lock)."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

from tendermint_tpu.utils import lockrank as J_lockrank
from tendermint_tpu_torch.services.batcher import VerifiedSigCache
from tendermint_tpu_torch.telemetry import REGISTRY
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture
from tendermint_tpu_torch.utils import lockrank
from tendermint_tpu_torch.utils.lockrank import (
    LockRankViolation,
    RankedLock,
    RankedRLock,
    ranked_lock,
    ranked_rlock,
)

REPO = pathlib.Path(__file__).resolve().parents[1]

# two ranked names of the port, lower rank first
LO, HI = "batcher.window", "dispatch.state"  # 72, 80


@pytest.fixture(autouse=True)
def _clean_lockrank():
    """Isolate the process-global graph and violations per test; the
    deliberate violations are drained before the guard reads them."""
    lockrank.reset()
    lockrank.set_raise(None)
    yield
    lockrank.set_raise(None)
    lockrank.set_timing(False)
    lockrank.reset()
    lockrank.reset_contention()


@pytest.fixture(autouse=True)
def _port_lockrank_guard(_clean_lockrank):
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))


def test_rank_table_matches_the_jax_package():
    """Every lock the port builds carries the JAX package's rank."""
    assert lockrank.RANKS == {k: J_lockrank.RANKS[k] for k in lockrank.RANKS}
    assert set(lockrank.RANKS) == {
        "consensus.state", "evidence.pool",
        "mempool.avail", "mempool.ingress", "mempool.lane", "mempool.txcache",
        "mempool.wal", "mempool.counter", "mempool.notif", "mempool.trace",
        "telemetry.profiler", "lightclient.cache",
        "dispatch.handle", "batcher.shard", "batcher.window",
        "dispatch.worker", "dispatch.state", "dispatch.global",
        "lightclient.reactor",
        "p2p.switch", "p2p.scorer", "p2p.conn.write", "p2p.flowrate",
    }


class TestRankInversion:
    def test_ascending_order_is_clean(self):
        lo, hi = RankedLock(LO), RankedLock(HI)
        with lo:
            with hi:
                pass
        assert lockrank.violations() == []

    def test_inversion_recorded_with_stack(self):
        lo, hi = RankedLock(LO), RankedLock(HI)
        with hi:
            with lo:
                pass
        vs = lockrank.drain()
        assert len(vs) == 1
        assert vs[0]["kind"] == "rank_inversion"
        assert LO in vs[0]["message"] and HI in vs[0]["message"]
        assert "test_inversion_recorded_with_stack" in lockrank.render_violation(vs[0])

    def test_inversion_report_carries_both_threads_stacks(self):
        lo, hi = RankedLock(LO), RankedLock(HI)

        def legal():
            with lo:
                with hi:
                    time.sleep(0.01)

        t = threading.Thread(target=legal, name="legal-order")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with hi:
            with lo:
                pass
        (v,) = lockrank.drain()
        labels = [s["label"] for s in v["stacks"]]
        assert any("acquire of" in lb for lb in labels)
        assert any("first observed" in lb for lb in labels)
        assert "legal-order" in {s["thread"] for s in v["stacks"]}

    def test_same_rank_ascending_seq_allowed(self):
        shards = [RankedLock("batcher.shard", seq=i) for i in range(4)]
        for s in shards:
            s.acquire()
        for s in reversed(shards):
            s.release()
        assert lockrank.violations() == []

    def test_same_rank_descending_seq_flagged(self):
        shards = [RankedLock("batcher.shard", seq=i) for i in range(2)]
        shards[1].acquire()
        shards[0].acquire()
        shards[0].release()
        shards[1].release()
        vs = lockrank.drain()
        assert len(vs) == 1 and vs[0]["kind"] == "rank_inversion"

    def test_rlock_reentry_is_not_a_violation(self):
        mtx = RankedRLock("dispatch.worker")
        with mtx:
            with mtx:
                pass
        assert lockrank.violations() == []

    def test_unranked_locks_skip_rank_check(self):
        a = RankedLock("custom.a", rank=None)
        b = RankedLock("custom.b", rank=None)
        with b:
            with a:
                pass
        assert lockrank.violations() == []


class TestCycleDetection:
    def test_two_lock_aba_cycle(self):
        a = RankedLock("custom.a", rank=None)
        b = RankedLock("custom.b", rank=None)

        def t1():
            with a:
                with b:
                    pass

        th = threading.Thread(target=t1, name="ab-thread")
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with b:
            with a:  # closes the cycle in the order graph, no contention
                pass
        vs = lockrank.drain()
        assert len(vs) == 1 and vs[0]["kind"] == "cycle"
        assert "custom.a" in vs[0]["message"]
        threads = {s["thread"] for s in vs[0]["stacks"]}
        assert "ab-thread" in threads and len(threads) >= 2

    def test_three_thread_three_lock_cycle(self):
        a, b, c = (RankedLock(f"custom.{x}", rank=None) for x in "abc")

        def nest(outer, inner, name):
            def run():
                with outer:
                    with inner:
                        pass

            t = threading.Thread(target=run, name=name)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()

        nest(a, b, "t-ab")
        nest(b, c, "t-bc")
        nest(c, a, "t-ca")  # a -> b -> c -> a
        vs = [v for v in lockrank.drain() if v["kind"] == "cycle"]
        assert len(vs) == 1
        for name in ("custom.a", "custom.b", "custom.c"):
            assert name in vs[0]["message"]
        assert {"t-ab", "t-bc"} <= {s["thread"] for s in vs[0]["stacks"]}

    def test_no_false_cycle_on_diamond(self):
        a, b, c = (RankedLock(f"custom.{x}", rank=None) for x in "abc")
        for outer, inner in ((a, b), (a, c), (b, c)):
            with outer:
                with inner:
                    pass
        assert lockrank.violations() == []


class TestAbbaRegression:
    def test_abba_deadlock_caught_without_hanging(self):
        """Two threads take A/B in opposite orders with real contention;
        in raise mode the second order raises BEFORE blocking."""
        lockrank.set_raise(True)
        a, b = RankedLock(LO), RankedLock(HI)
        a_held = threading.Event()
        release_a = threading.Event()
        outcomes = {}

        def legal():
            with a:
                a_held.set()
                release_a.wait(5)
                with b:
                    outcomes["legal"] = "ok"

        def inverted():
            a_held.wait(5)
            b.acquire()
            try:
                try:
                    a.acquire()
                    a.release()
                    outcomes["inverted"] = "acquired"
                except LockRankViolation:
                    outcomes["inverted"] = "caught"
            finally:
                b.release()
                release_a.set()

        t1 = threading.Thread(target=legal, name="abba-legal")
        t2 = threading.Thread(target=inverted, name="abba-inverted")
        t1.start()
        t2.start()
        t1.join(10)
        t2.join(10)
        assert not t1.is_alive() and not t2.is_alive(), "ABBA test wedged"
        assert outcomes == {"legal": "ok", "inverted": "caught"}
        assert lockrank.drain()

    def test_raise_knob_from_the_environment(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_LOCKRANK_RAISE", "1")
        lo, hi = RankedLock(LO), RankedLock(HI)
        with hi:
            with pytest.raises(LockRankViolation):
                lo.acquire()
        assert lockrank.drain()


class TestConditionIntegration:
    def test_condition_wait_notify_roundtrip(self):
        cond = threading.Condition(RankedLock(LO))
        hits = []

        def waiter():
            with cond:
                while not hits:
                    if not cond.wait(5):
                        return
            hits.append("woke")

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            hits.append("set")
            cond.notify_all()
        t.join(5)
        assert not t.is_alive()
        assert hits == ["set", "woke"]
        assert lockrank.violations() == []

    def test_condition_lock_participates_in_ranking(self):
        cond = threading.Condition(RankedLock(LO))
        state = RankedRLock(HI)
        with cond:
            with state:
                pass
        assert lockrank.violations() == []
        with state:
            with cond:  # the forbidden direction
                pass
        assert any(v["kind"] == "rank_inversion" for v in lockrank.drain())


class TestDisabledPassThrough:
    def test_factories_return_plain_locks_when_disabled(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_LOCKRANK", "0")
        monkeypatch.delenv("TENDERMINT_TPU_PROFILE_HZ", raising=False)
        lock = ranked_lock(LO)
        rlock = ranked_rlock("dispatch.worker")
        assert type(lock) is type(threading.Lock())
        assert "RLock" in type(rlock).__name__
        hi = ranked_lock(HI)
        with hi:
            with lock:
                pass
        assert lockrank.violations() == []

    def test_factories_instrument_when_enabled(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_LOCKRANK", "1")
        assert isinstance(ranked_lock(LO), RankedLock)
        assert isinstance(ranked_rlock("dispatch.worker"), RankedRLock)

    def test_profile_knob_makes_timing_only_locks(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_LOCKRANK", "0")
        monkeypatch.setenv("TENDERMINT_TPU_PROFILE_HZ", "0")
        lo, hi = ranked_lock(LO), ranked_lock(HI)
        assert isinstance(lo, RankedLock) and not lo.sanitize
        with hi:
            with lo:  # never rank-checked: a timing-only process records nothing
                pass
        assert lockrank.violations() == []


class TestContentionTiming:
    def test_disarmed_records_nothing(self):
        lock = RankedLock(LO)
        with lock:
            pass
        assert lockrank.contention_snapshot() == {"armed": False, "locks": []}

    def test_wait_and_hold_recorded_with_sites(self):
        lockrank.set_timing(True)
        lock = RankedLock(HI)
        held = threading.Event()
        wait0 = REGISTRY.get("tendermint_lock_wait_seconds").labels(lock=HI).value["count"]

        def holder():
            with lock:
                held.set()
                time.sleep(0.05)

        t = threading.Thread(target=holder)
        t.start()
        held.wait(5)
        with lock:  # waits out the holder's 50 ms
            pass
        t.join(5)
        snap = lockrank.contention_snapshot(top=5)
        assert snap["armed"] is True
        (row,) = snap["locks"]
        assert row["lock"] == HI
        assert row["wait_count"] == 2 and row["hold_count"] == 2
        assert row["wait_max_s"] >= 0.02
        assert row["hold_max_s"] >= 0.04
        assert row["top_sites"] and row["top_sites"][0]["site"].startswith("test_torch_lockrank.py:")
        assert REGISTRY.get("tendermint_lock_wait_seconds").labels(lock=HI).value["count"] > wait0
        lockrank.reset_contention()
        assert lockrank.contention_snapshot()["locks"] == []

    def test_snapshot_merges_instances_by_name(self):
        lockrank.set_timing(True)
        shards = [RankedLock("batcher.shard", seq=i) for i in range(3)]
        for s in shards:
            with s:
                pass
        (row,) = lockrank.contention_snapshot()["locks"]
        assert row["lock"] == "batcher.shard" and row["hold_count"] == 3


def _script(mod, raise_mode: bool):
    """One acquisition script (an inversion, a same-rank seq inversion and
    an unranked cycle) on either package's sanitizer; returns the kinds
    and messages it recorded."""
    mod.reset()
    mod.set_raise(raise_mode)
    try:
        lo, hi = mod.RankedLock(LO, rank=72), mod.RankedLock(HI, rank=80)
        s0, s1 = mod.RankedLock("batcher.shard", rank=68, seq=0), mod.RankedLock("batcher.shard", rank=68, seq=1)
        a, b = mod.RankedLock("custom.a", rank=None), mod.RankedLock("custom.b", rank=None)
        for outer, inner in ((lo, hi), (hi, lo), (s1, s0), (a, b), (b, a)):
            with outer:
                try:
                    inner.acquire()
                    inner.release()
                except mod.LockRankViolation:
                    pass
        return [(v["kind"], v["message"]) for v in mod.drain()]
    finally:
        mod.set_raise(None)
        mod.reset()


@pytest.mark.parametrize("raise_mode", [False, True], ids=["record", "raise"])
def test_same_script_same_violations_as_the_jax_sanitizer(raise_mode):
    """Tolerance: exact (kinds and messages)."""
    port = _script(lockrank, raise_mode)
    jax = _script(J_lockrank, raise_mode)
    assert [k for k, _ in port] == ["rank_inversion", "rank_inversion", "cycle"]
    assert port == jax


# -- the port's lock names, held to the JAX package's ---------------------------


def test_sig_cache_shard_locks_carry_their_seq(monkeypatch):
    """`batcher.shard` i carries seq=i, as in the JAX package, so that
    taking the shards in index order is clean."""
    monkeypatch.setenv("TENDERMINT_TPU_LOCKRANK", "1")
    cache = VerifiedSigCache(capacity=64)
    locks = [lock for lock, _od in cache._shards]
    assert [(lk.name, lk.rank, lk.seq) for lk in locks] == [
        ("batcher.shard", 68, i) for i in range(VerifiedSigCache.SHARDS)
    ]
    for lk in locks:
        lk.acquire()
    for lk in reversed(locks):
        lk.release()
    assert lockrank.violations() == []


def test_default_queue_lock_is_dispatch_global():
    """`default_dispatch_queue`'s lock is the ranked `dispatch.global`,
    as in the JAX package, in a process that imports the port under the
    sanitizer."""
    code = (
        "from tendermint_tpu_torch.services import dispatch\n"
        "lk = dispatch._DEFAULT_LOCK\n"
        "print(type(lk).__name__, lk.name, lk.rank)\n"
        "dispatch.default_dispatch_queue().close()\n"
        "from tendermint_tpu_torch.utils import lockrank\n"
        "assert not lockrank.violations(), lockrank.render_report()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), TENDERMINT_TPU_LOCKRANK="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["RankedLock", "dispatch.global", "84"]
