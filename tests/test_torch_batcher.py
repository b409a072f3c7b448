"""The port's verify coalescer and verified-signature cache
(`tendermint_tpu_torch/services/batcher.py`), scenario for scenario as
`tests/test_batcher.py` drives the JAX package's, on the CPU.

Negatives are never cached; cache keys cannot alias across field
boundaries; round-robin fairness; the three flush reasons; per-consumer
order with device faults mid-coalesce; lane filtering on commit grids;
the JAX host plane (`ValidatorSet.verify_commit_batched`, the
certifier) on a port stack; `force_fused` passed through every layer
down to the plain torch chains. The last test drives one seeded sequence
through the JAX stack and the port's and requires the same verdicts,
cache traffic and counters. Every coalescer a test makes is closed when
it ends.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.keys import gen_priv_key
from tendermint_tpu.services import batcher as J_bat
from tendermint_tpu.services import resilient as J_res
from tendermint_tpu.services import verifier as J_ver
from tendermint_tpu.telemetry import REGISTRY as J_REGISTRY
from tendermint_tpu.utils import circuit as J_circuit
from tendermint_tpu.utils import fail as J_fail
from tendermint_tpu_torch.services import batcher as P_bat
from tendermint_tpu_torch.services import resilient as P_res
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.services.batcher import (
    CoalescingVerifier,
    VerifiedSigCache,
    VerifyCoalescer,
    consumer_kwargs,
)
from tendermint_tpu_torch.services.resilient import ResilientVerifier
from tendermint_tpu_torch.telemetry import REGISTRY
from tendermint_tpu_torch.utils import circuit as P_circuit
from tendermint_tpu_torch.utils import fail
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture

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
def closing():
    """Registers coalescers (and coalescing verifiers) to close when the
    test ends, so no flush or join thread outlives it."""
    made = []

    def keep(obj):
        made.append(obj)
        return obj

    yield keep
    for obj in made:
        obj.close()


def _triples(n, salt=b"", start=0):
    out = []
    for i in range(start, start + n):
        priv = gen_priv_key(bytes([i % 251 + 1]) * 32)
        msg = b"batcher-msg-%d-" % i + salt
        out.append((priv.pub_key.data, msg, priv.sign(msg)))
    return out


def _counter(name, **labels):
    return REGISTRY.counter_value(name, **labels)


class _CountingVerifier(V.BatchVerifier):
    """Host verifier that records every underlying verify call."""

    def __init__(self):
        super().__init__()
        self._host = V.HostBatchVerifier()
        self.calls: list[int] = []
        self.lock = threading.Lock()

    def verify_batch(self, triples):
        with self.lock:
            self.calls.append(len(triples))
        return self._host.verify_batch(triples)


class TestVerifiedSigCache:
    def test_positive_only_contract_and_hit_metrics(self):
        cache = VerifiedSigCache(capacity=64)
        key = VerifiedSigCache.key(*_triples(1)[0])
        h0 = _counter("tendermint_verify_cache_hits_total")
        m0 = _counter("tendermint_verify_cache_misses_total")
        assert not cache.hit(key)
        cache.add(key)
        assert cache.hit(key)
        assert _counter("tendermint_verify_cache_hits_total") == h0 + 1
        assert _counter("tendermint_verify_cache_misses_total") == m0 + 1

    def test_lru_eviction_bounded_and_counted(self):
        cache = VerifiedSigCache(capacity=VerifiedSigCache.SHARDS * 4)
        e0 = _counter("tendermint_verify_cache_evictions_total")
        for i in range(VerifiedSigCache.SHARDS * 16):
            cache.add(VerifiedSigCache.key(b"\x01" * 32, b"m%d" % i, b"\x02" * 64))
        assert len(cache) <= cache.capacity
        assert _counter("tendermint_verify_cache_evictions_total") > e0

    def test_key_never_aliases_across_field_boundaries_and_matches_jax(self):
        rng = random.Random(0xBEEF)
        for _trial in range(50):
            blob = bytes(rng.getrandbits(8) for _ in range(rng.randint(3, 48)))
            keys = set()
            splits = 0
            for a in range(len(blob) + 1):
                for b in range(a, len(blob) + 1):
                    k = VerifiedSigCache.key(blob[:a], blob[a:b], blob[b:])
                    assert k == J_bat.VerifiedSigCache.key(blob[:a], blob[a:b], blob[b:])
                    keys.add(k)
                    splits += 1
            assert len(keys) == splits

    def test_shifted_msg_vs_pubkey_boundary(self):
        pk, msg, sig = b"\xaa" * 32, b"hello-world", b"\x05" * 64
        k1 = VerifiedSigCache.key(pk, msg, sig)
        k2 = VerifiedSigCache.key(pk + msg[:1], msg[1:], sig)
        k3 = VerifiedSigCache.key(pk, msg + sig[:1], sig[1:])
        assert len({k1, k2, k3}) == 3

    def test_concurrent_add_and_hit(self):
        cache = VerifiedSigCache(capacity=1024)
        keys = [VerifiedSigCache.key(b"\x07" * 32, b"c%d" % i, b"\x01" * 64) for i in range(256)]
        errors = []

        def worker(seed):
            rng = random.Random(seed)
            try:
                for _ in range(500):
                    k = keys[rng.randrange(len(keys))]
                    if rng.random() < 0.5:
                        cache.add(k)
                    else:
                        cache.hit(k)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert len(cache) <= cache.capacity


class TestNegativeVerdictsNeverCached:
    def test_forged_sig_for_cached_positive_pubkey_rejected(self, closing):
        v = closing(CoalescingVerifier(V.HostBatchVerifier(), window_s=0.001))
        (pk, msg, sig) = _triples(1, salt=b"neg")[0]
        assert v.verify_batch([(pk, msg, sig)]).all()
        forged = b"\xff" * 64
        assert not v.verify_batch([(pk, msg, forged)]).any()
        assert not v.verify_batch([(pk, b"other-msg", forged)]).any()
        assert not v.verify_batch_async([(pk, msg, forged)], consumer="rpc").result(timeout=10).any()
        assert VerifiedSigCache.key(pk, msg, forged) not in v.cache
        assert v.verify_batch([(pk, msg, sig)]).all()

    def test_failed_lane_reverifies_every_time(self, closing):
        counting = _CountingVerifier()
        v = closing(CoalescingVerifier(counting, window_s=0.001))
        (pk, msg, _sig) = _triples(1, salt=b"re")[0]
        bad = (pk, msg, b"\x01" * 64)
        for _ in range(3):
            assert not v.verify_batch([bad]).any()
        assert len(counting.calls) == 3


class TestFlushReasons:
    @staticmethod
    def _wait_done(*handles, timeout=10.0):
        """Wait for the flush WITHOUT joining: result() on an unflushed
        request would trigger a barrier and mask the reason under test."""
        deadline = time.monotonic() + timeout
        while not all(h.done() for h in handles):
            if time.monotonic() > deadline:
                raise TimeoutError("coalesced handles never resolved")
            time.sleep(0.002)

    def test_window_flush_merges_concurrent_consumers(self, closing):
        counting = _CountingVerifier()
        v = closing(VerifyCoalescer(counting, cache=None, window_s=0.05, max_batch=4096))
        f0 = _counter("tendermint_batcher_flush_total", reason="window")
        h1 = v.submit(_triples(3, salt=b"w1"), consumer="consensus")
        h2 = v.submit(_triples(3, salt=b"w2", start=100), consumer="fastsync")
        self._wait_done(h1, h2)
        assert h1.result(timeout=10).all() and h2.result(timeout=10).all()
        assert counting.calls == [6]
        assert _counter("tendermint_batcher_flush_total", reason="window") == f0 + 1

    def test_size_flush_fires_before_window(self, closing):
        counting = _CountingVerifier()
        v = closing(VerifyCoalescer(counting, cache=None, window_s=10.0, max_batch=4))
        s0 = _counter("tendermint_batcher_flush_total", reason="size")
        h = v.submit(_triples(4, salt=b"sz"), consumer="consensus")
        self._wait_done(h)
        assert h.result(timeout=10).all()
        assert _counter("tendermint_batcher_flush_total", reason="size") == s0 + 1

    def test_barrier_flush_on_early_join(self, closing):
        counting = _CountingVerifier()
        v = closing(VerifyCoalescer(counting, cache=None, window_s=30.0, max_batch=4096))
        b0 = _counter("tendermint_batcher_flush_total", reason="barrier")
        t0 = time.perf_counter()
        h = v.submit(_triples(2, salt=b"bar"), consumer="statesync")
        assert h.result(timeout=10).all()
        assert time.perf_counter() - t0 < 5.0
        assert _counter("tendermint_batcher_flush_total", reason="barrier") == b0 + 1

    def test_coalesce_factor_and_wait_telemetry_move(self, closing):
        v = closing(VerifyCoalescer(_CountingVerifier(), cache=None, window_s=0.05))
        fam = REGISTRY.get("tendermint_batcher_coalesce_factor")
        c0 = fam.value["count"]
        h1 = v.submit(_triples(1, salt=b"cf1"), consumer="consensus")
        h2 = v.submit(_triples(1, salt=b"cf2", start=50), consumer="rpc")
        h1.result(timeout=10)
        h2.result(timeout=10)
        assert fam.value["count"] > c0
        assert REGISTRY.get("tendermint_batcher_wait_seconds").labels(consumer="consensus").value["count"] > 0


class TestFairness:
    def test_starving_consumer_rides_the_first_take(self, monkeypatch, closing):
        v = closing(VerifyCoalescer(_CountingVerifier(), cache=None, window_s=30.0, max_batch=8))
        monkeypatch.setattr(v, "_ensure_threads", lambda: None)  # the flusher parked
        hot = [v.submit(_triples(4, salt=b"hot%d" % i, start=10 * i), "fastsync") for i in range(6)]
        v.submit(_triples(1, salt=b"starve", start=200), "rpc")
        with v._cond:
            first = v._take_locked()
        consumers = [r.consumer for r in first]
        assert consumers == ["fastsync", "rpc", "fastsync"]
        assert first[0] is hot[0]._req and first[2] is hot[1]._req

    def test_rotation_does_not_pin_the_first_consumer(self, monkeypatch, closing):
        v = closing(VerifyCoalescer(_CountingVerifier(), cache=None, window_s=30.0, max_batch=1))
        monkeypatch.setattr(v, "_ensure_threads", lambda: None)
        v.submit(_triples(1, salt=b"a"), "consensus")
        v.submit(_triples(1, salt=b"b", start=50), "rpc")
        v.submit(_triples(1, salt=b"c", start=60), "consensus")
        v.submit(_triples(1, salt=b"d", start=70), "rpc")
        takes = []
        for _ in range(4):
            with v._cond:
                takes.extend(r.consumer for r in v._take_locked())
        assert set(takes[:2]) == {"consensus", "rpc"}

    def test_per_consumer_fifo_order_is_preserved(self, closing):
        v = closing(VerifyCoalescer(_CountingVerifier(), cache=None, window_s=30.0, max_batch=3))
        batches = [_triples(2, salt=b"fifo%d" % i, start=20 * i) for i in range(4)]
        handles = [v.submit(b, consumer="consensus") for b in batches]
        v.request_barrier()
        for h in handles:
            assert h.result(timeout=10).all()


class TestFaultsMidCoalesce:
    def test_drain_order_with_breaker_faults(self, closing):
        # the default minimum keeps these small launches on the host
        # short-circuit; the injected faults fire before the backend runs
        inner = ResilientVerifier(V.DeviceBatchVerifier(device="cpu"))
        v = closing(CoalescingVerifier(inner, cache_size=0, window_s=0.005))
        fail.set_device_fault("verify", 2)
        good = _triples(3, salt=b"fault")
        bad = [(good[0][0], good[0][1], b"\x09" * 64)]
        handles = []
        for _ in range(4):
            handles.append(v.verify_batch_async(good, consumer="consensus"))
            handles.append(v.verify_batch_async(bad, consumer="rpc"))
        for i, h in enumerate(handles):
            out = h.result(timeout=20)
            assert out.all() if i % 2 == 0 else not out.any(), i

    def test_cache_hits_never_mask_a_breaker_faulted_launch(self, closing):
        inner = ResilientVerifier(V.DeviceBatchVerifier(device="cpu"))
        v = closing(CoalescingVerifier(inner, window_s=0.005))
        fb0 = _counter("tendermint_device_fallback_calls_total", kind="verify")
        fail.set_device_fault("verify")
        good = _triples(2, salt=b"mask")
        forged = (good[0][0], good[0][1], b"\x0c" * 64)
        assert v.verify_batch_async(good, consumer="consensus").result(timeout=20).all()
        assert _counter("tendermint_device_fallback_calls_total", kind="verify") > fb0
        out = v.verify_batch_async(good + [forged], consumer="consensus").result(timeout=20)
        assert out[0] and out[1] and not out[2]
        assert VerifiedSigCache.key(*forged) not in v.cache


class TestCommitGridDedup:
    def _commit_fixture(self, n=4):
        triples = _triples(n, salt=b"grid")
        return [t[0] for t in triples], [([t[1] for t in triples], [t[2] for t in triples])], triples

    def test_cached_lanes_skip_the_backend(self, closing):
        counting = _CountingVerifier()
        v = closing(CoalescingVerifier(counting, window_s=0.001))
        pubs, commits, triples = self._commit_fixture()
        assert v.verify_batch(triples).all()
        calls_before = len(counting.calls)
        assert v.verify_commits(pubs, commits).all()
        assert len(counting.calls) == calls_before

    def test_partial_cache_sends_only_novel_lanes(self, closing):
        counting = _CountingVerifier()
        v = closing(CoalescingVerifier(counting, window_s=0.001))
        pubs, commits, triples = self._commit_fixture()
        assert v.verify_batch(triples[:2]).all()
        assert v.verify_commits_async(pubs, commits, consumer="fastsync").result(timeout=10).all()
        assert counting.calls[-1] == 2

    def test_forged_lane_rejected_despite_cached_neighbors(self, closing):
        v = closing(CoalescingVerifier(V.HostBatchVerifier(), window_s=0.001))
        pubs, commits, triples = self._commit_fixture()
        assert v.verify_batch(triples).all()
        msgs, sigs = [list(x) for x in commits[0]]
        sigs[1] = b"\x0d" * 64
        grid = v.verify_commits(pubs, [(msgs, sigs)])
        assert grid[0, 0] and grid[0, 2] and grid[0, 3] and not grid[0, 1]


class TestValidatorSetRouting:
    """The JAX host plane's consumers on a port coalescing stack."""

    def _chain_fixture(self, n_vals=4):
        from tendermint_tpu.testing.nemesis import make_genesis
        from tendermint_tpu.types import BlockID
        from tendermint_tpu.types.part_set import PartSetHeader
        from tendermint_tpu.types.vote import VOTE_TYPE_PRECOMMIT, Vote
        from tendermint_tpu.types.vote_set import VoteSet

        genesis, privs = make_genesis(n_vals, chain_id="batcher-vs")
        valset = genesis.validator_set()
        block_id = BlockID(b"\x11" * 20, PartSetHeader(total=1, hash=b"\x22" * 20))
        vote_set = VoteSet("batcher-vs", 5, 0, VOTE_TYPE_PRECOMMIT, valset)
        for i, priv in enumerate(privs):
            vote = Vote(
                validator_address=priv.address, validator_index=i, height=5, round=0,
                timestamp=1, type=VOTE_TYPE_PRECOMMIT, block_id=block_id,
            )
            vote_set.add_vote(priv.sign_vote("batcher-vs", vote))
        return valset, block_id, vote_set.make_commit()

    def test_verify_commit_batched_through_coalescer(self, closing):
        valset, block_id, commit = self._chain_fixture()
        v = closing(CoalescingVerifier(V.HostBatchVerifier(), window_s=0.001))
        valset.verify_commit_batched("batcher-vs", [(block_id, 5, commit)], verifier=v, consumer="statesync")
        h0 = _counter("tendermint_verify_cache_hits_total")
        valset.verify_commit_batched("batcher-vs", [(block_id, 5, commit)], verifier=v, consumer="rpc")
        assert _counter("tendermint_verify_cache_hits_total") >= h0 + 4

    def test_certifier_walk_hits_the_cache(self, closing):
        from tendermint_tpu.certifiers.certifier import StaticCertifier

        valset, block_id, commit = self._chain_fixture()
        v = closing(CoalescingVerifier(V.HostBatchVerifier(), window_s=0.001))
        entries = [(block_id, 5, commit)]
        cert = StaticCertifier("batcher-vs", valset, verifier=v)
        m0 = _counter("tendermint_verify_cache_misses_total")
        valset.verify_commit_batched("batcher-vs", entries, verifier=v, consumer=cert.consumer)
        assert _counter("tendermint_verify_cache_misses_total") - m0 >= 4
        m1 = _counter("tendermint_verify_cache_misses_total")
        valset.verify_commit_batched("batcher-vs", entries, verifier=v, consumer=cert.consumer)
        assert _counter("tendermint_verify_cache_misses_total") == m1

    def test_consumer_kwargs_gate(self, closing):
        v = closing(CoalescingVerifier(V.HostBatchVerifier(), window_s=0.001))
        assert consumer_kwargs(v, "rpc") == {"consumer": "rpc"}
        assert J_bat.consumer_kwargs(v, "rpc") == {"consumer": "rpc"}  # the host plane's gate

        class _Minimal:
            def verify_batch(self, triples):
                return np.ones(len(triples), dtype=bool)

        assert consumer_kwargs(_Minimal(), "rpc") == {}


class TestDedupConcurrency:
    def test_overlapping_submissions_from_many_threads(self, closing):
        counting = _CountingVerifier()
        v = closing(CoalescingVerifier(counting, window_s=0.002))
        shared = _triples(8, salt=b"conc")
        errors = []

        def worker(seed):
            rng = random.Random(seed)
            try:
                for _ in range(20):
                    batch = rng.sample(shared, rng.randint(1, len(shared)))
                    out = v.verify_batch_async(batch, consumer=f"c{seed % 4}").result(timeout=20)
                    if not np.asarray(out).all():
                        errors.append(("verdict", batch))
            except Exception as e:
                errors.append(("exc", e))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert sum(counting.calls) < 300


class TestAdaptiveKnobs:
    def test_window_env_wins(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_COALESCE_WINDOW_MS", "7")
        assert P_bat._adaptive_window_s() == pytest.approx(0.007)

    def test_window_from_launch_mean_and_ratio_clamped(self, monkeypatch):
        from tendermint_tpu_torch.services import dispatch as dispatch_mod

        monkeypatch.delenv("TENDERMINT_TPU_COALESCE_WINDOW_MS", raising=False)
        fam = REGISTRY.get("tendermint_verify_seconds")
        # the window reads the first backend, in this order, that has
        # observations (earlier tests in the process may have made some)
        order = ("mesh", "tables", "device", "host")
        if not any(fam.labels(backend=b).value["count"] for b in order):
            V._observe_verify("tables", 512, 0.01)
        snap = next(s for s in (fam.labels(backend=b).value for b in order) if s["count"])
        mean = snap["sum"] / snap["count"]
        for ratio in (None, 0.5, 50.0):
            monkeypatch.setattr(dispatch_mod, "measured_launch_apply_ratio", lambda queue=None, r=ratio: r)
            want = min(max(0.1 * mean * min(ratio or 1.0, 4.0), 2e-4), 0.01)
            assert P_bat._adaptive_window_s() == pytest.approx(want)

    def test_launch_apply_ratio_from_overlap_histogram(self):
        from tendermint_tpu_torch.services.dispatch import measured_launch_apply_ratio
        from tendermint_tpu_torch.telemetry import metrics as _metrics

        _metrics.DISPATCH_OVERLAP.labels(queue="ratio-test").observe(0.5)
        assert measured_launch_apply_ratio("ratio-test") == pytest.approx(1.0)
        assert measured_launch_apply_ratio("no-such-queue") is None


def test_force_fused_reaches_the_chains_through_every_layer(monkeypatch, closing):
    """`force_fused` from the coalescing facade through the resilient
    layer to `verify_tables_kernel(impl=)`, sync and async: True takes
    the fused chain, False the entries chain, None decides by depth; the
    plain torch chains answer on the CPU."""
    picked = []
    real = V.verify_tables_kernel

    def spy(*args, impl="auto"):
        picked.append(impl)
        return real(*args, impl=impl)

    monkeypatch.setattr(V, "verify_tables_kernel", spy)
    stack = closing(CoalescingVerifier(ResilientVerifier(V.TableBatchVerifier(device="cpu", min_device_batch=0))))
    keys = [gen_priv_key(bytes([i + 1]) * 32) for i in range(4)]
    pubs = [k.pub_key.data for k in keys]

    def commit(tag, forge=None):
        msgs = [b"%s-%d" % (tag, i) for i in range(4)]
        sigs = [k.sign(m) for k, m in zip(keys, msgs)]
        if forge is not None:
            sigs[forge] = b"\x0e" * 64
        return [(msgs, sigs)]

    assert stack.verify_commits(pubs, commit(b"a", forge=1), force_fused=True).tolist() == [[True, False, True, True]]
    assert stack.verify_commits(pubs, commit(b"b"), force_fused=False).all()
    assert stack.verify_commits(pubs, commit(b"c")).all()
    got = stack.verify_commits_async(pubs, commit(b"d", forge=3), force_fused=True, consumer="fastsync")
    assert got.result(timeout=60).tolist() == [[True, True, True, False]]
    assert picked == ["fused", "entries", "auto", "fused"]
    assert stack.inner.snapshot()["fallback_calls"] == 0


# -- the JAX stack and the port's, side by side --------------------------------


def test_jax_and_port_stacks_agree_call_for_call(closing):
    rng = np.random.default_rng(7)
    pool = _triples(6, salt=b"diff")
    forged = [(pk, m, b"\x0f" * 64) for pk, m, _s in pool[:2]]
    plan = []
    for _ in range(14):
        pick = [int(i) for i in rng.choice(len(pool), int(rng.integers(1, 5)), replace=False)]
        plan.append((
            str(rng.choice(["sync", "async", "grid"])),
            [pool[i] for i in pick] + ([forged[int(rng.integers(0, 2))]] if rng.random() < 0.4 else []),
            bool(rng.random() < 0.3),  # the primary broken
            int(rng.integers(0, 2)) if rng.random() < 0.3 else 0,  # injected faults
        ))
    sides = {}
    for name, ver, res, circ, bat, fmod, reg in (
        ("jax", J_ver, J_res, J_circuit, J_bat, J_fail, J_REGISTRY),
        ("port", V, P_res, P_circuit, P_bat, fail, REGISTRY),
    ):
        class Flaky(ver.BatchVerifier):
            broken = False

            def verify_batch(self, triples, _host=ver.HostBatchVerifier()):
                if self.broken:
                    raise fail.InjectedDeviceFault("device exploded")
                return _host.verify_batch(triples)

        primary = Flaky()
        br = circ.CircuitBreaker(failure_threshold=2, reset_timeout_s=3600)
        stack = closing(bat.CoalescingVerifier(res.ResilientVerifier(primary, breaker=br, max_retries=0), window_s=0.001))
        hits0 = reg.counter_value("tendermint_verify_cache_hits_total")
        out = []
        for kind, triples, broken, faults in plan:
            primary.broken = broken
            if faults:
                fmod.set_device_fault("verify", faults)
            if kind == "sync":
                got = stack.verify_batch(triples)
            elif kind == "async":
                got = stack.verify_batch_async(triples, consumer="consensus").result(timeout=20)
            else:
                got = stack.verify_commits([t[0] for t in triples], [([t[1] for t in triples], [t[2] for t in triples])])
            fmod.clear_device_faults()
            out.append((np.asarray(got).tolist(), br.state))
        snap = stack.snapshot()
        cache = snap.pop("verify_cache")
        sides[name] = (out, snap, cache["entries"], reg.counter_value("tendermint_verify_cache_hits_total") - hits0)
    assert sides["jax"] == sides["port"]
    out, snap, entries, hits = sides["port"]
    assert snap["fallback_calls"] > 0 and hits > 0 and entries > 0
