"""The port's mempool (`tendermint_tpu_torch/mempool/`: `Mempool`, `TxCache`,
the lanes, the mempool WAL, `IngressBatcher` and the signed-tx
envelope) against the JAX package's.

The JAX package's own scenarios run again on the port:
`tests/test_mempool_ingress.py` (the envelope, lanes, concurrent WAL
writers, `get_after`, the gossip cursor, the opt-outs, the ingress
batcher's windows, its degradation and barriers) and
`test_mempool_store.py` (the cache, check/reap/update, recheck, the
block store, WAL replay), on the port's `HostBatchVerifier` and
`CoalescingVerifier`.

Across the packages, seeded: the same tx stream (plain txs, signed
envelopes, duplicates, a forged envelope, the reserved prefix) into a
JAX and a port `Mempool` gives equal `Result`s, reap order, cache and
WAL bytes, before and after `update`; `make_signed_tx` gives the same
bytes; the mempool reactor's messages encode alike. Tolerance: exact.
"""

from __future__ import annotations

import threading
import time

import pytest

from tendermint_tpu_torch.abci.apps import CounterApp, KVStoreApp
from tendermint_tpu_torch.abci.client import local_client_creator
from tendermint_tpu_torch.abci.types import CodeType
from tendermint_tpu_torch.blockchain import BlockStore
from tendermint_tpu_torch.crypto.keys import gen_priv_key
from tendermint_tpu_torch.db.kv import MemDB
from tendermint_tpu_torch.mempool import Mempool, TxCache, make_signed_tx, parse_signed_tx
from tendermint_tpu_torch.services.batcher import CoalescingVerifier
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.telemetry import REGISTRY
from tendermint_tpu_torch.testing import ChainSim, join_all, lockrank_report, time_limit_fixture
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.tx import Txs


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


# -- tests/test_mempool_ingress.py --------------------------------------------------


def _mempool(app=None, **kw):
    conns = local_client_creator(app or KVStoreApp())()
    return Mempool(conns.mempool, **kw), conns


PRIV = gen_priv_key(b"\x42" * 32)


def _signed(payload: bytes, priv=PRIV) -> bytes:
    return make_signed_tx(priv, payload)


class TestSignedTxEnvelope:
    def test_roundtrip(self):
        tx = _signed(b"k=v")
        parsed = parse_signed_tx(tx)
        assert parsed is not None
        pk, sig, payload = parsed
        assert pk == PRIV.pub_key.data and payload == b"k=v"
        assert PRIV.pub_key.verify(payload, sig)

    def test_plain_and_short_txs_are_not_envelopes(self):
        assert parse_signed_tx(b"k=v") is None
        assert parse_signed_tx(b"\xed\x01short") is None
        # magic alone is not enough: header must be complete
        assert parse_signed_tx(b"\xed\x01" + b"\x00" * 95) is None

    def test_tampered_payload_fails_verify(self):
        tx = bytearray(_signed(b"k=v"))
        tx[-1] ^= 0xFF
        pk, sig, payload = parse_signed_tx(bytes(tx))
        assert not PRIV.pub_key.verify(payload, sig)


class TestLanes:
    def test_reap_merges_lanes_in_counter_order(self):
        mp, _ = _mempool(lanes=4, ingress_batch=False)
        txs = [b"k%d=v%d" % (i, i) for i in range(24)]
        for tx in txs:
            mp.check_tx(tx)
        # txs spread over multiple lanes...
        occupied = [lane for lane in mp._lanes if lane.txs]
        assert len(occupied) > 1
        # ...but reap returns global admission order, counter-monotonic
        reaped = [bytes(t) for t in mp.reap(-1)]
        assert reaped == txs
        counters = [c for c, _ in mp.get_after(0)]
        assert counters == sorted(counters) == list(range(1, 25))
        assert [bytes(t) for t in mp.reap(5)] == txs[:5]

    def test_update_removes_committed_and_rechecks_across_lanes(self):
        app = CounterApp(serial=True)
        mp, conns = _mempool(app, lanes=4, ingress_batch=False)
        txs = [i.to_bytes(1, "big") if i else b"\x00" for i in range(6)]
        for tx in txs:
            mp.check_tx(tx)
        assert mp.size() == 6
        # app advances past nonce 3 -> nonces 2,3 go stale on recheck
        for i in range(4):
            conns.consensus.deliver_tx_async(txs[i])
        mp.lock()
        try:
            mp.update(1, Txs(txs[:2]))  # 0,1 committed
        finally:
            mp.unlock()
        survivors = [bytes(t) for t in mp.reap(-1)]
        assert survivors == txs[4:]  # 2,3 rechecked stale, 4,5 survive

    def test_dup_cache_hits_land_on_the_right_lane(self):
        mp, _ = _mempool(lanes=8, ingress_batch=False)
        txs = [b"dup%d=%d" % (i, i) for i in range(16)]
        for tx in txs:
            assert mp.check_tx(tx).is_ok
        for tx in txs:
            res = mp.check_tx(tx)
            assert res.code == CodeType.TX_IN_CACHE
        assert mp.size() == 16
        # eviction from the owning lane's segment makes the tx re-offerable
        mp.lock()
        try:
            mp.update(1, Txs(txs))
        finally:
            mp.unlock()
        assert mp.size() == 0
        # committed txs stay in their lane's dup cache (a gossip
        # re-arrival of a committed tx is still a duplicate)
        assert mp.check_tx(txs[0]).code == CodeType.TX_IN_CACHE

    def test_wal_replay_restores_every_lane(self, tmp_path):
        txs = [b"wal%d=%d" % (i, i) for i in range(12)]
        mp, _ = _mempool(lanes=4, ingress_batch=False, wal_dir=str(tmp_path))
        for tx in txs:
            mp.check_tx(tx)
        mp.close()
        mp2, _ = _mempool(lanes=4, ingress_batch=False, wal_dir=str(tmp_path))
        assert mp2.replay_wal() == 12
        assert [bytes(t) for t in mp2.reap(-1)] == txs
        # every lane that should hold a tx holds exactly its txs
        for tx in txs:
            lane = mp2._lane_for(tx)
            assert any(m.tx == tx for m in lane.txs)
        mp2.close()

    def test_lock_freezes_all_lanes(self):
        mp, _ = _mempool(lanes=4, ingress_batch=False)
        mp.check_tx(b"a=1")
        mp.lock()
        try:
            blocked = threading.Event()
            done = threading.Event()

            def admit():
                blocked.set()
                mp.check_tx(b"b=2")
                done.set()

            t = threading.Thread(target=admit, daemon=True)
            t.start()
            blocked.wait(2)
            time.sleep(0.1)
            # admission can't complete while consensus holds the pool
            assert not done.is_set()
        finally:
            mp.unlock()
        assert done.wait(5)
        assert mp.size() == 2


class TestWALConcurrentWriters:
    def test_concurrent_appends_keep_framing_parseable(self, tmp_path):
        """Pre-fix, check_tx appended outside any lock: interleaved
        writes from RPC + gossip threads corrupted the length framing
        load_wal replays. The dedicated WAL lock serializes appends."""
        mp, _ = _mempool(lanes=4, ingress_batch=False, wal_dir=str(tmp_path))
        n_threads, per_thread = 8, 40
        # variable-length payloads make torn frames visible
        txs = [
            b"t%d-%d=%s" % (k, i, b"x" * (1 + (k * per_thread + i) % 97))
            for k in range(n_threads)
            for i in range(per_thread)
        ]

        def worker(k):
            for tx in txs[k * per_thread : (k + 1) * per_thread]:
                mp.check_tx(tx)

        threads = [
            threading.Thread(target=worker, args=(k,)) for k in range(n_threads)
        ]
        for t in threads:
            t.start()
        join_all(threads, 60)
        records = mp.load_wal()
        assert len(records) == n_threads * per_thread
        assert set(records) == set(txs)
        mp.close()

    def test_concurrent_appends_preserve_admission_order(self, tmp_path):
        """WAL record order must equal counter (admission) order even
        with concurrent writers: the counter is assigned under the same
        _wal_lock hold as the WAL append, so crash replay re-admits txs
        in exactly the order the pool held them (nonce-style serial
        apps depend on this)."""
        mp, _ = _mempool(lanes=4, ingress_batch=False, wal_dir=str(tmp_path))
        n_threads, per_thread = 8, 25

        def worker(k):
            for i in range(per_thread):
                mp.check_tx(b"ord-%d-%d=1" % (k, i))

        threads = [
            threading.Thread(target=worker, args=(k,)) for k in range(n_threads)
        ]
        for t in threads:
            t.start()
        join_all(threads, 60)
        counter_of = {tx: c for c, tx in mp.get_after(0)}
        wal_counters = [counter_of[r] for r in mp.load_wal()]
        assert len(wal_counters) == n_threads * per_thread
        assert wal_counters == sorted(wal_counters)
        mp.close()


class TestGetAfterWait:
    def test_spurious_wakeup_does_not_return_empty(self):
        mp, _ = _mempool(lanes=4, ingress_batch=False)
        mp.check_tx(b"a=1")
        cursor = max(c for c, _ in mp.get_after(0))
        got = []

        def waiter():
            got.extend(mp.get_after(cursor, wait=True, timeout=10))

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        time.sleep(0.05)
        # spurious notify: no newer tx exists — the waiter must re-wait
        for _ in range(3):
            with mp._avail:
                mp._avail.notify_all()
            time.sleep(0.02)
        assert t.is_alive(), "waiter returned on a spurious wakeup"
        mp.check_tx(b"b=2")
        t.join(5)
        assert [tx for _, tx in got] == [b"b=2"]

    def test_timeout_expires_empty(self):
        mp, _ = _mempool(lanes=4, ingress_batch=False)
        mp.check_tx(b"a=1")
        cursor = max(c for c, _ in mp.get_after(0))
        t0 = time.monotonic()
        out = mp.get_after(cursor, wait=True, timeout=0.3)
        assert out == []
        assert time.monotonic() - t0 >= 0.25

    def test_spurious_wakeup_respects_deadline(self):
        """A storm of notifies without new txs must neither return
        early nor spin past the deadline."""
        mp, _ = _mempool(lanes=4, ingress_batch=False)
        mp.check_tx(b"a=1")
        cursor = max(c for c, _ in mp.get_after(0))
        stop = threading.Event()

        def noise():
            while not stop.is_set():
                with mp._avail:
                    mp._avail.notify_all()
                time.sleep(0.01)

        t = threading.Thread(target=noise, daemon=True)
        t.start()
        try:
            t0 = time.monotonic()
            out = mp.get_after(cursor, wait=True, timeout=0.3)
            dt = time.monotonic() - t0
        finally:
            stop.set()
            t.join(2)
        assert out == []
        assert 0.25 <= dt < 5.0


class TestGossipCursorConsistency:
    def test_mid_scan_admissions_withheld_never_skipped(self):
        """The gossip reactor advances its cursor to the max returned
        counter, so `get_after` must never return counter N while an
        unreturned counter < N exists. Pre-fix, the lane-by-lane scan
        could do exactly that: a tx admitted into an already-scanned
        lane was masked by a higher-counter tx in a later lane, and the
        cursor skipped it forever (the tx was never gossiped). The
        counter snapshot withholds BOTH mid-scan admissions until the
        next scan."""
        mp, _ = _mempool(lanes=4, ingress_batch=False)
        mp.check_tx(b"seed=1")
        cursor = max(c for c, _ in mp.get_after(0))

        def tx_for_lane(idx, tag):
            for i in range(100_000):
                tx = b"%s-%d=1" % (tag, i)
                if mp._lane_for(tx) is mp._lanes[idx]:
                    return tx
            raise AssertionError("no payload found for lane")

        early_lane_tx = tx_for_lane(0, b"early")  # lane scanned pre-pause
        late_lane_tx = tx_for_lane(3, b"late")  # lane scanned post-pause

        mid_scan = threading.Event()
        resume = threading.Event()
        state = {"armed": True}
        real_lanes = mp._lanes

        class PausingLanes(list):
            """Pauses the FIRST iteration (the scan under test) after
            yielding lane 0; every other iteration is pass-through."""

            def __iter__(self):
                it = list.__iter__(self)
                if not state["armed"]:
                    return it
                state["armed"] = False

                def gen():
                    yield next(it)
                    mid_scan.set()
                    resume.wait(5)
                    yield from it

                return gen()

        mp._lanes = PausingLanes(real_lanes)
        try:
            got = []
            t = threading.Thread(
                target=lambda: got.extend(mp.get_after(cursor)), daemon=True
            )
            t.start()
            assert mid_scan.wait(5)
            # admitted while the scan sits between lanes: "early" lands
            # on the lane already walked, "late" on one still to come
            assert mp.check_tx(early_lane_tx).is_ok
            assert mp.check_tx(late_lane_tx).is_ok
            resume.set()
            t.join(5)
            assert not t.is_alive()
        finally:
            mp._lanes = real_lanes
        # neither counter is returned (both post-snapshot) — returning
        # only the late one would advance the cursor past the early one
        assert got == []
        # the next scan sees both, in counter order, with no gap
        after = mp.get_after(cursor)
        assert [tx for _, tx in after] == [early_lane_tx, late_lane_tx]
        assert [c for c, _ in after] == [cursor + 1, cursor + 2]
        mp.close()


class TestSignedTxsOptOut:
    # >= 98 bytes and starts with the envelope magic, but is NOT a real
    # envelope — an app payload colliding with the reserved prefix
    COLLIDER = b"\xed\x01" + b"x" * 96

    def test_reserved_prefix_rejected_by_default(self):
        mp, _ = _mempool(lanes=2, ingress_batch=False)
        assert mp.check_tx(self.COLLIDER).code == CodeType.UNAUTHORIZED
        mp.close()

    def test_constructor_opt_out_restores_pass_through(self):
        mp, _ = _mempool(lanes=2, ingress_batch=False, signed_txs=False)
        assert mp.check_tx(self.COLLIDER).is_ok
        assert mp.size() == 1
        mp.close()

    def test_env_opt_out_covers_batched_path(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_SIGNED_TXS", "0")
        v = _coalescing()
        mp, _ = _mempool(lanes=2, ingress_batch=True, verifier=v)
        assert mp.check_tx(self.COLLIDER).is_ok
        mp.close()
        v.close()


def _coalescing(cache_size=4096, window_s=0.001):
    return CoalescingVerifier(
        HostBatchVerifier(), cache_size=cache_size, window_s=window_s
    )


class TestIngressBatcher:
    def test_batched_results_match_legacy(self):
        seq = [
            _signed(b"s1=1"),
            b"plain=1",
            _signed(b"s2=2"),
            _signed(b"s1=1"),  # duplicate
        ]
        forged = bytearray(_signed(b"s3=3"))
        forged[40] ^= 0xFF
        seq.append(bytes(forged))

        def run(batch_on):
            v = _coalescing()
            mp, _ = _mempool(lanes=4, ingress_batch=batch_on, verifier=v)
            codes = [mp.check_tx(tx).code for tx in seq]
            size = mp.size()
            mp.close()
            v.close()
            return codes, size

        legacy, batched = run(False), run(True)
        assert legacy == batched
        assert legacy[0] == (
            [CodeType.OK, CodeType.OK, CodeType.OK, CodeType.TX_IN_CACHE,
             CodeType.UNAUTHORIZED]
        )

    def test_forged_sig_rejected_evicted_and_retryable(self):
        v = _coalescing()
        mp, _ = _mempool(lanes=4, ingress_batch=True, verifier=v)
        good = _signed(b"k=v")
        forged = bytearray(good)
        forged[34] ^= 0x01  # flip one sig bit
        res = mp.check_tx(bytes(forged))
        assert res.code == CodeType.UNAUTHORIZED
        assert mp.size() == 0
        # the forged bytes were evicted from the dup cache: the CORRECT
        # envelope is admissible (a bad sig can't poison the tx)
        assert mp.check_tx(good).is_ok
        assert mp.size() == 1
        mp.close()
        v.close()

    def test_concurrent_callers_share_verify_windows(self):
        v = _coalescing(cache_size=0)
        mp, _ = _mempool(
            lanes=4, ingress_batch=True, verifier=v, ingress_window_s=0.02
        )
        fam = REGISTRY.get("tendermint_mempool_ingress_window_txs")
        n0, s0 = fam.value["count"], fam.value["sum"]
        txs = [_signed(b"w%d=%d" % (i, i)) for i in range(48)]
        threads = [
            threading.Thread(target=mp.check_tx, args=(tx,)) for tx in txs
        ]
        for t in threads:
            t.start()
        join_all(threads, 60)
        assert mp.size() == 48
        snap = fam.value
        windows = snap["count"] - n0
        assert snap["sum"] - s0 == 48
        assert windows < 48, "no admission coalescing happened"
        mp.close()
        v.close()

    def test_mempool_is_a_coalescer_consumer(self):
        v = _coalescing(cache_size=0)
        mp, _ = _mempool(lanes=4, ingress_batch=True, verifier=v)
        fam = REGISTRY.get("tendermint_batcher_wait_seconds")
        before = fam.labels(consumer="mempool").value["count"]
        for i in range(4):
            assert mp.check_tx(_signed(b"c%d=%d" % (i, i))).is_ok
        assert fam.labels(consumer="mempool").value["count"] > before
        mp.close()
        v.close()

    def test_gossip_rearrival_is_near_free_via_sig_cache(self):
        """Two nodes' mempools share one verifier stack (the in-process
        nemesis shape): the second admission of the same signed tx hits
        the VerifiedSigCache instead of re-verifying."""
        v = _coalescing()
        mp_a, _ = _mempool(lanes=4, ingress_batch=True, verifier=v)
        mp_b, _ = _mempool(lanes=4, ingress_batch=True, verifier=v)
        tx = _signed(b"gossip=1")
        assert mp_a.check_tx(tx).is_ok
        h0 = REGISTRY.counter_value("tendermint_verify_cache_hits_total")
        assert mp_b.check_tx(tx).is_ok
        assert (
            REGISTRY.counter_value("tendermint_verify_cache_hits_total") - h0
            >= 1
        )
        mp_a.close()
        mp_b.close()
        v.close()

    def test_callbacks_fire_in_submission_order(self):
        v = _coalescing(cache_size=0)
        mp, _ = _mempool(lanes=4, ingress_batch=True, verifier=v)
        order = []
        done = threading.Event()
        n = 20

        def cb_for(i):
            def cb(res):
                order.append(i)
                if len(order) == n:
                    done.set()

            return cb

        for i in range(n):
            mp.check_tx_async(_signed(b"f%d=%d" % (i, i)), cb_for(i))
        assert done.wait(10)
        assert order == list(range(n))
        mp.close()
        v.close()

    # A deliberate difference against the JAX package, which verifies a
    # window (or a synchronous tx) on the host when the verifier raises:
    # the port fails the signed txs with INTERNAL_ERROR and keeps the
    # plain txs of the window.

    def test_window_fails_its_signed_txs_when_verifier_faults(self):
        class ExplodingVerifier(HostBatchVerifier):
            def verify_batch_async(self, triples, queue=None, consumer="default"):
                raise RuntimeError("device gone")

        mp, _ = _mempool(
            lanes=4, ingress_batch=True, verifier=ExplodingVerifier()
        )
        good = _signed(b"h=1")
        res = mp.check_tx(good)
        assert res.code == CodeType.INTERNAL_ERROR
        assert res.log == "signature verify failed: RuntimeError: device gone"
        assert mp.check_tx(b"plain=1").is_ok
        assert mp.size() == 1
        # evicted from the dup cache: a re-offer verifies again
        assert mp.check_tx(good).code == CodeType.INTERNAL_ERROR
        mp.close()

    def test_window_fails_its_signed_txs_when_handle_result_faults(self):
        class FaultyHandle:
            def result(self, timeout=None):
                raise RuntimeError("launch lost")

        class FaultyVerifier(HostBatchVerifier):
            def verify_batch_async(self, triples, queue=None, consumer="default"):
                return FaultyHandle()

        mp, _ = _mempool(lanes=4, ingress_batch=True, verifier=FaultyVerifier())
        res = mp.check_tx(_signed(b"h3=3"))
        assert res.code == CodeType.INTERNAL_ERROR
        assert res.log == "signature verify failed: RuntimeError: launch lost"
        assert mp.size() == 0
        mp.close()

    def test_synchronous_admission_fails_when_verifier_faults(self):
        class ExplodingVerifier(HostBatchVerifier):
            def verify_batch(self, triples):
                raise RuntimeError("device gone")

        mp, _ = _mempool(lanes=4, ingress_batch=False, verifier=ExplodingVerifier())
        seen = []
        res = mp.check_tx(_signed(b"s=1"), cb=seen.append)
        assert res.code == CodeType.INTERNAL_ERROR
        assert seen == [res]
        assert mp.size() == 0
        mp.close()

    def test_env_opt_out_keeps_synchronous_semantics(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_INGRESS_BATCH", "0")
        mp, _ = _mempool(lanes=4)
        assert mp._ingress is None
        assert mp.check_tx(_signed(b"sync=1")).is_ok
        # check_tx_async falls back to the synchronous path
        res = mp.check_tx_async(b"plain=2")
        assert res.is_ok and mp.size() == 2
        mp.close()

    def test_env_lane_override(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_MEMPOOL_LANES", "2")
        mp, _ = _mempool(lanes=8, ingress_batch=False)
        assert mp.n_lanes == 2
        mp.close()

    def test_admission_latency_histogram_observed(self):
        fam = REGISTRY.get("tendermint_mempool_admission_seconds")
        before = fam.value["count"]
        v = _coalescing()
        mp, _ = _mempool(lanes=4, ingress_batch=True, verifier=v)
        mp.check_tx(_signed(b"lat=1"))
        mp.check_tx(b"plain-lat=1")
        assert fam.value["count"] >= before + 2
        mp.close()
        v.close()

    def test_flush_invalidates_inflight_ingress_admissions(self):
        """unsafe_flush_mempool must also cover txs sitting in ingress
        windows: pre-fix a tx queued for admission when the operator
        flushed re-entered the pool right after the flush."""
        v = _coalescing()
        mp, _ = _mempool(
            lanes=4, ingress_batch=True, verifier=v, ingress_window_s=5.0
        )
        adm = mp.check_tx_async(b"inflight=1")
        mp.flush()  # tx still queued (5 s window, no barrier yet)
        res = mp._ingress.wait(adm)  # barrier-flush and join NOW
        assert res.code == CodeType.INTERNAL_ERROR
        assert mp.size() == 0
        # caches were reset by the flush: the same tx is re-offerable
        assert mp.check_tx(b"inflight=1").is_ok
        assert mp.size() == 1
        mp.close()
        v.close()

    def test_close_drains_windows_enqueued_behind_stop(self):
        """A flusher stuck past close()'s join timeout can enqueue its
        window AFTER the _STOP sentinel; the joiner exits without
        resolving it and _Admission.wait() has no timeout — close()'s
        drain must resolve the batch so no blocked caller hangs."""
        from tendermint_tpu_torch.mempool.ingress import IngressBatcher, _Admission

        mp, _ = _mempool(lanes=2, ingress_batch=False)
        b = IngressBatcher(mp)
        adm = _Admission(b"late=1", None, None, time.time(), None)
        b._join_q.put((None, [adm], []))  # a window the joiner never saw
        b.close()
        assert adm.event.is_set()
        assert adm.result.code == CodeType.INTERNAL_ERROR
        mp.close()

    def test_close_resolves_queued_admissions(self):
        """A closing pool must not wedge blocked callers: queued
        admissions resolve with an internal error."""
        v = _coalescing()
        mp, _ = _mempool(
            lanes=4, ingress_batch=True, verifier=v, ingress_window_s=5.0
        )
        adm = mp.check_tx_async(_signed(b"late=1"))
        mp.close()
        v.close()
        res = adm.wait(5) if hasattr(adm, "wait") else adm
        assert res is not None

    def test_no_empty_block_wakeup_fires_from_window_join(self):
        v = _coalescing()
        mp, _ = _mempool(lanes=4, ingress_batch=True, verifier=v)
        fired = []
        mp.set_on_txs_available(lambda: fired.append(1))
        mp.check_tx(_signed(b"wake=1"))
        mp.check_tx(_signed(b"wake2=2"))
        assert len(fired) == 1  # once per height
        mp.lock()
        try:
            mp.update(1, Txs([_signed(b"wake=1")]))
        finally:
            mp.unlock()
        # recheck left wake2 pending -> fires again for the next height
        assert len(fired) == 2
        mp.close()
        v.close()


# -- tests/test_mempool_store.py ----------------------------------------------------


class TestTxCache:
    def test_dedup_and_eviction(self):
        c = TxCache(size=2)
        assert c.push(b"a") and not c.push(b"a")
        c.push(b"b")
        c.push(b"c")  # evicts a
        assert c.push(b"a")

    def test_remove(self):
        c = TxCache(size=4)
        c.push(b"a")
        c.remove(b"a")
        assert c.push(b"a")




class TestMempool:
    def test_check_reap_update(self):
        mp, _ = _mempool()
        for i in range(5):
            mp.check_tx(b"k%d=v%d" % (i, i))
        assert mp.size() == 5
        dup = mp.check_tx(b"k0=v0")
        assert dup.log == "tx already exists in cache"
        assert not dup.is_ok  # duplicates are a visible rejection (ErrTxInCache)
        assert mp.size() == 5
        reaped = mp.reap(3)
        assert len(reaped) == 3
        assert len(mp.reap(-1)) == 5
        mp.update(1, Txs([b"k0=v0", b"k1=v1"]))
        assert mp.size() == 3

    def test_bad_tx_rejected_and_uncached(self):
        app = CounterApp(serial=True)
        mp, conns = _mempool(app)
        mp.check_tx((5).to_bytes(2, "big"))
        assert mp.size() == 1
        # nonce 0 < tx_count after deliver? deliver 6 txs via consensus conn
        for i in range(6):
            conns.consensus.deliver_tx_async(i.to_bytes(1, "big") if i else b"")
        mp.check_tx((2).to_bytes(1, "big"))  # nonce 2 < 6: rejected
        assert mp.size() == 1
        # rejected tx was evicted from the cache, so it can be retried
        assert mp.check_tx((2).to_bytes(1, "big")).code != 0

    def test_update_recheck_drops_stale(self):
        app = CounterApp(serial=True)
        mp, conns = _mempool(app)
        for i in range(3):
            mp.check_tx(i.to_bytes(1, "big") if i else b"\x00")
        assert mp.size() == 3
        # app advances past nonce 1 -> txs 0,1 now stale
        conns.consensus.deliver_tx_async(b"\x00")
        conns.consensus.deliver_tx_async(b"\x01")
        mp.update(1, Txs())
        assert mp.size() == 1  # only nonce-2 tx survives recheck

    def test_txs_available_fires_once_per_height(self):
        mp, _ = _mempool()
        fired = []
        mp.set_on_txs_available(lambda: fired.append(1))
        mp.check_tx(b"a=1")
        mp.check_tx(b"b=2")
        assert len(fired) == 1
        mp.update(1, Txs([b"a=1"]))  # pool still has b=2 -> fires again
        assert len(fired) == 2

    def test_wal_replay(self, tmp_path):
        mp, _ = _mempool(wal_dir=str(tmp_path))
        mp.check_tx(b"x=1")
        mp.check_tx(b"y=2")
        assert mp.load_wal() == [b"x=1", b"y=2"]
        mp.close()

    def test_get_after_blocks_until_new_tx(self):
        mp, _ = _mempool()
        mp.check_tx(b"a=1")
        got = mp.get_after(0)
        assert got == [(1, b"a=1")]
        results = []

        def waiter():
            results.extend(mp.get_after(1, wait=True, timeout=5))

        t = threading.Thread(target=waiter)
        t.start()
        mp.check_tx(b"b=2")
        t.join(timeout=5)
        assert results == [(2, b"b=2")]

    def test_get_after_counter_survives_commit_compaction(self):
        # positional cursors would stall after update() compacts the
        # list (round-3 review finding): counters must keep advancing
        from tendermint_tpu_torch.types.tx import Txs

        mp, _ = _mempool()
        mp.check_tx(b"a=1")
        mp.check_tx(b"b=2")
        cursor = max(c for c, _ in mp.get_after(0))
        assert cursor == 2
        mp.lock()
        try:
            mp.update(1, Txs([b"a=1", b"b=2"]))  # both committed
        finally:
            mp.unlock()
        mp.check_tx(b"c=3")
        got = mp.get_after(cursor)
        assert got == [(3, b"c=3")]


class TestBlockStore:
    def _chain(self, n=3):
        sim = ChainSim(n_vals=3, verifier=HostBatchVerifier())
        store = BlockStore(MemDB())
        for i in range(n):
            block, ps = sim.make_next_block(txs=[b"t%d=%d" % (i, i)])
            commit = sim._commit_for(block, ps)
            from tendermint_tpu_torch.state import apply_block

            apply_block(sim.state, block, ps.header, sim.conns.consensus, verifier=HostBatchVerifier())
            sim.blocks.append(block)
            sim.commits.append(commit)
            store.save_block(block, ps, commit)
        return sim, store

    def test_save_load_roundtrip(self):
        sim, store = self._chain(3)
        assert store.height == 3
        for h in (1, 2, 3):
            blk = store.load_block(h)
            assert blk is not None and blk.hash() == sim.blocks[h - 1].hash()
            meta = store.load_block_meta(h)
            assert meta.header.height == h
            assert meta.block_id.hash == blk.hash()
        # canonical commit for h is carried by block h+1
        c2 = store.load_block_commit(2)
        assert c2.hash() == sim.blocks[2].last_commit.hash()
        sc3 = store.load_seen_commit(3)
        assert sc3.hash() == sim.commits[2].hash()
        assert store.load_block(4) is None
        assert store.load_block_commit(99) is None

    def test_parts_individually_loadable(self):
        sim, store = self._chain(1)
        meta = store.load_block_meta(1)
        total = meta.block_id.parts_header.total
        buf = b""
        for i in range(total):
            part = store.load_block_part(1, i)
            assert part is not None and part.index == i
            buf += part.bytes_
        from tendermint_tpu_torch.types.block import Block

        assert Block.decode(buf).hash() == sim.blocks[0].hash()
        assert store.load_block_part(1, total) is None

    def test_noncontiguous_save_rejected(self):
        sim, store = self._chain(1)
        block, ps = sim.make_next_block()
        block.header.height = 5
        with pytest.raises(ValidationError, match="contiguous"):
            store.save_block(block, ps, sim.commits[-1])

    def test_reload_watermark(self):
        db = MemDB()
        sim = ChainSim(n_vals=3, verifier=HostBatchVerifier())
        store = BlockStore(db)
        block, ps = sim.make_next_block()
        commit = sim._commit_for(block, ps)
        from tendermint_tpu_torch.state import apply_block

        apply_block(sim.state, block, ps.header, sim.conns.consensus, verifier=HostBatchVerifier())
        store.save_block(block, ps, commit)
        store2 = BlockStore(db)
        assert store2.height == 1
        assert store2.load_block(1).hash() == block.hash()


def test_replay_wal_recovers_and_compacts(tmp_path):
    mp, _ = _mempool(wal_dir=str(tmp_path))
    mp.check_tx(b"a=1")
    mp.check_tx(b"b=2")
    mp.close()
    # restart: fresh mempool over the same WAL dir
    mp2, _ = _mempool(wal_dir=str(tmp_path))
    n = mp2.replay_wal()
    assert n == 2
    assert {bytes(t) for t in mp2.reap(-1)} == {b"a=1", b"b=2"}
    # compaction: a second restart replays the same two, not four
    mp2.close()
    mp3, _ = _mempool(wal_dir=str(tmp_path))
    assert mp3.load_wal() == [b"a=1", b"b=2"]
    mp3.close()


# -- across the packages ---------------------------------------------------------------


def _tx_stream(seed: int):
    """A seeded tx stream: plain `k=v` txs, signed envelopes under a few
    keys (each package's `make_signed_tx`, which must give the same
    bytes), duplicates, a forged envelope and a payload on the reserved
    prefix that is no envelope."""
    import numpy as np

    from tendermint_tpu.crypto.keys import gen_priv_key as j_gen_priv_key
    from tendermint_tpu.mempool import make_signed_tx as j_make_signed_tx

    rng = np.random.default_rng(seed)
    keys = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(3)]
    txs = []
    for i in range(40):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            txs.append(b"k%d=v%d" % (int(rng.integers(0, 12)), i))
        elif kind == 1:
            seed_ = keys[int(rng.integers(0, 3))]
            payload = b"s%d=%s" % (i, bytes(rng.integers(97, 123, 8, dtype=np.uint8)))
            tx = make_signed_tx(gen_priv_key(seed_), payload)
            assert tx == j_make_signed_tx(j_gen_priv_key(seed_), payload)
            assert parse_signed_tx(tx)[2] == payload
            txs.append(tx)
        elif kind == 2 and txs:
            txs.append(txs[int(rng.integers(0, len(txs)))])  # a duplicate
        else:
            forged = bytearray(make_signed_tx(gen_priv_key(keys[0]), b"f%d=1" % i))
            forged[34 + int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
            txs.append(bytes(forged))
    txs.append(b"\xed\x01" + b"x" * 96)  # the reserved prefix, no envelope
    return txs


def _mempool_outcomes(pkg: str, txs, wal_dir, lanes: int, ingress: bool):
    import importlib

    apps = importlib.import_module(pkg + ".abci.apps")
    client = importlib.import_module(pkg + ".abci.client")
    mempool = importlib.import_module(pkg + ".mempool")
    verifier = importlib.import_module(pkg + ".services.verifier")
    conns = client.local_client_creator(apps.KVStoreApp())()
    mp = mempool.Mempool(conns.mempool, wal_dir=str(wal_dir), lanes=lanes, ingress_batch=ingress,
                         verifier=verifier.HostBatchVerifier() if ingress else None)
    out = {}
    try:
        out["results"] = [(r.code, r.data, r.log) for r in (mp.check_tx(tx) for tx in txs)]
        out["reap"] = [bytes(t) for t in mp.reap(-1)]
        out["reap5"] = [bytes(t) for t in mp.reap(5)]
        out["caches"] = [list(lane.cache._map) for lane in mp._lanes]
        out["wal"] = open(wal_dir / "wal", "rb").read()
        mp.lock()
        try:
            mp.update(1, out["reap"][::2])
        finally:
            mp.unlock()
        out["after_update"] = [bytes(t) for t in mp.reap(-1)]
        out["again"] = [mp.check_tx(tx).code for tx in out["reap"][:4]]
        out["size"] = mp.size()
    finally:
        mp.close()
    return out


@pytest.mark.parametrize("lanes,ingress", [(1, False), (4, True)])
def test_same_tx_stream_gives_equal_results_in_both_packages(tmp_path, lanes, ingress):
    """The same seeded tx stream into a JAX and a port `Mempool`: equal
    `Result`s (code, data, log), reap order, dup caches, WAL bytes, and
    equal again after `update` with every other reaped tx."""
    txs = _tx_stream(23)
    j = _mempool_outcomes("tendermint_tpu", txs, tmp_path / "j", lanes, ingress)
    p = _mempool_outcomes("tendermint_tpu_torch", txs, tmp_path / "p", lanes, ingress)
    assert p == j
    codes = {code for code, _, _ in p["results"]}
    assert {CodeType.OK, CodeType.UNAUTHORIZED, CodeType.TX_IN_CACHE} <= codes
    assert p["wal"] and p["after_update"] == p["reap"][1::2]


def test_mempool_reactor_messages_encode_alike():
    """A tx message of the port's mempool reactor is the JAX reactor's
    bytes, and each decodes the other's."""
    from tendermint_tpu.mempool import reactor as J_reactor
    from tendermint_tpu_torch.mempool import reactor

    assert reactor.MEMPOOL_CHANNEL == J_reactor.MEMPOOL_CHANNEL
    for tx in _tx_stream(5)[:12] + [b"", b"\x00" * 300]:
        wire = reactor.encode_tx_message(tx)
        assert wire == J_reactor.encode_tx_message(tx)
        assert reactor.decode_tx_message(wire) == J_reactor.decode_tx_message(wire) == tx
    with pytest.raises(Exception) as p_err:
        reactor.decode_tx_message(b"\x02\x00")
    with pytest.raises(Exception) as j_err:
        J_reactor.decode_tx_message(b"\x02\x00")
    assert (type(p_err.value).__name__, str(p_err.value)) == (type(j_err.value).__name__, str(j_err.value))
