"""The port's launch ledger (`tendermint_tpu_torch/telemetry/launchlog.py`)
and its seams in the port's stack, on the CPU: the JAX package's
`tests/test_launchlog.py` scenarios (ledger, ambient assembly, occupancy
on the mesh's pad geometry, cache-filtered lanes, step-cache and
placement-cache telemetry) re-run on the port with `device="cpu"`; the
JAX wrapper stack and the port's over the same fake primary and one
seeded sequence (a commit, a window, a flat batch, two hashes, an
injected fault), their records equal field for field except times; and
`tools/device_report.py` reading the port's ledger as it reads the JAX
package's. Tolerance: exact, except for times."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.keys import gen_priv_key
from tendermint_tpu.telemetry import launchlog as J_launchlog
from tendermint_tpu.utils import fail as J_fail
from tendermint_tpu_torch.parallel import mesh as mesh_mod
from tendermint_tpu_torch.parallel.mesh import MeshManager
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.services.batcher import CoalescingVerifier, VerifiedSigCache
from tendermint_tpu_torch.services.dispatch import DispatchQueue
from tendermint_tpu_torch.telemetry import REGISTRY, launchlog
from tendermint_tpu_torch.telemetry import tracectx as _tc
from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG, LaunchLedger
from tendermint_tpu_torch.testing import lockrank_report
from tendermint_tpu_torch.utils import fail

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TIME_FIELDS = {"t", "queue_wait_s", "host_prep_s", "in_flight_s", "finalize_s", "total_s",
               "device_s", "compile_s", "device_put_s"}


@pytest.fixture(autouse=True)
def _ledger_reset():
    """Every test leaves both packages' process-wide ledgers empty and
    their thread-ambient assembly state clean, and runs with no node id
    on either ledger (a node booted by an earlier test of the process
    tags every later record with its id)."""
    node_ids = [mod.LAUNCHLOG.node_id for mod in (launchlog, J_launchlog)]
    for mod in (launchlog, J_launchlog):
        mod.LAUNCHLOG.clear()
        mod.LAUNCHLOG.node_id = ""
        mod._tls.rec = None
        mod._tls.tags = None
    fail.clear_device_faults()
    J_fail.clear_device_faults()
    yield
    for mod, node_id in zip((launchlog, J_launchlog), node_ids):
        mod.LAUNCHLOG.clear()
        mod.LAUNCHLOG.node_id = node_id
        mod._tls.rec = None
        mod._tls.tags = None
    fail.clear_device_faults()
    J_fail.clear_device_faults()


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


def _counter(name, **labels) -> float:
    return REGISTRY.counter_value(name, **labels)


def _make_sigs(n: int, salt: bytes = b"ll"):
    privs = [gen_priv_key(bytes([40 + i % 8]) * 32) for i in range(min(8, n))]
    msgs = [b'{"s":"%s","i":%d}' % (salt, i) for i in range(n)]
    sigs = [privs[i % len(privs)].sign(m) for i, m in enumerate(msgs)]
    pubs = [privs[i % len(privs)].pub_key.data for i in range(n)]
    return list(zip(pubs, msgs, sigs))


class TestLedger:
    def test_ring_bounded_and_ordered(self):
        led = LaunchLedger(capacity=4)
        for i in range(10):
            led.record({"kind": "verify", "rows": i})
        assert len(led) == 4
        assert [r["rows"] for r in led.recent()] == [6, 7, 8, 9]
        assert led.last()["rows"] == 9
        assert [r["rows"] for r in led.recent(2)] == [8, 9]

    def test_kind_filter(self):
        led = LaunchLedger(capacity=8)
        led.record({"kind": "verify", "rows": 1})
        led.record({"kind": "leaf_hashes", "rows": 2})
        assert [r["rows"] for r in led.recent(kind="leaf_hashes")] == [2]

    def test_jsonl_persist_and_reload(self, tmp_path):
        path = str(tmp_path / "launches.jsonl")
        led = LaunchLedger(path=path, capacity=8, node_id="n1")
        for i in range(3):
            led.record({"kind": "verify", "rows": i, "t": float(i)})
        led.close()
        reloaded = LaunchLedger(path=path, capacity=8)
        assert [r["rows"] for r in reloaded.recent()] == [0, 1, 2]
        assert reloaded.recent()[0]["node"] == "n1"
        reloaded.close()

    def test_compaction_bounds_the_file(self, tmp_path):
        path = str(tmp_path / "launches.jsonl")
        led = LaunchLedger(path=path, capacity=4)
        for i in range(20):
            led.record({"kind": "verify", "rows": i})
        led.close()
        with open(path) as f:
            lines = [ln for ln in f.readlines() if ln.strip()]
        assert len(lines) <= 8  # trimmed to capacity whenever it doubles past it
        assert [json.loads(ln)["rows"] for ln in lines][-1] == 19

    def test_dump_all(self, tmp_path):
        LAUNCHLOG.record({"kind": "verify", "rows": 7})
        path = launchlog.dump_all(str(tmp_path), reason="test")
        assert path is not None and os.path.exists(path)
        with open(path) as f:
            payload = json.load(f)
        assert payload["reason"] == "test"
        assert payload["records"][-1]["rows"] == 7

    def test_env_disable(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_LAUNCHLOG", "0")
        assert launchlog.begin("verify") is None
        launchlog.annotate(rows_padded=5)
        launchlog.observe("verify", "mesh", 8, 0.01)
        assert len(LAUNCHLOG) == 0

    def test_seconds_since_success_tracks_errors(self):
        assert LAUNCHLOG.seconds_since_success() is None
        rec = launchlog.begin("verify")
        launchlog.commit(rec, error=RuntimeError("boom"))
        assert LAUNCHLOG.seconds_since_success() is None  # failed launch
        rec = launchlog.begin("verify")
        launchlog.commit(rec)
        age = LAUNCHLOG.seconds_since_success()
        assert age is not None and age < 5.0


class TestAmbientAssembly:
    def test_dispatch_handle_yields_one_record_with_stages(self):
        q = DispatchQueue(depth=2, name="launchlog-test")
        try:
            h = q.submit(lambda: launchlog.observe("verify", "mesh", 32, 0.001) or 41, lambda v: v + 1, kind="verify")
            assert h.result(timeout=10) == 42
        finally:
            q.close()
        (rec,) = LAUNCHLOG.recent()
        assert rec["kind"] == "verify" and rec["backend"] == "mesh"
        assert rec["rows"] == 32 and rec["queue"] == "launchlog-test"
        for stage in ("queue_wait_s", "host_prep_s", "in_flight_s", "finalize_s", "total_s"):
            assert stage in rec, stage
        assert "error" not in rec
        assert not any(k.startswith("_") for k in rec)

    def test_launch_error_recorded(self):
        q = DispatchQueue(depth=1, name="launchlog-err")
        try:
            h = q.submit(lambda: 1 / 0, kind="hash")
            with pytest.raises(ZeroDivisionError):
                h.result(timeout=10)
        finally:
            q.close()
        (rec,) = LAUNCHLOG.recent()
        assert rec["error"] == "ZeroDivisionError" and rec["kind"] == "hash"

    def test_host_queue_records_nothing(self):
        q = DispatchQueue(depth=1, name="host-work", launch_ledger=False)
        try:
            assert q.submit(lambda: launchlog.observe("verify", "host", 3, 0.0) or 5).result(timeout=10) == 5
        finally:
            q.close()
        assert len(LAUNCHLOG) == 0

    def test_host_micro_call_outside_launch_records_nothing(self):
        launchlog.observe("verify", "host", 1, 0.0001)
        assert len(LAUNCHLOG) == 0

    def test_sync_device_call_records_standalone(self):
        launchlog.observe("tables", "tables", 256, 0.05)
        (rec,) = LAUNCHLOG.recent()
        assert rec["kind"] == "tables" and rec["rows"] == 256
        # a record the observe opens takes the backend's seconds as its
        # total (the JAX package's says the microseconds since the observe)
        assert rec["total_s"] == rec["device_s"] == 0.05

    def test_implicit_record_from_annotation_commits_at_observe(self):
        launchlog.annotate(_additive=True, rows_padded=31)
        launchlog.add_transfer(4096)
        launchlog.observe("verify", "mesh", 33, 0.02)
        (rec,) = LAUNCHLOG.recent()
        assert rec["rows"] == 33 and rec["rows_padded"] == 31
        assert rec["transfer_bytes"] == 4096
        assert launchlog.current() is None

    def test_tags_cross_the_dispatch_thread(self):
        q = DispatchQueue(depth=1, name="launchlog-tags")
        try:
            with launchlog.tag(consumers={"consensus": 8, "mempool": 4}, rows_cached=3):
                h = q.submit(lambda: launchlog.observe("verify", "mesh", 12, 0.001), kind="verify")
            h.result(timeout=10)
        finally:
            q.close()
        rec = LAUNCHLOG.recent()[0]
        assert rec["consumers"] == {"consensus": 8, "mempool": 4}
        assert rec["rows_cached"] == 3
        assert launchlog.current_tags() is None

    def test_trace_exemplar_rides_the_record(self):
        from tendermint_tpu_torch.telemetry import TRACER

        ctx = _tc.TraceContext(os.urandom(8), os.urandom(8), "launch-test")
        q = DispatchQueue(depth=1, name="launchlog-trace")
        try:
            with _tc.use(ctx):
                h = q.submit(lambda: None, kind="verify")
            h.result(timeout=10)
        finally:
            q.close()
        assert LAUNCHLOG.recent()[0]["trace"] == ctx.trace
        spans = [s for s in TRACER.recent(prefix="dispatch.launch") if s["attrs"]["trace"] == ctx.trace]
        assert len(spans) == 1 and spans[0]["attrs"]["queue"] == "launchlog-trace"

    def test_metrics_observed_at_commit(self):
        u0 = _counter("tendermint_launch_rows", kind="verify", state="useful")
        p0 = _counter("tendermint_launch_rows", kind="verify", state="padded")
        rec = launchlog.begin("verify")
        rec["queue_wait_s"] = 0.001
        launchlog.annotate(_additive=True, rows_padded=7)
        launchlog.observe("verify", "mesh", 9, 0.01)
        launchlog.commit(rec)
        assert _counter("tendermint_launch_rows", kind="verify", state="useful") - u0 == 9
        assert _counter("tendermint_launch_rows", kind="verify", state="padded") - p0 == 7


def _host_mesh_verifier(n_devices: int):
    mgr = MeshManager(devices=["cpu"] * n_devices, executor="host")
    return V.ShardedBatchVerifier(mesh=mgr, min_device_batch=1), mgr


class TestOccupancyAccounting:
    """The waste math on the mesh's pad geometry (per-shard power-of-two
    bucket x active width, `_mesh_flat_launch`), on the host-executor
    mesh: the same shapes, host crypto."""

    def test_exact_fit_no_padding(self):
        v, _mgr = _host_mesh_verifier(4)
        assert bool(v.verify_batch(_make_sigs(32, b"fit")).all())  # 8 a shard: the least bucket
        rec = LAUNCHLOG.recent(kind="verify")[-1]
        assert rec["rows"] == 32 and rec.get("rows_padded", 0) == 0
        assert rec["mesh_width"] == 4 and rec["backend"] == "mesh"

    def test_bucket_boundary_cross_pads(self):
        v, _mgr = _host_mesh_verifier(4)
        # 33 rows / 4 shards -> 9 a shard -> bucket 16 -> 64 shipped rows
        assert bool(v.verify_batch(_make_sigs(33, b"cross")).all())
        rec = LAUNCHLOG.recent(kind="verify")[-1]
        assert rec["rows"] == 33 and rec["rows_padded"] == 64 - 33
        # 4 x (64, 32) uint8 lane arrays + (64,) int32 powers
        assert rec["transfer_bytes"] == 4 * 64 * 32 + 64 * 4
        summary = launchlog.summarize([rec])["verify"]
        assert summary["occupancy_pct"] == round(100.0 * 33 / 64, 1)
        assert summary["padding_waste_pct"] == round(100.0 * 31 / 64, 1)

    def test_non_divisible_row_count(self):
        v, _mgr = _host_mesh_verifier(4)
        assert bool(v.verify_batch(_make_sigs(10, b"odd")).all())  # ceil(10/4)=3 -> 8 -> 32
        rec = LAUNCHLOG.recent(kind="verify")[-1]
        assert rec["rows"] == 10 and rec["rows_padded"] == 22

    def test_rows_counters_advance(self):
        u0 = _counter("tendermint_launch_rows", kind="verify", state="useful")
        p0 = _counter("tendermint_launch_rows", kind="verify", state="padded")
        v, _mgr = _host_mesh_verifier(4)
        assert bool(v.verify_batch(_make_sigs(10, b"ctr")).all())
        assert _counter("tendermint_launch_rows", kind="verify", state="useful") - u0 == 10
        assert _counter("tendermint_launch_rows", kind="verify", state="padded") - p0 == 22

    def test_ladder_bucket_padding_on_one_device(self):
        """The one-device ladder lane pads to its power-of-two bucket and
        ships four (bucket, 32) uint8 arrays."""
        v = V.DeviceBatchVerifier(device="cpu", min_device_batch=1)
        triples = _make_sigs(5, b"ladder")
        triples[2] = (triples[2][0], triples[2][1], bytes(64))
        assert v.verify_batch(triples).tolist() == [True, True, False, True, True]
        (rec,) = LAUNCHLOG.recent()
        assert rec["kind"] == "verify" and rec["backend"] == "device"
        assert rec["rows"] == 5 and rec["rows_padded"] == 3 and rec["transfer_bytes"] == 4 * 8 * 32


class TestCacheFilteredLanes:
    def test_coalesced_flush_carries_cache_withholding_and_mix(self):
        v = CoalescingVerifier(V.HostBatchVerifier(), cache_size=1024, window_s=0.5)
        try:
            known, novel = _make_sigs(6, b"known"), _make_sigs(4, b"novel")
            assert bool(v.verify_batch(known).all())
            n_before = len(LAUNCHLOG)
            h = v.verify_batch_async(known + novel, consumer="consensus")
            assert bool(h.result(timeout=10).all())
            recs = LAUNCHLOG.recent()[n_before:]
            assert len(recs) == 1, recs
            rec = recs[0]
            assert rec["rows"] == 4 and rec["rows_cached"] == 6
            assert rec["consumers"] == {"consensus": 4} and rec["requests"] == 1
            assert rec["queue"] == "coalescer"
        finally:
            v.close()

    def test_fully_cached_offer_launches_nothing(self):
        v = CoalescingVerifier(V.HostBatchVerifier(), cache_size=1024, window_s=0.001)
        try:
            triples = _make_sigs(5, b"allcached")
            assert bool(v.verify_batch(triples).all())
            n_before = len(LAUNCHLOG)
            assert bool(v.verify_batch_async(triples, consumer="rpc").result(timeout=10).all())
            assert len(LAUNCHLOG) == n_before
        finally:
            v.close()

    def test_commit_grid_cached_lanes_reduce_requested_rows(self):
        """Cached commit-grid lanes are withheld from the table backend
        and tagged onto its launch record."""
        v = CoalescingVerifier(V.TableBatchVerifier(device="cpu", min_device_batch=1), cache_size=1024, window_s=0.5)
        try:
            triples = _make_sigs(4, b"grid")
            pubkeys = [pk for pk, _m, _s in triples]
            msgs = [m for _pk, m, _s in triples]
            sigs = [s for _pk, _m, s in triples]
            commit = (list(msgs), list(sigs))
            assert bool(v.verify_commits(pubkeys, [commit]).all())
            first = LAUNCHLOG.recent(kind="tables")[-1]
            assert first["rows"] == 4 and first["rows_cached"] == 0 and first["backend"] == "tables"
            n_before = len(LAUNCHLOG)
            assert bool(v.verify_commits(pubkeys, [commit]).all())
            assert len(LAUNCHLOG) == n_before  # no novel lane, no launch
            key = VerifiedSigCache.key(pubkeys[0], msgs[0], sigs[0])
            lock, od = v.cache._shard(key)
            with lock:
                od.pop(key, None)
            assert bool(v.verify_commits(pubkeys, [commit]).all())
            rec = LAUNCHLOG.recent(kind="tables")[-1]
            # the table path launches every lane of the filtered grid it
            # is handed: K x N rows, 3 of them absent (cached) lanes
            assert rec["rows"] == 4 and rec["rows_cached"] == 3
        finally:
            v.close()


def test_table_launches_file_under_tables():
    """`_observe_verify(kind="tables")`: a table launch is filed under
    `tables`, as in the JAX package, on the async path too (the handle
    is submitted as `verify`)."""
    V._observe_verify("tables", 12, 0.001, kind="tables")
    (rec,) = LAUNCHLOG.recent()
    assert rec["kind"] == "tables" and rec["backend"] == "tables" and rec["rows"] == 12
    tv = V.TableBatchVerifier(device="cpu", min_device_batch=1)
    triples = _make_sigs(3, b"kind")
    pubs = [t[0] for t in triples]
    q = DispatchQueue(depth=1, name="tables-kind")
    try:
        grid = tv.verify_commits_async(pubs, [([t[1] for t in triples], [t[2] for t in triples])], queue=q).result(10)
    finally:
        q.close()
    assert grid.tolist() == [[True, True, True]]
    rec = LAUNCHLOG.recent()[-1]
    assert (rec["kind"], rec["backend"], rec["queue"], rec["rows"]) == ("tables", "tables", "tables-kind", 3)
    assert rec["rows_padded"] == 0 and rec["transfer_bytes"] == 3 * 32 * 3


def test_implicit_record_takes_the_observed_kind():
    """A synchronous hash launch that annotates before its observe (the
    sharded data_hash's leaf lane) is filed under `hash`; the JAX
    package's ledger files it under `verify`, the kind its implicit
    records start with (a deliberate difference)."""
    for mod in (launchlog, J_launchlog):
        mod.annotate(_additive=True, rows_padded=3, mesh_width=2)
        mod.observe("hash", "mesh", 13, 0.0)
    (port,), (jax,) = LAUNCHLOG.recent(), J_launchlog.LAUNCHLOG.recent()
    assert (port["kind"], port["rows"], port["rows_padded"], port["mesh_width"]) == ("hash", 13, 3, 2)
    assert jax["kind"] == "verify" and _untimed(jax) == {**_untimed(port), "kind": "verify"}


class TestCompileCacheTelemetry:
    def test_pre_seeded_from_boot(self):
        for result in ("hit", "miss"):
            assert REGISTRY.get("tendermint_mesh_compile_total").labels(result=result).value >= 0
            assert REGISTRY.get("tendermint_table_device_cache_total").labels(result=result).value >= 0
        text = REGISTRY.prometheus_text()
        for kind in ("verify", "hash", "tables", "leaf_hashes"):
            for state in ("useful", "padded", "cached"):
                assert f'tendermint_launch_rows{{kind="{kind}",state="{state}"}}' in text

    def test_step_cache_miss_then_hit(self):
        mgr = MeshManager(devices=["cpu"] * 2, executor="host")
        program = f"launchlog-test-{time.monotonic_ns()}"
        seen_in_progress = []

        def build(devices):
            seen_in_progress.append(mesh_mod.compiles_in_progress())
            time.sleep(0.01)
            return "compiled-step"

        m0 = _counter("tendermint_mesh_compile_total", result="miss")
        h0 = _counter("tendermint_mesh_compile_total", result="hit")
        rec = launchlog.begin("verify")
        assert mgr._cached_step(program, build) == "compiled-step"
        assert seen_in_progress == [1] and mesh_mod.compiles_in_progress() == 0
        assert _counter("tendermint_mesh_compile_total", result="miss") - m0 == 1
        assert rec["compile"] == "miss" and rec["compile_s"] > 0
        assert mgr._cached_step(program, lambda devices: pytest.fail("rebuilt")) == "compiled-step"
        assert _counter("tendermint_mesh_compile_total", result="hit") - h0 == 1
        assert rec["compile"] == "hit"
        launchlog.commit(rec)

    def test_sharded_table_placement_cache(self, monkeypatch):
        mgr = MeshManager(devices=["cpu"] * 2, executor="host")
        v = V.ShardedTableBatchVerifier(mesh=mgr, min_device_batch=1)
        tables = torch.zeros((2, 2, 2, 4), dtype=torch.int16)
        key_ok = np.ones(4, dtype=bool)
        monkeypatch.setattr(v, "tables_for", lambda pubs: (tables, key_ok))
        pubs = tuple(bytes([i]) * 32 for i in range(4))
        m0 = _counter("tendermint_table_device_cache_total", result="miss")
        h0 = _counter("tendermint_table_device_cache_total", result="hit")
        rec = launchlog.begin("tables")
        placed, _ok = v._tables_for_mesh(pubs, mgr.active_devices())
        assert [p.shape for p in placed] == [(2, 2, 2, 2)] * 2
        assert _counter("tendermint_table_device_cache_total", result="miss") - m0 == 1
        assert rec["transfer_bytes"] == tables.numel() * tables.element_size()
        assert rec["device_put_s"] >= 0
        v._tables_for_mesh(pubs, mgr.active_devices())
        assert _counter("tendermint_table_device_cache_total", result="hit") - h0 == 1
        launchlog.commit(rec)


# -- the JAX wrapper stack and the port's, one seeded sequence ----------------


def _fake_primary(ver_mod, log_mod, keys_mod, mgr, program):
    """A device primary of either package that verifies with that
    package's host ed25519 and reports like a device backend: padded
    rows, shipped bytes, the mesh step cache (a miss on its first commit)
    and `_observe_verify`. Nothing here times anything."""

    def verdicts(triples):
        return np.array([keys_mod.PubKey(pk).verify(m, s) for pk, m, s in triples], dtype=bool)

    class FakePrimary(ver_mod.BatchVerifier):
        def verify_batch(self, triples):
            log_mod.annotate(_additive=True, rows_padded=-len(triples) % 8)
            log_mod.add_transfer(4 * 32 * len(triples))
            out = verdicts(triples)
            ver_mod._observe_verify("device", len(triples), 0.0)
            return out

        def launch_verify_commits(self, pubkeys, commits, force_fused=None):
            mgr._cached_step(program, (lambda *_a: time.sleep(0.25) or "step"))
            lanes = [(ci, i) for ci, (ms, ss) in enumerate(commits) for i in range(len(pubkeys))
                     if ms[i] is not None and ss[i] is not None]
            grid = np.zeros((len(commits), len(pubkeys)), dtype=bool)
            for (ci, i), ok in zip(lanes, verdicts([(pubkeys[i], commits[ci][0][i], commits[ci][1][i])
                                                    for ci, i in lanes])):
                grid[ci, i] = ok
            log_mod.annotate(_additive=True, rows_padded=len(commits) * len(pubkeys) - len(lanes))
            log_mod.add_transfer(96 * len(commits) * len(pubkeys))
            return grid, len(commits) * len(pubkeys)

        def finalize_verify_commits(self, launched):
            grid, rows = launched
            ver_mod._observe_verify("tables", rows, 0.0, kind="tables")
            return grid

        def verify_commits(self, pubkeys, commits, force_fused=None):
            return self.finalize_verify_commits(self.launch_verify_commits(pubkeys, commits))

    return FakePrimary()


def _fake_hasher(hasher_mod, log_mod, merkle_mod):
    class FakeDeviceHasher(hasher_mod.TreeHasher):
        def __init__(self):
            super().__init__(backend="host")

        def root_from_items(self, items):
            root = merkle_mod.simple_hash_from_byte_slices(items, self.algo)
            hasher_mod._observe_hash("device", len(items), 0.0)
            return root

        def leaf_hashes(self, items):
            out = [merkle_mod.leaf_hash(x, self.algo) for x in items]
            hasher_mod._observe_hash("device", len(items), 0.0, kind="leaf_hashes")
            return out

    return FakeDeviceHasher()


def _run_sequence(pkg: str, ledger_path: str) -> list[dict]:
    """The seeded sequence through one package's wrapper stack; returns
    the ledger's records (also written to `ledger_path`)."""
    if pkg == "jax":
        import jax

        from tendermint_tpu.crypto import keys as keys_mod
        from tendermint_tpu.merkle import simple as merkle_mod
        from tendermint_tpu.parallel.mesh import MeshManager as Mesh
        from tendermint_tpu.services import batcher as bat, dispatch as disp, hasher as hsh
        from tendermint_tpu.services import resilient as res, verifier as ver
        from tendermint_tpu.utils import circuit as circ, fail as fmod

        log_mod = J_launchlog
        mgr = Mesh(devices=list(jax.devices())[:2], executor="host")
    else:
        from tendermint_tpu_torch.crypto import keys as keys_mod
        from tendermint_tpu_torch.merkle import simple as merkle_mod
        from tendermint_tpu_torch.services import batcher as bat, dispatch as disp, hasher as hsh
        from tendermint_tpu_torch.services import resilient as res, verifier as ver
        from tendermint_tpu_torch.utils import circuit as circ, fail as fmod

        log_mod = launchlog
        mgr = MeshManager(devices=["cpu"] * 2, executor="host")
    program = f"seq-{pkg}-{time.monotonic_ns()}"
    ledger = log_mod.LaunchLedger(path=ledger_path, capacity=256, node_id="seq")
    saved = log_mod.LAUNCHLOG
    log_mod.LAUNCHLOG = ledger
    rng = np.random.default_rng(909)
    privs = [gen_priv_key(bytes([i + 1]) * 32) for i in range(6)]
    pubs = [p.pub_key.data for p in privs]

    def commit(tag, absent=(), forged=()):
        msgs, sigs = [], []
        for i, p in enumerate(privs):
            if i in absent:
                msgs.append(None)
                sigs.append(None)
                continue
            m = b"%s-%d" % (tag, i)
            s = p.sign(m)
            if i in forged:
                s = s[:5] + bytes([s[5] ^ 1]) + s[6:]
            msgs.append(m)
            sigs.append(s)
        return msgs, sigs

    stack = bat.CoalescingVerifier(
        res.ResilientVerifier(_fake_primary(ver, log_mod, keys_mod, mgr, program),
                              breaker=circ.CircuitBreaker(3, 60.0), max_retries=1),
        cache_size=1024, window_s=0.5,
    )
    hasher = res.ResilientTreeHasher(_fake_hasher(hsh, log_mod, merkle_mod), breaker=circ.CircuitBreaker(3, 60.0))
    qw, qh = disp.DispatchQueue(name="window"), disp.DispatchQueue(name="chunks")
    out = {}
    try:
        c1 = commit(b"h1", absent=(4,), forged=(2,))
        out["commit"] = stack.verify_commits(pubs, [c1]).tolist()
        window = [commit(b"w%d" % k, absent=(int(rng.integers(0, 6)),)) for k in range(3)]
        out["window"] = stack.verify_commits_async(pubs, window, queue=qw).result(10).tolist()
        flat = [(pubs[i], c1[0][i], c1[1][i]) for i in (0, 1)]
        flat += [(pubs[i], m, privs[i].sign(m)) for i, m in ((3, b"f0"), (5, b"f1"), (0, b"f2"))]
        flat += [(pubs[1], b"f3", privs[2].sign(b"f3"))]
        h1 = stack.verify_batch_async(flat[:3], consumer="consensus")
        h2 = stack.verify_batch_async(flat[3:], consumer="mempool")
        out["flat"] = [h1.result(10).tolist(), h2.result(10).tolist()]
        items = [rng.bytes(int(n)) for n in rng.integers(1, 64, 20)]
        out["root"] = hasher.root_from_items(items).hex()
        out["leaves"] = [x.hex() for x in hasher.leaf_hashes_async(items[:9], queue=qh).result(10)]
        fmod.set_device_fault("verify", 1)
        out["faulted"] = stack.verify_commits(pubs, [commit(b"h2", forged=(0,))]).tolist()
        fmod.clear_device_faults()
        out["snapshot"] = stack.inner.snapshot()
    finally:
        fmod.clear_device_faults()
        stack.close()
        qw.close()
        qh.close()
        log_mod.LAUNCHLOG = saved
        ledger.close()
    return out, ledger.recent()


def _untimed(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in TIME_FIELDS}


def _run_both(tmp_path, monkeypatch):
    from tendermint_tpu.services import resilient as J_res
    from tendermint_tpu_torch.services import resilient as P_res

    for mod in (J_res, P_res):
        monkeypatch.setattr(mod, "backoff_delay", lambda *a, **k: 0.0)
    paths = {pkg: str(tmp_path / f"{pkg}-launches.jsonl") for pkg in ("jax", "port")}
    return {pkg: _run_sequence(pkg, path) for pkg, path in paths.items()}, paths


def test_jax_and_port_ledgers_agree_record_for_record(tmp_path, monkeypatch):
    """Tolerance: exact, except the time fields (`t`, `*_s`)."""
    runs, _paths = _run_both(tmp_path, monkeypatch)
    (j_out, j_recs), (p_out, p_recs) = runs["jax"], runs["port"]
    assert p_out == j_out
    assert [_untimed(r) for r in p_recs] == [_untimed(r) for r in j_recs]
    assert [r.keys() - TIME_FIELDS for r in p_recs] == [r.keys() - TIME_FIELDS for r in j_recs]
    kinds = [(r["kind"], r["backend"], r.get("queue")) for r in p_recs]
    assert kinds == [
        ("tables", "tables", None),
        ("tables", "tables", "window"),
        ("verify", "device", "coalescer"),
        ("hash", "device", None),
        ("leaf_hashes", "device", "chunks"),
        ("tables", "tables", None),
    ]
    flat = p_recs[2]
    assert flat["consumers"] == {"consensus": 1, "mempool": 3} and flat["rows_cached"] == 2
    assert p_recs[0]["compile"] == "miss" and p_recs[1]["compile"] == "hit"
    assert not any(r.get("error") for r in p_recs)


def test_device_report_reads_the_port_ledger(tmp_path, monkeypatch):
    """`tools/device_report.py --ledgers <jsonl> --json` over the port's
    ledger gives the JAX ledger's per-kind waterfall (exact, except the
    seconds) and verdict."""
    _runs, paths = _run_both(tmp_path, monkeypatch)
    reports = {}
    for pkg, path in paths.items():
        out = tmp_path / f"{pkg}-report.json"
        res = subprocess.run(
            [sys.executable, str(REPO / "tools" / "device_report.py"), "--ledgers", path, "--json", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert res.returncode == 0, res.stderr[-2000:]
        assert "verdict:" in res.stdout
        reports[pkg] = json.loads(out.read_text())

    def waterfall(rep):
        return {kind: {k: v for k, v in agg.items() if k not in ("stages_s", "total_s", "compile_s", "device_put_s")}
                for kind, agg in rep["kinds"].items()}

    assert reports["port"]["launches"] == reports["jax"]["launches"] == 6
    assert waterfall(reports["port"]) == waterfall(reports["jax"])
    assert set(reports["port"]["kinds"]) == {"tables", "verify", "hash", "leaf_hashes"}
    # the 0.25 s step-cache miss outweighs every other waste source
    assert reports["port"]["verdict"]["top_waste_source"] == "compile_stalls"
    assert reports["port"]["verdict"]["top_waste_source"] == reports["jax"]["verdict"]["top_waste_source"]
