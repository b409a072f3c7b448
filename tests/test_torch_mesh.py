"""The port's device mesh (`tendermint_tpu_torch/parallel/mesh.py` and
the sharded verifier and hasher lanes) on CPU shards, held against the
JAX package's `tests/test_mesh_verifier.py` scenarios and its functions.

The choreography (pad geometry, shard faults, survivor re-mesh, the
breaker, the coalescer's drain order, the nemesis book) runs through the
`executor="host"` mesh, as in the JAX tests; the port's
`executor="device"` mesh runs the kernels' plain versions on CPU shards
(`cpu` repeated) and is held against the JAX host executor and host
verifier on the same seeded inputs: masks, tallies and leaf hashes equal
(tolerance 0). The mesh's card cases are in `tests/test_torch_cuda.py`
(the card's machine has no jax, which this file imports).
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.keys import gen_priv_key
from tendermint_tpu.parallel import mesh as J_mesh
from tendermint_tpu.services import verifier as J_ver
from tendermint_tpu.utils import fail as J_fail
from tendermint_tpu_torch.crypto import ed25519_ref
from tendermint_tpu_torch.merkle.simple import leaf_hash, simple_hash_from_byte_slices
from tendermint_tpu_torch.ops.ed25519_tables import host_build_key_tables
from tendermint_tpu_torch.parallel import mesh as mesh_mod
from tendermint_tpu_torch.parallel.mesh import (
    MeshExhaustedError,
    MeshManager,
    mesh_device_count,
    set_default_mesh_manager,
)
from tendermint_tpu_torch.services import verifier as svc
from tendermint_tpu_torch.services.batcher import MAX_COALESCED_BATCH, CoalescingVerifier
from tendermint_tpu_torch.services.hasher import TreeHasher, auto_hasher
from tendermint_tpu_torch.services.resilient import ResilientTreeHasher, ResilientVerifier
from tendermint_tpu_torch.services.verifier import (
    HostBatchVerifier,
    ShardedBatchVerifier,
    ShardedTableBatchVerifier,
    TableBatchVerifier,
    set_default_verifier,
)
from tendermint_tpu_torch.telemetry import REGISTRY
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

CPU = torch.device("cpu")
SHARDS = 8  # host-executor meshes: the JAX tests' 8 virtual devices


@pytest.fixture(autouse=True)
def _clean_mesh_state(monkeypatch):
    fail.clear_device_faults()
    J_fail.clear_device_faults()
    set_default_mesh_manager(None, "cpu")
    yield
    fail.clear_device_faults()
    J_fail.clear_device_faults()
    set_default_mesh_manager(None, "cpu")
    set_default_verifier(None, "cpu")


def _triples(n, corrupt=(), salt=b""):
    out = []
    for i in range(n):
        seed = bytes([i + 1]) * 32
        msg = b"mesh-msg-%s-%d" % (salt, i)
        sig = ed25519_ref.sign(seed, msg)
        if i in corrupt:
            sig = sig[:8] + bytes([sig[8] ^ 1]) + sig[9:]
        out.append((ed25519_ref.public_from_seed(seed), msg, sig))
    return out


def _counter(name, **labels) -> float:
    return REGISTRY.counter_value(name, **labels)


def _host_mesh_verifier(min_batch=1, reprobe_s=60.0, shards=SHARDS):
    mgr = MeshManager(devices=[CPU] * shards, executor="host", reprobe_s=reprobe_s)
    return ShardedBatchVerifier(mesh=mgr, min_device_batch=min_batch), mgr


# -- the numpy helpers against the JAX package's --------------------------------


@pytest.mark.parametrize("k,n_vals,shards", [(1, 16, 4), (3, 16, 4), (2, 24, 8), (16, 1000, 4)])
def test_lane_reorder_matches_jax(k, n_vals, shards):
    rng = np.random.default_rng(k * 1000 + n_vals)
    rows = rng.integers(0, 256, (k * n_vals, 32), dtype=np.uint8)
    flags = rng.random(k * n_vals) < 0.5
    got = mesh_mod.shard_lanes_validator_major([rows, flags], n_vals, shards)
    want = J_mesh.shard_lanes_validator_major([rows, flags], n_vals, shards)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    back = mesh_mod.unshard_lanes_validator_major(got[0], n_vals, shards)
    assert np.array_equal(back, J_mesh.unshard_lanes_validator_major(want[0], n_vals, shards))
    assert np.array_equal(back, rows)


def test_lane_reorder_rejects_an_uneven_split():
    with pytest.raises(ValueError):
        mesh_mod.shard_lanes_validator_major([np.zeros((10, 32), np.uint8)], 10, 4)


@pytest.mark.parametrize("b,multiple", [(10, 8), (16, 8), (1, 4), (13, 3)])
def test_pad_to_multiple_matches_jax(b, multiple):
    rng = np.random.default_rng(b)
    arrays = [rng.integers(0, 256, (b, 32), dtype=np.uint8) for _ in range(4)]
    powers = rng.integers(1, 100, b).astype(np.int32)
    got_a, got_p, got_n = mesh_mod.pad_to_multiple(arrays, powers, multiple)
    want_a, want_p, want_n = J_mesh.pad_to_multiple(arrays, powers, multiple)
    assert got_n == want_n == b
    assert np.array_equal(got_p, want_p)
    for g, w in zip(got_a, want_a):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("knob", ["0", "1", "3", "8", "64"])
def test_mesh_device_count_matches_jax(monkeypatch, knob):
    """As many cards as the JAX package sees devices: the same count."""
    monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", knob)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(jax.devices()))
    assert mesh_device_count("cuda") == J_mesh.mesh_device_count()


def test_host_rows_evaluation_matches_jax():
    """The host executor's verify equation, row for row, against the JAX
    package's, with a forged row, a zero row and a non-canonical key."""
    from tendermint_tpu_torch.ops.ed25519_kernel import prepare_batch

    triples = _triples(6, corrupt={2})
    triples[4] = (b"\xff" * 31 + b"\x7f", triples[4][1], triples[4][2])
    pub, r, s, h, _pre = prepare_batch(*zip(*triples))
    pub[5] = r[5] = s[5] = h[5] = 0
    got = mesh_mod._host_verify_prepared_rows(pub, r, s, h)
    assert np.array_equal(got, J_mesh._host_verify_prepared_rows(pub, r, s, h))
    assert got.tolist() == [True, True, False, True, False, False]


# -- MeshManager -----------------------------------------------------------------


class TestMeshManager:
    def test_cpu_shards_from_the_knob(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", "8")
        assert mesh_device_count("cpu") == 8
        mgr = MeshManager(device="cpu", executor="host")
        assert mgr.n_total == 8 and mgr.devices == (CPU,) * 8
        assert mgr.active_indices() == tuple(range(8))
        assert not mgr.degraded

    def test_mesh_devices_knob(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)  # 8 cards, counted only
        monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", "3")
        assert mesh_device_count("cuda") == 3
        assert MeshManager(device="cpu", executor="host").n_total == 3
        monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", "1")
        assert mesh_device_count("cuda") == 1  # the single-device path
        monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", "0")
        assert mesh_device_count("cuda") == 8  # 0/unset = all
        assert mesh_device_count("cpu") == 1  # the CPU has one device unless the knob asks
        monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", "64")
        assert mesh_device_count("cuda") == 8  # capped at visible devices

    def test_devices_are_indexed_and_may_repeat(self):
        mgr = MeshManager(devices=["cpu", CPU, "cpu"])
        assert mgr.devices == (CPU,) * 3
        with pytest.raises(ValueError):
            MeshManager(devices=[])
        with pytest.raises(ValueError):
            MeshManager(devices=[CPU], executor="tpu")

    def test_shard_fault_excludes_then_reprobe_restores(self):
        mgr = MeshManager(devices=[CPU] * 8, executor="host", reprobe_s=0.05)
        shrink0 = _counter("tendermint_mesh_remesh_total", direction="shrink")
        restore0 = _counter("tendermint_mesh_remesh_total", direction="restore")
        assert mgr.record_shard_fault(5)  # survivors remain
        assert mgr.n_active == 7
        assert 5 not in mgr.active_indices()
        assert mgr.degraded
        assert _counter("tendermint_mesh_remesh_total", direction="shrink") == shrink0 + 1
        mgr.maybe_reprobe()  # inside the window: still degraded
        assert mgr.n_active == 7
        time.sleep(0.06)
        mgr.maybe_reprobe()
        assert mgr.n_active == 8 and not mgr.degraded
        assert _counter("tendermint_mesh_remesh_total", direction="restore") == restore0 + 1

    def test_reprobe_keeps_excluding_while_fault_armed(self):
        mgr = MeshManager(devices=[CPU] * 8, executor="host", reprobe_s=0.05)
        fail.set_device_fault("shard2")
        assert mgr.record_shard_fault(2)
        time.sleep(0.06)
        mgr.maybe_reprobe()  # peeks the armed fault, stays degraded
        assert mgr.n_active == 7
        fail.clear_device_faults()
        time.sleep(0.06)
        mgr.maybe_reprobe()
        assert mgr.n_active == 8

    def test_exhaustion_reports_no_survivors(self):
        mgr = MeshManager(devices=[CPU] * 8, executor="host")
        for i in range(7):
            assert mgr.record_shard_fault(i)
        assert not mgr.record_shard_fault(7)
        assert mgr.n_active == 0
        snap = mgr.snapshot()
        assert snap["devices_active"] == 0
        assert snap["excluded"] == list(range(8))

    def test_devices_gauge_tracks_active(self):
        mgr = MeshManager(devices=[CPU] * 8, executor="host")
        fam = REGISTRY.get("tendermint_mesh_devices")
        assert fam.value == 8
        mgr.record_shard_fault(1)
        assert fam.value == 7
        mgr.reset()
        assert fam.value == 8

    def test_shard_fault_spec_from_the_env(self, monkeypatch):
        """The same `shard<i>[:count]` spec as the JAX package, on the
        port's own fault state."""
        monkeypatch.setenv("TENDERMINT_TPU_DEVICE_FAIL", "shard1:2")
        monkeypatch.setattr(fail, "_device_faults", None)  # re-read the env
        assert fail.shard_fault_armed(1) and not fail.shard_fault_armed(0)
        fail.shard_fail_point((0, 2))  # shard 1 not in the mesh: nothing fires
        for _ in range(2):
            with pytest.raises(fail.ShardDeviceFault) as e:
                fail.shard_fail_point((0, 1, 2))
            assert e.value.shard == 1
            assert isinstance(e.value, fail.InjectedDeviceFault)
        fail.shard_fail_point((0, 1, 2))  # budget spent
        assert not fail.shard_fault_armed(1)
        assert J_fail._device_faults in (None, {})  # the JAX fault state stayed unarmed

    def test_step_cache_counts_the_first_use_of_a_device_set(self):
        mgr = MeshManager(devices=[CPU] * 3)
        miss0 = _counter("tendermint_mesh_compile_total", result="miss")
        hit0 = _counter("tendermint_mesh_compile_total", result="hit")
        mgr.verify_step()
        mgr.verify_step()
        MeshManager(devices=[CPU] * 3).verify_step()  # shared process-wide
        moved = (
            _counter("tendermint_mesh_compile_total", result="miss") - miss0,
            _counter("tendermint_mesh_compile_total", result="hit") - hit0,
        )
        assert moved in ((1, 2), (0, 3))  # (0, 3): an earlier test used this device set
        assert mesh_mod.compiles_in_progress() == 0


# -- the flat mesh lanes (host executor) -------------------------------------------


class TestShardedVerifierHostExecutor:
    @pytest.mark.parametrize("n", [1, 7, 8, 9, 16, 17])
    def test_pad_slice_round_trip_non_divisible(self, n):
        """Every batch size, divisible by the mesh or not, comes back
        equal to the host verifier's, at the true length."""
        v, _mgr = _host_mesh_verifier()
        triples = _triples(n, corrupt={n - 1} if n > 2 else ())
        want = HostBatchVerifier().verify_batch(triples)
        got = v.verify_batch(triples)
        assert got.shape == (n,)
        assert (got == want).all()

    def test_per_shard_bucket_geometry(self, monkeypatch):
        """Launch rows = a power-of-two bucket a shard x active shards,
        derived again after a survivor re-mesh."""
        v, mgr = _host_mesh_verifier()
        shapes = []
        real_factory = mgr.verify_step

        def spying_step():
            real = real_factory()

            def _step(pub, r, s, h, pw):
                shapes.append(pub.shape[0])
                return real(pub, r, s, h, pw)

            return _step

        monkeypatch.setattr(mgr, "verify_step", spying_step)
        v.verify_batch(_triples(10))
        assert shapes[-1] == 8 * 8  # ceil(10/8)=2 -> bucket 8 -> x8 shards
        for i in (0, 1, 2):
            mgr.record_shard_fault(i)
        v.verify_batch(_triples(10))
        assert shapes[-1] == 8 * 5  # 5 survivors, bucket 8 a shard
        v.verify_batch(_triples(40, salt=b"big"))
        assert shapes[-1] == 8 * 5  # ceil(40/5)=8 -> bucket 8

    def test_zero_padding_rows_never_verify(self):
        zeros = np.zeros((16, 32), dtype=np.uint8)
        assert not mesh_mod._host_verify_prepared_rows(zeros, zeros, zeros, zeros).any()

    def test_commit_tally_with_powers(self):
        v, _mgr = _host_mesh_verifier()
        triples = _triples(10, corrupt={3, 7})
        powers = np.arange(1, 11, dtype=np.int32)
        mask, tally = v.verify_batch_with_powers(triples, powers)
        want = HostBatchVerifier().verify_batch(triples)
        assert (mask == want).all()
        assert tally == int(powers[want].sum())

    def test_commit_grid_flat_lanes(self):
        v, _mgr = _host_mesh_verifier()
        triples = _triples(10, corrupt={2})
        pubs, msgs, sigs = (list(x) for x in zip(*triples))
        absent_msgs, absent_sigs = list(msgs), list(sigs)
        absent_msgs[5] = absent_sigs[5] = None
        grid = v.verify_commits(pubs, [(msgs, sigs), (absent_msgs, absent_sigs)])
        assert grid.shape == (2, 10)
        want = HostBatchVerifier().verify_batch(triples)
        assert (grid[0] == want).all()
        want_absent = want.copy()
        want_absent[5] = False
        assert (grid[1] == want_absent).all()

    def test_small_batch_short_circuits_to_host(self, monkeypatch):
        v, mgr = _host_mesh_verifier(min_batch=512)

        def boom():  # the mesh must not be consulted below the threshold
            raise AssertionError("sub-threshold batch reached the mesh")

        monkeypatch.setattr(mgr, "verify_step", boom)
        assert v.verify_batch(_triples(4)).all()

    def test_shard_fault_survivor_remesh_keeps_serving(self):
        """One shard fault degrades through the re-mesh, not through the
        breaker: verdicts stay right, the resilient wrapper sees no
        failure, the shrink shows in the registry."""
        v, mgr = _host_mesh_verifier()
        rv = ResilientVerifier(v)
        faults0 = _counter("tendermint_mesh_shard_faults_total")
        fallback0 = _counter("tendermint_device_fallback_calls_total", kind="verify")
        fail.set_device_fault("shard4")
        triples = _triples(12, corrupt={0})
        want = HostBatchVerifier().verify_batch(triples)
        assert (rv.verify_batch(triples) == want).all()
        assert mgr.n_active == 7 and 4 not in mgr.active_indices()
        assert _counter("tendermint_mesh_shard_faults_total") == faults0 + 1
        assert _counter("tendermint_device_fallback_calls_total", kind="verify") == fallback0
        assert rv.breaker.state == "closed"
        assert rv.snapshot()["mesh"]["excluded"] == [4]

    def test_exhaustion_degrades_through_breaker_then_recovers(self):
        """Every shard faulted -> MeshExhaustedError -> the breaker's host
        fallback; clearing the faults and passing the re-probe window
        restores the full mesh."""
        v, mgr = _host_mesh_verifier(reprobe_s=0.05)
        rv = ResilientVerifier(v, max_retries=0)
        for i in range(8):
            fail.set_device_fault(f"shard{i}")
        fallback0 = _counter("tendermint_device_fallback_calls_total", kind="verify")
        triples = _triples(10, corrupt={1})
        want = HostBatchVerifier().verify_batch(triples)
        assert (rv.verify_batch(triples) == want).all()  # the breaker's fallback answers
        assert mgr.n_active == 0
        assert _counter("tendermint_device_fallback_calls_total", kind="verify") == fallback0 + 1
        fail.clear_device_faults()
        time.sleep(0.06)
        restore0 = _counter("tendermint_mesh_remesh_total", direction="restore")
        assert (rv.verify_batch(triples) == want).all()
        assert mgr.n_active == 8
        assert _counter("tendermint_mesh_remesh_total", direction="restore") == restore0 + 1

    def test_mesh_exhausted_raises_without_breaker(self):
        v, _mgr = _host_mesh_verifier()
        for i in range(8):
            fail.set_device_fault(f"shard{i}")
        with pytest.raises(MeshExhaustedError):
            v.verify_batch(_triples(9))


# -- the table path over a mesh: lane geometry and routing (steps faked) ----------


class TestTablesMeshGeometry:
    """The validator-axis table path's lane order, routing and fallbacks
    on a 4-shard CPU mesh, with the step faked (the echo of lane_ok); the
    kernels' verdicts are held by `TestAgainstJax`. The port has no K % 8
    padding: each shard takes its chain from its own stack depth."""

    SHARDS = 4

    def _verifier(self, n, monkeypatch, executor="device"):
        seeds = [bytes([i + 1]) * 32 for i in range(n)]
        pubs = tuple(ed25519_ref.public_from_seed(s) for s in seeds)
        mgr = MeshManager(devices=[CPU] * self.SHARDS, executor=executor, reprobe_s=60.0)
        v = ShardedTableBatchVerifier(mesh=mgr, min_device_batch=1)
        tables, ok = host_build_key_tables(list(pubs))
        v._tables[v._cache_key(pubs)] = (pubs, torch.from_numpy(tables), ok)
        calls = []

        def fake_tables_step():
            def _step(tables, s, h, r, lane_ok, power, impl="auto"):
                calls.append({"lanes": s.shape[0], "impl": impl, "lane_ok": lane_ok.copy()})
                return [lane_ok.copy()], int(np.where(lane_ok, power, 0).sum())

            return _step

        monkeypatch.setattr(mgr, "tables_step", fake_tables_step)
        return seeds, pubs, v, mgr, calls

    def _commits(self, seeds, k, absent=()):
        commits = []
        for c in range(k):
            msgs = [b"c%d-%d" % (c, i) for i in range(len(seeds))]
            sigs = [ed25519_ref.sign(s, m) for s, m in zip(seeds, msgs)]
            for (ci, i) in absent:
                if ci == c:
                    msgs[i] = sigs[i] = None
            commits.append((msgs, sigs))
        return commits

    def test_shard_major_order_and_absent_lanes(self, monkeypatch):
        """The grid an echo-lane_ok step gives equals the presence mask:
        the shard-major reorder and its inverse keep every lane's place."""
        seeds, pubs, v, mgr, calls = self._verifier(16, monkeypatch)
        grid = v.verify_commits(list(pubs), self._commits(seeds, 3, absent=[(1, 5), (2, 0)]))
        want = np.ones((3, 16), dtype=bool)
        want[1, 5] = want[2, 0] = False
        assert grid.shape == (3, 16) and (grid == want).all()
        assert calls[-1]["lanes"] == 3 * 16
        # shard-major: shard i's block holds its 4 validators of every commit
        lane_ok = calls[-1]["lane_ok"].reshape(self.SHARDS, 3, 4)
        assert not lane_ok[1, 1, 1] and not lane_ok[0, 2, 0]

    def test_force_fused_routes_without_k_padding(self, monkeypatch):
        """force_fused picks the chain for every shard; the stack is not
        padded to a multiple of 8 (a TPU tiling rule the port drops)."""
        seeds, pubs, v, mgr, calls = self._verifier(16, monkeypatch)
        commits = self._commits(seeds, 3)
        grid = v.verify_commits(list(pubs), commits, force_fused=True)
        assert grid.shape == (3, 16) and grid.all()
        assert calls[-1]["lanes"] == 3 * 16 and calls[-1]["impl"] == "fused"
        v.verify_commits(list(pubs), commits, force_fused=False)
        assert calls[-1]["impl"] == "entries"
        v.verify_commits(list(pubs), commits)
        assert calls[-1]["impl"] == "auto"

    @pytest.mark.parametrize("k,route", [(1, "entries"), (7, "entries"), (8, "fused")])
    def test_each_shard_routes_on_its_own_stack_depth(self, monkeypatch, k, route):
        """The real step with the verify faked: each shard gets its N/4
        columns and K * N/4 lanes, so `verify_tables_kernel(impl="auto")`
        sees the shard's own stack depth K."""
        seeds, pubs, v, mgr, _calls = self._verifier(16, monkeypatch)
        monkeypatch.undo()  # the real tables_step
        seen = []

        def fake_verify(tables, s, h, r, impl="auto"):
            n_vals = tables.shape[3]
            depth = s.shape[0] // n_vals
            seen.append((n_vals, depth, "fused" if depth >= 8 else "entries", impl))
            return torch.ones(s.shape[0], dtype=torch.bool)

        monkeypatch.setattr(mesh_mod, "verify_tables_kernel", fake_verify)
        monkeypatch.setattr(fail, "_device_faults", {})
        grid = v.verify_commits(list(pubs), self._commits(seeds, k))
        assert grid.shape == (k, 16) and grid.all()
        assert seen == [(4, k, route, "auto")] * self.SHARDS

    def test_uneven_valset_falls_back_to_single_device(self, monkeypatch):
        """N = 10 does not split over 4 shards: the call takes the
        one-card table path, not an error."""
        seeds, pubs, v, mgr, calls = self._verifier(10, monkeypatch)
        sentinel = []

        def spy(self, pubkeys, commits, force_fused=None):
            sentinel.append(len(pubkeys))
            return ("host", self._host_commit_loop(pubkeys, commits))

        monkeypatch.setattr(TableBatchVerifier, "launch_verify_commits", spy)
        grid = v.verify_commits(list(pubs), self._commits(seeds, 2))
        assert sentinel == [10]
        assert grid.shape == (2, 10) and grid.all()
        assert not calls  # the mesh step was never consulted

    def test_shard_fault_mid_commit_grid_remeshes(self, monkeypatch):
        """A shard fault during a commit-grid launch re-meshes; 16
        validators over 3 survivors do not split evenly, so the same
        call lands on the one-card path: degraded but serving."""
        seeds, pubs, v, mgr, calls = self._verifier(16, monkeypatch)
        fail.set_device_fault("shard3")
        grid = v.verify_commits(list(pubs), self._commits(seeds, 2))
        assert grid.shape == (2, 16) and grid.all()
        assert mgr.n_active == 3 and not calls

    def test_host_executor_routes_flat_lanes(self, monkeypatch):
        seeds, pubs, v, mgr, calls = self._verifier(16, monkeypatch, executor="host")
        grid = v.verify_commits(list(pubs), self._commits(seeds, 2, absent=[(0, 1)]))
        want = np.ones((2, 16), dtype=bool)
        want[0, 1] = False
        assert (grid == want).all()
        assert not calls  # the host executor has no table step

    def test_placements_are_cached_by_set_and_device_tuple(self):
        seeds = [bytes([i + 1]) * 32 for i in range(8)]
        pubs = tuple(ed25519_ref.public_from_seed(s) for s in seeds)
        mgr = MeshManager(devices=[CPU] * self.SHARDS)
        v = ShardedTableBatchVerifier(mesh=mgr, min_device_batch=1)
        tables, ok = host_build_key_tables(list(pubs))
        v._tables[v._cache_key(pubs)] = (pubs, torch.from_numpy(tables), ok)
        miss0 = _counter("tendermint_table_device_cache_total", result="miss")
        hit0 = _counter("tendermint_table_device_cache_total", result="hit")
        placed, key_ok = v._tables_for_mesh(pubs, mgr.active_devices())
        again, _ = v._tables_for_mesh(pubs, mgr.active_devices())
        assert again is placed and key_ok.all()
        assert [tuple(t.shape) for t in placed] == [(64, 16, 60, 2)] * self.SHARDS
        for i, t in enumerate(placed):
            assert t.is_contiguous()
            assert np.array_equal(t.numpy(), tables[..., 2 * i : 2 * i + 2])
        v._tables_for_mesh(pubs, mgr.active_devices()[:2])  # another device set: placed anew
        assert _counter("tendermint_table_device_cache_total", result="miss") == miss0 + 2
        assert _counter("tendermint_table_device_cache_total", result="hit") == hit0 + 1


# -- the coalescer over a mesh -------------------------------------------------------


class TestCoalescerMeshIntegration:
    def test_max_batch_scales_with_mesh_width(self):
        v, _mgr = _host_mesh_verifier()
        cv = CoalescingVerifier(ResilientVerifier(v))
        try:
            assert cv.coalescer._max_batch == MAX_COALESCED_BATCH * 8
        finally:
            cv.close()
        single = CoalescingVerifier(HostBatchVerifier())
        try:
            assert single.coalescer._max_batch == MAX_COALESCED_BATCH
        finally:
            single.close()

    def test_explicit_max_batch_stays_per_call(self):
        v, _mgr = _host_mesh_verifier()
        cv = CoalescingVerifier(ResilientVerifier(v), max_batch=64)
        try:
            assert cv.coalescer._max_batch == 64
        finally:
            cv.close()

    def test_drain_order_through_mid_coalesce_shard_fault(self):
        """Two consumers stream FIFO batches through one coalescer; a
        shard fault lands mid-stream. The re-mesh happens inside the
        merged launch: every handle resolves, in each consumer's order,
        with the right verdicts."""
        v, mgr = _host_mesh_verifier()
        cv = CoalescingVerifier(ResilientVerifier(v), cache_size=0, window_s=0.002)
        try:
            batches = {
                tag: [_triples(6, corrupt={r}, salt=b"%s%d" % (tag.encode(), r)) for r in range(3)]
                for tag in ("consensus", "fastsync")
            }
            handles = {tag: [] for tag in batches}
            for r in range(3):
                for tag in batches:
                    handles[tag].append(cv.verify_batch_async(batches[tag][r], consumer=tag))
                if r == 0:
                    fail.set_device_fault("shard6")
            for tag in batches:
                for r, h in enumerate(handles[tag]):
                    want = np.ones(6, dtype=bool)
                    want[r] = False
                    assert (h.result(timeout=30) == want).all(), (tag, r)
            assert mgr.n_active == 7
        finally:
            cv.close()


# -- the default stacks ------------------------------------------------------------------


class TestDefaultStackComposition:
    def test_cpu_opt_in_builds_mesh_stack(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", "8")
        set_default_verifier(None, "cpu")
        v = svc.default_verifier("cpu")
        try:
            assert isinstance(v, CoalescingVerifier)
            assert isinstance(v.inner, ResilientVerifier)
            assert isinstance(v.inner.primary, ShardedBatchVerifier)
            assert v.inner.primary.mesh.n_total == 8
            assert v.inner.mesh is v.inner.primary.mesh  # passthrough
            assert v.coalescer._max_batch == MAX_COALESCED_BATCH * 8
        finally:
            v.close()
            set_default_verifier(None, "cpu")

    def test_cpu_without_knob_stays_one_device(self, monkeypatch):
        monkeypatch.delenv("TENDERMINT_TPU_MESH_DEVICES", raising=False)
        set_default_verifier(None, "cpu")
        v = svc.default_verifier("cpu")
        try:
            assert type(v.inner.primary) is TableBatchVerifier
            assert v.inner.mesh is None
        finally:
            v.close()
            set_default_verifier(None, "cpu")

    def test_force_single_device_knob(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", "1")
        set_default_verifier(None, "cpu")
        v = svc.default_verifier("cpu")
        try:
            assert not isinstance(v.inner.primary, ShardedBatchVerifier)
        finally:
            v.close()
            set_default_verifier(None, "cpu")

    def test_auto_hasher_cpu_opt_in_gets_mesh(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", "8")
        h = auto_hasher("cpu")
        assert isinstance(h, ResilientTreeHasher)
        assert h.mesh is not None and h.mesh.n_total == 8
        assert h.primary.mesh is h.mesh

    def test_auto_hasher_without_knob_has_no_mesh(self, monkeypatch):
        monkeypatch.delenv("TENDERMINT_TPU_MESH_DEVICES", raising=False)
        h = auto_hasher("cpu")
        assert isinstance(h, ResilientTreeHasher) and h.mesh is None and h.primary.mesh is None


# -- the hash plane's leaf lane over a mesh ------------------------------------------------


class TestMeshHasherLane:
    def test_host_executor_leaf_hashes_match_and_remesh(self):
        mgr = MeshManager(devices=[CPU] * 8, executor="host", reprobe_s=60.0)
        th = TreeHasher(backend="device", min_device_leaves=2, mesh=mgr)
        items = [b"leaf-%d" % i for i in range(37)]
        fail.set_device_fault("shard1")
        assert th.leaf_hashes(items) == [leaf_hash(x) for x in items]
        assert mgr.n_active == 7  # the hash lane re-meshed too

    def test_hash_lane_exhaustion_hits_hash_breaker(self):
        mgr = MeshManager(devices=[CPU] * 8, executor="host")
        th = ResilientTreeHasher(
            TreeHasher(backend="device", min_device_leaves=2, mesh=mgr),
            TreeHasher(backend="host"),
            max_retries=0,
        )
        for i in range(8):
            fail.set_device_fault(f"shard{i}")
        fallback0 = _counter("tendermint_device_fallback_calls_total", kind="hash")
        items = [b"x%d" % i for i in range(9)]
        assert th.leaf_hashes(items) == [leaf_hash(x) for x in items]
        assert _counter("tendermint_device_fallback_calls_total", kind="hash") == fallback0 + 1

    @pytest.mark.parametrize("algo", ["sha256", "ripemd160"])
    def test_device_executor_against_jax(self, algo):
        """The port's leaf lane on 4 CPU shards (the hash kernels' plain
        versions) against the JAX `leaf_hashes_sharded` on its host
        executor, and the root over the sharded leaves against the JAX
        host tree; one shard out mid-run."""
        from tendermint_tpu.merkle import simple as J_simple
        from tendermint_tpu.ops.merkle_kernel import leaf_hashes_sharded as J_leaf_hashes_sharded

        rng = np.random.default_rng(8)
        items = [bytes(rng.integers(0, 256, int(k), dtype=np.uint8)) for k in rng.integers(0, 200, 45)]
        mgr = MeshManager(devices=[CPU] * 4, reprobe_s=60.0)
        th = TreeHasher(algo=algo, device="cpu", min_device_leaves=2, mesh=mgr)
        j_mgr = J_mesh.MeshManager(devices=jax.devices()[:4], executor="host", reprobe_s=60.0)
        want = J_leaf_hashes_sharded(items, algo, j_mgr)
        assert th.leaf_hashes(items) == want
        assert th.root_from_items(items) == J_simple.simple_hash_from_byte_slices(items, algo)
        fail.set_device_fault("shard2")
        assert th.leaf_hashes(items) == want
        assert mgr.active_indices() == (0, 1, 3)
        assert th.root_from_items(items) == simple_hash_from_byte_slices(items, algo)


# -- the device executor against the JAX package -------------------------------------------


class TestAgainstJax:
    def test_flat_mesh_masks_and_tallies(self):
        """The port's device mesh on 4 CPU shards (the ladder and finish
        plain versions) against a JAX `ShardedBatchVerifier` over its host
        executor, on the same triples with a forged lane and a
        non-canonical key: masks and tallies equal."""
        privs = [gen_priv_key(bytes([i + 1]) * 32) for i in range(12)]
        triples = []
        for i, p in enumerate(privs):
            msg = b"differential-%d" % i
            sig = p.sign(msg)
            if i == 5:
                sig = sig[:8] + bytes([sig[8] ^ 1]) + sig[9:]
            triples.append((p.pub_key.data, msg, sig))
        triples[9] = (b"\xff" * 31 + b"\x7f",) + triples[9][1:]
        powers = np.random.default_rng(12).integers(1, 50, 12).astype(np.int32)
        j_mgr = J_mesh.MeshManager(devices=jax.devices()[:4], executor="host", reprobe_s=60.0)
        j_mask, j_tally = J_ver.ShardedBatchVerifier(mesh=j_mgr, min_device_batch=1).verify_batch_with_powers(
            triples, powers
        )
        mgr = MeshManager(devices=[CPU] * 4, reprobe_s=60.0)
        mask, tally = ShardedBatchVerifier(mesh=mgr, min_device_batch=1).verify_batch_with_powers(triples, powers)
        assert mask.tolist() == np.asarray(j_mask).tolist()
        assert tally == j_tally == int(powers[mask].sum())
        assert not mask[5] and not mask[9] and mask.sum() == 10

    def test_table_grid_against_jax_host(self):
        """A 16-validator `ShardedTableBatchVerifier` grid on 4 CPU shards
        (4 table columns a shard, the entries chain's plain version)
        against the JAX `HostBatchVerifier`, with a forged lane, an
        absent vote and a non-canonical key."""
        seeds = [bytes([i + 1]) * 32 for i in range(16)]
        pubs = [ed25519_ref.public_from_seed(s) for s in seeds]
        pubs[11] = b"\xff" * 31 + b"\x7f"
        commits = []
        for c in range(2):
            msgs = [b"grid-%d-%d" % (c, i) for i in range(16)]
            sigs = [ed25519_ref.sign(s, m) for s, m in zip(seeds, msgs)]
            commits.append((msgs, sigs))
        commits[0][1][3] = bytes([commits[0][1][3][0] ^ 1]) + commits[0][1][3][1:]
        commits[1][0][6] = commits[1][1][6] = None
        mgr = MeshManager(devices=[CPU] * 4, reprobe_s=60.0)
        v = ShardedTableBatchVerifier(mesh=mgr, min_device_batch=1)
        grid = v.verify_commits(pubs, commits)
        j_host = J_ver.HostBatchVerifier()
        want = np.zeros((2, 16), dtype=bool)
        for c, (msgs, sigs) in enumerate(commits):
            lanes = [i for i in range(16) if msgs[i] is not None]
            want[c, lanes] = j_host.verify_batch([(pubs[i], msgs[i], sigs[i]) for i in lanes])
        assert (grid == want).all()
        assert want.sum() == 2 * 16 - 4


# -- the nemesis book ------------------------------------------------------------------------


def _mesh_reading() -> dict:
    return {
        "faults": _counter("tendermint_mesh_shard_faults_total"),
        "shrinks": _counter("tendermint_mesh_remesh_total", direction="shrink"),
        "restores": _counter("tendermint_mesh_remesh_total", direction="restore"),
        "trips": _counter("tendermint_breaker_transitions_total", kind="verify", to="open"),
    }


class TestMeshNemesis:
    def test_live_net_loses_shard_mid_height_keeps_committing(self, tmp_path, monkeypatch):
        """The JAX nemesis acceptance scenario on port stacks: a running
        4-validator net whose verify spine is the port's mesh stack
        (coalescer -> resilient -> sharded mesh, host executor) loses one
        shard mid-height. Each mesh re-meshes onto 7 survivors and the
        chain keeps committing: no fork, no breaker trip; clearing the
        fault restores every mesh. Read from the port's registry (the
        JAX `Nemesis.mesh_baseline` reads the JAX one)."""
        from tendermint_tpu.testing import Nemesis

        stacks = []

        def factory(_i):
            mgr = MeshManager(devices=[CPU] * 8, executor="host", reprobe_s=0.5)
            cv = CoalescingVerifier(
                ResilientVerifier(ShardedBatchVerifier(mesh=mgr, min_device_batch=1), max_retries=0),
                cache_size=4096,
            )
            stacks.append((cv, mgr))
            return cv

        monkeypatch.setattr(J_ver, "_DEFAULT", factory(None))

        def wait(pred, timeout=30.0):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if pred():
                    return True
                time.sleep(0.1)
            return pred()

        try:
            with Nemesis(4, home=str(tmp_path), verifier_factory=factory,
                         hasher_factory=lambda _i: TreeHasher(backend="host")) as net:
                net.wait_height(2, timeout=60)
                base = _mesh_reading()
                fail.set_device_fault("shard2")  # one card dies mid-height
                net.wait_progress(delta=2, timeout=60)  # commits continue
                nodes = stacks[1:]
                assert wait(lambda: all(m.n_active == 7 for _cv, m in nodes)), [m.n_active for _cv, m in nodes]
                now = _mesh_reading()
                assert now["faults"] > base["faults"] and now["shrinks"] >= base["shrinks"] + len(nodes)
                assert now["trips"] == base["trips"]  # the re-mesh is below the breaker
                net.check_invariants()  # no fork while degraded

                fail.clear_device_faults()  # the card comes back
                net.wait_progress(delta=2, timeout=60)
                assert wait(lambda: all(m.n_active == 8 for _cv, m in nodes)), [m.n_active for _cv, m in nodes]
                assert _mesh_reading()["restores"] >= now["restores"] + len(nodes)
                net.check_invariants()
            assert J_fail._device_faults in (None, {})  # the JAX fault state stayed unarmed
        finally:
            for cv, _m in stacks:
                cv.close()
