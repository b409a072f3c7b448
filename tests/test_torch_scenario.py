"""The port's scenario engine (`tendermint_tpu_torch/testing/scenario.py`)
and its load generator (`testing/loadgen.py`) on the CPU.

The JAX package's `tests/test_scenario.py` runs again on the port, each
case with its JAX marker: the schema, the deterministic churn rotation
and the library's two tier-1 scenarios end to end (`churn_small`,
`slow_wan_validator`) through the port's `ScenarioRunner` on
`device="cpu"`; the heavy entries are `slow`, as in the JAX file.

Across the packages: `validate_scenario`'s verdicts on every library
spec, each spec byte-equal to the JAX one, and on malformed specs made
from a seed (the same normalized spec, or the same exception class and
message); `ChurnApp` EndBlock diffs; `TxFactory` payload streams for
seeded arguments (plain and signed). The port's declared differences:
`ScenarioRunner(device=)` and `run_library(device=)`, and the load
feeder's `TxFactory` taken from `testing/loadgen.py`. Tolerance: exact.
"""

from __future__ import annotations

import copy
import json
import random

import pytest

from tendermint_tpu_torch.testing import lockrank_report, own_default_stacks, time_limit_fixture
from tendermint_tpu_torch.testing.scenario import (
    SCENARIO_LIBRARY,
    ChurnApp,
    ScenarioRunner,
    churn_app_factory,
    run_library,
    validate_scenario,
)


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


class TestSchema:
    def test_defaults_fill_in(self):
        spec = validate_scenario({"name": "x"})
        assert spec["nodes"] == 4
        assert spec["kind"] == "core"
        assert spec["run"]["target_height"] == 20

    def test_unknown_key_rejected(self):
        with pytest.raises(ValueError, match="unknown scenario keys"):
            validate_scenario({"name": "x", "topologee": {}})

    def test_unknown_action_rejected(self):
        with pytest.raises(ValueError, match="unknown timeline action"):
            validate_scenario(
                {"name": "x", "timeline": [{"at_height": 1, "action": "explode"}]}
            )

    def test_timeline_event_needs_a_trigger(self):
        with pytest.raises(ValueError, match="at_height or at_s"):
            validate_scenario({"name": "x", "timeline": [{"action": "heal"}]})

    def test_churn_requires_active_window(self):
        with pytest.raises(ValueError, match="n_active"):
            validate_scenario({"name": "x", "churn": {"every": 4, "shift": 1}})

    def test_load_requires_full_nodes(self):
        with pytest.raises(ValueError, match="kind=full"):
            validate_scenario({"name": "x", "load": {"rate": 10}})

    def test_library_specs_all_validate(self):
        for name, spec in SCENARIO_LIBRARY.items():
            validated = validate_scenario(spec)
            assert validated["name"] == name


class TestChurnApp:
    def _pool(self, n=6):
        return [bytes([i]) * 32 for i in range(n)]

    def test_no_rotation_off_boundary(self):
        app = ChurnApp(self._pool(), active=4, every=4, shift=1)
        for h in (1, 2, 3, 5, 7, 9):
            assert app.end_block(h) == []

    def test_rotation_diff_is_25_percent(self):
        pool = self._pool()
        app = ChurnApp(pool, active=4, every=4, shift=1)
        changes = app.end_block(4)  # epoch 0 {0,1,2,3} -> epoch 1 {1,2,3,4}
        assert [(c.pub_key, c.power) for c in changes] == [
            (pool[0], 0),  # removed
            (pool[4], 10),  # admitted
        ]

    def test_window_wraps_the_pool(self):
        pool = self._pool()
        app = ChurnApp(pool, active=4, every=4, shift=1)
        changes = app.end_block(12)  # epoch 3 {3,4,5,0}: wraps to index 0
        assert (pool[0], 10) in [(c.pub_key, c.power) for c in changes]

    def test_two_apps_agree(self):
        """Rotation is a pure function of height — the determinism
        consensus needs from every replica's EndBlock."""
        a = ChurnApp(self._pool(), active=4, every=3, shift=2)
        b = ChurnApp(self._pool(), active=4, every=3, shift=2)
        for h in range(1, 20):
            assert [(c.pub_key, c.power) for c in a.end_block(h)] == [
                (c.pub_key, c.power) for c in b.end_block(h)
            ]

    def test_factory_pool_matches_genesis(self):
        from tendermint_tpu_torch.testing.nemesis import make_genesis

        factory = churn_app_factory(6, "c", active=4, every=4, shift=1)
        app = factory()
        _, privs = make_genesis(6, chain_id="c", n_active=4)
        changes = app.end_block(4)
        admitted = {c.pub_key for c in changes if c.power > 0}
        assert admitted == {privs[4].pub_key.data}


class TestEndToEnd:
    def test_churn_small_end_to_end(self, tmp_path):
        """≥25% window rotation every 4 heights, ≥3 full epochs:
        speculation rebuilds fire at every boundary, the light client
        bisects genesis→tip across all rotations, no fork."""
        report = ScenarioRunner(home=str(tmp_path), device="cpu").run(
            SCENARIO_LIBRARY["churn_small"]
        )
        assert report["ok"], report["failures"]
        assert report["epochs"] >= 3
        assert report["valset_rebuilds"] >= 3  # the speculation seam exercised
        assert report["bisection"]["verified_to"] >= 16  # the bisection seam exercised
        assert min(report["heights"]) >= 16

    def test_slow_wan_validator_end_to_end(self, tmp_path):
        """Adaptive timeouts learn the slow path: derived propose
        timeout converges above the injected one-way delay and round
        skips stop once warmed."""
        report = ScenarioRunner(home=str(tmp_path), device="cpu").run(
            SCENARIO_LIBRARY["slow_wan_validator"]
        )
        assert report["ok"], report["failures"]
        assert (
            report["propose_timeout_s"]["min"] > report["max_one_way_delay_s"]
        )
        assert report["round_skips_post_warm"] == 0


@pytest.mark.slow
class TestLibraryHeavy:
    @pytest.mark.parametrize(
        "name",
        ["regional_outage", "churn_storm", "partition_during_churn", "flash_crowd"],
    )
    def test_library_scenario(self, name, tmp_path):
        report = ScenarioRunner(home=str(tmp_path), device="cpu").run(SCENARIO_LIBRARY[name])
        assert report["ok"], (name, report["failures"])

    def test_run_library_filters(self, tmp_path):
        reports = run_library(names=["churn_small"], home=str(tmp_path), device="cpu")
        assert [r["scenario"] for r in reports] == ["churn_small"]


# -- across the packages ---------------------------------------------------------------


def _verdict(validate, spec):
    try:
        return ("ok", json.dumps(validate(copy.deepcopy(spec)), sort_keys=True))
    except Exception as e:  # the class and message are the verdict
        return (type(e).__name__, str(e))


def test_the_library_equals_the_jax_library():
    from tendermint_tpu.testing import scenario as J

    assert json.dumps(SCENARIO_LIBRARY, sort_keys=True) == json.dumps(J.SCENARIO_LIBRARY, sort_keys=True)
    assert list(SCENARIO_LIBRARY) == list(J.SCENARIO_LIBRARY)
    for spec in SCENARIO_LIBRARY.values():
        assert _verdict(validate_scenario, spec) == _verdict(J.validate_scenario, spec)


def _malformed(rng: random.Random, base: dict) -> dict:
    """One seeded edit of a library spec: a bad or missing key, a bad
    kind, churn, load, timeline event or node count."""
    spec = copy.deepcopy(base)
    edit = rng.randrange(11)
    if edit == 0:
        spec[rng.choice(["topologee", "nodez", "extra"])] = {}
    elif edit == 1:
        spec.pop("name", None)
    elif edit == 2:
        spec["kind"] = rng.choice(["edge", "", "FULL"])
    elif edit == 3:
        spec["nodes"] = rng.choice([0, -1, "3"])
    elif edit == 4:
        spec["churn"] = {"every": rng.choice([0, 4]), "shift": rng.choice([0, 1])}
        if rng.random() < 0.5:
            spec.pop("n_active", None)
    elif edit == 5:
        spec["load"] = {"rate": 10}
        spec["kind"] = rng.choice(["core", "full"])
    elif edit == 6:
        spec["timeline"] = [{"action": rng.choice(["explode", "heal", None]), "at_height": 3}]
    elif edit == 7:
        spec["timeline"] = [{"action": "crash", "node": 1}]
    elif edit == 8:
        spec["topology"] = {"placement": ["us-east"], "overrides": {"0|1": {"rtt_ms": "fast"}}}
    elif edit == 9:
        spec = rng.choice([[], "spec", None, 7])
    else:
        spec["run"] = {}
        spec["expect"] = {"warm_height": rng.randrange(30)}
    return spec


@pytest.mark.parametrize("seed", range(8))
def test_validate_scenario_verdicts_equal_the_jax_package(seed):
    """Seeded malformed (and some well-formed) specs: the same normalized
    spec, or the same exception class and message."""
    from tendermint_tpu.testing import scenario as J

    rng = random.Random(seed)
    names = sorted(SCENARIO_LIBRARY)
    kinds = set()
    for _ in range(40):
        spec = _malformed(rng, SCENARIO_LIBRARY[rng.choice(names)])
        ours, theirs = _verdict(validate_scenario, spec), _verdict(J.validate_scenario, spec)
        assert ours == theirs, spec
        kinds.add(ours[0])
    assert "ValueError" in kinds


@pytest.mark.parametrize("every,shift,active,pool", [(4, 1, 4, 6), (3, 2, 4, 8), (5, 3, 3, 7), (1, 1, 2, 3)])
def test_churn_app_rotations_equal_the_jax_package(every, shift, active, pool):
    from tendermint_tpu.testing import scenario as J

    keys = [bytes([i + 1]) * 32 for i in range(pool)]
    ours, theirs = ChurnApp(keys, active, every, shift), J.ChurnApp(keys, active, every, shift)
    for h in range(1, 40):
        assert [(c.pub_key, c.power) for c in ours.end_block(h)] == [
            (c.pub_key, c.power) for c in theirs.end_block(h)]
    mine = churn_app_factory(pool, "churn", active=active, every=every, shift=shift)()
    jax = J.churn_app_factory(pool, "churn", active=active, every=every, shift=shift)()
    for h in range(1, 40):
        assert [(c.pub_key, c.power) for c in mine.end_block(h)] == [(c.pub_key, c.power) for c in jax.end_block(h)]


@pytest.mark.parametrize("kwargs", [
    dict(payload=64, hot_keys=8, hot_prob=0.2, dup_prob=0.0, signed=False, signers=0),
    dict(payload=8, hot_keys=0, hot_prob=0.0, dup_prob=0.3, signed=False, signers=0, seed=3),
    dict(payload=250, hot_keys=32, hot_prob=0.5, dup_prob=0.1, signed=False, signers=0, seed=99),
    dict(payload=40, hot_keys=4, hot_prob=0.3, dup_prob=0.2, signed=True, signers=3, seed=5),
])
def test_tx_factory_streams_equal_the_tools_tx_factory(kwargs):
    """The port's `TxFactory` and the repo's `tools/loadgen.py` one, for
    equal arguments and seed: the same payload stream, signed payloads
    included (ed25519 is deterministic)."""
    from tendermint_tpu_torch.testing.loadgen import TxFactory
    from tools.loadgen import TxFactory as JTxFactory

    n = 60 if kwargs["signed"] else 600
    ours, theirs = TxFactory(**kwargs), JTxFactory(**kwargs)
    assert [ours.make(i) for i in range(n)] == [theirs.make(i) for i in range(n)]


def test_the_load_feeder_runs_the_ports_tx_factory():
    """`_LoadFeeder` builds the port's `TxFactory` with the JAX feeder's
    arguments: its first payloads are the tool's for those arguments."""
    import types

    from tendermint_tpu_torch.testing.scenario import _LoadFeeder
    from tools.loadgen import TxFactory as JTxFactory

    feeder = _LoadFeeder(types.SimpleNamespace(), rate=0.0, payload=48)
    assert type(feeder._factory).__module__ == "tendermint_tpu_torch.testing.loadgen"
    want = JTxFactory(payload=48, hot_keys=8, hot_prob=0.2, dup_prob=0.0, signed=False, signers=0)
    assert [feeder._factory.make(i) for i in range(50)] == [want.make(i) for i in range(50)]


def test_the_runner_and_the_library_take_a_device(tmp_path, monkeypatch):
    """`ScenarioRunner(device=)` hands its device to the net it builds,
    whose nodes each verify on a cache of their own over the device's
    default stack; `run_library(device=)` hands it to each runner."""
    from tendermint_tpu_torch.services.verifier import default_verifier
    from tendermint_tpu_torch.testing import scenario

    spec = validate_scenario(SCENARIO_LIBRARY["slow_wan_validator"])
    net = ScenarioRunner(home=str(tmp_path), device="cpu")._build_net(spec)
    assert all(n.device == "cpu" and n.verifier.inner is default_verifier("cpu").inner for n in net.nodes)
    assert len({id(n.verifier.cache) for n in net.nodes}) == len(net.nodes)
    seen = []
    monkeypatch.setattr(scenario.ScenarioRunner, "run", lambda self, spec: seen.append(self.device) or {})
    run_library(names=["churn_small", "slow_wan_validator"], device="cpu")
    assert seen == ["cpu", "cpu"]
