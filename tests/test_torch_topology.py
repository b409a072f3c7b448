"""The port's WAN topology (`tendermint_tpu_torch/testing/topology.py`)
and the link layer it shapes (`p2p/transport.py`'s delivery wheel,
jitter and token bucket) on the CPU, against the JAX package's.

The JAX package's `tests/test_topology.py` runs again on the port:
the golden no-op contract of all-zero knobs, the wheel's O(1) threads,
order and reordering, mid-flight partitions, the token bucket and the
topology's matrix, overrides, scale, regional cuts and dict form.

Across the packages, with inputs made from a seed: random placements,
overrides, scales, jitter fractions, bandwidths and losses give equal
delay matrices (`profile(i, j)` of every directed pair), equal
`LinkChaos` knobs after `shape()`, equal `to_dict()` and `from_dict()`
round trips, equal regional cuts and equal `uniform_topology` /
`slow_validator_topology` profiles. Tolerance: exact.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from tendermint_tpu.p2p.transport import LinkChaos as JLinkChaos
from tendermint_tpu.testing import topology as J
from tendermint_tpu_torch.p2p.transport import (
    _WHEEL,
    ChaosEndpoint,
    FuzzConfig,
    FuzzedEndpoint,
    LinkChaos,
    _TokenBucket,
    pipe_pair,
)
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture
from tendermint_tpu_torch.testing import topology as T
from tendermint_tpu_torch.testing.topology import (
    DEFAULT_RTT_MS,
    LinkProfile,
    WanTopology,
    slow_validator_topology,
    uniform_topology,
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
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(120))


def _drain(ep, n: int, timeout: float = 5.0) -> list[bytes]:
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        try:
            out.append(ep.recv(timeout=0.2))
        except Exception:
            pass
    return out


class TestGoldenNoop:
    """All-zero chaos/fuzz knobs must be byte-for-byte pass-through:
    no RNG draws, no wheel rides, in-order synchronous delivery."""

    def test_zero_linkchaos_is_passthrough(self):
        a, b = pipe_pair()
        chaos = LinkChaos(seed=3)
        ep = ChaosEndpoint(a, chaos)
        state_before = chaos._rng.getstate()
        pending_before = _WHEEL.pending()
        msgs = [b"m%d" % i for i in range(50)]
        for m in msgs:
            assert ep.send(m)
        assert _drain(b, 50) == msgs  # synchronous, in order
        assert chaos._rng.getstate() == state_before  # zero RNG draws
        assert _WHEEL.pending() == pending_before  # nothing scheduled

    def test_zero_fuzzconfig_draw_sequence_unchanged(self):
        """The grown FuzzConfig fields (jitter_s, bandwidth_bps) must
        not consume RNG draws when zero: a seeded fuzzed link's
        drop/dup pattern is exactly what the pre-WAN draw order
        produces (mirrored here draw-for-draw)."""
        cfg = FuzzConfig(prob_drop_rw=0.3, prob_dup=0.3, seed=42)
        a, b = pipe_pair()
        ep = FuzzedEndpoint(a, cfg)
        msgs = [b"g%d" % i for i in range(40)]
        for m in msgs:
            ep.send(m)
        got = _drain(b, 80, timeout=1.0)

        rng = random.Random(42)  # the documented draw order, replayed
        expect: list[bytes] = []
        for m in msgs:
            if rng.random() < 0.3:  # prob_drop_rw
                continue
            if rng.random() < 0.3:  # prob_dup
                expect.append(m)
            expect.append(m)
        assert got == expect


class TestDeliveryWheel:
    def test_delay_holds_thread_count_flat(self):
        """Soak: hundreds of in-flight delayed sends, O(1) threads."""
        a, b = pipe_pair()
        chaos = LinkChaos(seed=1)
        chaos.delay_s = 0.25
        ep = ChaosEndpoint(a, chaos)
        base = threading.active_count()
        for i in range(400):
            ep.send(b"soak%d" % i)
        in_flight = _WHEEL.pending()
        assert in_flight >= 300, f"expected a deep wheel, got {in_flight}"
        # one wheel thread, plus scheduler noise headroom — NOT O(400)
        assert threading.active_count() <= base + 2, (
            f"thread count grew from {base} to {threading.active_count()} "
            f"with {in_flight} delayed sends in flight"
        )
        got = _drain(b, 400, timeout=5.0)
        assert len(got) == 400
        assert threading.active_count() <= base + 2

    def test_fixed_delay_preserves_order(self):
        a, b = pipe_pair()
        chaos = LinkChaos(seed=1)
        chaos.delay_s = 0.03
        ep = ChaosEndpoint(a, chaos)
        msgs = [b"o%d" % i for i in range(30)]
        t0 = time.monotonic()
        for m in msgs:
            ep.send(m)
        got = _drain(b, 30)
        assert got == msgs  # fixed latency == FIFO pipe
        assert time.monotonic() - t0 >= 0.03  # the delay actually happened

    def test_jitter_reorders(self):
        a, b = pipe_pair()
        chaos = LinkChaos(seed=7)
        chaos.delay_s = 0.01
        chaos.jitter_s = 0.08
        ep = ChaosEndpoint(a, chaos)
        msgs = [b"j%02d" % i for i in range(40)]
        for m in msgs:
            ep.send(m)
        got = _drain(b, 40)
        assert sorted(got) == msgs  # nothing lost
        assert got != msgs  # ...but the path reordered

    def test_partition_started_mid_flight_drops_delivery(self):
        a, b = pipe_pair()
        chaos = LinkChaos(seed=1)
        chaos.delay_s = 0.15
        ep = ChaosEndpoint(a, chaos)
        ep.send(b"doomed")
        chaos.partitioned = True  # partition lands while in flight
        assert _drain(b, 1, timeout=0.5) == []

    def test_closed_endpoint_does_not_kill_wheel(self):
        a, b = pipe_pair()
        chaos = LinkChaos(seed=1)
        chaos.delay_s = 0.05
        ep = ChaosEndpoint(a, chaos)
        ep.send(b"into-the-void")
        a.close()
        b.close()
        time.sleep(0.15)  # delivery fires into the closed endpoint
        # wheel must still deliver for OTHER links afterwards
        c, d = pipe_pair()
        chaos2 = LinkChaos(seed=2)
        chaos2.delay_s = 0.02
        ep2 = ChaosEndpoint(c, chaos2)
        ep2.send(b"alive")
        assert _drain(d, 1) == [b"alive"]


class TestTokenBucket:
    def test_serialization_times(self):
        bucket = _TokenBucket()
        # 8000 bps = 1000 bytes/s; no burst: each 100B costs 0.1s
        assert bucket.wait(100, now=50.0, bps=8000.0, burst_bytes=0) == pytest.approx(0.1)
        assert bucket.wait(100, now=50.0, bps=8000.0, burst_bytes=0) == pytest.approx(0.2)
        # idle time refunds the queue
        assert bucket.wait(100, now=60.0, bps=8000.0, burst_bytes=0) == pytest.approx(0.1)

    def test_burst_credit_absorbs_spikes(self):
        bucket = _TokenBucket()
        # 1000 bytes/s with a 1000-byte burst: the first 1000B are free
        waits = [
            bucket.wait(100, now=10.0, bps=8000.0, burst_bytes=1000)
            for _ in range(10)
        ]
        assert all(w == 0.0 for w in waits)
        assert bucket.wait(100, now=10.0, bps=8000.0, burst_bytes=1000) > 0.0

    def test_zero_bps_uncapped(self):
        bucket = _TokenBucket()
        assert bucket.wait(10**9, now=1.0, bps=0.0, burst_bytes=0) == 0.0

    def test_chaos_bandwidth_cap_delays_delivery(self):
        a, b = pipe_pair()
        chaos = LinkChaos(seed=1)
        chaos.bandwidth_bps = 80_000.0  # 10 KB/s
        chaos.bandwidth_burst_bytes = 0
        ep = ChaosEndpoint(a, chaos)
        t0 = time.monotonic()
        for i in range(5):
            ep.send(b"x" * 1000)  # 5 KB over a 10 KB/s pipe ≈ 0.5s
        got = _drain(b, 5)
        assert len(got) == 5
        assert time.monotonic() - t0 >= 0.35  # serialized, sender unblocked


class TestWanTopology:
    def test_default_matrix_symmetric_and_complete(self):
        regions = ("us-east", "us-west", "eu-west", "ap-northeast", "sa-east")
        for a in regions:
            for b in regions:
                assert DEFAULT_RTT_MS[(a, b)] == DEFAULT_RTT_MS[(b, a)]
                if a != b:
                    assert DEFAULT_RTT_MS[(a, b)] > 10.0

    def test_shape_writes_linkchaos_knobs(self):
        topo = WanTopology(placement=["us-east", "eu-west"], bandwidth_mbps=10.0)
        chaos = LinkChaos(seed=1)
        topo.shape(chaos, 0, 1)
        rtt = DEFAULT_RTT_MS[("us-east", "eu-west")]
        assert chaos.delay_s == pytest.approx(rtt / 2 / 1000)
        assert chaos.jitter_s == pytest.approx(rtt * 0.10 / 1000)
        assert chaos.bandwidth_bps == pytest.approx(10e6)

    def test_intra_region_stays_fast_and_uncapped(self):
        topo = WanTopology(
            placement=["us-east", "us-east"], bandwidth_mbps=10.0, loss=0.05
        )
        p = topo.profile(0, 1)
        assert p.rtt_ms <= 2.0
        assert p.bandwidth_mbps == 0.0
        assert p.loss == 0.0

    def test_asymmetric_override(self):
        topo = uniform_topology(rtt_ms=20.0)
        topo.overrides[(0, 1)] = LinkProfile(rtt_ms=300.0)
        assert topo.profile(0, 1).rtt_ms == 300.0
        assert topo.profile(1, 0).rtt_ms == 20.0  # reverse untouched

    def test_scale_multiplies_delays(self):
        topo = uniform_topology(rtt_ms=100.0, scale=0.1)
        chaos = LinkChaos(seed=1)
        topo.shape(chaos, 0, 1)
        assert chaos.delay_s == pytest.approx(0.005)

    def test_partition_groups_cut_one_region(self):
        topo = WanTopology(placement=["us-east", "us-east", "eu-west", "ap-northeast"])
        groups = topo.partition_groups(4, "us-east")
        assert groups == [{0, 1}, {2, 3}]
        with pytest.raises(ValueError):
            topo.partition_groups(4, "sa-east")

    def test_placement_wraps_round_robin(self):
        topo = WanTopology(placement=["us-east", "eu-west"])
        assert topo.region_of(0) == topo.region_of(2) == "us-east"
        assert topo.region_of(1) == topo.region_of(3) == "eu-west"

    def test_dict_round_trip(self):
        topo = slow_validator_topology(
            slow=2, base_rtt_ms=30.0, slow_rtt_ms=250.0, n_nodes=4, scale=0.2
        )
        clone = WanTopology.from_dict(topo.to_dict())
        for i in range(4):
            for j in range(4):
                if i != j:
                    assert clone.profile(i, j) == topo.profile(i, j)
        assert clone.scale == topo.scale


# -- across the packages ---------------------------------------------------------------

KNOBS = ("delay_s", "jitter_s", "bandwidth_bps", "drop_prob")


def _random_spec(rng: random.Random) -> dict:
    """A topology's dict form made from `rng`: regions of the default
    matrix and two of its own, overrides on random directed pairs."""
    regions = list(T.REGIONS) + ["r-x", "r-y"]
    n = rng.randrange(1, 9)
    spec = {
        "name": f"rand-{rng.randrange(1000)}",
        "placement": [rng.choice(regions) for _ in range(rng.randrange(1, 6))],
        "jitter_frac": rng.choice([0.0, 0.05, 0.1, 0.25]),
        "bandwidth_mbps": rng.choice([0.0, 1.5, 10.0, 100.0]),
        "loss": rng.choice([0.0, 0.01, 0.2]),
        "scale": rng.choice([0.05, 0.1, 0.2, 1.0, 2.5]),
        "overrides": {
            f"{rng.randrange(n)}|{rng.randrange(n)}": {
                "rtt_ms": rng.uniform(0, 400), "jitter_ms": rng.uniform(0, 40),
                "bandwidth_mbps": rng.choice([0.0, 5.0]), "loss": rng.choice([0.0, 0.1]),
            }
            for _ in range(rng.randrange(4))
        },
    }
    if rng.random() < 0.5:
        spec["rtt_ms"] = {"r-x|r-y": rng.uniform(1, 300), "r-x|r-x": 1.0, "r-y|us-east": rng.uniform(1, 300)}
    return spec, n


def _matrix(topo, n: int) -> list:
    return [[topo.profile(i, j).__dict__ for j in range(n)] for i in range(n)]


def _knobs(topo, chaos_cls, n: int) -> list:
    out = []
    for i in range(n):
        for j in range(n):
            c = chaos_cls(seed=i)
            topo.shape(c, i, j)
            out.append(tuple(getattr(c, k) for k in KNOBS))
    return out


def test_default_matrix_and_regions_equal_the_jax_package():
    assert T.REGIONS == J.REGIONS
    assert T.DEFAULT_RTT_MS == J.DEFAULT_RTT_MS
    assert WanTopology().to_dict() == J.WanTopology().to_dict()


@pytest.mark.parametrize("seed", range(12))
def test_seeded_topologies_shape_links_as_the_jax_package(seed):
    """A seeded random topology through both packages' `from_dict`: the
    delay matrix, the knobs `shape()` writes, the dict form, its round
    trip and the regional cuts are equal."""
    spec, n = _random_spec(random.Random(seed))
    ours, theirs = WanTopology.from_dict(spec), J.WanTopology.from_dict(spec)
    assert _matrix(ours, n) == _matrix(theirs, n)
    assert _knobs(ours, LinkChaos, n) == _knobs(theirs, JLinkChaos, n)
    assert ours.to_dict() == theirs.to_dict()
    assert WanTopology.from_dict(ours.to_dict()).to_dict() == J.WanTopology.from_dict(theirs.to_dict()).to_dict()
    assert ours.region_groups(n) == theirs.region_groups(n)
    for region in set(spec["placement"]) | {"nowhere"}:
        try:
            want = theirs.partition_groups(n, region)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                ours.partition_groups(n, region)
            assert str(got.value) == str(e)
        else:
            assert ours.partition_groups(n, region) == want


@pytest.mark.parametrize("seed", range(6))
def test_seeded_uniform_and_slow_validator_topologies_equal_the_jax_package(seed):
    rng = random.Random(100 + seed)
    rtt, frac, scale = rng.uniform(1, 200), rng.choice([0.0, 0.1, 0.3]), rng.choice([0.1, 0.2, 1.0])
    assert uniform_topology(rtt, frac, scale).to_dict() == J.uniform_topology(rtt, frac, scale).to_dict()
    n = rng.randrange(2, 8)
    slow, base, far = rng.randrange(n), rng.uniform(5, 50), rng.uniform(100, 400)
    ours = slow_validator_topology(slow, base, far, n, jitter_frac=frac, scale=scale)
    theirs = J.slow_validator_topology(slow, base, far, n, jitter_frac=frac, scale=scale)
    assert _matrix(ours, n) == _matrix(theirs, n)
    assert _knobs(ours, LinkChaos, n) == _knobs(theirs, JLinkChaos, n)
    assert ours.to_dict() == theirs.to_dict()
