"""WAN topology model for the chaos harness.

Maps every in-process node to a REGION and shapes each directed link
(`LinkChaos` in `p2p/transport.py`) from an inter-region RTT /
bandwidth / jitter matrix, so a Nemesis net stops looking like
loopback and starts looking like production geography: 60–250 ms
round trips, asymmetric routes, jitter-induced reordering, finite
egress, and partitions that cut along regional seams instead of
arbitrary node sets.

The shape of `DEFAULT_RTT_MS` follows public inter-region latency
figures (order of magnitude, not a benchmark): coast-to-coast US
~60 ms, transatlantic ~80 ms, US→Asia ~130–220 ms, South America the
far corner. One-way delay is RTT/2; jitter defaults to 10% of RTT —
enough to reorder, not enough to look like loss.

`scale` multiplies every delay/jitter uniformly. Scenarios that must
stay cheap enough for tier-1 run the SAME matrix at scale 0.1–0.2
(the relative geometry — who is far from whom — is what the consensus
layer reacts to; the absolute numbers only change how long the test
takes and which timeout regime applies).

Apply with `Nemesis.set_topology(topo)` — the harness stores the
topology so links recreated by `restart()` re-inherit the shaping,
exactly like live partition flags.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.p2p.transport import LinkChaos

# Regions in canonical order; the matrix is indexed by this order.
REGIONS = ("us-east", "us-west", "eu-west", "ap-northeast", "sa-east")

# Inter-region round-trip times, milliseconds. Symmetric base figures;
# real asymmetry (routing detours) is expressed per-topology via
# `overrides`.
DEFAULT_RTT_MS: dict[tuple[str, str], float] = {}


def _seed_default_matrix() -> None:
    rows = {
        "us-east": {"us-east": 1, "us-west": 62, "eu-west": 78,
                    "ap-northeast": 168, "sa-east": 118},
        "us-west": {"us-west": 1, "eu-west": 132, "ap-northeast": 108,
                    "sa-east": 176},
        "eu-west": {"eu-west": 1, "ap-northeast": 222, "sa-east": 186},
        "ap-northeast": {"ap-northeast": 1, "sa-east": 256},
        "sa-east": {"sa-east": 1},
    }
    for a, row in rows.items():
        for b, rtt in row.items():
            DEFAULT_RTT_MS[(a, b)] = float(rtt)
            DEFAULT_RTT_MS[(b, a)] = float(rtt)


_seed_default_matrix()


@dataclass
class LinkProfile:
    """Directed link shape, physical units (the topology layer's
    vocabulary; `shape()` translates into LinkChaos knobs)."""

    rtt_ms: float = 0.0  # round trip; one-way delay = rtt/2
    jitter_ms: float = 0.0  # uniform [0, jitter) added per delivery
    bandwidth_mbps: float = 0.0  # 0 = uncapped
    loss: float = 0.0  # per-send drop probability


@dataclass
class WanTopology:
    """Node placement + inter-region matrix + per-link overrides.

    `placement[i]` is node i's region. Nodes beyond the placement list
    wrap around (round-robin), so one placement spec serves any fleet
    size. `overrides[(i, j)]` replaces the matrix-derived profile for
    the DIRECTED node pair i->j (asymmetric routes, one slow validator,
    a saturated egress)."""

    name: str = "wan"
    placement: list[str] = field(default_factory=lambda: list(REGIONS))
    rtt_ms: dict[tuple[str, str], float] = field(
        default_factory=lambda: dict(DEFAULT_RTT_MS)
    )
    jitter_frac: float = 0.10  # jitter = frac * RTT unless overridden
    bandwidth_mbps: float = 0.0  # uniform cap on every inter-region link
    loss: float = 0.0  # uniform inter-region loss
    scale: float = 1.0  # multiplies every delay/jitter (tier-1 affordability)
    overrides: dict[tuple[int, int], LinkProfile] = field(default_factory=dict)

    def region_of(self, i: int) -> str:
        return self.placement[i % len(self.placement)]

    def profile(self, i: int, j: int) -> LinkProfile:
        """Directed profile for node i -> node j."""
        ov = self.overrides.get((i, j))
        if ov is not None:
            return ov
        a, b = self.region_of(i), self.region_of(j)
        rtt = self.rtt_ms.get((a, b), 0.0)
        intra = a == b
        return LinkProfile(
            rtt_ms=rtt,
            jitter_ms=rtt * self.jitter_frac,
            bandwidth_mbps=0.0 if intra else self.bandwidth_mbps,
            loss=0.0 if intra else self.loss,
        )

    def shape(self, chaos: LinkChaos, i: int, j: int) -> None:
        """Write the i->j profile into a live LinkChaos (the hook
        `Nemesis.set_topology` / `_chaos_pair` calls). Partition flags
        are deliberately untouched — they belong to the fault timeline,
        not the geography."""
        p = self.profile(i, j)
        chaos.delay_s = (p.rtt_ms / 2.0 / 1000.0) * self.scale
        chaos.jitter_s = (p.jitter_ms / 1000.0) * self.scale
        chaos.bandwidth_bps = p.bandwidth_mbps * 1e6
        chaos.drop_prob = p.loss

    def region_groups(self, n_nodes: int) -> dict[str, set[int]]:
        """Node indices by region — the unit regional faults cut along."""
        groups: dict[str, set[int]] = {}
        for i in range(n_nodes):
            groups.setdefault(self.region_of(i), set()).add(i)
        return groups

    def partition_groups(self, n_nodes: int, cut: str) -> list[set[int]]:
        """Groups for `Nemesis.partition(*groups)` that isolate region
        `cut` from everyone else (a regional outage: the region keeps
        its intra-region links, loses the world)."""
        groups = self.region_groups(n_nodes)
        if cut not in groups:
            raise ValueError(f"region {cut!r} has no nodes (have {sorted(groups)})")
        inside = groups.pop(cut)
        outside = set().union(*groups.values()) if groups else set()
        return [inside, outside]

    # -- declarative form ---------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "placement": list(self.placement),
            "jitter_frac": self.jitter_frac,
            "bandwidth_mbps": self.bandwidth_mbps,
            "loss": self.loss,
            "scale": self.scale,
            "rtt_ms": {f"{a}|{b}": v for (a, b), v in sorted(self.rtt_ms.items())},
            "overrides": {
                f"{i}|{j}": {
                    "rtt_ms": p.rtt_ms,
                    "jitter_ms": p.jitter_ms,
                    "bandwidth_mbps": p.bandwidth_mbps,
                    "loss": p.loss,
                }
                for (i, j), p in sorted(self.overrides.items())
            },
        }

    @classmethod
    def from_dict(cls, spec: dict) -> "WanTopology":
        """Inverse of `to_dict` (the scenario schema's `topology`
        section — docs/SCENARIOS.md). Omitted fields keep defaults, so
        `{"placement": ["us-east", "eu-west"], "scale": 0.1}` is a
        complete topology."""
        topo = cls(
            name=spec.get("name", "wan"),
            placement=list(spec.get("placement", REGIONS)),
            jitter_frac=float(spec.get("jitter_frac", 0.10)),
            bandwidth_mbps=float(spec.get("bandwidth_mbps", 0.0)),
            loss=float(spec.get("loss", 0.0)),
            scale=float(spec.get("scale", 1.0)),
        )
        if "rtt_ms" in spec:
            topo.rtt_ms = {}
            for key, v in spec["rtt_ms"].items():
                a, b = key.split("|")
                topo.rtt_ms[(a, b)] = float(v)
                topo.rtt_ms.setdefault((b, a), float(v))
        for key, p in spec.get("overrides", {}).items():
            i, j = key.split("|")
            topo.overrides[(int(i), int(j))] = LinkProfile(
                rtt_ms=float(p.get("rtt_ms", 0.0)),
                jitter_ms=float(p.get("jitter_ms", 0.0)),
                bandwidth_mbps=float(p.get("bandwidth_mbps", 0.0)),
                loss=float(p.get("loss", 0.0)),
            )
        return topo


def uniform_topology(
    rtt_ms: float, jitter_frac: float = 0.10, scale: float = 1.0,
    name: str = "uniform",
) -> WanTopology:
    """Every node in its own synthetic region, every link the same RTT
    — the controlled-variable topology for timeout calibration."""
    return WanTopology(
        name=name,
        placement=["r0"],
        rtt_ms={("r0", "r0"): rtt_ms},
        jitter_frac=jitter_frac,
        scale=scale,
    )


def slow_validator_topology(
    slow: int,
    base_rtt_ms: float,
    slow_rtt_ms: float,
    n_nodes: int,
    jitter_frac: float = 0.10,
    scale: float = 1.0,
) -> WanTopology:
    """Uniform fabric with ONE far-away validator: every link touching
    node `slow` runs at `slow_rtt_ms` (both directions). The canonical
    adaptive-timeout probe — when `slow` proposes, the proposal crosses
    the slow path and the propose timeout must have learned to wait."""
    topo = uniform_topology(
        base_rtt_ms, jitter_frac=jitter_frac, scale=scale,
        name=f"slow-validator-{slow}",
    )
    p = LinkProfile(rtt_ms=slow_rtt_ms, jitter_ms=slow_rtt_ms * jitter_frac)
    for other in range(n_nodes):
        if other != slow:
            topo.overrides[(slow, other)] = p
            topo.overrides[(other, slow)] = p
    return topo
