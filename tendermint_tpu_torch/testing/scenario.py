"""Declarative chaos scenarios over the Nemesis harness.

A scenario is DATA (a JSON-able dict, schema in docs/SCENARIOS.md):
WAN topology, node fleet + roles, an optional validator-churn policy,
an optional load profile, a fault timeline keyed by committed height
or wall time, and the expectations the run must meet. `ScenarioRunner`
executes one: builds the Nemesis fleet, shapes every link from the
topology, plays the timeline while the net commits, then derives a
finality/SLO report FROM THE HEIGHT LEDGERS (the same per-height
records `tools/finality_report.py` reads — the report is what a
production SLO dashboard would show, not harness bookkeeping) and
grades it against the expectations.

Churn: `ChurnApp` rotates the validator window deterministically at
EndBlock every K heights over a standby pool (`make_genesis
n_active=`), which exercises the two hardest rotation seams end to
end — the pipelined finalize's speculated-round REBUILD when EndBlock
changes the set (`pipeline_stats["valset_rebuilds"]`) and the
light client's bisection BRIDGING across dense rotations
(`BisectingCertifier` over a `StoreProvider`). Both are graded
by expectations, not assumed.

`SCENARIO_LIBRARY` ships the standing suite: flash crowd, regional
outage, slow-WAN validator, churn storm, partition-during-churn, plus
tier-1-affordable variants (`slow_wan_validator`, `churn_small`).
Heavy entries carry `"slow": True` — tests mark them accordingly and
`tools/bench_hotpath.py --section scenario_finality` runs them with
committed floors.
"""

from __future__ import annotations

import logging
import threading
import time

from tendermint_tpu_torch.testing.nemesis import (
    InvariantViolation,
    Nemesis,
    make_genesis,
)
from tendermint_tpu_torch.testing.topology import WanTopology
from tendermint_tpu_torch.utils.log import kv, logger

_log = logger("scenario")


def _round_skips_total() -> float:
    """Sum of the round-skip counter across its phase labels (the
    per-phase split is diagnostic; thrash detection wants the total)."""
    from tendermint_tpu_torch.telemetry import REGISTRY

    m = REGISTRY.get("tendermint_consensus_round_skips_total")
    if m is None:
        return 0.0
    return sum(float(snap) for _values, snap in m.samples())


# ---------------------------------------------------------------------------
# churn app
# ---------------------------------------------------------------------------


class ChurnApp:
    """KVStore app that rotates the validator window at EndBlock.

    Pool of P candidate pubkeys (index-aligned with the harness privs
    from `make_genesis`), active window of A, shifted by `shift` every
    `every` heights: epoch e's window starts at `(e * shift) % P`.
    Rotation is a pure function of height, so every node's app emits
    the identical EndBlock diff — the determinism consensus requires —
    and removed validators keep running as observers until a later
    epoch re-admits them."""

    def __new__(cls, pool: list[bytes], active: int, every: int, shift: int,
                power: int = 10):
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.types import Validator

        class _App(KVStoreApp):
            def _window(self, epoch: int) -> list[int]:
                start = (epoch * shift) % len(pool)
                return [(start + t) % len(pool) for t in range(active)]

            def end_block(self, height: int) -> list[Validator]:
                super().end_block(height)
                if every <= 0 or height % every != 0:
                    return []
                epoch = height // every
                old = set(self._window(epoch - 1))
                new = set(self._window(epoch))
                changes = [Validator(pub_key=pool[i], power=0) for i in sorted(old - new)]
                changes += [Validator(pub_key=pool[i], power=power) for i in sorted(new - old)]
                return changes

        return _App()


def churn_app_factory(n_vals: int, chain_id: str, active: int, every: int,
                      shift: int):
    """An `app_factory` whose pool mirrors the deterministic
    `make_genesis(n_vals, chain_id, n_active=active)` key set, so the
    app-side rotation and the harness genesis agree by construction."""
    _, privs = make_genesis(n_vals, chain_id=chain_id, n_active=active)
    pool = [p.pub_key.data for p in privs]

    def factory():
        return ChurnApp(pool, active=active, every=every, shift=shift)

    return factory


# ---------------------------------------------------------------------------
# bisection bridging probe
# ---------------------------------------------------------------------------


class StoreProvider:
    """Light-client `Provider` over a node's block store + historical
    valset index (the lightclient reactor's `_serve_from_stores` shape,
    packaged for in-harness bisection probes). Read-only; the floor
    contract is `get_by_height(h) -> newest FullCommit <= h`."""

    def __init__(self, store, state) -> None:
        self._store = store
        self._state = state

    def _full_commit(self, height: int):
        from tendermint_tpu_torch.certifiers.certifier import FullCommit

        meta = self._store.load_block_meta(height)
        if meta is None:
            return None
        commit = self._store.load_block_commit(height)
        if commit is None:
            commit = self._store.load_seen_commit(height)
        if commit is None:
            return None
        try:
            validators = self._state.load_validators(height)
        except Exception:
            return None
        return FullCommit(header=meta.header, commit=commit, validators=validators)

    def get_by_height(self, height: int):
        for h in range(min(height, self._store.height), 0, -1):
            fc = self._full_commit(h)
            if fc is not None:
                return fc
        return None

    def latest_commit(self):
        return self.get_by_height(self._store.height)

    def store_commit(self, fc) -> None:  # read-only source
        pass


def bisect_bridge(node, chain_id: str, genesis_privs, tip: int | None = None, device=None) -> dict:
    """Walk a light client from the GENESIS valset to the node's tip
    over its own stores — the bridging probe a churn scenario
    must survive (every epoch boundary is a valset the skip rule has to
    ladder across). Returns the walk stats; raises on a failed walk."""
    from tendermint_tpu_torch.lightclient.bisect import BisectingCertifier
    from tendermint_tpu_torch.services.verifier import default_verifier
    from tendermint_tpu_torch.state.state import load_state
    from tendermint_tpu_torch.types import Validator, ValidatorSet

    state = load_state(node.state_db)
    genesis_vals = ValidatorSet(
        [
            Validator(address=p.address, pub_key=p.pub_key, voting_power=10)
            for p in genesis_privs
        ]
    )
    source = StoreProvider(node.store, state)
    cert = BisectingCertifier(
        chain_id, validators=genesis_vals, height=0, source=source,
        verifier=default_verifier(device),
    )
    target = tip if tip is not None else node.store.height
    cert.verify_to_height(target)
    return {
        "verified_to": target,
        "rounds": cert.last_walk_rounds,
        "verifies": cert.last_walk_verifies,
    }


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

_ACTIONS = {
    "partition", "partition_region", "heal", "crash", "restart",
    "delay", "load_rate",
}
_TOP_KEYS = {
    "name", "description", "nodes", "n_vals", "n_active", "kind",
    "topology", "churn", "config", "load", "timeline", "run", "expect",
    "slow",
}


def validate_scenario(spec: dict) -> dict:
    """Normalize + validate a declarative scenario; returns a copy with
    defaults filled in. Raises ValueError on anything the runner would
    silently misplay (unknown keys are errors, not ignored — a typo'd
    fault that never fires is a scenario that tests nothing)."""
    if not isinstance(spec, dict):
        raise ValueError("scenario must be a dict")
    unknown = set(spec) - _TOP_KEYS
    if unknown:
        raise ValueError(f"unknown scenario keys: {sorted(unknown)}")
    if not spec.get("name"):
        raise ValueError("scenario needs a name")
    out = dict(spec)
    out.setdefault("description", "")
    nodes = int(out.get("nodes", 4))
    if nodes < 1:
        raise ValueError("nodes must be >= 1")
    out["nodes"] = nodes
    out.setdefault("n_vals", nodes)
    out.setdefault("n_active", None)
    out.setdefault("kind", "core")
    if out["kind"] not in ("core", "full"):
        raise ValueError(f"kind must be core|full, got {out['kind']!r}")
    out.setdefault("topology", None)
    if out["topology"] is not None:
        WanTopology.from_dict(out["topology"])  # shape check
    churn = out.setdefault("churn", None)
    if churn is not None:
        if int(churn.get("every", 0)) < 1 or int(churn.get("shift", 0)) < 1:
            raise ValueError("churn needs every >= 1 and shift >= 1")
        if out["n_active"] is None:
            raise ValueError("churn scenarios must set n_active (the window)")
    out.setdefault("config", {})
    out.setdefault("load", None)
    if out["load"] is not None and out["kind"] != "full":
        raise ValueError("load profiles need kind=full (mempool fleet)")
    timeline = out.setdefault("timeline", [])
    for ev in timeline:
        if ev.get("action") not in _ACTIONS:
            raise ValueError(f"unknown timeline action: {ev.get('action')!r}")
        if "at_height" not in ev and "at_s" not in ev:
            raise ValueError(f"timeline event needs at_height or at_s: {ev}")
    run = out.setdefault("run", {})
    run.setdefault("target_height", 20)
    run.setdefault("timeout_s", 120.0)
    out.setdefault("expect", {})
    out.setdefault("slow", True)
    return out


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


class _LoadFeeder:
    """Background tx feeder into one full node's mempool at a live
    mutable rate (txs/s); `load_rate` timeline events retune it — the
    flash-crowd knob."""

    def __init__(self, node, rate: float, payload: int = 64) -> None:
        from tendermint_tpu_torch.testing.loadgen import TxFactory

        self._node = node
        self.rate = rate
        self._factory = TxFactory(
            payload=payload, hot_keys=8, hot_prob=0.2, dup_prob=0.0,
            signed=False, signers=0,
        )
        self._stop = threading.Event()
        self._n = 0
        self._thread = threading.Thread(
            target=self._feed_loop, name="scenario-load", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _feed_loop(self) -> None:
        while not self._stop.is_set():
            rate = max(0.0, self.rate)
            if rate <= 0:
                time.sleep(0.05)
                continue
            tx = self._factory.make(self._n)
            self._n += 1
            try:
                self._node.node.mempool.check_tx_async(tx)
            except Exception as e:  # a full mempool is load shedding, not a bug
                kv(_log, logging.DEBUG, "load tx rejected", error=type(e).__name__)
            time.sleep(1.0 / rate)


class ScenarioRunner:
    """Executes declarative scenarios and grades the reports.

    One runner per fleet home; `run()` is synchronous and returns the
    report dict (never raises for a failed EXPECTATION — `ok: False`
    with `failures` is the verdict; it does raise for a broken SAFETY
    invariant, which is a harness-level red, not a grade)."""

    def __init__(self, home: str | None = None, device=None) -> None:
        self.home = home
        self.device = device

    # -- internals -----------------------------------------------------------

    def _build_config(self, spec: dict):
        from tendermint_tpu_torch.testing.nemesis import NemesisNode

        cfg = NemesisNode.default_config()
        c = spec["config"]
        if "timeout_commit_ms" in c:
            cfg.timeout_commit = int(c["timeout_commit_ms"])
        if "timeout_propose_ms" in c:
            cfg.timeout_propose = int(c["timeout_propose_ms"])
        if "timeout_prevote_ms" in c:
            cfg.timeout_prevote = int(c["timeout_prevote_ms"])
        if "timeout_precommit_ms" in c:
            cfg.timeout_precommit = int(c["timeout_precommit_ms"])
        if "skip_timeout_commit" in c:
            cfg.skip_timeout_commit = bool(c["skip_timeout_commit"])
        if "adaptive_timeouts" in c:
            cfg.adaptive_timeouts = bool(c["adaptive_timeouts"])
        return cfg

    def _build_net(self, spec: dict) -> Nemesis:
        churn = spec["churn"]
        chain_id = f"scenario-{spec['name']}"
        app_factory = None
        if churn is not None:
            app_factory = churn_app_factory(
                spec["n_vals"],
                chain_id,
                active=spec["n_active"],
                every=int(churn["every"]),
                shift=int(churn["shift"]),
            )
        if spec["kind"] == "full":
            # full nodes own a complete node Config; graft the scenario's
            # consensus tuning in via the mutator (fresh object per node)
            def mutator(config):
                config.consensus = self._build_config(spec)

            node_factory = Nemesis.full_node_factory(
                app_factory=app_factory, config_mutator=mutator
            )
            net_config = None
        else:
            node_factory = Nemesis.core_node_factory(app_factory=app_factory)
            net_config = self._build_config(spec)
        return Nemesis(
            spec["nodes"],
            n_vals=spec["n_vals"],
            n_active=spec["n_active"],
            home=self.home,
            config=net_config,
            chain_id=chain_id,
            node_factory=node_factory,
            device=self.device,
        )

    @staticmethod
    def _fire(net: Nemesis, topo: WanTopology | None, feeder, ev: dict) -> None:
        action = ev["action"]
        if action == "partition":
            net.partition(*[set(g) for g in ev["groups"]])
        elif action == "partition_region":
            if topo is None:
                raise ValueError("partition_region needs a topology")
            net.partition(*topo.partition_groups(len(net.nodes), ev["region"]))
        elif action == "heal":
            net.heal()
        elif action == "crash":
            net.crash(int(ev["node"]))
        elif action == "restart":
            net.restart(int(ev["node"]))
        elif action == "delay":
            net.delay(int(ev["i"]), int(ev["j"]), float(ev["seconds"]))
        elif action == "load_rate":
            if feeder is not None:
                feeder.rate = float(ev["rate"])

    @staticmethod
    def _finality_stats(net: Nemesis, window: int = 256) -> dict:
        vals: list[float] = []
        for node in net.nodes:
            ledger = getattr(node, "height_ledger", None) or getattr(
                getattr(node, "node", None), "height_ledger", None
            )
            if ledger is not None:
                vals.extend(ledger.finality_window(window))
        vals.sort()
        if not vals:
            return {"count": 0}
        pick = lambda q: vals[min(len(vals) - 1, int(q * len(vals)))]  # noqa: E731
        return {
            "count": len(vals),
            "p50_s": pick(0.50),
            "p95_s": pick(0.95),
            "max_s": vals[-1],
        }

    # -- entry point ---------------------------------------------------------

    def run(self, spec: dict) -> dict:
        from tendermint_tpu_torch.telemetry import TRACER
        from tendermint_tpu_torch.telemetry import metrics as _metrics

        spec = validate_scenario(spec)
        topo = (
            WanTopology.from_dict(spec["topology"])
            if spec["topology"] is not None
            else None
        )
        net = self._build_net(spec)
        if topo is not None:
            net.set_topology(topo)
        skips0 = _round_skips_total()
        feeder = None
        report: dict = {"scenario": spec["name"], "ok": False, "failures": []}
        t0 = time.monotonic()
        warm_height = int(spec["expect"].get("warm_height", 16))
        warm_skips: float | None = None
        try:
            with TRACER.span("scenario.run", scenario=spec["name"]):
                net.start()
                if spec["load"] is not None:
                    feeder = _LoadFeeder(
                        net.nodes[0],
                        rate=float(spec["load"].get("rate", 20.0)),
                        payload=int(spec["load"].get("payload", 64)),
                    )
                    feeder.start()
                warm_skips = self._play(net, spec, topo, feeder, warm_height)
        finally:
            if feeder is not None:
                feeder.stop()
            try:
                net.stop(check=False)
            except Exception as e:
                kv(_log, logging.WARNING, "net stop", error=type(e).__name__)
        report["elapsed_s"] = round(time.monotonic() - t0, 3)
        report["heights"] = net.heights()
        report["finality"] = self._finality_stats(net)
        report["round_skips"] = (
            _round_skips_total()
            - skips0
        )
        report["round_skips_post_warm"] = (
            None
            if warm_skips is None
            else _round_skips_total()
            - warm_skips
        )
        self._collect(net, spec, topo, report)
        self._grade(net, spec, report)
        result = "pass" if report["ok"] else "fail"
        _metrics.SCENARIO_RUNS.labels(result=result).inc()
        _metrics.SCENARIO_SECONDS.observe(report["elapsed_s"])
        kv(
            _log,
            logging.INFO,
            "scenario done",
            name=spec["name"],
            ok=report["ok"],
            heights=str(report["heights"]),
            failures=len(report["failures"]),
        )
        return report

    def _play(self, net, spec, topo, feeder, warm_height: int) -> float | None:
        """Drive the timeline while the net commits toward the target;
        returns the round-skip counter snapshot taken when the fleet
        first passed `warm_height` (the post-warm baseline)."""
        target = int(spec["run"]["target_height"])
        deadline = time.monotonic() + float(spec["run"]["timeout_s"])
        pending = sorted(
            spec["timeline"],
            key=lambda ev: (ev.get("at_height", 0), ev.get("at_s", 0.0)),
        )
        t0 = time.monotonic()
        warm_skips: float | None = None
        while True:
            if net.violations:
                raise InvariantViolation(net.violations[0])
            heights = net.heights()
            top = max(heights, default=0)
            now = time.monotonic()
            if warm_skips is None and top >= warm_height:
                warm_skips = _round_skips_total()
            fired = []
            for ev in pending:
                due_h = ev.get("at_height")
                due_s = ev.get("at_s")
                if (due_h is not None and top >= due_h) or (
                    due_s is not None and now - t0 >= due_s
                ):
                    self._fire(net, topo, feeder, ev)
                    kv(_log, logging.INFO, "timeline", action=ev["action"], at=top)
                    fired.append(ev)
            for ev in fired:
                pending.remove(ev)
            running = [
                i for i, node in enumerate(net.nodes) if node.running
            ]
            if running and all(
                net.nodes[i].store.height >= target for i in running
            ):
                return warm_skips
            if now > deadline:
                net._dump_stall_forensics()  # stacks + flight recorder
                raise TimeoutError(
                    f"scenario {spec['name']}: heights {heights} did not reach "
                    f"{target} in {spec['run']['timeout_s']}s "
                    f"({len(pending)} timeline events unfired)"
                )
            time.sleep(0.05)

    def _collect(self, net, spec, topo, report: dict) -> None:
        """Post-run observations that are not pass/fail by themselves."""
        churn = spec["churn"]
        if churn is not None:
            top = max(report["heights"], default=0)
            report["epochs"] = top // int(churn["every"])
            report["valset_rebuilds"] = sum(
                getattr(node.cs, "pipeline_stats", {}).get("valset_rebuilds", 0)
                for node in net.nodes
            )
        if spec["config"].get("adaptive_timeouts"):
            derived = [
                node.cs.timeouts.propose_timeout(0)
                for node in net.nodes
                if getattr(node, "cs", None) is not None
            ]
            report["propose_timeout_s"] = {
                "min": round(min(derived), 4),
                "max": round(max(derived), 4),
            }
        if topo is not None:
            worst = 0.0
            for i in range(len(net.nodes)):
                for j in range(len(net.nodes)):
                    if i != j:
                        p = topo.profile(i, j)
                        worst = max(worst, p.rtt_ms / 2.0 / 1000.0 * topo.scale)
            report["max_one_way_delay_s"] = round(worst, 4)
        gsum = self._gossip_summary(net)
        if gsum is not None:
            report["gossip"] = gsum

    @staticmethod
    def _gossip_summary(net) -> dict | None:
        """Fleet-wide gossip observatory rollup: per-channel bytes,
        per-kind redundancy factor (delivered / useful), top redundant
        kind — the numbers the `expect.gossip` block grades and the
        scenario_run/nemesis_demo verdict tables print. None when every
        node is sampled out (TENDERMINT_TPU_GOSSIPLOG=0)."""
        chans: dict[str, int] = {}
        kinds_recv: dict[str, int] = {}
        red: dict[str, dict] = {}
        seen = False
        for node in net.nodes:
            gossip = getattr(getattr(node, "switch", None), "gossip", None)
            if gossip is None or not gossip.enabled:
                continue
            seen = True
            snap = gossip.snapshot()
            for c, st in snap["channels"].items():
                chans[c] = chans.get(c, 0) + st["send_bytes"] + st["recv_bytes"]
            for k, st in snap["kinds"].items():
                kinds_recv[k] = kinds_recv.get(k, 0) + st["recv_msgs"]
            for k, st in snap["redundant"].items():
                r = red.setdefault(k, {"msgs": 0, "bytes": 0})
                r["msgs"] += st["msgs"]
                r["bytes"] += st["bytes"]
        if not seen:
            return None
        # redundant-kind -> wire-kind join (evidence dedups per item,
        # the wire ships lists)
        kind_of = {"evidence": "evidence_list"}
        factors: dict[str, float] = {}
        for k, r in red.items():
            recv = kinds_recv.get(kind_of.get(k, k), 0)
            useful = recv - r["msgs"]
            if useful > 0:
                factors[k] = round(recv / useful, 3)
            elif r["msgs"]:
                factors[k] = float(r["msgs"] + 1)
        top = max(red.items(), key=lambda kv: kv[1]["bytes"], default=None)
        return {
            "channel_bytes": chans,
            "redundant": red,
            "redundancy_factor": factors,
            "top_redundant_kind": top[0] if top else None,
            "total_bytes": sum(chans.values()),
        }

    def _grade(self, net, spec, report: dict) -> None:
        exp = spec["expect"]
        fails = report["failures"]
        try:
            net.check_invariants()  # no-fork + commit agreement, final word
        except InvariantViolation as e:
            fails.append(f"invariant: {e}")
        min_h = exp.get("min_height", spec["run"]["target_height"])
        live = [
            h for node, h in zip(net.nodes, report["heights"]) if node.running
        ] or report["heights"]
        if min(live, default=0) < min_h:
            fails.append(f"height floor: {report['heights']} < {min_h}")
        if "max_finality_p95_s" in exp:
            p95 = report["finality"].get("p95_s")
            if p95 is None or p95 > exp["max_finality_p95_s"]:
                fails.append(
                    f"finality p95 {p95} > {exp['max_finality_p95_s']}s"
                )
        if "min_epochs" in exp and report.get("epochs", 0) < exp["min_epochs"]:
            fails.append(
                f"epochs {report.get('epochs')} < {exp['min_epochs']}"
            )
        if "min_valset_rebuilds" in exp and report.get(
            "valset_rebuilds", 0
        ) < exp["min_valset_rebuilds"]:
            fails.append(
                f"valset rebuilds {report.get('valset_rebuilds')} < "
                f"{exp['min_valset_rebuilds']} (speculation rebuild not exercised)"
            )
        if exp.get("bisection_bridges"):
            try:
                genesis_privs = net.privs[: len(net.genesis.validators)]
                report["bisection"] = bisect_bridge(
                    net.nodes[0], net.chain_id, genesis_privs, device=self.device
                )
            except Exception as e:
                fails.append(f"bisection bridge: {type(e).__name__}: {e}")
        if exp.get("adaptive_above_max_delay"):
            d = report.get("propose_timeout_s", {}).get("min", 0.0)
            worst = report.get("max_one_way_delay_s", 0.0)
            if d <= worst:
                fails.append(
                    f"adaptive propose timeout {d}s did not converge above "
                    f"the injected one-way delay {worst}s"
                )
        if "max_round_skips_post_warm" in exp:
            post = report.get("round_skips_post_warm")
            if post is None or post > exp["max_round_skips_post_warm"]:
                fails.append(
                    f"round skips after warmup: {post} > "
                    f"{exp['max_round_skips_post_warm']} (timeouts thrashing)"
                )
        gexp = exp.get("gossip") or {}
        if gexp:
            # bandwidth/redundancy assertions graded from the gossip
            # observatory rollups (docs/SCENARIOS.md "expect.gossip") —
            # WAN scenarios bound gossip amplification the same way they
            # bound finality
            g = report.get("gossip")
            if g is None:
                fails.append(
                    "gossip expectations set but no rollup collected "
                    "(TENDERMINT_TPU_GOSSIPLOG sampled out?)"
                )
            else:
                if gexp.get("require_counted") and g["total_bytes"] <= 0:
                    fails.append("gossip accounting counted zero bytes")
                for kind, cap in (gexp.get("max_redundancy") or {}).items():
                    got = g["redundancy_factor"].get(kind)
                    if got is not None and got > cap:
                        fails.append(
                            f"gossip redundancy {kind} {got}x > {cap}x"
                        )
                for chan, cap_mb in (
                    gexp.get("max_channel_mbytes") or {}
                ).items():
                    got_mb = g["channel_bytes"].get(chan, 0) / 1e6
                    if got_mb > cap_mb:
                        fails.append(
                            f"gossip channel {chan} "
                            f"{got_mb:.2f} MB > {cap_mb} MB"
                        )
        report["ok"] = not fails


def run_library(names: list[str] | None = None, home: str | None = None,
                include_slow: bool = True, device=None) -> list[dict]:
    """Run named scenarios (default: whole library) and return their
    reports in order."""
    reports = []
    for name, spec in SCENARIO_LIBRARY.items():
        if names is not None and name not in names:
            continue
        if not include_slow and spec.get("slow", True):
            continue
        reports.append(ScenarioRunner(home=home, device=device).run(spec))
    return reports


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------
#
# Delays run the real inter-region geometry at `scale` (0.1–0.2): the
# relative shape — who is far from whom, how asymmetric the routes are
# — is what consensus reacts to; full-scale RTTs only stretch the wall
# clock without changing which code paths fire. Heavy entries are
# `slow`; `slow_wan_validator` and `churn_small` stay tier-1.

SCENARIO_LIBRARY: dict[str, dict] = {
    "slow_wan_validator": {
        "name": "slow_wan_validator",
        "description": (
            "Uniform fast fabric with ONE far-away validator; adaptive "
            "timeouts must learn the slow path (converge above the "
            "injected RTT) without post-warmup round skips."
        ),
        "nodes": 4,
        "kind": "core",
        "config": {
            "adaptive_timeouts": True,
            "skip_timeout_commit": True,
            "timeout_commit_ms": 20,
        },
        "topology": {
            "name": "slow-validator",
            "placement": ["r0"],
            "rtt_ms": {"r0|r0": 30.0},
            "jitter_frac": 0.10,
            "scale": 0.2,
            "overrides": {
                "3|0": {"rtt_ms": 200.0, "jitter_ms": 20.0},
                "0|3": {"rtt_ms": 200.0, "jitter_ms": 20.0},
                "3|1": {"rtt_ms": 200.0, "jitter_ms": 20.0},
                "1|3": {"rtt_ms": 200.0, "jitter_ms": 20.0},
                "3|2": {"rtt_ms": 200.0, "jitter_ms": 20.0},
                "2|3": {"rtt_ms": 200.0, "jitter_ms": 20.0},
            },
        },
        "run": {"target_height": 30, "timeout_s": 90.0},
        "expect": {
            "min_height": 30,
            "warm_height": 18,
            "adaptive_above_max_delay": True,
            "max_round_skips_post_warm": 0,
            # gossip amplification bound: a 4-peer full mesh re-gossips
            # every vote to every peer, so each node hears each vote up
            # to ~3x (n-1); 12x means the push-gossip layer is looping
            "gossip": {"require_counted": True,
                       "max_redundancy": {"vote": 12.0}},
        },
        "slow": False,
    },
    "churn_small": {
        "name": "churn_small",
        "description": (
            "25% of a 4-validator window rotates every 4 heights over a "
            "6-key pool: the speculated round must rebuild at every "
            "epoch boundary and a light client must bisect from genesis "
            "across every rotation."
        ),
        "nodes": 6,
        "n_vals": 6,
        "n_active": 4,
        "kind": "core",
        "churn": {"every": 4, "shift": 1},
        "config": {"skip_timeout_commit": True, "timeout_commit_ms": 20},
        "run": {"target_height": 16, "timeout_s": 90.0},
        "expect": {
            "min_height": 16,
            "min_epochs": 3,
            "min_valset_rebuilds": 3,
            "bisection_bridges": True,
            # churn re-gossips votes across epoch boundaries; bound the
            # amplification but leave headroom for rotation catchup
            "gossip": {"require_counted": True,
                       "max_redundancy": {"vote": 16.0}},
        },
        "slow": False,
    },
    "flash_crowd": {
        "name": "flash_crowd",
        "description": (
            "Full-node fleet on a WAN fabric under steady load hit by a "
            "6x submit burst mid-run; finality p95 must hold an SLO "
            "through the crowd."
        ),
        "nodes": 4,
        "kind": "full",
        "topology": {
            "placement": ["us-east", "us-west", "eu-west", "us-east"],
            "scale": 0.1,
        },
        # WAN-and-load-honest timeouts: the harness's 100 ms test
        # propose ladder (1 ms/round escalation) livelocks on nil
        # prevotes once burst gossip pushes proposal delivery past it —
        # the ladder can never outgrow a sustained latency shift. A
        # deployment on this fabric runs second-scale ceilings
        # (reference default: 3000 ms propose).
        "config": {
            "timeout_propose_ms": 1000,
            "timeout_prevote_ms": 300,
            "timeout_precommit_ms": 300,
        },
        "load": {"rate": 25.0, "payload": 64},
        "timeline": [
            {"at_height": 10, "action": "load_rate", "rate": 150.0},
            {"at_height": 20, "action": "load_rate", "rate": 25.0},
        ],
        "run": {"target_height": 30, "timeout_s": 180.0},
        "expect": {
            "min_height": 30,
            "max_finality_p95_s": 3.0,
            # the burst must not amplify: tx redundancy (peers cross-
            # shipping txs the dup-cache already holds) stays bounded
            # even at 6x load, and vote gossip holds the mesh bound
            "gossip": {"require_counted": True,
                       "max_redundancy": {"vote": 12.0, "tx": 30.0}},
        },
        "slow": True,
    },
    "regional_outage": {
        "name": "regional_outage",
        "description": (
            "Five regions, one validator each; eu-west drops off the "
            "planet for a window. The surviving 4/5 quorum must keep "
            "finalizing and the healed region must catch up."
        ),
        "nodes": 5,
        "kind": "core",
        "topology": {"placement": list(
            ("us-east", "us-west", "eu-west", "ap-northeast", "sa-east")
        ), "scale": 0.1},
        "timeline": [
            {"at_height": 8, "action": "partition_region", "region": "eu-west"},
            {"at_height": 16, "action": "heal"},
        ],
        "run": {"target_height": 24, "timeout_s": 180.0},
        "expect": {
            "min_height": 24,
            # the healed region replays missed votes/parts on rejoin —
            # redundancy spikes by design, but must stay finite
            "gossip": {"require_counted": True,
                       "max_redundancy": {"vote": 24.0}},
        },
        "slow": True,
    },
    "churn_storm": {
        "name": "churn_storm",
        "description": (
            "50% of a 4-validator window rotates every 3 heights over "
            "an 8-key pool — the dense-rotation stress for speculation "
            "rebuilds and bisection ladders."
        ),
        "nodes": 8,
        "n_vals": 8,
        "n_active": 4,
        "kind": "core",
        "churn": {"every": 3, "shift": 2},
        "config": {"skip_timeout_commit": True, "timeout_commit_ms": 20},
        "run": {"target_height": 18, "timeout_s": 150.0},
        "expect": {
            "min_height": 18,
            "min_epochs": 4,
            "min_valset_rebuilds": 4,
            "bisection_bridges": True,
        },
        "slow": True,
    },
    "partition_during_churn": {
        "name": "partition_during_churn",
        "description": (
            "A minority partition lands ACROSS an epoch boundary: the "
            "majority side must rotate the valset and keep committing; "
            "the healed minority must adopt the rotated set and catch "
            "up without fork."
        ),
        "nodes": 6,
        "n_vals": 6,
        "n_active": 4,
        "kind": "core",
        "churn": {"every": 4, "shift": 1},
        "config": {"skip_timeout_commit": True, "timeout_commit_ms": 40},
        "timeline": [
            {"at_height": 6, "action": "partition",
             "groups": [[0, 1, 2, 4, 5], [3]]},
            {"at_height": 14, "action": "heal"},
        ],
        "run": {"target_height": 20, "timeout_s": 180.0},
        "expect": {
            "min_height": 20,
            "min_epochs": 4,
            "bisection_bridges": True,
        },
        "slow": True,
    },
}
