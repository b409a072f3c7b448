"""Drive a chaos scenario against an in-process consensus network.

Usage:
    python -m tendermint_tpu_torch.tools.nemesis_demo [--nodes 4] [--heights 3] [--device cpu]

Runs the full nemesis playbook once, printing each phase: healthy
commits -> device-fault injection (circuit breaker trips, host fallback
keeps committing) -> fault clears (breaker re-closes) -> partition
(progress stalls, as it must) -> heal (progress resumes) -> crash +
WAL-tail corruption + restart (recovery replays). Exits non-zero if any
invariant (no-fork, commit agreement, progress) breaks.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def run_ingress_scenario(args) -> int:
    """Ingress-under-chaos: sustained signed-tx loadgen traffic into a
    FULL-node network's batched admission pipeline through a partition
    heal + verify-breaker trip — every tx that answered OK must commit
    (zero admitted-pool loss), no fork."""
    import itertools
    import threading

    from tendermint_tpu_torch.crypto.keys import gen_priv_key
    from tendermint_tpu_torch.mempool import make_signed_tx
    from tendermint_tpu_torch.services.resilient import ResilientVerifier
    from tendermint_tpu_torch.services.verifier import HostBatchVerifier
    from tendermint_tpu_torch.testing import Nemesis
    from tendermint_tpu_torch.utils import fail
    from tendermint_tpu_torch.utils.circuit import CircuitBreaker

    def verifier_factory(_i: int) -> ResilientVerifier:
        return ResilientVerifier(
            HostBatchVerifier(),
            breaker=CircuitBreaker(failure_threshold=2, reset_timeout_s=0.5),
            max_retries=0,
        )

    priv = gen_priv_key(b"\x33" * 32)
    t_all = time.time()
    with Nemesis(
        args.nodes,
        home=tempfile.mkdtemp(prefix="nemesis-ingress-"),
        node_factory=Nemesis.full_node_factory(),
        verifier_factory=verifier_factory,
        device=args.device,
    ) as net:
        print(f"[1/5] healthy full-node network of {args.nodes} ...")
        net.wait_height(2, timeout=args.timeout)

        admitted: list[bytes] = []
        lock = threading.Lock()
        stop = threading.Event()
        seq = itertools.count()

        def pump():
            for i in seq:
                if stop.is_set() or i >= args.txs:
                    return
                tx = make_signed_tx(priv, b"demo-%d=%d" % (i, i))

                def cb(res, tx=tx):
                    if res.is_ok:
                        with lock:
                            admitted.append(tx)

                net.nodes[i % 2].node.mempool.check_tx_async(tx, cb)
                time.sleep(1.0 / args.rate)

        print(f"[2/5] open-loop signed traffic at {args.rate:.0f} tx/s ...")
        t = threading.Thread(target=pump, daemon=True)
        t.start()
        try:
            time.sleep(0.5)
            print("[3/5] partition minority + trip the verify breaker ...")
            net.partition(set(range(args.nodes - 1)), {args.nodes - 1})
            fail.set_device_fault("verify")
            net.wait_progress(
                delta=2, nodes=list(range(args.nodes - 1)), timeout=args.timeout
            )
            print("[4/5] clear fault + heal; traffic still flowing ...")
            fail.clear_device_faults()
            net.heal()
            net.wait_progress(delta=2, timeout=args.timeout)
        finally:
            stop.set()
            t.join(10)
        with lock:
            final = list(admitted)
        print(f"[5/5] draining: {len(final)} admitted txs must all commit ...")
        deadline = time.time() + args.timeout
        missing = set(final)
        while time.time() < deadline and missing:
            store = net.nodes[0].store
            committed = set()
            for h in range(max(1, store.base), store.height + 1):
                blk = store.load_block(h)
                if blk is not None:
                    committed.update(bytes(x) for x in blk.data.txs)
            missing = set(final) - committed
            if missing:
                time.sleep(0.5)
        if missing:
            print(f"FAILED: {len(missing)} admitted txs lost")
            return 1
        net.check_invariants()
        print(
            f"done in {time.time() - t_all:.1f}s; zero admitted-tx loss, "
            "no fork"
        )
    return 0


def run_byzantine_scenario(args) -> int:
    """The adversary book: each scenario runs a live network, unleashes
    one Byzantine adversary from `testing/byzantine.py`, and records a
    verdict — evidence committed, attacker banned, breaker closed, no
    fork, liveness held (docs/BYZANTINE.md)."""
    import time as _time

    from tendermint_tpu_torch.services.resilient import ResilientVerifier
    from tendermint_tpu_torch.services.verifier import HostBatchVerifier
    from tendermint_tpu_torch.telemetry import REGISTRY
    from tendermint_tpu_torch.testing import (
        ConflictingProposer,
        Equivocator,
        FrameFuzzer,
        GarbageSigFlooder,
        Nemesis,
    )
    from tendermint_tpu_torch.testing.byzantine import wait_evidence_committed
    from tendermint_tpu_torch.utils.circuit import CircuitBreaker

    def verifier_factory(_i):
        return ResilientVerifier(
            HostBatchVerifier(),
            breaker=CircuitBreaker(failure_threshold=2, reset_timeout_s=0.5),
            max_retries=0,
        )

    verdicts: list[tuple[str, str, str]] = []  # (scenario, verdict, detail)
    t_all = _time.time()
    with Nemesis(
        args.nodes,
        home=tempfile.mkdtemp(prefix="nemesis-byz-"),
        verifier_factory=verifier_factory,
        device=args.device,
    ) as net:
        print(f"[1/4] equivocating validator (node {args.nodes - 1}) ...")
        net.wait_height(2, timeout=args.timeout)
        eq = Equivocator(net, args.nodes - 1).start()
        try:
            honest = list(range(args.nodes - 1))
            found = wait_evidence_committed(
                net, eq.address, nodes=honest, within_heights=5,
                timeout=args.timeout,
            )
            verdicts.append(
                (
                    "equivocator",
                    "PASS",
                    f"{eq.equivocations} double-signs -> evidence committed "
                    f"at heights {sorted(set(found.values()))} on all "
                    f"{len(honest)} honest nodes (<= 5 heights late)",
                )
            )
        finally:
            eq.stop()

        print("[2/4] conflicting proposer (node 1) ...")
        cp = ConflictingProposer(net, 1).start()
        try:
            deadline = _time.time() + args.timeout
            while _time.time() < deadline and cp.conflicts < 2:
                _time.sleep(0.05)
            net.wait_progress(delta=3, timeout=args.timeout)
            net.check_invariants()
            verdicts.append(
                (
                    "conflicting-proposer",
                    "PASS",
                    f"{cp.conflicts} split proposals; no fork, progress held",
                )
            )
        finally:
            cp.stop()

        print("[3/4] garbage-signature flooder vs node 0 ...")
        trips_before = REGISTRY.counter_value(
            "tendermint_breaker_transitions_total", kind="verify", to="open"
        )
        flooder = GarbageSigFlooder(net.nodes[0], net.chain_id)
        try:
            deadline = _time.time() + args.timeout
            while _time.time() < deadline and not flooder.banned():
                flooder.flood_votes(64)
                flooder.flood_txs(64)
                _time.sleep(0.05)
            trips = (
                REGISTRY.counter_value(
                    "tendermint_breaker_transitions_total",
                    kind="verify",
                    to="open",
                )
                - trips_before
            )
            banned = flooder.banned() and not flooder.reconnect()
            breakers = [n.cs.verifier.breaker.state for n in net.nodes]
            ok = banned and trips == 0 and all(s == "closed" for s in breakers)
            verdicts.append(
                (
                    "sig-flooder",
                    "PASS" if ok else "FAIL",
                    f"banned={banned}, breaker trips={trips:.0f}, "
                    f"states={breakers}",
                )
            )
            net.wait_progress(delta=2, timeout=args.timeout)
        finally:
            flooder.stop()

        print("[4/4] wire-frame fuzzer vs node 1 ...")
        fuzzer = FrameFuzzer(net.nodes[1].switch, net.chain_id)
        sent = fuzzer.run(args.fuzz_frames)
        fuzzer.stop()
        net.wait_progress(delta=1, timeout=args.timeout)
        net.check_invariants()
        verdicts.append(
            (
                "frame-fuzzer",
                "PASS",
                f"{sent} mutated frames across {fuzzer.reconnects} "
                f"identities; node alive, no fork",
            )
        )

    print(f"\nadversary book done in {_time.time() - t_all:.1f}s:")
    width = max(len(s) for s, _, _ in verdicts)
    failed = 0
    for scenario, verdict, detail in verdicts:
        print(f"  {scenario:<{width}}  {verdict}  {detail}")
        failed += verdict != "PASS"
    return 1 if failed else 0


def run_pipeline_scenario(args) -> int:
    """Cross-height pipeline chaos book: a
    FAULTED apply landing mid-pipeline drains at the join barrier and
    halts its node with no speculative state persisted; a FORGED apply
    (diverged local execution) can never fork the chain — the honest
    +2/3 keeps committing honest headers while the forger wedges
    itself. Restarting the faulted node proves the drain left a
    recoverable WAL/store. No-fork + commit-agreement invariants run
    continuously."""
    from tendermint_tpu_torch.state.state import load_state
    from tendermint_tpu_torch.testing import Nemesis
    from tendermint_tpu_torch.testing.nemesis import (
        FaultedApplyApp,
        ForgedHashApp,
        one_bad_app_factory,
    )

    t_all = time.time()
    verdicts: list[tuple[str, str, str]] = []

    def wait_fatal(node, timeout=30.0):
        deadline = time.time() + timeout
        while node.cs.fatal_error is None and time.time() < deadline:
            time.sleep(0.1)
        return node.cs.fatal_error

    print("[1/2] faulted apply mid-pipeline: node 3's ABCI commit raises at height 4 ...")
    with Nemesis(
        args.nodes,
        home=tempfile.mkdtemp(prefix="nemesis-pipe-"),
        node_factory=Nemesis.full_node_factory(
            app_factory=one_bad_app_factory(
                3, FaultedApplyApp, args.nodes, fail_from_height=4
            )
        ),
        device=args.device,
    ) as net:
        honest = list(range(args.nodes - 1))
        net.wait_height(6, nodes=honest, timeout=args.timeout)
        err = wait_fatal(net.nodes[3])
        persisted = load_state(net.nodes[3].node.state_db).last_block_height
        net.check_no_fork()
        ok = err is not None and persisted == 3
        verdicts.append(
            (
                "faulted apply",
                "PASS" if ok else "FAIL",
                f"halted={err is not None} persisted_height={persisted} "
                f"(speculative height 4 never landed), honest chain at "
                f"{max(net.heights())}, no fork",
            )
        )

    print("[2/2] forged apply: node 3's app returns a forged app hash from height 3 ...")
    with Nemesis(
        args.nodes,
        home=tempfile.mkdtemp(prefix="nemesis-forge-"),
        node_factory=Nemesis.full_node_factory(
            app_factory=one_bad_app_factory(
                3, ForgedHashApp, args.nodes, fail_from_height=3
            )
        ),
        device=args.device,
    ) as net:
        honest = list(range(args.nodes - 1))
        net.wait_height(6, nodes=honest, timeout=args.timeout)
        err = wait_fatal(net.nodes[3])
        forged = b"\xde\xad\xbe\xef" * 5
        clean = all(
            net.nodes[0].store.load_block_meta(h).header.app_hash != forged
            for h in range(4, net.nodes[0].store.height + 1)
        )
        net.check_no_fork()
        ok = err is not None and clean
        verdicts.append(
            (
                "forged apply",
                "PASS" if ok else "FAIL",
                f"forger halted={err is not None}, no committed header "
                f"carries the forged hash={clean}, honest chain at "
                f"{max(net.heights())}, no fork",
            )
        )

    print(f"\npipeline chaos book done in {time.time() - t_all:.1f}s:")
    width = max(len(s) for s, _, _ in verdicts)
    failed = 0
    for scenario, verdict, detail in verdicts:
        print(f"  {scenario:<{width}}  {verdict}  {detail}")
        failed += verdict != "PASS"
    return 1 if failed else 0


def run_replicas_scenario(args) -> int:
    """Read-replica fleet book: stateless
    replicas join a live validator net, follow it via follow-mode
    fast-sync + the 0x68 FullCommit subscription, and serve
    light-client reads. Then (a) a forged-FullCommit pusher attacks a
    replica — the client pin rejects it, the pusher is banned, and the
    embedded double-sign becomes COMMITTED evidence on the validators
    while the honest replica keeps answering; (b) the replica fleet is
    partitioned from the validators — serving lag is reported, reads
    keep answering from the certified cache, and the fleet converges
    after heal."""
    import json as _json

    from tendermint_tpu_torch.testing import Nemesis
    from tendermint_tpu_torch.testing.byzantine import (
        ForgedCommitPusher,
        forge_fullcommit,
        wait_evidence_committed,
    )
    from tendermint_tpu_torch.testing.nemesis import FullNemesisNode

    t_all = time.time()
    verdicts: list[tuple[str, str, str]] = []
    home = tempfile.mkdtemp(prefix="nemesis-replicas-")

    def replica_mutator(cfg):
        cfg.replica.enable = True

    with Nemesis(
        args.nodes, home=home, node_factory=Nemesis.full_node_factory(), device=args.device
    ) as net:
        n_vals = args.nodes
        print(f"[1/4] {n_vals} validators + {args.replicas} joining replicas ...")
        net.wait_height(2, timeout=args.timeout)
        reps = []
        for k in range(args.replicas):
            rep = FullNemesisNode(
                n_vals + k,
                net.genesis,
                net.privs,
                home,
                net.chain_id,
                config_mutator=replica_mutator,
                device=args.device,
            )
            net.add_node(rep)
            reps.append(rep)
        rep_idx = [n_vals + k for k in range(args.replicas)]
        target = max(net.heights()) + 2
        net.wait_height(target, nodes=rep_idx, timeout=args.timeout)
        certified = [r.node.fullcommit_cache.latest_height() for r in reps]
        deadline = time.time() + args.timeout
        while time.time() < deadline and not all(c >= 2 for c in certified):
            time.sleep(0.2)
            certified = [r.node.fullcommit_cache.latest_height() for r in reps]
        verdicts.append(
            (
                "replica-follow",
                "PASS" if all(c >= 2 for c in certified) else "FAIL",
                f"replicas at heights {[r.height for r in reps]}, certified "
                f"tips {certified}, consensus never joined "
                f"({all(r.node.consensus is None for r in reps)})",
            )
        )

        print("[2/4] forged FullCommit pushed at replica 0 ...")
        honest = reps[0].node.lightclient_reactor.serve_commit(2)
        forged = forge_fullcommit(honest, net.privs[0], net.chain_id)
        pusher = ForgedCommitPusher(reps[0].node, forged)
        pusher.push()
        try:
            deadline = time.time() + args.timeout
            while time.time() < deadline and not pusher.banned():
                time.sleep(0.1)
            # the embedded double-sign must COMMIT on the validators
            found = wait_evidence_committed(
                net,
                net.privs[0].address,
                nodes=list(range(n_vals)),
                timeout=args.timeout,
            )
            # the honest replica still answers at the attacked height
            served = reps[1].node.lightclient_reactor.serve_commit(2)
            honest_ok = (
                served is not None
                and served.header.app_hash == honest.header.app_hash
            )
            ok = pusher.banned() and honest_ok
            verdicts.append(
                (
                    "forged-fullcommit",
                    "PASS" if ok else "FAIL",
                    f"pusher banned={pusher.banned()}, double-sign evidence "
                    f"committed at heights {sorted(set(found.values()))}, "
                    f"honest replica answers={honest_ok}",
                )
            )
        finally:
            pusher.stop()

        print(f"[3/4] partition validators | replicas ...")
        net.partition(set(range(n_vals)), set(rep_idx))
        net.wait_progress(delta=2, nodes=list(range(n_vals)), timeout=args.timeout)
        stale = [r.height for r in reps]
        # reads keep answering from the certified cache while cut off
        served = reps[0].node.lightclient_reactor.serve_commit(0)
        lag_reported = [
            r.node.health()["serving"]["serving_lag"] for r in reps
        ]
        verdicts.append(
            (
                "partitioned-serving",
                "PASS" if served is not None else "FAIL",
                f"replica heights frozen at {stale} while validators "
                f"advanced to {max(net.heights())}; cached tip still "
                f"served (h={served.height() if served else None}), "
                f"serving lag reported {lag_reported}",
            )
        )

        print("[4/4] heal; replica fleet must converge ...")
        net.heal()
        target = max(net.heights()[:n_vals])
        net.wait_height(target, nodes=rep_idx, timeout=args.timeout)
        summary = {
            "heights": net.heights(),
            "certified": [r.node.fullcommit_cache.latest_height() for r in reps],
        }
        verdicts.append(
            ("partition-heal", "PASS", _json.dumps(summary, separators=(",", ":")))
        )
        net.check_invariants()

    print(f"\nreplica book done in {time.time() - t_all:.1f}s:")
    width = max(len(s) for s, _, _ in verdicts)
    failed = 0
    for scenario, verdict, detail in verdicts:
        print(f"  {scenario:<{width}}  {verdict}  {detail}")
        failed += verdict != "PASS"
    return 1 if failed else 0


def run_scenarios_scenario(args) -> int:
    """Declarative scenario-library book: every library entry — WAN
    slow-validator, validator churn, flash crowd, regional outage,
    churn storm, partition-during-churn — runs end-to-end through the
    ScenarioRunner and is graded against its committed expectations
    (finality SLOs, epoch counts, adaptive-timeout convergence,
    light-client bisection across rotations)."""
    from tendermint_tpu_torch.testing.scenario import run_library

    t_all = time.time()
    home = tempfile.mkdtemp(prefix="nemesis-scenarios-")
    reports = run_library(home=home, include_slow=not args.fast, device=args.device)
    verdicts: list[tuple[str, str, str]] = []
    for report in reports:
        fin = report["finality"]
        detail = f"heights {report['heights']}"
        if fin.get("count"):
            detail += f", finality p95 {fin['p95_s']:.2f}s"
        if "epochs" in report:
            detail += (
                f", {report['epochs']} epochs / "
                f"{report['valset_rebuilds']} rebuilds"
            )
        if "bisection" in report:
            detail += f", bisected to h{report['bisection']['verified_to']}"
        g = report.get("gossip")
        if g:
            detail += f", gossip {g['total_bytes'] / 1e6:.1f}MB"
            if g["redundancy_factor"]:
                detail += " (" + ", ".join(
                    f"{k} {f:.1f}x dup"
                    for k, f in sorted(
                        g["redundancy_factor"].items(), key=lambda kv: -kv[1]
                    )
                ) + ")"
        if report["failures"]:
            detail += f" — {'; '.join(report['failures'])}"
        verdicts.append(
            (report["scenario"], "PASS" if report["ok"] else "FAIL", detail)
        )

    print(f"\nscenario book done in {time.time() - t_all:.1f}s:")
    width = max(len(s) for s, _, _ in verdicts)
    failed = 0
    for scenario, verdict, detail in verdicts:
        print(f"  {scenario:<{width}}  {verdict}  {detail}")
        failed += verdict != "PASS"
    # the gossip verdict table: per-channel bandwidth + per-kind
    # redundancy, fleet-summed across the book's scenarios (the same
    # rollup tools/gossip_report.py renders per node)
    chan_totals: dict[str, int] = {}
    red_totals: dict[str, dict] = {}
    for report in reports:
        g = report.get("gossip")
        if not g:
            continue
        for c, b in g["channel_bytes"].items():
            chan_totals[c] = chan_totals.get(c, 0) + b
        for k, st in g["redundant"].items():
            r = red_totals.setdefault(k, {"msgs": 0, "bytes": 0})
            r["msgs"] += st["msgs"]
            r["bytes"] += st["bytes"]
    if chan_totals:
        print("\ngossip verdict (book total):")
        for c, b in sorted(chan_totals.items(), key=lambda kv: -kv[1]):
            print(f"  {c:<14} {b / 1e6:>8.2f}MB")
        for k, r in sorted(red_totals.items(), key=lambda kv: -kv[1]["bytes"]):
            print(
                f"  redundant {k:<11} {r['msgs']:>6} msgs "
                f"{r['bytes'] / 1e3:>8.1f}kB"
            )
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--heights", type=int, default=3, help="heights per phase")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument(
        "--ingress",
        action="store_true",
        help="run the ingress-under-chaos scenario (full nodes + loadgen "
        "traffic through partition heal + breaker trip) instead",
    )
    ap.add_argument(
        "--byzantine",
        action="store_true",
        help="run the Byzantine adversary book (equivocator -> evidence "
        "committed; flooder -> banned, breaker closed; proposer "
        "equivocation; frame fuzzing) instead",
    )
    ap.add_argument(
        "--pipeline",
        action="store_true",
        help="run the cross-height pipeline chaos book (faulted apply "
        "drains at the join barrier; forged apply cannot fork) instead",
    )
    ap.add_argument(
        "--replicas",
        type=int,
        default=0,
        help="run the read-replica fleet book with this many replicas "
        "(forged-FullCommit attribution; fleet under partition) instead",
    )
    ap.add_argument(
        "--scenarios",
        action="store_true",
        help="run the declarative scenario-library book (WAN topologies, "
        "validator churn, flash crowd, regional outage) instead",
    )
    ap.add_argument(
        "--fast",
        action="store_true",
        help="with --scenarios: tier-1 entries only, skip the slow ones",
    )
    ap.add_argument("--rate", type=float, default=150.0, help="ingress tx/s")
    ap.add_argument("--txs", type=int, default=1000, help="ingress tx cap")
    ap.add_argument(
        "--fuzz-frames", type=int, default=5000, help="byzantine fuzz frame count"
    )
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    if args.ingress:
        from tendermint_tpu_torch.utils.log import setup_logging

        setup_logging("resilient:info,nemesis:info,*:error")
        return run_ingress_scenario(args)

    if args.byzantine:
        from tendermint_tpu_torch.utils.log import setup_logging

        setup_logging("byzantine:info,evidence:warning,nemesis:info,*:error")
        return run_byzantine_scenario(args)

    if args.pipeline:
        from tendermint_tpu_torch.utils.log import setup_logging

        setup_logging("nemesis:info,*:error")
        return run_pipeline_scenario(args)

    if args.scenarios:
        from tendermint_tpu_torch.utils.log import setup_logging

        setup_logging("scenario:info,nemesis:warning,*:error")
        return run_scenarios_scenario(args)

    if args.replicas > 0:
        from tendermint_tpu_torch.utils.log import setup_logging

        setup_logging("lightclient:warning,nemesis:info,*:error")
        return run_replicas_scenario(args)

    from tendermint_tpu_torch.services.resilient import ResilientVerifier
    from tendermint_tpu_torch.services.verifier import HostBatchVerifier
    from tendermint_tpu_torch.testing import Nemesis
    from tendermint_tpu_torch.utils import fail
    from tendermint_tpu_torch.utils.circuit import CircuitBreaker
    from tendermint_tpu_torch.utils.log import setup_logging

    setup_logging("resilient:info,nemesis:info,*:error")

    def verifier_factory(_i: int) -> ResilientVerifier:
        return ResilientVerifier(
            HostBatchVerifier(),
            breaker=CircuitBreaker(failure_threshold=3, reset_timeout_s=1.0),
            max_retries=0,
        )

    t_all = time.time()
    with Nemesis(
        args.nodes, home=tempfile.mkdtemp(prefix="nemesis-demo-"),
        verifier_factory=verifier_factory,
        device=args.device,
    ) as net:
        step = args.heights

        print(f"[1/6] healthy network of {args.nodes} ...")
        net.wait_height(step, timeout=args.timeout)

        print("[2/6] injecting device verify faults (breaker will trip) ...")
        fail.set_device_fault("verify")
        target = max(net.heights()) + step
        net.wait_height(target, timeout=args.timeout)
        states = [n.cs.verifier.breaker.state for n in net.nodes]
        print(f"      breaker states: {states}; committing on host fallback")

        print("[3/6] clearing faults (breaker re-closes on probe) ...")
        fail.clear_device_faults()
        target = max(net.heights()) + step
        net.wait_height(target, timeout=args.timeout)
        deadline = time.time() + 30
        while time.time() < deadline and any(
            n.cs.verifier.breaker.state != "closed" for n in net.nodes
        ):
            time.sleep(0.2)
        print(f"      breaker states: {[n.cs.verifier.breaker.state for n in net.nodes]}")

        half = args.nodes // 2
        print(f"[4/6] partition {{0..{half-1}}} | {{{half}..{args.nodes-1}}} (no quorum, stall expected) ...")
        net.partition(set(range(half)), set(range(half, args.nodes)))
        before = max(net.heights())
        time.sleep(2.0)
        print(f"      heights {before} -> {max(net.heights())} while split")

        print("[5/6] heal (progress must resume) ...")
        net.heal()
        net.wait_height(max(net.heights()) + step, timeout=args.timeout)

        print("[6/6] crash node 0, corrupt its WAL tail, restart ...")
        net.crash(0)
        net.corrupt_wal_tail(0)
        net.restart(0)
        net.wait_height(max(net.heights()) + 1, timeout=args.timeout)

        print(
            f"done in {time.time() - t_all:.1f}s; heights={net.heights()}; "
            "all invariants held"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
