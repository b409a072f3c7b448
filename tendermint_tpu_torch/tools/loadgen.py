"""Open-loop mempool load generator (ROADMAP open item 2) + read traffic.

Drives CheckTx traffic the way "millions of users" would: arrivals are
scheduled by a fixed-rate open-loop process (a slow mempool does NOT
slow the generator down — backlog shows up as admission latency, the
honest serving metric per ACE-style sub-second targets), spread over N
client threads, with configurable payload size, hot-key skew, and
duplicate re-sends (gossip-style re-arrivals that should be near-free
through the dup cache / VerifiedSigCache).

Two write targets:

* in-process (default): builds a KVStore app + the production mempool
  shape (sharded lanes + ingress batching over `default_verifier()`),
  then reads latency back from the same
  `tendermint_mempool_admission_seconds` histogram a node exports;
* `--rpc host:port`: fires `broadcast_tx_sync` at a running node.

`--reads` flips the generator into light-client QUERY traffic against
a replica fleet (`--rpc host:port[,host:port...]`, round-robin):
proof reads (`full_commit` / `commit` / `validators`) with hot-height
skew — recent heights are what real users hammer — plus a
`--walk-prob` fraction of full verify-to-height walks, each a FRESH
`BisectingCertifier` bootstrapping from the genesis pin through the
target's proofs (the "new light client joins" workload). The bench and
nemesis replica scenarios drive this mode.

    python -m tendermint_tpu_torch.tools.loadgen --rate 20000 --duration 3 --device cpu
    python -m tendermint_tpu_torch.tools.loadgen --rate 2000 --threads 16 --signed  # the card
    python -m tendermint_tpu_torch.tools.loadgen --rpc 127.0.0.1:46657 --rate 500
    python -m tendermint_tpu_torch.tools.loadgen --reads --rpc 127.0.0.1:46657,127.0.0.1:46658

The in-process mempool and the `--reads` walks verify on
`default_verifier(--device)`: the CUDA card unless `--device` names
another, and without a card and without `--device` they raise.
`TxFactory` is the scenario library's (`testing/loadgen.py`); its
signed payloads are signed by the port's pure-Python ed25519, so a
`--signed` generator falls behind its offered rate at a few thousand
tx/s (`late_arrivals`).

Output: one JSON summary line on stdout.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time

from tendermint_tpu_torch.testing.loadgen import TxFactory


def _percentile(sorted_vals, q: float):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1)))
    return sorted_vals[idx]


class Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.outcomes: dict[str, int] = {}
        self.latencies: list[float] = []
        self.late_arrivals = 0

    def record(self, outcome: str, latency_s: float) -> None:
        with self.lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
            self.latencies.append(latency_s)


def _outcome(code: int) -> str:
    return {0: "ok", 4: "bad_sig", 5: "duplicate"}.get(code, "rejected")


def run_inprocess(args, factory: TxFactory, stats: Stats):
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.abci.client import local_client_creator
    from tendermint_tpu_torch.mempool import Mempool
    from tendermint_tpu_torch.services.verifier import default_verifier

    conns = local_client_creator(KVStoreApp())()
    verifier = default_verifier(args.device)
    mp = Mempool(
        conns.mempool,
        cache_size=10_000_000,
        verifier=verifier,
        lanes=args.lanes or None,
        ingress_batch=not args.legacy,
    )

    def submit(tx, t_sched):
        def cb(res, t_sched=t_sched):
            stats.record(_outcome(res.code), time.perf_counter() - t_sched)

        mp.check_tx_async(tx, cb)

    drain = lambda: None  # noqa: E731
    return mp, submit, drain


def _rpc_get(target: str, method: str, timeout: float = 30.0, **params):
    import urllib.parse
    import urllib.request

    qs = urllib.parse.urlencode(params)
    url = f"http://{target}/{method}" + (f"?{qs}" if qs else "")
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        out = json.load(resp)
    if "error" in out and out["error"]:
        raise RuntimeError(out["error"].get("message", "rpc error"))
    return out["result"]


def run_reads(args, stats: Stats):
    """Open-loop light-client query traffic against a replica fleet."""
    targets = [t.strip() for t in args.rpc.split(",") if t.strip()]
    if not targets:
        raise SystemExit("--reads needs --rpc host:port[,host:port...]")
    st = _rpc_get(targets[0], "status")
    chain_id = st["node_info"]["chain_id"]
    tip = int(st["sync_info"]["latest_block_height"])
    gen = _rpc_get(targets[0], "genesis")["genesis"]
    rng = random.Random(11)
    rng_lock = threading.Lock()
    hot_window = max(1, min(args.hot_keys or 8, tip))

    def pick_height() -> int:
        with rng_lock:
            if args.hot_prob > 0 and rng.random() < args.hot_prob:
                return max(1, tip - rng.randrange(hot_window))
            return rng.randrange(1, tip + 1)

    def do_walk(target: str) -> str:
        """A fresh light client bootstraps from the genesis pin and
        verifies to the tip through this replica's proofs."""
        from tendermint_tpu_torch.certifiers.node_provider import NodeProvider
        from tendermint_tpu_torch.lightclient import BisectingCertifier
        from tendermint_tpu_torch.rpc.client import HTTPClient
        from tendermint_tpu_torch.services.verifier import default_verifier
        from tendermint_tpu_torch.types.genesis import GenesisDoc

        doc = GenesisDoc.from_json(json.dumps(gen))
        cert = BisectingCertifier(
            chain_id,
            validators=doc.validator_set(),
            height=0,
            source=NodeProvider(HTTPClient(target)),
            verifier=default_verifier(args.device),
        )
        cert.verify_to_height(tip)
        return "walk"

    def submit(n: int, t_sched: float) -> None:
        target = targets[n % len(targets)]
        with rng_lock:
            r = rng.random()
        try:
            if r < args.walk_prob:
                kind = do_walk(target)
            elif r < args.walk_prob + 0.5:
                kind = "full_commit"
                _rpc_get(target, "full_commit", height=pick_height())
            elif r < args.walk_prob + 0.75:
                kind = "commit"
                _rpc_get(target, "commit", height=pick_height())
            else:
                kind = "validators"
                _rpc_get(target, "validators", height=pick_height())
            stats.record(kind, time.perf_counter() - t_sched)
        except Exception:
            stats.record("error", time.perf_counter() - t_sched)

    return None, submit, lambda: None


def run_rpc(args, factory: TxFactory, stats: Stats):
    import urllib.request

    url = f"http://{args.rpc}/"

    def submit(tx, t_sched):
        req = urllib.request.Request(
            url,
            data=json.dumps(
                {
                    "jsonrpc": "2.0",
                    "id": 1,
                    "method": "broadcast_tx_sync",
                    "params": {"tx": tx.hex()},
                }
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                out = json.load(resp)
            code = int(out.get("result", {}).get("code", 1))
            stats.record(_outcome(code), time.perf_counter() - t_sched)
        except Exception:
            stats.record("error", time.perf_counter() - t_sched)

    return None, submit, lambda: None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=5000.0, help="offered tx/s (open loop)")
    ap.add_argument("--duration", type=float, default=3.0, help="seconds of traffic")
    ap.add_argument("--threads", type=int, default=8, help="client threads")
    ap.add_argument("--payload", type=int, default=64, help="payload bytes")
    ap.add_argument("--hot-keys", type=int, default=16, dest="hot_keys",
                    help="hot-key pool size (0 disables)")
    ap.add_argument("--hot-prob", type=float, default=0.2, dest="hot_prob",
                    help="probability an arrival uses a hot key")
    ap.add_argument("--dup-prob", type=float, default=0.0, dest="dup_prob",
                    help="probability an arrival re-sends recent tx bytes")
    ap.add_argument("--signed", action="store_true",
                    help="wrap payloads in the signed-tx envelope")
    ap.add_argument("--signers", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=0, help="mempool lanes (0=default)")
    ap.add_argument("--legacy", action="store_true",
                    help="ingress batching OFF (one-at-a-time admission)")
    ap.add_argument("--rpc", default="", help="host:port of a running node "
                    "(default: in-process mempool); comma-separated fleet "
                    "with --reads")
    ap.add_argument("--reads", action="store_true",
                    help="light-client query traffic (proof reads + walks) "
                    "against a replica fleet instead of CheckTx writes")
    ap.add_argument("--walk-prob", type=float, default=0.05, dest="walk_prob",
                    help="fraction of read arrivals that run a full "
                    "verify-to-height walk (fresh client bootstrap)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    factory = TxFactory(
        args.payload, args.hot_keys, args.hot_prob, args.dup_prob,
        args.signed, args.signers,
    )
    stats = Stats()
    if args.reads:
        mp, submit, drain = run_reads(args, stats)
    else:
        mp, submit, drain = (
            run_rpc(args, factory, stats) if args.rpc
            else run_inprocess(args, factory, stats)
        )

    n_total = int(args.rate * args.duration)
    interval = 1.0 / args.rate if args.rate > 0 else 0.0
    t0 = time.perf_counter() + 0.05  # shared epoch for all threads

    make = (lambda n: n) if args.reads else factory.make

    def worker(k: int):
        late = 0
        for n in range(k, n_total, args.threads):
            due = t0 + n * interval
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            elif now - due > 0.001:
                late += 1  # open loop: fire immediately, count the slip
            submit(make(n), due)
        with stats.lock:
            stats.late_arrivals += late

    sys.stderr.write(
        f"offering {args.rate:.0f} tx/s x {args.duration}s over "
        f"{args.threads} threads ({n_total} txs)...\n"
    )
    threads = [
        threading.Thread(target=worker, args=(k,)) for k in range(args.threads)
    ]
    wall0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # wait for in-flight admissions to resolve
    deadline = time.time() + 30
    while time.time() < deadline:
        with stats.lock:
            if len(stats.latencies) >= n_total:
                break
        time.sleep(0.05)
    wall = time.perf_counter() - wall0
    drain()
    if mp is not None:
        mp.close()

    with stats.lock:
        lat = sorted(stats.latencies)
        outcomes = dict(stats.outcomes)
        late = stats.late_arrivals
    out = {
        "offered_rate": args.rate,
        "duration_s": args.duration,
        "threads": args.threads,
        "payload_bytes": args.payload,
        "signed": bool(args.signed),
        "dup_prob": args.dup_prob,
        "hot_prob": args.hot_prob,
        "mode": "reads" if args.reads else (
            "rpc" if args.rpc else ("legacy" if args.legacy else "batched")
        ),
        "walk_prob": args.walk_prob if args.reads else None,
        "submitted": n_total,
        "resolved": len(lat),
        "achieved_checktx_per_s": round(len(lat) / wall, 1) if wall > 0 else None,
        "outcomes": outcomes,
        "late_arrivals": late,
        "admission_p50_ms": round(_percentile(lat, 0.50) * 1e3, 3) if lat else None,
        "admission_p99_ms": round(_percentile(lat, 0.99) * 1e3, 3) if lat else None,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
