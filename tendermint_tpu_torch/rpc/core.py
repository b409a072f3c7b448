"""RPC core handlers wired to node internals (reference
`rpc/core/routes.go:8-45` + per-file handlers).

`make_routes(node)` builds the route table from a composed Node;
responses are hex-encoded JSON dicts mirroring the reference's
result types.

The port's copy of `tendermint_tpu/rpc/core.py`. `make_routes` reads a
composed node; until the port has its own `Node`,
`tendermint_tpu_torch.testing.ReadNode` assembles one from the port's
parts.
"""

from __future__ import annotations

import queue
import time

from tendermint_tpu_torch.rpc.server import RPCError
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.types import events as ev
from tendermint_tpu_torch.types.tx import tx_hash

BROADCAST_TX_COMMIT_TIMEOUT_S = 60.0  # reference waits up to 120s


def _header_json(header) -> dict:
    return {
        "chain_id": header.chain_id,
        "height": header.height,
        "time": header.time,
        "num_txs": header.num_txs,
        "last_block_id": {
            "hash": header.last_block_id.hash.hex(),
            "parts": {
                "total": header.last_block_id.parts_header.total,
                "hash": header.last_block_id.parts_header.hash.hex(),
            },
        },
        "last_commit_hash": header.last_commit_hash.hex(),
        "data_hash": header.data_hash.hex(),
        "validators_hash": header.validators_hash.hex(),
        "app_hash": header.app_hash.hex(),
        "hash": header.hash().hex(),
    }


def _block_json(block) -> dict:
    return {
        "header": _header_json(block.header),
        "txs": [bytes(tx).hex() for tx in block.data.txs],
        "last_commit": {
            "block_id": block.last_commit.block_id.hash.hex()
            if block.last_commit.precommits
            else "",
            "precommits": sum(
                1 for p in block.last_commit.precommits if p is not None
            ),
        },
    }


def make_routes(node) -> dict:
    """Route table (reference `rpc/core/routes.go:8-34`)."""

    def status() -> dict:
        rs = node.consensus.get_round_state() if node.consensus else None
        latest = node.block_store.load_block_meta(node.block_store.height)
        return {
            "node_info": {
                "id": node.node_id,
                "moniker": node.config.base.moniker,
                "chain_id": node.genesis.chain_id,
            },
            "sync_info": {
                "latest_block_height": node.block_store.height,
                "latest_block_hash": latest.block_id.hash.hex() if latest else "",
                "latest_app_hash": node.current_state.app_hash.hex(),
                "catching_up": node.blockchain_reactor.fast_sync
                if node.blockchain_reactor
                else False,
            },
            "validator_info": {
                "address": node.priv_validator.address.hex()
                if node.priv_validator
                else "",
                "voting_power": next(
                    (
                        v.voting_power
                        for v in node.current_state.validators
                        if node.priv_validator
                        and v.address == node.priv_validator.address
                    ),
                    0,
                ),
            },
            "consensus_state": {
                "height": rs.height if rs else 0,
                "round": rs.round if rs else 0,
                "step": rs.step if rs else 0,
            },
        }

    def net_info() -> dict:
        peers = node.switch.peers() if node.switch else []
        return {
            "n_peers": len(peers),
            "peers": [
                {
                    "id": p.id,
                    "moniker": p.node_info.moniker,
                    "outbound": p.outbound,
                    "send_rate": round(p.send_monitor.rate, 1),
                    "recv_rate": round(p.recv_monitor.rate, 1),
                    "bytes_sent": p.send_monitor.total,
                    "bytes_recv": p.recv_monitor.total,
                }
                for p in peers
            ],
        }

    def block(height: int) -> dict:
        b = node.block_store.load_block(int(height))
        if b is None:
            raise RPCError(-32000, f"no block at height {height}")
        return {"block": _block_json(b)}

    def blockchain(min_height: int = 1, max_height: int = 0) -> dict:
        top = node.block_store.height
        max_h = int(max_height) or top
        max_h = min(max_h, top)
        min_h = max(int(min_height), max(1, max_h - 20 + 1))
        metas = []
        for h in range(max_h, min_h - 1, -1):
            m = node.block_store.load_block_meta(h)
            if m is not None:
                metas.append(
                    {"height": m.header.height, "hash": m.block_id.hash.hex()}
                )
        return {"last_height": top, "block_metas": metas}

    def commit(height: int) -> dict:
        c = node.block_store.load_block_commit(int(height))
        seen = c is None
        if c is None:
            c = node.block_store.load_seen_commit(int(height))
        if c is None:
            raise RPCError(-32000, f"no commit for height {height}")
        meta = node.block_store.load_block_meta(int(height))
        out = {
            "canonical": not seen,
            "commit": {
                "height": c.height(),
                "round": c.round(),
                "block_id": {
                    "hash": c.block_id.hash.hex(),
                    "parts": {
                        "total": c.block_id.parts_header.total,
                        "hash": c.block_id.parts_header.hash.hex(),
                    },
                },
                "signatures": sum(1 for p in c.precommits if p is not None),
                # full precommits (null = absent vote) so external light
                # clients can re-verify — the reference's ResultCommit
                # carries the complete SignedHeader
                # (`rpc/core/blocks.go` Commit)
                "precommits": [
                    None
                    if v is None
                    else {
                        "validator_address": v.validator_address.hex(),
                        "validator_index": v.validator_index,
                        "height": v.height,
                        "round": v.round,
                        "timestamp": v.timestamp,
                        "type": v.type,
                        "block_id": {
                            "hash": v.block_id.hash.hex(),
                            "parts": {
                                "total": v.block_id.parts_header.total,
                                "hash": v.block_id.parts_header.hash.hex(),
                            },
                        },
                        "signature": v.signature.hex(),
                    }
                    for v in c.precommits
                ],
            },
        }
        if meta is not None:
            out["header"] = _header_json(meta.header)
        _metrics.REPLICA_PROOFS_SERVED.labels(kind="commit").inc()
        return out

    def full_commit(height: int = 0) -> dict:
        """One light-client proof unit — header + commit + valset at a
        height (0 = tip) — served from the certified cache / local
        stores through the 0x68 reactor's exact->floor lookup. The
        `full_commit` hex decodes via `FullCommit.decode`; external
        light clients feed it straight into a certifier walk without
        the three-round-trip commit+validators+header dance."""
        reactor = getattr(node, "lightclient_reactor", None)
        fc = reactor.serve_commit(int(height)) if reactor is not None else None
        if fc is None:
            raise RPCError(-32000, f"no full commit at height {height}")
        _metrics.REPLICA_PROOFS_SERVED.labels(kind="full_commit").inc()
        return {
            "height": fc.height(),
            "header": _header_json(fc.header),
            "canonical": True,
            "full_commit": fc.encode().hex(),
        }

    def validators(height: int | None = None) -> dict:
        h = int(height) if height is not None else node.current_state.last_block_height + 1
        vs = node.current_state.load_validators(h)
        _metrics.REPLICA_PROOFS_SERVED.labels(kind="validators").inc()
        return {
            "block_height": h,
            "validators": [
                {
                    "address": v.address.hex(),
                    "pub_key": v.pub_key.data.hex(),
                    "voting_power": v.voting_power,
                }
                for v in vs
            ],
        }

    def dump_consensus_state() -> dict:
        if node.consensus is None:
            raise RPCError(-32000, "consensus not running")
        rs = node.consensus.get_round_state()
        peers = []
        reactor = getattr(node, "consensus_reactor", None)
        if reactor is not None and node.switch is not None:
            for p in node.switch.peers():
                ps = p.get(reactor.PEER_STATE_KEY)
                if ps is None:
                    continue
                prs = ps.snapshot()
                peers.append(
                    {
                        "id": p.id,
                        "height": prs.height,
                        "round": prs.round,
                        "step": prs.step,
                        "has_proposal": prs.proposal,
                    }
                )
        return {
            "height": rs.height,
            "round": rs.round,
            "step": rs.step,
            "proposal": rs.proposal is not None,
            "locked_round": rs.locked_round,
            "validators": len(rs.validators),
            "peers": peers,
        }

    def health() -> dict:
        """Health / readiness snapshot (telemetry/health.py): status ∈
        ok | degraded | not_ready, per-check detail, rolling finality
        SLO. Also served as plain `GET /health` with HTTP 503 on
        not_ready so load balancers can act without parsing JSON-RPC."""
        from tendermint_tpu_torch.telemetry.health import build_health

        return build_health(node)

    def dump_telemetry(
        spans: int = 128,
        prefix: str = "",
        trace_id: str = "",
        flight: int = 0,
        heights: int = 0,
        profile: int = 0,
        launches: int = 0,
        gossip: int = 0,
    ) -> dict:
        """Structured telemetry dump: the full metrics registry, the
        recent span window (consensus round phases, device dispatch),
        and per-service breaker snapshots. The JSON twin of
        `GET /metrics` (docs/OBSERVABILITY.md).

        `trace_id` (hex) narrows the span window to one distributed
        trace — the live-node half of `tools/trace_timeline.py`;
        `flight` > 0 additionally returns that many recent flight-
        recorder events; `heights` > 0 returns the last N HeightLedger
        records (per-height phases + critical-path attribution);
        `profile` > 0 returns the contention-observatory view (profiler
        snapshot + top-contended locks + unified queue waits —
        `tools/contention_report.py` consumes it); `launches` > 0
        returns the last N LaunchLedger records + per-kind rollup (the
        device observatory — `tools/device_report.py` consumes it);
        `gossip` > 0 returns the gossip observatory view (per-peer ×
        per-channel × per-kind traffic, redundancy counters, first-seen
        propagation stamps — `tools/gossip_report.py` consumes it).

        High-cardinality detail (per-peer, per-thread, per-site) is
        served ONLY here, through `telemetry/views.py` — the dump-only
        convention (docs/OBSERVABILITY.md "Dump-only views")."""
        from tendermint_tpu_torch.telemetry import REGISTRY, TRACER, views

        breakers = {}
        for name, svc in (
            ("verifier", getattr(node.consensus, "verifier", None)),
            ("hasher", getattr(node, "hasher", None)),
        ):
            if svc is not None and hasattr(svc, "snapshot"):
                try:
                    breakers[name] = svc.snapshot()
                except Exception:
                    pass
        if trace_id:
            # trace filter ignores the recency cap: a stitched timeline
            # wants every matching span still in the ring
            span_window = [
                s
                for s in TRACER.recent(prefix=str(prefix))
                if (s.get("attrs") or {}).get("trace") == str(trace_id)
            ]
        else:
            span_window = TRACER.recent(n=int(spans), prefix=str(prefix))
        out = {
            "metrics": REGISTRY.to_dict(),
            "spans": span_window,
            "breakers": breakers,
        }
        want: list = ["p2p", "vote_arrivals"]
        if int(profile) > 0:
            want.append("profile")
        if int(launches) > 0:
            want.append(("launches", {"n": int(launches)}))
        if int(gossip) > 0:
            want.append("gossip")
        out.update(views.collect(node, want))
        if int(flight) > 0:
            from tendermint_tpu_torch.telemetry.flightrec import FLIGHT

            out["flight"] = FLIGHT.recent(n=int(flight))
        if int(heights) > 0:
            ledger = getattr(node.consensus, "height_ledger", None)
            if ledger is not None:
                out["heights"] = ledger.recent(int(heights))
        return out

    def abci_query(path: str = "", data: str = "", height: int = 0, prove: bool = False) -> dict:
        res = node.app_conns.query.query_sync(
            path, bytes.fromhex(data) if data else b"", int(height), bool(prove)
        )
        if prove:
            _metrics.REPLICA_PROOFS_SERVED.labels(kind="abci_query").inc()
        return {
            "code": res.code,
            "value": res.value.hex(),
            "log": res.log,
            "height": res.height,
        }

    def num_unconfirmed_txs() -> dict:
        return {"n_txs": node.mempool.size()}

    def unconfirmed_txs() -> dict:
        """Pending mempool txs (reference `rpc/core/mempool.go` +
        `routes.go:22` UnconfirmedTxs)."""
        txs = node.mempool.reap(-1)
        return {"n_txs": len(txs), "txs": [bytes(t).hex() for t in txs]}

    def abci_info() -> dict:
        """App Info over the query conn (reference `rpc/core/abci.go:36-42`,
        route `routes.go:30`)."""
        res = node.app_conns.query.info_sync()
        return {
            "data": res.data,
            "version": res.version,
            "last_block_height": res.last_block_height,
            "last_block_app_hash": res.last_block_app_hash.hex(),
        }

    def _decode_tx(tx: str) -> bytes:
        try:
            return bytes.fromhex(tx)
        except ValueError as e:
            raise RPCError(-32602, f"tx must be hex: {e}") from e

    def broadcast_tx_async(tx: str) -> dict:
        raw = _decode_tx(tx)
        # fire-and-forget (reference BroadcastTxAsync returns before
        # CheckTx): the tx joins the next ingress verify window and this
        # handler thread is free for the next request
        submit = getattr(node.mempool, "check_tx_async", None)
        (submit or node.mempool.check_tx)(raw)
        return {"hash": tx_hash(raw).hex()}

    def broadcast_tx_sync(tx: str) -> dict:
        raw = _decode_tx(tx)
        res = node.mempool.check_tx(raw)
        return {
            "code": res.code,
            "data": res.data.hex(),
            "log": res.log,
            "hash": tx_hash(raw).hex(),
        }

    def broadcast_tx_commit(tx: str) -> dict:
        """CheckTx, then wait for the tx to be committed in a block
        (reference `rpc/core/mempool.go:149-215`)."""
        raw = _decode_tx(tx)
        h = tx_hash(raw)
        got: "queue.Queue" = queue.Queue()
        key = ev.event_tx(h)
        listener_id = f"rpc-tx-{h.hex()[:16]}-{time.monotonic_ns()}"
        node.event_switch.add_listener(listener_id, key, got.put)
        try:
            check = node.mempool.check_tx(raw)
            if not check.is_ok:
                return {
                    "check_tx": {"code": check.code, "log": check.log},
                    "deliver_tx": {},
                    "hash": h.hex(),
                    "height": 0,
                }
            try:
                data = got.get(timeout=BROADCAST_TX_COMMIT_TIMEOUT_S)
            except queue.Empty:
                raise RPCError(-32000, "timed out waiting for tx commit") from None
            return {
                "check_tx": {"code": check.code, "log": check.log},
                "deliver_tx": {
                    "code": data.code,
                    "data": data.data.hex(),
                    "log": data.log,
                },
                "hash": h.hex(),
                "height": data.height,
            }
        finally:
            node.event_switch.remove_listener(listener_id)

    def tx(hash: str, prove: bool = False) -> dict:
        if node.tx_indexer is None:
            raise RPCError(-32000, "tx indexing disabled")
        tr = node.tx_indexer.get(bytes.fromhex(hash))
        if tr is None:
            raise RPCError(-32000, f"tx {hash} not found")
        out = {
            "height": tr.height,
            "index": tr.index,
            "tx": tr.tx.hex(),
            "result": {
                "code": tr.result.code,
                "data": tr.result.data.hex(),
                "log": tr.result.log,
            },
        }
        if prove:
            # Rebuild the block's tx tree and serve the inclusion proof
            # (reference `rpc/core/tx.go` Tx prove + `types/tx.go:71-112`)
            blk = node.block_store.load_block(tr.height)
            if blk is None:
                raise RPCError(-32000, f"block {tr.height} not in store")
            tx_proof = blk.data.txs.proof(tr.index)
            _metrics.REPLICA_PROOFS_SERVED.labels(kind="tx").inc()
            out["proof"] = {
                "root_hash": tx_proof.root_hash.hex(),
                "data": tx_proof.data.hex(),
                "proof": {
                    "index": tx_proof.proof.index,
                    "total": tx_proof.proof.total,
                    "leaf": tx_proof.proof.leaf.hex(),
                    "aunts": [a.hex() for a in tx_proof.proof.aunts],
                },
            }
        return out

    def genesis() -> dict:
        import json as _json

        return {"genesis": _json.loads(node.genesis.to_json())}

    # -- unsafe profiling/introspection routes (reference
    # `rpc/core/routes.go:36-45` + `dev.go`, served only with
    # rpc.unsafe; the pprof-server analog for this runtime) ------------

    # Sampling profiler across ALL threads: cProfile hooks only the
    # calling thread, which over HTTP is a short-lived request-handler
    # thread — it would capture nothing of the node's work. A sampler
    # walking sys._current_frames() sees consensus/gossip/sync threads
    # regardless of which thread starts it.
    _profiler: dict = {}
    _profiler_lock = __import__("threading").Lock()

    def unsafe_start_cpu_profiler(interval_ms: int = 5) -> dict:
        import collections
        import sys
        import threading
        import time as time_mod

        if not _profiler_lock.acquire(blocking=False):
            raise RPCError(-32000, "profiler already running")
        # held until unsafe_stop_cpu_profiler releases: two concurrent
        # starts must not each spawn an (then-unstoppable) sampler
        if _profiler:
            _profiler_lock.release()
            raise RPCError(-32000, "profiler already running")
        counts = collections.Counter()
        stop = threading.Event()

        def sampler():
            while not stop.is_set():
                for frame in list(sys._current_frames().values()):
                    counts[
                        f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:"
                        f"{frame.f_lineno} {frame.f_code.co_name}"
                    ] += 1
                time_mod.sleep(max(int(interval_ms), 1) / 1000.0)

        t = threading.Thread(target=sampler, name="rpc-profiler", daemon=True)
        _profiler["stop"] = stop
        _profiler["counts"] = counts
        _profiler["thread"] = t
        t.start()
        return {"started": True, "interval_ms": int(interval_ms)}

    def unsafe_stop_cpu_profiler(top: int = 25) -> dict:
        if not _profiler:
            raise RPCError(-32000, "profiler not running")
        _profiler["stop"].set()
        _profiler["thread"].join(timeout=2)
        counts = _profiler["counts"]
        _profiler.clear()
        _profiler_lock.release()
        total = sum(counts.values()) or 1
        return {
            "samples": total,
            "profile": [
                {"where": where, "pct": round(100.0 * n / total, 1)}
                for where, n in counts.most_common(int(top))
            ],
        }

    def unsafe_dump_threads() -> dict:
        import sys
        import threading
        import traceback

        frames = sys._current_frames()
        out = {}
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            if frame is not None:
                out[t.name] = traceback.format_stack(frame)[-3:]
        return {"threads": out, "count": len(out)}

    def unsafe_heap_summary(top: int = 20, keep_tracing: bool = False) -> dict:
        import tracemalloc

        if isinstance(keep_tracing, str):
            keep_tracing = keep_tracing.strip().lower() in ("true", "1", "yes")

        if not tracemalloc.is_tracing():
            tracemalloc.start()
            return {"started": True, "note": "call again for a snapshot"}
        snap = tracemalloc.take_snapshot()
        # tracing taxes every allocation — turn it off once snapshotted
        # unless the operator explicitly keeps it for a follow-up diff
        if not keep_tracing:
            tracemalloc.stop()
        stats = snap.statistics("lineno")[: int(top)]
        return {
            "tracing": bool(keep_tracing),
            "top": [
                {"where": str(s.traceback), "kb": round(s.size / 1024, 1)}
                for s in stats
            ],
        }

    def dial_seeds(seeds: str = "") -> dict:
        """UnsafeDialSeeds (reference `rpc/core/net.go:57-69`): dial a
        comma-separated seed list in the background."""
        lst = [s.strip() for s in str(seeds).split(",") if s.strip()]
        if not lst:
            raise RPCError(-32602, "no seeds provided")
        import threading

        for seed in lst:
            threading.Thread(
                target=node.dial_seed, args=(seed,), daemon=True
            ).start()
        return {"log": "Dialing seeds in progress. See /net_info for details"}

    def unsafe_flush_mempool() -> dict:
        """Drop every pending tx (reference `rpc/core/mempool.go`
        UnsafeFlushMempool, route `routes.go:39`)."""
        node.mempool.flush()
        return {"result": "flushed"}

    routes_unsafe = {
        "dial_seeds": dial_seeds,
        "unsafe_flush_mempool": unsafe_flush_mempool,
        "unsafe_start_cpu_profiler": unsafe_start_cpu_profiler,
        "unsafe_stop_cpu_profiler": unsafe_stop_cpu_profiler,
        "unsafe_dump_threads": unsafe_dump_threads,
        "unsafe_heap_summary": unsafe_heap_summary,
    }

    return {
        **(routes_unsafe if node.config.rpc.unsafe else {}),
        "status": status,
        "net_info": net_info,
        "block": block,
        "blockchain": blockchain,
        "commit": commit,
        "full_commit": full_commit,
        "validators": validators,
        "dump_consensus_state": dump_consensus_state,
        "dump_telemetry": dump_telemetry,
        "health": health,
        "abci_query": abci_query,
        "abci_info": abci_info,
        "num_unconfirmed_txs": num_unconfirmed_txs,
        "unconfirmed_txs": unconfirmed_txs,
        "broadcast_tx_async": broadcast_tx_async,
        "broadcast_tx_sync": broadcast_tx_sync,
        "broadcast_tx_commit": broadcast_tx_commit,
        "tx": tx,
        "genesis": genesis,
    }
