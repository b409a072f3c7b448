"""State-sync demo: snapshot restore under injected chunk corruption.

Spins up an in-process validator network serving snapshots, lets it
commit past a snapshot interval, CORRUPTS a stored chunk on one serving
node (so a syncing peer receives garbage it must detect and re-fetch
elsewhere), then boots a fresh node with `state_sync` enabled and
times the restore:

    python -m tendermint_tpu_torch.tools.statesync_demo --device cpu
    python -m tendermint_tpu_torch.tools.statesync_demo --nodes 4 --interval 5 --chunk-size 4096

Prints discovery/restore/parity timings plus the exported
`tendermint_statesync_*` telemetry the run produced, from the port's
registry. The nodes verify on the CUDA card unless `--device` names
another device.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


def telemetry(name, **labels):
    from tendermint_tpu_torch.telemetry import REGISTRY

    return REGISTRY.counter_value(name, **labels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=2, help="serving validators")
    ap.add_argument("--interval", type=int, default=3, help="snapshot every N heights")
    ap.add_argument("--chunk-size", type=int, default=1024)
    ap.add_argument("--height", type=int, default=5, help="serve height before joining")
    ap.add_argument("--no-corruption", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tendermint_tpu_torch.testing.nemesis import FullNemesisNode, Nemesis

    def serving(cfg):
        cfg.statesync.snapshot_interval = args.interval
        cfg.statesync.chunk_size = args.chunk_size

    home = tempfile.mkdtemp(prefix="statesync-demo-")
    t0 = time.perf_counter()
    with Nemesis(
        args.nodes,
        home=home,
        node_factory=Nemesis.full_node_factory(config_mutator=serving),
        device=args.device,
    ) as net:
        net.nodes[0].node.mempool.check_tx(b"demo-key=demo-val")
        net.wait_height(args.height, timeout=120)
        t_chain = time.perf_counter() - t0
        manifests = net.nodes[0].node.snapshot_store.list_manifests()
        print(
            f"chain at height {max(net.heights())} in {t_chain:.1f}s; "
            f"snapshots: {[(m.height, m.chunks) for m in manifests]}"
        )

        corrupted = 0
        if not args.no_corruption and args.nodes > 1:
            # freeze snapshot-taking so the corrupted snapshot stays the
            # newest one on offer, then flip EVERY stored chunk on one
            # serving node — whatever it is asked for, the joiner must
            # blame it, drop it, and re-fetch from the honest peers
            for n in net.nodes:
                n.node.statesync_reactor.snapshot_interval = 0
            evil = net.nodes[1].node.snapshot_store
            for m in evil.list_manifests():
                for i in range(m.chunks):
                    if evil.corrupt_chunk(m.height, m.format, i):
                        corrupted += 1
            print(f"corrupted {corrupted} stored chunk(s) on node 1")

        def joining(cfg):
            cfg.statesync.enable = True
            cfg.statesync.chunk_size = args.chunk_size

        t1 = time.perf_counter()
        joiner = FullNemesisNode(
            args.nodes,
            net.genesis,
            net.privs,
            net.home,
            net.chain_id,
            config_mutator=joining,
            device=args.device,
        )
        net.add_node(joiner)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if joiner.node.statesync_reactor.restored_state is not None:
                break
            time.sleep(0.05)
        restored = joiner.node.statesync_reactor.restored_state
        if restored is None:
            print("RESTORE FAILED (gave up; fell back to fast-sync)")
            return 1
        t_restore = time.perf_counter() - t1
        target = max(n.store.height for n in net.nodes[: args.nodes])
        while joiner.store.height < target and time.monotonic() < deadline:
            time.sleep(0.05)
        t_parity = time.perf_counter() - t1
        assert joiner.app._data.get(b"demo-key") == b"demo-val"

        out = {
            "snapshot_height": joiner.node.statesync_reactor.restored_manifest.height,
            "synced_height": joiner.store.height,
            "store_base": joiner.store.base,
            "restore_s": round(t_restore, 3),
            "parity_s": round(t_parity, 3),
            "chunks_ok": telemetry("tendermint_statesync_chunks_total", result="ok"),
            "chunks_corrupt": telemetry(
                "tendermint_statesync_chunks_total", result="corrupt"
            ),
            "chunks_served": telemetry("tendermint_statesync_chunks_served_total"),
            "snapshots_taken": telemetry(
                "tendermint_statesync_snapshots_taken_total"
            ),
            "restores_ok": telemetry(
                "tendermint_statesync_restores_total", result="ok"
            ),
        }
        if corrupted and out["chunks_corrupt"] == 0:
            print("note: corrupted peer was never asked for chunk 0 this run")
        print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
