"""CLI: init / node / testnet / show_validator / gen_validator /
replay / replay_console / reset_all / reset_priv_validator /
probe_upnp / wal2json / cut_wal_until / version
(reference `cmd/tendermint/main.go:14-37` + `commands/`).

Run as `python -m tendermint_tpu_torch <command> [--home DIR] ...`.

The port's copy of `tendermint_tpu/cmd.py`. `node`, `replay` and
`replay_console` take `--device` (default: the CUDA card); without a
card and without `--device cpu` they raise rather than run on the host.
`node` loads the kernel library from `ops/_build.py`'s digest-keyed
cache under `build/kernels/` (the node's `warm_kernels()`), the
counterpart of the JAX package's persistent XLA cache.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time


def _cmd_init(args) -> int:
    """Create config.toml, genesis.json, priv_validator.json (reference
    `commands/init.go`)."""
    from tendermint_tpu_torch.config import Config, write_config
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFS

    cfg = Config.default(args.home)
    os.makedirs(args.home, exist_ok=True)
    write_config(cfg)
    pv = PrivValidatorFS.load_or_gen(cfg.priv_validator_path())
    if not os.path.exists(cfg.genesis_path()):
        gen = GenesisDoc(
            chain_id=args.chain_id or f"test-chain-{os.urandom(3).hex()}",
            genesis_time=time.time_ns(),
            validators=[GenesisValidator(pub_key=pv.pub_key, power=10)],
        )
        gen.save_as(cfg.genesis_path())
    print(f"initialized node home at {args.home}")
    return 0


def _cmd_show_validator(args) -> int:
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFS

    cfg = load_config(args.home)
    pv = PrivValidatorFS.load(cfg.priv_validator_path())
    print(pv.pub_key.data.hex())
    return 0


def _cmd_node(args) -> int:
    """Run a node until interrupted (reference `commands/run_node.go`)."""
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node import Node

    cfg = load_config(args.home)
    if args.p2p_laddr:
        cfg.p2p.laddr = args.p2p_laddr
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    if args.seeds:
        cfg.p2p.seeds = args.seeds
    if args.fast_sync is not None:
        cfg.base.fast_sync = args.fast_sync

    node = Node(cfg, device=args.device)
    node.start()
    print(
        f"node {node.node_id[:12]} up: p2p :{node.p2p_port} rpc :{node.rpc_port}",
        flush=True,
    )
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        node.stop()
    return 0


def _cmd_testnet(args) -> int:
    """Generate N validator node homes wired to each other (reference
    `commands/testnet.go:29-50`)."""
    from tendermint_tpu_torch.config import Config, write_config
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFS

    n = args.n
    base_p2p = args.starting_port
    homes = [os.path.join(args.output, f"node{i}") for i in range(n)]
    pvs = []
    for home in homes:
        os.makedirs(home, exist_ok=True)
        pvs.append(
            PrivValidatorFS.load_or_gen(os.path.join(home, "priv_validator.json"))
        )
    gen = GenesisDoc(
        chain_id=args.chain_id or f"testnet-{os.urandom(3).hex()}",
        genesis_time=time.time_ns(),
        validators=[GenesisValidator(pub_key=pv.pub_key, power=10) for pv in pvs],
    )
    for i, home in enumerate(homes):
        cfg = Config.default(home)
        cfg.base.moniker = f"node{i}"
        cfg.p2p.laddr = f"tcp://127.0.0.1:{base_p2p + 2 * i}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{base_p2p + 2 * i + 1}"
        cfg.p2p.seeds = ",".join(
            f"127.0.0.1:{base_p2p + 2 * j}" for j in range(n) if j != i
        )
        write_config(cfg)
        gen.save_as(os.path.join(home, "genesis.json"))
    print(f"wrote {n} node homes under {args.output}")
    return 0


def _cmd_probe_upnp(args) -> int:
    """Discover a UPnP gateway and test a port mapping (reference
    `commands/probe_upnp.go`)."""
    import json as _json

    from tendermint_tpu_torch.p2p import upnp

    try:
        result = upnp.probe(port=args.port)
    except upnp.UPnPError as e:
        print(f"probe failed: {e}", file=sys.stderr)
        return 1
    print(_json.dumps(result))
    return 0


def _cmd_version(args) -> int:
    from tendermint_tpu_torch.version import __version__

    print(__version__)
    return 0


def _cmd_gen_validator(args) -> int:
    """Print a freshly generated validator keypair as JSON (reference
    `commands/gen_validator.go`). Does NOT touch any file."""
    import json as _json

    from tendermint_tpu_torch.crypto import gen_priv_key

    pk = gen_priv_key()
    print(
        _json.dumps(
            {
                "address": pk.pub_key.address.hex(),
                "pub_key": pk.pub_key.data.hex(),
                "priv_key_seed": pk.seed.hex(),
                "last_height": 0,
                "last_round": 0,
                "last_step": 0,
                "last_signature": "",
                "last_signbytes": "",
            },
            indent=2,
            sort_keys=True,
        )
    )
    return 0


def _reset_priv_validator(path: str) -> None:
    from tendermint_tpu_torch.types.priv_validator import PrivValidatorFS

    if os.path.exists(path):
        PrivValidatorFS.load(path).reset()
        print(f"reset priv validator sign state: {path}")
    else:
        PrivValidatorFS.load_or_gen(path)
        print(f"generated priv validator: {path}")


def _cmd_reset_priv_validator(args) -> int:
    """(unsafe) Forget the validator's last-sign state — double-sign
    protection goes with it (reference `commands/reset_priv_validator.go`).
    Testnets only."""
    from tendermint_tpu_torch.config import load_config

    _reset_priv_validator(load_config(args.home).priv_validator_path())
    return 0


def _cmd_reset_all(args) -> int:
    """(unsafe) Remove all chain data + WALs and reset the validator
    (reference `commands/reset_priv_validator.go` resetAll)."""
    import shutil

    from tendermint_tpu_torch.config import load_config

    cfg = load_config(args.home)
    data_dir = os.path.dirname(cfg.db_path("state"))
    for victim in (data_dir, cfg.mempool_wal_path()):
        if os.path.isdir(victim):
            shutil.rmtree(victim)
            print(f"removed {victim}")
    _reset_priv_validator(cfg.priv_validator_path())
    return 0


def _cmd_replay(args) -> int:
    """Replay the consensus WAL through a fresh state machine — all at
    once (`replay`) or interactively (`replay_console`); reference
    `consensus/replay_file.go`, `commands/replay.go`."""
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.consensus.replay_console import (
        Playback,
        make_replay_cs_factory,
    )

    cfg = load_config(args.home)
    wal = args.wal or cfg.wal_path()
    pb = Playback(make_replay_cs_factory(cfg, device=args.device), wal)
    if args.console:
        pb.console()
    else:
        n = pb.run_all()
        print(f"replayed {n} records; final state: {pb.round_state('short')}")
    return 0


def _cmd_wal2json(args) -> int:
    """Dump a consensus WAL as JSON lines (reference
    `scripts/wal2json/main.go:19-50`)."""
    import json as _json

    from tendermint_tpu_torch.consensus.wal import (
        WAL,
        EndHeightMessage,
        MsgRecord,
        RoundStateRecord,
        TimeoutRecord,
    )

    for rec in WAL.iter_records(args.wal):
        if isinstance(rec, EndHeightMessage):
            out = {"type": "end_height", "height": rec.height}
        elif isinstance(rec, RoundStateRecord):
            out = {
                "type": "round_state",
                "height": rec.height,
                "round": rec.round,
                "step": rec.step,
            }
        elif isinstance(rec, TimeoutRecord):
            out = {
                "type": "timeout",
                "height": rec.height,
                "round": rec.round,
                "step": rec.step,
                "duration": rec.duration,
            }
        elif isinstance(rec, MsgRecord):
            m = rec.msg
            out = {
                "type": "msg",
                "peer": rec.peer_id,
                "msg": type(m).__name__ if not isinstance(m, tuple) else "BlockPart",
            }
            if hasattr(m, "height"):
                out["height"] = m.height
        else:
            out = {"type": type(rec).__name__}
        print(_json.dumps(out))
    return 0


def _cmd_cut_wal_until(args) -> int:
    """Truncate a WAL just before the first record at/after `height`
    (reference `scripts/cutWALUntil/main.go` — builds crash fixtures)."""
    from tendermint_tpu_torch.consensus.wal import WAL

    segments = WAL.segment_paths(args.wal)
    if not segments:
        print(f"error: no WAL found at {args.wal}", file=sys.stderr)
        return 1
    # walk ALL segments in order (rotated files + live file) so the cut
    # point is found wherever rotation put it; output is one flat file
    out = bytearray()
    total = 0
    done = False
    for seg in segments:
        with open(seg, "rb") as f:
            data = f.read()
        total += len(data)
        if done:
            continue
        cut = len(data)
        for off, rec in WAL.iter_records_with_offsets(seg):
            rec_height = getattr(rec, "height", None)
            if rec_height is None:
                rec_height = getattr(getattr(rec, "msg", None), "height", None)
            if rec_height is not None and rec_height >= args.height:
                cut = off
                done = True
                break
        out += data[:cut]
    with open(args.output, "wb") as f:
        f.write(bytes(out))
    print(f"wrote {len(out)} of {total} bytes to {args.output}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tendermint_tpu_torch", description="TPU-native BFT consensus node"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("init", help="initialize a node home directory")
    p.add_argument("--home", default=os.path.expanduser("~/.tendermint_tpu_torch"))
    p.add_argument("--chain-id", default="")
    p.set_defaults(fn=_cmd_init)

    p = sub.add_parser("node", help="run a node")
    p.add_argument("--home", default=os.path.expanduser("~/.tendermint_tpu_torch"))
    p.add_argument("--p2p-laddr", default="")
    p.add_argument("--rpc-laddr", default="")
    p.add_argument("--seeds", default="")
    p.add_argument(
        "--fast-sync", type=lambda s: s.lower() != "false", default=None
    )
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.set_defaults(fn=_cmd_node)

    p = sub.add_parser("testnet", help="generate an N-node local testnet")
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--output", default="./mytestnet")
    p.add_argument("--chain-id", default="")
    p.add_argument("--starting-port", type=int, default=46656)
    p.set_defaults(fn=_cmd_testnet)

    p = sub.add_parser("show_validator", help="print the validator pubkey")
    p.add_argument("--home", default=os.path.expanduser("~/.tendermint_tpu_torch"))
    p.set_defaults(fn=_cmd_show_validator)

    p = sub.add_parser("probe_upnp", help="test UPnP gateway port mapping")
    p.add_argument("--port", type=int, default=46656)
    p.set_defaults(fn=_cmd_probe_upnp)

    p = sub.add_parser("gen_validator", help="generate a validator keypair")
    p.set_defaults(fn=_cmd_gen_validator)

    p = sub.add_parser(
        "reset_priv_validator",
        help="(unsafe) reset the validator's sign state",
    )
    p.add_argument("--home", default=os.path.expanduser("~/.tendermint_tpu_torch"))
    p.set_defaults(fn=_cmd_reset_priv_validator)

    p = sub.add_parser(
        "reset_all", help="(unsafe) wipe chain data + reset the validator"
    )
    p.add_argument("--home", default=os.path.expanduser("~/.tendermint_tpu_torch"))
    p.set_defaults(fn=_cmd_reset_all)

    p = sub.add_parser("replay", help="replay the consensus WAL")
    p.add_argument("--home", default=os.path.expanduser("~/.tendermint_tpu_torch"))
    p.add_argument("--wal", default="", help="WAL path (default: the home's)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.set_defaults(fn=_cmd_replay, console=False)

    p = sub.add_parser(
        "replay_console", help="step the consensus WAL interactively"
    )
    p.add_argument("--home", default=os.path.expanduser("~/.tendermint_tpu_torch"))
    p.add_argument("--wal", default="", help="WAL path (default: the home's)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.set_defaults(fn=_cmd_replay, console=True)

    p = sub.add_parser("version", help="print the version")
    p.set_defaults(fn=_cmd_version)

    p = sub.add_parser("wal2json", help="dump a consensus WAL as JSON lines")
    p.add_argument("wal")
    p.set_defaults(fn=_cmd_wal2json)

    p = sub.add_parser(
        "cut_wal_until", help="truncate a WAL before the given height"
    )
    p.add_argument("wal")
    p.add_argument("height", type=int)
    p.add_argument("output")
    p.set_defaults(fn=_cmd_cut_wal_until)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
