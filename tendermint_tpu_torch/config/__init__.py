"""Typed config tree + TOML persistence (reference `config/config.go`,
`config/toml.go`).

Defaults match the reference's shape: Base (home/moniker/fast-sync),
RPC, P2P, Mempool, Consensus sub-configs, with `Default*` and `Test*`
presets. `load_config` merges `$home/config.toml` over defaults;
`write_config` emits a commented TOML on `init`.

The port's copy of `tendermint_tpu/config/__init__.py`; it writes and
reads the same bytes. `Config.test_config()` keeps
`secret_connections=True`: the port's SecretConnection runs on its own
X25519, HKDF and ChaCha20-Poly1305, so it needs no `cryptography`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields

from tendermint_tpu_torch.consensus.config import ConsensusConfig


@dataclass
class BaseConfig:
    """Reference `config/config.go:57-132`."""

    moniker: str = "anonymous"
    fast_sync: bool = True
    db_dir: str = "data"
    log_level: str = "state:info,*:error"
    genesis_file: str = "genesis.json"
    priv_validator_file: str = "priv_validator.json"


@dataclass
class RPCConfig:
    """Reference `config/config.go:163-193`."""

    laddr: str = "tcp://127.0.0.1:46657"
    grpc_laddr: str = ""
    unsafe: bool = False


@dataclass
class P2PConfig:
    """Reference `config/config.go:199-256`."""

    laddr: str = "tcp://0.0.0.0:46656"
    # dialable address advertised to peers via PEX; REQUIRED for
    # multi-machine deployments when binding 0.0.0.0 (loopback is only
    # inferred for single-host setups)
    external_address: str = ""
    seeds: str = ""  # comma-separated host:port
    persistent_peers: str = ""
    secret_connections: bool = True  # X25519+AEAD STS on every peer link
    pex: bool = True  # peer-exchange discovery (addrbook + PEX reactor)
    # ask the ABCI app to vet peers via Query("/p2p/filter/...") before
    # admission (reference node/node.go:259-281, config FilterPeers)
    filter_peers: bool = False
    max_num_peers: int = 50
    pex_ensure_interval_s: float = 30.0  # reference ensurePeersPeriod
    send_rate: int = 512000  # bytes/s (flow limits live in MConnection)
    recv_rate: int = 512000
    # keepalive: ping idle peers, drop them when silent past the grace
    # window (reference pingTimeout 40s, `p2p/connection.go:312-345`)
    ping_interval_s: float = 40.0
    pong_timeout_s: float = 20.0
    # persistent-peer redial policy (reference `p2p/switch.go:15-18`:
    # reconnectAttempts 30 with backoff)
    reconnect_max_attempts: int = 30
    reconnect_base_backoff_s: float = 1.0


@dataclass
class StateSyncConfig:
    """Snapshot bootstrap + serving (`tendermint_tpu/statesync/`).

    `enable` turns on the bootstrap mode: a fresh node discovers peer
    snapshots, restores the newest one that passes certifier anchoring,
    and fast-syncs only the tail. `trust_height`/`trust_hash` pin the
    operator's known-good header (light-client subjective init) —
    REQUIRED in production; empty falls back to trusting the genesis
    validator set. `snapshot_interval` > 0 makes this node SERVE
    snapshots, taken every that many committed heights."""

    enable: bool = False
    trust_height: int = 0
    trust_hash: str = ""  # hex header hash at trust_height
    trust_period_s: float = 0.0  # 0 = no anchoring-header freshness check
    snapshot_interval: int = 0  # 0 = don't take/serve snapshots
    snapshot_keep_recent: int = 2
    # Blocks a snapshot-serving node keeps below its head: after each
    # snapshot the store prunes to head-retain_blocks+1 (0 = keep all).
    # Peers needing older history state-sync + fast-sync the tail.
    retain_blocks: int = 0
    chunk_size: int = 65536
    discovery_time_s: float = 3.0
    chunk_request_timeout_s: float = 10.0
    chunk_inflight_per_peer: int = 4
    giveup_time_s: float = 45.0  # then fall back to plain fast-sync


@dataclass
class ReplicaConfig:
    """Stateless read-replica mode (`tendermint_tpu/lightclient/`).

    `enable` turns the node into a replica: it bootstraps like any
    fresh node (statesync when `[statesync] enable` is set, else
    fast-sync from genesis), NEVER joins consensus (no ConsensusState,
    no validator key use), follows the chain via a follow-mode
    fast-sync tail plus the 0x68 FullCommit subscription, and serves
    light-client queries (FullCommits, commits, merkle-proof-carrying
    reads). Replicas certify every pushed FullCommit through a
    bisecting light-client pin before serving it — a forged push is
    scored + turned into evidence, never trusted.

    `fullcommit_cache_size` bounds the certified-commit cache (0 =
    unbounded); `serve_lightclient` keeps the serving half on for
    non-replica nodes too (every full node serves 0x68 by default)."""

    enable: bool = False
    fullcommit_cache_size: int = 2048
    serve_lightclient: bool = True


@dataclass
class MempoolConfig:
    """Reference `config/config.go:267-288` + the ingress pipeline
    (`mempool/ingress.py`): `lanes` shards the pool into tx-hash
    partitions (0 = env `TENDERMINT_TPU_MEMPOOL_LANES` or the built-in
    default), `ingress_batch` merges concurrent CheckTx arrivals into
    verify windows through the coalescer (`TENDERMINT_TPU_INGRESS_BATCH=0`
    overrides to the legacy synchronous path), `signed_txs` enables
    signed-envelope recognition — when on, the `0xED 0x01` tx prefix is
    reserved (see mempool/ingress.py); turn off for chains whose apps
    may emit payloads colliding with it (`TENDERMINT_TPU_SIGNED_TXS=0`
    overrides). All nodes of a chain must agree on `signed_txs`."""

    recheck: bool = True
    broadcast: bool = True
    wal_dir: str = "data/mempool.wal"
    cache_size: int = 100_000
    lanes: int = 0  # 0 = env/default (mempool.DEFAULT_LANES)
    ingress_batch: bool = True
    signed_txs: bool = True


@dataclass
class Config:
    home: str = "."
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    replica: ReplicaConfig = field(default_factory=ReplicaConfig)

    # -- derived paths -----------------------------------------------------

    def genesis_path(self) -> str:
        return os.path.join(self.home, self.base.genesis_file)

    def priv_validator_path(self) -> str:
        return os.path.join(self.home, self.base.priv_validator_file)

    def node_key_path(self) -> str:
        return os.path.join(self.home, "node_key.json")

    def db_path(self, name: str) -> str:
        return os.path.join(self.home, self.base.db_dir, f"{name}.db")

    def wal_path(self) -> str:
        return os.path.join(self.home, self.base.db_dir, "cs.wal")

    def evidence_wal_path(self) -> str:
        return os.path.join(self.home, self.base.db_dir, "evidence.wal")

    def mempool_wal_path(self) -> str:
        return os.path.join(self.home, self.mempool.wal_dir)

    @classmethod
    def default(cls, home: str = ".") -> "Config":
        return cls(home=home)

    @classmethod
    def test_config(cls, home: str = ".") -> "Config":
        """Shrunk timeouts, ephemeral ports (reference `TestConfig`)."""
        cfg = cls(home=home, consensus=ConsensusConfig.test_config())
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.p2p.pex_ensure_interval_s = 0.5
        cfg.statesync.discovery_time_s = 0.5
        cfg.statesync.chunk_request_timeout_s = 3.0
        cfg.statesync.giveup_time_s = 20.0
        return cfg


_SECTIONS = ("base", "rpc", "p2p", "mempool", "consensus", "statesync", "replica")


def write_config(cfg: Config) -> str:
    """Emit `$home/config.toml` (reference `config/toml.go`)."""
    lines = ["# tendermint_tpu configuration\n"]
    for section in _SECTIONS:
        sub = getattr(cfg, section)
        lines.append(f"[{section}]")
        for f in fields(sub):
            v = getattr(sub, f.name)
            if isinstance(v, bool):
                tv = "true" if v else "false"
            elif isinstance(v, (int, float)):
                tv = str(v)
            else:
                tv = '"%s"' % str(v).replace("\\", "\\\\").replace('"', '\\"')
            lines.append(f"{f.name} = {tv}")
        lines.append("")
    path = os.path.join(cfg.home, "config.toml")
    os.makedirs(cfg.home, exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    return path


def _parse_toml_subset(text: str) -> dict:
    """Parse exactly the dialect `write_config` emits ([section] headers,
    `key = true|false|int|float|"escaped string"` lines, # comments) —
    the stdlib `tomllib` only exists on Python 3.11+, and a node must
    still boot its own config files on 3.10 hosts."""
    doc: dict = {}
    section: dict | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = doc.setdefault(line[1:-1].strip(), {})
            continue
        if section is None or "=" not in line:
            continue
        key, _, val = (p.strip() for p in line.partition("="))
        if val.startswith('"') and val.endswith('"') and len(val) >= 2:
            body = val[1:-1]
            out, i = [], 0
            while i < len(body):
                if body[i] == "\\" and i + 1 < len(body):
                    out.append(body[i + 1])
                    i += 2
                else:
                    out.append(body[i])
                    i += 1
            section[key] = "".join(out)
        elif val in ("true", "false"):
            section[key] = val == "true"
        else:
            try:
                section[key] = int(val)
            except ValueError:
                try:
                    section[key] = float(val)
                except ValueError:
                    continue  # not our dialect: ignore the line
    return doc


def load_config(home: str) -> Config:
    """Defaults overlaid with `$home/config.toml` when present."""
    cfg = Config.default(home)
    path = os.path.join(home, "config.toml")
    if not os.path.exists(path):
        return cfg
    try:
        import tomllib  # Python 3.11+

        with open(path, "rb") as fh:
            doc = tomllib.load(fh)
    except ImportError:
        with open(path, "r") as fh:
            doc = _parse_toml_subset(fh.read())
    for section in _SECTIONS:
        sub = getattr(cfg, section)
        for f in fields(sub):
            if section in doc and f.name in doc[section]:
                setattr(sub, f.name, doc[section][f.name])
    return cfg
