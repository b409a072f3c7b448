"""The port's config, command line and replay console
(`tendermint_tpu_torch/{config,cmd,version,__main__}.py`,
`consensus/replay_console.py`) against the JAX package's.

The JAX package's own cases run again on the port: `tests/test_node.py`'s
`TestCLI` (`init`, `testnet`), `tests/test_replay_console.py` (`Playback`
over a recorded WAL: run all, step and back, the console's commands, the
`reset_priv_validator` / `reset_all` / `gen_validator` / `replay`
commands), `tests/test_rpc_client.py`'s `TestWALTools` and
`tests/test_wal_rotation.py::test_cut_wal_until_spans_segments`
(`wal2json`, `cut_wal_until`). The WAL is recorded by a solo port node
on the CPU (`device="cpu"`); the replay runs there too.

Across the packages: `write_config` emits byte-equal TOML and
`load_config` / `_parse_toml_subset` read equal `Config`s for the
default, test and an edited config; `init` and `testnet` homes of each
package load in the other (config, genesis, validator keys); `version`,
`reset_priv_validator`, `reset_all`, `wal2json` and `cut_wal_until`
give equal output on one home and one WAL, `gen_validator` the same
document shape and a key pair each package derives alike; `Playback`
over the recorded WAL reconstructs the same round states, blocks and
state JSON. Without a card, `node`, `replay` and `Node(cfg)` raise
unless given a device. Tolerance: exact.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
from contextlib import redirect_stdout

import pytest

from tendermint_tpu import cmd as J_cmd
from tendermint_tpu import config as J_config
from tendermint_tpu.consensus import replay_console as J_rc
from tendermint_tpu.db.kv import MemDB as JMemDB
from tendermint_tpu.types.genesis import GenesisDoc as JGenesisDoc
from tendermint_tpu.types.priv_validator import PrivValidatorFS as JPrivValidatorFS
from tendermint_tpu_torch import cmd as P_cmd
from tendermint_tpu_torch import config as P_config
from tendermint_tpu_torch.config import Config, load_config
from tendermint_tpu_torch.consensus.replay_console import Playback, make_replay_cs_factory
from tendermint_tpu_torch.consensus.wal import WAL, EndHeightMessage, MsgRecord
from tendermint_tpu_torch.db.kv import MemDB
from tendermint_tpu_torch.node import Node
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.priv_validator import PrivValidatorFS

CLI = {"jax": J_cmd.main, "port": P_cmd.main}
CONFIG = {"jax": J_config, "port": P_config}


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
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))


def _out(fn, *args) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(list(map(str, args)))
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def recorded_home(tmp_path_factory):
    """A solo port validator's home (on the CPU) whose WAL records at
    least 3 committed heights."""
    home = str(tmp_path_factory.mktemp("cli") / "rec")
    _out(P_cmd.main, "init", "--home", home, "--chain-id", "replay-test")
    cfg = Config.test_config(home)
    cfg.base.fast_sync = False
    node = Node(cfg, device="cpu")
    node.start()
    try:
        node.wait_height(3)
    finally:
        node.stop()
    return cfg


def _copy_home(cfg, dst) -> str:
    shutil.copytree(cfg.home, dst)
    return str(dst)


# -- tests/test_node.py TestCLI ----------------------------------------------------


class TestCLI:
    def test_init_creates_home(self, tmp_path):
        home = str(tmp_path / "home")
        assert _out(P_cmd.main, "init", "--home", home, "--chain-id", "cli-chain")[0] == 0
        for f in ("config.toml", "genesis.json", "priv_validator.json"):
            assert os.path.exists(os.path.join(home, f))
        cfg = load_config(home)
        assert cfg.base.moniker  # toml round-trips

    def test_testnet_generates_wired_homes(self, tmp_path):
        out = str(tmp_path / "net")
        assert _out(P_cmd.main, "testnet", "--n", "3", "--output", out, "--starting-port", "47000")[0] == 0
        gens = set()
        for i in range(3):
            cfg = load_config(os.path.join(out, f"node{i}"))
            assert cfg.p2p.seeds.count(":") == 2  # two peer addrs
            with open(os.path.join(out, f"node{i}", "genesis.json")) as f:
                gens.add(f.read())
        assert len(gens) == 1  # identical genesis everywhere

    def test_version_and_prog(self):
        assert _out(P_cmd.main, "version") == (0, "0.1.0\n")
        with pytest.raises(SystemExit):
            with redirect_stdout(io.StringIO()):
                P_cmd.main(["--help"])


# -- the config across the packages ------------------------------------------------


def _edited(cfg):
    cfg.base.moniker = 'quote " and \\ backslash'
    cfg.p2p.seeds = "127.0.0.1:1,127.0.0.1:2"
    cfg.p2p.send_rate = 1234
    cfg.consensus.timeout_commit = 250
    cfg.statesync.trust_period_s = 12.5
    cfg.replica.enable = True
    return cfg


@pytest.mark.parametrize("kind", ["default", "test", "edited"])
def test_write_config_is_byte_equal_and_loads_equal(tmp_path, kind):
    texts, loaded = {}, {}
    for pkg, mod in CONFIG.items():
        home = str(tmp_path / pkg)
        cfg = mod.Config.test_config(home) if kind == "test" else mod.Config.default(home)
        if kind == "edited":
            _edited(cfg)
        path = mod.write_config(cfg)
        with open(path, "rb") as f:
            texts[pkg] = f.read()
        loaded[pkg] = mod.load_config(home)
        assert dataclasses.asdict(loaded[pkg]) == dataclasses.asdict(cfg)
    assert texts["jax"] == texts["port"]
    for pkg in CONFIG:  # each package's file read by the other
        home = str(tmp_path / pkg)
        assert dataclasses.asdict(J_config.load_config(home)) == dataclasses.asdict(P_config.load_config(home))
    # the 3.10 fallback parser reads the same document in both packages
    text = texts["port"].decode()
    assert P_config._parse_toml_subset(text) == J_config._parse_toml_subset(text)


def test_test_config_keeps_secret_connections():
    """Declared difference: the port's test config keeps SecretConnections
    on, its cipher being its own; the JAX one keeps them while
    `cryptography` is importable, as it is here."""
    assert Config.test_config().p2p.secret_connections
    assert J_config.Config.test_config().p2p.secret_connections


@pytest.mark.parametrize("maker,reader", [("jax", "port"), ("port", "jax")])
def test_homes_load_in_the_other_package(tmp_path, maker, reader):
    home, net = str(tmp_path / "home"), str(tmp_path / "net")
    assert _out(CLI[maker], "init", "--home", home, "--chain-id", "cross")[0] == 0
    assert _out(CLI[maker], "testnet", "--n", "2", "--output", net, "--starting-port", "47100")[0] == 0
    gen_cls = {"jax": JGenesisDoc, "port": GenesisDoc}
    pv_cls = {"jax": JPrivValidatorFS, "port": PrivValidatorFS}
    for h in (home, os.path.join(net, "node0"), os.path.join(net, "node1")):
        mine, theirs = CONFIG[maker].load_config(h), CONFIG[reader].load_config(h)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        g_mine = gen_cls[maker].from_file(mine.genesis_path())
        g_theirs = gen_cls[reader].from_file(theirs.genesis_path())
        assert g_theirs.chain_id == g_mine.chain_id and g_theirs.genesis_time == g_mine.genesis_time
        assert g_theirs.validator_set().hash() == g_mine.validator_set().hash()
        pv_mine, pv_theirs = pv_cls[maker].load(mine.priv_validator_path()), pv_cls[reader].load(h + "/priv_validator.json")
        assert pv_theirs.pub_key.data == pv_mine.pub_key.data and pv_theirs.address == pv_mine.address
    assert _out(CLI[reader], "show_validator", "--home", home) == _out(CLI[maker], "show_validator", "--home", home)


def test_gen_validator_documents_agree():
    """Fresh keys each call: the documents have one shape, and each
    package derives the same public key and address from a seed."""
    from tendermint_tpu.crypto import PrivKey as JPrivKey
    from tendermint_tpu_torch.crypto import PrivKey

    docs = {pkg: json.loads(_out(fn, "gen_validator")[1]) for pkg, fn in CLI.items()}
    assert sorted(docs["jax"]) == sorted(docs["port"])
    for doc in docs.values():
        assert doc["last_height"] == 0 and len(bytes.fromhex(doc["pub_key"])) == 32
        seed = bytes.fromhex(doc["priv_key_seed"])
        for cls in (JPrivKey, PrivKey):
            assert cls(seed).pub_key.data.hex() == doc["pub_key"]
            assert cls(seed).pub_key.address.hex() == doc["address"]


def test_reset_commands_leave_equal_homes(recorded_home, tmp_path):
    homes = {pkg: _copy_home(recorded_home, tmp_path / pkg) for pkg in CLI}
    for cmd in ("reset_priv_validator", "reset_all"):
        outs = {pkg: _out(fn, cmd, "--home", homes[pkg]) for pkg, fn in CLI.items()}
        assert outs["jax"][0] == outs["port"][0] == 0
        assert outs["jax"][1].replace(homes["jax"], "H") == outs["port"][1].replace(homes["port"], "H")
        for name in ("priv_validator.json",):
            with open(os.path.join(homes["jax"], name), "rb") as a, open(os.path.join(homes["port"], name), "rb") as b:
                assert a.read() == b.read()
        assert sorted(os.listdir(homes["jax"])) == sorted(os.listdir(homes["port"]))


def test_wal_tools_give_equal_output(recorded_home, tmp_path):
    wal = recorded_home.wal_path()
    dumps = {pkg: _out(fn, "wal2json", wal) for pkg, fn in CLI.items()}
    assert dumps["jax"] == dumps["port"] and dumps["port"][0] == 0
    cut = {}
    for pkg, fn in CLI.items():
        out = str(tmp_path / f"{pkg}.wal")
        assert _out(fn, "cut_wal_until", wal, "2", out)[0] == 0
        with open(out, "rb") as f:
            cut[pkg] = f.read()
    assert cut["jax"] == cut["port"] and cut["port"]


def test_playback_reconstructs_equal_states_in_both_packages(recorded_home):
    """One recorded WAL through each package's `Playback` (fresh
    in-memory stores): the same round state after every tenth record,
    and the same blocks and state JSON at the end."""
    wal = recorded_home.wal_path()
    jpb = J_rc.Playback(J_rc.make_replay_cs_factory(recorded_home, db_provider=lambda name: JMemDB()), wal,
                        out=lambda _line: None)
    ppb = Playback(make_replay_cs_factory(recorded_home, db_provider=lambda name: MemDB(), device="cpu"), wal,
                   out=lambda _line: None)
    assert len(jpb.records) == len(ppb.records) > 0
    while not ppb.done():
        assert jpb.step(10) == ppb.step(10)
        assert jpb.round_state("short") == ppb.round_state("short")
    assert jpb.cs.state.to_json() == ppb.cs.state.to_json()
    assert jpb.cs.block_store.height == ppb.cs.block_store.height >= 3
    for h in range(1, ppb.cs.block_store.height + 1):
        assert jpb.cs.block_store.load_block(h).hash() == ppb.cs.block_store.load_block(h).hash()


# -- tests/test_replay_console.py ----------------------------------------------------


def _factory(cfg):
    # fresh in-memory stores per reset: the replay reconstructs the
    # chain from the WAL alone, leaving the recorded home untouched
    return make_replay_cs_factory(cfg, db_provider=lambda name: MemDB(), device="cpu")


class TestPlayback:
    def test_run_all_reconstructs_chain_from_wal(self, recorded_home):
        pb = Playback(_factory(recorded_home), recorded_home.wal_path())
        assert len(pb.records) > 0
        applied = pb.run_all()
        assert applied == len(pb.records)
        assert pb.cs.state.last_block_height >= 3
        assert pb.cs.block_store.height >= 3

    def test_step_and_back(self, recorded_home):
        pb = Playback(_factory(recorded_home), recorded_home.wal_path())
        total = len(pb.records)
        assert pb.step(5) == 5
        assert pb.count == 5
        h5 = pb.cs.get_round_state().height
        pb.back(2)
        assert pb.count == 3
        pb.step(2)
        assert pb.count == 5
        assert pb.cs.get_round_state().height == h5
        assert pb.step(total) == total - 5  # clamped at EOF
        assert pb.done()

    def test_console_commands(self, recorded_home):
        out: list[str] = []
        pb = Playback(_factory(recorded_home), recorded_home.wal_path(), out=out.append)
        script = iter(["next", "next 3", "n", "rs short", "back 1", "rs", "bogus", "quit"])
        pb.console(input_fn=lambda _prompt: next(script))
        assert pb.count == 3  # 1 + 3 - 1
        assert any("unknown command" in line for line in out)
        assert any("/" in line for line in out)  # rs short prints h/r/step

    def test_cli_reset_and_gen_validator(self, recorded_home, tmp_path):
        home = _copy_home(recorded_home, tmp_path / "copy")
        cfg = Config.test_config(home)
        pv_before = PrivValidatorFS.load(cfg.priv_validator_path())
        assert pv_before._last.height > 0  # the recorder signed blocks

        assert _out(P_cmd.main, "reset_priv_validator", "--home", home)[0] == 0
        pv = PrivValidatorFS.load(cfg.priv_validator_path())
        assert pv._last.height == 0
        assert pv.pub_key.data == pv_before.pub_key.data  # key survives

        assert _out(P_cmd.main, "reset_all", "--home", home)[0] == 0
        assert not os.path.exists(cfg.db_path("state"))
        assert os.path.exists(cfg.priv_validator_path())

        rc, text = _out(P_cmd.main, "gen_validator")
        doc = json.loads(text)
        assert rc == 0 and len(bytes.fromhex(doc["pub_key"])) == 32
        assert doc["last_height"] == 0

    def test_cli_replay_command(self, recorded_home, tmp_path):
        # CLI batch replay over a COPY of the home (replay writes through
        # the real stores, same as the reference console)
        copy = _copy_home(recorded_home, tmp_path / "copy")
        shutil.rmtree(os.path.join(copy, "data"))
        os.makedirs(os.path.join(copy, "data"))
        shutil.copy(recorded_home.wal_path(), os.path.join(copy, "data", "cs.wal"))
        rc, text = _out(P_cmd.main, "replay", "--home", copy, "--device", "cpu")
        assert rc == 0
        assert "replayed" in text


# -- no card: the node and the replay raise unless given a device -------------------


def test_node_without_a_device_raises_here(recorded_home, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    home = _copy_home(recorded_home, tmp_path / "copy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P_cmd.main(["node", "--home", home])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node(Config.test_config(home))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P_cmd.main(["replay", "--home", home])


# -- tests/test_rpc_client.py TestWALTools, tests/test_wal_rotation.py ---------------


def test_wal2json_and_cut(recorded_home, tmp_path):
    wal = recorded_home.wal_path()
    rc, text = _out(P_cmd.main, "wal2json", wal)
    assert rc == 0
    lines = [json.loads(line) for line in text.strip().splitlines()]
    kinds = {rec["type"] for rec in lines}
    assert "end_height" in kinds and "msg" in kinds
    heights = [r["height"] for r in lines if r["type"] == "end_height"]
    assert max(heights) >= 2

    out = str(tmp_path / "cut.wal")
    assert _out(P_cmd.main, "cut_wal_until", wal, "2", out)[0] == 0
    rc, text = _out(P_cmd.main, "wal2json", out)
    cut_lines = [json.loads(line) for line in text.strip().splitlines()]
    assert all(rec.get("height", 0) < 2 or rec["type"] == "round_state" for rec in cut_lines), cut_lines


def _vote(height):
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.part_set import PartSetHeader
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PREVOTE, Vote

    return Vote(
        validator_address=b"\x01" * 20,
        validator_index=0,
        height=height,
        round=0,
        timestamp=1000,
        type=VOTE_TYPE_PREVOTE,
        block_id=BlockID(b"\x02" * 32, PartSetHeader(total=1, hash=b"\x03" * 20)),
        signature=b"\x04" * 64,
    )


def test_cut_wal_until_spans_segments(tmp_path):
    path = str(tmp_path / "cs.wal")
    wal = WAL(path, max_file_bytes=200, max_segments=100)
    for h in range(1, 10):
        wal.save(MsgRecord(_vote(h), "p"))
        wal.save(EndHeightMessage(h))
    wal.close()
    assert len(WAL.segment_paths(path)) > 2
    out = str(tmp_path / "cut.wal")
    assert _out(P_cmd.main, "cut_wal_until", path, "4", out)[0] == 0
    heights = [r.height for r in WAL.iter_records(out) if isinstance(r, EndHeightMessage)]
    assert heights == [1, 2, 3]  # everything at/after height 4 cut
    # the JAX command cuts the port's segments to the same bytes
    jout = str(tmp_path / "jcut.wal")
    assert _out(J_cmd.main, "cut_wal_until", path, "4", jout)[0] == 0
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
