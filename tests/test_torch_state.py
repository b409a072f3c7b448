"""The port's db, in-process abci and state against the JAX package's.

The JAX package's own scenarios (`tests/test_state.py`: the DB backends,
the apps, the genesis state, `apply_block` over real commits, validator
changes, `ABCIResponses`, the fail points) run again on
`tendermint_tpu_torch.{db,abci,state}` through the port's `ChainSim`
(`tendermint_tpu_torch.testing`). A seeded differential drives one chain
through both packages' `ChainSim` (random txs, a validator-set change,
evidence) and requires byte-equal blocks, state JSON, app hashes, ABCI
responses, tx-index entries, historical validator sets and DB contents
at every height. The outcome matrix of `validate_block` (wrong chain id,
height, last block id, app hash, validators hash; signatures at height
1; a wrong commit size; a forged precommit; too many, expired, future and
forged evidence) requires the JAX outcome, compared as the exception's
class name and message, through the port's host verifier and
`default_verifier(device="cpu")` at the default minimum batch and at 0.

Objects cross from the JAX package to the port by their wire or JSON
form only: blocks and evidence by `encode()`, states by `to_json()`.
`verifier=None` is the port's card stack and raises without a card.
Everything is exact.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tendermint_tpu import state as J_state
from tendermint_tpu import types as J
from tendermint_tpu.abci.apps import PersistentKVStoreApp as JPersistentKVStoreApp
from tendermint_tpu.crypto.keys import gen_priv_key as j_gen_priv_key
from tendermint_tpu.db.kv import MemDB as JMemDB
from tendermint_tpu.services.verifier import HostBatchVerifier as JHostVerifier
from tendermint_tpu.state.txindex import KVTxIndexer as JKVTxIndexer
from tendermint_tpu.types import evidence as J_evidence
from tendermint_tpu_torch import types as P
from tendermint_tpu_torch.abci.apps import CounterApp, KVStoreApp, PersistentKVStoreApp
from tendermint_tpu_torch.abci.client import local_client_creator
from tendermint_tpu_torch.abci.types import CodeType
from tendermint_tpu_torch.crypto.keys import gen_priv_key
from tendermint_tpu_torch.db.kv import MemDB, SQLiteDB, db_provider
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.services.batcher import CoalescingVerifier
from tendermint_tpu_torch.state import State, apply_block, load_state, make_genesis_state, validate_block
from tendermint_tpu_torch.state.state import ABCIResponses
from tendermint_tpu_torch.state.txindex import KVTxIndexer, NullTxIndexer
from tendermint_tpu_torch.testing import ChainSim, lockrank_report, make_genesis, time_limit_fixture
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.evidence import decode_evidence
from tendermint_tpu_torch.types.tx import tx_hash
from tendermint_tpu_torch.utils import fail

from tests.helpers import ChainSim as JChainSim

torch.set_num_threads(1)

HOST = V.HostBatchVerifier()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def outcome(fn):
    """None, or the raised exception as (class name, message)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is part of what is compared
        return type(e).__name__, str(e)
    return None


# -- the bridge: JAX objects into the port by their wire or JSON form --------


def p_block(b):
    return P.Block.decode(b.encode())


def p_state(st, db=None):
    return State.from_json(st.to_json(), db=db)


# -- tests/test_state.py ------------------------------------------------------


class TestDB:
    def test_memdb_roundtrip_and_prefix_iterate(self):
        db = MemDB()
        db.set(b"a:1", b"x")
        db.set(b"a:2", b"y")
        db.set(b"b:1", b"z")
        assert db.get(b"a:1") == b"x"
        assert db.get(b"missing") is None
        assert list(db.iterate(b"a:")) == [(b"a:1", b"x"), (b"a:2", b"y")]
        db.delete(b"a:1")
        assert not db.has(b"a:1")

    def test_sqlite_roundtrip_persistence(self, tmp_path):
        path = str(tmp_path / "kv.db")
        db = SQLiteDB(path)
        db.set(b"k1", b"v1")
        db.set_sync(b"k2", b"v2")
        db.delete(b"k1")
        db.close()
        db2 = SQLiteDB(path)
        assert db2.get(b"k1") is None
        assert db2.get(b"k2") == b"v2"
        assert list(db2.iterate()) == [(b"k2", b"v2")]
        db2.close()

    def test_sqlite_prefix_iterate_and_provider(self, tmp_path):
        db = db_provider("state", "sqlite", str(tmp_path / "data"))
        for k in (b"a\xff", b"a\xff\x01", b"b", b"a\x01"):
            db.set(k, k)
        assert [k for k, _ in db.iterate(b"a\xff")] == [b"a\xff", b"a\xff\x01"]
        assert [k for k, _ in db.iterate(b"a")] == [b"a\x01", b"a\xff", b"a\xff\x01"]
        db.close()
        assert os.path.exists(tmp_path / "data" / "state.db")
        assert isinstance(db_provider("x", "memdb", ""), MemDB)
        with pytest.raises(ValueError, match="unknown db backend"):
            db_provider("x", "leveldb", "")

    def test_sqlite_reads_what_the_jax_package_wrote(self, tmp_path):
        """One file, both packages: the same table, keys and order."""
        from tendermint_tpu.db.kv import SQLiteDB as JSQLiteDB

        path = str(tmp_path / "shared.db")
        rng = np.random.default_rng(3)
        items = {bytes(rng.integers(0, 256, 1 + i % 9, dtype=np.uint8)): bytes([i]) * i for i in range(40)}
        jdb = JSQLiteDB(path)
        for k, v in items.items():
            jdb.set(k, v)
        jdb.close()
        db = SQLiteDB(path)
        assert list(db.iterate()) == sorted(items.items())
        db.close()


class TestApps:
    def test_kvstore(self):
        app = KVStoreApp()
        conns = local_client_creator(app)()
        assert conns.mempool.check_tx_async(b"name=satoshi").is_ok
        conns.consensus.deliver_tx_async(b"name=satoshi")
        h1 = conns.consensus.commit_sync().data
        assert h1 != b""
        q = conns.query.query_sync("/key", b"name")
        assert q.value == b"satoshi"
        conns.consensus.deliver_tx_async(b"other=thing")
        assert conns.consensus.commit_sync().data != h1

    def test_counter_serial_nonce(self):
        app = CounterApp(serial=True)
        conns = local_client_creator(app)()
        assert conns.consensus.deliver_tx_async(b"\x00").is_ok
        res = conns.consensus.deliver_tx_async(b"\x00")
        assert res.code == CodeType.BAD_NONCE
        assert conns.consensus.deliver_tx_async(b"\x01").is_ok
        assert conns.mempool.check_tx_async(b"\x00").code == CodeType.BAD_NONCE
        assert conns.mempool.check_tx_async(b"\x05").is_ok  # check allows >=

    def test_persistent_kvstore_reload(self):
        db = MemDB()
        app = PersistentKVStoreApp(db)
        app.deliver_tx(b"k=v")
        app.end_block(3)
        app.commit()
        app2 = PersistentKVStoreApp(db)
        assert app2.info().last_block_height == 3
        assert app2.query("/key", b"k").value == b"v"

    @pytest.mark.parametrize("app_name", ["kvstore", "persistent", "counter", "counter_loose"])
    def test_app_results_match_the_jax_package(self, app_name):
        """A seeded stream of txs (key=value, bare, val:, malformed val:,
        nonces) through both packages' apps: every result, info, query
        and app hash, and the persisted state and snapshot bytes."""
        from tendermint_tpu.abci import apps as JA

        rng = np.random.default_rng(17)
        make = {
            "kvstore": lambda m: m.KVStoreApp(),
            "persistent": lambda m: m.PersistentKVStoreApp(),
            "counter": lambda m: m.CounterApp(serial=True),
            "counter_loose": lambda m: m.CounterApp(serial=False),
        }[app_name]
        import tendermint_tpu_torch.abci.apps as PA

        japp, papp = make(JA), make(PA)
        pub = gen_priv_key(b"\x42" * 32).pub_key.data.hex().encode()
        for height in range(1, 5):
            for i in range(int(rng.integers(0, 9))):
                kind = int(rng.integers(0, 6))
                if kind == 0:
                    tx = b"val:" + pub + b"/%d" % int(rng.integers(0, 20))
                elif kind == 1:
                    tx = b"val:zz/notanumber"
                elif kind == 2:
                    tx = (i + height * 3).to_bytes(int(rng.integers(1, 10)), "big")
                else:
                    tx = bytes(rng.integers(97, 123, int(rng.integers(1, 12)), dtype=np.uint8))
                    if kind == 3:
                        tx += b"=" + bytes(rng.integers(48, 58, 3, dtype=np.uint8))
                assert repr(papp.check_tx(tx)) == repr(japp.check_tx(tx))
                assert repr(papp.deliver_tx(tx)) == repr(japp.deliver_tx(tx))
            assert repr(papp.end_block(height)) == repr(japp.end_block(height))
            assert repr(papp.commit()) == repr(japp.commit())
            assert repr(papp.info()) == repr(japp.info())
            for path, data in (("/key", b"a"), ("hash", b""), ("tx", b""), ("nope", b"")):
                assert repr(papp.query(path, data)) == repr(japp.query(path, data))
            assert papp.snapshot_state() == japp.snapshot_state()
        if app_name == "persistent":
            assert list(papp._db.iterate()) == list(japp._db.iterate())
            fresh, jfresh = PA.PersistentKVStoreApp(), JA.PersistentKVStoreApp()
            fresh.restore_state(papp.snapshot_state())
            jfresh.restore_state(japp.snapshot_state())
            assert repr(fresh.commit()) == repr(jfresh.commit())

    def test_begin_block_evidence_only_to_apps_that_take_it(self):
        seen = []

        class Legacy(KVStoreApp):
            def begin_block(self, block_hash, header):
                seen.append(("legacy", block_hash))

        class Slasher(KVStoreApp):
            def begin_block(self, block_hash, header, evidence=()):
                seen.append(("slasher", list(evidence)))

        for app in (Legacy(), Slasher()):
            local_client_creator(app)().consensus.begin_block_sync(b"h", None, evidence=["ev"])
        assert seen == [("legacy", b"h"), ("slasher", ["ev"])]


class TestGenesisState:
    def test_make_save_load_roundtrip(self):
        db = MemDB()
        gen, _ = make_genesis(4)
        st = make_genesis_state(db, gen)
        assert st.last_block_height == 0
        assert st.validators.size() == 4
        assert st.last_validators.size() == 0
        st.save()
        st2 = load_state(db)
        assert st2 is not None and st2.equals(st)

    def test_load_missing_returns_none(self):
        assert load_state(MemDB()) is None

    def test_genesis_state_matches_the_jax_package(self):
        from tests.helpers import make_genesis as j_make_genesis

        jdb, db = JMemDB(), MemDB()
        jst = J_state.make_genesis_state(jdb, j_make_genesis(5)[0])
        st = make_genesis_state(db, make_genesis(5)[0])
        jst.save()
        st.save()
        assert st.to_json() == jst.to_json()
        assert list(db.iterate()) == list(jdb.iterate())
        assert p_state(jst).to_json() == jst.to_json()


class TestApplyBlock:
    def test_three_heights_with_real_commits(self):
        sim = ChainSim(n_vals=4, verifier=HOST)
        sim.advance(txs=[b"a=1"])
        assert sim.state.last_block_height == 1
        app_hash_1 = sim.state.app_hash
        assert app_hash_1 != b""
        sim.advance(txs=[b"b=2"])
        app_hash_2 = sim.state.app_hash
        assert app_hash_2 != app_hash_1
        sim.advance()
        assert sim.state.last_block_height == 3
        assert sim.state.app_hash == app_hash_2  # height-3 block had no txs
        assert sim.state.last_validators.hash() == sim.state.validators.hash()
        # state persisted each height
        st = load_state(sim.db)
        assert st.last_block_height == 3

    def test_validate_block_rejections(self):
        sim = ChainSim(n_vals=4, verifier=HOST)
        sim.advance()
        block, ps = sim.make_next_block()
        block.header.height += 1  # wrong height
        with pytest.raises(ValidationError, match="wrong height"):
            validate_block(sim.state, block, HOST)

        block2, _ = sim.make_next_block()
        block2.header.app_hash = b"\x01" * 20
        block2.header.data_hash = b""  # force refill? header already filled
        with pytest.raises(ValidationError, match="app_hash"):
            validate_block(sim.state, block2, HOST)

    def test_bad_last_commit_signature_rejected(self):
        sim = ChainSim(n_vals=4, verifier=HOST)
        sim.advance()
        # tamper a commit signature, then try to apply height 2
        block, ps = sim.make_next_block()
        pc = block.last_commit.precommits[0]
        object.__setattr__(pc, "signature", bytes(64))
        block.header.last_commit_hash = b""
        block.fill_header()
        with pytest.raises(ValidationError):
            validate_block(sim.state, block, HOST)

    def test_tx_indexer_batch(self):
        db = MemDB()
        sim = ChainSim(n_vals=4, verifier=HOST)
        idx = KVTxIndexer(db)
        sim.advance(txs=[b"k1=v1", b"k2=v2"], tx_indexer=idx)
        tr = idx.get(tx_hash(b"k1=v1"))
        assert tr is not None and tr.height == 1 and tr.index == 0
        assert idx.get(b"\x00" * 20) is None
        null = NullTxIndexer()
        null.add_batch(sim.blocks[0], sim.state.load_abci_responses(1))
        assert null.get(tx_hash(b"k1=v1")) is None

    def test_failed_verify_leaves_state_and_app_untouched(self):
        """A forged last commit raises before any execution effect."""
        app = PersistentKVStoreApp(MemDB())
        sim = ChainSim(n_vals=4, app=app, verifier=HOST)
        sim.advance(txs=[b"a=1"])
        before, app_before = sim.state.to_json(), app.snapshot_state()
        block, ps = sim.make_next_block(txs=[b"b=2"])
        pc = block.last_commit.precommits[2]
        object.__setattr__(pc, "signature", bytes(64))
        block.header.last_commit_hash = b""
        block.fill_header()
        with pytest.raises(ValidationError, match="invalid commit signature from validator 2"):
            apply_block(sim.state, block, ps.header, sim.conns.consensus, verifier=HOST)
        assert sim.state.to_json() == before and app.snapshot_state() == app_before
        assert sim.state.load_abci_responses(2) is None


class TestValidatorChanges:
    def test_end_block_diffs_rotate_in(self):
        db = MemDB()
        sim = ChainSim(n_vals=4, app=PersistentKVStoreApp(db), verifier=HOST)
        new_key = gen_priv_key(b"\x99" * 32)
        hash_before = sim.state.validators.hash()
        sim.advance(txs=[b"val:" + new_key.pub_key.data.hex().encode() + b"/7"])
        # the diff applies to the validator set for the next height
        assert sim.state.validators.size() == 5
        assert sim.state.last_validators.hash() == hash_before
        assert sim.state.last_height_validators_changed == 2
        _, v = sim.state.validators.get_by_address(new_key.pub_key.address)
        assert v is not None and v.voting_power == 7

    def test_historical_validators_with_compression(self):
        sim = ChainSim(n_vals=3, verifier=HOST)
        for _ in range(4):
            sim.advance()
        vs1 = sim.state.load_validators(1)
        vs4 = sim.state.load_validators(4)
        assert vs1.hash() == vs4.hash() == sim.state.validators.hash()
        with pytest.raises(ValidationError):
            sim.state.load_validators(99)

    def test_set_change_prebuilds_the_next_sets_tables(self, monkeypatch):
        """On the port's stack a set change starts the next set's table
        build (`prebuild`), and the next height's commit, signed by the new
        set, verifies on those tables."""
        # a stack of this test's own: it sets the minimum batch to 0 and
        # closes the stack, which the process-wide one must not be left as
        monkeypatch.setattr(V, "_DEFAULTS", {})
        stack = V.default_verifier(device="cpu")
        try:
            stack.inner.primary._min_batch = 0
            # the commits are made on the host; the chain applies on the stack
            sim = ChainSim(n_vals=3, app=PersistentKVStoreApp(MemDB()), verifier=HOST)
            sim.advance(verifier=stack)
            priv = P.PrivValidator(gen_priv_key(b"\x77" * 32))
            sim.privs.append(priv)
            sim.advance(txs=[b"val:" + priv.pub_key.data.hex().encode() + b"/10"], verifier=stack)
            backend = stack.inner.primary
            want = tuple(v.pub_key.data for v in sim.state.validators)
            deadline = time.monotonic() + 60
            while backend._prebuilds and time.monotonic() < deadline:
                time.sleep(0.01)
            assert backend._cache_key(want) in backend._tables
            sim.advance(verifier=stack)
            sim.advance(verifier=stack)
            assert sim.state.last_block_height == 4
            snap = stack.inner.snapshot()
            assert snap["fallback_calls"] == 0 and snap["total_failures"] == 0
        finally:
            stack.close()


class TestABCIResponses:
    def test_save_load(self):
        sim = ChainSim(n_vals=4, verifier=HOST)
        sim.advance(txs=[b"x=y"])
        res = sim.state.load_abci_responses(1)
        assert res is not None
        assert res.height == 1 and len(res.deliver_tx) == 1
        assert res.deliver_tx[0].is_ok
        assert sim.state.load_abci_responses(9) is None

    def test_json_roundtrip_against_the_jax_package(self):
        from tendermint_tpu.abci.types import Result as JResult
        from tendermint_tpu.abci.types import Validator as JValidator
        from tendermint_tpu.state.state import ABCIResponses as JABCIResponses

        rng = np.random.default_rng(5)
        jres = JABCIResponses(
            height=9,
            deliver_tx=[JResult(int(rng.integers(0, 6)), bytes(rng.integers(0, 256, i, dtype=np.uint8)), f"log {i} é")
                        for i in range(7)],
            end_block_changes=[JValidator(bytes(rng.integers(0, 256, 32, dtype=np.uint8)), i) for i in range(3)],
        )
        raw = jres.to_json()
        res = ABCIResponses.from_json(raw)
        assert res.to_json() == raw
        assert JABCIResponses.from_json(res.to_json()) == jres


class TestFailPoints:
    SCRIPT = (
        "import sys; sys.path.insert(0, %r)\n"
        "from tendermint_tpu_torch.services.verifier import HostBatchVerifier\n"
        "from tendermint_tpu_torch.testing import ChainSim\n"
        "from tendermint_tpu_torch.utils import lockrank\n"
        "sim = ChainSim(n_vals=2, verifier=HostBatchVerifier())\n"
        "sim.advance(txs=[b'a=1'])\n"
        "assert not lockrank.drain()\n"
        "assert 'jax' not in sys.modules and 'tendermint_tpu' not in sys.modules\n"
        "print('SURVIVED')\n"
    )

    def test_fail_index_kills_process_at_each_point(self, tmp_path):
        script = tmp_path / "crash.py"
        script.write_text(self.SCRIPT % REPO)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("FAIL_TEST_SOFT", None)
        # 4 fail points in apply_block: indices 0..3 must die, 4 survives
        for idx in range(4):
            env["FAIL_TEST_INDEX"] = str(idx)
            p = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, text=True, timeout=120)
            assert p.returncode == 1, (idx, p.stdout, p.stderr)
            assert "SURVIVED" not in p.stdout
            assert f"FAIL_TEST_INDEX={idx}: exiting at fail point" in p.stderr
        env["FAIL_TEST_INDEX"] = "4"
        p = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, text=True, timeout=120)
        assert p.returncode == 0 and "SURVIVED" in p.stdout, p.stderr

    def test_soft_fail_raises_simulated_crash_at_each_point(self, monkeypatch):
        """FAIL_TEST_SOFT: the crash is a `SimulatedCrash` (past `except
        Exception`), and the persisted state is the step's: the responses
        are saved from the third point on, the app hash only at the last."""
        monkeypatch.setenv("FAIL_TEST_SOFT", "1")
        saved = []
        for idx in range(4):
            monkeypatch.setenv("FAIL_TEST_INDEX", str(idx))
            fail.reset_for_testing()
            sim = ChainSim(n_vals=2, verifier=HOST)
            with pytest.raises(fail.SimulatedCrash, match=f"FAIL_TEST_INDEX={idx}"):
                try:
                    sim.advance(txs=[b"a=1"])
                except Exception:  # noqa: BLE001 - must not catch the crash
                    pytest.fail("SimulatedCrash was caught as an Exception")
            saved.append((sim.state.load_abci_responses(1) is not None, load_state(sim.db).last_block_height))
        fail.reset_for_testing()
        assert saved == [(False, 0), (False, 0), (True, 0), (True, 0)]
        assert not issubclass(fail.SimulatedCrash, Exception)


# -- the seam: verifier=None is the card's stack ----------------------------


def test_missing_verifier_is_the_card_stack_and_raises_without_a_card(monkeypatch):
    """`apply_block(..., verifier=None)` reaches the port's
    `default_verifier()`: without a card it raises before any effect,
    and does not answer on the host. `hasher=None` is the host tree."""
    sim = ChainSim(n_vals=4, app=PersistentKVStoreApp(MemDB()), verifier=HOST)
    sim.advance(txs=[b"a=1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(V, "_DEFAULTS", {})
    before, app_before = sim.state.to_json(), sim.app.snapshot_state()
    block, ps = sim.make_next_block(txs=[b"b=2"])
    for call in (
        lambda: apply_block(sim.state, block, ps.header, sim.conns.consensus),
        lambda: apply_block(sim.state, block, ps.header, sim.conns.consensus, verifier=None, hasher=None),
        lambda: validate_block(sim.state, block),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()
    assert sim.state.to_json() == before and sim.app.snapshot_state() == app_before
    assert V._DEFAULTS == {}
    # with the verifier given, the same block applies
    apply_block(sim.state, block, ps.header, sim.conns.consensus, verifier=HOST)
    assert sim.state.last_block_height == 2


# -- the port's chain against the JAX package's ------------------------------


@pytest.fixture(scope="module")
def stacks():
    """The port's default stack on the CPU at the default minimum batch
    and at 0 (the plain torch chains and ladder)."""
    saved = dict(V._DEFAULTS)
    out = {}
    for name, min_batch in (("port-stack", None), ("port-chains", 0)):
        V._DEFAULTS.clear()
        stack = V.default_verifier(device="cpu")
        if min_batch is not None:
            stack.inner.primary._min_batch = min_batch
        out[name] = stack
    V._DEFAULTS.clear()
    V._DEFAULTS.update(saved)
    yield out
    for stack in out.values():
        stack.close()


def _port_verifiers(stacks):
    """(name, verifier, coalescer to close): the port's host verifier, and
    a fresh coalescer (an empty signature cache) over each stack."""
    yield "port-host", HOST, None
    for name, stack in stacks.items():
        v = CoalescingVerifier(stack.inner)
        yield name, v, v


def _byzantine(priv, height, tag, chain_id, pkg):
    """A prevote signed past the double-sign guard."""
    vote = pkg.Vote(validator_address=priv.address, validator_index=0, height=height, round=0, timestamp=1000,
                    type=pkg.VOTE_TYPE_PREVOTE, block_id=pkg.BlockID(bytes([tag]) * 32, pkg.PartSetHeader.zero()))
    return vote.with_signature(priv._signer.sign(vote.sign_bytes(chain_id)))


def _j_evidence(priv, height, chain_id="test-chain", forged=False):
    a = _byzantine(priv, height, 0xA1, chain_id, J)
    b = _byzantine(priv, height, 0xB2, chain_id, J)
    if forged:
        b = b.with_signature(bytes(64))
    return J_evidence.DuplicateVoteEvidence.make(a, b)


@pytest.mark.parametrize("verifier_name", ["port-host", "port-chains"])
def test_chain_matches_the_jax_package(stacks, verifier_name, monkeypatch):
    """One seeded chain of 7 heights through both packages' `ChainSim`:
    random txs, a validator joining at height 2 (power 7) and one leaving
    at height 4, evidence at height 5. Byte-equal at every height:
    blocks and their hashes, state JSON, app hashes, ABCI responses,
    tx-index entries, historical validator sets, and every key of the
    state, app and index DBs."""
    monkeypatch.setattr(time, "time_ns", lambda: 1_750_000_000_000_000_000)
    verifier = HOST if verifier_name == "port-host" else CoalescingVerifier(stacks[verifier_name].inner)
    rng = np.random.default_rng(2026)
    jsim = JChainSim(n_vals=4, app=JPersistentKVStoreApp(JMemDB()))
    # the commits are made on the host; the chain applies on `verifier`
    psim = ChainSim(n_vals=4, app=PersistentKVStoreApp(MemDB()), verifier=HOST)
    jidx, pidx = JKVTxIndexer(JMemDB()), KVTxIndexer(MemDB())
    jnew, pnew = J.PrivValidator(j_gen_priv_key(b"\x55" * 32)), P.PrivValidator(gen_priv_key(b"\x55" * 32))
    assert jnew.address == pnew.address
    all_txs = []
    try:
        for height in range(1, 8):
            txs = [b"k%d=%s" % (int(rng.integers(0, 12)), rng.bytes(int(rng.integers(0, 20))).hex().encode())
                   for _ in range(int(rng.integers(0, 7)))]
            txs += [rng.bytes(int(rng.integers(1, 40)))]
            evidence = (None, None)
            if height == 2:
                txs.append(b"val:" + pnew.pub_key.data.hex().encode() + b"/7")
                jsim.privs.append(jnew)
                psim.privs.append(pnew)
            if height == 4:
                leaving = jsim.state.validators.validators[1]
                txs.append(b"val:" + leaving.pub_key.data.hex().encode() + b"/0")
            if height == 5:
                jev = _j_evidence(jsim._privs_in_valset_order()[0], 3)
                evidence = ([jev], [decode_evidence(jev.encode())])
            all_txs += txs
            jblock, jps = jsim.make_next_block(txs, evidence=evidence[0])
            pblock, pps = psim.make_next_block(txs, evidence=evidence[1])
            assert pblock.encode() == jblock.encode() and pblock.hash() == jblock.hash()
            assert pps.header.hash == jps.header.hash
            jcommit, pcommit = jsim._commit_for(jblock, jps), psim._commit_for(pblock, pps)
            assert pcommit.encode() == jcommit.encode()
            J_state.apply_block(jsim.state, jblock, jps.header, jsim.conns.consensus, tx_indexer=jidx)
            apply_block(psim.state, pblock, pps.header, psim.conns.consensus, verifier=verifier, tx_indexer=pidx)
            for sim, block, commit in ((jsim, jblock, jcommit), (psim, pblock, pcommit)):
                sim.blocks.append(block)
                sim.commits.append(commit)
            assert psim.state.to_json() == jsim.state.to_json()
            assert psim.state.app_hash == jsim.state.app_hash
            assert psim.state.load_abci_responses(height).to_json() == jsim.state.load_abci_responses(height).to_json()
            for h in range(1, height + 2):
                assert psim.state.load_validators(h).hash() == jsim.state.load_validators(h).hash()
            for tx in all_txs:
                assert pidx.get(tx_hash(tx)).to_json() == jidx.get(tx_hash(tx)).to_json()
            assert list(psim.db.iterate()) == list(jsim.db.iterate())
            assert list(psim.app._db.iterate()) == list(jsim.app._db.iterate())
            assert list(pidx._db.iterate()) == list(jidx._db.iterate())
        assert psim.state.validators.size() == 4 and psim.state.last_height_validators_changed == 5
        assert load_state(psim.db).to_json() == J_state.load_state(jsim.db).to_json()
    finally:
        if verifier is not HOST:
            verifier.coalescer.close()


# -- the outcome matrix of validate_block -------------------------------------

EVIDENCE_CASES = ("too_many_evidence", "expired_evidence", "future_evidence", "forged_evidence", "good_evidence")
BLOCK_CASES = ("good", "wrong_chain_id", "wrong_height", "wrong_last_block_id", "wrong_app_hash",
               "wrong_validators_hash", "height1_signatures", "wrong_commit_size", "forged_precommit")


def _j_case(case):
    """(JAX state, JAX block) for one case: a 4-validator JAX chain at
    height 3 and its next block, changed as the case says."""
    jsim = JChainSim(n_vals=4)
    if case == "height1_signatures":
        other = JChainSim(n_vals=4)
        other.advance()
        block = J.Block.make_block(
            height=1, chain_id=jsim.chain_id, txs=J.Txs([b"t=1"]), last_commit=other.commits[0],
            last_block_id=jsim.state.last_block_id, time=jsim.genesis.genesis_time + 10**9,
            validators_hash=jsim.state.validators.hash(), app_hash=jsim.state.app_hash)
        return jsim.state, block
    for i in range(3):
        jsim.advance(txs=[b"h%d=%d" % (i, i)])
    privs = jsim._privs_in_valset_order()
    evidence = None
    if case in EVIDENCE_CASES:
        params = jsim.state.consensus_params.evidence
        evidence = [_j_evidence(privs[1], 2), _j_evidence(privs[2], 3)]
        if case == "too_many_evidence":
            params.max_evidence = 1
        elif case == "expired_evidence":
            params.max_age = 1
        elif case == "future_evidence":
            evidence = [_j_evidence(privs[1], 9)]
        elif case == "forged_evidence":
            evidence = [evidence[0], _j_evidence(privs[3], 3, forged=True)]
    block, _ps = jsim.make_next_block([b"x=1", b"y=2"], evidence=evidence)
    hdr = block.header
    if case == "wrong_chain_id":
        hdr.chain_id = "other-chain"
    elif case == "wrong_height":
        hdr.height += 1
    elif case == "wrong_last_block_id":
        hdr.last_block_id = J.BlockID(b"\x01" * 32, J.PartSetHeader(3, b"\x02" * 20))
    elif case == "wrong_app_hash":
        hdr.app_hash = b"\x01" * 20
    elif case == "wrong_validators_hash":
        hdr.validators_hash = b"\x02" * 32
    elif case in ("wrong_commit_size", "forged_precommit"):
        pre = list(block.last_commit.precommits)
        if case == "wrong_commit_size":
            pre = pre[:-1]
        else:
            pre[2] = pre[2].with_signature(bytes([pre[2].signature[0] ^ 1]) + pre[2].signature[1:])
        block.last_commit = J.Commit(block_id=block.last_commit.block_id, precommits=pre)
        hdr.last_commit_hash = block.last_commit.hash()
    return jsim.state, block


@pytest.fixture(scope="module")
def block_cases():
    return {case: _j_case(case) for case in BLOCK_CASES + EVIDENCE_CASES}


@pytest.mark.parametrize("case", BLOCK_CASES + EVIDENCE_CASES)
def test_validate_block_outcomes_match_the_jax_package(block_cases, stacks, case):
    jstate, jblock = block_cases[case]
    want = outcome(lambda: J_state.validate_block(jstate, jblock, JHostVerifier()))
    assert (want is None) == (case in ("good", "good_evidence")), want
    for name, verifier, coalescer in _port_verifiers(stacks):
        pstate, pblock = p_state(jstate), p_block(jblock)
        try:
            got = outcome(lambda: validate_block(pstate, pblock, verifier))
        finally:
            if coalescer is not None:
                coalescer.coalescer.close()
        assert got == want, name
    for name, stack in stacks.items():
        snap = stack.inner.snapshot()
        assert snap["fallback_calls"] == 0 and snap["total_failures"] == 0, name
