"""The port's certifiers, providers and `FullCommitStore` against the JAX
package's.

The JAX package's own scenarios (`tests/test_certifiers.py`, and the
`FullCommitStore` cases of `tests/test_lightclient.py`) run again on
`tendermint_tpu_torch.certifiers` and `tendermint_tpu_torch.db.fullcommit`.
A seeded differential drives one chain through both packages' `ChainSim`
(a validator-set change on the way) and requires byte-equal
`FullCommit.encode()`, the same files from `FileProvider` and the same
keys in a `FullCommitStore`. The outcome matrix runs each certifier
scenario (certify, a batch, wrong chain, forged signatures, validators
changed, a small and a too-large change, a height that does not
increase, bisection, no intermediate commit) in the JAX package on its
host verifier and in the port on its host verifier and on
`default_verifier(device="cpu")` at the default minimum batch and at 0,
and requires the same outcome (the exception's class name and message)
and the same trusted heights.

Objects cross from the JAX package to the port by their wire form only
(`FullCommit.encode()` into the port's `FullCommit.decode()`).
`verifier=None` is the port's card stack and raises without a card.
Everything is exact.
"""

from __future__ import annotations

import os
import time
import types

import numpy as np
import pytest
import torch

from tendermint_tpu import certifiers as JC
from tendermint_tpu import types as J
from tendermint_tpu.abci.apps import PersistentKVStoreApp as JPersistentKVStoreApp
from tendermint_tpu.crypto.keys import gen_priv_key as j_gen_priv_key
from tendermint_tpu.db.fullcommit import FullCommitStore as JFullCommitStore
from tendermint_tpu.db.kv import MemDB as JMemDB
from tendermint_tpu.services.verifier import HostBatchVerifier as JHostVerifier
from tendermint_tpu_torch import certifiers as PC
from tendermint_tpu_torch import types as P
from tendermint_tpu_torch.abci.apps import PersistentKVStoreApp
from tendermint_tpu_torch.certifiers import (
    DynamicCertifier,
    FileProvider,
    FullCommit,
    InquiringCertifier,
    MemProvider,
    StaticCertifier,
)
from tendermint_tpu_torch.crypto import PrivKey, PubKey
from tendermint_tpu_torch.crypto.keys import gen_priv_key
from tendermint_tpu_torch.db.fullcommit import FullCommitStore
from tendermint_tpu_torch.db.kv import MemDB, SQLiteDB
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.services.batcher import CoalescingVerifier
from tendermint_tpu_torch.telemetry import REGISTRY
from tendermint_tpu_torch.testing import ChainSim, lockrank_report, make_commit
from tendermint_tpu_torch.types import Header, PrivValidator, Validator, ValidatorSet
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.errors import ErrTooMuchChange, ErrValidatorsChanged, ValidationError
from tendermint_tpu_torch.types.part_set import PartSetHeader

from tests import test_certifiers as JT
from tests.helpers import ChainSim as JChainSim

torch.set_num_threads(1)

CHAIN = "light-chain"
HOST = V.HostBatchVerifier()


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


def outcome(fn):
    """(None, fn's result), or the raised exception as (class name,
    message) and None."""
    try:
        return None, fn()
    except Exception as e:  # noqa: BLE001 - the class is part of what is compared
        return (type(e).__name__, str(e)), None


def _privs(indices):
    return [PrivValidator(PrivKey(i.to_bytes(32, "little"))) for i in indices]


def _valset(privs, power=10):
    return ValidatorSet([Validator(address=p.address, pub_key=p.pub_key, voting_power=power) for p in privs])


def _full_commit(height, privs, app_hash=b"app"):
    """FullCommit at `height` signed by `privs`' valset (its precommits
    checked on the host as the commit is made)."""
    vs = _valset(privs)
    header = Header(chain_id=CHAIN, height=height, time=height * 1_000_000_000, num_txs=0,
                    last_block_id=BlockID.zero(), last_commit_hash=b"", data_hash=b"",
                    validators_hash=vs.hash(), app_hash=app_hash)
    block_id = BlockID(header.hash(), PartSetHeader(total=1, hash=header.hash()[:20]))
    ordered = sorted(privs, key=lambda p: p.address)
    commit = make_commit(vs, ordered, height, 0, block_id, HOST, CHAIN)
    return FullCommit(header=header, commit=commit, validators=vs)


def p_fc(fc):
    return FullCommit.decode(fc.encode())


def p_valset(vs):
    return ValidatorSet([Validator(v.address, PubKey(v.pub_key.data), v.voting_power, v.accum) for v in vs])


# -- tests/test_certifiers.py -----------------------------------------------


class TestStaticCertifier:
    def test_certify_and_batch(self):
        privs = _privs(range(1, 5))
        fcs = [_full_commit(h, privs) for h in (5, 6, 7)]
        cert = StaticCertifier(CHAIN, _valset(privs), verifier=HOST)
        cert.certify(fcs[0])
        cert.certify_batch(fcs)  # config-2 shape: K commits, one call

    def test_rejects_wrong_chain_and_forged_sig(self):
        privs = _privs(range(1, 5))
        fc = _full_commit(3, privs)
        with pytest.raises(ValidationError, match="chain"):
            StaticCertifier("other", _valset(privs), verifier=HOST).certify(fc)
        # forge one signature
        bad = fc.commit.precommits[1]
        sig = bytearray(bad.signature)
        sig[5] ^= 1
        fc.commit.precommits[1] = bad.with_signature(bytes(sig))
        with pytest.raises(ValidationError, match="validator 1"):
            StaticCertifier(CHAIN, _valset(privs), verifier=HOST).certify(fc)

    def test_validators_changed_is_typed(self):
        fc = _full_commit(3, _privs(range(1, 5)))
        other = _valset(_privs(range(10, 14)))
        with pytest.raises(ErrValidatorsChanged):
            StaticCertifier(CHAIN, other, verifier=HOST).certify(fc)


class TestDynamicCertifier:
    def test_update_follows_small_change(self):
        old = _privs([1, 2, 3, 4])
        new = _privs([1, 2, 3, 5])  # one of four replaced: 75% overlap
        cert = DynamicCertifier(CHAIN, _valset(old), height=1, verifier=HOST)
        fc = _full_commit(10, new)
        cert.update(fc)
        assert cert.last_height == 10
        cert.certify(_full_commit(11, new))

    def test_update_rejects_large_change(self):
        old = _privs([1, 2, 3, 4])
        new = _privs([1, 2, 5, 6])  # half replaced: 50% < 2/3
        cert = DynamicCertifier(CHAIN, _valset(old), height=1, verifier=HOST)
        with pytest.raises(ErrTooMuchChange):
            cert.update(_full_commit(10, new))

    def test_update_height_must_increase(self):
        privs = _privs([1, 2, 3, 4])
        cert = DynamicCertifier(CHAIN, _valset(privs), height=10, verifier=HOST)
        with pytest.raises(ValidationError, match="height"):
            cert.update(_full_commit(5, privs))


class TestInquiringCertifier:
    def _chain(self):
        """heights 1..4 rotate one validator each: any 2-step jump
        changes half the set (> 1/3), forcing bisection."""
        sets = {
            1: _privs([1, 2, 3, 4]),
            2: _privs([1, 2, 3, 5]),
            3: _privs([1, 2, 5, 6]),
            4: _privs([1, 5, 6, 7]),
        }
        return {h: _full_commit(h, p) for h, p in sets.items()}

    def test_bisection_across_large_total_change(self):
        fcs = self._chain()
        source = MemProvider()
        for fc in fcs.values():
            source.store_commit(fc)
        trusted = MemProvider()
        walks = REGISTRY.get("tendermint_lightclient_walk_seconds").labels(mode="sequential").value["count"]
        inq = InquiringCertifier(CHAIN, fcs[1], trusted, source, verifier=HOST)
        # direct 1->4 changed 3 of 4 validators; must bisect via 2 and 3
        inq.certify(fcs[4])
        assert inq.cert.last_height == 4
        # intermediate hops became trusted
        assert trusted.get_by_height(3).height() >= 2
        # the walk is timed in the port's registry
        after = REGISTRY.get("tendermint_lightclient_walk_seconds").labels(mode="sequential").value["count"]
        assert after == walks + 1

    def test_fails_without_intermediate_commits(self):
        fcs = self._chain()
        source = MemProvider()
        source.store_commit(fcs[1])
        source.store_commit(fcs[4])  # gap: no 2, 3
        inq = InquiringCertifier(CHAIN, fcs[1], MemProvider(), source, verifier=HOST)
        with pytest.raises(ErrTooMuchChange):
            inq.certify(fcs[4])

    def test_same_valset_certifies_without_update(self):
        privs = _privs([1, 2, 3, 4])
        seed = _full_commit(1, privs)
        inq = InquiringCertifier(CHAIN, seed, MemProvider(), MemProvider(), verifier=HOST)
        inq.certify(_full_commit(7, privs))


class TestProviders:
    def test_mem_provider_floor_lookup(self):
        p = MemProvider()
        privs = _privs([1, 2, 3, 4])
        for h in (2, 5, 9):
            p.store_commit(_full_commit(h, privs))
        assert p.get_by_height(1) is None
        assert p.get_by_height(5).height() == 5
        assert p.get_by_height(8).height() == 5
        assert p.latest_commit().height() == 9

    def test_file_provider_round_trip(self, tmp_path):
        p = FileProvider(str(tmp_path / "trust"))
        privs = _privs([1, 2, 3, 4])
        fc = _full_commit(12, privs)
        p.store_commit(fc)
        # fresh instance reads the same directory (restart survival)
        p2 = FileProvider(str(tmp_path / "trust"))
        got = p2.get_by_height(100)
        assert got.height() == 12
        assert got.header.hash() == fc.header.hash()
        assert got.validators.hash() == fc.validators.hash()
        # decoded commit still certifies
        StaticCertifier(CHAIN, got.validators, verifier=HOST).certify(got)

    def test_metric_family_seeded_at_import(self):
        fam = REGISTRY.get("tendermint_lightclient_walk_seconds")
        for mode in ("sequential", "bisect"):
            assert fam.labels(mode=mode).value["count"] >= 0


# -- tests/test_lightclient.py's FullCommitStore cases ------------------------


class TestFullCommitStore:
    def test_roundtrip_floor_exact_latest(self):
        store = FullCommitStore(MemDB())
        privs = _privs(range(1, 5))
        for h in (2, 5, 9):
            store.store_commit(_full_commit(h, privs))
        assert store.get_by_height(1) is None
        assert store.get_by_height(5).height() == 5
        assert store.get_by_height(8).height() == 5
        assert store.get_exact(5).height() == 5
        assert store.get_exact(6) is None
        assert store.latest_commit().height() == 9
        assert store.latest_height() == 9
        assert len(store) == 3

    def test_survives_reopen(self, tmp_path):
        for db in (MemDB(), SQLiteDB(str(tmp_path / "fc.db"))):
            store = FullCommitStore(db)
            privs = _privs(range(1, 5))
            fc = _full_commit(12, privs)
            store.store_commit(fc)
            store.store_commit(fc)  # idempotent
            again = FullCommitStore(db)  # fresh index over the same DB
            got = again.get_by_height(100)
            assert got.height() == 12 and again.heights() == [12]
            assert got.header.hash() == fc.header.hash()
            assert got.validators.hash() == fc.validators.hash()
            db.close()

    def test_prune_keeps_recent(self):
        store = FullCommitStore(MemDB())
        privs = _privs(range(1, 5))
        for h in range(1, 11):
            store.store_commit(_full_commit(h, privs))
        assert store.prune(0) == 0
        assert store.prune(3) == 7
        assert store.heights() == [8, 9, 10]
        assert store.get_by_height(7) is None
        assert store.get_by_height(9).height() == 9


# -- the seam: verifier=None is the card's stack ----------------------------


def test_missing_verifier_is_the_card_stack_and_raises_without_a_card(monkeypatch):
    """A certifier given no verifier verifies on the port's
    `default_verifier()`: without a card every walk raises, and none
    answers on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(V, "_DEFAULTS", {})
    old, new = _privs([1, 2, 3, 4]), _privs([1, 2, 3, 5])
    fc, fc_new = _full_commit(3, old), _full_commit(10, new)
    source = MemProvider()
    source.store_commit(fc_new)
    calls = [
        lambda: StaticCertifier(CHAIN, _valset(old)).certify(fc),
        lambda: StaticCertifier(CHAIN, _valset(old)).certify_batch([fc]),
        lambda: DynamicCertifier(CHAIN, _valset(old), height=1).update(fc_new),
        lambda: InquiringCertifier(CHAIN, fc, MemProvider(), source).certify(fc_new),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()
    assert V._DEFAULTS == {}
    StaticCertifier(CHAIN, _valset(old), verifier=HOST).certify(fc)


# -- the port's FullCommits against the JAX package's -------------------------


def test_full_commits_match_the_jax_package(tmp_path, monkeypatch):
    """One seeded chain of 6 heights through both packages' `ChainSim`,
    a validator joining at height 2 and one leaving at height 3: each
    height's FullCommit (header, commit, the set `load_validators` gives)
    encodes to the same bytes, decodes across, and lands in the same
    `FileProvider` files and `FullCommitStore` keys; the port certifies
    the chain with an `InquiringCertifier` over a `FullCommitStore` on
    SQLite."""
    monkeypatch.setattr(time, "time_ns", lambda: 1_750_000_000_000_000_000)
    rng = np.random.default_rng(99)
    jsim = JChainSim(n_vals=4, app=JPersistentKVStoreApp(JMemDB()))
    psim = ChainSim(n_vals=4, app=PersistentKVStoreApp(MemDB()), verifier=HOST)
    jnew, pnew = J.PrivValidator(j_gen_priv_key(b"\x66" * 32)), P.PrivValidator(gen_priv_key(b"\x66" * 32))
    for height in range(1, 7):
        txs = [rng.bytes(int(rng.integers(1, 30))) for _ in range(int(rng.integers(0, 5)))]
        if height == 2:
            txs.append(b"val:" + pnew.pub_key.data.hex().encode() + b"/7")
            jsim.privs.append(jnew)
            psim.privs.append(pnew)
        if height == 3:
            txs.append(b"val:" + psim.state.validators.validators[0].pub_key.data.hex().encode() + b"/0")
        jsim.advance(txs=txs)
        psim.advance(txs=txs)
    jfiles, pfiles = JC.FileProvider(str(tmp_path / "j")), FileProvider(str(tmp_path / "p"))
    jstore, pstore = JFullCommitStore(JMemDB()), FullCommitStore(MemDB())
    pfcs = {}
    for h in range(1, 7):
        jfc = JC.FullCommit(header=jsim.blocks[h - 1].header, commit=jsim.commits[h - 1],
                            validators=jsim.state.load_validators(h))
        pfc = FullCommit(header=psim.blocks[h - 1].header, commit=psim.commits[h - 1],
                         validators=psim.state.load_validators(h))
        assert pfc.encode() == jfc.encode()
        assert p_fc(jfc).encode() == jfc.encode()
        assert JC.FullCommit.decode(pfc.encode()).encode() == jfc.encode()
        pfc.validate_basic(psim.chain_id)
        for store in (jfiles, pfiles, jstore):
            store.store_commit(jfc if store is not pfiles else pfc)
        pstore.store_commit(pfc)
        pfcs[h] = pfc
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    assert list(pstore._db.iterate()) == list(jstore._db.iterate())
    # the port's light client follows the chain across the set changes
    source = MemProvider()
    for fc in pfcs.values():
        source.store_commit(fc)
    trusted = FullCommitStore(SQLiteDB(str(tmp_path / "trusted.db")))
    inq = InquiringCertifier(psim.chain_id, pfcs[1], trusted, source, verifier=HOST)
    inq.certify(pfcs[6])
    assert inq.cert.last_height == 6 and trusted.latest_height() == 6
    StaticCertifier(psim.chain_id, pfcs[6].validators, verifier=HOST).certify_batch([pfcs[4], pfcs[5], pfcs[6]])
    trusted._db.close()


# -- the outcome matrix --------------------------------------------------------


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


def _forged(pkg_fc, fc, idx):
    """`fc` with precommit `idx`'s signature changed in one bit."""
    pre = list(fc.commit.precommits)
    sig = pre[idx].signature
    pre[idx] = pre[idx].with_signature(sig[:5] + bytes([sig[5] ^ 1]) + sig[6:])
    commit = type(fc.commit)(block_id=fc.commit.block_id, precommits=pre)
    return pkg_fc(header=fc.header, commit=commit, validators=fc.validators)


@pytest.fixture(scope="module")
def jax_commits():
    """The JAX package's FullCommits and sets for every scenario."""
    p = JT._privs
    fcs = {f"a{h}": JT._full_commit(h, p([1, 2, 3, 4])) for h in (3, 5, 6, 7)}
    fcs.update({"b10": JT._full_commit(10, p([1, 2, 3, 5])), "b11": JT._full_commit(11, p([1, 2, 3, 5])),
                "c10": JT._full_commit(10, p([1, 2, 5, 6]))})
    for h, idx in ((2, [1, 2, 3, 5]), (3, [1, 2, 5, 6]), (4, [1, 5, 6, 7])):
        fcs[f"r{h}"] = JT._full_commit(h, p(idx))
    fcs["r1"] = JT._full_commit(1, p([1, 2, 3, 4]))
    fcs["a3_forged"] = _forged(JC.FullCommit, fcs["a3"], 1)
    fcs["a6_forged"] = _forged(JC.FullCommit, fcs["a6"], 3)
    # the new set's precommit of old validator 2 (index 1 in the new order)
    fcs["b10_forged"] = _forged(JC.FullCommit, fcs["b10"], 1)
    sets = {"a": JT._valset(p([1, 2, 3, 4])), "other": JT._valset(p(range(10, 14)))}
    return fcs, sets


def _inquire(C, fcs, sets, verifier, source_heights, target):
    source, trusted = C.MemProvider(), C.MemProvider()
    for h in source_heights:
        source.store_commit(fcs[f"r{h}"])
    inq = C.InquiringCertifier(CHAIN, fcs["r1"], trusted, source, verifier=verifier)
    inq.certify(fcs[target])
    return inq.cert.last_height, list(trusted._heights)


def _dynamic(C, fcs, sets, verifier, update, then=None, height=1):
    cert = C.DynamicCertifier(CHAIN, sets["a"], height=height, verifier=verifier)
    cert.update(fcs[update])
    if then is not None:
        cert.certify(fcs[then])
    return cert.last_height


SCENARIOS = {
    "certify": lambda C, f, s, v: C.StaticCertifier(CHAIN, s["a"], v).certify(f["a3"]),
    "batch": lambda C, f, s, v: C.StaticCertifier(CHAIN, s["a"], v).certify_batch([f["a5"], f["a6"], f["a7"]]),
    "wrong_chain": lambda C, f, s, v: C.StaticCertifier("other", s["a"], v).certify(f["a3"]),
    "forged": lambda C, f, s, v: C.StaticCertifier(CHAIN, s["a"], v).certify(f["a3_forged"]),
    "batch_forged": lambda C, f, s, v: C.StaticCertifier(CHAIN, s["a"], v).certify_batch(
        [f["a5"], f["a6_forged"], f["a7"]]),
    "validators_changed": lambda C, f, s, v: C.StaticCertifier(CHAIN, s["other"], v).certify(f["a3"]),
    "small_change": lambda C, f, s, v: _dynamic(C, f, s, v, "b10", then="b11"),
    "too_much_change": lambda C, f, s, v: _dynamic(C, f, s, v, "c10"),
    "forged_update": lambda C, f, s, v: _dynamic(C, f, s, v, "b10_forged"),
    "height_not_increasing": lambda C, f, s, v: _dynamic(C, f, s, v, "a5", height=10),
    "bisection": lambda C, f, s, v: _inquire(C, f, s, v, (1, 2, 3, 4), "r4"),
    "no_intermediate": lambda C, f, s, v: _inquire(C, f, s, v, (1, 4), "r4"),
    "same_valset": lambda C, f, s, v: _inquire(C, f, s, v, (), "a7"),
}
FAILING = {"wrong_chain", "forged", "batch_forged", "validators_changed", "too_much_change", "forged_update",
           "height_not_increasing", "no_intermediate"}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_certifier_outcomes_match_the_jax_package(jax_commits, stacks, case):
    jfcs, jsets = jax_commits
    want = outcome(lambda: SCENARIOS[case](JC, jfcs, jsets, JHostVerifier()))
    assert (want[0] is not None) == (case in FAILING), want
    pfcs = {name: p_fc(fc) for name, fc in jfcs.items()}
    psets = {name: p_valset(vs) for name, vs in jsets.items()}
    verifiers = [("port-host", HOST)] + [(name, CoalescingVerifier(s.inner)) for name, s in stacks.items()]
    for name, verifier in verifiers:
        try:
            got = outcome(lambda: SCENARIOS[case](PC, pfcs, psets, verifier))
        finally:
            if verifier is not HOST:
                verifier.coalescer.close()
        assert got == want, name
    for name, stack in stacks.items():
        snap = stack.inner.snapshot()
        assert snap["fallback_calls"] == 0 and snap["total_failures"] == 0, name


def test_exports_match_the_jax_package():
    import tendermint_tpu.abci as JA
    import tendermint_tpu.db as JD
    import tendermint_tpu.state as JS
    import tendermint_tpu_torch.abci as PA
    import tendermint_tpu_torch.db as PD
    import tendermint_tpu_torch.state as PS

    for jmod, pmod in ((JC, PC), (JA, PA), (JD, PD), (JS, PS)):
        assert sorted(pmod.__all__) == sorted(jmod.__all__)
        for name in pmod.__all__:
            assert isinstance(getattr(pmod, name), (type, types.FunctionType)) == isinstance(
                getattr(jmod, name), (type, types.FunctionType)), name
