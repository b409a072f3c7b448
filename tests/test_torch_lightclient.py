"""The port's light client (`tendermint_tpu_torch/lightclient/`) against
the JAX package's.

The JAX package's own `tests/test_lightclient.py` runs again on the port
up to its reactor round trips: the FullCommit store, the certified-commit
cache (positives only, eviction, the store fallback, warm reloads), the
bisection's arithmetic (one round over a stable set, bridging a
rotation, a dense rotation, an unbridgeable gap, the trust period, the
strict 1/3 overlap, attacker keys under trusted addresses, typed
environmental failures, forged and quorumless candidates, the trusted
cache's memoization), one coalesced launch a round, evidence
extraction, and the 0x68 reactor (request and floor fallback, concurrent
waits, pushes certified and forwarded, a forged push scored and turned
into evidence). The port's certifiers are given the port's
`HostBatchVerifier` (`verifier=None` is the card's stack).
`TestReplicaAcceptance` waits for the port's node (ROADMAP A8).

Across the packages, on one source: both `BisectingCertifier`s end at
the same trusted heights with the same rounds and `last_walk_verifies`,
or raise the same error class and message; extracted evidence, reactor
frames, cache answers and a walk over the 0x68 channel between a JAX and
a port reactor over localhost TCP agree. The gossip tables name the
port's lightclient and statesync channels and tags. Tolerance: exact.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu.certifiers.provider import MemProvider as JMemProvider
from tendermint_tpu.lightclient import BisectingCertifier as JBisectingCertifier
from tendermint_tpu.lightclient import CertifiedCommitCache as JCertifiedCommitCache
from tendermint_tpu.lightclient import extract_double_sign_evidence as j_extract
from tendermint_tpu.lightclient import reactor as J_lcr
from tendermint_tpu.p2p import NodeInfo as JNodeInfo
from tendermint_tpu.p2p import Switch as JSwitch
from tendermint_tpu.p2p import tcp as J_tcp
from tendermint_tpu.testing.byzantine import forge_fullcommit as j_forge_fullcommit
from tendermint_tpu_torch.certifiers.certifier import FullCommit
from tendermint_tpu_torch.certifiers.provider import MemProvider
from tendermint_tpu_torch.db.fullcommit import FullCommitStore
from tendermint_tpu_torch.db.kv import MemDB
from tendermint_tpu_torch.lightclient import (
    BisectingCertifier,
    CertifiedCommitCache,
    LightClientReactor,
    PeerProvider,
    extract_double_sign_evidence,
)
from tendermint_tpu_torch.lightclient import reactor as lcr
from tendermint_tpu_torch.p2p import NodeInfo, Switch, connect_switches, tcp
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.testing import forge_fullcommit, lockrank_report
from tendermint_tpu_torch.types.errors import (
    ErrNoSourceCommit,
    ErrTooMuchChange,
    ErrTrustExpired,
    ValidationError,
)

from tests.test_certifiers import _full_commit as j_full_commit
from tests.test_certifiers import _privs as j_privs
from tests.test_torch_certifiers import _full_commit, _privs

torch.set_num_threads(1)

CHAIN = "light-chain"
HOST = HostBatchVerifier()


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


def _cert(**kw):
    """A port `BisectingCertifier` on the host verifier unless told
    otherwise."""
    kw.setdefault("verifier", HOST)
    return BisectingCertifier(CHAIN, **kw)


def _chain_source(heights, privs_for):
    """MemProvider of FullCommits: privs_for(h) -> priv list at h."""
    src = MemProvider()
    fcs = {}
    for h in heights:
        fcs[h] = _full_commit(h, privs_for(h))
        src.store_commit(fcs[h])
    return src, fcs


# -- tests/test_lightclient.py ---------------------------------------------------------


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

    def test_survives_reopen(self):
        db = MemDB()
        store = FullCommitStore(db)
        fc = _full_commit(12, _privs(range(1, 5)))
        store.store_commit(fc)
        got = FullCommitStore(db).get_by_height(100)
        assert got.height() == 12
        assert got.header.hash() == fc.header.hash()
        assert got.validators.hash() == fc.validators.hash()

    def test_prune_keeps_recent(self):
        store = FullCommitStore(MemDB())
        privs = _privs(range(1, 5))
        for h in range(1, 11):
            store.store_commit(_full_commit(h, privs))
        assert store.prune(3) == 7
        assert store.heights() == [8, 9, 10]
        assert store.get_by_height(7) is None
        assert store.get_by_height(9).height() == 9


class TestCertifiedCommitCache:
    def test_positives_only_surface(self):
        cache = CertifiedCommitCache()
        assert not hasattr(cache, "put_rejected")
        assert cache.get_exact(5) is None
        cache.put_certified(_full_commit(5, _privs(range(1, 5))))
        assert cache.get_exact(5).height() == 5
        assert cache.get_by_height(9).height() == 5
        assert cache.get_by_height(4) is None

    def test_eviction_oldest_first(self):
        cache = CertifiedCommitCache(capacity=3)
        privs = _privs(range(1, 5))
        for h in range(1, 6):
            cache.put_certified(_full_commit(h, privs))
        assert len(cache) == 3
        assert cache.get_exact(1) is None
        assert cache.get_exact(5).height() == 5

    def test_store_fallback_readmission_stays_evictable(self):
        store = FullCommitStore(MemDB())
        privs = _privs(range(1, 5))
        for h in range(1, 11):
            store.store_commit(_full_commit(h, privs))
        cache = CertifiedCommitCache(capacity=3, store=store)
        for h in range(1, 11):
            assert cache.get_exact(h).height() == h
        assert sum(len(entries) for _, entries in cache._shards) <= 3
        assert len(cache) <= 3

    def test_write_through_store_and_warm_reload(self):
        db = MemDB()
        cache = CertifiedCommitCache(store=FullCommitStore(db))
        cache.put_certified(_full_commit(7, _privs(range(1, 5))))
        cache2 = CertifiedCommitCache(store=FullCommitStore(db))
        assert cache2.latest_height() == 7
        assert cache2.get_exact(7).height() == 7
        stats = cache2.stats()
        assert stats["entries"] == 1 and stats["latest_height"] == 7


class TestBisectionMath:
    def test_stable_valset_single_round(self):
        privs = _privs(range(1, 5))
        src, fcs = _chain_source((1, 64, 128, 200, 256), lambda h: privs)
        cert = _cert(seed=fcs[1], trusted=MemProvider(), source=src)
        cert.verify_to_height(256)
        assert cert.last_height == 256
        assert cert.last_walk_rounds == 1
        assert cert.last_walk_verifies <= 36

    def test_rotating_chain_bisects(self):
        sets = {1: _privs([1, 2, 3, 4]), 2: _privs([1, 2, 3, 5]), 3: _privs([1, 2, 5, 6]), 4: _privs([1, 5, 6, 7])}
        src, fcs = _chain_source(sets, lambda h: sets[h])
        trusted = MemProvider()
        cert = _cert(seed=fcs[1], trusted=trusted, source=src)
        cert.certify(fcs[4])
        assert cert.last_height == 4
        assert trusted.get_by_height(3).height() >= 2

    def test_dense_rotation_long_chain(self):
        base = list(range(1, 9))

        def privs_for(h):
            rotated = (h - 1) // 4
            ids = base[rotated % 8:] + [100 + i for i in range(rotated)]
            return _privs(sorted(ids[-8:]))

        src, fcs = _chain_source(list(range(1, 65)), privs_for)
        cert = _cert(seed=fcs[1], trusted=MemProvider(), source=src)
        cert.verify_to_height(64)
        assert cert.last_height == 64
        assert cert.last_walk_verifies < 64 * 8 / 2
        assert cert.last_walk_rounds <= 8

    def test_unbridgeable_gap_raises_too_much_change(self):
        sets = {1: _privs([1, 2, 3, 4]), 4: _privs([1, 5, 6, 7])}
        src, fcs = _chain_source(sets, lambda h: sets[h])
        cert = _cert(seed=fcs[1], trusted=MemProvider(), source=src)
        with pytest.raises(ErrTooMuchChange):
            cert.certify(fcs[4])

    def test_trust_period_boundary(self):
        privs = _privs(range(1, 5))
        src, fcs = _chain_source((1, 10), lambda h: privs)
        period_ns = int(3600 * 1e9)
        expired_now = fcs[1].header.time + period_ns + 1
        cert = _cert(seed=fcs[1], trusted=MemProvider(), source=src, trust_period_ns=period_ns,
                     now_ns=lambda: expired_now)
        with pytest.raises(ValidationError, match="trust expired"):
            cert.verify_to_height(10)
        fresh = _cert(seed=fcs[1], trusted=MemProvider(), source=src, trust_period_ns=period_ns,
                      now_ns=lambda: fcs[1].header.time + period_ns - 1)
        fresh.verify_to_height(10)
        assert fresh.last_height == 10

    def test_one_third_overlap_boundary(self):
        old = _privs(range(1, 10))
        exactly_third = _privs([1, 2, 3] + list(range(20, 26)))
        just_above = _privs([1, 2, 3, 4] + list(range(20, 25)))
        for new, ok in ((exactly_third, False), (just_above, True)):
            src = MemProvider()
            seed = _full_commit(1, old)
            src.store_commit(seed)
            src.store_commit(_full_commit(2, new))
            cert = _cert(seed=seed, trusted=MemProvider(), source=src)
            if ok:
                cert.verify_to_height(2)
                assert cert.last_height == 2
            else:
                with pytest.raises(ErrTooMuchChange):
                    cert.verify_to_height(2)

    def test_address_reuse_with_attacker_keys_cannot_hijack(self):
        src, seed, _forged = _hijack_source(_privs, _full_commit, _types("tendermint_tpu_torch"))
        trusted = MemProvider()
        cert = _cert(seed=seed, trusted=trusted, source=src)
        with pytest.raises(ErrTooMuchChange):
            cert.verify_to_height(10)
        assert cert.last_height == 1
        assert trusted.latest_commit().height() == 1

    def test_environmental_failures_are_typed_not_forged(self):
        from tendermint_tpu_torch.telemetry import REGISTRY

        def count(result):
            return REGISTRY.counter_value("tendermint_lightclient_bisections_total", result=result)

        privs = _privs(range(1, 5))
        src, fcs = _chain_source((1, 10), lambda h: privs)
        base = count("forged")
        cert = _cert(seed=fcs[1], trusted=MemProvider(), source=MemProvider())
        ns_base = count("no_source")
        with pytest.raises(ErrNoSourceCommit):
            cert.verify_to_height(10)
        assert count("no_source") == ns_base + 1
        period_ns = int(3600 * 1e9)
        expired = _cert(seed=fcs[1], trusted=MemProvider(), source=src, trust_period_ns=period_ns,
                        now_ns=lambda: fcs[1].header.time + period_ns + 1)
        te_base = count("trust_expired")
        with pytest.raises(ErrTrustExpired):
            expired.verify_to_height(10)
        with pytest.raises(ErrTrustExpired):
            expired.certify(fcs[10])
        assert count("trust_expired") == te_base + 1
        assert count("forged") == base

    def test_forged_signature_is_hard_failure_and_never_cached(self):
        privs = _privs(range(1, 5))
        src, fcs = _chain_source((1, 10), lambda h: privs)
        bad = fcs[10].commit.precommits[1]
        sig = bytearray(bad.signature)
        sig[5] ^= 1
        fcs[10].commit.precommits[1] = bad.with_signature(bytes(sig))
        trusted = MemProvider()
        cert = _cert(seed=fcs[1], trusted=trusted, source=src)
        with pytest.raises(ValidationError, match="forged|invalid"):
            cert.verify_to_height(10)
        assert trusted.latest_commit().height() == 1

    def test_quorumless_candidate_is_forged(self):
        from tendermint_tpu_torch.types.block import Commit

        privs = _privs(range(1, 5))
        seed = _full_commit(1, privs)
        fc = _full_commit(10, privs)
        keep = next(i for i, p in enumerate(fc.commit.precommits) if p is not None)
        fc.commit = Commit(block_id=fc.commit.block_id,
                           precommits=[p if i == keep else None for i, p in enumerate(fc.commit.precommits)])
        src = MemProvider()
        src.store_commit(seed)
        src.store_commit(fc)
        cert = _cert(seed=seed, trusted=MemProvider(), source=src)
        with pytest.raises(ValidationError, match="quorum"):
            cert.verify_to_height(10)

    def test_trusted_cache_memoizes_walks(self):
        privs = _privs(range(1, 5))
        src, fcs = _chain_source((1, 256), lambda h: privs)
        db = MemDB()
        cert = _cert(seed=fcs[1], trusted=CertifiedCommitCache(store=FullCommitStore(db)), source=src)
        cert.verify_to_height(256)
        assert cert.last_height == 256
        cert2 = _cert(seed=fcs[1], trusted=CertifiedCommitCache(store=FullCommitStore(db)), source=MemProvider())
        cert2.verify_to_height(256)
        assert cert2.last_height == 256
        assert cert2.last_walk_verifies == 0

    def test_verifier_none_is_the_card_stack_and_raises_without_a_card(self, monkeypatch):
        from tendermint_tpu_torch.services import verifier as V

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(V, "_DEFAULTS", {})
        privs = _privs(range(1, 5))
        src, fcs = _chain_source((1, 10), lambda h: privs)
        cert = BisectingCertifier(CHAIN, seed=fcs[1], trusted=MemProvider(), source=src)
        with pytest.raises(RuntimeError):
            cert.verify_to_height(10)


def _hijack_source(privs_fn, full_commit_fn, T):
    """The trust-hijack case's source, in the package whose types `T`
    holds: a candidate set reusing every trusted address with attacker
    keys, fully signed by them. Returns (source, seed, forged)."""
    seed = full_commit_fn(1, privs_fn(range(1, 5)))
    attackers = privs_fn(range(11, 15))
    forged_vs = T.ValidatorSet([T.Validator(address=v.address, pub_key=att.pub_key, voting_power=v.voting_power)
                                for v, att in zip(seed.validators.validators, attackers)])
    by_pub = {a.pub_key.data: a for a in attackers}
    header = T.Header(chain_id=CHAIN, height=10, time=10_000_000_000, num_txs=0, last_block_id=T.BlockID.zero(),
                      last_commit_hash=b"", data_hash=b"", validators_hash=forged_vs.hash(), app_hash=b"evil")
    bid = T.BlockID(header.hash(), T.PartSetHeader(total=1, hash=header.hash()[:20]))
    precommits = []
    for idx, val in enumerate(forged_vs.validators):
        vote = T.Vote(validator_address=val.address, validator_index=idx, height=10, round=0, timestamp=idx + 1,
                      type=T.VOTE_TYPE_PRECOMMIT, block_id=bid)
        precommits.append(vote.with_signature(by_pub[val.pub_key.data]._signer.sign(vote.sign_bytes(CHAIN))))
    forged = T.FullCommit(header=header, commit=T.Commit(block_id=bid, precommits=precommits), validators=forged_vs)
    src = T.MemProvider()
    src.store_commit(seed)
    src.store_commit(forged)
    return src, seed, forged


def _types(pkg):
    """The classes `_hijack_source` builds with, from one package."""
    import importlib

    mods = [importlib.import_module(f"{pkg}.{m}") for m in (
        "types", "types.block", "types.block_id", "types.part_set", "types.vote", "certifiers.certifier",
        "certifiers.provider")]
    names = ("ValidatorSet", "Validator", "Header", "Commit", "BlockID", "PartSetHeader", "Vote",
             "VOTE_TYPE_PRECOMMIT", "FullCommit", "MemProvider")
    return SimpleNamespace(**{n: next(getattr(m, n) for m in mods if hasattr(m, n)) for n in names})


class TestBatchedLaunches:
    def test_one_coalesced_launch_per_bisection_round(self):
        from tendermint_tpu_torch.services.batcher import CoalescingVerifier
        from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG

        sets = {1: _privs([1, 2, 3, 4]), 2: _privs([1, 2, 3, 5]), 3: _privs([1, 2, 5, 6]), 4: _privs([1, 5, 6, 7])}
        src, fcs = _chain_source(sets, lambda h: sets[h])
        verifier = CoalescingVerifier(HostBatchVerifier(), cache_size=0)
        LAUNCHLOG.clear()
        try:
            cert = _cert(seed=fcs[1], trusted=MemProvider(), source=src, verifier=verifier)
            cert.verify_to_height(4)
        finally:
            verifier.close()
        rounds = cert.last_walk_rounds
        assert rounds >= 2
        lc_records = [r for r in LAUNCHLOG.recent() if "lightclient" in (r.get("consumers") or {})]
        assert len(lc_records) == rounds
        for rec in lc_records:
            assert set(rec["consumers"]) == {"lightclient"}


class TestEvidenceExtraction:
    def _pair(self, double_signer_idx=0):
        honest = _full_commit(5, _privs(range(1, 5)))
        forged = forge_fullcommit(honest, self._ordered(honest)[double_signer_idx], CHAIN)
        return honest, forged

    @staticmethod
    def _ordered(fc):
        by_addr = {p.address: p for p in _privs(range(1, 5))}
        return [by_addr[v.address] for v in fc.validators.validators]

    def test_double_sign_becomes_evidence(self):
        honest, forged = self._pair()
        evs = extract_double_sign_evidence(forged, honest, CHAIN, verifier=HOST)
        assert len(evs) == 1
        evs[0].verify(CHAIN, honest.validators, verifier=HOST)
        assert evs[0].height == 5

    def test_garbage_signature_yields_nothing(self):
        honest, forged = self._pair()
        for i, pc in enumerate(forged.commit.precommits):
            if pc is not None:
                forged.commit.precommits[i] = pc.with_signature(b"\x01" * 64)
        assert extract_double_sign_evidence(forged, honest, CHAIN, verifier=HOST) == []

    def test_different_round_cannot_pair(self):
        from dataclasses import replace

        honest, forged = self._pair()
        for i, pc in enumerate(forged.commit.precommits):
            if pc is not None:
                forged.commit.precommits[i] = replace(pc, round=1)
        assert extract_double_sign_evidence(forged, honest, CHAIN, verifier=HOST) == []

    def test_same_block_is_no_conflict(self):
        honest = _full_commit(5, _privs(range(1, 5)))
        assert extract_double_sign_evidence(honest, honest, CHAIN, verifier=HOST) == []

    def test_height_mismatch_yields_nothing(self):
        honest = _full_commit(5, _privs(range(1, 5)))
        other = _full_commit(6, _privs(range(1, 5)))
        assert extract_double_sign_evidence(other, honest, CHAIN, verifier=HOST) == []


class _SwitchStub:
    def __init__(self):
        self.reports = []

    def report_misbehavior(self, peer_id, kind, detail=None):
        self.reports.append((peer_id, kind))

    def peers(self):
        return []


class TestReactorRoundTrip:
    def _wired_pair(self, serve_cache, client_subscribes=False, certifier=None):
        server = LightClientReactor(chain_id=CHAIN, cache=serve_cache, verifier=HOST)
        client = LightClientReactor(chain_id=CHAIN, subscribe=client_subscribes, certifier=certifier,
                                    cache=CertifiedCommitCache(), verifier=HOST)
        sws = []
        for name, reactor in (("server", server), ("client", client)):
            sw = Switch(NodeInfo(node_id=f"lc-{name}", moniker=name, chain_id=CHAIN))
            sw.add_reactor("lightclient", reactor)
            sw.start()
            sws.append(sw)
        connect_switches(sws[0], sws[1])
        return server, client, sws

    def test_request_response_serves_certified_cache(self):
        cache = CertifiedCommitCache()
        privs = _privs(range(1, 5))
        cache.put_certified(_full_commit(3, privs))
        cache.put_certified(_full_commit(7, privs))
        _server, client, sws = self._wired_pair(cache)
        try:
            assert client.request_commit(7).height() == 7
            assert client.request_commit(5).height() == 3  # floor fallback
            assert client.request_commit(0).height() == 7  # the tip
        finally:
            for sw in sws:
                sw.stop()

    def test_concurrent_same_height_requests_all_served(self):
        cache = CertifiedCommitCache()
        cache.put_certified(_full_commit(7, _privs(range(1, 5))))
        _server, client, sws = self._wired_pair(cache)
        try:
            results = []
            lock = threading.Lock()

            def fetch():
                fc = client.request_commit(7)
                with lock:
                    results.append(fc)

            threads = [threading.Thread(target=fetch) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert len(results) == 4
            assert all(fc is not None and fc.height() == 7 for fc in results)
            assert client._waits == {}
        finally:
            for sw in sws:
                sw.stop()

    def test_environmental_push_failure_does_not_score_peer(self):
        privs = _privs(range(1, 5))
        seed = _full_commit(1, privs)
        period_ns = int(3600 * 1e9)
        expired_cert = _cert(seed=seed, trusted=CertifiedCommitCache(), source=MemProvider(),
                             trust_period_ns=period_ns, now_ns=lambda: seed.header.time + period_ns + 1)
        reactor = LightClientReactor(chain_id=CHAIN, subscribe=True, certifier=expired_cert,
                                     cache=CertifiedCommitCache(), verifier=HOST)
        stub = _SwitchStub()
        reactor.switch = stub
        reactor._on_push("honest-peer", _full_commit(5, _privs(range(1, 6))))
        assert stub.reports == []
        assert reactor.cache.get_exact(5) is None

    def test_push_certifies_then_forwards(self):
        privs = _privs(range(1, 5))
        seed = _full_commit(1, privs)
        serve_cache = CertifiedCommitCache()
        serve_cache.put_certified(seed)
        certifier = _cert(seed=seed, trusted=CertifiedCommitCache(), source=None)
        server, client, sws = self._wired_pair(serve_cache, client_subscribes=True, certifier=certifier)
        try:
            fc5 = _full_commit(5, privs)
            server.cache.put_certified(fc5)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not server._subscribers:
                time.sleep(0.02)
            server.announce(fc5)
            while time.monotonic() < deadline and client.cache.get_exact(5) is None:
                time.sleep(0.02)
            assert client.cache.get_exact(5) is not None
            assert client.serving_stats()["last_push_age_s"] is not None
        finally:
            for sw in sws:
                sw.stop()

    def test_forged_push_scores_peer_and_extracts_evidence(self):
        from tendermint_tpu_torch.evidence import EvidencePool
        from tendermint_tpu_torch.telemetry import REGISTRY

        privs = _privs(range(1, 5))
        seed = _full_commit(1, privs)
        honest5 = _full_commit(5, privs)
        pool = EvidencePool(chain_id=CHAIN)
        certifier = _cert(seed=seed, trusted=CertifiedCommitCache(), source=None)
        _server, client, sws = self._wired_pair(CertifiedCommitCache(), client_subscribes=True,
                                                certifier=certifier)
        client.evidence_pool = pool
        try:
            client.cache.put_certified(honest5)
            certifier.certify(honest5)
            by_addr = {p.address: p for p in privs}
            compromised = by_addr[honest5.validators.validators[0].address]
            forged = forge_fullcommit(honest5, compromised, CHAIN)
            base = REGISTRY.counter_value("tendermint_p2p_peer_misbehavior_total", kind="forged_fullcommit")
            peer = sws[0].peers()[0]
            peer.try_send(lcr.LIGHTCLIENT_CHANNEL, lcr._enc_fc_announce(forged))
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and pool.depth() == 0:
                time.sleep(0.02)
            assert pool.depth() == 1
            assert pool.pending_evidence()[0].address == compromised.address
            delta = REGISTRY.counter_value("tendermint_p2p_peer_misbehavior_total", kind="forged_fullcommit") - base
            assert delta >= 1
            assert sws[1].scorer.is_banned("lc-server")
            assert client.cache.get_exact(5).header.app_hash == honest5.header.app_hash
        finally:
            pool.close()
            for sw in sws:
                sw.stop()


# -- across the packages ---------------------------------------------------------------


def _p(jfc):
    return FullCommit.decode(jfc.encode())


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is part of what is compared
        return type(e).__name__, str(e)
    return None


def _dense(h):
    base = list(range(1, 9))
    rotated = (h - 1) // 4
    ids = base[rotated % 8:] + [100 + i for i in range(rotated)]
    return sorted(ids[-8:])


_ROT = {1: [1, 2, 3, 4], 2: [1, 2, 3, 5], 3: [1, 2, 5, 6], 4: [1, 5, 6, 7]}
_GAP = {1: [1, 2, 3, 4], 4: [1, 5, 6, 7]}
SCENARIOS = {
    # name: (heights, ids at height h, target, how to walk, forge)
    "stable": ((1, 64, 128, 200, 256), lambda h: range(1, 5), 256, "walk", None),
    "rotation": (tuple(_ROT), lambda h: _ROT[h], 4, "certify", None),
    "dense": (tuple(range(1, 65)), _dense, 64, "walk", None),
    "gap": (tuple(_GAP), lambda h: _GAP[h], 4, "certify", None),
    "third": ((1, 2), lambda h: range(1, 10) if h == 1 else [1, 2, 3] + list(range(20, 26)), 2, "walk", None),
    "above_third": ((1, 2), lambda h: range(1, 10) if h == 1 else [1, 2, 3, 4] + list(range(20, 25)), 2, "walk",
                    None),
    "forged_sig": ((1, 10), lambda h: range(1, 5), 10, "walk", "sig"),
    "quorumless": ((1, 10), lambda h: range(1, 5), 10, "walk", "quorum"),
    "floor": ((1, 40, 90), lambda h: [1, 2, 3, 4] if h < 50 else [1, 2, 3, 9], 75, "walk", None),
    "no_source": ((1,), lambda h: range(1, 5), 10, "walk", None),
}


def _run_both(name, monkeypatch):
    """Both packages' certifiers on one source (the JAX FullCommits, the
    port's by wire form): (JAX, port) each as (outcome, last height,
    rounds, verifies, trusted heights)."""
    import dataclasses

    heights, ids, target, how, forge = SCENARIOS[name]
    jfcs = {h: j_full_commit(h, j_privs(ids(h))) for h in heights}
    if forge == "sig":
        bad = jfcs[10].commit.precommits[1]
        jfcs[10].commit.precommits[1] = bad.with_signature(bad.signature[:5] + bytes([bad.signature[5] ^ 1])
                                                           + bad.signature[6:])
    elif forge == "quorum":
        c = jfcs[10].commit
        keep = next(i for i, p in enumerate(c.precommits) if p is not None)
        jfcs[10].commit = dataclasses.replace(c, precommits=[p if i == keep else None
                                                             for i, p in enumerate(c.precommits)])
    jsrc, psrc = JMemProvider(), MemProvider()
    for h in heights:
        jsrc.store_commit(jfcs[h])
        psrc.store_commit(_p(jfcs[h]))
    out = []
    for pkg, src, cache_cls, cls in (("jax", jsrc, JCertifiedCommitCache, JBisectingCertifier),
                                     ("port", psrc, CertifiedCommitCache, BisectingCertifier)):
        seed = jfcs[1] if pkg == "jax" else _p(jfcs[1])
        kw = {"verifier": HOST} if pkg == "port" else {}
        trusted = cache_cls()
        cert = cls(CHAIN, seed=seed, trusted=trusted, source=src if name != "no_source" else type(src)(), **kw)
        if how == "walk":
            res = _outcome(lambda: cert.verify_to_height(target))
        else:
            res = _outcome(lambda: cert.certify(jfcs[target] if pkg == "jax" else _p(jfcs[target])))
        held = [h for h in range(1, target + 1) if trusted.get_exact(h) is not None]
        out.append((res, cert.last_height, cert.last_walk_rounds, cert.last_walk_verifies, held,
                    cert.validators.hash()))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_walks_equal_the_jax_certifier_on_one_source(name, monkeypatch):
    jax, port = _run_both(name, monkeypatch)
    assert port == jax


def test_the_hijack_walk_equals_the_jax_certifier():
    jsrc, jseed, jforged = _hijack_source(j_privs, j_full_commit, _types("tendermint_tpu"))
    psrc, pseed = MemProvider(), _p(jseed)
    psrc.store_commit(pseed)
    psrc.store_commit(_p(jforged))
    jcert = JBisectingCertifier(CHAIN, seed=jseed, trusted=JMemProvider(), source=jsrc)
    pcert = _cert(seed=pseed, trusted=MemProvider(), source=psrc)
    assert _outcome(lambda: pcert.verify_to_height(10)) == _outcome(lambda: jcert.verify_to_height(10))
    assert (pcert.last_height, pcert.last_walk_rounds, pcert.last_walk_verifies) == (
        jcert.last_height, jcert.last_walk_rounds, jcert.last_walk_verifies)


def test_extracted_evidence_equals_the_jax_package():
    honest = j_full_commit(5, j_privs(range(1, 5)))
    by_addr = {p.address: p for p in j_privs(range(1, 5))}
    for v in honest.validators.validators:
        jforged = j_forge_fullcommit(honest, by_addr[v.address], CHAIN)
        jevs = j_extract(jforged, honest, CHAIN)
        pevs = extract_double_sign_evidence(_p(jforged), _p(honest), CHAIN, verifier=HOST)
        assert [e.encode() for e in pevs] == [e.encode() for e in jevs] and len(jevs) == 1
    pb = FullCommit.decode(honest.encode())
    by_paddr = {p.address: p for p in _privs(range(1, 5))}
    assert forge_fullcommit(pb, by_paddr[pb.validators.validators[1].address], CHAIN).encode() == \
        j_forge_fullcommit(honest, by_addr[honest.validators.validators[1].address], CHAIN).encode()


def test_reactor_frames_encode_as_the_jax_reactor():
    fc = j_full_commit(7, j_privs(range(1, 5)))
    assert lcr._enc_fc_request(7) == J_lcr._enc_fc_request(7)
    assert lcr._enc_fc_response(7, _p(fc)) == J_lcr._enc_fc_response(7, fc)
    assert lcr._enc_fc_response(7, None) == J_lcr._enc_fc_response(7, None)
    assert lcr._enc_fc_subscribe() == J_lcr._enc_fc_subscribe()
    assert lcr._enc_fc_announce(_p(fc)) == J_lcr._enc_fc_announce(fc)
    assert lcr.LIGHTCLIENT_CHANNEL == J_lcr.LIGHTCLIENT_CHANNEL == 0x68
    kind, (h, got) = lcr.decode_message(J_lcr._enc_fc_response(7, fc))
    assert (kind, h, got.encode()) == ("fc_response", 7, fc.encode())


def test_cache_answers_equal_the_jax_cache():
    jc, pc = JCertifiedCommitCache(capacity=5), CertifiedCommitCache(capacity=5)
    for h in (3, 9, 4, 12, 20, 7, 15):
        fc = j_full_commit(h, j_privs(range(1, 5)))
        jc.put_certified(fc)
        pc.put_certified(_p(fc))
    before = jc.stats(), pc.stats()
    for q in range(0, 25):
        j, p = jc.get_by_height(q), pc.get_by_height(q)
        assert (j.encode() if j else None) == (p.encode() if p else None)
        j, p = jc.get_exact(q), pc.get_exact(q)
        assert (j.encode() if j else None) == (p.encode() if p else None)
    after = jc.stats(), pc.stats()
    # the hit and miss counters are each package's process-wide families
    moved = [{k: a[k] - b[k] if k in ("hits", "misses") else a[k] for k in a} for a, b in zip(after, before)]
    assert moved[0] == moved[1]


@pytest.mark.parametrize("direction", ["jax_serves_port", "port_serves_jax"])
def test_a_walk_over_the_0x68_channel_across_the_packages(direction):
    """A rotating chain served by one package's reactor over localhost
    TCP; the other package's certifier walks it through its
    `PeerProvider`, and ends where a walk over the JAX source does."""
    jfcs = {h: j_full_commit(h, j_privs(_dense(h))) for h in range(1, 65)}
    ref = JBisectingCertifier(CHAIN, seed=jfcs[1], trusted=JMemProvider(), source=_jsrc(jfcs))
    ref.verify_to_height(64)
    if direction == "jax_serves_port":
        cache = JCertifiedCommitCache()
        for fc in jfcs.values():
            cache.put_certified(fc)
        srv = JSwitch(JNodeInfo(node_id="jax-lc", moniker="jax-lc", chain_id=CHAIN))
        srv.add_reactor("lightclient", J_lcr.LightClientReactor(chain_id=CHAIN, cache=cache))
        srv.start()
        lis = J_tcp.TcpListener(srv, "tcp://127.0.0.1:0")
        cli_reactor = LightClientReactor(chain_id=CHAIN, verifier=HOST)
        cli = Switch(NodeInfo(node_id="port-lc", moniker="port-lc", chain_id=CHAIN))
        cli.add_reactor("lightclient", cli_reactor)
        cli.start()
        dial = tcp.dial
        cert = _cert(seed=_p(jfcs[1]), trusted=CertifiedCommitCache(), source=PeerProvider(cli_reactor))
    else:
        cache = CertifiedCommitCache()
        for fc in jfcs.values():
            cache.put_certified(_p(fc))
        srv = Switch(NodeInfo(node_id="port-lc", moniker="port-lc", chain_id=CHAIN))
        srv.add_reactor("lightclient", LightClientReactor(chain_id=CHAIN, cache=cache, verifier=HOST))
        srv.start()
        lis = tcp.TcpListener(srv, "tcp://127.0.0.1:0")
        cli_reactor = J_lcr.LightClientReactor(chain_id=CHAIN)
        cli = JSwitch(JNodeInfo(node_id="jax-lc", moniker="jax-lc", chain_id=CHAIN))
        cli.add_reactor("lightclient", cli_reactor)
        cli.start()
        dial = J_tcp.dial
        cert = JBisectingCertifier(CHAIN, seed=jfcs[1], trusted=JCertifiedCommitCache(),
                                   source=J_lcr.PeerProvider(cli_reactor))
    try:
        dial(cli, f"127.0.0.1:{lis.port}")
        cert.verify_to_height(64)
    finally:
        cli.stop()
        lis.stop()
        srv.stop()
    assert (cert.last_height, cert.last_walk_rounds, cert.last_walk_verifies) == (
        ref.last_height, ref.last_walk_rounds, ref.last_walk_verifies)
    assert cert.validators.hash() == ref.validators.hash()


def _jsrc(jfcs):
    src = JMemProvider()
    for fc in jfcs.values():
        src.store_commit(fc)
    return src


def test_lightclient_and_statesync_reactors_match_the_gossip_tables():
    """The JAX `test_gossiplog.py` cross-checks of the gossip tables
    against the lightclient and statesync reactors, on the port's."""
    import tendermint_tpu_torch.statesync.reactor as ss
    from tendermint_tpu_torch.telemetry.gossiplog import CHANNEL_NAMES, KIND_TAGS

    assert CHANNEL_NAMES[ss.STATESYNC_CHANNEL] == "statesync"
    assert CHANNEL_NAMES[lcr.LIGHTCLIENT_CHANNEL] == "lightclient"
    assert KIND_TAGS[ss.STATESYNC_CHANNEL] == {
        ss._MSG_SNAPSHOTS_REQUEST: "snapshots_request",
        ss._MSG_SNAPSHOTS_RESPONSE: "snapshots_response",
        ss._MSG_CHUNK_REQUEST: "chunk_request",
        ss._MSG_CHUNK_RESPONSE: "chunk_response",
        ss._MSG_NO_CHUNK: "no_chunk",
        ss._MSG_COMMIT_REQUEST: "commit_request",
        ss._MSG_COMMIT_RESPONSE: "commit_response",
    }
    assert KIND_TAGS[lcr.LIGHTCLIENT_CHANNEL] == {
        lcr._MSG_FC_REQUEST: "fc_request",
        lcr._MSG_FC_RESPONSE: "fc_response",
        lcr._MSG_FC_SUBSCRIBE: "fc_subscribe",
        lcr._MSG_FC_ANNOUNCE: "fc_announce",
    }


def test_lightclient_metric_families_and_span_are_cataloged():
    from tendermint_tpu_torch.telemetry import REGISTRY
    from tendermint_tpu_torch.telemetry.metrics import SPAN_CATALOG

    for name in ("tendermint_lightclient_bisections_total", "tendermint_lightclient_cache_hits_total",
                 "tendermint_lightclient_cache_misses_total", "tendermint_lightclient_walk_seconds",
                 "tendermint_replica_proofs_served_total"):
        assert REGISTRY.get(name) is not None, name
    assert "lightclient.walk" in SPAN_CATALOG
