"""The port's state sync (`tendermint_tpu_torch/statesync/`) against the
JAX package's.

The JAX package's own `tests/test_statesync.py` runs again on the port:
manifest round-trips, chunk-tree verification (corrupt, duplicated,
out-of-order chunks, a wrong count), the async chunk gate (its join, the
hasher's async seam, a device fault degrading inside the handle), the
snapshot store, the trust anchor's rejections, the chunk pool's
timeouts and requeues, the block store's base, prune and bootstrap, and
the serving lifecycle (the cadence resumed after a restart, retained
blocks). The JAX cases that run a `Nemesis` net build their store with
the port's `ChainSim` instead; `TestStateSyncEndToEnd` waits for the
port's node and nemesis (ROADMAP A8, A9).

Across the packages, seeded: the same state, app bytes and block tail
give byte-equal manifests, chunks and roots through both packages'
`SnapshotStore`, and every gate outcome (class name and message)
agrees; a restore crosses the packages both ways over localhost TCP (a
port node state-syncs a JAX server's snapshot and fast-syncs its tail,
a JAX node does the same from a port server), each ending with the
serving chain's blocks, state JSON and app hash; the reactors' frames
encode alike. A JAX object reaches the port only as its wire or JSON
form. Tolerance: exact.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from tendermint_tpu.abci.apps import KVStoreApp as JKVStoreApp
from tendermint_tpu.abci.client import local_client_creator as j_local_client_creator
from tendermint_tpu.blockchain import BlockchainReactor as JBlockchainReactor
from tendermint_tpu.blockchain import BlockStore as JBlockStore
from tendermint_tpu.db.kv import MemDB as JMemDB
from tendermint_tpu.p2p import NodeInfo as JNodeInfo
from tendermint_tpu.p2p import Switch as JSwitch
from tendermint_tpu.p2p import tcp as J_tcp
from tendermint_tpu.services.hasher import TreeHasher as JTreeHasher
from tendermint_tpu.state import make_genesis_state as j_make_genesis_state
from tendermint_tpu.statesync import reactor as J_ssr
from tendermint_tpu.statesync import snapshot as J_snap
from tendermint_tpu.statesync import trust as J_trust
from tendermint_tpu.types.errors import ValidationError as JValidationError
from tendermint_tpu_torch import types as P
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.codec.binary import Reader
from tendermint_tpu_torch.db.kv import MemDB
from tendermint_tpu_torch.merkle.simple import leaf_hash
from tendermint_tpu_torch.p2p import tcp
from tendermint_tpu_torch.services.hasher import TreeHasher
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.state.state import State, make_genesis_state
from tendermint_tpu_torch.statesync import reactor as ssr
from tendermint_tpu_torch.statesync.reactor import ChunkPool
from tendermint_tpu_torch.statesync.snapshot import (
    SnapshotManifest,
    SnapshotStore,
    build_payload,
    decode_payload,
    split_chunks,
    verify_chunks,
    verify_chunks_async,
)
from tendermint_tpu_torch.statesync.trust import TrustAnchor, TrustOptions
from tendermint_tpu_torch.testing import (
    TEST_CHAIN_ID as CHAIN_ID,
    ChainSim,
    StateSyncingNode,
    lockrank_report,
    make_genesis,
    make_validators,
    snapshot_server,
)
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.utils import fail

from tests.helpers import ChainSim as JChainSim

torch.set_num_threads(1)

HOST_HASHER = TreeHasher(backend="host")
J_HOST_HASHER = JTreeHasher(backend="host")
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


@pytest.fixture(autouse=True)
def _clean_faults():
    fail.clear_device_faults()
    yield
    fail.clear_device_faults()


def wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _snapshot_state(height=5, app_hash=b"\xaa" * 20, chain_id="ss-chain"):
    genesis, _ = make_genesis(4, chain_id=chain_id)
    st = make_genesis_state(MemDB(), genesis)
    st.last_block_height = height
    st.app_hash = app_hash
    return st


def _chain(n_heights, n_vals=4):
    """A port chain on the host verifier, saved into a block store as it
    grows."""
    sim = ChainSim(n_vals=n_vals, verifier=HOST, hasher=HOST_HASHER)
    store = BlockStore(MemDB())
    for h in range(1, n_heights + 1):
        block = sim.advance(txs=[b"k%d-%d=v%d" % (h, i, i) for i in range(h % 3 + 1)])
        store.save_block(block, block.make_part_set(hasher=HOST_HASHER), sim.commits[-1])
    return sim, store


# -- tests/test_statesync.py -----------------------------------------------------------


class TestManifest:
    def _manifest(self, payload=b"x" * 1000, chunk_size=128):
        st = _snapshot_state()
        store = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=chunk_size)
        return store.take(st, payload), store

    def test_roundtrip(self):
        m, _ = self._manifest()
        m2 = SnapshotManifest.from_json(m.to_json())
        assert m2.to_json() == m.to_json()
        assert (m2.height, m2.chunks, m2.root) == (m.height, m.chunks, m.root)
        m2.validate_basic()
        m2.verify_root(HOST_HASHER)

    def test_validate_rejects_inconsistencies(self):
        m, _ = self._manifest()
        bad = SnapshotManifest.from_json(m.to_json())
        bad.chunks += 1
        with pytest.raises(ValidationError):
            bad.validate_basic()
        bad = SnapshotManifest.from_json(m.to_json())
        bad.payload_len = bad.chunks * bad.chunk_size + 1
        with pytest.raises(ValidationError):
            bad.validate_basic()
        bad = SnapshotManifest.from_json(m.to_json())
        bad.root = b""
        with pytest.raises(ValidationError):
            bad.validate_basic()

    def test_forged_chunk_hash_list_fails_root_check(self):
        m, _ = self._manifest()
        forged = SnapshotManifest.from_json(m.to_json())
        forged.chunk_hashes[0] = leaf_hash(b"not the chunk")
        with pytest.raises(ValidationError, match="root"):
            forged.verify_root(HOST_HASHER)


class TestChunkVerification:
    def _take(self):
        st = _snapshot_state()
        store = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=100)
        m = store.take(st, b"app" * 400)
        chunks = [store.load_chunk(m.height, m.format, i) for i in range(m.chunks)]
        return m, chunks

    def test_clean_set_verifies(self):
        m, chunks = self._take()
        verify_chunks(m, chunks, HOST_HASHER)

    def test_corrupted_chunk_detected(self):
        m, chunks = self._take()
        chunks[1] = bytes(b ^ 0xFF for b in chunks[1])
        with pytest.raises(ValidationError, match="chunk 1"):
            verify_chunks(m, chunks, HOST_HASHER)

    def test_out_of_order_chunks_detected(self):
        m, chunks = self._take()
        chunks[0], chunks[1] = chunks[1], chunks[0]
        with pytest.raises(ValidationError):
            verify_chunks(m, chunks, HOST_HASHER)

    def test_duplicated_chunk_detected(self):
        m, chunks = self._take()
        chunks[2] = chunks[1]
        with pytest.raises(ValidationError):
            verify_chunks(m, chunks, HOST_HASHER)

    def test_wrong_count_detected(self):
        m, chunks = self._take()
        with pytest.raises(ValidationError):
            verify_chunks(m, chunks[:-1], HOST_HASHER)

    def test_payload_roundtrip(self):
        st = _snapshot_state()
        payload = build_payload(st, b"app-bytes", [])
        state_json, app, tail = decode_payload(payload)
        assert json.loads(state_json) == json.loads(st.to_json())
        assert app == b"app-bytes"
        assert tail == []
        assert b"".join(split_chunks(payload, 7)) == payload


class TestChunkVerifyAsyncGate:
    """The chunk-verify gate as a dispatch handle: hashing launches
    through the hasher's async seam, the comparison and root fold run at
    the join, and device faults degrade to host hashlib inside the
    handle."""

    def _take(self):
        st = _snapshot_state()
        store = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=100)
        m = store.take(st, b"app" * 400)
        chunks = [store.load_chunk(m.height, m.format, i) for i in range(m.chunks)]
        return m, chunks

    def test_clean_set_resolves_true_at_join(self):
        m, chunks = self._take()
        gate = verify_chunks_async(m, chunks, HOST_HASHER)
        assert gate.result() is True

    def test_corrupt_chunk_raises_at_join_not_submit(self):
        m, chunks = self._take()
        chunks[1] = bytes(b ^ 0xFF for b in chunks[1])
        gate = verify_chunks_async(m, chunks, HOST_HASHER)  # must not raise
        with pytest.raises(ValidationError, match="chunk 1"):
            gate.result()

    def test_wrong_count_is_an_error_handle(self):
        m, chunks = self._take()
        gate = verify_chunks_async(m, chunks[:-1], HOST_HASHER)
        with pytest.raises(ValidationError, match="chunks"):
            gate.result()

    def test_routes_through_the_hashers_async_seam(self):
        from tendermint_tpu_torch.services.dispatch import DispatchQueue

        class _Recording(TreeHasher):
            def __init__(self):
                super().__init__(backend="host")
                self.async_calls = 0

            def leaf_hashes_async(self, items, queue=None):
                self.async_calls += 1
                return super().leaf_hashes_async(items, queue=queue)

        hasher = _Recording()
        m, chunks = self._take()
        q = DispatchQueue(depth=2, name="test-chunk-gate")
        try:
            assert verify_chunks_async(m, chunks, hasher, queue=q).result() is True
        finally:
            q.close()
        assert hasher.async_calls == 1

    def test_device_fault_degrades_inside_the_gate(self):
        from tendermint_tpu_torch.services.dispatch import DispatchQueue
        from tendermint_tpu_torch.services.resilient import ResilientTreeHasher
        from tendermint_tpu_torch.utils.circuit import OPEN, CircuitBreaker

        rh = ResilientTreeHasher(
            TreeHasher(backend="host"),
            breaker=CircuitBreaker(failure_threshold=1, reset_timeout_s=60),
            max_retries=0,
        )
        fail.set_device_fault("hash")
        m, chunks = self._take()
        q = DispatchQueue(depth=2, name="test-chunk-gate-fault")
        try:
            # a faulted launch re-hashes on the host inside the handle
            assert verify_chunks_async(m, chunks, rh, queue=q).result() is True
        finally:
            q.close()
        assert rh.breaker.state == OPEN
        chunks[0] = b"garbage" + chunks[0][7:]
        q2 = DispatchQueue(depth=2, name="test-chunk-gate-fault2")
        try:
            with pytest.raises(ValidationError, match="chunk 0"):
                verify_chunks_async(m, chunks, rh, queue=q2).result()
        finally:
            q2.close()


class TestSnapshotStore:
    def test_prune_keeps_newest(self):
        store = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=64, keep_recent=2)
        for h in (3, 6, 9):
            store.take(_snapshot_state(height=h), b"s" * 100)
        assert [m.height for m in store.list_manifests()] == [6, 9]
        assert store.load_chunk(3, 1, 0) is None
        assert store.load_chunk(9, 1, 0) is not None

    def test_corrupt_chunk_hook(self):
        store = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=64)
        m = store.take(_snapshot_state(), b"s" * 100)
        before = store.load_chunk(m.height, m.format, 0)
        assert store.corrupt_chunk(m.height, m.format, 0)
        assert store.load_chunk(m.height, m.format, 0) != before


def _full_commit(height, valset, privs, app_hash=b"", chain_id=CHAIN_ID, forge=False):
    """A signed FullCommit over a synthetic header, or a forged one whose
    votes are signed by keys outside the validator set."""
    from tendermint_tpu_torch.certifiers.certifier import FullCommit
    from tendermint_tpu_torch.crypto import PrivKey
    from tendermint_tpu_torch.types import PrivValidator
    from tendermint_tpu_torch.types.block import Commit, Header
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.part_set import PartSetHeader
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote

    header = Header(
        chain_id=chain_id,
        height=height,
        time=1_700_000_000_000_000_000,
        num_txs=0,
        last_block_id=BlockID.zero(),
        last_commit_hash=b"\x01" * 20,
        data_hash=b"",
        validators_hash=valset.hash(),
        app_hash=app_hash,
    )
    h = header.hash()
    block_id = BlockID(hash=h, parts_header=PartSetHeader(total=1, hash=h[:20]))
    signers = privs
    if forge:
        signers = [PrivValidator(PrivKey((100 + i).to_bytes(32, "little"))) for i in range(len(privs))]
    votes = []
    for i, (real, signer) in enumerate(zip(privs, signers)):
        v = Vote(validator_address=real.address, validator_index=i, height=height, round=0, timestamp=1000,
                 type=VOTE_TYPE_PRECOMMIT, block_id=block_id)
        votes.append(v.with_signature(signer._signer.sign(v.sign_bytes(chain_id))))
    return FullCommit(header=header, commit=Commit(block_id=block_id, precommits=votes), validators=valset)


def _manifest_for(height, app_hash, chain_id=CHAIN_ID):
    st = _snapshot_state(height=height, app_hash=app_hash, chain_id=chain_id)
    store = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=128)
    return store.take(st, b"app" * 10)


class TestTrustAnchor:
    def setup_method(self):
        self.valset, self.privs = make_validators(4)
        self.anchor = TrustAnchor(CHAIN_ID, self.valset, verifier=HOST)

    def test_accepts_genuine_commit(self):
        app_hash = b"\xaa" * 20
        manifest = _manifest_for(7, app_hash)
        fc = _full_commit(8, self.valset, self.privs, app_hash=app_hash)
        self.anchor.verify_snapshot(manifest, fc)

    def test_rejects_forged_signatures(self):
        app_hash = b"\xaa" * 20
        manifest = _manifest_for(7, app_hash)
        fc = _full_commit(8, self.valset, self.privs, app_hash=app_hash, forge=True)
        with pytest.raises(ValidationError):
            self.anchor.verify_snapshot(manifest, fc)

    def test_rejects_app_hash_mismatch(self):
        manifest = _manifest_for(7, b"\xaa" * 20)
        fc = _full_commit(8, self.valset, self.privs, app_hash=b"\xbb" * 20)
        with pytest.raises(ValidationError, match="app_hash"):
            self.anchor.verify_snapshot(manifest, fc)

    def test_rejects_wrong_anchor_height(self):
        app_hash = b"\xaa" * 20
        manifest = _manifest_for(7, app_hash)
        fc = _full_commit(9, self.valset, self.privs, app_hash=app_hash)
        with pytest.raises(ValidationError, match="anchor"):
            self.anchor.verify_snapshot(manifest, fc)

    def test_rejects_wrong_chain(self):
        manifest = _manifest_for(7, b"\xaa" * 20, chain_id="other-chain")
        fc = _full_commit(8, self.valset, self.privs, app_hash=b"\xaa" * 20)
        with pytest.raises(ValidationError, match="chain"):
            self.anchor.verify_snapshot(manifest, fc)

    def test_trust_pin_must_match(self):
        app_hash = b"\xaa" * 20
        pin_fc = _full_commit(3, self.valset, self.privs)
        anchor = TrustAnchor(CHAIN_ID, self.valset, TrustOptions(height=3, hash_=pin_fc.header.hash()),
                             verifier=HOST)
        manifest = _manifest_for(7, app_hash)
        fc = _full_commit(8, self.valset, self.privs, app_hash=app_hash)
        anchor.verify_snapshot(manifest, fc, pin_fc)  # the genuine pin
        bad = TrustAnchor(CHAIN_ID, self.valset, TrustOptions(height=3, hash_=b"\x13" * 32), verifier=HOST)
        with pytest.raises(ValidationError, match="pinned"):
            bad.verify_snapshot(manifest, fc, pin_fc)
        # a snapshot below the trust root can never anchor
        low = _manifest_for(2, app_hash)
        low_fc = _full_commit(3, self.valset, self.privs, app_hash=app_hash)
        with pytest.raises(ValidationError, match="below trust root"):
            anchor.verify_snapshot(low, low_fc, pin_fc)

    def test_trust_period_expiry(self):
        app_hash = b"\xaa" * 20
        manifest = _manifest_for(7, app_hash)
        fc = _full_commit(8, self.valset, self.privs, app_hash=app_hash)
        fresh = TrustAnchor(CHAIN_ID, self.valset, TrustOptions(trust_period_ns=int(3600e9)), verifier=HOST,
                            now_ns=lambda: fc.header.time + int(60e9))
        fresh.verify_snapshot(manifest, fc)
        stale = TrustAnchor(CHAIN_ID, self.valset, TrustOptions(trust_period_ns=int(3600e9)), verifier=HOST,
                            now_ns=lambda: fc.header.time + int(7200e9))
        with pytest.raises(ValidationError, match="trust period"):
            stale.verify_snapshot(manifest, fc)

    def test_restored_state_must_match_certified_header(self):
        app_hash = b"\xaa" * 20
        fc = _full_commit(8, self.valset, self.privs, app_hash=app_hash)
        st = _snapshot_state(height=7, app_hash=app_hash, chain_id=CHAIN_ID)
        st.validators = self.valset
        self.anchor.verify_restored_state(st, fc)
        st2 = _snapshot_state(height=7, app_hash=b"\xcc" * 20, chain_id=CHAIN_ID)
        st2.validators = self.valset
        with pytest.raises(ValidationError):
            self.anchor.verify_restored_state(st2, fc)

    def test_verifier_none_is_the_card_stack_and_raises_without_a_card(self, monkeypatch):
        from tendermint_tpu_torch.services import verifier as V

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(V, "_DEFAULTS", {})
        anchor = TrustAnchor(CHAIN_ID, self.valset)
        app_hash = b"\xaa" * 20
        with pytest.raises(RuntimeError):
            anchor.verify_snapshot(_manifest_for(7, app_hash),
                                   _full_commit(8, self.valset, self.privs, app_hash=app_hash))


class TestChunkPool:
    def test_inflight_limit_and_assignment(self):
        now = [0.0]
        pool = ChunkPool(10, inflight_per_peer=2, request_timeout_s=5.0, time_fn=lambda: now[0])
        pool.add_peer("a")
        pool.add_peer("b")
        reqs, evicted = pool.schedule()
        assert not evicted
        assert len(reqs) == 4  # 2 a peer
        per_peer = {}
        for p, _i in reqs:
            per_peer[p] = per_peer.get(p, 0) + 1
        assert per_peer == {"a": 2, "b": 2}

    def test_only_assigned_peer_may_answer(self):
        pool = ChunkPool(4, inflight_per_peer=4)
        pool.add_peer("a")
        reqs, _ = pool.schedule()
        idx = reqs[0][1]
        assert not pool.add_chunk("b", idx, b"x")  # unsolicited
        assert pool.add_chunk("a", idx, b"x")
        assert not pool.add_chunk("a", idx, b"x")  # duplicate

    def test_timeout_evicts_and_requeues(self):
        now = [0.0]
        pool = ChunkPool(2, inflight_per_peer=2, request_timeout_s=5.0, time_fn=lambda: now[0])
        pool.add_peer("slow")
        pool.add_peer("ok")
        reqs, _ = pool.schedule()
        by_peer = {p: i for p, i in reqs}
        assert set(by_peer) == {"slow", "ok"}
        pool.add_chunk("ok", by_peer["ok"], b"ok-data")
        now[0] = 6.0  # the slow peer's request is now stale
        reqs2, evicted = pool.schedule()
        assert evicted == ["slow"]
        assert pool.num_peers() == 1
        assert ("ok", by_peer["slow"]) in reqs2
        pool.add_chunk("ok", by_peer["slow"], b"more")
        assert pool.is_complete()

    def test_requeue_after_bad_hash(self):
        pool = ChunkPool(1, inflight_per_peer=1)
        pool.add_peer("a")
        pool.schedule()
        assert pool.add_chunk("a", 0, b"corrupt")
        pool.requeue(0)
        assert not pool.is_complete()
        reqs, _ = pool.schedule()
        assert reqs == [("a", 0)]

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_schedule_equals_the_jax_pool(self, seed):
        import random

        rnd = random.Random(seed)
        now = [0.0]
        port = ChunkPool(40, inflight_per_peer=3, request_timeout_s=5.0, time_fn=lambda: now[0])
        jax = J_ssr.ChunkPool(40, inflight_per_peer=3, request_timeout_s=5.0, time_fn=lambda: now[0])
        for pool in (port, jax):
            pool.add_peer("a")
        for _ in range(30):
            now[0] += rnd.choice([0.5, 1.0, 6.0])
            got = [pool.schedule() for pool in (port, jax)]
            assert sorted(got[0][0]) == sorted(got[1][0]) and got[0][1] == got[1][1]
            for p, i in got[0][0]:
                if rnd.random() < 0.7:
                    assert port.add_chunk(p, i, b"c%d" % i) == jax.add_chunk(p, i, b"c%d" % i)
            if rnd.random() < 0.2:
                for pool in (port, jax):
                    pool.add_peer("b")
        assert port.is_complete() == jax.is_complete()


class TestBlockStoreBase:
    def test_fresh_store_base_zero_then_tracks(self):
        store = BlockStore(MemDB())
        assert store.base == 0 and store.height == 0
        assert store.load_block(5) is None

    def test_prune_bounds_history(self):
        # a real store from a 4-validator chain (the JAX case runs a 1-node net)
        _sim, store = _chain(6)
        assert store.base == 1
        assert store.prune(4) == 3
        assert store.base == 4
        for h in (1, 2, 3):
            assert store.load_block(h) is None
            assert store.load_block_meta(h) is None
            assert store.load_seen_commit(h) is None
        assert store.load_block(4) is not None
        assert store.load_block_commit(3) is not None  # kept for block 4
        store2 = BlockStore(store._db)
        assert store2.base == 4 and store2.height == store.height
        assert store2.prune(2) == 0

    def test_bootstrap_from_tail(self):
        _sim, src = _chain(5)
        tail = [(src.load_block(h), src.load_seen_commit(h)) for h in (4, 5)]
        dst = BlockStore(MemDB())
        dst.bootstrap(tail)
        assert dst.base == 4 and dst.height == 5
        assert dst.load_block(3) is None
        assert dst.load_block(4).hash() == tail[0][0].hash()
        assert dst.load_block_commit(4) is not None  # from block 5's LastCommit
        with pytest.raises(ValidationError):
            dst.bootstrap(tail)


class TestServingLifecycle:
    """A restart resumes the persisted snapshot cadence and
    `retain_blocks` bounds the block store after each take."""

    def test_restart_resumes_snapshot_cadence(self):
        sim = ChainSim(n_vals=4, verifier=HOST)
        store = BlockStore(MemDB())

        def advance_to(height):
            while store.height < height:
                block = sim.advance()
                store.save_block(block, block.make_part_set(), sim.commits[-1])

        advance_to(10)
        db = MemDB()
        first = ssr.StateSyncReactor(SnapshotStore(db, hasher=HOST_HASHER, chunk_size=64), store, sim.state,
                                     snapshot_interval=5)
        assert first.maybe_take_snapshot(sim.state, app=sim.app) is not None
        reborn = SnapshotStore(db, hasher=HOST_HASHER, chunk_size=64)
        assert [m.height for m in reborn.list_manifests()] == [10]
        reactor = ssr.StateSyncReactor(reborn, store, sim.state, snapshot_interval=5)
        assert reactor._last_snapshot_height == 10
        advance_to(12)
        assert reactor.maybe_take_snapshot(sim.state, app=sim.app) is None
        advance_to(15)
        taken = reactor.maybe_take_snapshot(sim.state, app=sim.app)
        assert taken is not None and taken.height == 15

    def test_retain_blocks_prunes_store_after_snapshot(self):
        sim, store = _chain(12)
        reactor = ssr.StateSyncReactor(SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=64), store,
                                       sim.state, snapshot_interval=5, retain_blocks=4)
        assert reactor.maybe_take_snapshot(sim.state, app=sim.app) is not None
        assert store.base == 9 and store.height == 12
        assert store.load_block(8) is None
        assert store.load_block(9) is not None

    def test_retain_blocks_zero_keeps_everything(self):
        sim, store = _chain(6)
        reactor = ssr.StateSyncReactor(SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=64), store,
                                       sim.state, snapshot_interval=5, retain_blocks=0)
        assert reactor.maybe_take_snapshot(sim.state, app=sim.app) is not None
        assert store.base == 1 and store.load_block(1) is not None


# -- across the packages ---------------------------------------------------------------

CROSS_HEIGHTS = 14
CROSS_SNAPSHOT = 8
CROSS_CHUNK = 700


@pytest.fixture(scope="module")
def jax_chain():
    """A JAX chain of CROSS_HEIGHTS heights with txs in a JAX block store,
    its app snapshot (the JAX `KVStoreApp`'s) and state at
    CROSS_SNAPSHOT."""
    sim = JChainSim(n_vals=4)
    store = JBlockStore(JMemDB())
    snap = None
    sim.state_jsons = [sim.state.to_json()]
    for h in range(1, CROSS_HEIGHTS + 1):
        txs = [b"key-%d-%d=value-%d" % (h, i, h * i) for i in range(12)]
        block = sim.advance(txs=txs)
        store.save_block(block, block.make_part_set(), sim.commits[-1])
        sim.state_jsons.append(sim.state.to_json())
        if h == CROSS_SNAPSHOT:
            snap = (sim.state.to_json(), sim.app.snapshot_state())
    return sim, store, snap


def _port_block(jblock):
    return P.Block.decode(jblock.encode())


def _port_commit(jcommit):
    return P.Commit.decode_from(Reader(jcommit.encode()))


def _both_takes(jax_chain, tail_len=2, chunk_size=CROSS_CHUNK):
    """The same state, app bytes and tail through both packages'
    `SnapshotStore.take`: (port manifest, port store, JAX manifest, JAX
    store)."""
    jsim, jstore, (state_json, app_state) = jax_chain
    jstate = jsim.state.__class__.from_json(state_json, db=JMemDB())
    pstate = State.from_json(state_json, db=MemDB())
    ptail = BlockStore(MemDB())
    for h in range(1, CROSS_SNAPSHOT + 1):
        ptail.save_block(_port_block(jstore.load_block(h)), _port_block(jstore.load_block(h)).make_part_set(),
                         _port_commit(jstore.load_seen_commit(h)))
    jsnaps = J_snap.SnapshotStore(JMemDB(), hasher=J_HOST_HASHER, chunk_size=chunk_size)
    psnaps = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=chunk_size)
    # the JAX store runs ahead of the snapshot height: each package takes
    # its tail from a store that ends at CROSS_SNAPSHOT
    jtail = JBlockStore(JMemDB())
    for h in range(1, CROSS_SNAPSHOT + 1):
        jb = jstore.load_block(h)
        jtail.save_block(jb, jb.make_part_set(), jstore.load_seen_commit(h))
    jm = jsnaps.take(jstate, app_state, block_store=jtail, tail_len=tail_len)
    pm = psnaps.take(pstate, app_state, block_store=ptail, tail_len=tail_len)
    return pm, psnaps, jm, jsnaps


@pytest.mark.parametrize("chunk_size,tail_len", [(CROSS_CHUNK, 2), (256, 0), (4096, 3), (1 << 16, 2)])
def test_manifests_chunks_and_roots_equal_the_jax_package(jax_chain, chunk_size, tail_len):
    pm, psnaps, jm, jsnaps = _both_takes(jax_chain, tail_len, chunk_size)
    assert pm.to_json() == jm.to_json()
    assert pm.chunks == jm.chunks and pm.root == jm.root
    for i in range(pm.chunks):
        assert psnaps.load_chunk(pm.height, pm.format, i) == jsnaps.load_chunk(jm.height, jm.format, i)
    assert list(psnaps._db.iterate(b"")) == list(jsnaps._db.iterate(b""))


def _gate_outcome(fn):
    try:
        fn()
    except (ValidationError, JValidationError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["clean", "corrupt", "swap", "dup", "short", "forged_list", "bad_root"])
def test_gate_outcomes_equal_the_jax_package(jax_chain, case):
    pm, psnaps, jm, jsnaps = _both_takes(jax_chain)
    chunks = [psnaps.load_chunk(pm.height, pm.format, i) for i in range(pm.chunks)]
    pman, jman = SnapshotManifest.from_json(pm.to_json()), J_snap.SnapshotManifest.from_json(jm.to_json())
    if case == "corrupt":
        chunks[2] = bytes(b ^ 0xFF for b in chunks[2])
    elif case == "swap":
        chunks[0], chunks[1] = chunks[1], chunks[0]
    elif case == "dup":
        chunks[3] = chunks[1]
    elif case == "short":
        chunks = chunks[:-1]
    elif case == "forged_list":
        for m in (pman, jman):
            m.chunk_hashes[1] = leaf_hash(b"not the chunk")
    elif case == "bad_root":
        for m in (pman, jman):
            m.root = b"\x00" * 20
    port = _gate_outcome(lambda: verify_chunks(pman, chunks, HOST_HASHER))
    jax = _gate_outcome(lambda: J_snap.verify_chunks(jman, chunks, J_HOST_HASHER))
    assert port == jax
    assert (port is None) == (case == "clean")
    assert _gate_outcome(lambda: pman.verify_root(HOST_HASHER)) == _gate_outcome(
        lambda: jman.verify_root(J_HOST_HASHER))


def test_decoded_payload_equals_the_jax_package(jax_chain):
    pm, psnaps, jm, jsnaps = _both_takes(jax_chain)
    payload = b"".join(psnaps.load_chunk(pm.height, pm.format, i) for i in range(pm.chunks))[: pm.payload_len]
    pj, pa, ptail = decode_payload(payload)
    jj, ja, jtail = J_snap.decode_payload(payload)
    assert (pj, pa) == (jj, ja)
    assert [(b.encode(), c.encode()) for b, c in ptail] == [(b.encode(), c.encode()) for b, c in jtail]
    assert build_payload(State.from_json(pj, db=MemDB()), pa, ptail) == payload


def test_reactor_frames_encode_as_the_jax_reactor(jax_chain):
    pm, _ps, jm, _js = _both_takes(jax_chain)
    assert ssr._enc_snapshots_response([pm]) == J_ssr._enc_snapshots_response([jm])
    assert ssr._enc_chunk_request(8, 1, 3) == J_ssr._enc_chunk_request(8, 1, 3)
    assert ssr._enc_chunk_response(8, 1, 3, b"abc") == J_ssr._enc_chunk_response(8, 1, 3, b"abc")
    assert ssr._enc_no_chunk(8, 1, 3) == J_ssr._enc_no_chunk(8, 1, 3)
    assert ssr._enc_commit_request(9) == J_ssr._enc_commit_request(9)
    assert ssr._enc_commit_response(9, None) == J_ssr._enc_commit_response(9, None)
    assert ssr.STATESYNC_CHANNEL == J_ssr.STATESYNC_CHANNEL == 0x60
    frame = J_ssr._enc_snapshots_response([jm])
    kind, got = ssr.decode_message(frame)
    assert kind == "snapshots_response" and [m.to_json() for m in got] == [jm.to_json()]
    with pytest.raises(ValueError) as pe:
        ssr.decode_message(b"\x7f")
    with pytest.raises(ValueError) as je:
        J_ssr.decode_message(b"\x7f")
    assert str(pe.value) == str(je.value)


@pytest.fixture(scope="module")
def restored(jax_chain):
    """Both directions over localhost TCP: a port node state-syncs a JAX
    server's snapshot and fast-syncs the tail; a JAX node does the same
    from a port server holding the JAX chain by its wire form."""
    jsim, jstore, _snap = jax_chain
    genesis = GenesisDoc.from_json(jsim.genesis.to_json())
    trust_h = 3
    out = {}
    # 1. a JAX server -> a port node
    jsnaps = J_snap.SnapshotStore(JMemDB(), hasher=J_HOST_HASHER, chunk_size=CROSS_CHUNK)
    jss = J_ssr.StateSyncReactor(jsnaps, jstore, jsim.state, hasher=J_HOST_HASHER)
    state_json, app_state = _snap
    jtail = JBlockStore(JMemDB())
    for h in range(1, CROSS_SNAPSHOT + 1):
        jb = jstore.load_block(h)
        jtail.save_block(jb, jb.make_part_set(), jstore.load_seen_commit(h))
    jsnaps.take(jsim.state.__class__.from_json(state_json, db=JMemDB()), app_state, block_store=jtail)
    jsrv = JSwitch(JNodeInfo(node_id="jax-server", moniker="jax-server", chain_id=CHAIN_ID))
    jsrv.add_reactor("blockchain", JBlockchainReactor(state=None, store=jstore, app_conn=None, fast_sync=False))
    jsrv.add_reactor("statesync", jss)
    jsrv.start()
    lis = J_tcp.TcpListener(jsrv, "tcp://127.0.0.1:0")
    trust = TrustOptions(height=trust_h, hash_=jstore.load_block(trust_h).hash())
    node = StateSyncingNode(genesis, "port-fresh", HOST, hasher=HOST_HASHER, trust=trust, discovery_time_s=0.3)
    try:
        tcp.dial(node.switch, f"127.0.0.1:{lis.port}")
        assert node.caught_up.wait(timeout=60), "the port node caught up"
        out["port"] = node
    finally:
        node.stop()
        lis.stop()
        jsrv.stop()
    # 2. a port server -> a JAX node
    pstore = BlockStore(MemDB())
    for h in range(1, jstore.height + 1):
        block = _port_block(jstore.load_block(h))
        pstore.save_block(block, block.make_part_set(), _port_commit(jstore.load_seen_commit(h)))
    psnaps = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=CROSS_CHUNK)
    ptail = BlockStore(MemDB())
    for h in range(1, CROSS_SNAPSHOT + 1):
        ptail.save_block(pstore.load_block(h), pstore.load_block(h).make_part_set(), pstore.load_seen_commit(h))
    psnaps.take(State.from_json(state_json, db=MemDB()), app_state, block_store=ptail)
    # the serving reactor answers commits from the chain's state: the JAX
    # chain's state at every height, by its JSON, saved into one port DB
    # holds the historical validator sets
    pdb = MemDB()
    for state_json_h in jsim.state_jsons:
        pstate = State.from_json(state_json_h, db=pdb)
        pstate.save()
    psrv, _pss = snapshot_server(pstore, pstate, psnaps, "port-server", CHAIN_ID, hasher=HOST_HASHER)
    plis = tcp.TcpListener(psrv, "tcp://127.0.0.1:0")
    jstate_db = JMemDB()
    jstate = j_make_genesis_state(jstate_db, jsim.genesis)
    jstate.save()
    jfresh_store = JBlockStore(JMemDB())
    japp = JKVStoreApp()
    jcaught = []
    jbc = JBlockchainReactor(state=jstate, store=jfresh_store,
                             app_conn=j_local_client_creator(japp)().consensus, fast_sync=True,
                             on_caught_up=jcaught.append, deferred=True)
    janchor = J_trust.TrustAnchor(jsim.genesis.chain_id, jsim.genesis.validator_set(),
                                  J_trust.TrustOptions(height=trust_h, hash_=jstore.load_block(trust_h).hash()))
    jsync = J_ssr.StateSyncReactor(
        J_snap.SnapshotStore(JMemDB()), jfresh_store, jstate, sync=True, trust_anchor=janchor,
        state_db=jstate_db, app_restore_fn=japp.restore_state, on_synced=jbc.begin_fast_sync,
        hasher=J_HOST_HASHER, discovery_time_s=0.3,
    )
    jnode = JSwitch(JNodeInfo(node_id="jax-fresh", moniker="jax-fresh", chain_id=CHAIN_ID))
    jnode.add_reactor("blockchain", jbc)
    jnode.add_reactor("statesync", jsync)
    jnode.start()
    try:
        J_tcp.dial(jnode, f"127.0.0.1:{plis.port}")
        wait_until(lambda: bool(jcaught), timeout=60, msg="the JAX node caught up")
        out["jax"] = (jcaught[0], jfresh_store, jsync)
    finally:
        jnode.stop()
        plis.stop()
        psrv.stop()
    return out


def test_a_port_node_restores_a_jax_snapshot_over_tcp(jax_chain, restored):
    jsim, jstore, (state_json, _app) = jax_chain
    node = restored["port"]
    assert node.statesync.restored_manifest.height == CROSS_SNAPSHOT
    assert node.store.base == CROSS_SNAPSHOT - 1 and node.store.height == CROSS_HEIGHTS - 1
    for h in range(CROSS_SNAPSHOT - 1, CROSS_HEIGHTS):
        assert node.store.load_block(h).hash() == jstore.load_block(h).hash()
    assert node.state.app_hash == jstore.load_block(CROSS_HEIGHTS).header.app_hash


def test_a_jax_node_restores_a_port_snapshot_over_tcp(jax_chain, restored):
    jsim, jstore, _snap = jax_chain
    jstate, jfresh, jsync = restored["jax"]
    assert jsync.restored_manifest.height == CROSS_SNAPSHOT
    assert jfresh.height == CROSS_HEIGHTS - 1
    for h in range(CROSS_SNAPSHOT - 1, CROSS_HEIGHTS):
        assert jfresh.load_block(h).hash() == jstore.load_block(h).hash()
    assert jstate.app_hash == jstore.load_block(CROSS_HEIGHTS).header.app_hash


def test_both_restored_nodes_agree_byte_for_byte(restored):
    node = restored["port"]
    jstate, jfresh, _jsync = restored["jax"]
    assert node.state.to_json() == jstate.to_json()
    assert node.app.snapshot_state() == _jax_app_snapshot(restored)
    assert [node.store.load_block(h).encode() for h in range(CROSS_SNAPSHOT - 1, CROSS_HEIGHTS)] == [
        jfresh.load_block(h).encode() for h in range(CROSS_SNAPSHOT - 1, CROSS_HEIGHTS)]


def _jax_app_snapshot(restored):
    _jstate, _jfresh, jsync = restored["jax"]
    return jsync.app_restore_fn.__self__.snapshot_state()


def test_the_syncing_routine_gives_up_without_snapshots():
    """No peer offers a snapshot: the routine ends with None after its
    giveup time, and the node falls back to fast sync from genesis."""
    genesis, _ = make_genesis(4)
    node = StateSyncingNode(genesis, "lonely", HOST, hasher=HOST_HASHER, discovery_time_s=0.05,
                            giveup_time_s=0.3)
    try:
        assert node.synced.wait(timeout=10)
        assert node.statesync.restored_state is None
        assert node.blockchain.deferred is False
    finally:
        node.stop()


def test_corrupt_chunk_from_one_server_is_blamed_and_refetched():
    """Two servers hold the same snapshot; one serves two corrupt chunks
    (the pool asks it for one of them first). The chunk is blamed on
    arrival, that server is dropped, the other serves the rest, and the
    restore ends exact."""
    from tendermint_tpu_torch.telemetry import REGISTRY

    sim, store = _chain(10)
    snaps = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=300)
    sw_a, ss_a = snapshot_server(store, sim.state, snaps, "srv-a", CHAIN_ID, hasher=HOST_HASHER)
    snap_h = sim.state.last_block_height
    sim_state_json, sim_app = sim.state.to_json(), sim.state.app_hash
    ss_a.snapshot_interval = 5
    assert ss_a.maybe_take_snapshot(sim.state, app=sim.app) is not None
    for _ in range(3):
        block = sim.advance(txs=[b"tail=%d" % store.height])
        store.save_block(block, block.make_part_set(hasher=HOST_HASHER), sim.commits[-1])
    snaps_b = SnapshotStore(MemDB(), hasher=HOST_HASHER, chunk_size=300)
    snaps_b._db._data = dict(snaps._db._data)
    sw_b, _ss_b = snapshot_server(store, sim.state, snaps_b, "srv-b", CHAIN_ID, hasher=HOST_HASHER)
    assert snaps.corrupt_chunk(snap_h, index=0) and snaps.corrupt_chunk(snap_h, index=1)
    lis = [tcp.TcpListener(sw, "tcp://127.0.0.1:0") for sw in (sw_a, sw_b)]
    corrupt0 = REGISTRY.counter_value("tendermint_statesync_chunks_total", result="corrupt")
    trust = TrustOptions(height=2, hash_=store.load_block(2).hash())
    node = StateSyncingNode(sim.genesis, "fresh", HOST, hasher=HOST_HASHER, trust=trust, discovery_time_s=0.5)
    restored_json = []
    restore = node.statesync._restore

    def capture(m, decoded, anchor_fc):
        st = restore(m, decoded, anchor_fc)
        restored_json.append((st.to_json(), st.app_hash))
        return st

    node.statesync._restore = capture
    try:
        for li in lis:
            tcp.dial(node.switch, f"127.0.0.1:{li.port}")
        assert node.caught_up.wait(timeout=60)
        assert sorted(p.id for p in node.switch.peers()) == ["srv-b"]
    finally:
        node.stop()
        for li in lis:
            li.stop()
        sw_a.stop()
        sw_b.stop()
    assert REGISTRY.counter_value("tendermint_statesync_chunks_total", result="corrupt") - corrupt0 == 1
    assert restored_json == [(sim_state_json, sim_app)]
    assert node.store.height == store.height - 1
    assert node.state.app_hash == sim.blocks[store.height - 1].header.app_hash


def test_metric_families_are_in_the_ports_catalog():
    from tendermint_tpu_torch.telemetry import REGISTRY

    for name in ("tendermint_statesync_chunks_total", "tendermint_statesync_chunks_served_total",
                 "tendermint_statesync_chunk_verify_seconds", "tendermint_statesync_restore_seconds",
                 "tendermint_statesync_snapshot_seconds", "tendermint_statesync_snapshots_taken_total",
                 "tendermint_statesync_snapshots_rejected_total", "tendermint_statesync_restores_total"):
        assert REGISTRY.get(name) is not None, name
    for result in ("ok", "corrupt", "timeout"):
        assert REGISTRY.counter_value("tendermint_statesync_chunks_total", result=result) >= 0

