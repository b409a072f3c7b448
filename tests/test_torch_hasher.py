"""The port's `TreeHasher` on the CPU: routing at the leaf threshold,
device resolution, and the JAX package's host plane (`Txs.hash`,
`Block.make_block` / `validate_basic`, `evidence_hash`, the state-sync
chunk gate) driven by a port backend, with the JAX host tree's roots."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tendermint_tpu.merkle.simple import leaf_hash, simple_hash_from_byte_slices, simple_hash_from_hashes
from tendermint_tpu.statesync import snapshot as J_snapshot
from tendermint_tpu.types import BlockID, Txs
from tendermint_tpu.types.block import Block, Commit
from tendermint_tpu.types.evidence import evidence_hash
from tendermint_tpu.types.errors import ValidationError
from tendermint_tpu_torch.ops import merkle_kernel as MK
from tendermint_tpu_torch.services import hasher as H
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture


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


ALGOS = ["sha256", "ripemd160"]


def _items(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(1, 120, n)]


@pytest.fixture
def device_calls(monkeypatch):
    """Counts the device tree builds the hasher asks for."""
    calls = {"root": 0, "words": 0, "leaves": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        return wrapped

    monkeypatch.setattr(MK, "merkle_root_device", spy("root", MK.merkle_root_device))
    monkeypatch.setattr(MK, "merkle_root_from_leaf_words", spy("words", MK.merkle_root_from_leaf_words))
    monkeypatch.setattr(MK, "leaf_hashes_device", spy("leaves", MK.leaf_hashes_device))
    return calls


@pytest.mark.parametrize("algo", ALGOS)
def test_routing_at_the_threshold(device_calls, algo):
    h = H.TreeHasher(algo=algo, min_device_leaves=9, device="cpu")
    below, at = _items(8, 1), _items(9, 2)
    assert h.root_from_items(below) == simple_hash_from_byte_slices(below, algo)
    assert h.leaf_hashes(below) == [leaf_hash(x, algo) for x in below]
    assert h.root_from_hashes(h.leaf_hashes(below)) == simple_hash_from_byte_slices(below, algo)
    assert device_calls == {"root": 0, "words": 0, "leaves": 0}
    assert h.root_from_items(at) == simple_hash_from_byte_slices(at, algo)
    leaves = h.leaf_hashes(at)
    assert leaves == [leaf_hash(x, algo) for x in at]
    assert h.root_from_hashes(leaves) == simple_hash_from_byte_slices(at, algo)
    assert device_calls == {"root": 1, "words": 1, "leaves": 1}


def test_one_leaf_never_goes_to_the_device(device_calls):
    h = H.TreeHasher(min_device_leaves=0, device="cpu")
    assert h.root_from_items([b"x"]) == simple_hash_from_byte_slices([b"x"])
    assert h.root_from_items([]) == b""
    assert device_calls["root"] == 0


def test_host_backend_never_goes_to_the_device(device_calls):
    h = H.TreeHasher(backend="host", min_device_leaves=0)
    assert h.device is None
    items = _items(20, 3)
    assert h.root_from_items(items) == simple_hash_from_byte_slices(items)
    root, proofs = h.proofs(items)
    assert root == simple_hash_from_byte_slices(items) and len(proofs) == 20
    assert device_calls == {"root": 0, "words": 0, "leaves": 0}


def test_default_threshold_and_its_env_variable():
    assert H.DEVICE_MIN_LEAVES == int(os.environ.get("TENDERMINT_TPU_MIN_DEVICE_LEAVES", "8192"))
    env = dict(os.environ, TENDERMINT_TPU_MIN_DEVICE_LEAVES="77")
    code = "from tendermint_tpu_torch.services.hasher import DEVICE_MIN_LEAVES as d, TreeHasher as T; print(d, T(backend='host').min_device_leaves)"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["77", "77"], out.stderr


def test_constructor_checks():
    with pytest.raises(ValueError):
        H.TreeHasher(backend="tpu", device="cpu")
    with pytest.raises(ValueError):
        H.TreeHasher(algo="md5", device="cpu")
    assert H.TreeHasher(device="cpu").min_device_leaves == H.DEVICE_MIN_LEAVES


def test_auto_and_default_hasher_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        H.auto_hasher()
    with pytest.raises(RuntimeError):
        H.default_hasher()
    with pytest.raises(RuntimeError):
        H.TreeHasher()


def test_auto_and_default_hasher_on_request():
    from tendermint_tpu_torch.services.resilient import ResilientTreeHasher

    a = H.auto_hasher("cpu")
    # the JAX package's layering: a device hasher behind the breaker,
    # the host tree as its fallback
    assert isinstance(a, ResilientTreeHasher)
    assert a.backend == "device" and a.device == torch.device("cpu")
    assert a.primary.backend == "device" and a.primary.device == torch.device("cpu")
    assert a.fallback.backend == "host"
    assert H.default_hasher("cpu") is H.default_hasher("cpu")
    assert isinstance(H.default_hasher("cpu"), ResilientTreeHasher)
    assert H.default_hasher("cpu").primary.backend == "device"


# -- the JAX package's host plane on a port backend ---------------------------


@pytest.fixture(params=ALGOS)
def port_hasher(request):
    return H.TreeHasher(algo=request.param, min_device_leaves=0, device="cpu")


def test_txs_hash_on_the_port(port_hasher):
    txs = Txs(b"tx-%d" % i for i in range(37))
    assert txs.hash(port_hasher) == simple_hash_from_byte_slices(list(txs), port_hasher.algo)


def test_make_block_and_validate_basic_on_the_port():
    """data_hash and evidence_hash through the port's device backend on
    the CPU equal the JAX host tree's; validate_basic recomputes them
    through the same backend and accepts the block, and rejects a
    tampered tx list."""
    hasher = H.TreeHasher(min_device_leaves=0, device="cpu")
    txs = Txs(b"payload-%d" % i for i in range(20))
    kwargs = dict(
        height=1,
        chain_id="port-chain",
        txs=txs,
        last_commit=Commit.empty(),
        last_block_id=BlockID.zero(),
        time=1,
        validators_hash=b"\x01" * 20,
        app_hash=b"",
    )
    block = Block.make_block(hasher=hasher, **kwargs)
    host_block = Block.make_block(**kwargs)
    assert block.header.data_hash == host_block.header.data_hash == simple_hash_from_byte_slices(list(txs))
    assert block.header.evidence_hash == host_block.header.evidence_hash
    assert block.hash() == host_block.hash()
    block.validate_basic(hasher)
    block.data.txs[3] = b"tampered"
    with pytest.raises(ValidationError):
        block.validate_basic(hasher)


def test_evidence_hash_on_the_port(port_hasher):
    class Ev:
        def __init__(self, i):
            self.i = i

        def encode(self):
            return b"evidence-%d" % self.i

    evs = [Ev(i) for i in range(5)]
    assert evidence_hash([], port_hasher) == b""
    want = simple_hash_from_byte_slices([e.encode() for e in evs], port_hasher.algo)
    assert evidence_hash(evs, port_hasher) == want


def test_state_sync_gate_on_the_port(monkeypatch):
    """The JAX chunk-gate helpers and `verify_chunks` on the port's
    backend: leaf hashes, the root fold, and a tampered chunk refused.
    `verify_chunks` reaches the port through `leaf_hashes_async`, on the
    port's dispatch queue."""
    hasher = H.TreeHasher(min_device_leaves=0, device="cpu")
    chunks = J_snapshot.split_chunks(np.random.default_rng(4).bytes(5000), 700)
    leaves = J_snapshot._chunk_leaf_hashes(chunks, hasher)
    assert leaves == J_snapshot._chunk_leaf_hashes(chunks, None) == [leaf_hash(c) for c in chunks]
    root = J_snapshot._root_from_leaf_hashes(leaves, hasher)
    assert root == J_snapshot._root_from_leaf_hashes(leaves, None) == simple_hash_from_hashes(leaves)
    manifest = J_snapshot.SnapshotManifest(
        height=10, chunks=len(chunks), chunk_size=700, root=root, chunk_hashes=leaves,
        app_hash=b"\x02" * 32, chain_id="port-chain", payload_len=5000,
    )
    J_snapshot.verify_chunks(manifest, chunks, hasher)
    bad = list(chunks)
    bad[2] = b"\x00" + bad[2][1:]
    with pytest.raises(ValidationError):
        J_snapshot.verify_chunks(manifest, bad, hasher)
