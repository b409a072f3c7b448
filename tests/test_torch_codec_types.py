"""The port's codec and domain types against the JAX package's.

Covers `tendermint_tpu_torch.codec`, `utils.bit_array`, `crypto.keys`
and the types `block`, `part_set`, `genesis`, `priv_validator`,
`proposal`, `heartbeat`, `events` and `params`. The JAX package's own
scenarios (`tests/test_codec.py`, `test_block.py`, `test_part_set.py`,
`test_genesis.py`, `test_priv_validator.py` and the type-level cases of
`test_evidence.py`) run again on the port's types, and differential
tests push the same seeded fields through both packages.

Objects never cross between the packages: a JAX object's `encode()`
feeds the port's `decode()`, and results are compared as bytes, hashes
and booleans. Everything is exact.
"""

from __future__ import annotations

import os
import pathlib
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tendermint_tpu import codec as J_codec
from tendermint_tpu import types as J
from tendermint_tpu.crypto import PrivKey as JPrivKey
from tendermint_tpu.crypto import hashing as J_hashing
from tendermint_tpu.types import events as J_events
from tendermint_tpu.types import evidence as J_evidence
from tendermint_tpu.types import params as J_params
from tendermint_tpu.utils.bit_array import BitArray as JBitArray
from tendermint_tpu_torch import codec as P_codec
from tendermint_tpu_torch import types as P
from tendermint_tpu_torch.codec import (
    Reader,
    Writer,
    canonical_dumps,
    decode_svarint,
    decode_uvarint,
    encode_svarint,
    encode_uvarint,
)
from tendermint_tpu_torch.crypto import PrivKey, gen_priv_key
from tendermint_tpu_torch.crypto import hashing as P_hashing
from tendermint_tpu_torch.services.hasher import TreeHasher
from tendermint_tpu_torch.services.verifier import HostBatchVerifier
from tendermint_tpu_torch.testing import det_priv_keys, lockrank_report, make_block_id, make_validators
from tendermint_tpu_torch.testing import make_commit as _make_commit
from tendermint_tpu_torch.types import events as P_events
from tendermint_tpu_torch.types import evidence as P_evidence
from tendermint_tpu_torch.types import params as P_params
from tendermint_tpu_torch.types.part_set import Part
from tendermint_tpu_torch.utils.bit_array import BitArray

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CHAIN_ID = "test-chain"
HOST = HostBatchVerifier()


def make_commit(val_set, privs, height, round_, block_id):
    return _make_commit(val_set, privs, height, round_, block_id, verifier=HOST)


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


# -- the codec: tests/test_codec.py, then byte for byte against the JAX codec -


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 2**32, 2**63 - 1, 2**64])
def test_uvarint_roundtrip(n):
    enc = encode_uvarint(n)
    dec, off = decode_uvarint(enc)
    assert dec == n and off == len(enc)
    assert enc == J_codec.encode_uvarint(n)


@pytest.mark.parametrize("n", [0, 1, -1, 63, -64, 2**40, -(2**40), 2**62, -(2**62)])
def test_svarint_roundtrip(n):
    dec, _off = decode_svarint(encode_svarint(n))
    assert dec == n
    assert encode_svarint(n) == J_codec.encode_svarint(n)


def test_uvarint_negative_raises():
    with pytest.raises(ValueError):
        encode_uvarint(-1)


@pytest.mark.parametrize("data", [b"\x80", b"\xff" * 11, b""], ids=["truncated", "too-long", "empty"])
def test_bad_uvarint_raises_as_the_jax_codec_does(data):
    with pytest.raises(ValueError) as got:
        decode_uvarint(data)
    with pytest.raises(ValueError) as want:
        J_codec.decode_uvarint(data)
    assert str(got.value) == str(want.value)


def test_writer_reader_roundtrip():
    w = Writer().uvarint(42).svarint(-7).bytes(b"hello").string("wörld").bool(True).bool(False).raw(b"\xff\x00")
    data = w.build()
    r = Reader(data)
    assert r.uvarint() == 42
    assert r.svarint() == -7
    assert r.bytes() == b"hello"
    assert r.string() == "wörld"
    assert r.bool() is True
    assert r.bool() is False
    assert r.raw(2) == b"\xff\x00"
    r.expect_done()
    jw = J_codec.Writer().uvarint(42).svarint(-7).bytes(b"hello").string("wörld").bool(True).bool(False)
    assert data == jw.raw(b"\xff\x00").build()


def test_reader_trailing_bytes_detected():
    r = Reader(b"\x00\x01")
    r.uvarint()
    with pytest.raises(ValueError, match="1 trailing bytes"):
        r.expect_done()
    with pytest.raises(ValueError, match="invalid bool byte"):
        Reader(b"\x02").bool()


def test_canonical_json_deterministic_and_sorted():
    a = canonical_dumps({"b": 1, "a": b"\xde\xad", "c": {"z": 2, "y": [1, 2]}})
    b = canonical_dumps({"c": {"y": [1, 2], "z": 2}, "a": b"\xde\xad", "b": 1})
    assert a == b
    assert a == b'{"a":"DEAD","b":1,"c":{"y":[1,2],"z":2}}'


def test_canonical_json_rejects_floats():
    with pytest.raises(TypeError, match="floats are forbidden"):
        canonical_dumps({"x": 1.5})
    with pytest.raises(TypeError, match="floats are forbidden"):
        canonical_dumps([1, {"y": (2, 0.5)}])


@pytest.mark.parametrize("seed", range(4))
def test_codec_matches_the_jax_codec_on_seeded_fields(seed):
    rng = np.random.default_rng(seed)
    w, jw = Writer(), J_codec.Writer()
    doc = {}
    for i in range(40):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            v = int(rng.integers(0, 2**62)) >> int(rng.integers(0, 62))
            w.uvarint(v), jw.uvarint(v)
        elif kind == 1:
            v = int(rng.integers(-(2**62), 2**62))
            w.svarint(v), jw.svarint(v)
        elif kind == 2:
            v = rng.bytes(int(rng.integers(0, 300)))
            w.bytes(v), jw.bytes(v)
        elif kind == 3:
            v = "".join(chr(int(c)) for c in rng.integers(32, 0x3000, int(rng.integers(0, 20))))
            w.string(v), jw.string(v)
        else:
            v = bool(rng.integers(0, 2))
            w.bool(v), jw.bool(v)
        doc[f"k{int(rng.integers(0, 1000))}"] = v
    assert w.build() == jw.build()
    assert P_codec.canonical_dumps(doc) == J_codec.canonical_dumps(doc)


# -- the bit array ----------------------------------------------------------


def test_bit_array_basics():
    ba = BitArray(10)
    assert ba.is_empty() and not ba.is_full() and ba.size == 10
    assert ba.set(3, True) and ba.set(9, True)
    assert not ba.set(10, True) and not ba.get(-1)
    assert ba.count() == ba.num_set() == 2 and ba.to_int() == (1 << 3) | (1 << 9)
    full = BitArray(4, 0b1111)
    assert full.is_full() and full.not_().is_empty()
    assert repr(BitArray(3, 0b101)) == "BA{x_x}"
    with pytest.raises(ValueError, match="negative size"):
        BitArray(-1)
    i, ok = BitArray(8, 0b100).pick_random(random.Random(1))
    assert (i, ok) == (2, True) and BitArray(8).pick_random() == (0, False)


@pytest.mark.parametrize("seed", range(3))
def test_bit_array_matches_the_jax_bit_array(seed):
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    a_bits, b_bits = int(rng.integers(0, 2**62)), int(rng.integers(0, 2**62))
    pa, pb, ja, jb = BitArray(n, a_bits), BitArray(m, b_bits), JBitArray(n, a_bits), JBitArray(m, b_bits)
    for i in rng.integers(-2, n + 2, 20):
        v = bool(rng.integers(0, 2))
        assert pa.set(int(i), v) == ja.set(int(i), v)
    for op in ("or_", "and_", "sub"):
        got, want = getattr(pa, op)(pb), getattr(ja, op)(jb)
        assert (got.size, got.to_int(), repr(got)) == (want.size, want.to_int(), repr(want))
    got, want = pa.not_(), ja.not_()
    assert (got.to_int(), got.count(), got.is_full()) == (want.to_int(), want.count(), want.is_full())
    pa.update(pb), ja.update(jb)
    assert pa.to_int() == ja.to_int() and pa == pa.copy()
    assert pa.pick_random(random.Random(seed)) == ja.pick_random(random.Random(seed))


# -- keys and addresses -----------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_priv_key_signs_byte_equal_to_the_jax_package(seed):
    """Ed25519 is deterministic: the port's pure-Python signer and the
    JAX package's library-backed one give the same bytes."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        key_seed, msg = rng.bytes(32), rng.bytes(int(rng.integers(0, 400)))
        pk, jk = PrivKey(key_seed), JPrivKey(key_seed)
        sig = pk.sign(msg)
        assert sig == jk.sign(msg)
        assert pk.pub_key.data == jk.pub_key.data
        assert pk.pub_key.address == jk.pub_key.address == J_hashing.address_hash(pk.pub_key.data)
        assert P_hashing.address_hash(pk.pub_key.data) == pk.pub_key.address
        assert pk.pub_key.verify(msg, sig) and not pk.pub_key.verify(msg + b"!", sig)


def test_gen_priv_key_and_repr():
    assert gen_priv_key(b"\x03" * 32) == PrivKey(b"\x03" * 32)
    assert len(gen_priv_key().seed) == 32
    assert repr(PrivKey(b"\x05" * 32)) == repr(JPrivKey(b"\x05" * 32))
    with pytest.raises(ValueError, match="privkey seed must be 32 bytes"):
        PrivKey(b"\x01")


# -- blocks: tests/test_block.py ------------------------------------------


def make_test_block(height=2, n_txs=5, hasher=None):
    vs, privs = make_validators(4)
    last_bid = make_block_id(b"prev")
    last_commit = make_commit(vs, privs, height=height - 1, round_=0, block_id=last_bid)
    txs = P.Txs(f"tx-{i}".encode() for i in range(n_txs))
    return P.Block.make_block(
        height=height, chain_id=CHAIN_ID, txs=txs, last_commit=last_commit, last_block_id=last_bid,
        time=time.time_ns(), validators_hash=vs.hash(), app_hash=b"\x01" * 32, hasher=hasher,
    )


@pytest.fixture(scope="module")
def test_block():
    return make_test_block()


def test_block_hash_stable_and_nonempty(test_block):
    h1, h2 = test_block.hash(), test_block.hash()
    assert h1 == h2 and len(h1) == 32


def test_header_hash_changes_with_fields(test_block):
    b2 = P.Block.decode(test_block.encode())
    b2.header.app_hash = b"\x02" * 32
    assert test_block.hash() != b2.hash()


def test_validate_basic_ok(test_block):
    test_block.validate_basic()


def test_validate_basic_catches_num_txs(test_block):
    b = P.Block.decode(test_block.encode())
    b.header.num_txs = 99
    with pytest.raises(P.ValidationError, match="num_txs"):
        b.validate_basic()


def test_validate_basic_catches_data_tamper(test_block):
    b = P.Block.decode(test_block.encode())
    b.data.txs[0] = b"evil"
    with pytest.raises(P.ValidationError, match="data_hash mismatch"):
        b.validate_basic()


def test_encode_decode_roundtrip(test_block):
    b2 = P.Block.decode(test_block.encode())
    assert b2.hash() == test_block.hash()
    assert b2.data.txs == test_block.data.txs
    assert b2.last_commit.block_id == test_block.last_commit.block_id
    b2.validate_basic()


def test_block_part_set_roundtrip():
    b = make_test_block(n_txs=200)
    ps = b.make_part_set(part_size=512)
    assert ps.total > 1
    assert P.Block.decode(ps.assemble()).hash() == b.hash()


def test_commit_validate_basic():
    vs, privs = make_validators(4)
    c = make_commit(vs, privs, height=3, round_=1, block_id=make_block_id())
    c.validate_basic()
    assert c.height() == 3 and c.round() == 1
    assert c.bit_array().num_set() == 4


def test_empty_commit_for_height_1():
    assert P.Commit.empty().size() == 0
    assert P.Commit.empty().height() == 0 and not P.Commit.empty().is_commit()


# -- blocks, differential ---------------------------------------------------


def _block_fields(rng, height):
    """Seeded raw fields of a block, for building it in either package."""
    n_txs = int(rng.integers(0, 40))
    txs = [rng.bytes(int(rng.integers(0, 300))) for _ in range(n_txs)]
    bid = (rng.bytes(32), int(rng.integers(1, 9)), rng.bytes(20))
    n_vals = int(rng.integers(1, 6))
    votes = []
    for i in range(n_vals):
        if rng.integers(0, 4) == 0:
            votes.append(None)
            continue
        votes.append(dict(
            validator_address=rng.bytes(20), validator_index=i, height=height - 1, round=int(rng.integers(0, 3)),
            timestamp=int(rng.integers(-(2**40), 2**62)), type=J.VOTE_TYPE_PRECOMMIT, signature=rng.bytes(64),
        ))
    return dict(txs=txs, bid=bid, votes=votes, time=int(rng.integers(0, 2**62)),
                validators_hash=rng.bytes(32), app_hash=rng.bytes(int(rng.integers(0, 33))))


def _build_block(pkg, f, height, evidence=None, hasher=None):
    bid = pkg.BlockID(f["bid"][0], pkg.PartSetHeader(total=f["bid"][1], hash=f["bid"][2]))
    pre = [None if v is None else pkg.Vote(block_id=bid, **v) for v in f["votes"]]
    return pkg.Block.make_block(
        height=height, chain_id=CHAIN_ID, txs=pkg.Txs(f["txs"]), last_commit=pkg.Commit(block_id=bid, precommits=pre),
        last_block_id=bid, time=f["time"], validators_hash=f["validators_hash"], app_hash=f["app_hash"],
        hasher=hasher, evidence=evidence,
    )


@pytest.mark.parametrize("seed", range(6))
def test_blocks_encode_and_hash_as_the_jax_package_does(seed):
    rng = np.random.default_rng(100 + seed)
    height = int(rng.integers(2, 10**6))
    f = _block_fields(rng, height)
    pb, jb = _build_block(P, f, height), _build_block(J, f, height)
    assert pb.encode() == jb.encode()
    assert pb.hash() == jb.hash() and len(pb.hash()) == 32
    assert pb.header.encode() == jb.header.encode()
    assert pb.last_commit.hash() == jb.last_commit.hash()
    assert pb.last_commit.encode() == jb.last_commit.encode()
    assert pb.data.hash() == jb.data.hash() and pb.header.data_hash == jb.header.data_hash
    assert str(pb) == str(jb)
    # the JAX block's wire form decodes in the port to the same block
    back = P.Block.decode(jb.encode())
    assert back.encode() == jb.encode() and back.hash() == jb.hash()
    assert P.Block.decode(pb.encode()).header == pb.header
    # part sets of the wire form: the same header and parts
    size = int(rng.integers(64, 2048))
    pps, jps = pb.make_part_set(size), jb.make_part_set(size)
    assert (pps.header.total, pps.header.hash) == (jps.header.total, jps.header.hash)
    assert [pps.get_part(i).encode() for i in range(pps.total)] == [jps.get_part(i).encode() for i in range(jps.total)]
    assert str(pb.block_id(size)) == str(jb.block_id(size))


@pytest.mark.parametrize("n_txs", [1, 2, 9, 37])
def test_data_hash_through_the_port_tree_hasher_equals_the_jax_host_tree(n_txs):
    """`hasher=` a port `TreeHasher` with every tree on its device path
    (the plain torch levels on the CPU): `make_block`, `validate_basic`
    and `Txs.hash` give the JAX host tree's roots."""
    rng = np.random.default_rng(n_txs)
    f = _block_fields(rng, 5)
    f["txs"] = [rng.bytes(int(rng.integers(1, 250))) for _ in range(n_txs)]
    hasher = TreeHasher(device="cpu", min_device_leaves=0)
    pb, jb = _build_block(P, f, 5, hasher=hasher), _build_block(J, f, 5)
    assert pb.header.data_hash == jb.header.data_hash == J.Txs(f["txs"]).hash()
    assert P.Txs(f["txs"]).hash(hasher) == J.Txs(f["txs"]).hash()
    assert pb.hash() == jb.hash()
    pb.validate_basic(hasher=hasher)
    pb.data.txs[0] = b"tampered"
    with pytest.raises(P.ValidationError, match="data_hash mismatch"):
        pb.validate_basic(hasher=hasher)


def test_tx_proofs_match_the_jax_package():
    rng = np.random.default_rng(7)
    txs = [rng.bytes(int(rng.integers(1, 100))) for _ in range(11)]
    ptxs, jtxs = P.Txs(txs), J.Txs(txs)
    for i in (0, 5, 10):
        pp, jp = ptxs.proof(i), jtxs.proof(i)
        assert pp.root_hash == jp.root_hash and pp.proof.encode() == jp.proof.encode()
        assert pp.validate(jtxs.hash()) and not pp.validate(b"\x00" * 32)
    assert ptxs.index(txs[4]) == 4 and ptxs.index(b"absent") == -1
    assert P.tx_hash(txs[0]) == J.tx_hash(txs[0])


# -- evidence in blocks (test_evidence.py, TestBlockEvidence) ---------------


PRIV = PrivKey(b"\x07" * 32)


def ev_vote(pkg, priv_seed=b"\x07" * 32, height=3, block_hash=b"\xaa" * 20, timestamp=123):
    key = (PrivKey if pkg is P else JPrivKey)(priv_seed)
    vote = pkg.Vote(
        validator_address=key.pub_key.address, validator_index=0, height=height, round=0, timestamp=timestamp,
        type=pkg.VOTE_TYPE_PRECOMMIT, block_id=pkg.BlockID(block_hash, pkg.PartSetHeader.zero()),
    )
    return vote.with_signature(key.sign(vote.sign_bytes(CHAIN_ID)))


def dup_evidence(pkg, height=3):
    mod = P_evidence if pkg is P else J_evidence
    return mod.DuplicateVoteEvidence.make(
        ev_vote(pkg, height=height, block_hash=b"\xaa" * 20), ev_vote(pkg, height=height, block_hash=b"\xbb" * 20)
    )


def _evidence_block(pkg, evidence=None, hasher=None):
    return pkg.Block.make_block(
        height=1, chain_id=CHAIN_ID, txs=pkg.Txs([b"t1"]), last_commit=pkg.Commit.empty(),
        last_block_id=pkg.BlockID.zero(), time=1, validators_hash=b"\x01" * 20, app_hash=b"",
        evidence=evidence, hasher=hasher,
    )


def test_evidence_free_block_keeps_legacy_wire_and_hash():
    b = _evidence_block(P)
    assert b.header.evidence_hash == b""
    decoded = P.Block.decode(b.encode())
    assert decoded.hash() == b.hash() and len(decoded.evidence) == 0
    assert b.encode() == _evidence_block(J).encode()


def test_evidence_changes_header_hash_and_roundtrips():
    ev = dup_evidence(P, height=1)
    b = _evidence_block(P, evidence=[ev])
    assert b.header.evidence_hash == P_evidence.evidence_hash([ev])
    assert b.hash() != _evidence_block(P).hash()
    decoded = P.Block.decode(b.encode())
    assert decoded.hash() == b.hash() and list(decoded.evidence) == [ev]
    decoded.validate_basic()
    jb = _evidence_block(J, evidence=[dup_evidence(J, height=1)])
    assert b.encode() == jb.encode() and b.hash() == jb.hash()
    hasher = TreeHasher(device="cpu", min_device_leaves=0)
    assert P_evidence.evidence_hash([ev, ev], hasher) == J_evidence.evidence_hash([dup_evidence(J, 1)] * 2)
    _evidence_block(P, evidence=[ev], hasher=hasher).validate_basic(hasher=hasher)


def test_tampered_evidence_fails_validate_basic():
    from tendermint_tpu_torch.types.block import EvidenceData

    b = _evidence_block(P, evidence=[dup_evidence(P, height=1)])
    b.evidence = EvidenceData(evidence=[])
    with pytest.raises(P.ValidationError, match="evidence_hash"):
        b.validate_basic()


# -- part sets: tests/test_part_set.py, then against the JAX part sets ------


def test_part_set_roundtrip():
    data = os.urandom(4096 * 3 + 100)
    ps = P.PartSet.from_data(data, part_size=4096)
    assert ps.total == 4 and ps.is_complete() and ps.assemble() == data


def test_gossip_reassembly():
    data = os.urandom(10000)
    src = P.PartSet.from_data(data, part_size=1024)
    dst = P.PartSet.from_header(src.header)
    assert not dst.is_complete()
    for i in list(range(src.total))[::-1]:
        assert dst.add_part(src.get_part(i))
    assert dst.is_complete() and dst.assemble() == data


def test_duplicate_part_ignored():
    src = P.PartSet.from_data(b"x" * 5000, part_size=1024)
    dst = P.PartSet.from_header(src.header)
    assert dst.add_part(src.get_part(0))
    assert not dst.add_part(src.get_part(0))


def test_bad_proof_rejected():
    src = P.PartSet.from_data(b"y" * 5000, part_size=1024)
    dst = P.PartSet.from_header(src.header)
    p = src.get_part(1)
    with pytest.raises(P.ValidationError, match="invalid part Merkle proof"):
        dst.add_part(Part(index=1, bytes_=p.bytes_ + b"!", proof=p.proof))


def test_wrong_index_rejected():
    src = P.PartSet.from_data(b"z" * 5000, part_size=1024)
    dst = P.PartSet.from_header(src.header)
    p = src.get_part(1)
    with pytest.raises(P.ValidationError, match="part proof shape mismatch"):
        dst.add_part(Part(index=2, bytes_=p.bytes_, proof=p.proof))
    with pytest.raises(P.ValidationError, match="out of range"):
        dst.add_part(Part(index=9, bytes_=p.bytes_, proof=p.proof))


def test_part_encode_roundtrip():
    p = P.PartSet.from_data(b"w" * 3000, part_size=1024).get_part(2)
    assert Part.decode(p.encode()).bytes_ == p.bytes_


def test_empty_data_single_part():
    ps = P.PartSet.from_data(b"", part_size=1024)
    assert ps.total == 1 and ps.assemble() == b""


@pytest.mark.parametrize("seed", range(4))
def test_part_sets_match_the_jax_package(seed):
    """Equal headers and part encodings; the JAX parts, carried by their
    wire form, fill a port part set out of order; a port `TreeHasher`
    builds the same proofs."""
    rng = np.random.default_rng(200 + seed)
    data = rng.bytes(int(rng.integers(0, 20000)))
    size = int(rng.integers(100, 4096))
    ps, js = P.PartSet.from_data(data, size), J.PartSet.from_data(data, size)
    assert (ps.header.total, ps.header.hash) == (js.header.total, js.header.hash)
    assert ps.header.encode() == js.header.encode()
    hashed = P.PartSet.from_data(data, size, hasher=TreeHasher(device="cpu", min_device_leaves=0))
    assert hashed.header == ps.header
    dst = P.PartSet.from_header(P.PartSetHeader.decode_from(Reader(js.header.encode())))
    for i in rng.permutation(js.total):
        jp = js.get_part(int(i))
        assert ps.get_part(int(i)).encode() == jp.encode() == hashed.get_part(int(i)).encode()
        assert dst.add_part(Part.decode(jp.encode()))
    assert dst.is_complete() and dst.assemble() == data
    assert dst.parts_bit_array.is_full() and dst.has_header(ps.header)


# -- genesis: tests/test_genesis.py ---------------------------------------


def make_genesis(n=4):
    return P.GenesisDoc(
        chain_id="test-chain",
        validators=[P.GenesisValidator(pub_key=k.pub_key, power=10) for k in det_priv_keys(n)],
    )


def test_genesis_roundtrip_json():
    doc = make_genesis()
    doc.validate_and_complete()
    doc2 = P.GenesisDoc.from_json(doc.to_json())
    assert doc2.chain_id == doc.chain_id
    assert doc2.validator_hash() == doc.validator_hash()
    assert doc2.genesis_time == doc.genesis_time


def test_genesis_save_load_file(tmp_path):
    doc = make_genesis()
    doc.validate_and_complete()
    path = str(tmp_path / "genesis.json")
    doc.save_as(path)
    assert P.GenesisDoc.from_file(path).validator_hash() == doc.validator_hash()


@pytest.mark.parametrize("fault", ["chain_id", "validators", "power", "params"])
def test_genesis_rejects_what_the_jax_package_rejects(fault):
    doc, jdoc = make_genesis(), J.GenesisDoc.from_json(make_genesis().to_json())
    for d in (doc, jdoc):
        if fault == "chain_id":
            d.chain_id = ""
        elif fault == "validators":
            d.validators = []
        elif fault == "power":
            d.validators[0].power = -1
        else:
            d.consensus_params.block_gossip.block_part_size_bytes = 0
    with pytest.raises(P.ValidationError) as got:
        doc.validate_and_complete()
    with pytest.raises(J.ValidationError) as want:
        jdoc.validate_and_complete()
    assert str(got.value) == str(want.value)


def test_genesis_validator_set_size():
    doc = make_genesis(7)
    doc.validate_and_complete()
    assert doc.validator_set().size() == 7


@pytest.mark.parametrize("seed", range(3))
def test_genesis_json_and_validator_hash_match_the_jax_package(seed):
    rng = np.random.default_rng(300 + seed)
    keys = [PrivKey(rng.bytes(32)) for _ in range(int(rng.integers(1, 8)))]
    powers = [int(p) for p in rng.integers(0, 1000, len(keys))]
    doc = P.GenesisDoc(
        chain_id=f"chain-{seed}", genesis_time=int(rng.integers(1, 2**62)), app_hash=rng.bytes(16),
        validators=[P.GenesisValidator(pub_key=k.pub_key, power=w, name=f"v{i}") for i, (k, w) in enumerate(zip(keys, powers))],
        app_options={"a": [1, 2], "b": "x"},
    )
    doc.consensus_params.evidence = P_params.EvidenceParams(max_age=int(rng.integers(1, 99)), max_evidence=3)
    jdoc = J.GenesisDoc.from_json(doc.to_json())
    assert jdoc.to_json() == doc.to_json()
    assert jdoc.validator_hash() == doc.validator_hash()
    assert P.GenesisDoc.from_json(jdoc.to_json()).to_json() == doc.to_json()


# -- params (test_evidence.py, TestEvidenceParams) -----------------------------


def test_params_dict_roundtrip_and_defaults():
    p = P.ConsensusParams()
    p.evidence = P_params.EvidenceParams(max_age=7, max_evidence=3)
    again = P.ConsensusParams.from_dict(p.to_dict())
    assert (again.evidence.max_age, again.evidence.max_evidence) == (7, 3)
    legacy = P.ConsensusParams.from_dict({"block_size": {"max_txs": 5}})
    assert legacy.evidence.max_age == P_params.EvidenceParams().max_age
    assert legacy.to_dict() == J_params.ConsensusParams.from_dict({"block_size": {"max_txs": 5}}).to_dict()
    assert P.ConsensusParams().to_dict() == J.ConsensusParams().to_dict()


@pytest.mark.parametrize("field,value", [("max_age", 0), ("max_evidence", -1)])
def test_params_validate_rejects_as_the_jax_package_does(field, value):
    p, jp = P.ConsensusParams(), J.ConsensusParams()
    setattr(p.evidence, field, value)
    setattr(jp.evidence, field, value)
    with pytest.raises(P.ValidationError) as got:
        p.validate()
    with pytest.raises(J.ValidationError) as want:
        jp.validate()
    assert str(got.value) == str(want.value)


# -- the priv validator: tests/test_priv_validator.py ---------------------


def mk_vote(pv, height, round_, type_, bid, ts=1000):
    return P.Vote(validator_address=pv.address, validator_index=0, height=height, round=round_,
                  timestamp=ts, type=type_, block_id=bid)


def test_sign_vote_and_verify():
    pv = P.PrivValidator(PrivKey(b"\x05" * 32))
    v = pv.sign_vote(CHAIN_ID, mk_vote(pv, 1, 0, P.VOTE_TYPE_PREVOTE, make_block_id()))
    assert pv.pub_key.verify(v.sign_bytes(CHAIN_ID), v.signature)


def test_double_sign_same_hrs_different_block_refused():
    pv = P.PrivValidator(PrivKey(b"\x05" * 32))
    pv.sign_vote(CHAIN_ID, mk_vote(pv, 1, 0, P.VOTE_TYPE_PREVOTE, make_block_id(b"a")))
    with pytest.raises(P.ErrDoubleSign, match="conflicting sign-bytes at 1/0/2"):
        pv.sign_vote(CHAIN_ID, mk_vote(pv, 1, 0, P.VOTE_TYPE_PREVOTE, make_block_id(b"b")))


def test_resign_identical_returns_cached():
    pv = P.PrivValidator(PrivKey(b"\x05" * 32))
    v1 = pv.sign_vote(CHAIN_ID, mk_vote(pv, 1, 0, P.VOTE_TYPE_PREVOTE, make_block_id()))
    v2 = pv.sign_vote(CHAIN_ID, mk_vote(pv, 1, 0, P.VOTE_TYPE_PREVOTE, make_block_id()))
    assert v1.signature == v2.signature


def test_regression_refused():
    pv = P.PrivValidator(PrivKey(b"\x05" * 32))
    pv.sign_vote(CHAIN_ID, mk_vote(pv, 2, 0, P.VOTE_TYPE_PRECOMMIT, make_block_id()))
    with pytest.raises(P.ErrDoubleSign, match="sign regression"):
        pv.sign_vote(CHAIN_ID, mk_vote(pv, 1, 0, P.VOTE_TYPE_PREVOTE, make_block_id()))
    with pytest.raises(P.ErrDoubleSign):
        pv.sign_vote(CHAIN_ID, mk_vote(pv, 2, 0, P.VOTE_TYPE_PREVOTE, make_block_id()))


def test_step_progression_allowed():
    pv = P.PrivValidator(PrivKey(b"\x05" * 32))
    bid = make_block_id()
    pv.sign_vote(CHAIN_ID, mk_vote(pv, 1, 0, P.VOTE_TYPE_PREVOTE, bid))
    pv.sign_vote(CHAIN_ID, mk_vote(pv, 1, 0, P.VOTE_TYPE_PRECOMMIT, bid))
    pv.sign_vote(CHAIN_ID, mk_vote(pv, 1, 1, P.VOTE_TYPE_PREVOTE, bid))
    pv.sign_vote(CHAIN_ID, mk_vote(pv, 2, 0, P.VOTE_TYPE_PREVOTE, bid))


_PV_STEP = """
import sys
from tendermint_tpu_torch.types import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE, BlockID, ErrDoubleSign, PrivValidatorFS, Vote
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.utils import lockrank

path, step = sys.argv[1], sys.argv[2]
bid = BlockID(b"\\x11" * 32, PartSetHeader(total=1, hash=b"\\x22" * 20))

def vote(pv, height, type_):
    return Vote(validator_address=pv.address, validator_index=0, height=height, round=0,
                timestamp=1000, type=type_, block_id=bid)

if step == "first":
    pv = PrivValidatorFS.load_or_gen(path, seed=b"\\x09" * 32)
    pv.sign_vote("test-chain", vote(pv, 3, VOTE_TYPE_PRECOMMIT))
    print(pv.address.hex())
else:
    pv = PrivValidatorFS.load(path)
    try:
        pv.sign_vote("test-chain", vote(pv, 3, VOTE_TYPE_PREVOTE))
        print("signed")
    except ErrDoubleSign as e:
        print("refused", e)
    pv.sign_vote("test-chain", vote(pv, 4, VOTE_TYPE_PREVOTE))
    print(pv.address.hex())
assert not lockrank.drain()
"""


def test_fs_double_sign_refused_across_two_processes(tmp_path):
    """Sign at 3/0/precommit in one process; a second process loads the
    file and must refuse the regression and allow progress. The JAX
    package reads the same file the same way."""
    path = str(tmp_path / "priv_validator.json")
    env = {**os.environ, "PYTHONPATH": str(REPO)}

    def step(name):
        out = subprocess.run([sys.executable, "-c", _PV_STEP, path, name], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return out.stdout.split("\n")

    first = step("first")
    second = step("second")
    assert second[0].startswith("refused sign regression: have 3/0/3, asked 3/0/2")
    assert first[0] == second[1] == J.PrivValidatorFS.load(path).address.hex()
    assert (tmp_path / "priv_validator.json").stat().st_mode & 0o777 == 0o600


def test_load_or_gen_idempotent(tmp_path):
    path = str(tmp_path / "pv.json")
    a = P.PrivValidatorFS.load_or_gen(path)
    b = P.PrivValidatorFS.load_or_gen(path)
    assert a.address == b.address


def test_resign_differing_only_by_timestamp_reuses_cached_vote():
    pv = P.PrivValidator(PrivKey(b"\x05" * 32))
    bid = make_block_id()
    v1 = pv.sign_vote(CHAIN_ID, mk_vote(pv, 2, 0, P.VOTE_TYPE_PRECOMMIT, bid, ts=1000))
    v2 = pv.sign_vote(CHAIN_ID, mk_vote(pv, 2, 0, P.VOTE_TYPE_PRECOMMIT, bid, ts=9999))
    assert v2.timestamp == 1000 and v2.signature == v1.signature
    assert pv.pub_key.verify(v2.sign_bytes(CHAIN_ID), v2.signature)
    with pytest.raises(P.ErrDoubleSign):
        pv.sign_vote(CHAIN_ID, mk_vote(pv, 2, 0, P.VOTE_TYPE_PRECOMMIT, make_block_id(b"other")))


def test_priv_validator_files_match_the_jax_package(tmp_path):
    """The same signing sequence through both packages' file-backed
    validators: equal votes, proposals and heartbeats, equal files, and
    each package loads the other's file."""
    pf, jf = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    pv = P.PrivValidatorFS.load_or_gen(pf, seed=b"\x0a" * 32)
    jv = J.PrivValidatorFS.load_or_gen(jf, seed=b"\x0a" * 32)
    pbid, jbid = make_block_id(b"q"), J.BlockID(make_block_id(b"q").hash, J.PartSetHeader(1, make_block_id(b"q").hash[:20]))
    pprop = P.Proposal(5, 1, pbid.parts_header, -1, P.BlockID.zero(), 77)
    jprop = J.Proposal(5, 1, jbid.parts_header, -1, J.BlockID.zero(), 77)
    assert pv.sign_proposal(CHAIN_ID, pprop).encode() == jv.sign_proposal(CHAIN_ID, jprop).encode()
    for h, t in ((5, P.VOTE_TYPE_PREVOTE), (5, P.VOTE_TYPE_PRECOMMIT), (6, P.VOTE_TYPE_PREVOTE)):
        got = pv.sign_vote(CHAIN_ID, mk_vote(pv, h, 1, t, pbid))
        want = jv.sign_vote(CHAIN_ID, J.Vote(jv.address, 0, h, 1, 1000, t, jbid))
        assert got.encode() == want.encode()
    phb = pv.sign_heartbeat(CHAIN_ID, P.Heartbeat(pv.address, 0, 6, 1, 3))
    assert phb.encode() == jv.sign_heartbeat(CHAIN_ID, J.Heartbeat(jv.address, 0, 6, 1, 3)).encode()
    assert pathlib.Path(pf).read_text() == pathlib.Path(jf).read_text()
    assert J.PrivValidatorFS.load(pf).address == P.PrivValidatorFS.load(jf).address == pv.address
    with pytest.raises(P.ErrDoubleSign):
        P.PrivValidatorFS.load(jf).sign_vote(CHAIN_ID, mk_vote(pv, 5, 1, P.VOTE_TYPE_PRECOMMIT, make_block_id(b"r")))


# -- proposals and heartbeats ---------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_proposals_and_heartbeats_match_the_jax_package(seed):
    rng = np.random.default_rng(400 + seed)
    total, phash, bhash = int(rng.integers(0, 99)), rng.bytes(20), rng.bytes(32)
    pol_round = int(rng.integers(-1, 5))
    fields = (int(rng.integers(1, 2**40)), int(rng.integers(0, 9)))
    ts, sig = int(rng.integers(-(2**40), 2**62)), rng.bytes(64)
    chain = f"chain-{seed}"

    def proposal(pkg):
        psh = pkg.PartSetHeader(total=total, hash=phash)
        return pkg.Proposal(*fields, psh, pol_round, pkg.BlockID(bhash, psh), ts, sig)

    pp, jp = proposal(P), proposal(J)
    assert pp.sign_bytes(chain) == jp.sign_bytes(chain) and pp.encode() == jp.encode()
    assert P.Proposal.decode(jp.encode()) == pp and str(pp) == str(jp)
    addr, idx, seq = rng.bytes(20), int(rng.integers(0, 99)), int(rng.integers(0, 2**30))
    ph = P.Heartbeat(addr, idx, *fields, seq, sig)
    jh = J.Heartbeat(addr, idx, *fields, seq, sig)
    assert ph.sign_bytes(chain) == jh.sign_bytes(chain) and ph.encode() == jh.encode()
    assert P.Heartbeat.decode(jh.encode()) == ph
    with pytest.raises(ValueError, match="trailing bytes"):
        P.Heartbeat.decode(jh.encode() + b"\x00")


# -- events ---------------------------------------------------------------


def test_event_switch_fires_removes_and_isolates_listeners():
    sw = P.EventSwitch()
    seen = []
    sw.add_listener("a", P_events.EVENT_NEW_BLOCK, lambda d: seen.append(("a", d)))
    sw.add_listener("b", P_events.EVENT_NEW_BLOCK, lambda d: 1 / 0)  # a raising listener
    sw.add_listener("b", P_events.EVENT_VOTE, lambda d: seen.append(("b", d)))
    sw.fire(P_events.EVENT_NEW_BLOCK, 1)
    sw.fire(P_events.EVENT_VOTE, 2)
    sw.remove_listener("b")
    sw.fire(P_events.EVENT_NEW_BLOCK, 3)
    sw.fire(P_events.EVENT_VOTE, 4)
    sw.remove_listener("a", P_events.EVENT_NEW_BLOCK)
    sw.fire(P_events.EVENT_NEW_BLOCK, 5)
    assert seen == [("a", 1), ("b", 2), ("a", 3)]
    cache = P.EventCache(sw)
    sw.add_listener("c", P_events.EVENT_TX, seen.append)
    cache.fire(P_events.EVENT_TX, "t1")
    cache.fire(P_events.EVENT_TX, "t2")
    assert seen[-1] == ("a", 3)
    cache.flush()
    assert seen[-2:] == ["t1", "t2"]


def test_event_names_match_the_jax_package():
    names = [n for n in dir(J_events) if n.startswith("EVENT_")]
    assert names == [n for n in dir(P_events) if n.startswith("EVENT_")]
    assert all(getattr(P_events, n) == getattr(J_events, n) for n in names)
    assert P_events.event_tx(b"\x01\xab") == J_events.event_tx(b"\x01\xab") == "Tx:01ab"


def test_nop_mempool_answers_nothing():
    from tendermint_tpu_torch.types.services import NopMempool

    m = NopMempool()
    m.lock(), m.unlock(), m.check_tx(b"x"), m.check_tx_async(b"x"), m.update(1, P.Txs()), m.flush()
    assert m.size() == 0 and m.reap(5) == P.Txs() and not m.tx_available()
