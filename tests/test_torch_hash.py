"""The port's hash plane against the JAX package and hashlib, on the CPU.

Padding array for array, the constants, the plain SHA-256 / RIPEMD-160 /
SHA-512 (the kernels' plain versions) against hashlib around every block
boundary, the port's trees and forests against the JAX package's host
tree, and the kernels' own arithmetic (`csrc/*.cuh`) compiled as host
C++ against hashlib. Everything is an integer: tolerance 0.
"""

from __future__ import annotations

import hashlib
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import hashing as JH
from tendermint_tpu.merkle import simple as JS
from tendermint_tpu.ops import padding as JP
from tendermint_tpu.ops import ripemd160_kernel as JR
from tendermint_tpu.ops import sha256_kernel as J256
from tendermint_tpu.ops import sha512_kernel as J512
from tendermint_tpu_torch.crypto import hashing as TH
from tendermint_tpu_torch.merkle import simple as TS
from tendermint_tpu_torch.ops import merkle_kernel as MK
from tendermint_tpu_torch.ops import padding as TP
from tendermint_tpu_torch.ops import ripemd160_kernel as TR
from tendermint_tpu_torch.ops import sha256_kernel as T256
from tendermint_tpu_torch.ops import sha512_kernel as T512
from tendermint_tpu_torch.testing import time_limit_fixture

# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))

CSRC = pathlib.Path(TP.__file__).resolve().parents[1] / "csrc"
# lengths around the SHA-256/RIPEMD-160 (55/56/64) and SHA-512
# (111/112/128) padding boundaries
LENGTHS = [0, 1, 55, 56, 57, 63, 64, 65, 111, 112, 113, 119, 120, 127, 128, 129, 200, 250]
ALGOS = ["sha256", "ripemd160"]
TREE_SIZES = list(range(1, 18)) + [33, 100, 255, 256]


def _msgs(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in lengths]


def _ripemd(m: bytes) -> bytes:
    return hashlib.new("ripemd160", m).digest()


# -- padding, array for array ---------------------------------------------


@pytest.mark.parametrize("name", ["pad_sha256", "pad_ripemd160", "pad_sha512"])
@pytest.mark.parametrize("max_blocks", [None, 8])
def test_padding_matches_jax(name, max_blocks):
    msgs = _msgs(LENGTHS, 1)
    got = getattr(TP, name)(msgs, max_blocks)
    want = getattr(JP, name)(msgs, max_blocks)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["pad_sha256_prefixed", "pad_ripemd160_prefixed"])
@pytest.mark.parametrize("prefix", [b"", b"\x00", b"\x01\x02\x03"])
def test_prefixed_padding_matches_jax(name, prefix):
    msgs = _msgs(LENGTHS + [1000, 3, 3, 0], 2)
    for g, w in zip(getattr(TP, name)(msgs, prefix), getattr(JP, name)(msgs, prefix)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["pad_sha256", "pad_ripemd160", "pad_sha512"])
def test_padding_of_no_messages_matches_jax(name):
    for g, w in zip(getattr(TP, name)([]), getattr(JP, name)([])):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_padding_helpers_match_jax():
    for n in list(range(0, 70)) + [1025, 4097]:
        assert TP.bucket_blocks(n) == JP.bucket_blocks(n)
    for m in _msgs([0, 55, 56, 111, 112, 200], 3):
        for block, length, le in ((64, 8, False), (64, 8, True), (128, 16, False)):
            assert TP._md_pad(m, block, length, le) == JP._md_pad(m, block, length, le)
    a = np.arange(12, dtype=np.uint32).reshape(3, 4)
    b = np.arange(3, dtype=np.int32)
    (ga, gb), gn = TP.pad_rows_to_multiple([a, b], 4)
    (wa, wb), wn = JP.pad_rows_to_multiple([a, b], 4)
    assert gn == wn
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(gb, wb)
    with pytest.raises(ValueError):
        TP.pad_rows_to([a], 2)
    d = np.random.default_rng(4).integers(0, 2**32, (5, 8), dtype=np.uint64).astype(np.uint32)
    assert TP.digests_to_bytes_be(d) == JP.digests_to_bytes_be(d)
    assert TP.digests_to_bytes_le(d[:, :5]) == JP.digests_to_bytes_le(d[:, :5])


# -- constants ---------------------------------------------------------------


def test_constants_match_jax():
    np.testing.assert_array_equal(T256.SHA256_H0, J256.SHA256_H0)
    np.testing.assert_array_equal(T256.SHA256_K, J256.SHA256_K)
    for name in ("SHA512_H0_HI", "SHA512_H0_LO", "SHA512_K_HI", "SHA512_K_LO"):
        np.testing.assert_array_equal(getattr(T512, name), getattr(J512, name))
    for name in ("_RL", "_RR", "_SL", "_SR", "_KL", "_KR"):
        assert getattr(TR, name) == getattr(JR, name)
    np.testing.assert_array_equal(TR._H0, JR._H0)


def _hex_table(text: str, name: str) -> list[int]:
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-fA-F]+)", body)]


def _int_table(text: str, name: str) -> list[int]:
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
    return [int(v) for v in re.findall(r"\d+", body)]


def test_kernel_tables_equal_the_derived_constants():
    """The CUDA headers' transcribed tables against the port's constants
    (derived from integer roots of primes, as in the JAX package)."""
    s256 = (CSRC / "sha256.cuh").read_text()
    assert _hex_table(s256, "kK") == T256.SHA256_K.tolist()
    s512 = (CSRC / "sha512.cuh").read_text()
    assert _hex_table(s512, "kK") == T512._K_64
    rmd = (CSRC / "ripemd160.cuh").read_text()
    for name, tab in (("kRL", TR._RL), ("kRR", TR._RR), ("kSL", TR._SL), ("kSR", TR._SR)):
        assert _int_table(rmd, name) == [v for grp in tab for v in grp]
    assert _hex_table(rmd, "kKL") == TR._KL
    assert _hex_table(rmd, "kKR") == TR._KR


# -- the plain hashes against hashlib -----------------------------------------


def test_plain_sha256_equals_hashlib():
    msgs = _msgs(LENGTHS, 5)
    assert T256.sha256_digest_bytes(msgs, "cpu") == [hashlib.sha256(m).digest() for m in msgs]
    assert T256.sha256_digest_bytes([], "cpu") == []


def test_plain_ripemd160_equals_hashlib():
    msgs = _msgs(LENGTHS, 6)
    blocks, n = TP.pad_ripemd160(msgs)
    got = TR.ripemd160_batch(blocks, n, "cpu")
    assert TP.digests_to_bytes_le(T256.to_u32(got)) == [_ripemd(m) for m in msgs]


def test_plain_sha512_equals_hashlib():
    msgs = _msgs(LENGTHS + [305], 7)
    blocks, n = TP.pad_sha512(msgs)
    got = T512.sha512_batch(blocks, n, "cpu")
    assert TP.digests_to_bytes_be(T256.to_u32(got)) == [hashlib.sha512(m).digest() for m in msgs]


@pytest.mark.parametrize("name", ["sha256_masked", "ripemd160_masked", "sha512_masked"])
def test_rows_without_blocks_give_the_initial_state(name):
    """n_blocks 0 (a pad row) and below 0 leave the initial state; n_blocks
    above M compresses all M blocks, as the JAX mask does."""
    mod, words, h0 = {
        "sha256_masked": (T256, 16, T256.SHA256_H0),
        "ripemd160_masked": (TR, 16, TR._H0),
        "sha512_masked": (T512, 32, T512._sha512_h0()),
    }[name]
    fn = getattr(mod, name)
    rng = np.random.default_rng(8)
    blocks = torch.from_numpy(rng.integers(0, 2**32, (4, 2, words), dtype=np.uint64).astype(np.uint32).view(np.int32))
    blocks[3] = blocks[2]
    got = fn(blocks, torch.tensor([0, -3, 2, 5], dtype=torch.int32))
    want0 = torch.from_numpy(h0.astype(np.uint32).view(np.int32))
    assert torch.equal(got[0], want0) and torch.equal(got[1], want0)
    assert torch.equal(got[2], got[3])


def test_sha256_fixed2_is_the_two_block_digest():
    msgs = _msgs([64 + 1, 100, 119], 9)
    blocks, n = TP.pad_sha256(msgs)
    assert (n == 2).all()
    b = torch.from_numpy(blocks.view(np.int32))
    got = T256.sha256_fixed2_from_words(b[:, 0], b[:, 1])
    assert TP.digests_to_bytes_be(T256.to_u32(got)) == [hashlib.sha256(m).digest() for m in msgs]


def test_words_cross_as_bit_patterns():
    w = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)
    t = T256.to_words(w, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(T256.to_u32(t), w)
    np.testing.assert_array_equal(T256.to_u32(T256.bits32(T256.words64(t))), w)
    assert T256.words64(t).tolist() == w.tolist()


def test_wrappers_check_their_arguments():
    b = torch.zeros((2, 1, 16), dtype=torch.int32)
    n = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        T256.sha256_masked(b.long(), n)
    with pytest.raises(ValueError):
        T256.sha256_masked(b, n[:1])
    with pytest.raises(ValueError):
        T512.sha512_masked(b, n)
    with pytest.raises(ValueError):
        MK.merkle_level(torch.zeros((1, 3, 8), dtype=torch.int32), torch.ones(1, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        MK.merkle_level(torch.zeros((1, 4, 8), dtype=torch.int32), torch.ones(1, dtype=torch.int32), 0, "md5")


# -- the kernels' arithmetic, compiled as host C++ ---------------------------

_HOST_PROGRAM = r"""
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#include <cstdio>
#include <vector>
#include "sha256.cuh"
#include "ripemd160.cuh"
#include "sha512.cuh"
// stdin: int32 algo, B, M, n_blocks[B], then the words; stdout: digests
int main() {
  int32_t hdr[3];
  if (fread(hdr, 4, 3, stdin) != 3) return 1;
  const int algo = hdr[0], B = hdr[1], M = hdr[2];
  const int bw = algo == 2 ? 32 : 16;
  std::vector<int32_t> nb(B);
  std::vector<uint32_t> w((size_t)B * M * bw);
  if (fread(nb.data(), 4, B, stdin) != (size_t)B || fread(w.data(), 4, w.size(), stdin) != w.size()) return 1;
  for (int b = 0; b < B; ++b) {
    const uint32_t* row = w.data() + (size_t)b * M * bw;
    const int n = nb[b] < 0 ? 0 : (nb[b] > M ? M : nb[b]);
    if (algo == 0) {
      uint32_t s[8];
      sha256::init(s);
      for (int j = 0; j < n; ++j) sha256::compress(s, row + j * 16);
      fwrite(s, 4, 8, stdout);
    } else if (algo == 1) {
      uint32_t s[5];
      ripemd160::init(s);
      for (int j = 0; j < n; ++j) ripemd160::compress(s, row + j * 16);
      fwrite(s, 4, 5, stdout);
    } else if (algo == 2) {  // the kernel's split: schedule into a strided ring, then the rounds
      uint64_t s[8], ring[80 * 3];
      sha512::init(s);
      for (int j = 0; j < n; ++j) {
        uint64_t x[16];
        for (int q = 0; q < 16; ++q) x[q] = ((uint64_t)row[j * 32 + 2 * q] << 32) | row[j * 32 + 2 * q + 1];
        sha512::schedule(ring + 1, 3, x);
        sha512::rounds(s, ring + 1, 3);
      }
      for (int i = 0; i < 8; ++i) {
        const uint32_t hl[2] = {(uint32_t)(s[i] >> 32), (uint32_t)s[i]};
        fwrite(hl, 4, 2, stdout);
      }
    } else if (algo == 3) {  // row = L (8 words), R (8 words)
      uint32_t h[8];
      sha256::inner_node(row, row + 8, h);
      fwrite(h, 4, 8, stdout);
    } else {  // row = L (5 words), R (5 words), 6 unused
      uint32_t h[5];
      ripemd160::inner_node(row, row + 5, h);
      fwrite(h, 4, 5, stdout);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_program(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernels' headers")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "host.cpp").write_text(_HOST_PROGRAM)
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-Wno-unknown-pragmas", "-I", str(CSRC), str(d / "host.cpp"), "-o", str(d / "host")],
        check=True, capture_output=True, timeout=120,
    )
    return d / "host"


def _run_host_program(prog, algo, blocks, n_blocks):
    bsz, mb, _w = blocks.shape
    data = np.array([algo, bsz, mb], np.int32).tobytes()
    data += np.asarray(n_blocks, np.int32).tobytes() + np.ascontiguousarray(blocks, np.uint32).tobytes()
    out = subprocess.run([str(prog)], input=data, capture_output=True, check=True, timeout=60).stdout
    return np.frombuffer(out, np.uint32).reshape(bsz, -1)


def test_kernel_arithmetic_equals_hashlib(host_program):
    msgs = _msgs(LENGTHS + [305, 1000], 10)
    cases = (
        (0, TP.pad_sha256, TP.digests_to_bytes_be, lambda m: hashlib.sha256(m).digest()),
        (1, TP.pad_ripemd160, TP.digests_to_bytes_le, _ripemd),
        (2, TP.pad_sha512, TP.digests_to_bytes_be, lambda m: hashlib.sha512(m).digest()),
    )
    for algo, pad, to_bytes, ref in cases:
        blocks, n = pad(msgs)
        assert to_bytes(_run_host_program(host_program, algo, blocks, n)) == [ref(m) for m in msgs]


def test_kernel_inner_nodes_equal_hashlib(host_program):
    rng = np.random.default_rng(11)
    for algo, size, order, ref, to_bytes in (
        (3, 32, ">u4", hashlib.sha256, TP.digests_to_bytes_be),
        (4, 20, "<u4", lambda m: hashlib.new("ripemd160", m), TP.digests_to_bytes_le),
    ):
        pairs = [(rng.bytes(size), rng.bytes(size)) for _ in range(6)]
        words = np.zeros((6, 1, 16), np.uint32)
        for i, (l, r) in enumerate(pairs):
            words[i, 0, : size // 2] = np.frombuffer(l + r, order)
        got = to_bytes(_run_host_program(host_program, algo, words, np.ones(6)))
        assert got == [ref(b"\x01" + l + r).digest() for l, r in pairs]


# -- trees against the JAX package's host tree --------------------------------


def _items(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(0, 130, n)]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("n", TREE_SIZES)
def test_merkle_root_device_equals_jax_host_tree(algo, n):
    items = _items(n, 100 + n)
    assert MK.merkle_root_device(items, algo, "cpu") == JS.simple_hash_from_byte_slices(items, algo)


@pytest.mark.parametrize("algo", ALGOS)
def test_forest_equals_jax_host_tree(algo):
    """One forest of all the listed sizes: 21 trees, padded to 32."""
    trees = [_items(n, 200 + n) for n in TREE_SIZES]
    assert MK.merkle_roots_forest(trees, algo, "cpu") == [JS.simple_hash_from_byte_slices(t, algo) for t in trees]


@pytest.mark.parametrize("algo", ALGOS)
def test_root_from_leaf_words_equals_jax_host_tree(algo):
    for n in (1, 2, 3, 17, 100):
        leaves = [JS.leaf_hash(x, algo) for x in _items(n, 300 + n)]
        order = ">u4" if algo == "sha256" else "<u4"
        words = np.frombuffer(b"".join(leaves), order).astype(np.uint32).reshape(n, -1)
        root = MK.merkle_root_from_leaf_words(words, algo=algo, device="cpu")
        to_bytes = TP.digests_to_bytes_be if algo == "sha256" else TP.digests_to_bytes_le
        assert to_bytes(T256.to_u32(root)[None])[0] == JS.simple_hash_from_hashes(leaves, algo)


@pytest.mark.parametrize("algo", ALGOS)
def test_merkle_level_promotes_the_unpaired_node(algo):
    """Counts 1, 3, 4 over P = 4 slots: pairs only inside the valid prefix."""
    w = MK.WIDTHS[algo]
    nodes = torch.arange(3 * 4 * w, dtype=torch.int32).reshape(3, 4, w)
    counts = torch.tensor([1, 3, 4], dtype=torch.int32)
    out = MK.merkle_level(nodes, counts, 0, algo)
    assert torch.equal(out[0], nodes[0, 0::2])  # one leaf: nothing pairs
    assert torch.equal(out[1, 1], nodes[1, 2])  # leaf 2 of 3 is promoted
    assert not torch.equal(out[1, 0], nodes[1, 0]) and not torch.equal(out[2, 1], nodes[2, 2])
    # level 1 of a 3-leaf tree: ceil(3 / 2) = 2 nodes, one pair
    out1 = MK.merkle_level(out, counts, 1, algo)
    assert torch.equal(out1[0, 0], nodes[0, 0])


@pytest.mark.parametrize("algo", ALGOS)
def test_leaf_hashes_device_equals_host(algo):
    items = _items(40, 400)
    assert MK.leaf_hashes_device(items, algo, "cpu") == [JS.leaf_hash(x, algo) for x in items]


def test_empty_inputs_behave_as_in_jax():
    with pytest.raises(ValueError):
        MK.merkle_root_from_leaf_words(np.zeros((0, 8), np.uint32), device="cpu")
    with pytest.raises(ValueError):
        MK.merkle_root_from_leaf_words(np.zeros((3, 5), np.uint32), device="cpu")  # not sha256's width
    assert MK.merkle_root_device([], "sha256", "cpu") == b""
    assert MK.merkle_roots_forest([], "sha256", "cpu") == []
    with pytest.raises(ValueError):
        MK.merkle_roots_forest([[b"a"], []], "sha256", "cpu")
    assert MK.leaf_hashes_device([], "sha256", "cpu") == []
    assert MK.merkle_root_device([b"only"], "ripemd160", "cpu") == JS.leaf_hash(b"only", "ripemd160")


# -- host hashing, host tree and proofs against the JAX package ---------------


def test_host_hashing_matches_jax():
    assert TH.DEFAULT_ALGO == JH.DEFAULT_ALGO
    for m in _msgs([0, 1, 64, 300], 12):
        for algo in ALGOS:
            assert TH.tmhash(m, algo) == JH.tmhash(m, algo)
        assert TH.sha512(m) == JH.sha512(m)
    with pytest.raises(ValueError):
        TH.tmhash(b"", "md5")


@pytest.mark.parametrize("algo", ALGOS)
def test_host_tree_and_proofs_match_jax(algo):
    items = _items(13, 500)
    assert TS.simple_hash_from_byte_slices(items, algo) == JS.simple_hash_from_byte_slices(items, algo)
    assert TS.simple_hash_from_byte_slices([], algo) == b""
    root, proofs = TS.simple_proofs_from_byte_slices(items, algo)
    jroot, jproofs = JS.simple_proofs_from_byte_slices(items, algo)
    assert root == jroot
    for p, jp, item in zip(proofs, jproofs, items):
        assert p.encode() == jp.encode()
        assert TS.SimpleProof.decode(jp.encode()) == p
        assert TS.verify_proof(root, item, p, algo)
        assert not TS.verify_proof(root, item + b"x", p, algo)
    kvs = {"b": b"2", "a": b"1", "c": b"\x00" * 200}
    assert TS.simple_hash_from_map(kvs, algo) == JS.simple_hash_from_map(kvs, algo)
