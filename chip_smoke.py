#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ed25519 verify path and Merkle hash
plane once on the card.

    python3 chip_smoke.py            # one CUDA card, about 2-4 minutes

Phases (inputs made from --seed with numpy, signed with the port's
pure-Python RFC 8032 module, messages as long as a canonical vote's sign
bytes):

0. environment: card name and power limit, torch/CUDA/nvcc versions;
   builds the kernels from `tendermint_tpu_torch/csrc` (ptxas register
   and spill lines printed);
2. consensus commit: one commit of a 10,000-validator set through
   `default_verifier().verify_commits` — tables built on the card, the
   entries-chain kernel (`madd_chain_entries`, selecting its entries
   from the tables itself);
3. fast-sync window: 16 stacked commits of a 1000-validator set — the
   fused kernel (`madd_chain_fused`);
4. flat batch: `verify_batch` on 4096 triples with distinct keys — the
   `ladder` kernel (decompression, [h](-A) and [S]B in one kernel);
   every phase ends in the `finish_encode_compare` kernel (one batched
   inversion a block, encode, compare with R);
5. hash plane (bytes made from --seed): the data_hash of a block of
   65,536 txs of 250 bytes through `TreeHasher(device).root_from_items`
   for `sha256` and `ripemd160` (one leaf launch, 16 `merkle_level`
   launches a call), each root bit-equal to the host tree, 5 warm calls
   timed beside the host tree (Merkle leaves/s); `merkle_roots_forest`
   over 16 blocks of 1-4,096 txs of 1-1,024 bytes (a 1-tx block and a
   power of two among them); the state-sync gate, `leaf_hashes` over
   8,192 chunks of 64 KiB and `root_from_hashes` over the result, against
   hashlib and the host tree; `sha512_batch` over 4,096 messages of 305
   bytes (R || A || M) against hashlib, and 16,384 more (the fast-sync
   window's lane count) timed beside their bound; then the stages of one call
   (padding, copy in, leaf kernel, levels, copy back), the card's kernels
   in one data_hash call (torch.profiler) and the host-vs-card crossover
   at 256-65k leaves;
1. kernel vs plain: each kernel against its plain torch version on the
   card, on the inputs its phase gave it (the entries chain also at
   4096 lanes and at 3 commits of the fast-sync set), compared exactly
   on the canonical affine coordinates (x, y), T * Z == X * Y, the
   verdicts and, for the ladder, a_ok; the finish on all three chains'
   outputs, on hand-made lanes (sign bit set and cleared, y >= p,
   the identity) and on a batch of three blocks with a Z = 0 lane in
   one (false on every lane); the hash kernels at the data_hash block (the two
   leaf passes, the first level of both trees), every level of the
   forest (both trees) and the SHA-512 batch,
   word for word (everything is an integer: tolerance 0); then
   a per-stage breakdown of one call of each phase, the card's kernel
   time in one call of each phase (torch.profiler) and the flat
   prologue's kernel count, and each kernel and its plain version timed
   with CUDA events around a call (a hash kernel by torch.profiler, its
   device time a launch). Each kernel's bound is the larger of the limb
   products its function needs (100 a field multiply, 55 a squaring;
   FE_OPS_PER_LANE, and for the finish a batched inversion's count with
   one chain a call, not its kernel's one a block) and the bytes it must move
   (madd_chain_entries: the distinct 32-byte table sectors its lanes
   touch); a hash kernel's bound counts the compressions its rows need
   (INSTR_PER_COMPRESSION, `hash_ops`) and the blocks they read. Last,
   the finish at each path's shape by CUDA events and by the profiler's
   device time (`finish_device_ms`), and `sha512_masked` at 16,384
   messages against hashlib and one message alone (`sha512_wide`).

Every verify phase plants a forged signature, an absent vote, an S >= L, an
invalid pubkey encoding and a wrong-length signature, and its verdicts
must equal the expected mask exactly. Launch counts are zeroed just
before each main-path phase and read just after; a phase whose kernel
did not launch fails. The script prints one `kernels` JSON line, the
card's name and power limit, and as its last line
`{"ok": true, "device": {...}}`; any failure exits non-zero without that
line. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

# length of a canonical precommit's sign bytes (tendermint_tpu/types/vote.py
# `Vote.sign_bytes`: 17-character chain id, 20-byte block and parts
# hashes, height 123456, a nanosecond timestamp), measured once on a CPU
MSG_LEN = 241
INT32_LANES_PER_SM_CLOCK = 64  # Hopper white paper: 64 INT32 lanes per SM
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# One rule for every kernel's bound: a field multiply counts 100 limb
# products (10 x 10 in radix 2^26), a squaring 55 (10 squares and 45
# cross products).
PRODUCTS_PER_FE_MUL = 100
PRODUCTS_PER_FE_SQ = 55
SECTOR_BYTES = 32  # the card's unit of a read from device memory
# field (multiplies, squarings) a lane of the ladder kernel runs (csrc/ladder.cu)
LADDER_FE_OPS = {
    # d y^2, v^3, v^7, u v^3, u v^7, x, v x^2, x sqrt(-1), T and the 11
    # multiplies of the p58 chain; y^2, v^2, v^6, x^2 and its 251 squarings
    "decompress": (20, 255),
    "table": (1 + 15 * (8 + 1), 0),  # -A cached, 15 additions, each cached
    # 4 doublings a window of 4 squarings and 3 multiplies, T only before an addition
    "doublings": (63 * (3 * 3 + 4), 63 * 4 * 4),
    "window_adds": (64 * 8, 0),
    "comb": (64 * 7, 0),
    "join": (1 + 8, 0),
}
# field (multiplies, squarings) a lane of each function needs
FE_OPS_PER_LANE = {
    "madd_chain_entries": (96 * 7, 0),
    "madd_chain_fused": (128 * 7 + 9, 0),  # two 64-step halves and one addition
    "ladder": tuple(map(sum, zip(*LADDER_FE_OPS.values()))),
    # encode(x/z, y/z) needs a batched (Montgomery) inversion's 3
    # multiplies a lane, then x/z and y/z; the kernel runs one chain a
    # block of 32-256 lanes, more than the one a call counted below
    "finish_encode_compare": (3 + 2, 0),
}
# field (multiplies, squarings) once a call: the batched inversion's one
# shared z^(p-2)
FE_OPS_PER_CALL = {"finish_encode_compare": (11, 254)}
# kernels a flat call ran when torch decompressed A, built B - A and
# inverted before the ladder (PERF.md, run F)
EAGER_PROLOGUE_FLAT_CALL_KERNELS = 33818
# name -> (source, the JAX function it replaces)
KERNEL_INFO = {
    "madd_chain_entries": (
        "tendermint_tpu_torch/csrc/madd_chain.cu",
        "tendermint_tpu/ops/ed25519_tables.py:609",
    ),
    "madd_chain_fused": (
        "tendermint_tpu_torch/csrc/madd_chain.cu",
        "tendermint_tpu/ops/ed25519_tables.py:775",
    ),
    "ladder": (
        "tendermint_tpu_torch/csrc/ladder.cu",
        "tendermint_tpu/ops/ed25519_ladder_pallas.py:155",
    ),
    # XLA stages of the JAX package, not Pallas kernels
    "finish_encode_compare": (
        "tendermint_tpu_torch/csrc/finish.cu",
        "tendermint_tpu/ops/ed25519_tables.py:895",
    ),
    "sha256_masked": (
        "tendermint_tpu_torch/csrc/hash.cu",
        "tendermint_tpu/ops/sha256_kernel.py:91",
    ),
    "ripemd160_masked": (
        "tendermint_tpu_torch/csrc/hash.cu",
        "tendermint_tpu/ops/ripemd160_kernel.py:118",
    ),
    "sha512_masked": (
        "tendermint_tpu_torch/csrc/hash.cu",
        "tendermint_tpu/ops/sha512_kernel.py:129",
    ),
    "merkle_level": (
        "tendermint_tpu_torch/csrc/hash.cu",
        "tendermint_tpu/ops/merkle_kernel.py:106",
    ),
}
# 32-bit instructions of one compression, counted from the kernels' code
# (csrc/sha256.cuh, ripemd160.cuh, sha512.cuh) as the card can issue it,
# as (logic functions and shifts, all): a logic function of three words
# is one LOP3, a sum of three words one IADD3, a rotate or a shift across
# two words one funnel shift (SHF); a 64-bit operation is two. SHA-256:
# 48 schedule steps of 10 (8 LOP3/SHF), 64 rounds of 14 (10), 8
# additions; RIPEMD-160: 160 steps of 3 LOP3/SHF and 3 additions (2
# where K = 0), 5 sums; SHA-512: 64 schedule steps of 20 (16), 80 rounds
# of 28 (20), 8 additions of 2.
INSTR_PER_COMPRESSION = {
    "sha256": (48 * 8 + 64 * 10, 48 * 10 + 64 * 14 + 8),
    "ripemd160": (160 * 3, 128 * 6 + 32 * 5 + 5),
    "sha512": (64 * 16 + 80 * 20, 64 * 20 + 80 * 28 + 8 * 2),
}
LEAF_KERNEL = {"sha256": "sha256_masked", "ripemd160": "ripemd160_masked"}
# the hash kernels' symbols as the profiler reports them: their `ms` is
# the profiler's device time a launch, since a CUDA-event pair around one
# 10-60 us launch times mostly the launch; the verify kernels keep the
# event time of a call, as in their earlier rows, so trees stay comparable
PROFILED = {
    "sha256_masked": "sha256_masked_kernel",
    "ripemd160_masked": "ripemd160_masked_kernel",
    "sha512_masked": "sha512_masked_kernel",
    "merkle_level": "merkle_level_kernel",
}
# torch.profiler sessions a measurement may take (`profiled`), and the
# sessions of this run that recorded no device activity and were redone
PROFILE_TRIES = 3
LOST_SESSIONS = [0]
# the hash phase's sizes: a block of TXS txs of TX_BYTES (tm-bench's
# default tx size; BASELINE config 4's 65k-tx block), a fast-sync window
# of FOREST_TREES blocks of 1 to FOREST_MAX_TXS txs, the state-sync gate
# over CHUNKS chunks of CHUNK_BYTES (statesync/snapshot.py), SHA512_MSGS
# messages of R || A || M (and SHA512_WIDE_MSGS, the fast-sync window's
# lanes, for one more timing), HASH_REPS warm calls
TXS = 65536
TX_BYTES = 250
FOREST_TREES = 16
FOREST_MAX_TXS = 4096
CHUNKS = 8192
CHUNK_BYTES = 65536
SHA512_MSGS = 4096
SHA512_WIDE_MSGS = 16384
HASH_REPS = 5
# Two floors for one SHA-512 message, whose compressions are sequential,
# so no width of batch runs one below them: the dependent chain of a
# round through e (csrc/sha512.cuh `rounds`: the rotates of S1 (SHF),
# their XOR (LOP3), then the 64-bit sums into e as a low IADD3 and a high
# IADD3.X, twice), each at an assumed 4 cycles of ALU latency; and the
# round warp's issue, 20 logic functions and shifts a round
# (INSTR_PER_COMPRESSION), each two clocks of a warp on its scheduler's
# 16-lane ALU pipe (INT32_LANES_PER_SM_CLOCK / 4).
SHA512_ROUND_DEPTH = 6
ALU_LATENCY_CYCLES = 4
SHA512_ROUND_ALU = 20


def sha256_folded(block: list) -> tuple[int, int]:
    """(logic functions and shifts, all) instructions of one SHA-256
    compression of a block whose words are ints where known when the
    kernel is compiled, None where known only at run time: the unrolled
    schedule folds a step whose terms are all constants, and a sigma of a
    constant or a zero term costs nothing; the 64 rounds and 8 additions
    are as in INSTR_PER_COMPRESSION (K is read from the constant bank, so
    W[t] + K[t] does not fold)."""
    rotr = lambda x, n: ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF  # noqa: E731
    sigma = (
        lambda x: rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3),
        lambda x: rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10),
    )
    w = list(block)
    alu, total = 64 * 10, 64 * 14 + 8
    for t in range(16, 64):
        terms = [w[t - 16], w[t - 7]]
        for f, x in zip(sigma, (w[t - 15], w[t - 2])):
            if x is None:  # two rotates, a shift, one LOP3
                alu, total = alu + 4, total + 4
            terms.append(None if x is None else f(x))
        known = sum(x for x in terms if x is not None) & 0xFFFFFFFF
        unknown = terms.count(None)
        k = unknown + (known != 0)
        total += k // 2  # one IADD3 adds three terms
        w.append(None if unknown else known)
    return alu, total


# an inner node of the SHA-256 tree: a block of 16 run-time words, then
# R's last byte, the pad byte, 14 zeros and the bit length 520; and the 18
# instructions that build its message words (one funnel shift each, two
# for the second block's first word)
INSTR_PER_SHA256_INNER_NODE = tuple(
    a + b + 18
    for a, b in zip(INSTR_PER_COMPRESSION["sha256"], sha256_folded([None] + [0] * 14 + [65 * 8]))
)


def sh(cmd: list[str]) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


class Inputs:
    """Keys, messages and signatures for every phase, from one seed."""

    def __init__(self, seed: int, n_keys: int):
        from tendermint_tpu_torch.crypto import ed25519_ref

        self.ref = ed25519_ref
        self.rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        raw = self.rng.integers(0, 256, size=(n_keys, 32), dtype=np.uint8)
        self.seeds = [bytes(row) for row in raw]
        self.pubs = [ed25519_ref.public_from_seed(s) for s in self.seeds]
        self.keygen_s = time.perf_counter() - t0

    def msgs(self, n: int) -> list[bytes]:
        raw = self.rng.integers(0, 256, size=(n, MSG_LEN), dtype=np.uint8)
        return [bytes(row) for row in raw]

    def sign(self, idx: int, msg: bytes) -> bytes:
        return self.ref.sign(self.seeds[idx], msg)


def bad_pubkey() -> bytes:
    """A non-canonical encoding (y = 2^255 - 1 >= p): decodes to nothing."""
    return b"\xff" * 31 + b"\x7f"


def forge(sig: bytes) -> bytes:
    return bytes([sig[0] ^ 0x01]) + sig[1:]


def s_plus_l(sig: bytes) -> bytes:
    from tendermint_tpu_torch.ops.ed25519_kernel import L

    s = int.from_bytes(sig[32:], "little") + L
    return sig[:32] + s.to_bytes(32, "little")


def make_commit(inp: Inputs, keys: list[int], plant: dict):
    """(pubkeys, msgs, sigs, expected) for one commit over `keys`;
    `plant` maps a kind to the lane that gets it."""
    n = len(keys)
    pubs = [inp.pubs[i] for i in keys]
    msgs = inp.msgs(n)
    sigs = [inp.sign(k, m) for k, m in zip(keys, msgs)]
    expected = np.ones(n, dtype=bool)
    for kind, lane in plant.items():
        expected[lane] = False
        if kind == "forged":
            sigs[lane] = forge(sigs[lane])
        elif kind == "absent":
            msgs[lane] = sigs[lane] = None
        elif kind == "s_ge_l":
            sigs[lane] = s_plus_l(sigs[lane])
        elif kind == "bad_key":
            pubs[lane] = bad_pubkey()
        elif kind == "short_sig":
            sigs[lane] = sigs[lane][:63]
    return pubs, msgs, sigs, expected


def check_mask(name: str, got: np.ndarray, expected: np.ndarray) -> None:
    if got.shape != expected.shape or not np.array_equal(got, expected):
        bad = np.argwhere(got != expected)[:10].tolist() if got.shape == expected.shape else "shape"
        raise AssertionError(f"{name}: verdicts differ from the expected mask at {bad}")


def timed(fn, sync) -> float:
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn` over `reps` runs, CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wrappers() -> dict:
    from tendermint_tpu_torch.ops.ed25519_ladder import ladder
    from tendermint_tpu_torch.ops.ed25519_tables import (
        finish_encode_compare,
        fused_chain,
        sum_entries,
    )
    from tendermint_tpu_torch.ops.merkle_kernel import merkle_level
    from tendermint_tpu_torch.ops.ripemd160_kernel import ripemd160_masked
    from tendermint_tpu_torch.ops.sha256_kernel import sha256_masked
    from tendermint_tpu_torch.ops.sha512_kernel import sha512_masked

    return {
        "madd_chain_entries": sum_entries,
        "madd_chain_fused": fused_chain,
        "ladder": ladder,
        "finish_encode_compare": finish_encode_compare,
        "sha256_masked": sha256_masked,
        "ripemd160_masked": ripemd160_masked,
        "sha512_masked": sha512_masked,
        "merkle_level": merkle_level,
    }


def counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def affine(point):
    """Canonical affine (x, y) = (X/Z, Y/Z) of every lane, stacked, and
    whether T * Z == X * Y holds on every lane."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_kernel import fe_canon, fe_carry, fe_eq, fe_mul
    from tendermint_tpu_torch.ops.ed25519_tables import fe_batch_invert

    x, y, z, t = (c.contiguous() for c in point)
    zinv = fe_batch_invert(fe_carry(z))
    xy = torch.stack([fe_canon(fe_mul(x, zinv)), fe_canon(fe_mul(y, zinv))])
    return xy, bool(fe_eq(fe_mul(t, z), fe_mul(x, y)).all())


def compare(name, kernel_out, plain_out, r, a_ok=None) -> int:
    """Exact comparison of a kernel's output with its plain version:
    canonical affine x, y (the kernels add in another order, so their
    projective coordinates differ), T * Z == X * Y, the
    encode-and-compare verdicts and, for the ladder, a_ok (a pair:
    kernel's, plain version's). Returns the max absolute difference of
    the affine coordinates (0 when they agree)."""
    from tendermint_tpu_torch.ops.ed25519_tables import _finish_encode_compare

    (ak, tz_k), (ap, tz_p) = affine(kernel_out), affine(plain_out)
    err = int((ak - ap).abs().max().item())
    vk = _finish_encode_compare(*kernel_out[:3], r)
    vp = _finish_encode_compare(*plain_out[:3], r)
    same_ok = a_ok is None or bool((a_ok[0] == a_ok[1]).all())
    if err != 0 or not (tz_k and tz_p and same_ok) or not bool((vk == vp).all()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max_abs_err={err}, "
            f"T*Z == X*Y: {tz_k}/{tz_p}, a_ok equal: {same_ok})"
        )
    return err


def compare_finish(name, point, r) -> int:
    """The finish kernel against its plain version on one chain's output,
    verdict for verdict; returns the number of lanes that differ (0)."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_tables import _finish_encode_compare, finish_encode_compare

    x, y, z = point[:3]
    got = finish_encode_compare(x, y, z, r)
    want = _finish_encode_compare(x.contiguous(), y.contiguous(), z.contiguous(), r.to(torch.int32))
    diff = int((got != want).sum().item())
    if diff:
        raise AssertionError(f"finish_encode_compare on {name}: {diff} verdicts differ from the plain version")
    return diff


def check_finish_edges(dev) -> None:
    """The finish on the hand-made lanes of `finish_edge_lanes` (known
    verdicts, same as the plain version's), then on `finish_mixed_lanes`:
    70 lanes, three blocks of 32, a Z = 0 lane in the middle block with
    an all-zero R (true in the JAX tree, which inverts every lane to 0)
    and valid lanes in the others. The kernel must equal the plain
    version lane for lane: false everywhere with the zero, the known
    verdicts once that Z is 1."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_tables import (
        _finish_encode_compare,
        finish_encode_compare,
        finish_lanes_per_block,
    )
    from tendermint_tpu_torch.testing import MIXED_ZERO_LANE, finish_edge_lanes, finish_mixed_lanes

    x, y, z, r, want = (torch.from_numpy(a).to(dev) for a in finish_edge_lanes())
    got = finish_encode_compare(x, y, z, r)
    plain = _finish_encode_compare(x, y, z, r.to(torch.int32))
    if not (torch.equal(got, want) and torch.equal(plain, want)):
        raise AssertionError(f"finish on hand-made lanes: {got.tolist()} / plain {plain.tolist()}, want {want.tolist()}")
    x, y, z, r, want = (torch.from_numpy(a).to(dev) for a in finish_mixed_lanes())
    if finish_lanes_per_block(x.shape[0], torch.cuda.get_device_properties(dev).multi_processor_count) != 32:
        raise AssertionError("finish: the mixed batch does not span three blocks")
    got = finish_encode_compare(x, y, z, r)
    plain = _finish_encode_compare(x, y, z, r.to(torch.int32))
    if bool(got.any()) or not torch.equal(got, plain):
        raise AssertionError(f"finish with a Z = 0 lane: {got.tolist()} / plain {plain.tolist()}, want all false")
    z[MIXED_ZERO_LANE, 0] = 1
    got = finish_encode_compare(x, y, z, r)
    plain = _finish_encode_compare(x, y, z, r.to(torch.int32))
    if not (torch.equal(got, want) and torch.equal(plain, want)):
        raise AssertionError(f"finish on the mixed batch: {got.tolist()} / plain {plain.tolist()}, want {want.tolist()}")


def entries_bytes(a_tables, s, h) -> tuple[int, int]:
    """Bytes `madd_chain_entries` must move for these digits, and the
    table sectors among them: the distinct 32-byte sectors of the table
    entries its lanes select (an entry's 60 int16 limbs lie N apart), the
    distinct comb entries (240 bytes each), S and h (int32) and the
    (4, 20, B) int32 output."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_tables import _h_nibbles

    n = a_tables.shape[3]
    bsz = s.shape[0]
    dev = s.device
    w = torch.arange(64, device=dev)
    rows = (w * 16 + _h_nibbles(h).long()) * 60  # (B, 64): an entry's first row
    limbs = torch.arange(60, device=dev)
    v = torch.arange(bsz, device=dev) % n
    parts = []
    for lo in range(0, 64, 8):  # 8 windows at a time bounds the scratch
        addr = ((rows[:, lo:lo + 8, None] + limbs) * n + v[:, None, None]) * 2
        parts.append(torch.unique(addr // SECTOR_BYTES))
    sectors = torch.unique(torch.cat(parts)).numel()
    comb = torch.unique(torch.arange(32, device=dev) * 256 + s.long()).numel()
    nbytes = sectors * SECTOR_BYTES + comb * 240 + 2 * s.numel() * 4 + 4 * 20 * bsz * 4
    return nbytes, sectors


def products(fe_ops: tuple[int, int]) -> int:
    muls, squarings = fe_ops
    return muls * PRODUCTS_PER_FE_MUL + squarings * PRODUCTS_PER_FE_SQ


def hash_ops(instr: tuple[int, int], count: int) -> float:
    """`count` times `instr` (logic functions and shifts, all) as INT32
    operations of the 64-lane rate: a SM issues at most 128 lanes of
    instructions a clock (four schedulers of 32), LOP3 and SHF run only on
    the 64-lane ALU pipe, and an addition may also issue on the FMA pipe
    (as IMAD), so the least is the larger of the two."""
    alu, total = instr
    return count * max(alu, total / 2)


def fe_ops(name: str, lanes: int) -> int:
    """32-bit limb products an ed25519 kernel's function needs."""
    return lanes * products(FE_OPS_PER_LANE[name]) + products(FE_OPS_PER_CALL.get(name, (0, 0)))


def bound_ms(ops: float, nbytes: int, clock_hz: float, sms: int) -> tuple[float, str]:
    """The least time for `ops` 32-bit integer operations at the 64-lane
    INT32 rate and `nbytes` moved, the larger of the two, and which one
    sets it."""
    t_ops = ops / (INT32_LANES_PER_SM_CLOCK * sms * clock_hz)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stage_times(dev, verifier, path: str, pubs, commits) -> dict:
    """Seconds of each stage of one call of a phase, the card
    synchronised after each: host prep, copy to the card, the torch
    prologue (the digit packing of the fused and ladder paths), the
    chain kernel, the finish kernel with the copy back."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_ladder as lad
    from tendermint_tpu_torch.ops import ed25519_tables as tab
    from tendermint_tpu_torch.ops.ed25519_kernel import prepare_batch

    out = {}
    clock = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = now - clock[0]
        clock[0] = now

    if path == "ladder":
        msgs, sigs = commits
        pub, r, s, h, _pre = prepare_batch(pubs, msgs, sigs)
        mark("host_prep_s")
        pub, r, s, h = (torch.from_numpy(a).to(dev) for a in (pub, r, s, h))
        mark("to_device_s")
        dig = tab._digits_w4(s.to(torch.int32), h.to(torch.int32))
        mark("prologue_s")
        (x, y, z, _t), a_ok = lad.ladder(pub, dig)
        mark("kernel_s")
        (tab.finish_encode_compare(x, y, z, r) & a_ok).cpu()
        mark("finish_s")
        return out
    tables, _ok = verifier.tables_for(tuple(pubs))
    s, h, r, _pre = tab.prepare_commit_lanes(pubs, commits)
    mark("host_prep_s")
    s, h, r = (torch.from_numpy(a).to(dev) for a in (s, h, r))
    s, h = s.to(torch.int32), h.to(torch.int32)
    mark("to_device_s")
    if path == "entries":
        x, y, z, _t = tab.sum_entries(tables, s, h)
    else:
        dig = tab._digits_w4(s, h)
        mark("prologue_s")
        x, y, z, _t = tab.fused_chain(tables, dig)
    mark("kernel_s")
    tab.finish_encode_compare(x, y, z, r).cpu()
    mark("finish_s")
    return out


def profiled(fn):
    """`key_averages()` of a torch.profiler session around `fn` (the card
    synchronised before it and inside it). On the H100 a session now and
    then ends having recorded no device activity at all, every launch in
    it lost (`python3 -m tendermint_tpu_torch.profiler_drops` counts
    them); such a session is run again, up to PROFILE_TRIES in all, and
    counted in LOST_SESSIONS. Raises when every try was lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(e.device_type == DeviceType.CUDA for e in events):
            return events
        LOST_SESSIONS[0] += 1
    raise AssertionError(f"torch.profiler recorded no device activity in {PROFILE_TRIES} sessions")


def device_time(fn) -> dict:
    """One call of `fn` under torch.profiler (`profiled`): the summed time
    of every kernel the card ran, how many ran, and the eight that took
    longest."""
    from torch.autograd import DeviceType

    kernels = [
        e for e in profiled(fn)
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {
        "device_s": total_us / 1e6,
        "device_kernels": sum(e.count for e in kernels),
        "top": [
            {"name": e.key[:90], "count": e.count, "ms": e.self_device_time_total / 1e3}
            for e in top
        ],
    }


def byte_items(rng, lens) -> list[bytes]:
    """Random byte strings of the given lengths, cut from one buffer."""
    ends = np.cumsum(lens)
    buf = rng.bytes(int(ends[-1]))
    return [buf[e - n : e] for n, e in zip(np.asarray(lens).tolist(), ends.tolist())]


def max_err(got, want) -> int:
    """Largest absolute difference of two int32 word tensors (0 when equal)."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shapes differ: {tuple(got.shape)} / {tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) if got.numel() else 0


def kernel_ms(fn, symbol: str, reps: int) -> tuple[float, int]:
    """Device milliseconds of one launch of the kernel named `symbol`,
    from torch.profiler over `reps` calls of `fn`, and the launches it
    recorded: the mean over those (it has dropped one of five
    back-to-back 30 us launches); raises when it recorded fewer than
    `reps` - 1 or more than `reps`."""
    from torch.autograd import DeviceType

    def calls():
        for _ in range(reps):
            fn()

    hits = [e for e in profiled(calls) if e.device_type == DeviceType.CUDA and symbol in e.key]
    seen = sum(e.count for e in hits)
    if not max(1, reps - 1) <= seen <= reps:
        raise AssertionError(f"the profiler saw {seen} launches of {symbol} in {reps} calls")
    return sum(e.self_device_time_total for e in hits) / 1e3 / seen, seen


def hash_stage_times(dev, items, algo, levels: bool = True) -> dict:
    """Seconds of each stage of one tree build (or, levels=False, one
    leaf-hash pass), the card synchronised after each: padding on the
    host, copy to the card, the leaf kernel, the levels, the copy back."""
    import torch

    from tendermint_tpu_torch.ops import merkle_kernel as mk
    from tendermint_tpu_torch.ops.sha256_kernel import to_u32, to_words

    out = {}
    clock = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = now - clock[0]
        clock[0] = now

    blocks, n_blocks = mk._pad_leaves(items, algo)
    mark("padding_s")
    b, n = to_words(blocks, dev), to_words(n_blocks, dev)
    mark("to_device_s")
    digs = mk._leaf_kernel(algo)(b, n)
    mark("leaf_kernel_s")
    if levels:
        digs = mk.merkle_root_from_leaf_words(digs, algo=algo, device=dev)[None]
        mark("levels_s")
    mk._to_bytes(algo)(to_u32(digs))
    mark("copy_back_s")
    return out


def run_hash(seed: int, dev, sync) -> tuple[dict, dict, tuple]:
    """The hash phase's main path, each step with the launch counts set
    to 0 just before it and read just after: a 65,536-tx block's
    data_hash for both tree variants, a forest, the state-sync gate and a
    SHA-512 batch, at the sizes of the module's constants. Returns the
    report, the summed launches and the inputs (txs, forest, chunks,
    SHA-512 messages)."""
    import hashlib

    from tendermint_tpu_torch.merkle import simple as host
    from tendermint_tpu_torch.ops import merkle_kernel as mk
    from tendermint_tpu_torch.ops.padding import digests_to_bytes_be, pad_sha512
    from tendermint_tpu_torch.ops.sha256_kernel import to_u32
    from tendermint_tpu_torch.ops.sha512_kernel import sha512_batch
    from tendermint_tpu_torch.services.hasher import TreeHasher

    rng = np.random.default_rng(seed + 5)
    rep: dict = {}
    launches = dict.fromkeys(("sha256_masked", "ripemd160_masked", "sha512_masked", "merkle_level"), 0)

    def add(c, expect: dict, what: str) -> dict:
        got = {k: c[k] for k in launches}
        for k, v in expect.items():
            if got[k] != v:
                raise AssertionError(f"{what}: {k} launched {got[k]} times, expected {v}")
        for k in launches:
            launches[k] += got[k]
        return got

    def host_median(fn) -> tuple[float, list]:
        times = []
        for _ in range(HASH_REPS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times), times

    # block data_hash: TXS transactions of TX_BYTES
    t0 = time.perf_counter()
    txs = byte_items(rng, np.full(TXS, TX_BYTES))
    rep["tx_gen_s"] = time.perf_counter() - t0
    levels = mk._next_pow2(TXS).bit_length() - 1
    rep["data_hash"] = {}
    for algo in ("sha256", "ripemd160"):
        want = host.simple_hash_from_byte_slices(txs, algo)
        host_s, host_all = host_median(lambda: host.simple_hash_from_byte_slices(txs, algo))
        hasher = TreeHasher(algo=algo, device=dev)
        got = []
        reset_counts()
        cold = timed(lambda: got.append(hasher.root_from_items(txs)), sync)
        warm = [timed(lambda: got.append(hasher.root_from_items(txs)), sync) for _ in range(HASH_REPS)]
        calls = 1 + HASH_REPS
        c = add(counts(), {LEAF_KERNEL[algo]: calls, "merkle_level": calls * levels}, f"data_hash {algo}")
        if any(g != want for g in got):
            raise AssertionError(f"data_hash {algo}: the card's root differs from the host tree's")
        med = statistics.median(warm)
        d = {
            "txs": TXS,
            "tx_bytes": TX_BYTES,
            "root": want.hex(),
            "cold_s": cold,
            "warm_s_median": med,
            "warm_s": warm,
            "leaves_per_s": TXS / med,
            "host_s_median": host_s,
            "host_s": host_all,
            "host_leaves_per_s": TXS / host_s,
            "launches": c,
        }
        rep["data_hash"][algo] = d
        log({"phase": "hash", "part": "data_hash", "algo": algo, **{k: v for k, v in d.items() if k != "warm_s"}})

    # forest: a fast-sync window of blocks, 1..FOREST_MAX_TXS txs of 1..1024 bytes
    sizes = rng.integers(1, FOREST_MAX_TXS + 1, FOREST_TREES)
    sizes[0], sizes[-1] = 1, FOREST_MAX_TXS  # a 1-tx tree and a power of two
    trees = [byte_items(rng, rng.integers(1, 1025, k)) for k in sizes]
    rep["forest"] = {"trees": FOREST_TREES, "txs": int(sizes.sum())}
    for algo in ("sha256", "ripemd160"):
        t0 = time.perf_counter()
        want = [host.simple_hash_from_byte_slices(t, algo) for t in trees]
        host_s = time.perf_counter() - t0
        got = []
        reset_counts()
        dt = timed(lambda: got.append(mk.merkle_roots_forest(trees, algo, dev)), sync)
        c = add(counts(), {LEAF_KERNEL[algo]: 1}, f"forest {algo}")
        if got[0] != want:
            raise AssertionError(f"forest {algo}: roots differ from the host tree's")
        rep["forest"][algo] = {"s": dt, "host_s": host_s, "launches": c}
    log({"phase": "hash", "part": "forest", **rep["forest"]})

    # state-sync gate: CHUNKS chunks of CHUNK_BYTES, their leaf hashes and root
    t0 = time.perf_counter()
    chunks = byte_items(rng, np.full(CHUNKS, CHUNK_BYTES))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_leaves = [hashlib.sha256(b"\x00" + c).digest() for c in chunks]
    host_leaf_s = time.perf_counter() - t0
    want_root = host.simple_hash_from_hashes(want_leaves)
    hasher = TreeHasher(algo="sha256", device=dev)
    got = []
    reset_counts()
    cold = timed(lambda: got.append(hasher.leaf_hashes(chunks)), sync)
    warm = timed(lambda: got.append(hasher.leaf_hashes(chunks)), sync)
    roots = []
    root_s = timed(lambda: roots.append(hasher.root_from_hashes(got[-1])), sync)
    sync_levels = mk._next_pow2(CHUNKS).bit_length() - 1
    c = add(counts(), {"sha256_masked": 2, "merkle_level": sync_levels}, "state-sync gate")
    if any(g != want_leaves for g in got) or roots[0] != want_root:
        raise AssertionError("state-sync gate: leaf hashes or root differ from hashlib and the host tree")
    rep["state_sync"] = {
        "chunks": CHUNKS,
        "chunk_bytes": CHUNK_BYTES,
        "gen_s": gen_s,
        "cold_leaf_hashes_s": cold,
        "warm_leaf_hashes_s": warm,
        "host_leaf_hashes_s": host_leaf_s,
        "root_from_hashes_s": root_s,
        "launches": c,
    }
    log({"phase": "hash", "part": "state_sync", **rep["state_sync"]})

    # SHA-512 of R || A || M, as long as the flat phase's
    msgs = byte_items(rng, np.full(SHA512_MSGS, 64 + MSG_LEN))
    blocks, n_blocks = pad_sha512(msgs)
    reset_counts()
    out = []
    dt = timed(lambda: out.append(sha512_batch(blocks, n_blocks, dev)), sync)
    c = add(counts(), {"sha512_masked": 1}, "sha512")
    if digests_to_bytes_be(to_u32(out[0])) != [hashlib.sha512(m).digest() for m in msgs]:
        raise AssertionError("sha512_batch differs from hashlib")
    rep["sha512"] = {"msgs": SHA512_MSGS, "msg_bytes": 64 + MSG_LEN, "s": dt, "launches": c}
    log({"phase": "hash", "part": "sha512", **rep["sha512"]})
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the hash phase did not launch {name}")
    return rep, launches, (txs, trees, chunks, msgs)


def hash_kernels(dev, txs, trees, msgs) -> list:
    """The four hash kernels against their plain versions on the card, at
    the data_hash block (leaf passes and the first level, both variants),
    every level of the forest (mixed counts: unpaired nodes promoted) and
    the SHA-512 batch; entries for the kernels line."""
    import torch

    from tendermint_tpu_torch.ops import merkle_kernel as mk
    from tendermint_tpu_torch.ops import ripemd160_kernel as hr
    from tendermint_tpu_torch.ops import sha256_kernel as hs
    from tendermint_tpu_torch.ops import sha512_kernel as h5
    from tendermint_tpu_torch.ops.padding import pad_sha512
    from tendermint_tpu_torch.ops.sha256_kernel import to_words

    entries = []
    level_err = 0
    plains = {"sha256": hs._sha256_masked, "ripemd160": hr._ripemd160_masked}
    n = len(txs)
    p = mk._next_pow2(n)
    for algo in ("sha256", "ripemd160"):
        blocks, n_blocks = mk._pad_leaves(txs, algo)
        b, nb = to_words(blocks, dev), to_words(n_blocks, dev)
        kern, plain = mk._leaf_kernel(algo), plains[algo]
        digs = kern(b, nb)
        err = max_err(digs, plain(b, nb))
        if err:
            raise AssertionError(f"{LEAF_KERNEL[algo]}: kernel disagrees with its plain version ({err})")
        comps = int(n_blocks.sum())
        width = mk.WIDTHS[algo]
        entries.append((LEAF_KERNEL[algo], err, lambda k=kern, b=b, nb=nb: k(b, nb),
                        lambda f=plain, b=b, nb=nb: f(b, nb), n,
                        hash_ops(INSTR_PER_COMPRESSION[algo], comps), comps * 64 + 4 * n + 4 * width * n))
        nodes = torch.cat([digs, digs.new_zeros((p - n, width))]).view(1, p, width)
        counts_t = torch.tensor([n], dtype=torch.int32, device=dev)
        level_err = max(level_err, max_err(mk.merkle_level(nodes, counts_t, 0, algo),
                                           mk._merkle_level(nodes, counts_t, 0, algo)))
        f_nodes, f_counts = mk.forest_leaves(trees, algo, dev)
        for lv in range(f_nodes.shape[1].bit_length() - 1):
            got = mk.merkle_level(f_nodes, f_counts, lv, algo)
            level_err = max(level_err, max_err(got, mk._merkle_level(f_nodes, f_counts, lv, algo)))
            f_nodes = got
        if level_err:
            raise AssertionError(f"merkle_level ({algo}): kernel disagrees with its plain version ({level_err})")
        if algo == "sha256":
            level = (nodes, counts_t, hash_ops(INSTR_PER_SHA256_INNER_NODE, n // 2), nodes.numel() * 4 * 3 // 2 + 4)
    nodes, counts_t, ops, nbytes = level
    entries.append(("merkle_level", level_err, lambda: mk.merkle_level(nodes, counts_t, 0),
                    lambda: mk._merkle_level(nodes, counts_t, 0), p // 2, ops, nbytes))
    blocks, n_blocks = pad_sha512(msgs)
    b, nb = to_words(blocks, dev), to_words(n_blocks, dev)
    err = max_err(h5.sha512_masked(b, nb), h5._sha512_masked(b, nb))
    if err:
        raise AssertionError(f"sha512_masked: kernel disagrees with its plain version ({err})")
    comps = int(n_blocks.sum())
    entries.append(("sha512_masked", err, lambda: h5.sha512_masked(b, nb), lambda: h5._sha512_masked(b, nb),
                    len(msgs), hash_ops(INSTR_PER_COMPRESSION["sha512"], comps), comps * 128 + 4 * len(msgs) + 64 * len(msgs)))
    return entries


def sha512_wide(seed: int, dev, clock_hz: float, sms: int, reps: int) -> dict:
    """`sha512_masked` at SHA512_WIDE_MSGS messages of R || A || M: the
    digests against hashlib, the profiler's device time a launch and the
    bound, as for the kernels line; then one message alone, and the two
    floors of one message (SHA512_ROUND_DEPTH, SHA512_ROUND_ALU)."""
    import hashlib

    from tendermint_tpu_torch.ops.padding import digests_to_bytes_be, pad_sha512
    from tendermint_tpu_torch.ops.sha256_kernel import to_u32, to_words
    from tendermint_tpu_torch.ops.sha512_kernel import sha512_masked

    msgs = byte_items(np.random.default_rng(seed + 6), np.full(SHA512_WIDE_MSGS, 64 + MSG_LEN))
    blocks, n_blocks = pad_sha512(msgs)
    b, nb = to_words(blocks, dev), to_words(n_blocks, dev)
    if digests_to_bytes_be(to_u32(sha512_masked(b, nb))) != [hashlib.sha512(m).digest() for m in msgs]:
        raise AssertionError(f"sha512_masked at {SHA512_WIDE_MSGS} messages differs from hashlib")
    ms, seen = kernel_ms(lambda: sha512_masked(b, nb), PROFILED["sha512_masked"], reps)
    comps = int(n_blocks.sum())
    n = len(msgs)
    bms, by = bound_ms(hash_ops(INSTR_PER_COMPRESSION["sha512"], comps), comps * 128 + 4 * n + 64 * n, clock_hz, sms)
    # one message alone: its chain of compressions, the least any batch takes
    one_ms, _seen = kernel_ms(lambda: sha512_masked(b[:1], nb[:1]), PROFILED["sha512_masked"], reps)
    rounds = (comps // n) * 80
    warp_clocks = 32 / (INT32_LANES_PER_SM_CLOCK / 4)
    return {"msgs": n, "ms": ms, "profiled_launches": seen, "bound_ms": bms, "bound_by": by,
            "one_msg_ms": one_ms,
            "chain_floor_ms": 1e3 * rounds * SHA512_ROUND_DEPTH * ALU_LATENCY_CYCLES / clock_hz,
            "issue_floor_ms": 1e3 * rounds * SHA512_ROUND_ALU * warp_clocks / clock_hz}


def hash_profile(dev, sync, rep, txs, chunks) -> None:
    """After the main path: stage breakdowns, the card's kernels in one
    data_hash call (torch.profiler) and the host-vs-card crossover."""
    from tendermint_tpu_torch.merkle import simple as host
    from tendermint_tpu_torch.ops import merkle_kernel as mk
    from tendermint_tpu_torch.services.hasher import TreeHasher

    rep["stages"] = {algo: hash_stage_times(dev, txs, algo) for algo in ("sha256", "ripemd160")}
    rep["stages"]["state_sync_leaves"] = hash_stage_times(dev, chunks, "sha256", levels=False)
    log({"phase": "hash", "part": "stages", **rep["stages"]})
    rep["device"] = {}
    for algo in ("sha256", "ripemd160"):
        hasher = TreeHasher(algo=algo, device=dev)
        d = device_time(lambda: hasher.root_from_items(txs))
        wall = rep["data_hash"][algo]["warm_s_median"]
        d["wall_s"] = wall
        d["busy_share"] = d["device_s"] / wall
        rep["device"][algo] = d
        log({"phase": "hash", "part": "device", "algo": algo, **{k: v for k, v in d.items() if k != "top"}})
    cross = []
    for n in sorted({min(k, len(txs)) for k in (256, 1024, 4096, 8192, 16384, 65536)}):
        items = txs[:n]
        mk.merkle_root_device(items, "sha256", dev)  # warm
        dev_s = statistics.median(timed(lambda: mk.merkle_root_device(items, "sha256", dev), sync) for _ in range(3))
        host_s = statistics.median(timed(lambda: host.simple_hash_from_byte_slices(items), sync) for _ in range(3))
        cross.append({"leaves": n, "device_s": dev_s, "host_s": host_s})
    rep["crossover_sha256"] = cross
    log({"phase": "hash", "part": "crossover", "sha256": cross})


def run(args) -> dict:
    import torch

    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops import ed25519_ladder as lad
    from tendermint_tpu_torch.ops import ed25519_tables as tab
    from tendermint_tpu_torch.ops.ed25519_kernel import prepare_batch
    from tendermint_tpu_torch.services.verifier import default_verifier

    sync = torch.cuda.synchronize
    report: dict = {"args": vars(args)}

    # -- phase 0: environment and build --------------------------------------
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    clock_mhz = sh(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"])
    nvcc_v = sh([_build.nvcc_path(), "--version"]).splitlines()
    props = torch.cuda.get_device_properties(0)
    env = {
        "nvidia_smi": smi,
        "clocks_max_sm_mhz": clock_mhz,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_v[-1] if nvcc_v else "",
        "sms": props.multi_processor_count,
    }
    t0 = time.perf_counter()
    _build.kernel_lib(verbose=True)
    env["build_s"] = time.perf_counter() - t0
    env["ptxas"] = [
        ln.strip()
        for out in _build.BUILD_LOG
        for ln in out.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln
    ]
    log({"phase": 0, **env})
    report["env"] = env
    clock_hz = float(clock_mhz.split()[0]) * 1e6
    sms = props.multi_processor_count

    inp = Inputs(args.seed, args.validators)
    log({"phase": "keys", "n": args.validators, "keygen_s": inp.keygen_s})
    verifier = default_verifier()
    launches: dict = {}

    # -- phase 2: consensus commit, N validators, K = 1 -----------------------
    n = args.validators
    plant = {"forged": 11, "absent": n // 4, "s_ge_l": n // 3, "bad_key": n // 2, "short_sig": n - 1}
    t0 = time.perf_counter()
    pubs2, msgs2, sigs2, exp2 = make_commit(inp, list(range(n)), plant)
    sign2_s = time.perf_counter() - t0
    reset_counts()
    build_s = timed(lambda: verifier.tables_for(tuple(pubs2)), sync)
    commit = [(msgs2, sigs2)]
    got = []
    cold_s = timed(lambda: got.append(verifier.verify_commits(pubs2, commit)), sync)
    warm = []
    for _ in range(5):
        warm.append(timed(lambda: got.append(verifier.verify_commits(pubs2, commit)), sync))
    c2 = counts()
    for g in got:
        check_mask("consensus commit", g, exp2[None, :])
    for name in ("madd_chain_entries", "finish_encode_compare"):
        if c2[name] == 0:
            raise AssertionError(f"consensus commit did not launch {name}")
    launches["madd_chain_entries"] = c2["madd_chain_entries"]
    tables2, _ok2 = verifier.tables_for(tuple(pubs2))
    p2 = {
        "phase": 2,
        "validators": n,
        "sign_s": sign2_s,
        "table_build_s": build_s,
        "cold_commit_s": cold_s,
        "warm_commit_s_median": statistics.median(warm),
        "warm_commit_s": warm,
        "table_bytes": tables2.numel() * tables2.element_size(),
        "launches": c2,
    }
    log(p2)
    report["consensus"] = p2

    # -- phase 3: fast-sync window, N_sync validators, K = window ------------
    ns, k = args.sync_validators, args.window
    keys3 = list(range(ns))
    commits3, exp3 = [], []
    t0 = time.perf_counter()
    for ci in range(k):
        plant3 = {}
        if ci == 3:
            plant3["forged"] = 5
        if ci == 5:
            plant3["absent"] = 6
        if ci == 7:
            plant3["s_ge_l"] = 7
        if ci == 9:
            plant3["short_sig"] = 8
        plant3["bad_key"] = 17  # the same validator in every commit
        pubs3, m, s, e = make_commit(inp, keys3, plant3)
        commits3.append((m, s))
        exp3.append(e)
    exp3 = np.stack(exp3)
    sign3_s = time.perf_counter() - t0
    reset_counts()
    got = []
    cold3 = timed(lambda: got.append(verifier.verify_commits(pubs3, commits3)), sync)
    warm3 = []
    for _ in range(5):
        warm3.append(timed(lambda: got.append(verifier.verify_commits(pubs3, commits3)), sync))
    c3 = counts()
    for g in got:
        check_mask("fast-sync window", g, exp3)
    for name in ("madd_chain_fused", "finish_encode_compare"):
        if c3[name] == 0:
            raise AssertionError(f"fast-sync window did not launch {name}")
    launches["madd_chain_fused"] = c3["madd_chain_fused"]
    med3 = statistics.median(warm3)
    p3 = {
        "phase": 3,
        "validators": ns,
        "window": k,
        "sign_s": sign3_s,
        "cold_window_s": cold3,
        "warm_window_s_median": med3,
        "warm_window_s": warm3,
        "commits_per_s": k / med3,
        "verifies_per_s": k * ns / med3,
        "launches": c3,
    }
    log(p3)
    report["fast_sync"] = p3

    # -- phase 4: flat batch of distinct keys ---------------------------------
    nf = args.flat
    t0 = time.perf_counter()
    pubs4, msgs4, sigs4, exp4 = make_commit(
        inp,
        list(range(nf)),
        {"forged": 1, "absent": 2, "s_ge_l": 3, "bad_key": 4, "short_sig": 5},
    )
    # a flat batch has no absent slot: the absent vote arrives as an
    # empty message and signature
    msgs4[2], sigs4[2] = b"", b""
    triples = list(zip(pubs4, msgs4, sigs4))
    sign4_s = time.perf_counter() - t0
    reset_counts()
    got = []
    cold4 = timed(lambda: got.append(verifier.verify_batch(triples)), sync)
    warm4 = []
    for _ in range(5):
        warm4.append(timed(lambda: got.append(verifier.verify_batch(triples)), sync))
    c4 = counts()
    for g in got:
        check_mask("flat batch", g, exp4)
    for name in ("ladder", "finish_encode_compare"):
        if c4[name] == 0:
            raise AssertionError(f"flat batch did not launch {name}")
    launches["ladder"] = c4["ladder"]
    # the finish ends every path: its launches over the three phases
    launches["finish_encode_compare"] = sum(c["finish_encode_compare"] for c in (c2, c3, c4))
    med4 = statistics.median(warm4)
    p4 = {
        "phase": 4,
        "lanes": nf,
        "sign_s": sign4_s,
        "cold_batch_s": cold4,
        "warm_batch_s_median": med4,
        "warm_batch_s": warm4,
        "verifies_per_s": nf / med4,
        "launches": c4,
    }
    log(p4)
    report["flat"] = p4

    dev = verifier.device

    # -- phase 5: the hash plane ----------------------------------------------
    hrep, hlaunches, (txs, trees, chunks, sha512_msgs) = run_hash(args.seed, dev, sync)
    launches.update(hlaunches)
    report["hash"] = hrep

    # -- phase 1: each kernel against its plain version, then timed ----------

    def lanes_to_dev(pubs, commits):
        s, h, r, _pre = tab.prepare_commit_lanes(pubs, commits)
        return tuple(torch.from_numpy(a).to(dev).to(torch.int32) for a in (s, h, r))

    kernels = []
    # entries chain at the consensus commit's shape, at 4096 lanes (the
    # first 4096 validators) and at 3 commits of the fast-sync set
    s, h, r = lanes_to_dev(pubs2, commit)
    b2 = s.shape[0]
    e_pt = tab.sum_entries(tables2, s, h)
    err = compare("madd_chain_entries", e_pt, tab._sum_entries_plain(tab._select_entries(tables2, s, h)), r)
    r2u = r.to(torch.uint8)
    finish_err = compare_finish("consensus", e_pt, r2u)
    part = tables2[..., : args.flat].contiguous()
    sp, hp, rp = s[: args.flat], h[: args.flat], r[: args.flat]
    err = max(err, compare("madd_chain_entries", tab.sum_entries(part, sp, hp),
                           tab._sum_entries_plain(tab._select_entries(part, sp, hp)), rp))
    del part
    tables3, _ok3 = verifier.tables_for(tuple(pubs3))
    s3, h3, r3 = lanes_to_dev(pubs3, commits3[:3])
    err = max(err, compare("madd_chain_entries", tab.sum_entries(tables3, s3, h3),
                           tab._sum_entries_plain(tab._select_entries(tables3, s3, h3)), r3))
    nbytes, sectors = entries_bytes(tables2, s, h)
    report["entries_table_sectors"] = sectors
    kernels.append(("madd_chain_entries", err, lambda: tab.sum_entries(tables2, s, h),
                    lambda: tab._sum_entries_plain(tab._select_entries(tables2, s, h)), b2,
                    fe_ops("madd_chain_entries", b2), nbytes))
    # fused chain at the fast-sync window's shape
    s3, h3, r3 = lanes_to_dev(pubs3, commits3)
    dig = tab._digits_w4(s3, h3).contiguous()
    b3 = dig.shape[0]
    f_pt = tab.fused_chain(tables3, dig)
    err = compare("madd_chain_fused", f_pt, tab._fused_chain_plain(tables3, dig), r3)
    r3u = r3.to(torch.uint8)
    finish_err = max(finish_err, compare_finish("fast_sync", f_pt, r3u))
    nbytes = tables3.numel() * 2 + 64 * 16 * 60 * 4 + dig.numel() * 4 + 4 * 20 * b3 * 4
    kernels.append(("madd_chain_fused", err, lambda: tab.fused_chain(tables3, dig),
                    lambda: tab._fused_chain_plain(tables3, dig), b3, fe_ops("madd_chain_fused", b3), nbytes))
    # ladder at the flat batch's shape (the bucket of 4096 lanes)
    pub, rr, ss, hh, _pre = prepare_batch(pubs4, msgs4, sigs4)
    pub, rr, ss, hh = (torch.from_numpy(a).to(dev) for a in (pub, rr, ss, hh))
    ldig = tab._digits_w4(ss.to(torch.int32), hh.to(torch.int32))
    b4 = ldig.shape[0]
    k_pt, k_ok = lad.ladder(pub, ldig)
    p_pt, p_ok = lad._ladder_w4_plain(pub, ldig)
    err = compare("ladder", k_pt, p_pt, rr.to(torch.int32), a_ok=(k_ok, p_ok))
    finish_err = max(finish_err, compare_finish("flat", k_pt, rr))
    check_finish_edges(dev)
    nbytes = pub.numel() + ldig.numel() * 4 + 64 * 16 * 60 * 4 + (4 * 20 * 4 + 1) * b4
    kernels.append(("ladder", err, lambda: lad.ladder(pub, ldig),
                    lambda: lad._ladder_w4_plain(pub, ldig), b4, fe_ops("ladder", b4), nbytes))
    # the finish at the largest main-path shape (the window's 16k lanes),
    # on the buffer the fused kernel left, as the main path reads it
    fx, fy, fz = f_pt[:3]
    nbytes = (3 * 20 * 4 + 32 + 1) * b3
    kernels.append(("finish_encode_compare", finish_err,
                    lambda: tab.finish_encode_compare(fx, fy, fz, r3u),
                    lambda: tab._finish_encode_compare(fx.contiguous(), fy.contiguous(),
                                                       fz.contiguous(), r3), b3,
                    fe_ops("finish_encode_compare", b3), nbytes))

    kernels += hash_kernels(dev, txs, trees, sha512_msgs)

    report["stages"] = {
        "consensus": stage_times(dev, verifier, "entries", pubs2, commit),
        "fast_sync": stage_times(dev, verifier, "fused", pubs3, commits3),
        "flat": stage_times(dev, verifier, "ladder", pubs4, (msgs4, sigs4)),
    }
    log({"phase": "stages", **report["stages"]})
    # the card's busy share of one warm call of each phase: kernel time
    # from the profiler over the phase's unprofiled median wall time
    calls = {
        "consensus": (lambda: verifier.verify_commits(pubs2, commit), p2["warm_commit_s_median"]),
        "fast_sync": (lambda: verifier.verify_commits(pubs3, commits3), med3),
        "flat": (lambda: verifier.verify_batch(triples), med4),
    }
    report["device"] = {}
    for name, (fn, wall) in calls.items():
        d = device_time(fn)
        d["wall_s"] = wall
        d["busy_share"] = d["device_s"] / wall
        report["device"][name] = d
        log({"phase": "device", "call": name, **{k: v for k, v in d.items() if k != "top"}})
    # the flat call's torch prologue before the ladder kernel: the digit
    # packing only (decompression, B - A and inversion are in the kernel)
    pro = device_time(lambda: tab._digits_w4(ss.to(torch.int32), hh.to(torch.int32)))
    report["flat_launches"] = {
        "prologue_kernels": pro["device_kernels"],
        "prologue_device_s": pro["device_s"],
        "call_kernels": report["device"]["flat"]["device_kernels"],
        "eager_prologue_call_kernels": EAGER_PROLOGUE_FLAT_CALL_KERNELS,
    }
    log({"phase": "flat_launches", **report["flat_launches"]})
    hash_profile(dev, sync, hrep, txs, chunks)
    del chunks

    rows = []
    for name, err, kern, plain, lanes, ops, nbytes in kernels:
        kern()  # warm
        src, replaces = KERNEL_INFO[name]
        if name in PROFILED:
            ms, seen = kernel_ms(kern, PROFILED[name], args.reps)
            timing = {"ms_by": "profiler", "profiled_launches": seen}
        else:
            ms, timing = cuda_ms(kern, args.reps), {"ms_by": "events"}
        plain_ms = cuda_ms(plain, 1)
        bms, by = bound_ms(ops, nbytes, clock_hz, sms)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
            **timing,
            "lanes": lanes,
        })
        log({"phase": 1, **rows[-1]})
    report["kernels"] = rows
    # the finish at each path's shape, on its chain's output as it lies:
    # CUDA events around a call (the wrapper's host work before the launch
    # included, as in the kernels line) and the kernel's device time alone
    finish_calls = {
        "consensus": lambda: tab.finish_encode_compare(*e_pt[:3], r2u),
        "fast_sync": lambda: tab.finish_encode_compare(fx, fy, fz, r3u),
        "flat": lambda: tab.finish_encode_compare(*k_pt[:3], rr),
    }
    report["finish_ms"] = {name: cuda_ms(fn, args.reps) for name, fn in finish_calls.items()}
    log({"phase": "finish_ms", **report["finish_ms"]})
    report["finish_device_ms"] = {
        name: kernel_ms(fn, "finish_kernel", args.reps)[0] for name, fn in finish_calls.items()
    }
    log({"phase": "finish_device_ms", **report["finish_device_ms"]})
    report["sha512_wide"] = sha512_wide(args.seed, dev, clock_hz, sms, args.reps)
    log({"phase": "sha512_wide", **report["sha512_wide"]})
    report["profiler_lost_sessions"] = LOST_SESSIONS[0]
    log({"phase": "profiler", "lost_sessions": LOST_SESSIONS[0]})
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--validators", type=int, default=10000, help="consensus commit size")
    ap.add_argument("--sync-validators", type=int, default=1000, help="fast-sync set size")
    ap.add_argument("--window", type=int, default=16, help="fast-sync commits per call")
    ap.add_argument("--flat", type=int, default=4096, help="flat batch lanes")
    ap.add_argument("--reps", type=int, default=5, help="timed kernel runs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import tendermint_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2
    try:
        report = run(args)
    except Exception:
        traceback.print_exc()
        return 1
    out = pathlib.Path("chiprun_out")
    try:
        out.mkdir(exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    except OSError:
        pass
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(report["env"]["nvidia_smi"])
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in report["kernels"]]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
