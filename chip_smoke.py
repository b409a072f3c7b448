#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ed25519 verify path once on the card.

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
   every phase ends in the `finish_encode_compare` kernel (invert,
   encode, compare with R);
1. kernel vs plain: each kernel against its plain torch version on the
   card, on the inputs its phase gave it (the entries chain also at
   4096 lanes and at 3 commits of the fast-sync set), compared exactly
   on the canonical affine coordinates (x, y), T * Z == X * Y, the
   verdicts and, for the ladder, a_ok; the finish on all three chains'
   outputs and on hand-made lanes (sign bit set and cleared, y >= p,
   the identity, Z = 0) (everything is an integer: tolerance 0); then
   a per-stage breakdown of one call of each phase, the card's kernel
   time in one call of each phase (torch.profiler) and the flat
   prologue's kernel count, and each kernel and plain version timed
   with CUDA events. Each kernel's bound is the larger of the limb
   products its function needs (100 a field multiply, 55 a squaring;
   FE_OPS_PER_LANE, and for the finish a batched inversion's count, not
   its kernel's per-lane chain) and the bytes it must move
   (madd_chain_entries: the distinct 32-byte table sectors its lanes
   touch).

Every phase plants a forged signature, an absent vote, an S >= L, an
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
    # multiplies a lane, then x/z and y/z; the kernel's own per-lane
    # chain (254 squarings, 11 multiplies) is more than the function needs
    "finish_encode_compare": (3 + 2, 0),
}
# field (multiplies, squarings) once a call: the batched inversion's one
# shared z^(p-2)
FE_OPS_PER_CALL = {"finish_encode_compare": (11, 254)}
# kernels a flat call ran when torch decompressed A, built B - A and
# inverted before the ladder (PERF.md, run F)
EAGER_PROLOGUE_FLAT_CALL_KERNELS = 33818
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
    # an XLA stage of the JAX package, not a Pallas kernel
    "finish_encode_compare": (
        "tendermint_tpu_torch/csrc/finish.cu",
        "tendermint_tpu/ops/ed25519_tables.py:895",
    ),
}


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

    return {
        "madd_chain_entries": sum_entries,
        "madd_chain_fused": fused_chain,
        "ladder": ladder,
        "finish_encode_compare": finish_encode_compare,
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
    verdicts, same as the plain version's), then on lanes with Z = 0: the
    tree's verdict is true for an all-zero R there, the kernel's false."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_tables import _finish_encode_compare, finish_encode_compare
    from tendermint_tpu_torch.testing import finish_edge_lanes

    x, y, z, r, want = (torch.from_numpy(a).to(dev) for a in finish_edge_lanes())
    got = finish_encode_compare(x, y, z, r)
    plain = _finish_encode_compare(x, y, z, r.to(torch.int32))
    if not (torch.equal(got, want) and torch.equal(plain, want)):
        raise AssertionError(f"finish on hand-made lanes: {got.tolist()} / plain {plain.tolist()}, want {want.tolist()}")
    zero = torch.zeros((2, 20), dtype=torch.int32, device=dev)
    y0 = zero.clone()
    y0[1, 0] = 1
    r0 = torch.zeros((2, 32), dtype=torch.uint8, device=dev)
    r0[1, 0] = 1
    if finish_encode_compare(zero, y0, zero, r0).any():
        raise AssertionError("finish: a lane with Z = 0 came out true")


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


def bound_ms(name: str, lanes: int, nbytes: int, clock_hz: float, sms: int) -> tuple[float, str]:
    ops = lanes * products(FE_OPS_PER_LANE[name]) + products(FE_OPS_PER_CALL.get(name, (0, 0)))
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


def device_time(fn) -> dict:
    """One call of `fn` under torch.profiler: the summed time of every
    kernel the card ran, how many ran, and the eight that took longest.
    `device_s` is None when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {
        "device_s": total_us / 1e6 if total_us else None,
        "device_kernels": sum(e.count for e in kernels),
        "top": [
            {"name": e.key[:90], "count": e.count, "ms": e.self_device_time_total / 1e3}
            for e in top
        ],
    }


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

    # -- phase 1: each kernel against its plain version, then timed ----------
    dev = verifier.device

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
                    lambda: tab._sum_entries_plain(tab._select_entries(tables2, s, h)), b2, nbytes))
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
                    lambda: tab._fused_chain_plain(tables3, dig), b3, nbytes))
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
                    lambda: lad._ladder_w4_plain(pub, ldig), b4, nbytes))
    # the finish at the largest main-path shape (the window's 16k lanes),
    # on the buffer the fused kernel left, as the main path reads it
    fx, fy, fz = f_pt[:3]
    nbytes = (3 * 20 * 4 + 32 + 1) * b3
    kernels.append(("finish_encode_compare", finish_err,
                    lambda: tab.finish_encode_compare(fx, fy, fz, r3u),
                    lambda: tab._finish_encode_compare(fx.contiguous(), fy.contiguous(),
                                                       fz.contiguous(), r3), b3, nbytes))

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
        d["busy_share"] = d["device_s"] / wall if d["device_s"] is not None else None
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

    rows = []
    for name, err, kern, plain, lanes, nbytes in kernels:
        kern()  # warm
        ms = cuda_ms(kern, args.reps)
        plain_ms = cuda_ms(plain, 1)
        bms, by = bound_ms(name, lanes, nbytes, clock_hz, sms)
        src, replaces = KERNEL_INFO[name]
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
            "lanes": lanes,
        })
        log({"phase": 1, **rows[-1]})
    report["kernels"] = rows
    # the finish at each path's shape, on its chain's output as it lies
    report["finish_ms"] = {
        "consensus": cuda_ms(lambda: tab.finish_encode_compare(*e_pt[:3], r2u), args.reps),
        "fast_sync": rows[-1]["ms"],
        "flat": cuda_ms(lambda: tab.finish_encode_compare(*k_pt[:3], rr), args.reps),
    }
    log({"phase": "finish_ms", **report["finish_ms"]})
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
