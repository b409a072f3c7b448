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
   entries-chain kernel (`madd_chain_entries`);
3. fast-sync window: 16 stacked commits of a 1000-validator set — the
   fused kernel (`madd_chain_fused`);
4. flat batch: `verify_batch` on 4096 triples with distinct keys — the
   generic ladder kernel (`ladder`);
1. kernel vs plain: each kernel against its plain torch version on the
   card, on the inputs its phase gave it (the entries chain also at the
   flat batch's 4096 lanes), compared exactly on the canonical
   coordinates and the verdicts (everything is an integer: tolerance
   0); then a per-stage breakdown of one call of each phase, the
   card's kernel time in one call of each phase (torch.profiler), and
   each kernel and plain version timed with CUDA events.

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
MADDS_PER_FE_MUL = 400  # 20 x 20 schoolbook limb products
FE_MULS_PER_LANE = {
    "madd_chain_entries": 96 * 7,
    "madd_chain_fused": 128 * 7,
    "ladder": 253 * (8 + 7),
}
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


def counts() -> dict:
    from tendermint_tpu_torch.ops.ed25519_ladder import ladder
    from tendermint_tpu_torch.ops.ed25519_tables import fused_chain, sum_entries

    return {
        "madd_chain_entries": sum_entries.launches,
        "madd_chain_fused": fused_chain.launches,
        "ladder": ladder.launches,
    }


def reset_counts() -> None:
    from tendermint_tpu_torch.ops.ed25519_ladder import ladder
    from tendermint_tpu_torch.ops.ed25519_tables import fused_chain, sum_entries

    sum_entries.launches = fused_chain.launches = ladder.launches = 0


def canonical(point):
    """Canonical limbs of the four projective coordinates, stacked."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_kernel import fe_canon

    return torch.stack([fe_canon(c.contiguous()) for c in point])


def compare(name, kernel_out, plain_out, r) -> int:
    """Exact comparison of a kernel's output with its plain version:
    canonical X, Y, Z, T and the encode-and-compare verdicts. Returns
    the max absolute difference (0 when they agree)."""
    from tendermint_tpu_torch.ops.ed25519_tables import _finish_encode_compare

    ck, cp = canonical(kernel_out), canonical(plain_out)
    err = int((ck - cp).abs().max().item())
    vk = _finish_encode_compare(*kernel_out[:3], r)
    vp = _finish_encode_compare(*plain_out[:3], r)
    if err != 0 or not bool((vk == vp).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max_abs_err={err})")
    return err


def bound_ms(name: str, lanes: int, nbytes: int, clock_hz: float, sms: int) -> tuple[float, str]:
    ops = lanes * FE_MULS_PER_LANE[name] * MADDS_PER_FE_MUL
    t_ops = ops / (INT32_LANES_PER_SM_CLOCK * sms * clock_hz)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stage_times(dev, verifier, path: str, pubs, commits) -> dict:
    """Seconds of each stage of one call of a phase, the card
    synchronised after each: host prep, copy to the card, the torch
    prologue (selection / digits / ladder inputs), the kernel, the torch
    finish (batched inversion, encode, compare) with the copy back."""
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
        gtab, dig, a_ok = lad._build_inputs(pub, s, h)
        mark("prologue_s")
        x, y, z, _t = lad.ladder(gtab.contiguous(), dig)
        mark("kernel_s")
        (tab._finish_encode_compare(x, y, z, r.to(torch.int32)) & a_ok).cpu()
        mark("finish_s")
        return out
    tables, _ok = verifier.tables_for(tuple(pubs))
    s, h, r, _pre = tab.prepare_commit_lanes(pubs, commits)
    mark("host_prep_s")
    s, h, r = (torch.from_numpy(a).to(dev).to(torch.int32) for a in (s, h, r))
    mark("to_device_s")
    if path == "entries":
        ent = tab._select_entries(tables, s, h)
        mark("prologue_s")
        x, y, z, _t = tab.sum_entries(ent)
    else:
        dig = tab._digits_w4(s, h)
        mark("prologue_s")
        x, y, z, _t = tab.fused_chain(tables, dig)
    mark("kernel_s")
    tab._finish_encode_compare(x, y, z, r).cpu()
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
    if c2["madd_chain_entries"] == 0:
        raise AssertionError("consensus commit did not launch madd_chain_entries")
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
    if c3["madd_chain_fused"] == 0:
        raise AssertionError("fast-sync window did not launch madd_chain_fused")
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
    if c4["ladder"] == 0:
        raise AssertionError("flat batch did not launch ladder")
    launches["ladder"] = c4["ladder"]
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
    # entries chain at the consensus commit's shape
    s, h, r = lanes_to_dev(pubs2, commit)
    ent = tab._select_entries(tables2, s, h)  # (96, 60, B)
    b2 = ent.shape[2]
    err = compare("madd_chain_entries", tab.sum_entries(ent), tab._sum_entries_plain(ent), r)
    part = ent[:, :, : args.flat].contiguous()  # and at the flat batch's 4096 lanes
    err = max(err, compare("madd_chain_entries", tab.sum_entries(part),
                           tab._sum_entries_plain(part), r[: args.flat]))
    del part
    nbytes = ent.numel() * 4 + 4 * 20 * b2 * 4
    kernels.append(("madd_chain_entries", err, lambda: tab.sum_entries(ent),
                    lambda: tab._sum_entries_plain(ent), b2, nbytes))
    # fused chain at the fast-sync window's shape
    tables3, _ok3 = verifier.tables_for(tuple(pubs3))
    s, h, r3 = lanes_to_dev(pubs3, commits3)
    dig = tab._digits_w4(s, h).contiguous()
    b3 = dig.shape[0]
    err = compare("madd_chain_fused", tab.fused_chain(tables3, dig),
                  tab._fused_chain_plain(tables3, dig), r3)
    nbytes = tables3.numel() * 2 + 64 * 16 * 60 * 4 + dig.numel() * 4 + 4 * 20 * b3 * 4
    kernels.append(("madd_chain_fused", err, lambda: tab.fused_chain(tables3, dig),
                    lambda: tab._fused_chain_plain(tables3, dig), b3, nbytes))
    # ladder at the flat batch's shape (the bucket of 4096 lanes)
    pub, rr, ss, hh, _pre = prepare_batch(pubs4, msgs4, sigs4)
    pub, rr, ss, hh = (torch.from_numpy(a).to(dev) for a in (pub, rr, ss, hh))
    gtab, ldig, _a_ok = lad._build_inputs(pub, ss, hh)
    gtab = gtab.contiguous()
    b4 = ldig.shape[0]
    err = compare("ladder", lad.ladder(gtab, ldig), lad._ladder_plain(gtab, ldig),
                  rr.to(torch.int32))
    nbytes = gtab.numel() * 4 + ldig.numel() * 4 + 4 * 20 * b4 * 4
    kernels.append(("ladder", err, lambda: lad.ladder(gtab, ldig),
                    lambda: lad._ladder_plain(gtab, ldig), b4, nbytes))

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
