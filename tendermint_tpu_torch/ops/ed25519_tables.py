"""Table-driven batched ed25519 verification: the steady-state fast path.

Counterpart of `tendermint_tpu/ops/ed25519_tables.py`. Consensus,
fast-sync and the light client verify commits signed by a known
validator set that changes rarely, so:

* **[h]A — cached per-validator window tables.** A per-validator w=4
  table (64 windows x 16 entries of multiples of -A, affine precomp form
  ypx|ymx|t2d, canonical 13-bit limbs) is built on the card once per
  validator set: (64, 16, 60, N) int16, the JAX package's own layout.
* **[S]B — fixed-base combs.** The entries path uses a w=8 table of B
  (32 windows x 256 entries: 32 mixed adds); the fused path a w=4 table
  (64 windows x 16 entries) so its 128 steps are all alike.
* **No R decompression.** The computed point is encoded and compared
  byte for byte with sig[:32].

Three kernels (`csrc/madd_chain.cu`, `csrc/finish.cu`):

* `sum_entries` — 96 mixed adds per lane, each entry selected inside
  the kernel from the w=8 comb and the validator tables, ten threads a
  lane. Single commits and small stacks take it. Its plain version is
  the JAX package's composition: the gather `_select_entries`, then
  `_sum_entries_plain`.
* `fused_chain` — per lane 64 comb steps and 64 validator-table steps,
  two threads a lane, each block staging its validator tile's table
  slab once per window. Stacked windows (K >= FUSED_MIN_STACK commits)
  take it.
* `finish_encode_compare` — the verdict of every verify path (these
  two and the flat ladder): each lane inverts its Z, encodes and
  compares with R. Its plain version `_finish_encode_compare` inverts
  with one batched tree, as the JAX package does.

Each wrapper launches its kernel for CUDA tensors and runs the plain
torch version of the same function for CPU tensors.
"""

from __future__ import annotations

import functools
import hashlib
import threading

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.ops._build import check, kernel_lib, stream_ptr
from tendermint_tpu_torch.ops.ed25519_kernel import (
    BX,
    BY,
    D,
    D2,
    L,
    NLIMBS,
    P,
    SQRT_M1,
    _D2_L,
    _const,
    _int_to_limbs,
    fe_canon,
    fe_carry,
    fe_invert,
    fe_is_zero,
    fe_mul,
    fe_sub,
    fe_to_bytes,
    identity_point,
    pt_add,
    pt_decompress,
    pt_double,
    pt_neg,
)

A_WINDOW = 4  # per-validator tables: 64 windows x 16 entries
A_NWIN = 64
B_NWIN = 32  # fixed-base table: 32 windows x 256 entries (w=8, entries path)
SB_NWIN = 64  # fixed-base table: 64 windows x 16 entries (w=4, fused path)
NSTEPS = B_NWIN + A_NWIN  # 96 mixed adds per signature (entries path)
NSTEPS_W4 = 2 * SB_NWIN  # 128: steps 0..63 = S comb, 64..127 = h comb
A_START = SB_NWIN
# stacks of at least this many commits take the fused kernel (the JAX
# package's threshold); single commits and small stacks the entries chain
FUSED_MIN_STACK = 8
# keys per table-build pass: a pass holds 1024 extended points per key
BUILD_CHUNK = 16384


# -- host EC over Python ints (comb tables, small builds, tests) --------------


def _hadd(p, q):
    """Extended twisted-Edwards add (a=-1), Python ints."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


_H_IDENT = (0, 1, 1, 0)
_B_EXT = (BX, BY, 1, BX * BY % P)


def host_scalar_mul(k: int, p) -> tuple[int, int, int, int]:
    """[k]P by double-and-add over Python ints (tests / cross-checks)."""
    acc = _H_IDENT
    while k:
        if k & 1:
            acc = _hadd(acc, p)
        p = _hadd(p, p)
        k >>= 1
    return acc


def host_affine(p) -> tuple[int, int]:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    return (x * zi % P, y * zi % P)


def _precomp_limbs(x: int, y: int) -> np.ndarray:
    """Affine point -> (3, 20) int32 precomp form (y+x, y-x, 2d*x*y)."""
    return np.stack(
        [
            _int_to_limbs((y + x) % P),
            _int_to_limbs((y - x) % P),
            _int_to_limbs(2 * D * x % P * y % P),
        ]
    )


def _host_decompress(pub: bytes) -> tuple[int, int] | None:
    """RFC 8032 point decoding over Python ints (host build path)."""
    enc = int.from_bytes(pub, "little")
    sign = enc >> 255
    y = enc & ((1 << 255) - 1)
    if y >= P:
        return None
    y2 = y * y % P
    u = (y2 - 1) % P
    v = (D * y2 + 1) % P
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    if v * x * x % P != u:
        if v * x * x % P == (P - u) % P:
            x = x * SQRT_M1 % P
        else:
            return None
    if x == 0 and sign:
        return None
    if (x & 1) != sign:
        x = P - x
    return x, y


def _affine_rows(entries) -> list[tuple[int, int]]:
    """Affine (x, y) of extended points via one Montgomery batched
    inversion (one modexp for the whole list)."""
    prefix = [1]
    for pt in entries:
        prefix.append(prefix[-1] * pt[2] % P)
    inv = pow(prefix[-1], P - 2, P)
    out: list[tuple[int, int]] = [(0, 0)] * len(entries)
    for i in reversed(range(len(entries))):
        zi = inv * prefix[i] % P
        inv = inv * entries[i][2] % P
        out[i] = (entries[i][0] * zi % P, entries[i][1] * zi % P)
    return out


def host_build_key_tables(pubkeys) -> tuple[np.ndarray, np.ndarray]:
    """Python-int table build: same layout as build_key_tables
    ((64, 16, 60, N) int16 window/digit/limb/validator tables of -A
    multiples, (N,) ok) without the device. For small N (incremental
    builds of a few new keys, tests).

    Invalid pubkey encodings get identity-entry columns and ok=False.
    An identity column degrades the check to encode([S]B) == R, which an
    attacker CAN satisfy — callers must AND key_ok into every verdict."""
    n = len(pubkeys)
    ok = np.zeros(n, dtype=bool)
    tbl = np.zeros((A_NWIN, 16, 3 * NLIMBS, n), dtype=np.int16)
    ident_entry = _precomp_limbs(0, 1).reshape(-1)
    for col, pk in enumerate(pubkeys):
        aff = _host_decompress(bytes(pk)) if len(pk) == 32 else None
        if aff is None:
            tbl[:, :, :, col] = ident_entry[None, None, :]
            continue
        ok[col] = True
        x, y = aff
        nx = (P - x) % P  # tables hold multiples of -A
        base = (nx, y, 1, nx * y % P)
        rows: list[tuple[int, int]] = []  # (window, digit) per entry
        entries: list[tuple[int, int, int, int]] = []
        for w in range(A_NWIN):
            e = _H_IDENT
            for d in range(16):
                if d == 0:
                    tbl[w, 0, :, col] = ident_entry
                else:
                    rows.append((w, d))
                    entries.append(e)
                e = _hadd(e, base)
            for _ in range(A_WINDOW):
                base = _hadd(base, base)
        for (w, d), (ex, ey) in zip(rows, _affine_rows(entries)):
            tbl[w, d, :, col] = _precomp_limbs(ex, ey).reshape(-1)
    return tbl, ok


def _comb_table(nwin: int, width: int) -> np.ndarray:
    """(nwin * 2^width, 60) int32: entry [w * 2^width + j] holds
    j * 2^(width * w) * B in affine precomp form."""
    entries = []
    base = _B_EXT
    for _ in range(nwin):
        e = _H_IDENT
        for _j in range(1 << width):
            entries.append(e)
            e = _hadd(e, base)
        for _ in range(width):
            base = _hadd(base, base)
    out = np.zeros((len(entries), 3 * NLIMBS), dtype=np.int32)
    for i, (x, y) in enumerate(_affine_rows(entries)):
        out[i] = _precomp_limbs(x, y).reshape(-1)
    return out


_SB_TABLE: np.ndarray | None = None
_B_TABLE: np.ndarray | None = None


def sb_table_w4() -> np.ndarray:
    """w=4 fixed-base comb: (64, 16, 60) int32; [w, j] holds
    j * 2^(4w) * B in affine precomp form (ypx|ymx|t2d). Used by the
    fused path, whose 128 steps are then all alike."""
    global _SB_TABLE
    if _SB_TABLE is None:
        _SB_TABLE = _comb_table(SB_NWIN, 4).reshape(SB_NWIN, 16, 3 * NLIMBS)
    return _SB_TABLE


def b_table() -> np.ndarray:
    """Fixed-base table: (B_NWIN*256, 3, 20) int32; entry [w*256+j] holds
    j * 2^(8w) * B in affine precomp form. Built lazily once per process."""
    global _B_TABLE
    if _B_TABLE is None:
        _B_TABLE = _comb_table(B_NWIN, 8).reshape(-1, 3, NLIMBS)
    return _B_TABLE


# -- device primitives --------------------------------------------------------


def pt_madd(acc, entry):
    """Mixed add: extended acc + affine precomp entry (ypx, ymx, t2d).

    madd-2008-hwcd-3 with a=-1 and Z2=1: 7 muls. Entry limbs are
    canonical (< 2^13), acc limbs loose — both satisfy fe_mul's bound.
    """
    x1, y1, z1, t1 = acc
    ypx, ymx, t2d = entry
    a = fe_mul(fe_sub(y1, x1), ymx)
    b = fe_mul(fe_carry(y1 + x1), ypx)
    c = fe_mul(t1, t2d)
    d = fe_carry(z1 + z1)
    e = fe_sub(b, a)
    f = fe_sub(d, c)
    g = fe_carry(d + c)
    h = fe_carry(b + a)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


def fe_batch_invert(z):
    """Invert every row of z (M, 20) via a log-depth product tree:
    ~3 muls per element + ONE fe_invert total. Non-power-of-two M is
    padded with ones (a fixed point of inversion) so the tree halves
    evenly. Zero inputs are the caller's responsibility (Z of a valid
    point is never 0)."""
    m = z.shape[0]
    padded = 1
    while padded < m:
        padded *= 2
    if padded != m:
        ones = torch.zeros((padded - m, NLIMBS), dtype=z.dtype, device=z.device)
        ones[:, 0] = 1
        z = torch.cat([z, ones], dim=0)
    levels = []
    cur = z
    while cur.shape[0] > 1:
        levels.append(cur)
        cur = fe_mul(cur[0::2], cur[1::2])
    inv = fe_invert(cur)
    for lev in reversed(levels):
        inv_left = fe_mul(inv, lev[1::2])
        inv_right = fe_mul(inv, lev[0::2])
        inv = torch.stack([inv_left, inv_right], dim=1).reshape(lev.shape)
    return inv[:m]


# -- table build (device) -----------------------------------------------------


def _build_tables_chunk(pub: torch.Tensor):
    """(M, 32) uint8 pubkeys on the device -> ((64, 16, 60, M) int16
    tables, (M,) bool ok). Counterpart of `_build_tables_kernel` +
    `_to_fused_layout`: entry (w, d) of column m holds
    d * 2^(4w) * (-A_m) in affine precomp form, canonical limbs.

    The 64 window bases (-A doubled 4w times) come first, then the 15
    additions that fill a window run on all 64 windows at once: each
    entry sees the same sequence of field operations as in the JAX
    build, in 256 + 15 sequential point operations instead of 64 x 19.
    Columns of invalid encodings hold identity entries, as in
    `host_build_key_tables`.
    """
    m = pub.shape[0]
    a_pt, ok = pt_decompress(pub)
    base = pt_neg(a_pt)  # tables hold multiples of -A
    bases = []
    for w in range(A_NWIN):
        bases.append(base)
        if w + 1 < A_NWIN:
            for _ in range(A_WINDOW):
                base = pt_double(base)
    wb = tuple(torch.stack([b[c] for b in bases]) for c in range(4))  # (64, M, 20)
    e = identity_point((A_NWIN, m), pub.device)
    entries = [e]
    for _ in range(15):
        e = pt_add(e, wb)
        entries.append(e)
    ex, ey, ez = (
        torch.stack([en[c] for en in entries], dim=1).reshape(-1, NLIMBS)
        for c in range(3)
    )  # (64 * 16 * M, 20), (window, digit, validator) order
    del entries, e
    zinv = fe_batch_invert(fe_carry(ez))
    del ez
    ax = fe_mul(ex, zinv)
    ay = fe_mul(ey, zinv)
    del ex, ey, zinv
    ypx = fe_canon(fe_carry(ay + ax))
    ymx = fe_canon(fe_sub(ay, ax))
    t2d = fe_canon(fe_mul(fe_mul(ax, ay), _const(_D2_L, pub.device)))
    tbl = torch.stack([ypx, ymx, t2d], dim=-2).reshape(A_NWIN, 16, m, 3 * NLIMBS)
    tbl = tbl.permute(0, 1, 3, 2).to(torch.int16)
    # invalid encodings get identity-entry columns, as in the host build
    ident = torch.as_tensor(_precomp_limbs(0, 1).reshape(-1), dtype=torch.int16)
    tbl = torch.where(ok, tbl, ident.to(pub.device)[:, None])
    return tbl.contiguous(), ok


def build_key_tables(pub_bytes, device=None):
    """Build per-validator window tables on the device, BUILD_CHUNK keys
    at a time to bound peak memory.

    pub_bytes: (N, 32) uint8 (numpy or tensor). Returns (tables
    (64, 16, 60, N) int16 on the device — window, digit, limb,
    validator — and ok (N,) bool numpy)."""
    dev = resolve_device(device)
    pub = torch.tensor(np.asarray(pub_bytes, dtype=np.uint8), device=dev)
    n = pub.shape[0]
    tbls, oks = [], []
    for lo in range(0, n, BUILD_CHUNK):
        t, ok = _build_tables_chunk(pub[lo : lo + BUILD_CHUNK])
        tbls.append(t)
        oks.append(ok.cpu().numpy())
    tables = tbls[0] if len(tbls) == 1 else torch.cat(tbls, dim=3)
    return tables, np.concatenate(oks)


def tables_from_jax(tables_np, ok_np, device=None):
    """Carry the JAX package's tables across: `build_key_tables` or
    `host_build_key_tables` output as numpy ((64, 16, 60, N) int16,
    (N,) bool) -> the port's (tables on the device, ok numpy). The port
    keeps the same layout, so this checks and copies."""
    t = np.asarray(tables_np)
    ok = np.asarray(ok_np)
    if t.ndim != 4 or t.shape[:3] != (A_NWIN, 16, 3 * NLIMBS):
        raise ValueError(f"tables must be (64, 16, 60, N), got {t.shape}")
    if t.dtype != np.int16:
        raise ValueError(f"tables must be int16, got {t.dtype}")
    if ok.shape != (t.shape[3],) or ok.dtype != np.bool_:
        raise ValueError(f"ok must be ({t.shape[3]},) bool, got {ok.shape} {ok.dtype}")
    if t.size and (t.min() < 0 or t.max() >= 1 << 13):
        raise ValueError("table limbs must be canonical 13-bit values")
    dev = resolve_device(device)
    return torch.from_numpy(np.ascontiguousarray(t)).to(dev), ok.copy()


# -- verification: the entries chain -----------------------------------------


def _h_nibbles(h):
    """(B, 32) int32 bytes -> (B, 64) int32 nibbles, low nibble first."""
    return torch.stack([h & 0xF, (h >> 4) & 0xF], dim=-1).reshape(h.shape[0], 64)


def _select_entries(a_tables, s, h):
    """Operand selection as a plain gather -> (NSTEPS, 60, B) int32.

    s, h: (B, 32) int32 bytes. Steps 0..31 take the w=8 fixed-base entry
    chosen by byte w of S; steps 32..95 take table entry
    [w][nibble w of h][:, b mod N] — lane b verifies against validator
    b mod N, so one validator set verifies K stacked commits with
    B = K*N lanes. Lane-minor (the JAX package's is (NSTEPS, B, 60)).
    The CPU path and the plain version only: the `madd_chain_entries`
    kernel selects the same entries itself."""
    bsz = s.shape[0]
    n_vals = a_tables.shape[3]
    dev = s.device
    width = 3 * NLIMBS
    ent = torch.empty((NSTEPS, width, bsz), dtype=torch.int32, device=dev)
    # one index per (window, lane), broadcast over the limbs: a gather
    # along the entry axis, the lane axis read as it lies
    btab = _const(b_table(), dev).view(B_NWIN, 256, width, 1).expand(-1, -1, -1, bsz)
    idx = s.T.long()[:, None, None, :].expand(-1, 1, width, -1)
    torch.gather(btab, 1, idx, out=ent[:B_NWIN].view(B_NWIN, 1, width, bsz))
    dig = _h_nibbles(h).T.long()[:, None, None, :]  # (64, 1, 1, B)
    for lo in range(0, bsz, n_vals):  # commit by commit: lane b reads column b mod N
        idx = dig[..., lo : lo + n_vals].expand(-1, 1, width, -1)
        ent[B_NWIN:, :, lo : lo + n_vals] = torch.gather(a_tables, 1, idx)[:, 0]
    return ent


def _sum_entries_plain(ent):
    """With `_select_entries`, the plain version of the
    `madd_chain_entries` kernel: NSTEPS mixed adds from the identity;
    ent (NSTEPS, 60, B) int32."""
    acc = identity_point((ent.shape[2],), ent.device)
    for e in ent:
        e = e.T  # (B, 60)
        acc = pt_madd(acc, (e[:, :20], e[:, 20:40], e[:, 40:]))
    return acc


def _check_cuda(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _coords(out):
    """(4, 20, B) kernel output -> (x, y, z, t), each (B, 20)."""
    return tuple(out[c].T for c in range(4))


def _check_whole_commits(a_tables, bsz):
    """Lane b takes validator b mod N: B must be a positive multiple of
    N, on the CPU as on the card."""
    n_vals = a_tables.shape[3] if a_tables.dim() == 4 else -1
    if n_vals <= 0 or bsz <= 0 or bsz % n_vals:
        raise ValueError(f"B={bsz} lanes must be a positive multiple of N={n_vals}")
    return n_vals


def sum_entries(a_tables, s, h):
    """a_tables (64, 16, 60, N) int16, s and h (B, 32) int32 bytes ->
    extended acc (x, y, z, t), each (B, 20) int32: 96 mixed adds of the
    entries `_select_entries` names. Lane b takes validator b mod N.
    CUDA tensors launch `madd_chain_entries`, which selects the entries
    itself; CPU tensors run `_sum_entries_plain(_select_entries(...))`."""
    bsz = s.shape[0]
    n_vals = _check_whole_commits(a_tables, bsz)
    if s.device.type == "cpu":
        return _sum_entries_plain(_select_entries(a_tables, s, h))
    _check_cuda("a_tables", a_tables, torch.int16, (A_NWIN, 16, 3 * NLIMBS, n_vals))
    _check_cuda("s", s, torch.int32, (bsz, 32))
    _check_cuda("h", h, torch.int32, (bsz, 32))
    if a_tables.device != s.device or h.device != s.device:
        raise ValueError("a_tables, s and h must be on the same device")
    dev = s.device
    btab = _const(b_table(), dev)
    out = torch.empty((4, NLIMBS, bsz), dtype=torch.int32, device=dev)
    lib = kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.madd_chain_entries(
            a_tables.data_ptr(), btab.data_ptr(), s.data_ptr(), h.data_ptr(),
            out.data_ptr(), bsz, n_vals, stream_ptr(dev),
        )
    check(rc, "madd_chain_entries")
    sum_entries.launches += 1
    return _coords(out)


sum_entries.launches = 0


# -- verification: fused select + accumulate ----------------------------------


def _digits_w4(s, h):
    """(B, 32) int32 byte arrays -> (B, 128) int32 nibble-per-step:
    64 nibbles of S, then 64 of h, low nibble first."""
    return torch.cat([_h_nibbles(s), _h_nibbles(h)], dim=1)


def _fused_chain_plain(a_tables, digits):
    """Plain version of the `madd_chain_fused` kernel: 128 mixed adds,
    steps 0..63 from the w=4 fixed-base comb, steps 64..127 from the
    validator tables (column b mod N)."""
    bsz = digits.shape[0]
    dev = digits.device
    sb = _const(sb_table_w4(), dev)
    col = torch.arange(bsz, device=dev) % a_tables.shape[3]
    dig = digits.long()
    acc = identity_point((bsz,), dev)
    for step in range(NSTEPS_W4):
        if step < A_START:
            e = sb[step, dig[:, step]]
        else:
            e = a_tables[step - A_START, dig[:, step], :, col].to(torch.int32)
        acc = pt_madd(acc, (e[:, :20], e[:, 20:40], e[:, 40:]))
    return acc


def fused_chain(a_tables, digits):
    """a_tables (64, 16, 60, N) int16, digits (B, 128) int32 -> extended
    acc (x, y, z, t), each (B, 20) int32. CUDA tensors launch
    `madd_chain_fused`; CPU tensors run `_fused_chain_plain`. Lane b
    takes validator b mod N, and B must be whole commits (a multiple of
    N) on either device."""
    bsz = digits.shape[0]
    n_vals = _check_whole_commits(a_tables, bsz)
    if digits.device.type == "cpu":
        return _fused_chain_plain(a_tables, digits)
    _check_cuda("a_tables", a_tables, torch.int16, (A_NWIN, 16, 3 * NLIMBS, n_vals))
    _check_cuda("digits", digits, torch.int32, (bsz, NSTEPS_W4))
    if a_tables.device != digits.device:
        raise ValueError("a_tables and digits must be on the same device")
    if a_tables.data_ptr() % 4:
        raise ValueError("a_tables: the kernel copies 4-byte words; expected a 4-byte aligned tensor")
    dig_t = digits.T.contiguous()  # (128, B): lanes adjacent
    sb = _const(sb_table_w4(), digits.device)
    out = torch.empty((4, NLIMBS, bsz), dtype=torch.int32, device=digits.device)
    lib = kernel_lib()
    with torch.cuda.device(digits.device):
        rc = lib.madd_chain_fused(
            a_tables.data_ptr(),
            sb.data_ptr(),
            dig_t.data_ptr(),
            out.data_ptr(),
            bsz,
            n_vals,
            stream_ptr(digits.device),
        )
    check(rc, "madd_chain_fused")
    fused_chain.launches += 1
    return _coords(out)


fused_chain.launches = 0


def verify_tables_kernel(a_tables, s_bytes, h_bytes, r_bytes, impl="auto"):
    """Batched verify against cached tables.

    a_tables: (64, 16, 60, N) int16 from build_key_tables.
    s_bytes:  (B, 32) uint8, S little-endian (host-checked < L).
    h_bytes:  (B, 32) uint8, SHA512(R||A||M) mod L little-endian.
    r_bytes:  (B, 32) uint8, the signature's R encoding (sig[:32]).

    Lane b verifies against validator b mod N — one commit is B == N
    lanes in validator order; fast-sync stacks K commits of the same
    set as B = K*N. Returns (B,) bool: encode([S]B + [h](-A)) == r_bytes.

    impl: "auto" sends stacks of K >= FUSED_MIN_STACK commits to the
    fused chain and smaller ones to the entries chain; "fused" and
    "entries" force one of them.
    """
    s = s_bytes.to(torch.int32)
    h = h_bytes.to(torch.int32)
    bsz = s.shape[0]
    n_vals = _check_whole_commits(a_tables, bsz)
    if impl == "auto":
        impl = "fused" if bsz // n_vals >= FUSED_MIN_STACK else "entries"
    if impl == "fused":
        x, y, z, _t = fused_chain(a_tables, _digits_w4(s, h))
    elif impl == "entries":
        x, y, z, _t = sum_entries(a_tables, s, h)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return finish_encode_compare(x, y, z, r_bytes)


def _finish_encode_compare(x, y, z, r):
    """Plain version of the `finish_encode_compare` kernel: affine-normalize
    via one tree inversion, encode y, compare to R (int32 bytes). A batch
    with a Z = 0 lane is false on every lane (the tree inverts every lane
    to 0 there, and would pass a lane whose R is 32 zero bytes)."""
    zinv = fe_batch_invert(fe_carry(z))
    x_aff = fe_canon(fe_mul(x, zinv))
    y_bytes = fe_to_bytes(fe_mul(y, zinv))
    parity = x_aff[..., 0] & 1
    sign = (r[..., 31] >> 7) & 1
    r_clean = r.clone()
    r_clean[..., 31] &= 0x7F
    ok = torch.all(y_bytes == r_clean, dim=-1) & (parity == sign)
    return ok & ~fe_is_zero(z).any()


# lanes (and threads) of a block of the finish kernel: a power of two
FINISH_MIN_LANES = 32
FINISH_MAX_LANES = 256


def finish_lanes_per_block(bsz: int, sms: int) -> int:
    """Lanes a block of the `finish_encode_compare` kernel takes for a
    call of `bsz` lanes on a card of `sms` SMs: the largest power of two
    in [32, 256] that still gives every SM a block (each block runs one
    inversion chain, so the chains run side by side), else 32."""
    lanes = FINISH_MAX_LANES
    while lanes > FINISH_MIN_LANES and -(-bsz // lanes) < sms:
        lanes //= 2
    return lanes


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# one 64-bit word of device memory a (device, stream) for the finish
# kernel: its blocks count themselves and their "saw a zero Z" bits
# there, and its last block zeroes it again, so the calls of one stream
# (in order) reuse it and calls on two streams never share one
_FINISH_SCRATCH: dict = {}
_FINISH_SCRATCH_LOCK = threading.Lock()


def _finish_scratch(dev, stream: int) -> torch.Tensor:
    with _FINISH_SCRATCH_LOCK:
        word = _FINISH_SCRATCH.get((dev.index, stream))
        if word is None:
            word = _FINISH_SCRATCH[(dev.index, stream)] = torch.zeros((1,), dtype=torch.int64, device=dev)
        return word


def finish_encode_compare(x, y, z, r):
    """x, y, z (B, 20) int32 extended coordinates in the chains' boundary
    form, r (B, 32) uint8 or int32 bytes of R -> (B,) bool:
    encode(x/z, y/z) == r. CUDA tensors launch the `finish_encode_compare`
    kernel (one batched inversion a block of `finish_lanes_per_block`
    lanes); CPU tensors run `_finish_encode_compare`. A call with a lane
    whose z is 0 is false on every lane, on either device. x, y, z may be
    contiguous or the transposed rows of a chain's (4, 20, B) output,
    alike."""
    if z.device.type == "cpu":
        return _finish_encode_compare(x, y, z, r.to(torch.int32))
    bsz = z.shape[0]
    for name, t in (("x", x), ("y", y), ("z", z)):
        if t.device != z.device:
            raise ValueError(f"{name}: expected a tensor on {z.device}, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected torch.int32, got {t.dtype}")
        if tuple(t.shape) != (bsz, NLIMBS):
            raise ValueError(f"{name}: expected shape {(bsz, NLIMBS)}, got {tuple(t.shape)}")
        if not (t.is_contiguous() or t.T.is_contiguous()) or t.stride() != z.stride():
            raise ValueError(f"{name}: expected z's layout, contiguous or a transposed row")
    if r.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"r: expected torch.uint8 or torch.int32, got {r.dtype}")
    _check_cuda("r", r, r.dtype, (bsz, 32))
    if r.device != z.device:
        raise ValueError("r must be on the device of x, y, z")
    dev = z.device
    ok = torch.empty((bsz,), dtype=torch.bool, device=dev)
    if bsz == 0:
        return ok
    lane_stride, limb_stride = z.stride()
    lib = kernel_lib()
    with torch.cuda.device(dev):
        stream = stream_ptr(dev)
        rc = lib.finish_encode_compare(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), lane_stride, limb_stride,
            r.data_ptr(), r.element_size(), ok.data_ptr(), bsz,
            finish_lanes_per_block(bsz, _sm_count(dev.index)),
            _finish_scratch(dev, stream).data_ptr(), stream,
        )
    check(rc, "finish_encode_compare")
    finish_encode_compare.launches += 1
    return ok


finish_encode_compare.launches = 0


# -- host-side lane prep ------------------------------------------------------


def prepare_commit_lanes(pubkeys, commits):
    """Host prep for K stacked commits over one N-validator set.

    pubkeys: N 32-byte pubkey encodings in validator order.
    commits: K pairs (msgs, sigs) — each a length-N sequence aligned to
    validator index, with None marking absent votes.

    Returns (s, h, r) uint8 arrays of shape (K*N, 32) and a (K*N,) bool
    precheck mask (False for absent lanes and host-detected malformed
    signatures: wrong length or non-canonical S >= L, the same strict-S
    rule as `ed25519_kernel.prepare_batch`). Lane k*N+i aligns with
    `verify_tables_kernel`'s b-mod-N column mapping.
    """
    n = len(pubkeys)
    k = len(commits)
    s = np.zeros((k * n, 32), dtype=np.uint8)
    h = np.zeros((k * n, 32), dtype=np.uint8)
    r = np.zeros((k * n, 32), dtype=np.uint8)
    precheck = np.zeros(k * n, dtype=bool)
    # one bytes-join + frombuffer per commit instead of per-lane array
    # writes, hashlib only on present lanes
    zero64 = b"\x00" * 64
    from_bytes = int.from_bytes
    sha512 = hashlib.sha512
    for ci, (msgs, sigs) in enumerate(commits):
        if len(msgs) != n or len(sigs) != n:
            raise ValueError(f"commit {ci}: expected {n} lanes")
        lanes = precheck[ci * n : (ci + 1) * n]
        hrows = []
        sig_blob = []
        for i in range(n):
            msg, sig = msgs[i], sigs[i]
            if (
                msg is None
                or sig is None
                or len(sig) != 64
                or len(pubkeys[i]) != 32
                or from_bytes(sig[32:], "little") >= L
            ):
                sig_blob.append(zero64)
                continue
            lanes[i] = True
            sig_blob.append(sig)
            hh = sha512(sig[:32] + pubkeys[i] + msg).digest()
            hrows.append((i, (from_bytes(hh, "little") % L).to_bytes(32, "little")))
        sig_arr = np.frombuffer(b"".join(sig_blob), dtype=np.uint8).reshape(n, 64)
        r[ci * n : (ci + 1) * n] = sig_arr[:, :32]
        s[ci * n : (ci + 1) * n] = sig_arr[:, 32:]
        if hrows:
            idx, blobs = zip(*hrows)
            h[ci * n + np.asarray(idx, dtype=np.intp)] = np.frombuffer(
                b"".join(blobs), dtype=np.uint8
            ).reshape(len(blobs), 32)
    return s, h, r, precheck
