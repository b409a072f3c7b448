"""Hand-made inputs with known answers, shared by the port's tests and
`chip_smoke.py`; nothing on the verify path imports this module."""

from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch.ops.ed25519_kernel import P, SQRT_M1, _int_to_limbs, fe_canon, fe_mul, fe_to_bytes
from tendermint_tpu_torch.ops.ed25519_tables import _B_EXT, host_affine, host_scalar_mul


def finish_edge_lanes():
    """Hand-made inputs of the encode-and-compare finish, from Python
    ints: (x, y, z) each (n, 20) int32 canonical 13-bit limbs of
    projective coordinates (Z != 0), r (n, 32) uint8 and the verdict
    each lane must get. Lanes: a point of odd x and one of even x with
    their encodings (sign bit set, cleared) and with the sign bit
    flipped; the identity with its encoding, with the sign bit set and
    with y = 1 + p (non-canonical); the order-4 point (sqrt(-1), 0)
    with y = 0 and with y = p."""
    pts = [host_affine(host_scalar_mul(k, _B_EXT)) for k in range(2, 12)]
    odd = next(p for p in pts if p[0] & 1)
    even = next(p for p in pts if not p[0] & 1)

    def enc(y: int, sign: int) -> int:
        return y | sign << 255

    lanes = [
        (odd, enc(odd[1], 1), True),
        (even, enc(even[1], 0), True),
        (odd, enc(odd[1], 0), False),
        (even, enc(even[1], 1), False),
        ((0, 1), enc(1, 0), True),
        ((0, 1), enc(1, 1), False),
        ((0, 1), enc(1 + P, 0), False),
        ((SQRT_M1, 0), enc(0, SQRT_M1 & 1), True),
        ((SQRT_M1, 0), enc(P, SQRT_M1 & 1), False),
    ]
    xs, ys, zs, rs, want = [], [], [], [], []
    for i, ((x, y), r, ok) in enumerate(lanes):
        z = (7919 * (i + 3) ** 5 + 1) % P  # any Z != 0
        xs.append(_int_to_limbs(x * z % P))
        ys.append(_int_to_limbs(y * z % P))
        zs.append(_int_to_limbs(z))
        rs.append(np.frombuffer(r.to_bytes(32, "little"), dtype=np.uint8))
        want.append(ok)
    return np.stack(xs), np.stack(ys), np.stack(zs), np.stack(rs), np.array(want)


# the mixed batch's size and the lane whose Z is 0: three blocks of 32
# lanes, the zero in the middle one
MIXED_LANES = 70
MIXED_ZERO_LANE = 40


def finish_mixed_lanes():
    """A batch of the finish with one Z = 0 lane, from a fixed seed:
    the hand-made lanes of `finish_edge_lanes` first, then random
    projective points (a Z, b Z, Z) with their encodings (three of them
    forged), and lane MIXED_ZERO_LANE with X = Y = Z = 0 and R = 0.
    Returns x, y, z (MIXED_LANES, 20) int32, r (MIXED_LANES, 32) uint8
    and the verdict each lane gets once that Z is made 1 (true at that
    lane: (0, 0) encodes to 32 zero bytes); with the Z = 0 lane in the
    call every verdict is false."""
    ex, ey, ez, er, edge = finish_edge_lanes()
    rng = np.random.default_rng(23)
    m, n = len(edge), MIXED_LANES - len(edge)

    def rand_fe():
        vals = [int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1 for _ in range(n)]
        return torch.from_numpy(np.stack([_int_to_limbs(v) for v in vals]))

    a, b, z = rand_fe(), rand_fe(), rand_fe()
    r = fe_to_bytes(b)
    r[:, 31] |= (fe_canon(a)[:, 0] & 1) << 7
    xs = np.concatenate([ex, fe_mul(a, z).numpy()])
    ys = np.concatenate([ey, fe_mul(b, z).numpy()])
    zs = np.concatenate([ez, z.numpy()])
    rs = np.concatenate([er, r.numpy().astype(np.uint8)])
    want = np.concatenate([edge, np.ones(n, dtype=bool)])
    for lane in (m + 3, 50, 69):
        rs[lane, 7] ^= 0x10
        want[lane] = False
    k = MIXED_ZERO_LANE
    xs[k] = ys[k] = zs[k] = 0
    rs[k] = 0
    want[k] = True
    return xs, ys, zs, rs, want


def lockrank_report() -> str:
    """Drain the port's lock-rank sanitizer (`utils/lockrank.py`): "" when
    it recorded no violation since the last drain, else each violation's
    report with both threads' acquisition stacks. The port's test files
    call it after every test, as the JAX suite's guard drains the JAX
    package's sanitizer, so that a violation fails the test that
    provoked it."""
    from tendermint_tpu_torch.utils import lockrank

    return "\n".join(lockrank.render_violation(v) for v in lockrank.drain())


# The hand kernel each launch-ledger record's launch runs first, by the
# record's kind; every verify launch then ends in the finish.
LEDGER_KERNELS = {
    "verify": ("ladder",),
    "tables": ("madd_chain_entries", "madd_chain_fused"),
    "hash": ("sha256_masked", "ripemd160_masked"),
}
_LEDGER_FAMILY = {"verify": "verify", "tables": "tables", "hash": "hash", "leaf_hashes": "hash"}


def ledger_launches(records) -> dict:
    """The kernel launches a run's launch-ledger records account for, by
    family (`LEDGER_KERNELS`, plus `finish_encode_compare`): a record
    that reached a device (no `error`, backend not "host") launched its
    family's kernel once on each shard of its `mesh_width` (1 without a
    mesh). A `root_from_hashes` record launches the tree levels only:
    callers hold such calls out of the records they count."""
    out = dict.fromkeys((*LEDGER_KERNELS, "finish_encode_compare"), 0)
    for r in records:
        if r.get("error") or r.get("backend", "host") == "host":
            continue
        family = _LEDGER_FAMILY[r["kind"]]
        n = int(r.get("mesh_width", 1))
        out[family] += n
        if family != "hash":
            out["finish_encode_compare"] += n
    return out


def kernel_launches(counts: dict) -> dict:
    """The kernel wrappers' launch counts (`{wrapper name: launches}`)
    grouped as `ledger_launches` groups the records."""
    out = {family: sum(counts[n] for n in names) for family, names in LEDGER_KERNELS.items()}
    out["finish_encode_compare"] = counts["finish_encode_compare"]
    return out
