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


# -- the domain types' fixtures (the port's counterpart of tests/helpers.py) --

TEST_CHAIN_ID = "test-chain"


def det_priv_keys(n: int):
    """n deterministic keys, seeds 1..n little-endian."""
    from tendermint_tpu_torch.crypto import PrivKey

    return [PrivKey(i.to_bytes(32, "little")) for i in range(1, n + 1)]


def make_validators(n: int, power: int = 10):
    """(ValidatorSet, priv validators in the set's order): n deterministic
    validators of equal power."""
    from tendermint_tpu_torch.types import PrivValidator, Validator, ValidatorSet

    privs = [PrivValidator(k) for k in det_priv_keys(n)]
    vs = ValidatorSet([Validator(p.address, p.pub_key, power) for p in privs])
    by_addr = {p.address: p for p in privs}
    return vs, [by_addr[v.address] for v in vs.validators]


def make_block_id(seed: bytes = b"blk"):
    import hashlib

    from tendermint_tpu_torch.types import BlockID, PartSetHeader

    h = hashlib.sha256(seed).digest()
    return BlockID(hash=h, parts_header=PartSetHeader(total=1, hash=h[:20]))


def signed_vote(priv, index, height, round_, type_, block_id, chain_id=TEST_CHAIN_ID, timestamp=None):
    """A vote signed through `priv`'s double-sign guard."""
    import time

    from tendermint_tpu_torch.types import Vote

    vote = Vote(validator_address=priv.address, validator_index=index, height=height, round=round_,
                timestamp=timestamp if timestamp is not None else time.time_ns(), type=type_,
                block_id=block_id)
    return priv.sign_vote(chain_id, vote)


def make_commit(val_set, privs, height, round_, block_id, verifier, chain_id=TEST_CHAIN_ID):
    """A commit of every validator's precommit, made through a `VoteSet`
    whose signature checks run on `verifier` (a port type given no
    verifier would take the card's stack)."""
    from tendermint_tpu_torch.types import VOTE_TYPE_PRECOMMIT, VoteSet

    votes = VoteSet(chain_id, height, round_, VOTE_TYPE_PRECOMMIT, val_set)
    for i, priv in enumerate(privs):
        votes.add_vote(signed_vote(priv, i, height, round_, VOTE_TYPE_PRECOMMIT, block_id, chain_id),
                       verifier=verifier)
    return votes.make_commit()


# -- the chain's fixtures (the port's counterpart of tests/helpers.py's) ------


def make_genesis(n_vals: int = 4, power: int = 10, chain_id: str = TEST_CHAIN_ID):
    """GenesisDoc + priv validators in the set's order."""
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    vs, privs = make_validators(n_vals, power)
    gen = GenesisDoc(
        chain_id=chain_id,
        genesis_time=1_700_000_000_000_000_000,
        validators=[GenesisValidator(pub_key=v.pub_key, power=v.voting_power) for v in vs.validators],
    )
    return gen, privs


class ChainSim:
    """Drive a real State + app through heights with real commits: the
    make-block -> sign-precommits -> apply_block loop of the port's
    chain. `verifier` checks each precommit as the commit is made and is
    passed on to `apply_block` with `hasher`; `verifier=None` is the
    port's `default_verifier()`, the card's stack. `genesis` is a
    (GenesisDoc, privs in the set's order) pair to start from in place of
    `make_genesis(n_vals)`."""

    def __init__(self, n_vals: int = 4, app=None, db=None, chain_id: str = TEST_CHAIN_ID, hasher=None,
                 verifier=None, genesis=None):
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.db.kv import MemDB
        from tendermint_tpu_torch.state import make_genesis_state

        self.chain_id = chain_id
        self.hasher = hasher
        self.verifier = verifier
        self.db = db if db is not None else MemDB()
        self.genesis, self.privs = genesis if genesis is not None else make_genesis(n_vals, chain_id=chain_id)
        self.state = make_genesis_state(self.db, self.genesis)
        self.state.save()  # node startup persists genesis state (validators@1)
        self.app = app if app is not None else KVStoreApp()
        self.conns = local_client_creator(self.app)()
        self.blocks = []
        self.commits = []

    def _commit_for(self, block, part_set):
        from tendermint_tpu_torch.types import BlockID

        block_id = BlockID(block.hash(), part_set.header)
        return make_commit(self.state.validators, self._privs_in_valset_order(), block.header.height, 0,
                           block_id, self.verifier, self.chain_id)

    def _privs_in_valset_order(self):
        by_addr = {p.address: p for p in self.privs}
        return [by_addr[v.address] for v in self.state.validators.validators]

    def make_next_block(self, txs=None, evidence=None):
        from tendermint_tpu_torch.types import Block, Commit, Txs

        height = self.state.last_block_height + 1
        last_commit = self.commits[-1] if self.commits else Commit.empty()
        block = Block.make_block(
            height=height,
            chain_id=self.chain_id,
            txs=Txs(txs or []),
            last_commit=last_commit,
            last_block_id=self.state.last_block_id,
            time=self.genesis.genesis_time + height * 1_000_000_000,
            validators_hash=self.state.validators.hash(),
            app_hash=self.state.app_hash,
            hasher=self.hasher,
            evidence=evidence,
        )
        return block, block.make_part_set(hasher=self.hasher)

    def advance(self, txs=None, **apply_kwargs):
        """Build, commit-sign, and apply one block; returns the block."""
        from tendermint_tpu_torch.state import apply_block

        block, part_set = self.make_next_block(txs)
        commit = self._commit_for(block, part_set)
        apply_kwargs.setdefault("hasher", self.hasher)
        apply_kwargs.setdefault("verifier", self.verifier)
        apply_block(self.state, block, part_set.header, self.conns.consensus, **apply_kwargs)
        self.blocks.append(block)
        self.commits.append(commit)
        return block
