"""Hand-made inputs with known answers and the chain, net and node
fixtures, shared by the port's tests and `chip_smoke.py`; nothing on
the verify path imports this module. `tendermint_tpu_torch.testing`
re-exports every name of `__all__`. The bounded waits at the end
(`time_limit`, `first_line`, `join_all`) keep a port test that starts a
net, a node, a thread or a child process from waiting for good."""

from __future__ import annotations

import contextlib
import faulthandler
import signal
import sys
import threading
import time

import numpy as np
import torch

from tendermint_tpu_torch.ops.ed25519_kernel import P, SQRT_M1, _int_to_limbs, fe_canon, fe_mul, fe_to_bytes
from tendermint_tpu_torch.ops.ed25519_tables import _B_EXT, host_affine, host_scalar_mul

__all__ = [
    "finish_edge_lanes", "MIXED_LANES", "MIXED_ZERO_LANE", "finish_mixed_lanes", "lockrank_report",
    "LEDGER_KERNELS", "ledger_launches", "device_flat_rows", "kernel_launches", "TEST_CHAIN_ID",
    "det_priv_keys", "make_validators", "make_block_id", "signed_vote", "byzantine_signed_vote",
    "make_commit", "make_genesis", "ChainSim", "SignedChainSim", "chain_store", "serving_switch",
    "SyncingNode", "preloaded_reactor", "forge_newest_precommit", "StormValidator", "NetValidator",
    "start_net", "snapshot_server", "StateSyncingNode", "ReadNode", "time_limit",
    "time_limit_fixture", "own_default_stacks", "first_line", "join_all",
]


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


def device_flat_rows(records, lanes, min_batch: int, what: str = "run") -> dict:
    """Holds the flat calls among a run's launch-ledger records (kind
    `verify`) to the lanes the run sent them: `lanes` has one count a
    drained vote run or ingress window. Every lane of a run or window of
    `min_batch` lanes or more must be a row a device answered, unless the
    signature cache withheld it (`rows_cached`); the coalescer may merge
    runs, so rows are compared, not calls. Raises AssertionError on a
    shortfall, or on a flat record of `min_batch` rows or more that the
    host answered; returns the account."""
    flat = [r for r in records if r.get("kind") == "verify" and not r.get("error")]
    device = [int(r.get("rows", 0)) for r in flat if r.get("backend", "host") != "host"]
    host_big = [int(r.get("rows", 0)) for r in flat
                if r.get("backend", "host") == "host" and int(r.get("rows", 0)) >= min_batch]
    cached = sum(int(r.get("rows_cached", 0)) for r in flat)
    big = sum(n for n in lanes if n >= min_batch)
    if sum(device) < big - cached or host_big:
        raise AssertionError(
            f"{what}: the device answered {sum(device)} flat rows ({device}), the runs of {min_batch} "
            f"lanes or more sent {big} ({cached} from the cache); the host answered flat calls of {host_big}"
        )
    return {"device_flat_calls": len(device), "device_flat_rows": sum(device), "device_flat_sizes": device,
            "lanes_of_min_batch_or_more": big, "rows_cached": cached}


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


def byzantine_signed_vote(priv, index, height, round_, type_, block_id, chain_id=TEST_CHAIN_ID, timestamp=1000):
    """A vote signed around `priv`'s double-sign guard: the Byzantine
    validator of the tests (the reference's ByzantinePrivValidator)."""
    from tendermint_tpu_torch.types import Vote

    vote = Vote(validator_address=priv.address, validator_index=index, height=height, round=round_,
                timestamp=timestamp, type=type_, block_id=block_id)
    return vote.with_signature(priv._signer.sign(vote.sign_bytes(chain_id)))


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


class SignedChainSim(ChainSim):
    """`ChainSim` whose commits are signed directly with each validator's
    key, with no check of each vote as it is added: a `VoteSet` checks
    each vote alone, seconds a commit of 1,000 validators on the host.
    The chain's own `apply_block` still verifies every last commit on
    `verifier`."""

    def _commit_for(self, block, part_set):
        from tendermint_tpu_torch.types import VOTE_TYPE_PRECOMMIT, BlockID, Commit, Vote

        bid = BlockID(block.hash(), part_set.header)
        h = block.header.height
        ts = self.genesis.genesis_time + h * 1_000_000_000
        pre = []
        for idx, priv in enumerate(self._privs_in_valset_order()):
            v = Vote(priv.address, idx, h, 0, ts + idx, VOTE_TYPE_PRECOMMIT, bid)
            pre.append(v.with_signature(priv._signer.sign(v.sign_bytes(self.chain_id))))
        return Commit(block_id=bid, precommits=pre)


# -- fast-sync fixtures: a store-backed server, a fresh syncing node ------------


def chain_store(sim, db=None):
    """A `BlockStore` holding `sim`'s blocks, each saved with the commit
    signed for it (the seen commit), as a node that made the chain keeps
    them."""
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.db.kv import MemDB

    store = BlockStore(db if db is not None else MemDB())
    for block, commit in zip(sim.blocks, sim.commits):
        store.save_block(block, block.make_part_set(hasher=sim.hasher), commit)
    return store


def serving_switch(store, node_id: str, chain_id: str):
    """A started `Switch` whose `BlockchainReactor(fast_sync=False)` serves
    `store` to any peer that asks; it verifies and applies nothing, so it
    holds no state and no app."""
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    from tendermint_tpu_torch.p2p import NodeInfo, Switch

    sw = Switch(NodeInfo(node_id=node_id, moniker="server", chain_id=chain_id))
    sw.add_reactor("blockchain", BlockchainReactor(state=None, store=store, app_conn=None, fast_sync=False))
    sw.start()
    return sw


class SyncingNode:
    """A fresh node that fast-syncs: the genesis state on a `MemDB`, an
    empty `BlockStore`, `app_conn`, and a started `Switch` with
    `BlockchainReactor(fast_sync=True)` on `verifier`. `caught_up` is set
    when the reactor calls `on_caught_up`, at `caught_up_at`
    (`time.perf_counter()`)."""

    def __init__(self, genesis, node_id: str, app_conn, verifier, hasher=None):
        import threading

        from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
        from tendermint_tpu_torch.blockchain.store import BlockStore
        from tendermint_tpu_torch.db.kv import MemDB
        from tendermint_tpu_torch.p2p import NodeInfo, Switch
        from tendermint_tpu_torch.state import make_genesis_state

        self.state = make_genesis_state(MemDB(), genesis)
        self.state.save()
        self.store = BlockStore(MemDB())
        self.caught_up = threading.Event()
        self.caught_up_at = None
        self.reactor = BlockchainReactor(state=self.state, store=self.store, app_conn=app_conn, fast_sync=True,
                                         on_caught_up=self._on_caught_up, verifier=verifier, hasher=hasher)
        self.switch = Switch(NodeInfo(node_id=node_id, moniker="fresh", chain_id=genesis.chain_id))
        self.switch.add_reactor("blockchain", self.reactor)
        self.switch.start()

    def _on_caught_up(self, state) -> None:
        import time

        self.caught_up_at = time.perf_counter()
        self.state = state
        self.caught_up.set()

    def stop(self) -> None:
        self.switch.stop()


def preloaded_reactor(sim, app_conn, verifier, depth: int = 2):
    """A fresh fast-syncing reactor with `sim`'s whole chain already in
    its pool (the harness of the JAX package's `tests/test_fastsync.py`:
    drive `_try_sync` directly, no network, so the pipeline's windows
    and drains are deterministic). Returns (reactor, state, store)."""
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.db.kv import MemDB
    from tendermint_tpu_torch.state import make_genesis_state

    state = make_genesis_state(MemDB(), sim.genesis)
    state.save()
    store = BlockStore(MemDB())
    reactor = BlockchainReactor(state=state, store=store, app_conn=app_conn, fast_sync=True, verifier=verifier,
                                pipeline_depth=depth, hasher=sim.hasher)
    reactor.pool.set_peer_height("srv", len(sim.blocks))
    for h, b in enumerate(sim.blocks, start=1):
        reactor.pool._blocks[h] = (b, "srv")
    return reactor, state, store


def forge_newest_precommit(sim, index: int) -> None:
    """Flip one bit of precommit `index`'s signature in `sim`'s newest
    commit, the one its next block carries as the last commit: the next
    `advance` must then pass `commit_preverified=True`. The chain's
    linkage stays intact (the forged commit is inside the next block
    before that block is hashed), so a fast-syncing node finds the fault
    only in the window's verdict."""
    import dataclasses

    commit = sim.commits[-1]
    vote = commit.precommits[index]
    sig = vote.signature
    precommits = list(commit.precommits)
    precommits[index] = vote.with_signature(bytes([sig[0] ^ 0x01]) + sig[1:])
    sim.commits[-1] = dataclasses.replace(commit, precommits=precommits)


# -- consensus fixtures: a validator whose set the caller plays, a small net ----


class StormValidator:
    """One port `ConsensusState` as a validator of a set whose other
    validators the caller plays: the harness of the JAX package's
    `tests/test_consensus.py` vote storm and `tests/test_pol_safety.py`
    proposals, at any width. The node runs `KVStoreApp`, a port `Mempool`
    and `EvidencePool` and a `BlockStore(MemDB())` on `verifier`,
    `ConsensusConfig.test_config()` and `MockTicker` (only height starts
    fire: a round moves on messages alone). `seeds` maps each validator's
    address to its 32-byte key seed; `sign_many(pairs)` signs a list of
    (seed, message) pairs for the validators the caller plays (a
    height's votes of one type in one call), and the node signs with its own
    `PrivValidator`. Each drained vote run's length lands in `drains`
    and its lanes (the votes not self-signed) in `drain_lanes`, each
    finalized block in `commits` as (perf_counter time, block)."""

    def __init__(self, genesis, seeds, node_address, sign_many, verifier, hasher=None, wal_path=None):
        import queue
        import time

        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.blockchain.store import BlockStore
        from tendermint_tpu_torch.consensus import ConsensusConfig, ConsensusState, MockTicker
        from tendermint_tpu_torch.crypto import PrivKey
        from tendermint_tpu_torch.db.kv import MemDB
        from tendermint_tpu_torch.evidence import EvidencePool
        from tendermint_tpu_torch.mempool import Mempool
        from tendermint_tpu_torch.state import make_genesis_state
        from tendermint_tpu_torch.types import PrivValidator
        from tendermint_tpu_torch.types import events as ev

        self.chain_id = genesis.chain_id
        self.seeds, self.sign_many, self.hasher, self.address = seeds, sign_many, hasher, node_address
        state = make_genesis_state(MemDB(), genesis)
        state.save()
        self.app = KVStoreApp()
        conns = local_client_creator(self.app)()
        self.store = BlockStore(MemDB())
        self.mempool = Mempool(conns.mempool, verifier=verifier)
        self.evidence = EvidencePool(params=state.consensus_params.evidence, verifier=verifier,
                                     chain_id=self.chain_id)
        self.cs = ConsensusState(
            config=ConsensusConfig.test_config(), state=state, app_conn=conns.consensus,
            block_store=self.store, mempool=self.mempool,
            priv_validator=PrivValidator(PrivKey(seeds[node_address])), wal_path=wal_path,
            ticker=MockTicker(), verifier=verifier, hasher=hasher, evidence_pool=self.evidence,
        )
        self.commits: "queue.Queue" = queue.Queue()
        self.committed: list[int] = []

        def on_block(data):
            self.committed.append(data.block.header.height)
            self.commits.put((time.perf_counter(), data.block))

        self.cs.event_switch.add_listener("storm", ev.EVENT_NEW_BLOCK, on_block)
        self.drains: list[int] = []
        self.drain_lanes: list[int] = []
        submit = self.cs._submit_vote_batch

        def drained(records):
            self.drains.append(len(records))
            self.drain_lanes.append(sum(1 for rec in records if not rec.self_signed))
            return submit(records)

        self.cs._submit_vote_batch = drained

    def _wait(self, pred, what: str, timeout: float) -> None:
        import time

        deadline = time.time() + timeout
        while not pred():
            if self.cs.fatal_error is not None:
                raise AssertionError(f"consensus halted waiting for {what}: {self.cs.fatal_error!r}")
            if time.time() > deadline:
                raise AssertionError(f"timed out waiting for {what}")
            time.sleep(0.005)

    def propose(self, height: int, txs=(), timeout: float = 60.0):
        """Round 0 of `height`, once the node has applied `height - 1`:
        (block_id, block, proposal, parts). When the node proposes, waits
        for its complete block (proposal and parts None); else builds the
        proposer's block on the node's applied state, with the node's seen
        commit of the height below as the last commit (what a proposer that
        gathered the same precommits carries), and signs its proposal,
        unsent."""
        import time

        from tendermint_tpu_torch.types import Block, BlockID, Commit, PartSetHeader, Proposal, Txs

        cs = self.cs
        self._wait(lambda: cs.height == height and (height == 1 or height - 1 in self.committed),
                   f"height {height}", timeout)
        proposer = cs.validators.proposer.address
        if proposer == self.address:
            def complete():
                rs = cs.get_round_state()
                return rs.height == height and rs.proposal_block is not None

            self._wait(complete, f"the node's proposal at height {height}", timeout)
            rs = cs.get_round_state()
            return BlockID(rs.proposal_block.hash(), rs.proposal_block_parts.header), rs.proposal_block, None, None
        st = cs.state
        block = Block.make_block(
            height=height, chain_id=self.chain_id, txs=Txs(list(txs)),
            last_commit=Commit.empty() if height == 1 else self.store.load_seen_commit(height - 1),
            last_block_id=st.last_block_id, time=time.time_ns(), validators_hash=st.validators.hash(),
            app_hash=st.app_hash, hasher=self.hasher,
        )
        parts = block.make_part_set(hasher=self.hasher)
        prop = Proposal(height=height, round=0, block_parts_header=parts.header, pol_round=-1,
                        pol_block_id=BlockID(b"", PartSetHeader.zero()), timestamp=time.time_ns())
        prop = prop.with_signature(self.sign_many([(self.seeds[proposer], prop.sign_bytes(self.chain_id))])[0])
        return BlockID(block.hash(), parts.header), block, prop, parts

    def votes(self, height: int, type_: int, block_id, timestamp: int) -> list:
        """Every validator's round-0 vote but the node's, signed, in the
        set's order."""
        from tendermint_tpu_torch.types import Vote

        votes = [Vote(val.address, idx, height, 0, timestamp, type_, block_id)
                 for idx, val in enumerate(self.cs.validators.validators) if val.address != self.address]
        sigs = self.sign_many([(self.seeds[v.validator_address], v.sign_bytes(self.chain_id)) for v in votes])
        return [v.with_signature(sig) for v, sig in zip(votes, sigs)]

    def play(self, proposal, parts, prevotes, precommits, timeout: float = 120.0) -> float:
        """Queue the proposal and its parts (when the caller proposes) and
        `prevotes` as one backlog, then, once the node has precommitted
        (its own vote queues behind the backlog, as a node's own vote
        queues behind its peers' in a storm), `precommits` as one backlog;
        returns the perf_counter time of the first message."""
        import time

        t0 = time.perf_counter()
        height = prevotes[0].height
        if proposal is not None:
            self.cs.set_proposal(proposal, peer_id="storm")
            for i in range(parts.total):
                self.cs.add_proposal_block_part(proposal.height, 0, parts.get_part(i), peer_id="storm")
        for v in prevotes:
            self.cs.add_vote(v, peer_id=f"val{v.validator_index}")

        def precommitted():
            votes = self.cs.votes
            pcs = votes.precommits(0) if votes is not None and self.cs.height == height else None
            return pcs is not None and pcs.get_by_address(self.address) is not None

        self._wait(precommitted, f"the node's precommit at height {height}", timeout)
        for v in precommits:
            self.cs.add_vote(v, peer_id=f"val{v.validator_index}")
        return t0

    def wait_commit(self, height: int, timeout: float = 120.0):
        """(perf_counter time, block) of the node's commit of `height`,
        once its apply has joined."""
        while True:
            self._wait(lambda: not self.commits.empty(), f"the commit of height {height}", timeout)
            t, block = self.commits.get()
            if block.header.height == height:
                return t, block


class NetValidator:
    """One validator of an in-process net: a port `ConsensusState` with
    its `ConsensusReactor`, `MempoolReactor` and `EvidenceReactor` on a
    port `Switch` (the node's wiring, `node/node.py` of the JAX package),
    `KVStoreApp`, a `BlockStore(MemDB())`, the real `TimeoutTicker` and
    `ConsensusConfig.test_config()`; `verifier` and `hasher` are shared
    by the consensus, the mempool and the evidence pool."""

    def __init__(self, index: int, genesis, privs, verifier, hasher=None, config=None):
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.blockchain.store import BlockStore
        from tendermint_tpu_torch.consensus import ConsensusConfig, ConsensusState, TimeoutTicker
        from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
        from tendermint_tpu_torch.db.kv import MemDB
        from tendermint_tpu_torch.evidence import EvidencePool, EvidenceReactor
        from tendermint_tpu_torch.mempool import Mempool
        from tendermint_tpu_torch.mempool.reactor import MempoolReactor
        from tendermint_tpu_torch.p2p import NodeInfo, Switch
        from tendermint_tpu_torch.state import make_genesis_state

        self.index = index
        state = make_genesis_state(MemDB(), genesis)
        state.save()
        self.app = KVStoreApp()
        conns = local_client_creator(self.app)()
        self.store = BlockStore(MemDB())
        self.mempool = Mempool(conns.mempool, verifier=verifier)
        self.evidence = EvidencePool(params=state.consensus_params.evidence, verifier=verifier,
                                     chain_id=genesis.chain_id)
        self.cs = ConsensusState(
            config=config or ConsensusConfig.test_config(), state=state, app_conn=conns.consensus,
            block_store=self.store, mempool=self.mempool, priv_validator=privs[index],
            ticker=TimeoutTicker(), verifier=verifier, hasher=hasher, evidence_pool=self.evidence,
        )
        self.switch = Switch(NodeInfo(node_id=f"node{index}", moniker=f"val{index}", chain_id=genesis.chain_id))
        self.switch.add_reactor("consensus", ConsensusReactor(self.cs))
        self.switch.add_reactor("mempool", MempoolReactor(self.mempool))
        self.switch.add_reactor("evidence", EvidenceReactor(self.evidence))

    @property
    def height(self) -> int:
        return self.cs.height

    def block_txs(self, top: int) -> list[bytes]:
        return [bytes(tx) for h in range(1, top + 1) for tx in self.store.load_block(h).data.txs]

    def stop(self) -> None:
        self.switch.stop()
        self.mempool.close()
        self.evidence.close()


def start_net(nodes) -> None:
    """Start every node's switch, then link each pair in process."""
    from tendermint_tpu_torch.p2p import connect_switches

    for node in nodes:
        node.switch.start()
    for i in range(len(nodes)):
        for j in range(i + 1, len(nodes)):
            connect_switches(nodes[i].switch, nodes[j].switch)


# -- read-path fixtures: snapshot serving, a state-syncing node, the RPC node --


def snapshot_server(store, state, snapshot_store, node_id: str, chain_id: str, hasher=None,
                    snapshot_interval: int = 0):
    """A started `Switch` that serves a snapshot as a node does, wired as
    the JAX `node/node.py` wires it: a serving `StateSyncReactor` over
    `snapshot_store` (its commits answered from `store` and `state`'s
    historical validator sets) and a `BlockchainReactor(fast_sync=False)`
    over `store` for the fast-sync tail. Returns (switch, statesync
    reactor)."""
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    from tendermint_tpu_torch.p2p import NodeInfo, Switch
    from tendermint_tpu_torch.statesync import StateSyncReactor

    ss = StateSyncReactor(snapshot_store=snapshot_store, block_store=store, state=state, hasher=hasher,
                          snapshot_interval=snapshot_interval)
    sw = Switch(NodeInfo(node_id=node_id, moniker="server", chain_id=chain_id))
    sw.add_reactor("blockchain", BlockchainReactor(state=None, store=store, app_conn=None, fast_sync=False))
    sw.add_reactor("statesync", ss)
    sw.start()
    return sw, ss


class StateSyncingNode:
    """A fresh node that state-syncs a snapshot and then fast-syncs the
    tail: the genesis state on a `MemDB`, an empty `BlockStore`,
    `KVStoreApp` (its `restore_state` restores the app), and a started
    `Switch` with `StateSyncReactor(sync=True)` and a deferred
    `BlockchainReactor(fast_sync=True)`, wired as the JAX `node/node.py`
    wires them: the reactor's `TrustAnchor` starts from the genesis set
    with `trust` (`TrustOptions`), and `on_synced` adopts the restored
    state and calls `begin_fast_sync`. `verifier` and `hasher` go to the
    anchor, both reactors and the fast-sync tail. `synced` is set when
    the state sync ends (at `synced_at`), `caught_up` when the tail does
    (at `caught_up_at`, `time.perf_counter()`); `reactor_kwargs` go to
    the `StateSyncReactor`."""

    def __init__(self, genesis, node_id: str, verifier, hasher=None, trust=None, **reactor_kwargs):
        import threading

        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
        from tendermint_tpu_torch.blockchain.store import BlockStore
        from tendermint_tpu_torch.db.kv import MemDB
        from tendermint_tpu_torch.p2p import NodeInfo, Switch
        from tendermint_tpu_torch.state import make_genesis_state
        from tendermint_tpu_torch.statesync import SnapshotStore, StateSyncReactor, TrustAnchor

        self.state_db = MemDB()
        self.state = make_genesis_state(self.state_db, genesis)
        self.state.save()
        self.store = BlockStore(MemDB())
        self.app = KVStoreApp()
        self.conns = local_client_creator(self.app)()
        self.synced = threading.Event()
        self.caught_up = threading.Event()
        self.synced_at = self.caught_up_at = None
        self.anchor = TrustAnchor(chain_id=genesis.chain_id, base_validators=genesis.validator_set(),
                                  options=trust, verifier=verifier)
        self.blockchain = BlockchainReactor(state=self.state, store=self.store, app_conn=self.conns.consensus,
                                            fast_sync=True, on_caught_up=self._on_caught_up, verifier=verifier,
                                            hasher=hasher, deferred=True)
        self.statesync = StateSyncReactor(
            snapshot_store=SnapshotStore(MemDB(), hasher=hasher), block_store=self.store, state=self.state,
            sync=True, trust_anchor=self.anchor, state_db=self.state_db, app_restore_fn=self.app.restore_state,
            app_snapshot_fn=self.app.snapshot_state, on_synced=self._on_synced, hasher=hasher, **reactor_kwargs,
        )
        self.switch = Switch(NodeInfo(node_id=node_id, moniker="fresh", chain_id=genesis.chain_id))
        self.switch.add_reactor("blockchain", self.blockchain)
        self.switch.add_reactor("statesync", self.statesync)
        self.switch.start()

    def _on_synced(self, state) -> None:
        import time

        self.synced_at = time.perf_counter()
        if state is not None:
            self.state = state
            self.statesync.state = state
        self.synced.set()
        self.blockchain.begin_fast_sync(state)

    def _on_caught_up(self, state) -> None:
        import time

        self.caught_up_at = time.perf_counter()
        self.state = state
        self.caught_up.set()

    def stop(self) -> None:
        self.switch.stop()


class ReadNode:
    """The node `rpc.core.make_routes` and `telemetry.health.build_health`
    read, assembled from the port's parts without a whole `Node`:
    `genesis`, `block_store`, `current_state` (the state object given,
    read live), the app's connections (`app_conns`), an `EventSwitch`,
    and the `tx_indexer`, `lightclient_reactor` and `hasher` the caller
    has; no switch, mempool, consensus, priv validator or sync reactor
    until the caller sets one. Its config is a plain namespace with the
    two fields the routes read, `rpc.unsafe` (off) and `base.moniker`."""

    def __init__(self, genesis, state, block_store, app, node_id: str, tx_indexer=None, lightclient_reactor=None,
                 hasher=None, moniker: str = "readnode"):
        from types import SimpleNamespace

        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.types.events import EventSwitch

        self.config = SimpleNamespace(rpc=SimpleNamespace(unsafe=False), base=SimpleNamespace(moniker=moniker))
        self.genesis = genesis
        self.state = state
        self.block_store = block_store
        self.app = app
        self.app_conns = local_client_creator(app)()
        self.node_id = node_id
        self.tx_indexer = tx_indexer
        self.lightclient_reactor = lightclient_reactor
        self.hasher = hasher
        self.event_switch = EventSwitch()
        self.switch = self.mempool = self.consensus = self.consensus_reactor = self.priv_validator = None
        self.blockchain_reactor = self.statesync_reactor = None

    @property
    def current_state(self):
        return self.state

    def dial_seed(self, addr: str) -> None:
        """The `dial_seeds` route's worker: one dial, a failure logged (the
        JAX node's)."""
        import logging

        from tendermint_tpu_torch.p2p.tcp import dial

        try:
            dial(self.switch, addr)
        except Exception:
            logging.getLogger(__name__).warning("dial %s failed", addr)


# -- bounded waits for the port's tests ----------------------------------------


@contextlib.contextmanager
def time_limit(seconds: float):
    """Run the block under a limit of `seconds` of wall time: past it,
    every thread's stack goes to stderr and the block raises
    `TimeoutError`, so the test fails and its `finally` blocks stop its
    nodes and children, where a wait that never ends would hold its
    pytest worker for good. The limit is SIGALRM's, which reaches only
    the main thread: off the main thread the block runs unbounded."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(_signum, _frame):
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise TimeoutError(f"past the test's limit of {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def time_limit_fixture(seconds: float):
    """The body of an autouse pytest fixture that runs each test of a file
    under `time_limit(seconds)`:
    `_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))`."""

    def limit():
        with time_limit(seconds):
            yield

    return limit


@contextlib.contextmanager
def own_default_stacks():
    """Run the block with process-wide verifier stacks of its own
    (`services.verifier.default_verifier`): the stacks it makes are closed
    after it and the earlier ones come back. A test whose nodes verify on
    `default_verifier(device)` then neither meets a stack an earlier test
    of its process changed or closed, nor leaves its own behind."""
    from tendermint_tpu_torch.services import verifier

    saved, verifier._DEFAULTS = verifier._DEFAULTS, {}
    try:
        yield
    finally:
        made, verifier._DEFAULTS = verifier._DEFAULTS, saved
        for stack in made.values():
            stack.close()


def first_line(proc, timeout: float, log=None):
    """The first line of the child `proc`'s stdout, read on a thread of
    its own for at most `timeout` seconds. A child that prints no line in
    that time is killed, and AssertionError carries the end of its
    stderr (`log`: the path its stderr goes to)."""
    got: list = []
    reader = threading.Thread(target=lambda: got.append(proc.stdout.readline()), name="first-line", daemon=True)
    reader.start()
    reader.join(timeout)
    if got:
        return got[0]
    proc.kill()
    proc.wait(timeout=30)
    tail = ""
    if log is not None:
        with open(log, "rb") as f:
            tail = f.read()[-3000:].decode(errors="replace")
    raise AssertionError(f"the child printed no line in {timeout} s (exit code {proc.returncode}):\n{tail}")


def join_all(threads, timeout: float) -> None:
    """Join every thread within `timeout` seconds in all; AssertionError
    names those still alive then."""
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"threads still running after {timeout} s: {alive}"
