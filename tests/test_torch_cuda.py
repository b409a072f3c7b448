"""Hand kernels against their plain torch versions, on the CUDA card.

Every test here needs a card and skips without one (the kernels have no
CPU mode; their plain versions are held against JAX in the CPU tests).
Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Outputs are integers, so kernel and plain version must agree exactly on
the canonical coordinates (affine x, y for the two kernels that add in
another order than their plain versions) and on the verdicts. The
machine with the card has no jax: run this file with `--noconftest`.
The last two tests drive the mesh (`parallel/mesh.py`) on the card: four
shards (one a card where four are visible) against the one-card
verifier, and a shard fault re-meshed mid-call.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519_ref
from tendermint_tpu_torch.ops import ed25519_kernel as T
from tendermint_tpu_torch.ops import ed25519_ladder as TL
from tendermint_tpu_torch.ops import ed25519_tables as TT
from tendermint_tpu_torch.testing import MIXED_ZERO_LANE, finish_edge_lanes, finish_mixed_lanes

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def signed():
    rng = np.random.default_rng(51)
    seeds = [rng.bytes(32) for _ in range(16)]
    pubs = [ed25519_ref.public_from_seed(s) for s in seeds]
    msgs = [[rng.bytes(64) for _ in seeds] for _ in range(8)]
    sigs = [[ed25519_ref.sign(s, m) for s, m in zip(seeds, row)] for row in msgs]
    sigs[0][3] = bytes([sigs[0][3][0] ^ 1]) + sigs[0][3][1:]
    return pubs, list(zip(msgs, sigs))


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(T.fe_canon(g.contiguous()), T.fe_canon(w.contiguous()))


def _affine(point):
    x, y, z, t = (c.contiguous() for c in point)
    zinv = TT.fe_batch_invert(T.fe_carry(z))
    assert bool(T.fe_eq(T.fe_mul(t, z), T.fe_mul(x, y)).all())  # T * Z == X * Y
    return torch.stack([T.fe_canon(T.fe_mul(x, zinv)), T.fe_canon(T.fe_mul(y, zinv))])


def _same_affine(got, want):
    assert torch.equal(_affine(got), _affine(want))


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    uniq = [ed25519_ref.public_from_seed(rng.bytes(32)) for _ in range(min(n, 64))]
    return np.frombuffer(b"".join(uniq[i % len(uniq)] for i in range(n)), np.uint8).reshape(n, 32).copy()


def _nibbles(lanes, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 16, (lanes, TT.NSTEPS_W4), dtype=np.int32)).to(dev)


def _lanes(pubs, commits, dev):
    s, h, r, _pre = TT.prepare_commit_lanes(pubs, commits)
    return tuple(torch.from_numpy(a).to(dev).int() for a in (s, h, r))


def test_madd_chain_entries_matches_plain(dev, signed):
    pubs, commits = signed
    tables, _ok = TT.build_key_tables(np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 32), device=dev)
    s, h, r = _lanes(pubs, commits[:1], dev)
    before = TT.sum_entries.launches
    got = TT.sum_entries(tables, s, h)
    assert TT.sum_entries.launches == before + 1
    _same(got, TT._sum_entries_plain(TT._select_entries(tables, s, h)))
    verdict = TT.finish_encode_compare(*got[:3], r).cpu().numpy()
    assert not verdict[3] and verdict.sum() == len(pubs) - 1


@pytest.mark.parametrize("n", [1000, 13])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_madd_chain_entries_shapes(dev, n, k):
    """Selection in the kernel against the gather, for a ragged block of
    lanes and every stack the entries chain takes (K < 8)."""
    tables, _ok = TT.build_key_tables(_keys(n, 56), device=dev)
    rng = np.random.default_rng(57 + k)
    s, h = (torch.from_numpy(rng.integers(0, 256, (n * k, 32), dtype=np.int32)).to(dev) for _ in range(2))
    got = TT.sum_entries(tables, s, h)
    _same(got, TT._sum_entries_plain(TT._select_entries(tables, s, h)))


def test_madd_chain_fused_matches_plain(dev, signed):
    pubs, commits = signed
    tables, _ok = TT.build_key_tables(np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 32), device=dev)
    s, h, r = _lanes(pubs, commits, dev)
    dig = TT._digits_w4(s, h).contiguous()
    before = TT.fused_chain.launches
    got = TT.fused_chain(tables, dig)
    assert TT.fused_chain.launches == before + 1
    _same_affine(got, TT._fused_chain_plain(tables, dig))
    verdict = TT.finish_encode_compare(*got[:3], r).cpu().numpy()
    assert not verdict[3] and verdict.sum() == verdict.size - 1


@pytest.mark.parametrize("n", [1000, 13])
@pytest.mark.parametrize("k", [1, 8, 16])
def test_madd_chain_fused_shapes(dev, n, k):
    """A ragged validator tile (13 = 8 + 5) and every commit grouping."""
    tables, _ok = TT.build_key_tables(_keys(n, 52), device=dev)
    dig = _nibbles(n * k, 53 + k, dev)
    got = TT.fused_chain(tables, dig)
    _same_affine(got, TT._fused_chain_plain(tables, dig))


def test_ladder_matches_plain(dev, signed):
    pubs, commits = signed
    msgs, sigs = commits[0]
    pub, r, s, h, _pre = T.prepare_batch(pubs, msgs, sigs)
    pub, r, s, h = (torch.from_numpy(a).to(dev) for a in (pub, r, s, h))
    dig = TT._digits_w4(s.int(), h.int())
    before = TL.ladder.launches
    got, ok = TL.ladder(pub, dig)
    assert TL.ladder.launches == before + 1
    want, want_ok = TL._ladder_w4_plain(pub, dig)
    _same_affine(got, want)
    assert torch.equal(ok, want_ok) and bool(ok.all())
    gtab, odig, _ok = TL._build_inputs(pub, s, h)  # the JAX-mirroring oracle
    _same_affine(got, TL._ladder_plain(gtab.contiguous(), odig))
    verdict = TT.finish_encode_compare(*got[:3], r).cpu().numpy()
    assert not verdict[3] and verdict.sum() == len(pubs) - 1


@pytest.mark.parametrize("lanes", [1, 31, 512, 4096])
def test_ladder_shapes(dev, lanes):
    """Any lane count (three lanes a warp, twelve a block), with keys that
    do not decode (y >= p, x = 0 with the sign bit) and small-order keys."""
    pub = _keys(lanes, 54)
    if lanes > 8:
        pub[3] = 0xFF
        pub[3, 31] = 0x7F
        pub[4] = 0
        pub[4, 0] = 1
        pub[5] = 0
        pub[6] = 0
        pub[6, 0] = 2
        pub[7] = 0
        pub[7, 0] = 1
        pub[7, 31] = 0x80
    pub_t = torch.from_numpy(pub).to(dev)
    dig = _nibbles(lanes, 55, dev)
    got, ok = TL.ladder(pub_t, dig)
    want, want_ok = TL._ladder_w4_plain(pub_t, dig)
    _same_affine(got, want)
    assert torch.equal(ok, want_ok)
    assert torch.equal(ok, T.pt_decompress(pub_t)[1])


def _encodings(point):
    """R of each lane's affine point, as the plain finish computes it."""
    x, y, z, _t = (c.contiguous() for c in point)
    zinv = TT.fe_batch_invert(T.fe_carry(z))
    r = T.fe_to_bytes(T.fe_mul(y, zinv))
    r[:, 31] |= (T.fe_canon(T.fe_mul(x, zinv))[:, 0] & 1) << 7
    return r.to(torch.uint8)


@pytest.mark.parametrize("lanes", [1, 3, 1000, 4096, 10000, 16000, 40000])
def test_finish_encode_compare_matches_plain(dev, lanes):
    """Verdicts bit for bit against the tree-inversion plain version, on
    ladder outputs with every third R forged and the hand-made lanes in
    front, read as the (4, 20, B) buffer lies and contiguous, R as uint8
    and int32."""
    pub = torch.from_numpy(_keys(lanes, 58)).to(dev)
    point, _ok = TL.ladder(pub, _nibbles(lanes, 59, dev))
    r = _encodings(point)
    r[::3, 5] ^= 1
    ex, ey, ez, er, want = finish_edge_lanes()
    m = min(lanes, len(want))
    for c, e in zip(point[:3] + (r,), (ex, ey, ez, er)):
        c[:m] = torch.from_numpy(e[:m]).to(dev)
    plain = TT._finish_encode_compare(*(c.contiguous() for c in point[:3]), r.int())
    for xyz in (point[:3], tuple(c.contiguous() for c in point[:3])):
        before = TT.finish_encode_compare.launches
        got = TT.finish_encode_compare(*xyz, r)
        assert TT.finish_encode_compare.launches == before + 1
        assert torch.equal(got, plain)
        assert torch.equal(TT.finish_encode_compare(*xyz, r.int()), plain)
    np.testing.assert_array_equal(got[:m].cpu().numpy(), want[:m])
    if lanes > m:
        assert not bool(got[m::3].any()) and bool(got[m + 1 :: 3].all()) and bool(got[m + 2 :: 3].all())


def test_finish_encode_compare_is_false_where_z_is_zero(dev):
    """A call with a Z = 0 lane is false on every lane, the kernel's
    verdicts equal to the plain version's: two lanes, and the mixed batch
    of `finish_mixed_lanes` (three blocks of 32, the zero in the middle
    one, an all-zero R there), which without the zero keeps its known
    verdicts."""
    zero = torch.zeros((2, 20), dtype=torch.int32, device=dev)
    y = zero.clone()
    y[1, 0] = 1
    r = torch.zeros((2, 32), dtype=torch.uint8, device=dev)
    r[1, 0] = 1
    assert TT._finish_encode_compare(zero, y, zero, r.int()).cpu().tolist() == [False, False]
    assert TT.finish_encode_compare(zero, y, zero, r).cpu().tolist() == [False, False]
    assert TT.finish_encode_compare(zero.cpu(), y.cpu(), zero.cpu(), r.cpu()).tolist() == [False, False]
    x, y, z, r, want = (torch.from_numpy(a).to(dev) for a in finish_mixed_lanes())
    assert TT.finish_lanes_per_block(x.shape[0], torch.cuda.get_device_properties(dev).multi_processor_count) == 32
    for _ in range(3):  # the scratch word is zero again after every call
        got = TT.finish_encode_compare(x, y, z, r)
        assert torch.equal(got, TT._finish_encode_compare(x, y, z, r.int()))
        assert not bool(got.any())
    z[MIXED_ZERO_LANE, 0] = 1
    got = TT.finish_encode_compare(x, y, z, r)
    assert torch.equal(got, want) and torch.equal(got, TT._finish_encode_compare(x, y, z, r.int()))


def test_finish_encode_compare_launches_nothing_for_no_lanes(dev):
    """B = 0 gives an empty verdict and leaves the launch count alone."""
    before = TT.finish_encode_compare.launches
    fe = torch.zeros((0, 20), dtype=torch.int32, device=dev)
    got = TT.finish_encode_compare(fe, fe, fe, torch.zeros((0, 32), dtype=torch.uint8, device=dev))
    assert got.shape == (0,) and got.dtype == torch.bool and got.device == fe.device
    assert TT.finish_encode_compare.launches == before


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    tables = torch.zeros((64, 16, 60, 4), dtype=torch.int16, device=dev)
    sh = torch.zeros((8, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        TT.sum_entries(tables, sh.long(), sh)
    with pytest.raises(ValueError):
        TT.sum_entries(tables, sh, sh[:, :31])
    with pytest.raises(ValueError):
        TT.sum_entries(tables.cpu(), sh, sh)
    with pytest.raises(ValueError):
        TT.sum_entries(tables, sh, sh.T.contiguous().T)
    for lanes in (0, 2, 6):  # no lanes, fewer than N, not whole commits
        with pytest.raises(ValueError):
            TT.sum_entries(tables, sh[:lanes], sh[:lanes])
    with pytest.raises(ValueError):
        TT.fused_chain(tables.int(), torch.zeros((8, 128), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        TT.fused_chain(tables, torch.zeros((8, 127), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        TT.fused_chain(tables.cpu(), torch.zeros((8, 128), dtype=torch.int32, device=dev))
    for lanes in (0, 2, 6):
        with pytest.raises(ValueError):
            TT.fused_chain(tables, torch.zeros((lanes, 128), dtype=torch.int32, device=dev))
    pub = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    dig = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        TL.ladder(pub.int(), dig)
    with pytest.raises(ValueError):
        TL.ladder(pub, dig.long())
    with pytest.raises(ValueError):
        TL.ladder(pub[:4], dig)
    with pytest.raises(ValueError):
        TL.ladder(pub.cpu(), dig)
    fe = torch.zeros((8, 20), dtype=torch.int32, device=dev)
    wide = torch.zeros((8, 40), dtype=torch.int32, device=dev)
    for bad in (
        (fe.long(), fe, fe, pub),  # dtype
        (fe, fe, fe, pub.float()),
        (fe[:, :19], fe, fe, pub),  # shape
        (fe, fe, fe, pub[:4]),
        (fe, fe.cpu(), fe, pub),  # device
        (fe, fe, fe, pub.cpu()),
        (wide[:, ::2], wide[:, ::2], wide[:, ::2], pub),  # contiguity
        (fe.T.contiguous().T, fe, fe, pub),  # layouts that differ
        (fe, fe, fe, pub.T.contiguous().T),
    ):
        with pytest.raises(ValueError):
            TT.finish_encode_compare(*bad)


def test_verifier_on_the_card_launches_each_kernel(dev, signed):
    from tendermint_tpu_torch.services.verifier import TableBatchVerifier

    pubs, commits = signed
    v = TableBatchVerifier(min_device_batch=0)
    def counts():
        return (TT.sum_entries.launches, TT.fused_chain.launches, TL.ladder.launches,
                TT.finish_encode_compare.launches)

    before = counts()
    single = v.verify_commits(pubs, commits[:1])
    stacked = v.verify_commits(pubs, commits)
    flat = v.verify_batch([(pubs[i], commits[1][0][i], commits[1][1][i]) for i in range(len(pubs))])
    assert counts() == tuple(c + d for c, d in zip(before, (1, 1, 1, 3)))
    assert not single[0, 3] and single.sum() == len(pubs) - 1
    assert not stacked[0, 3] and stacked.sum() == stacked.size - 1
    assert flat.all()


# -- the hash plane: sha256_masked, ripemd160_masked, sha512_masked, merkle_level


def _hash_modules():
    from tendermint_tpu_torch.ops import merkle_kernel as MK
    from tendermint_tpu_torch.ops import ripemd160_kernel as HR
    from tendermint_tpu_torch.ops import sha256_kernel as HS
    from tendermint_tpu_torch.ops import sha512_kernel as H5

    return HS, HR, H5, MK


def _masked(name):
    HS, HR, H5, _MK = _hash_modules()
    return {
        "sha256_masked": (HS.sha256_masked, HS._sha256_masked, 16),
        "ripemd160_masked": (HR.ripemd160_masked, HR._ripemd160_masked, 16),
        "sha512_masked": (H5.sha512_masked, H5._sha512_masked, 32),
    }[name]


def _random_blocks(bsz, mb, words, seed, dev):
    """Random words and block counts 0..M, one row past M and one below
    0 (both clamped, as the JAX mask treats them)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 2**32, (bsz, mb, words), dtype=np.uint64).astype(np.uint32).view(np.int32)
    n = rng.integers(0, mb + 1, bsz).astype(np.int32)
    n[0] = 0
    if bsz > 2:
        n[1], n[2] = mb + 3, -1
    return torch.from_numpy(blocks).to(dev), torch.from_numpy(n).to(dev)


@pytest.mark.parametrize("name", ["sha256_masked", "ripemd160_masked", "sha512_masked"])
@pytest.mark.parametrize("bsz,mb", [(1, 1), (1, 3), (77, 4), (1025, 2), (4096, 3), (4500, 2)])
def test_masked_hash_matches_plain(dev, name, bsz, mb):
    kernel, plain, words = _masked(name)
    blocks, n = _random_blocks(bsz, mb, words, 71 + bsz, dev)
    before = kernel.launches
    got = kernel(blocks, n)
    assert kernel.launches == before + 1
    assert torch.equal(got, plain(blocks, n))


@pytest.mark.parametrize("name", ["sha256_masked", "ripemd160_masked", "sha512_masked"])
def test_masked_hash_equals_hashlib(dev, name):
    import hashlib

    from tendermint_tpu_torch.ops import padding as HP

    kernel, _plain, _words = _masked(name)
    rng = np.random.default_rng(72)
    msgs = [rng.bytes(n) for n in (0, 55, 56, 64, 111, 112, 128, 305, 1000)]
    pad, ref, to_bytes = {
        "sha256_masked": (HP.pad_sha256, hashlib.sha256, HP.digests_to_bytes_be),
        "ripemd160_masked": (HP.pad_ripemd160, lambda m: hashlib.new("ripemd160", m), HP.digests_to_bytes_le),
        "sha512_masked": (HP.pad_sha512, hashlib.sha512, HP.digests_to_bytes_be),
    }[name]
    blocks, n = pad(msgs)
    got = kernel(torch.from_numpy(blocks.view(np.int32)).to(dev), torch.from_numpy(n).to(dev))
    assert to_bytes(got.cpu().numpy().view(np.uint32)) == [ref(m).digest() for m in msgs]


@pytest.mark.parametrize("algo", ["sha256", "ripemd160"])
def test_merkle_level_matches_plain(dev, algo):
    """Every level of a forest of 5 trees of 8 slots (counts 1, 2, 5, 7,
    8), kernel against plain version."""
    _HS, _HR, _H5, MK = _hash_modules()
    width = MK.WIDTHS[algo]
    rng = np.random.default_rng(73)
    nodes = torch.from_numpy(rng.integers(0, 2**32, (5, 8, width), dtype=np.uint64).astype(np.uint32).view(np.int32))
    nodes = nodes.to(dev)
    counts = torch.tensor([1, 2, 5, 7, 8], dtype=torch.int32, device=dev)
    for level in range(3):
        before = MK.merkle_level.launches
        got = MK.merkle_level(nodes, counts, level, algo)
        assert MK.merkle_level.launches == before + 1
        assert torch.equal(got, MK._merkle_level(nodes, counts, level, algo))
        nodes = got


@pytest.mark.parametrize("algo", ["sha256", "ripemd160"])
def test_forest_on_the_card_equals_the_host_tree(dev, algo):
    """A forest with T > 1, a 1-leaf tree and a power of two; one leaf
    launch and one level launch a level (P = 16: 4 levels)."""
    from tendermint_tpu_torch.merkle import simple as host

    HS, HR, _H5, MK = _hash_modules()
    rng = np.random.default_rng(74)
    trees = [[rng.bytes(int(rng.integers(0, 300))) for _ in range(k)] for k in (1, 16, 5, 9, 2)]
    leaf = HS.sha256_masked if algo == "sha256" else HR.ripemd160_masked
    before = (leaf.launches, MK.merkle_level.launches)
    got = MK.merkle_roots_forest(trees, algo, dev)
    assert (leaf.launches, MK.merkle_level.launches) == (before[0] + 1, before[1] + 4)
    assert got == [host.simple_hash_from_byte_slices(t, algo) for t in trees]
    assert MK.merkle_root_device(trees[0], algo, dev) == host.simple_hash_from_byte_slices(trees[0], algo)


@pytest.mark.parametrize("algo", ["sha256", "ripemd160"])
def test_tree_hasher_on_the_card(dev, algo):
    from tendermint_tpu_torch.merkle import simple as host
    from tendermint_tpu_torch.services.hasher import TreeHasher

    rng = np.random.default_rng(75)
    items = [rng.bytes(int(rng.integers(1, 200))) for _ in range(300)]
    h = TreeHasher(algo=algo, min_device_leaves=0)
    assert h.device.type == "cuda"
    assert h.root_from_items(items) == host.simple_hash_from_byte_slices(items, algo)
    leaves = h.leaf_hashes(items)
    assert leaves == [host.leaf_hash(x, algo) for x in items]
    assert h.root_from_hashes(leaves) == host.simple_hash_from_hashes(leaves, algo)


def test_hash_wrappers_reject_what_the_kernels_do_not_take(dev):
    HS, HR, H5, MK = _hash_modules()
    blocks = torch.zeros((4, 2, 16), dtype=torch.int32, device=dev)
    n = torch.ones((4,), dtype=torch.int32, device=dev)
    for fn in (HS.sha256_masked, HR.ripemd160_masked):
        for bad in (
            (blocks.long(), n),  # dtype
            (blocks, n.long()),
            (blocks[:, :, :15], n),  # shape
            (blocks, n[:3]),
            (blocks[:, :0], n),
            (blocks.cpu(), n),  # device
            (blocks, n.cpu()),
            (blocks.transpose(0, 1).contiguous().transpose(0, 1), n),  # layout
        ):
            with pytest.raises(ValueError):
                fn(*bad)
    with pytest.raises(ValueError):
        H5.sha512_masked(blocks, n)  # 16 words, not 32
    flat = torch.zeros((1 + 4 * 2 * 16,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # contiguous, but 4 bytes off a 16-byte boundary
        HS.sha256_masked(flat[1:].view(4, 2, 16), n)
    nodes = torch.zeros((2, 4, 8), dtype=torch.int32, device=dev)
    counts = torch.full((2,), 4, dtype=torch.int32, device=dev)
    for bad, algo in (
        ((nodes.long(), counts, 0), "sha256"),  # dtype
        ((nodes, counts.long(), 0), "sha256"),
        ((nodes, counts, 0), "ripemd160"),  # width 8 is not RIPEMD-160's 5
        ((nodes[:, :3], counts, 0), "sha256"),  # odd P
        ((nodes, counts[:1], 0), "sha256"),
        ((nodes.cpu(), counts, 0), "sha256"),  # device
        ((nodes, counts, -1), "sha256"),  # level
    ):
        with pytest.raises(ValueError):
            MK.merkle_level(*bad, algo)


def test_hash_wrappers_launch_nothing_for_no_rows(dev):
    HS, _HR, _H5, _MK = _hash_modules()
    before = HS.sha256_masked.launches
    got = HS.sha256_masked(torch.zeros((0, 1, 16), dtype=torch.int32, device=dev),
                           torch.zeros((0,), dtype=torch.int32, device=dev))
    assert got.shape == (0, 8) and HS.sha256_masked.launches == before


# -- the mesh (`parallel/mesh.py`) on the card --------------------------------


def _mesh_triples(n, corrupt=()):
    out = []
    for i in range(n):
        seed = bytes([i + 1]) * 32
        msg = b"card-mesh-%d" % i
        sig = ed25519_ref.sign(seed, msg)
        if i in corrupt:
            sig = sig[:8] + bytes([sig[8] ^ 1]) + sig[9:]
        out.append((ed25519_ref.public_from_seed(seed), msg, sig))
    return out


def _card_mesh(reprobe_s=60.0):
    """Four shards: one a card where four are visible, else several on one."""
    from tendermint_tpu_torch.parallel.mesh import MeshManager

    n = torch.cuda.device_count()
    return MeshManager(devices=[torch.device("cuda", i % n) for i in range(4)], reprobe_s=reprobe_s)


def test_mesh_matches_the_one_card_verifier(dev, monkeypatch):
    """A 4-shard mesh on the card: the flat batch's mask and tally, and a
    32-validator commit and a stack of 8 through the table path (the
    entries chain, then the fused chain, a shard), equal the one-card
    verifier's on the same lanes."""
    from tendermint_tpu_torch.services.verifier import (
        ShardedBatchVerifier,
        ShardedTableBatchVerifier,
        TableBatchVerifier,
    )
    from tendermint_tpu_torch.utils import fail

    monkeypatch.setattr(fail, "_device_faults", {})
    mesh = _card_mesh()
    triples = _mesh_triples(40, corrupt={3, 17})
    powers = np.arange(1, 41, dtype=np.int32)
    one = TableBatchVerifier(device=dev, min_device_batch=1)
    want = one.verify_batch(triples)
    assert want.sum() == 38
    mask, tally = ShardedBatchVerifier(mesh=mesh, min_device_batch=1).verify_batch_with_powers(triples, powers)
    assert (mask == want).all() and tally == int(powers[want].sum())
    pubs, msgs, sigs = (list(x) for x in zip(*triples[:32]))
    tv = ShardedTableBatchVerifier(mesh=mesh, min_device_batch=1)
    for k in (1, 8):
        stack = [(msgs, sigs)] * k
        assert (tv.verify_commits(pubs, stack) == one.verify_commits(pubs, stack)).all()
    tv.close()
    one.close()


def test_mesh_remeshes_a_shard_fault_mid_call(dev, monkeypatch):
    """A fault armed on shard 1 for one launch: the call re-meshes onto
    the other three shards and answers exactly, one ladder launch a
    surviving shard."""
    from tendermint_tpu_torch.services.verifier import HostBatchVerifier, ShardedBatchVerifier
    from tendermint_tpu_torch.utils import fail

    monkeypatch.setattr(fail, "_device_faults", {})
    mesh = _card_mesh()
    v = ShardedBatchVerifier(mesh=mesh, min_device_batch=1)
    triples = _mesh_triples(24, corrupt={7})
    want = HostBatchVerifier().verify_batch(triples)
    v.verify_batch(triples)  # first use of the device set
    fail.set_device_fault("shard1", 1)
    before = TL.ladder.launches
    assert (v.verify_batch(triples) == want).all()
    assert mesh.active_indices() == (0, 2, 3)
    assert TL.ladder.launches - before == 3


def test_ledger_records_match_the_wrappers_launches(dev, signed, monkeypatch):
    """On the card, the launch ledger's records account for exactly the
    kernel wrappers' launches: a commit, a stack of 8 (async), a flat
    batch, a data_hash and leaf hashes on one card, and a flat batch on
    the 4-shard mesh through a shard fault (one record, three shards)."""
    from tendermint_tpu_torch.ops import merkle_kernel as MK
    from tendermint_tpu_torch.services.dispatch import DispatchQueue
    from tendermint_tpu_torch.services.hasher import TreeHasher
    from tendermint_tpu_torch.services.verifier import ShardedBatchVerifier, TableBatchVerifier
    from tendermint_tpu_torch.telemetry import launchlog
    from tendermint_tpu_torch.testing import kernel_launches, ledger_launches
    from tendermint_tpu_torch.utils import fail

    HS, HR, _H5, _MK = _hash_modules()
    wrappers = {"madd_chain_entries": TT.sum_entries, "madd_chain_fused": TT.fused_chain, "ladder": TL.ladder,
                "finish_encode_compare": TT.finish_encode_compare, "sha256_masked": HS.sha256_masked,
                "ripemd160_masked": HR.ripemd160_masked}
    monkeypatch.setattr(fail, "_device_faults", {})
    pubs, commits = signed
    v = TableBatchVerifier(device=dev, min_device_batch=0)
    hasher = TreeHasher(device=dev, min_device_leaves=0)
    mesh_v = ShardedBatchVerifier(mesh=_card_mesh(), min_device_batch=1)
    triples = _mesh_triples(24, corrupt={7})
    mesh_v.verify_batch(triples)  # first use of the device set
    q = DispatchQueue(name="ledger-card")
    launchlog.LAUNCHLOG.clear()
    before = {k: w.launches for k, w in wrappers.items()}
    try:
        v.verify_commits(pubs, commits[:1])
        v.verify_commits_async(pubs, commits, queue=q).result(60)
        v.verify_batch([(pubs[i], commits[1][0][i], commits[1][1][i]) for i in range(len(pubs))])
        hasher.root_from_items([i.to_bytes(2, "big") * 20 for i in range(300)])
        hasher.leaf_hashes([bytes([i]) * 9 for i in range(70)])
        fail.set_device_fault("shard1", 1)
        mesh_v.verify_batch(triples)
    finally:
        q.close()
    recs = launchlog.LAUNCHLOG.recent()
    delta = {k: w.launches - before[k] for k, w in wrappers.items()}
    assert [(r["kind"], r["backend"], r.get("mesh_width", 1)) for r in recs] == [
        ("tables", "tables", 1), ("tables", "tables", 1), ("verify", "device", 1),
        ("hash", "device", 1), ("leaf_hashes", "device", 1), ("verify", "mesh", 3)]
    assert ledger_launches(recs) == kernel_launches(delta) == {
        "verify": 4, "tables": 2, "hash": 2, "finish_encode_compare": 6}
    assert recs[1]["queue"] == "ledger-card" and recs[2]["rows_padded"] == 0
    v.close()


def test_port_types_verify_on_the_card(dev, monkeypatch):
    """The port's own `ValidatorSet` on the card's stack at minimum
    device batch 0: a 300-validator commit through `verify_commit`
    launches the entries chain and the finish, `verify_commit_any` the
    ladder and the finish; a forged precommit raises naming its
    validator."""
    from tendermint_tpu_torch.crypto import PrivKey
    from tendermint_tpu_torch.services import verifier as V
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.types import (
        VOTE_TYPE_PRECOMMIT, BlockID, Commit, PartSetHeader, ValidationError, Validator, ValidatorSet, Vote,
    )

    chain = "card-chain"
    monkeypatch.setattr(V, "_DEFAULTS", {})
    stack = V.default_verifier(dev)
    stack.inner.primary._min_batch = 0
    rng = np.random.default_rng(61)
    keys = [PrivKey(rng.bytes(32)) for _ in range(300)]
    vs = ValidatorSet([Validator(k.pub_key.address, k.pub_key, 10) for k in keys])
    by_addr = {k.pub_key.address: k for k in keys}
    bid = BlockID(rng.bytes(32), PartSetHeader(total=1, hash=rng.bytes(20)))
    pre = []
    for i, val in enumerate(vs.validators):
        vote = Vote(val.address, i, 9, 0, 1000 + i, VOTE_TYPE_PRECOMMIT, bid)
        pre.append(vote.with_signature(by_addr[val.address].sign(vote.sign_bytes(chain))))
    commit = Commit(block_id=bid, precommits=pre)
    forged = Commit(block_id=bid, precommits=list(pre))
    forged.precommits[17] = pre[17].with_signature(bytes([pre[17].signature[0] ^ 1]) + pre[17].signature[1:])

    def counts():
        return (TT.sum_entries.launches, TL.ladder.launches, TT.finish_encode_compare.launches)

    light = CoalescingVerifier(stack.inner)  # an empty signature cache of its own
    try:
        before = counts()
        vs.verify_commit(chain, bid, 9, commit, verifier=stack)
        with pytest.raises(ValidationError, match="invalid commit signature from validator 17$"):
            vs.verify_commit(chain, bid, 9, forged, verifier=stack)
        mid = counts()
        vs.verify_commit_any(ValidatorSet(list(vs.validators)), chain, bid, 9, commit, verifier=light)
        after = counts()
    finally:
        light.coalescer.close()
        stack.close()
    assert mid[0] - before[0] == 2 and mid[1] == before[1] and mid[2] - before[2] == 2
    assert after[0] == mid[0] and after[1] - mid[1] == 1 and after[2] - mid[2] == 1


def test_port_chain_applies_and_certifies_on_the_card(dev, monkeypatch):
    """The port's `ChainSim` on the card's stack at minimum device batch 0:
    a 150-validator chain whose height 2 replaces 15 validators; every
    `apply_block` from height 2 on verifies its last commit with one
    entries-chain launch and one finish, the new set's tables come from
    the prebuild, a forged precommit raises before the app runs,
    `certify_batch` of the new set's 8 commits takes the fused kernel and
    `DynamicCertifier.update` across the change the ladder."""
    from tendermint_tpu_torch.abci.apps import PersistentKVStoreApp
    from tendermint_tpu_torch.certifiers import DynamicCertifier, FullCommit, StaticCertifier
    from tendermint_tpu_torch.crypto import PrivKey
    from tendermint_tpu_torch.db.kv import MemDB
    from tendermint_tpu_torch.services import verifier as V
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.state import apply_block
    from tendermint_tpu_torch.testing import ChainSim
    from tendermint_tpu_torch.types import Commit, PrivValidator, ValidationError

    monkeypatch.setattr(V, "_DEFAULTS", {})
    stack = V.default_verifier(dev)
    stack.inner.primary._min_batch = 0
    rng = np.random.default_rng(67)

    def counts():
        return (TT.sum_entries.launches, TT.fused_chain.launches, TL.ladder.launches,
                TT.finish_encode_compare.launches)

    def delta(before):
        return tuple(b - a for a, b in zip(before, counts()))

    # the commits are made and checked on the host; the chain applies on the card
    sim = ChainSim(n_vals=150, app=PersistentKVStoreApp(MemDB()), verifier=V.HostBatchVerifier())
    light = CoalescingVerifier(stack.inner)  # the light client's own signature cache
    try:
        sim.advance(txs=[b"a=1"], verifier=stack)
        new = [PrivValidator(PrivKey(rng.bytes(32))) for _ in range(15)]
        leaving = sim.state.validators.validators[:15]
        txs = [b"val:%s/0" % v.pub_key.data.hex().encode() for v in leaving]
        txs += [b"val:%s/10" % p.pub_key.data.hex().encode() for p in new]
        sim.privs += new
        before = counts()
        sim.advance(txs=txs, verifier=stack)
        assert delta(before) == (1, 0, 0, 1)
        backend = stack.inner.primary
        for t in list(backend._prebuilds.values()):
            t.join(timeout=120)
        key = backend._cache_key(tuple(v.pub_key.data for v in sim.state.validators))
        assert key in backend._tables and sim.state.last_height_validators_changed == 3
        for _ in range(9):  # heights 3..11: the new set signs from height 3 on
            before = counts()
            sim.advance(txs=[rng.bytes(40)], verifier=stack)
            assert delta(before) == (1, 0, 0, 1)
        # a forged precommit in the next block's last commit
        saved = sim.commits[-1]
        pre = list(saved.precommits)
        pre[7] = pre[7].with_signature(bytes([pre[7].signature[0] ^ 1]) + pre[7].signature[1:])
        sim.commits[-1] = Commit(block_id=saved.block_id, precommits=pre)
        block, ps = sim.make_next_block(txs=[b"z=9"])
        sim.commits[-1] = saved
        state_json, app_state = sim.state.to_json(), sim.app.snapshot_state()
        fresh = CoalescingVerifier(stack.inner)
        try:
            with pytest.raises(ValidationError, match="invalid commit signature from validator 7$"):
                apply_block(sim.state, block, ps.header, sim.conns.consensus, verifier=fresh)
        finally:
            fresh.coalescer.close()
        assert sim.state.to_json() == state_json and sim.app.snapshot_state() == app_state
        fcs = [FullCommit(sim.blocks[h - 1].header, sim.commits[h - 1], sim.state.load_validators(h))
               for h in range(1, 12)]
        before = counts()
        StaticCertifier(sim.chain_id, fcs[3].validators, light).certify_batch(fcs[3:11])
        assert delta(before) == (0, 1, 0, 1)
        cert = DynamicCertifier(sim.chain_id, fcs[0].validators, height=1, verifier=light)
        cert.certify(fcs[1])
        before = counts()
        cert.update(fcs[2])
        assert delta(before) == (0, 0, 1, 1) and cert.last_height == 3
        snap = stack.inner.snapshot()
        assert snap["fallback_calls"] == 0 and snap["total_failures"] == 0
    finally:
        light.coalescer.close()
        stack.close()
