"""The port's verifier services against the JAX package's host verifier.

`DeviceBatchVerifier(device="cpu")` and `TableBatchVerifier(device="cpu")`
run the plain torch versions of the kernels; their verdicts must equal
`tendermint_tpu.services.verifier.HostBatchVerifier`'s on the same
triples, lane for lane.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.keys import gen_priv_key
from tendermint_tpu.services.verifier import HostBatchVerifier as JaxHostVerifier
from tendermint_tpu_torch.ops import ed25519_kernel as T
from tendermint_tpu_torch.ops import ed25519_ladder as TL
from tendermint_tpu_torch.ops import ed25519_tables as TT
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))

ZERO_KEY = b"\x00" * 32  # small order: y = 0 is a point of order 4


def _privs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [gen_priv_key(rng.bytes(32)) for _ in range(n)]


@pytest.fixture(scope="module")
def privs():
    return _privs(6, seed=41)


def _commit(privs, tag: bytes, absent=(), forged=(), s_ge_l=()):
    msgs, sigs = [], []
    for i, p in enumerate(privs):
        if i in absent:
            msgs.append(None)
            sigs.append(None)
            continue
        m = tag + b"-%d" % i
        sig = p.sign(m)
        if i in forged:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        if i in s_ge_l:
            s = int.from_bytes(sig[32:], "little") + T.L
            sig = sig[:32] + s.to_bytes(32, "little")
        msgs.append(m)
        sigs.append(sig)
    return msgs, sigs


def _host_grid(pubs, commits):
    grid = np.zeros((len(commits), len(pubs)), dtype=bool)
    host = JaxHostVerifier()
    for ci, (msgs, sigs) in enumerate(commits):
        for i, (m, s) in enumerate(zip(msgs, sigs)):
            if m is not None and s is not None:
                grid[ci, i] = host.verify_batch([(pubs[i], m, s)])[0]
    return grid


def _flat(privs):
    triples = []
    for i, p in enumerate(privs):
        m = b"flat-%d" % i
        triples.append((p.pub_key.data, m, p.sign(m)))
    pk, m, s = triples[0]
    triples[0] = (pk, m, bytes([s[0] ^ 1]) + s[1:])  # forged
    pk, m, s = triples[1]
    triples[1] = (pk[:31], m, s)  # short pubkey
    pk, m, s = triples[2]
    triples[2] = (pk, m, s[:32] + (int.from_bytes(s[32:], "little") + T.L).to_bytes(32, "little"))
    pk, m, s = triples[3]
    triples[3] = (pk, m, s + b"\x00")  # wrong-length signature
    return triples


def test_device_batch_verifier_matches_jax_host(privs):
    triples = _flat(privs)
    v = V.DeviceBatchVerifier(device="cpu", min_device_batch=0)
    got = v.verify_batch(triples)
    want = JaxHostVerifier().verify_batch(triples)
    np.testing.assert_array_equal(got, want)
    assert list(got) == [False, False, False, False, True, True]


def test_flat_batches_take_the_ladder_on_cpu(privs, monkeypatch):
    """The CPU runs the card's flat path — the digit packing, the ladder
    kernel's plain version, the encode-and-compare finish — not another
    verifier, and no decompression or inversion before the ladder."""
    seen = []
    for mod, name in (
        (TL, "_digits_w4"),
        (TL, "pt_decompress"),
        (TL, "fe_batch_invert"),
        (TL, "_ladder_w4_plain"),
        (TL, "finish_encode_compare"),
    ):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real: seen.append(_n) or _f(*a))
    triples = _flat(privs)
    got = V.DeviceBatchVerifier(device="cpu", min_device_batch=0).verify_batch(triples)
    np.testing.assert_array_equal(got, JaxHostVerifier().verify_batch(triples))
    assert seen == ["_digits_w4", "_ladder_w4_plain", "finish_encode_compare"]


@pytest.mark.parametrize("n", [1, 9])
def test_flat_bucket_padding(privs, n):
    """Batches that are not a power of two pad to their bucket (8, 16)
    and only their own lanes come back."""
    flat = _flat(privs)
    triples = [flat[4 + i % 2] for i in range(n)]
    got = V.DeviceBatchVerifier(device="cpu", min_device_batch=0).verify_batch(triples)
    assert got.shape == (n,) and got.all()


def test_add_flush_and_verify_one(privs):
    v = V.DeviceBatchVerifier(device="cpu", min_device_batch=0)
    triples = _flat(privs)
    idx = [v.add(*t) for t in triples]
    assert idx == list(range(len(triples))) and v.pending() == len(triples)
    np.testing.assert_array_equal(v.flush(), JaxHostVerifier().verify_batch(triples))
    assert v.pending() == 0 and v.flush().shape == (0,)
    assert v.verify_one(*triples[-1]) is True


def test_small_batches_answer_on_the_host(privs):
    v = V.DeviceBatchVerifier(device="cpu")  # default minimum: 512 lanes
    launched = v.launch_verify_batch(_flat(privs))
    assert launched[0] == "host"
    np.testing.assert_array_equal(
        v.finalize_verify_batch(launched), JaxHostVerifier().verify_batch(_flat(privs))
    )


@pytest.fixture(scope="module")
def table_verifier():
    return V.TableBatchVerifier(device="cpu", min_device_batch=0)


def test_verify_commits_matches_jax_host(table_verifier, privs):
    pubs = [p.pub_key.data for p in privs]
    commits = [
        _commit(privs, b"h1", forged=(1,)),
        _commit(privs, b"h2", absent=(0, 4), s_ge_l=(2,)),
    ]
    got = table_verifier.verify_commits(pubs, commits)
    np.testing.assert_array_equal(got, _host_grid(pubs, commits))
    assert got.shape == (2, 6) and got.sum() == 8


@pytest.mark.parametrize("force_fused", [True, False])
def test_both_chains_give_the_same_verdicts(table_verifier, privs, force_fused):
    """Either chain, forced through `verify_tables_kernel(impl=...)` on
    the verifier's cached tables, against the host verdicts."""
    pubs = [p.pub_key.data for p in privs]
    commits = [_commit(privs, b"f%d" % k, forged=(k,)) for k in range(3)]
    tables, key_ok = table_verifier.tables_for(tuple(pubs))
    s, h, r, pre = TT.prepare_commit_lanes(pubs, commits)
    impl = "fused" if force_fused else "entries"
    dev = TT.verify_tables_kernel(tables, *(torch.from_numpy(a) for a in (s, h, r)), impl=impl)
    got = (dev.numpy() & pre & np.tile(key_ok, len(commits))).reshape(len(commits), -1)
    np.testing.assert_array_equal(got, _host_grid(pubs, commits))


def test_stack_depth_picks_the_chain(table_verifier, privs, monkeypatch):
    """Single commits and small stacks take the entries chain; stacks of
    FUSED_MIN_STACK commits or more (fast-sync windows) the fused one."""
    taken = []
    for name in ("sum_entries", "fused_chain"):
        real = getattr(TT, name)
        monkeypatch.setattr(
            TT, name, lambda *a, _n=name, _f=real: taken.append(_n) or _f(*a)
        )
    pubs = [p.pub_key.data for p in privs]
    for k in (1, TT.FUSED_MIN_STACK - 1, TT.FUSED_MIN_STACK):
        commits = [_commit(privs, b"d%d-%d" % (k, i), forged=(i % 6,)) for i in range(k)]
        np.testing.assert_array_equal(
            table_verifier.verify_commits(pubs, commits), _host_grid(pubs, commits)
        )
    assert taken == ["sum_entries", "sum_entries", "fused_chain"]


def test_table_cache_hit_reuses_tables(privs):
    v = V.TableBatchVerifier(device="cpu", min_device_batch=0)
    pubs = tuple(p.pub_key.data for p in privs)
    t1, ok1 = v.tables_for(pubs)
    t2, ok2 = v.tables_for(pubs)
    assert t1 is t2 and ok1 is ok2 and len(v._tables) == 1


def test_incremental_build_under_the_host_limit(privs):
    v = V.TableBatchVerifier(device="cpu", min_device_batch=0)
    old = [p.pub_key.data for p in privs]
    v.tables_for(tuple(old))
    newcomer = _privs(1, seed=42)[0]
    new_privs = [privs[3], newcomer, privs[0], privs[5]]  # reordered + one new key
    new = tuple(p.pub_key.data for p in new_privs)
    built = v._incremental_build(new)
    assert built is not None
    tables, ok = built
    want_t, want_ok = TT.host_build_key_tables(list(new))
    np.testing.assert_array_equal(tables.numpy(), want_t)
    np.testing.assert_array_equal(ok, want_ok)
    commits = [_commit(new_privs, b"inc", forged=(2,))]
    np.testing.assert_array_equal(
        v.verify_commits(list(new), commits), _host_grid(list(new), commits)
    )
    # an unrelated set shares no key: no incremental build
    assert v._incremental_build(tuple(p.pub_key.data for p in _privs(2, seed=43))) is None


def test_cache_evicts_least_recently_used(privs):
    v = V.TableBatchVerifier(device="cpu", cache_size=1, min_device_batch=0)
    a = tuple(p.pub_key.data for p in privs[:2])
    b = tuple(p.pub_key.data for p in privs[2:4])
    v.tables_for(a)
    v.tables_for(b)
    assert list(v._tables) == [hashlib.sha256(b"".join(b)).digest()]


def test_short_pubkey_and_absent_lanes(table_verifier, privs):
    pubs = [p.pub_key.data for p in privs]
    pubs[5] = pubs[5][:31]
    commits = [_commit(privs, b"short", absent=(1,))]
    got = table_verifier.verify_commits(pubs, commits)
    np.testing.assert_array_equal(got, _host_grid(pubs, commits))
    assert not got[0, 5] and not got[0, 1] and got[0, 0]


def test_small_commits_take_the_host_loop(privs):
    v = V.TableBatchVerifier(device="cpu")
    pubs = [p.pub_key.data for p in privs]
    commits = [_commit(privs, b"small", forged=(3,))]
    launched = v.launch_verify_commits(pubs, commits)
    assert launched[0] == "host" and len(v._tables) == 0
    np.testing.assert_array_equal(v.finalize_verify_commits(launched), _host_grid(pubs, commits))


def test_empty_inputs():
    v = V.TableBatchVerifier(device="cpu", min_device_batch=0)
    assert v.verify_commits([], []).shape == (0, 0)
    assert v.verify_batch([]).shape == (0,)


def test_cpu_tensors_never_count_a_launch(table_verifier, privs):
    before = (
        TT.sum_entries.launches, TT.fused_chain.launches, TL.ladder.launches,
        TT.finish_encode_compare.launches,
    )
    pubs = [p.pub_key.data for p in privs]
    stack = [_commit(privs, b"c%d" % i) for i in range(TT.FUSED_MIN_STACK)]
    table_verifier.verify_commits(pubs, stack)  # fused chain
    table_verifier.verify_commits(pubs, [_commit(privs, b"d")])  # entries chain
    table_verifier.verify_batch(_flat(privs))
    after = (
        TT.sum_entries.launches, TT.fused_chain.launches, TL.ladder.launches,
        TT.finish_encode_compare.launches,
    )
    assert before == after == (0, 0, 0, 0)


def test_entry_points_raise_without_a_card(monkeypatch):
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.resilient import ResilientVerifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(V, "_DEFAULTS", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.default_verifier()
    with pytest.raises(RuntimeError):
        V.DeviceBatchVerifier()
    with pytest.raises(RuntimeError):
        T.batch_verify([b"\x01" * 32], [b"m"], [b"\x00" * 64])
    assert V._DEFAULTS == {}
    v = V.default_verifier(device="cpu")
    try:
        # the JAX node's layering: coalescing -> resilient -> table backend
        assert isinstance(v, CoalescingVerifier) and isinstance(v.inner, ResilientVerifier)
        assert isinstance(v.inner.primary, V.TableBatchVerifier)
        assert v.inner.primary.device.type == "cpu"
        assert V.default_verifier(device="cpu") is v  # one shared table cache
        monkeypatch.setenv("TENDERMINT_TPU_COALESCE", "0")
        monkeypatch.setattr(V, "_DEFAULTS", {})
        bare = V.default_verifier(device="cpu")
        assert type(bare) is ResilientVerifier and isinstance(bare.primary, V.TableBatchVerifier)
        V.set_default_verifier(v, device="cpu")
        assert V.default_verifier(device="cpu") is v
    finally:
        v.close()


def _zero_key_message() -> tuple[bytes, bytes]:
    """A message the all-zero key 'signs' with R = identity, S = 0:
    cofactorless verification accepts it whenever h = H(R, A, M) is a
    multiple of 4, the order of the zero key's point."""
    sig = b"\x01" + b"\x00" * 63
    for i in range(64):
        msg = b"keyless-%d" % i
        h = int.from_bytes(hashlib.sha512(sig[:32] + ZERO_KEY + msg).digest(), "little") % T.L
        if h % 4 == 0:
            return msg, sig
    raise AssertionError("no message with h = 0 mod 4 in 64 tries")


def test_small_order_key_is_not_screened_on_the_device_lanes(privs):
    """Like the JAX device kernels (docs/BYZANTINE.md), the port's device
    lanes accept the zero key's keyless signature; its host verifier,
    like the JAX host verifier, screens the key. The port adds no screen
    of its own."""
    msg, sig = _zero_key_message()
    flat = V.DeviceBatchVerifier(device="cpu", min_device_batch=0)
    assert flat.verify_batch([(ZERO_KEY, msg, sig)])[0]
    pubs = [ZERO_KEY] + [p.pub_key.data for p in privs[:3]]
    commit = ([msg] + [None] * 3, [sig] + [None] * 3)
    tables = V.TableBatchVerifier(device="cpu", min_device_batch=0)
    assert tables.verify_commits(pubs, [commit])[0, 0]
    assert not V.HostBatchVerifier().verify_batch([(ZERO_KEY, msg, sig)])[0]
    assert not JaxHostVerifier().verify_batch([(ZERO_KEY, msg, sig)])[0]
