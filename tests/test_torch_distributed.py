"""The port's multi-host seam (`tendermint_tpu_torch/parallel/distributed.py`)
and its device names.

* The single-process seam, as `tests/test_services.py` drives the JAX
  package's: `initialize()` a no-op, `process_info() == (0, 1)`, a
  mesh's tally over rows placed by `host_local_to_global`.
* Two processes joined by gloo, 4 CPU shards each (the port's
  counterpart of `tests/test_multiprocess.py`'s two-process
  `jax.distributed` run): 16 triples, lane 5 forged, power 3 each; both
  ranks read the global tally 45, and rank 0's own mask has lane 5 false.
  The same over NCCL is a `cuda` case: it needs two cards, one half of
  them a process, and skips with fewer. This file imports no jax, so it
  runs on the card's machine with `--noconftest`.
* `resolve_device` names a card with its index, so that one card has one
  default stack (torch's `device("cuda") != device("cuda:0")`).
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519_ref
from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.ops.ed25519_kernel import prepare_batch
from tendermint_tpu_torch.parallel import distributed as dist
from tendermint_tpu_torch.parallel import mesh as mesh_mod
from tendermint_tpu_torch.parallel.mesh import BATCH_AXIS, gather_verdicts, pad_to_multiple
from tendermint_tpu_torch.services import hasher as port_hasher
from tendermint_tpu_torch.services import verifier as port_verifier
from tendermint_tpu_torch.services.batcher import CoalescingVerifier
from tendermint_tpu_torch.services.resilient import ResilientVerifier
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture

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

REPO = pathlib.Path(__file__).resolve().parents[1]


def _triples(n, corrupt=()):
    out = []
    for i in range(n):
        seed = bytes([i + 1]) * 32
        msg = b"dist-msg-%d" % i
        sig = ed25519_ref.sign(seed, msg)
        if i in corrupt:
            sig = sig[:8] + bytes([sig[8] ^ 1]) + sig[9:]
        out.append((ed25519_ref.public_from_seed(seed), msg, sig))
    return out


@pytest.fixture
def fresh_seam(monkeypatch):
    monkeypatch.setattr(dist, "_init_mode", None)


# -- one process ------------------------------------------------------------------


def test_single_process_seam_tallies_over_cpu_shards(fresh_seam, monkeypatch):
    monkeypatch.setenv("TENDERMINT_TPU_MESH_DEVICES", "4")
    dist.initialize()  # single process: nothing to join
    dist.initialize()  # idempotent
    assert dist.process_info() == (0, 1)
    mesh = dist.global_batch_mesh(device="cpu")
    assert mesh.n_total == 4 and not mesh.spans_processes

    pub, r, s, h, _pre = prepare_batch(*zip(*_triples(6, corrupt={2})))
    arrs, powers, valid = pad_to_multiple([pub, r, s, h], np.full(6, 2, dtype=np.int32), 4)
    placed = [dist.host_local_to_global(mesh, BATCH_AXIS, a) for a in arrs]
    assert [tuple(p.shape) for p in placed[0]] == [(2, 32)] * 4
    pw = dist.host_local_to_global(mesh, BATCH_AXIS, powers)
    ok, total = mesh.verify_step()(*placed, pw)
    assert gather_verdicts(ok)[:valid].tolist() == [True, True, False, True, True, True]
    assert gather_verdicts(ok)[valid:].tolist() == [False, False]  # zero pad rows
    assert int(total) == 2 * 5


def test_host_local_to_global_specs():
    mesh = mesh_mod.MeshManager(devices=["cpu"] * 3)
    rows = np.arange(12, dtype=np.int32).reshape(6, 2)
    split = dist.host_local_to_global(mesh, BATCH_AXIS, rows)
    assert [p.tolist() for p in split] == [rows[0:2].tolist(), rows[2:4].tolist(), rows[4:6].tolist()]
    replicas = dist.host_local_to_global(mesh, None, rows)
    assert len(replicas) == 3 and all(p.tolist() == rows.tolist() for p in replicas)
    with pytest.raises(ValueError):
        dist.host_local_to_global(mesh, BATCH_AXIS, rows[:5])  # 5 rows over 3 shards
    with pytest.raises(ValueError):
        dist.host_local_to_global(mesh, ("batch",), rows)


def test_multi_host_init_after_local_init_raises(fresh_seam):
    dist.initialize()
    with pytest.raises(RuntimeError):
        dist.initialize(coordinator="127.0.0.1:1", num_processes=2, process_id=0, device="cpu")


# -- two processes ------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_WORKER = r"""
import os, sys
rank, coord, device = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
import torch
torch.set_num_threads(1)
from tendermint_tpu_torch.crypto import ed25519_ref
from tendermint_tpu_torch.ops.ed25519_kernel import prepare_batch
from tendermint_tpu_torch.parallel import distributed as dist
from tendermint_tpu_torch.parallel.mesh import BATCH_AXIS, gather_verdicts

dist.initialize(coordinator=coord, num_processes=2, process_id=rank, device=device)
assert dist.process_info() == (rank, 2), dist.process_info()
mesh = dist.global_batch_mesh(device=device)
assert mesh.spans_processes, mesh.snapshot()
assert device != "cpu" or mesh.n_total == 4, mesh.snapshot()

# the same 16 triples on both ranks; lane 5 forged (rank 0's half)
seeds = [bytes([i + 1]) * 32 for i in range(16)]
msgs = [b"dist-msg-%d" % i for i in range(16)]
sigs = [ed25519_ref.sign(s, m) for s, m in zip(seeds, msgs)]
sigs[5] = sigs[5][:8] + bytes([sigs[5][8] ^ 1]) + sigs[5][9:]
pub, r, s, h, _pre = prepare_batch([ed25519_ref.public_from_seed(x) for x in seeds], msgs, sigs)
powers = np.full(16, 3, dtype=np.int32)

# each process places only its own half, over its own 4 shards
lo, hi = rank * 8, rank * 8 + 8
placed = [dist.host_local_to_global(mesh, BATCH_AXIS, a[lo:hi]) for a in (pub, r, s, h, powers)]
ok, total = mesh.verify_step()(*placed)
assert int(total) == 15 * 3, int(total)  # the global tally, on both ranks
local = gather_verdicts(ok)
want = np.ones(8, dtype=bool)
if rank == 0:
    want[5] = False
assert (local == want).all(), (rank, local)
from tendermint_tpu_torch.utils import lockrank
assert not lockrank.violations(), lockrank.render_report()
print("RANK%d OK" % rank, flush=True)
"""


def _run_two_ranks(tmp_path, device: str, rank_env) -> None:
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "dist_worker.py"
    script.write_text(_WORKER)
    procs = []
    for rank in (0, 1):
        env = dict(os.environ)
        # the port's sanitizer on, as the conftest sets it for this process
        env.update(PYTHONPATH=str(REPO), TENDERMINT_TPU_LOCKRANK="1", **rank_env(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(rank), coord, device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank{rank} failed:\n{out[-3000:]}"
        assert f"RANK{rank} OK" in out


def test_two_processes_share_one_tally(tmp_path):
    _run_two_ranks(tmp_path, "cpu", lambda _rank: {"TENDERMINT_TPU_MESH_DEVICES": "4"})


@pytest.mark.cuda
def test_two_processes_share_one_tally_over_nccl(tmp_path):
    """The same run with NCCL: each process sees its own half of the
    cards (one host's cards standing in for two hosts), its mesh spans
    them, and the tally all-reduces between the processes."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: NCCL takes one card a process")
    half = torch.cuda.device_count() // 2

    def cards(rank):
        return {"CUDA_VISIBLE_DEVICES": ",".join(str(rank * half + i) for i in range(half))}

    _run_two_ranks(tmp_path, "cuda", cards)


# -- device names -------------------------------------------------------------------


@pytest.fixture
def fake_cards(monkeypatch):
    """torch.cuda as a host with `n` cards, current card 0, so that the
    stacks can be composed (not run) without a card."""

    def install(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.delenv("TENDERMINT_TPU_MESH_DEVICES", raising=False)

    built = []
    yield install, built
    for v in built:
        v.close()
    port_verifier._DEFAULTS.pop(torch.device("cuda", 0), None)
    port_hasher._DEFAULTS.pop(torch.device("cuda", 0), None)
    mesh_mod.set_default_mesh_manager(None, "cuda")


def test_resolve_device_names_a_card_with_its_index(fake_cards):
    install, _built = fake_cards
    install(2)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.device("cuda") != torch.device("cuda", 0)  # why the index matters


def test_one_card_has_one_default_stack(fake_cards):
    install, built = fake_cards
    install(1)
    v = port_verifier.default_verifier()
    built.append(v)
    assert port_verifier.default_verifier("cuda:0") is v
    assert port_verifier.default_verifier("cuda") is v
    assert type(v.inner.primary) is port_verifier.TableBatchVerifier and v.inner.mesh is None
    other = CoalescingVerifier(ResilientVerifier(port_verifier.HostBatchVerifier()))
    built.append(other)
    port_verifier.set_default_verifier(other, "cuda")
    assert port_verifier.default_verifier("cuda:0") is other
    assert port_verifier.default_verifier() is other
    h = port_hasher.default_hasher()
    assert port_hasher.default_hasher("cuda:0") is h and port_hasher.default_hasher("cuda") is h
    assert h.device == torch.device("cuda", 0) and h.mesh is None


def test_several_cards_compose_the_mesh_stack(fake_cards):
    install, built = fake_cards
    install(4)
    v = port_verifier.default_verifier()
    built.append(v)
    assert isinstance(v, CoalescingVerifier) and isinstance(v.inner, ResilientVerifier)
    assert isinstance(v.inner.primary, port_verifier.ShardedTableBatchVerifier)
    mesh = v.inner.primary.mesh
    assert mesh is mesh_mod.default_mesh_manager("cuda")
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert v.inner.primary.device == torch.device("cuda", 0)
    h = port_hasher.default_hasher()
    assert h.mesh is mesh and h.primary.mesh is mesh  # one health view for both lanes
