"""The bookkeeping of `chip_smoke.py` and `tendermint_tpu_torch.abba`
that runs without a card: the hash bounds' instruction counts, the
refusal to compare kernel times measured by different means, the
profiler sessions that are run again when they recorded no device
activity (with a stand-in for torch.profiler), and the node phase's
accounts: a node's launch-ledger records read as kernel launches, a
node process's counts hook (its wrappers' counts and its timers at
exit), a height ledger's split and the run's phase clock."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch
from torch.autograd import DeviceType

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tendermint_tpu_torch import abba, profiler_drops  # noqa: E402
from tendermint_tpu_torch.testing import time_limit_fixture

# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))


def test_sha256_folded_counts_a_run_time_block_as_the_full_compression():
    assert chip_smoke.sha256_folded([None] * 16) == chip_smoke.INSTR_PER_COMPRESSION["sha256"]


def test_sha256_folded_counts_only_the_rounds_for_a_constant_block():
    # every schedule step folds; the 64 rounds and 8 additions remain
    assert chip_smoke.sha256_folded(list(range(16))) == (64 * 10, 64 * 14 + 8)


def test_sha256_inner_node_counts_the_constant_block_as_folded():
    full = chip_smoke.INSTR_PER_COMPRESSION["sha256"]
    second = chip_smoke.sha256_folded([None] + [0] * 14 + [65 * 8])
    assert all(s < f for s, f in zip(second, full))
    assert chip_smoke.INSTR_PER_SHA256_INNER_NODE == tuple(f + s + 18 for f, s in zip(full, second))


@pytest.mark.parametrize(
    "before_by, after_by, mismatch",
    [
        (None, "events", []),  # a row without `ms_by` was timed by events
        (None, "profiler", ["ladder"]),
        ("profiler", "profiler", []),
    ],
)
def test_abba_refuses_kernel_times_measured_by_different_means(before_by, after_by, mismatch):
    def report(by, extra=()):
        row = {"name": "ladder", "ms": 1.0, "bound_ms": 0.1, "plain_ms": 9.0, "launches": 1, "max_abs_err": 0}
        if by is not None:
            row["ms_by"] = by
        rows = [row] + [dict(row, name=n, ms_by="profiler") for n in extra]
        return {"kernels": rows}

    before = abba.summary(report(before_by))
    after = abba.summary(report(after_by, extra=("sha256_masked",)))
    assert abba.timing_mismatch(before, after) == mismatch


class _Event:
    def __init__(self, device_type):
        self.device_type = device_type
        self.key = "sha256_masked_kernel"
        self.count = 1
        self.self_device_time_total = 30.0


def _fake_profiler(monkeypatch, sessions):
    """torch.profiler.profile replaced by sessions that record, in turn,
    the device types listed in `sessions`."""
    queue = list(sessions)

    class Profile:
        def __init__(self, **_kw):
            self.events = [_Event(t) for t in queue.pop(0)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "LOST_SESSIONS", [0])
    return queue


def test_profiled_runs_a_session_that_recorded_no_device_activity_again(monkeypatch):
    left = _fake_profiler(monkeypatch, [[DeviceType.CPU], [DeviceType.CPU, DeviceType.CUDA], []])
    calls = []
    events = chip_smoke.profiled(lambda: calls.append(1))
    assert [e.device_type for e in events] == [DeviceType.CPU, DeviceType.CUDA]
    assert len(calls) == 2 and chip_smoke.LOST_SESSIONS == [1] and left == [[]]


def test_profiled_raises_when_every_session_lost_its_device_activity(monkeypatch):
    _fake_profiler(monkeypatch, [[DeviceType.CPU]] * chip_smoke.PROFILE_TRIES)
    with pytest.raises(AssertionError, match="no device activity"):
        chip_smoke.profiled(lambda: None)
    assert chip_smoke.LOST_SESSIONS == [chip_smoke.PROFILE_TRIES]


def test_kernel_ms_still_refuses_a_session_that_missed_launches(monkeypatch):
    # a session with device activity but two of five launches is not redone
    _fake_profiler(monkeypatch, [[DeviceType.CUDA] * 2])
    with pytest.raises(AssertionError, match="saw 2 launches"):
        chip_smoke.kernel_ms(lambda: None, "sha256_masked_kernel", 5)


def test_profiler_drops_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler_drops.main(["1"]) == 2


def _rec(kind, rows, backend="tables", **extra):
    return {"kind": kind, "rows": rows, "backend": backend, **extra}


def test_ledger_kernels_reads_each_record_as_its_kernel():
    from tendermint_tpu_torch.ops.ed25519_tables import FUSED_MIN_STACK

    records = [
        _rec("tables", 1000),  # one commit of 1,000: the entries chain
        _rec("tables", FUSED_MIN_STACK * 1000),  # a window of FUSED_MIN_STACK commits: fused
        _rec("tables", (FUSED_MIN_STACK - 1) * 1000),
        _rec("verify", 8, backend="device"),
        _rec("verify", 8, backend="device", mesh_width=2),  # a launch a shard
        _rec("verify", 3, backend="host"),  # the host answered: no launch
        _rec("tables", 1000, error="InjectedDeviceFault"),
    ]
    got = chip_smoke.ledger_kernels(records, 1000)
    assert got == dict(dict.fromkeys(chip_smoke.WRAPPERS, 0), madd_chain_entries=2, madd_chain_fused=1, ladder=3,
                       finish_encode_compare=6)
    with pytest.raises(AssertionError, match="hash record"):
        chip_smoke.ledger_kernels([_rec("hash", 9000, backend="device")], 1000)


def test_node_account_holds_counts_less_the_warm_up_to_the_ledger():
    zero = dict.fromkeys(chip_smoke.WRAPPERS, 0)
    warm = dict(zero, madd_chain_entries=1, madd_chain_fused=1, ladder=1, finish_encode_compare=3)
    got = dict(zero, madd_chain_entries=2, madd_chain_fused=1, ladder=1, finish_encode_compare=4)
    assert chip_smoke.node_account("n", got, warm, [_rec("tables", 4)], 4) == dict(
        zero, madd_chain_entries=1, finish_encode_compare=1)
    with pytest.raises(AssertionError, match="account for"):
        chip_smoke.node_account("n", got, warm, [], 4)
    with pytest.raises(AssertionError, match="with an error"):
        chip_smoke.node_account("n", warm, warm, [_rec("tables", 4, error="X")], 4)


def test_counts_hook_writes_the_wrappers_counts_and_the_timers(tmp_path):
    """A process with the hook first on its path: its wrappers' counts
    and the timed methods' seconds land in the file its environment
    names, and the interpreter's own sitecustomize still runs."""
    import json
    import os
    import subprocess

    hook = tmp_path / "hook"
    hook.mkdir()
    chip_smoke.write_counts_hook(hook)
    shadowed = tmp_path / "shadowed"
    shadowed.mkdir()
    (shadowed / "sitecustomize.py").write_text("import builtins\nbuiltins.SHADOWED_RAN = True\n")
    out = tmp_path / "counts.json"
    code = (
        "import builtins\n"
        "assert builtins.SHADOWED_RAN\n"
        "from tendermint_tpu_torch.ops import ed25519_tables as t\n"
        "from tendermint_tpu_torch.consensus.replay import Handshaker\n"
        "from tendermint_tpu_torch.node.node import Node\n"
        "t.sum_entries.launches = 3\n"
        "assert Handshaker.handshake.__name__ == 'timed' and Node.start.__name__ == 'timed'\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(hook), str(shadowed), str(REPO)]))
    env[chip_smoke.NODE_COUNTS_ENV] = str(out)
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    doc = json.loads(out.read_text())
    assert doc["counts"] == dict(dict.fromkeys(chip_smoke.WRAPPERS, 0), madd_chain_entries=3)
    assert doc["seconds"] == {}  # nothing timed ran
    # a timed call records its seconds and its wall-clock end
    code = ("import time\nfrom tendermint_tpu_torch.consensus.replay import Handshaker\n"
            "t0 = time.time()\n"
            "try:\n    Handshaker.handshake(None, None)\nexcept AttributeError:\n    pass\n")
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    ((secs, end),) = json.loads(out.read_text())["seconds"]["handshake_s"]
    assert 0 <= secs < 5 and abs(end - __import__("time").time()) < 60
    # the end of a MARKS call (the warm-up) leaves its mark beside the file
    mark = pathlib.Path(str(out) + ".warm_first_use_s")
    assert not mark.exists()
    code = ("from tendermint_tpu_torch.services.verifier import TableBatchVerifier\n"
            "try:\n    TableBatchVerifier._first_use(None)\nexcept AttributeError:\n    pass\n")
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert mark.exists() and "warm_first_use_s" in json.loads(out.read_text())["seconds"]


def test_height_split_reads_the_height_ledger(tmp_path):
    import json

    (tmp_path / "data").mkdir()
    recs = [{"height": h, "round": int(h == 3), "height_s": float(h), "critical_path": "proposal_wait",
             "phases": {"new_height": {"s": 1.0}, "propose": {"s": 0.1 * h}}} for h in range(1, 6)]
    (tmp_path / "data" / "heights.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    got = chip_smoke.height_split(tmp_path, 2, 4)
    assert got["heights"] == 3 and got["height_s_median"] == 3.0
    assert got["phase_s_median"] == {"new_height": 1.0, "propose": pytest.approx(0.3)}
    assert got["slowest"] == (4, 4.0, "proposal_wait") and got["rounds_past_0"] == 1
    assert got["critical_path"] == {"proposal_wait": 3}
    assert chip_smoke.height_split(tmp_path, 9, 9) == {"heights": 0}


def test_phase_clock_charges_each_phase_until_the_next_mark(monkeypatch):
    ticks = iter([0.0, 1.0, 3.0, 6.0, 10.0])
    monkeypatch.setattr(chip_smoke.time, "perf_counter", lambda: next(ticks))
    clock = chip_smoke.PhaseClock()
    clock.mark("0")
    clock.mark("2")
    clock.mark("0")
    assert clock.done() == {"0": 2.0 + 4.0, "2": 3.0}
