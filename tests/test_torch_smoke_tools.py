"""The bookkeeping of `chip_smoke.py` and `tendermint_tpu_torch.abba`
that runs without a card: the hash bounds' instruction counts, the
refusal to compare kernel times measured by different means, and the
profiler sessions that are run again when they recorded no device
activity (with a stand-in for torch.profiler)."""

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
