"""The bookkeeping of `chip_smoke.py` and `tendermint_tpu_torch.abba`
that runs without a card: the hash bounds' instruction counts and the
refusal to compare kernel times measured by different means."""

from __future__ import annotations

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tendermint_tpu_torch import abba  # noqa: E402


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
