"""Jittered exponential backoff (counterpart of
`tendermint_tpu/utils/backoff.py`): the resilient dispatch's in-call
retries."""

from __future__ import annotations

import random


def backoff_delay(attempt: int, base: float, cap: float = 30.0) -> float:
    """Delay for the given 0-indexed attempt: min(base * 2^attempt, cap)
    with up to +30% jitter so synchronized retriers fan out."""
    return min(base * (2**attempt), cap) * (1.0 + 0.3 * random.random())
