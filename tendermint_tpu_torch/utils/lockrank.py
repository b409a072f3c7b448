"""Lock construction for the verify spine (counterpart of
`tendermint_tpu/utils/lockrank.py`'s `ranked_lock`).

The JAX package hands out rank-checked locks when its sanitizer
(`TENDERMINT_TPU_LOCKRANK`) or its lock profiler
(`TENDERMINT_TPU_PROFILE_HZ`) is on, and plain `threading` locks
otherwise. Neither is ported yet, so here a knob that asks for one
raises instead of being ignored; without them the locks are plain.
"""

from __future__ import annotations

import os
import threading

_ENV = "TENDERMINT_TPU_LOCKRANK"
_ENV_PROFILE = "TENDERMINT_TPU_PROFILE_HZ"


def _check_knobs(name: str) -> None:
    if os.environ.get(_ENV, "0") not in ("", "0"):
        raise NotImplementedError(
            f"lock {name!r}: the lock-rank sanitizer ({_ENV}) is not ported "
            f"to tendermint_tpu_torch; unset it or set it to 0"
        )
    if os.environ.get(_ENV_PROFILE) is not None:
        raise NotImplementedError(
            f"lock {name!r}: the lock profiler ({_ENV_PROFILE}) is not ported "
            f"to tendermint_tpu_torch; unset it"
        )


def ranked_lock(name: str):
    """A plain `threading.Lock` for the lock called `name`."""
    _check_knobs(name)
    return threading.Lock()
