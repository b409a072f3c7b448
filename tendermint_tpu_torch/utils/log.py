"""Structured key-value logging (counterpart of
`tendermint_tpu/utils/log.py`).

Key-value records under per-subsystem loggers. The loggers live under
the same `tendermint_tpu` root as the JAX package's, so the JAX
package's `setup_logging` spec covers both packages' services.
"""

from __future__ import annotations

import logging

_ROOT = "tendermint_tpu"


def logger(module: str) -> logging.Logger:
    """Subsystem logger, e.g. logger('resilient')."""
    return logging.getLogger(f"{_ROOT}.{module}")


def kv(log: logging.Logger, level: int, msg: str, **fields) -> None:
    """Structured emit: kv(log, logging.INFO, 'breaker closed', kind='verify')."""
    if log.isEnabledFor(level):
        log.log(level, msg, extra={"kv": fields})
