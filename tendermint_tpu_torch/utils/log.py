"""Structured leveled logging with per-module levels (counterpart of
`tendermint_tpu/utils/log.py`).

Key-value lines (`KVFormatter`) under per-subsystem loggers, with levels
from a spec like "resilient:info,mesh:debug,*:error" (`setup_logging`).
The loggers live under the same `tendermint_tpu` root as the JAX
package's, so one spec, applied by either package's `setup_logging`,
covers both packages' services.
"""

from __future__ import annotations

import logging
import time

_ROOT = "tendermint_tpu"

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "none": logging.CRITICAL + 10,
}


class KVFormatter(logging.Formatter):
    """`ts=... level=... module=... msg="..." k=v` lines."""

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        module = record.name.removeprefix(_ROOT + ".")
        msg = record.getMessage().replace('"', "'")
        out = (
            f"ts={ts}.{int(record.msecs):03d} level={record.levelname.lower()} "
            f'module={module} msg="{msg}"'
        )
        extras = getattr(record, "kv", None)
        if extras:
            out += "".join(f" {k}={v}" for k, v in extras.items())
        return out


def logger(module: str) -> logging.Logger:
    """Subsystem logger, e.g. logger('resilient')."""
    return logging.getLogger(f"{_ROOT}.{module}")


def kv(log: logging.Logger, level: int, msg: str, **fields) -> None:
    """Structured emit: kv(log, logging.INFO, 'breaker closed', kind='verify')."""
    if log.isEnabledFor(level):
        log.log(level, msg, extra={"kv": fields})


def setup_logging(spec: str = "*:error", stream=None) -> None:
    """Apply a per-module level spec ("module:level,...,*:default")."""
    root = logging.getLogger(_ROOT)
    # replace handlers (idempotent re-setup, e.g. tests)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream)
    handler.setFormatter(KVFormatter())
    root.addHandler(handler)
    root.propagate = False

    default = logging.ERROR
    per_module: dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if ":" not in part:
            continue
        mod, _, level_name = part.partition(":")
        level = _LEVELS.get(level_name.strip().lower())
        if level is None:
            continue
        if mod.strip() == "*":
            default = level
        else:
            per_module[mod.strip()] = level
    root.setLevel(default)
    # reset levels from any previous spec, then apply the new one
    for name in list(logging.Logger.manager.loggerDict):
        if name.startswith(_ROOT + "."):
            logging.getLogger(name).setLevel(logging.NOTSET)
    for mod, level in per_module.items():
        logging.getLogger(f"{_ROOT}.{mod}").setLevel(level)
