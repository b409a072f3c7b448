"""Flight recorder (counterpart of `tendermint_tpu/telemetry/flightrec.py`):
a bounded in-memory ring of structured events — coalescer flushes,
dispatch launches, breaker transitions, mesh shard faults and restores —
cheap enough to record unconditionally, that atomically dumps to a
directory when something breaks or an operator sends `SIGUSR2`.

A dump carries the event ring, the last 32 height-ledger records
(`telemetry/heightlog.py`) and the last 32 launch-ledger records
(`telemetry/launchlog.py`) under the JAX package's dump layout. Dumps
are tmp-file + `os.replace` atomic.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """Bounded, thread-safe event ring with atomic JSON dumps."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._lock = threading.Lock()
        self._events: "deque[dict]" = deque(maxlen=max(1, capacity))
        self._dump_dir: str | None = None
        self._node_id = ""
        self._dump_seq = 0

    # -- wiring -------------------------------------------------------------

    def set_dump_dir(self, path: str) -> None:
        self._dump_dir = path

    def set_node_id(self, node_id: str) -> None:
        self._node_id = node_id

    # -- recording ----------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one structured event; must never fail the caller."""
        try:
            evt = {"t": time.time(), "kind": kind}
            evt.update(fields)
            with self._lock:
                self._events.append(evt)
        except Exception:
            pass

    def recent(
        self, n: int | None = None, kind: str = "", height: int | None = None
    ) -> list[dict]:
        with self._lock:
            events = list(self._events)
        if kind:
            events = [e for e in events if e.get("kind") == kind]
        if height is not None:
            events = [e for e in events if e.get("height") == height]
        if n is not None:
            events = events[-n:]
        return events

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- dumping -------------------------------------------------------------

    def dump(self, reason: str = "manual", dir: str | None = None) -> str | None:
        """Atomically write the ring as JSON under `dir` (or the wired
        dump dir); returns the path, or None when nowhere to write.
        Never raises — a broken disk must not mask the original fault."""
        target = dir or self._dump_dir
        if not target:
            return None
        try:
            os.makedirs(target, exist_ok=True)
            # the last K height-ledger records ride every dump: the
            # post-mortem's "which heights led into this, and where did
            # their time go" (telemetry/heightlog.py; lazy import — the
            # ledger imports the metric catalog, not this module)
            try:
                from tendermint_tpu_torch.telemetry import heightlog

                heights = heightlog.recent_records(32)
            except Exception:
                heights = []
            # the last K launch records: which launches led into this,
            # and where their time went
            try:
                from tendermint_tpu_torch.telemetry import launchlog

                launches = launchlog.LAUNCHLOG.recent(32)
            except Exception:
                launches = []
            with self._lock:
                events = list(self._events)
                self._dump_seq += 1
                seq = self._dump_seq
            safe_reason = "".join(
                c if c.isalnum() or c in "-_" else "-" for c in reason
            )[:48]
            path = os.path.join(target, f"flightrec-{safe_reason}-{seq}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "node": self._node_id,
                        "reason": reason,
                        "dumped_at": time.time(),
                        "events": events,
                        "heights": heights,
                        "launches": launches,
                    },
                    f,
                    separators=(",", ":"),
                )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return path
        except Exception:
            return None

    @staticmethod
    def load(path: str) -> dict:
        """Parse a dump file."""
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)


# Process-wide recorder, mirroring REGISTRY/TRACER conventions.
FLIGHT = FlightRecorder()

_signal_installed = False


def install_signal_dump() -> bool:
    """Arm `SIGUSR2` -> `FLIGHT.dump("sigusr2")`: the operator's switch
    to snapshot the black box of a live process. Safe to call more than
    once; returns False where signals can't be installed (non-main
    thread, platforms without SIGUSR2)."""
    global _signal_installed
    if _signal_installed:
        return True
    import signal

    if not hasattr(signal, "SIGUSR2"):
        return False
    try:
        signal.signal(signal.SIGUSR2, lambda *_args: FLIGHT.dump("sigusr2"))
    except ValueError:  # not the main thread
        return False
    _signal_installed = True
    return True
