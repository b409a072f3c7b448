"""Process-level resource telemetry: RSS, fds, threads, GC pauses.

The whole-node observability floor under the contention observatory
(`telemetry/profiler.py`): before attributing time between subsystems,
an operator needs to know whether the *process* is healthy — resident
set growth, fd leaks, thread-count creep, and the stop-the-world GC
pauses that show up in consensus latency tails without any lock or
queue being at fault.

Exported through the catalog (`telemetry/metrics.py`):

* ``tendermint_process_rss_bytes`` / ``_open_fds`` / ``_threads`` —
  callback gauges read at scrape time only (`/proc/self` on Linux,
  `resource.getrusage` fallback elsewhere); idle cost is zero.
* ``tendermint_process_gc_pause_seconds`` +
  ``tendermint_process_gc_collections_total{gen}`` — a `gc.callbacks`
  hook stamps `perf_counter` across each collection. CPython invokes
  the callbacks on whichever thread triggered the collection, start
  and stop paired on that thread, and collections never overlap, so a
  single module-global stamp is race-free. Installed idempotently by
  ``install_gc_telemetry()`` (node start / tests), ~100 ns per
  collection when installed.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from collections import deque

_PAGE_SIZE = 4096
try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):  # pragma: no cover - exotic libc
    pass


def rss_bytes() -> float:
    """Resident set size. `/proc/self/statm` field 2 on Linux; the
    `ru_maxrss` high-water mark (kB) as the best-effort fallback."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return float(int(f.read().split()[1]) * _PAGE_SIZE)
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    except Exception:
        return 0.0


def open_fds() -> float:
    """Open file descriptors (sockets, WAL handles, device fds)."""
    try:
        return float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return 0.0


def thread_count() -> float:
    return float(threading.active_count())


# -- GC pause timing ----------------------------------------------------------

_installed = False
_install_lock = threading.Lock()
_gc_started_at: float | None = None
# (generation, pause seconds or None) of collections not yet recorded
_gc_pending: deque = deque()


def _gc_callback(phase: str, info: dict) -> None:
    global _gc_started_at
    if phase == "start":
        _gc_started_at = time.perf_counter()
        return
    started = _gc_started_at
    _gc_started_at = None
    from tendermint_tpu_torch.telemetry import metrics as _m

    _gc_pending.append(
        (str(info.get("generation", "?")), None if started is None else time.perf_counter() - started)
    )
    # a collection starts on whatever thread allocates, maybe one inside a
    # read of these very families with their lock held, which it would
    # wait for forever: such a collection is recorded with the next one
    if _m.PROCESS_GC_COLLECTIONS.held_here() or _m.PROCESS_GC_PAUSE.held_here():
        return
    while _gc_pending:
        gen, pause = _gc_pending.popleft()
        _m.PROCESS_GC_COLLECTIONS.labels(gen=gen).inc()
        if pause is not None:
            _m.PROCESS_GC_PAUSE.observe(pause)


def install_gc_telemetry() -> bool:
    """Idempotently hook `gc.callbacks`; returns True when the hook is
    (now) installed. Never uninstalled — the hook is process-lifetime
    cheap and a second install is a no-op."""
    global _installed
    with _install_lock:
        if _installed:
            return True
        gc.callbacks.append(_gc_callback)
        _installed = True
        return True
