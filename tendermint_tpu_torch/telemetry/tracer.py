"""Span tracer (counterpart of `tendermint_tpu/telemetry/tracer.py`): a
bounded ring of completed spans (name, wall-clock start/end,
attributes), cheap enough to leave on. The port records the device
path's spans: `dispatch.launch` (a traced handle's submit -> launch
end) and `batcher.flush` (a coalesced launch's oldest traced request ->
its flush). Spans carrying a `trace` attribute (a `tracectx` trace id)
stitch across nodes and against the launch ledger's records. Every span
name recorded with a literal is registered in `telemetry/metrics.py`'s
SPAN_CATALOG.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field


def _snapshot_attrs(attrs: dict) -> dict:
    """Copy `attrs` tolerating concurrent writers: a traced path may
    hand its attrs dict to another thread (callers add attrs mid-span),
    and a resize during the copy raises RuntimeError — retry, and never
    let the snapshot kill the traced path."""
    for _ in range(4):
        try:
            return dict(attrs)
        except RuntimeError:
            continue
    return {}


@dataclass
class Span:
    name: str
    start: float  # time.time() epoch seconds
    end: float
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> dict:
        # attrs are COPIED: a reader serializing the dict must never
        # observe (or publish) a later writer's mutation
        return {
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration_s": self.duration,
            **({"attrs": dict(self.attrs)} if self.attrs else {}),
        }


class Tracer:
    """Bounded ring of completed spans; thread-safe. Optional sink
    callbacks observe every completed span (the JSONL span log persists
    them, `telemetry/spanlog.py`); several sinks may be installed. Sink
    errors are swallowed: recording must never fail the traced path."""

    def __init__(self, capacity: int = 1024) -> None:
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=capacity)
        self._sinks: tuple = ()

    def add_sink(self, fn) -> None:
        """Attach `fn(span)` as an additional completion sink."""
        with self._lock:
            if fn not in self._sinks:
                self._sinks = self._sinks + (fn,)

    def remove_sink(self, fn) -> None:
        """Detach one sink; other sinks (a successor node's span log)
        stay installed. Equality, not identity: bound methods are a new
        object per attribute access, so `log.append` must still match."""
        with self._lock:
            self._sinks = tuple(s for s in self._sinks if s != fn)

    def set_sink(self, fn) -> None:
        """Legacy single-sink API: replace ALL sinks with `fn` (None
        clears)."""
        with self._lock:
            self._sinks = () if fn is None else (fn,)

    def clear_sink(self, fn) -> None:
        """Remove the sink only if `fn` is an installed one — a
        stopping node must not strip a successor's sink."""
        self.remove_sink(fn)

    def add(self, name: str, start: float, end: float, **attrs) -> Span:
        span = Span(name, start, end, attrs)
        with self._lock:
            self._spans.append(span)
            sinks = self._sinks
        for sink in sinks:
            try:
                sink(span)
            except Exception:
                pass
        return span

    @contextmanager
    def span(self, name: str, **attrs):
        """`with TRACER.span("mempool.admission", n=512): ...` — the span
        recorded on exit, errors included (attr `error` is set). The
        attrs are SNAPSHOT at completion: the yielded dict may keep
        being mutated (even from another thread) without racing the
        recorded span or its readers."""
        t0 = time.time()
        try:
            yield attrs  # callers may add attrs mid-span
        except BaseException as e:
            attrs["error"] = f"{type(e).__name__}"
            raise
        finally:
            self.add(name, t0, time.time(), **_snapshot_attrs(attrs))

    def recent(self, n: int | None = None, prefix: str = "") -> list[dict]:
        with self._lock:
            spans = list(self._spans)
        if prefix:
            spans = [s for s in spans if s.name.startswith(prefix)]
        if n is not None:
            spans = spans[-n:]
        return [s.to_dict() for s in spans]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


# Process-wide tracer.
TRACER = Tracer(capacity=1024)
