"""Span persistence (counterpart of `tendermint_tpu/telemetry/spanlog.py`):
a bounded JSONL ring. `SpanLog` appends every completed span as one JSON
line, compacting the file in place to the newest `capacity` spans
whenever it doubles past it (write amplification 2, no rotation files).
`persist_spans` replays a persisted window into a tracer, tagged
`restored: true`, then installs the log as one of its sinks.

No fsync per span: spans are forensic, a crash may lose the last lines.
"""

from __future__ import annotations

import json
import os
import threading

from tendermint_tpu_torch.telemetry.tracer import Span, Tracer
from tendermint_tpu_torch.utils import shutdown

DEFAULT_CAPACITY = 4096


class SpanLog:
    """Append-only JSONL span sink with in-place compaction."""

    def __init__(self, path: str, capacity: int = DEFAULT_CAPACITY) -> None:
        self.path = path
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._count = self._count_lines()
        self._fh = open(path, "a", encoding="utf-8")
        self._closed = False

    def _count_lines(self) -> int:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return sum(1 for _ in f)
        except OSError:
            return 0

    def load(self) -> list[dict]:
        """The newest `capacity` persisted spans (oldest first). Lines
        that fail to parse — a torn final write from a crash — are
        skipped, not fatal."""
        out: list[dict] = []
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            return out
        for line in lines[-self.capacity :]:
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if isinstance(d, dict) and "name" in d:
                out.append(d)
        return out

    def append(self, span: Span) -> None:
        if self._closed:
            return
        line = json.dumps(span.to_dict(), separators=(",", ":"))
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            self._count += 1
            if self._count > 2 * self.capacity:
                self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite the file to its newest `capacity` lines via a temp
        file + atomic rename (a crash mid-compaction leaves either the
        old ring or the new one, never a torn file)."""
        self._fh.close()
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                tail = f.readlines()[-self.capacity :]
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.writelines(tail)
            os.replace(tmp, self.path)
            self._count = len(tail)
        finally:
            self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            self._closed = True
            try:
                self._fh.close()
            except OSError:
                pass


def persist_spans(
    tracer: Tracer, path: str, capacity: int = DEFAULT_CAPACITY
) -> SpanLog:
    """Replay the persisted window into `tracer` (attr `restored: true`
    marks earlier spans) and THEN install the log as one of the
    tracer's sinks: replay must not re-append what the file holds. The
    file closes at interpreter exit (`utils/shutdown.py`)."""
    log = SpanLog(path, capacity=capacity)
    for d in log.load():
        attrs = dict(d.get("attrs") or {})
        attrs.setdefault("restored", True)
        try:
            tracer.add(d["name"], float(d["start"]), float(d["end"]), **attrs)
        except Exception:
            continue
    tracer.add_sink(log.append)
    shutdown.at_exit(log.close)
    return log
