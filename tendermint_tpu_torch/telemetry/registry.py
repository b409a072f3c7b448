"""Dependency-free metrics registry: counters, gauges, histograms
(counterpart of `tendermint_tpu/telemetry/registry.py`, without its
Prometheus and JSON exposition).

Metric families carry labels; one lock per family guards its children
and their values, since consensus, dispatch and coalescer threads all
write concurrently. Histograms use fixed cumulative buckets.
"""

from __future__ import annotations

import math
import threading
from typing import Sequence

# Latency buckets: 100 us floor to 30 s, roughly x2.5 per step.
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# Batch-size buckets: powers of two up to the 65k bench shapes.
SIZE_BUCKETS = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
    1024.0, 2048.0, 4096.0, 8192.0, 16384.0, 65536.0,
)


class _Metric:
    """Family base: name, help, label names, children keyed by label
    values. Unlabeled families expose the child API directly."""

    type_name = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        REGISTRY.register(self)
        # the no-label child exists from birth so the family always has
        # a sample (reads see zeros, not absence)
        self._default = None if self.labelnames else self._make_child(())

    def _make_child(self, values: tuple[str, ...]):
        child = self.CHILD(self._lock)
        self._children[values] = child
        return child

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass labels positionally or by name, not both")
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child(values)
            return child

    def samples(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return [(k, v.snapshot()) for k, v in self._children.items()]

    def _child0(self):
        if self._default is None:
            raise ValueError(f"{self.name} has labels {self.labelnames}; use .labels()")
        return self._default


class _CounterChild:
    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self._value  # caller holds the family lock


class Counter(_Metric):
    type_name = "counter"
    CHILD = _CounterChild

    def inc(self, n: float = 1.0) -> None:
        self._child0().inc(n)

    @property
    def value(self) -> float:
        return self._child0().value


class _GaugeChild:
    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self._value


class Gauge(_Metric):
    type_name = "gauge"
    CHILD = _GaugeChild

    def set(self, v: float) -> None:
        self._child0().set(v)

    @property
    def value(self) -> float:
        return self._child0().value


class _HistogramChild:
    def __init__(self, lock: threading.Lock, buckets: tuple[float, ...]) -> None:
        self._lock = lock
        self.buckets = buckets  # upper bounds, +Inf implicit
        self._counts = [0] * (len(buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._exemplar: str | None = None

    def observe(self, v: float, exemplar: str | None = None) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            if exemplar is not None:
                self._exemplar = str(exemplar)
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> dict:
        cumulative, running = [], 0
        for c in self._counts:
            running += c
            cumulative.append(running)
        out = {
            "buckets": list(zip(list(self.buckets) + [math.inf], cumulative)),
            "sum": self._sum,
            "count": self._count,
        }
        if self._exemplar is not None:
            out["exemplar"] = self._exemplar
        return out

    @property
    def value(self) -> dict:
        with self._lock:
            return self.snapshot()


class Histogram(_Metric):
    type_name = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = LATENCY_BUCKETS,
    ) -> None:
        self._buckets = tuple(sorted(float(b) for b in buckets))
        if not self._buckets:
            raise ValueError("histogram needs at least one bucket")
        super().__init__(name, help, labelnames)

    def _make_child(self, values: tuple[str, ...]):
        child = _HistogramChild(self._lock, self._buckets)
        self._children[values] = child
        return child

    def observe(self, v: float, exemplar: str | None = None) -> None:
        self._child0().observe(v, exemplar=exemplar)

    @property
    def value(self) -> dict:
        return self._child0().value


class Registry:
    """Named metric families."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: "dict[str, _Metric]" = {}

    def register(self, metric: _Metric) -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                raise ValueError(f"metric {metric.name} already registered")
            self._metrics[metric.name] = metric

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def counter_value(self, name: str, **labels) -> float:
        """Current value of a counter or gauge series (0.0 when the
        series does not exist yet: unobserved is zero)."""
        m = self.get(name)
        if m is None:
            return 0.0
        want = tuple(str(labels[n]) for n in m.labelnames) if labels else ()
        for values, snap in m.samples():
            if values == want:
                return float(snap)
        return 0.0


# The port's process-wide registry: `telemetry/metrics.py` registers the
# catalog into it at import.
REGISTRY = Registry()
