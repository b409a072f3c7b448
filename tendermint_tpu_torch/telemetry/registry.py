"""Dependency-free metrics registry: counters, gauges, histograms
(counterpart of `tendermint_tpu/telemetry/registry.py`, with its
Prometheus text exposition and JSON dump).

Metric families carry labels; one lock per family guards its children
and their values, since consensus, dispatch and coalescer threads all
write concurrently. Gauges may carry a callback (`set_function`)
evaluated at collect time. Histograms use fixed cumulative buckets;
`quantile()` interpolates within the winning bucket. `prometheus_text()`
renders format 0.0.4 and `to_dict()` the structured dump, byte for byte
as the JAX package's registry renders the same families.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Sequence

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


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Metric:
    """Family base: name, help, label names, children keyed by label
    values. Unlabeled families expose the child API directly."""

    type_name = "untyped"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        registry: "Registry | None" = None,
    ) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        # reentrant, so that `held_here` can tell whether this thread holds
        # it (a GC callback that records into a family runs on whatever
        # thread a collection starts on, maybe one inside this lock)
        self._lock = threading.RLock()
        self._children: dict[tuple[str, ...], object] = {}
        reg = registry if registry is not None else REGISTRY
        reg.register(self)
        if not self.labelnames:
            # the no-label child exists from birth so the family always
            # exposes a sample (scrapes see zeros, not absence)
            self._default = self._make_child(())
        else:
            self._default = None

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
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child(values)
            return child

    def samples(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return [(k, v.snapshot()) for k, v in self._children.items()]

    def held_here(self) -> bool:
        """Whether this thread holds the family's lock: inside one of its
        reads or updates."""
        return self._lock._is_owned()

    def sum_total(self) -> float:
        """Sum of all children's observation sums (histograms) or
        values (counters/gauges): a cheap read without building
        per-child bucket snapshots."""
        total = 0.0
        with self._lock:
            for c in self._children.values():
                s = getattr(c, "_sum", None)
                if s is None:
                    s = getattr(c, "_value", 0.0)
                total += s
        return float(total)

    # unlabeled convenience: family proxies to its default child
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
        self._fn: Callable[[], float] | None = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_function(self, fn: Callable[[], float] | None) -> None:
        """Collect-time callback; exceptions keep the last stored value
        (a scrape must never fail because a live view raced teardown)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            return self.snapshot()

    def snapshot(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                self._value = float(fn())
            except Exception:
                pass
        return self._value


class Gauge(_Metric):
    type_name = "gauge"
    CHILD = _GaugeChild

    def set(self, v: float) -> None:
        self._child0().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._child0().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._child0().dec(n)

    def set_function(self, fn: Callable[[], float] | None) -> None:
        self._child0().set_function(fn)

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
        # last exemplar attached to an observation (a trace id): JSON
        # dump only, text format 0.0.4 has no exemplars
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
        # caller holds the family lock (or tolerates a torn read via .value)
        cumulative = []
        running = 0
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

    def quantile(self, q: float) -> float:
        """Linear interpolation inside the winning bucket — standard
        Prometheus histogram_quantile() semantics."""
        snap = self.value
        if snap["count"] == 0:
            return float("nan")
        rank = q * snap["count"]
        prev_ub, prev_cum = 0.0, 0
        for ub, cum in snap["buckets"]:
            if cum >= rank:
                if ub == math.inf:
                    return prev_ub  # open-ended: best honest answer
                width = ub - prev_ub
                in_bucket = cum - prev_cum
                if in_bucket == 0:
                    return ub
                return prev_ub + width * (rank - prev_cum) / in_bucket
            prev_ub, prev_cum = ub, cum
        return prev_ub


class Histogram(_Metric):
    type_name = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = LATENCY_BUCKETS,
        registry: "Registry | None" = None,
    ) -> None:
        self._buckets = tuple(sorted(float(b) for b in buckets))
        if not self._buckets:
            raise ValueError("histogram needs at least one bucket")
        super().__init__(name, help, labelnames, registry)

    def _make_child(self, values: tuple[str, ...]):
        child = _HistogramChild(self._lock, self._buckets)
        self._children[values] = child
        return child

    def observe(self, v: float, exemplar: str | None = None) -> None:
        self._child0().observe(v, exemplar=exemplar)

    def quantile(self, q: float) -> float:
        return self._child0().quantile(q)

    @property
    def value(self) -> dict:
        return self._child0().value


class Registry:
    """Named metric families; collection renders every family even when
    a labeled one has no children yet (HELP/TYPE lines make the catalog
    discoverable from a scrape of an idle node)."""

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

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def prometheus_text(self) -> str:
        """Text exposition format 0.0.4 (`Content-Type: text/plain;
        version=0.0.4`)."""
        out: list[str] = []
        for m in self.metrics():
            out.append(f"# HELP {m.name} {_escape_help(m.help)}")
            out.append(f"# TYPE {m.name} {m.type_name}")
            for values, snap in m.samples():
                if m.type_name == "histogram":
                    for ub, cum in snap["buckets"]:
                        ls = _label_str(
                            m.labelnames + ("le",),
                            values + (_format_value(ub),),
                        )
                        out.append(f"{m.name}_bucket{ls} {cum}")
                    ls = _label_str(m.labelnames, values)
                    out.append(f"{m.name}_sum{ls} {_format_value(snap['sum'])}")
                    out.append(f"{m.name}_count{ls} {snap['count']}")
                else:
                    ls = _label_str(m.labelnames, values)
                    out.append(f"{m.name}{ls} {_format_value(snap)}")
        return "\n".join(out) + "\n"

    def to_dict(self) -> dict:
        """Structured dump (the JSON twin of `prometheus_text`)."""
        out: dict = {}
        for m in self.metrics():
            series = []
            for values, snap in m.samples():
                labels = dict(zip(m.labelnames, values))
                if m.type_name == "histogram":
                    entry = {
                        "labels": labels,
                        "sum": snap["sum"],
                        "count": snap["count"],
                        "buckets": [
                            ["+Inf" if ub == math.inf else ub, cum]
                            for ub, cum in snap["buckets"]
                        ],
                    }
                    if "exemplar" in snap:
                        entry["exemplar"] = snap["exemplar"]
                    series.append(entry)
                else:
                    series.append({"labels": labels, "value": snap})
            out[m.name] = {
                "type": m.type_name,
                "help": m.help,
                "series": series,
            }
        return out

    def counter_value(self, name: str, **labels) -> float:
        """Current value of a counter or gauge series (0.0 when the
        series does not exist yet: unobserved is zero)."""
        m = self.get(name)
        if m is None:
            return 0.0
        want = tuple(str(labels[n]) for n in m.labelnames) if labels else ()
        for values, snap in m.samples():
            if not labels and not m.labelnames:
                return float(snap)
            if values == want:
                return float(snap)
        return 0.0


# The port's process-wide registry: `telemetry/metrics.py` registers the
# catalog into it at import.
REGISTRY = Registry()
