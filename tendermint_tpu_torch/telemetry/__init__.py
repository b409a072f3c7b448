"""Telemetry of the port's device plane: the metric registry and its
catalog (`metrics.py`), the span tracer and its JSONL span log, trace
contexts (`tracectx.py`), the flight recorder (`flightrec.py`), the
per-launch ledger (`launchlog.py`) and the consensus height ledger
(`heightlog.py`, exported lazily as `HeightLedger`).

Counterpart of the device-plane pieces of `tendermint_tpu/telemetry/`,
under the same metric names, label sets, span names, record fields and
file formats; the port keeps its own process-wide REGISTRY, TRACER,
FLIGHT and LAUNCHLOG. Import-cheap and dependency-free.
"""

from tendermint_tpu_torch.telemetry.registry import (
    LATENCY_BUCKETS,
    REGISTRY,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from tendermint_tpu_torch.telemetry.tracer import TRACER, Span, Tracer

__all__ = [
    "Counter",
    "FLIGHT",
    "FlightRecorder",
    "Gauge",
    "HeightLedger",
    "Histogram",
    "Registry",
    "REGISTRY",
    "Span",
    "SpanLog",
    "TraceContext",
    "Tracer",
    "TRACER",
    "LATENCY_BUCKETS",
    "SIZE_BUCKETS",
    "persist_spans",
]


def __getattr__(name: str):
    # spanlog/flightrec/tracectx lazily: they touch the filesystem or
    # os.urandom, and most importers only want the registry/tracer
    if name in ("SpanLog", "persist_spans"):
        from tendermint_tpu_torch.telemetry import spanlog

        return getattr(spanlog, name)
    if name in ("FLIGHT", "FlightRecorder"):
        from tendermint_tpu_torch.telemetry import flightrec

        return getattr(flightrec, name)
    if name == "TraceContext":
        from tendermint_tpu_torch.telemetry import tracectx

        return tracectx.TraceContext
    if name == "HeightLedger":
        from tendermint_tpu_torch.telemetry import heightlog

        return heightlog.HeightLedger
    raise AttributeError(name)
