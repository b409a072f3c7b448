"""Trace contexts: a cluster-wide identity for one traced piece of work
(counterpart of `tendermint_tpu/telemetry/tracectx.py`, same wire block,
sampling knob and thread-ambient slot).

A `TraceContext` is minted head-based at the edge of the system and
rides along two channels:

* **the wire** — `encode_wire()` / `decode_wire()`, byte for byte the
  JAX package's trailing block (version uvarint, 8-byte trace id, 8-byte
  parent span id, length-prefixed origin), so a context encoded by one
  package decodes in the other;
* **the thread** — a thread-ambient slot (`use()` / `current()`): the
  dispatch handle captures the submitting thread's context and records
  its `dispatch.launch` span against it, and the coalescer launches a
  merged batch under the context of its oldest traced request.

Sampling is decided once at mint: `TENDERMINT_TPU_TRACE_SAMPLE` holds
the 1-in-N rate (default 64; 0 disables minting; 1 samples everything).
Breaker transitions and mesh shard faults `boost()` a temporary
sample-everything window; `force_all(True)` samples everything until
turned off.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from tendermint_tpu_torch.codec import Reader, Writer

SAMPLE_ENV = "TENDERMINT_TPU_TRACE_SAMPLE"
DEFAULT_SAMPLE = 64

# wire-block version tag: a future layout bumps it and old nodes drop
# the (still well-framed) block instead of misparsing it
_WIRE_VERSION = 1

_ID_BYTES = 8


@dataclass(frozen=True)
class TraceContext:
    """(trace_id, parent span_id, origin node_id) of one traced message.
    Immutable: hops re-parent via `rehop()`."""

    trace_id: bytes
    span_id: bytes
    origin: str

    @property
    def trace(self) -> str:
        """Hex trace id: the attr value every stitched span carries."""
        return self.trace_id.hex()

    def rehop(self) -> "TraceContext":
        """Fresh parent span id for the next hop; trace/origin stay."""
        return TraceContext(self.trace_id, os.urandom(_ID_BYTES), self.origin)

    def encode_wire(self) -> bytes:
        return (
            Writer()
            .uvarint(_WIRE_VERSION)
            .raw(self.trace_id[:_ID_BYTES].ljust(_ID_BYTES, b"\x00"))
            .raw(self.span_id[:_ID_BYTES].ljust(_ID_BYTES, b"\x00"))
            .string(self.origin)
            .build()
        )

    @classmethod
    def decode_wire(cls, r) -> "TraceContext":
        """Decode from a `Reader` over the block (or raw bytes)."""
        if isinstance(r, (bytes, bytearray)):
            r = Reader(r)
        version = r.uvarint()
        if version != _WIRE_VERSION:
            raise ValueError(f"unknown trace-context version {version}")
        trace_id = r.raw(_ID_BYTES)
        span_id = r.raw(_ID_BYTES)
        origin = r.string()
        return cls(trace_id, span_id, origin)


# -- sampling -----------------------------------------------------------------

_counter = itertools.count()
_force_all = False
_boost_until = 0.0
_boost_lock = threading.Lock()


def sample_rate() -> int:
    """1-in-N mint rate (0 = tracing off), read per mint."""
    try:
        return int(os.environ.get(SAMPLE_ENV, str(DEFAULT_SAMPLE)))
    except ValueError:
        return DEFAULT_SAMPLE


def force_all(on: bool) -> None:
    """Sample everything until turned off."""
    global _force_all
    _force_all = on


def boost(duration_s: float = 30.0) -> None:
    """Sample everything for `duration_s`: called on breaker transitions
    and mesh shard faults, when per-message attribution pays."""
    global _boost_until
    with _boost_lock:
        _boost_until = max(_boost_until, time.monotonic() + duration_s)


def sampling_forced() -> bool:
    return _force_all or time.monotonic() < _boost_until


def mint(origin: str = "") -> TraceContext | None:
    """Head-based sampling decision + context creation; None when this
    message is not sampled (callers then attach nothing)."""
    if not sampling_forced():
        rate = sample_rate()
        if rate <= 0:
            return None
        if rate > 1 and next(_counter) % rate:
            return None
    from tendermint_tpu_torch.telemetry import metrics as _metrics

    _metrics.TRACE_SAMPLED.inc()
    return TraceContext(os.urandom(_ID_BYTES), os.urandom(_ID_BYTES), origin)


# -- thread-ambient propagation ----------------------------------------------

_tls = threading.local()


def current() -> TraceContext | None:
    """The context ambient on this thread (None = untraced work)."""
    return getattr(_tls, "ctx", None)


@contextmanager
def use(ctx: TraceContext | None):
    """Install `ctx` as this thread's ambient context for the scope
    (None explicitly clears it)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev
