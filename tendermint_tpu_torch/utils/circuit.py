"""Circuit breaker for device-backend dispatch (counterpart of
`tendermint_tpu/utils/circuit.py`).

The classic three-state machine: CLOSED (healthy, calls flow to the
primary), OPEN (N consecutive failures tripped it — calls route to the
fallback until a reset timeout elapses), HALF_OPEN (timeout elapsed —
exactly one probe call is let through; success re-closes, failure
re-opens). `services/resilient.py` wraps every device backend call in
one of these so a sick card degrades a node to host crypto instead of
killing it mid-consensus.

Thread-safe: consensus, fast-sync and RPC threads all dispatch through
the same breaker instance.
"""

from __future__ import annotations

import threading
import time

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# numeric encoding for the telemetry gauge (ordered by "badness")
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 3,
        reset_timeout_s: float = 5.0,
        clock=time.monotonic,
        on_state_change=None,
        name: str | None = None,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._listeners = [on_state_change] if on_state_change is not None else []
        self._mtx = threading.RLock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        # lifetime counters, exported with degradation state
        self.total_failures = 0
        self.total_successes = 0
        self.times_opened = 0
        self.name: str | None = None
        if name is not None:
            self.bind_telemetry(name)

    def add_state_listener(self, fn) -> None:
        """fn(old, new) on every transition; listeners run under the
        breaker lock, so keep them cheap (log lines, counter bumps)."""
        self._listeners.append(fn)

    def bind_telemetry(self, name: str) -> None:
        """Export this breaker under `kind=name`: a state gauge plus
        transition counters (to=open counts trips, to=closed counts
        recoveries), and a `breaker` flight event on every transition.
        Idempotent; the first name wins."""
        if self.name is not None:
            return
        self.name = name
        from tendermint_tpu_torch.telemetry import metrics

        metrics.BREAKER_STATE.labels(kind=name).set(STATE_CODES[self._state])

        def _export(old: str, new: str) -> None:
            metrics.BREAKER_STATE.labels(kind=name).set(STATE_CODES[new])
            metrics.BREAKER_TRANSITIONS.labels(kind=name, to=new).inc()
            # a transition is a forensic moment: black-box it and sample
            # every trace for a window, so that the work around the
            # degradation is attributable
            from tendermint_tpu_torch.telemetry import tracectx
            from tendermint_tpu_torch.telemetry.flightrec import FLIGHT

            FLIGHT.record("breaker", breaker=name, frm=old, to=new)
            tracectx.boost()

        self._listeners.append(_export)

    @property
    def state(self) -> str:
        with self._mtx:
            self._maybe_half_open()
            return self._state

    def _set_state(self, new: str) -> None:
        old, self._state = self._state, new
        if old != new:
            for fn in self._listeners:
                fn(old, new)

    def _maybe_half_open(self) -> None:
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            self._probe_in_flight = False
            self._set_state(HALF_OPEN)

    def allow(self) -> bool:
        """May this call go to the primary? OPEN answers False until the
        reset timeout, then HALF_OPEN admits exactly one probe at a time
        (concurrent callers keep getting False until the probe reports)."""
        with self._mtx:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        with self._mtx:
            self.total_successes += 1
            self._consecutive_failures = 0
            self._probe_in_flight = False
            if self._state != CLOSED:
                self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._mtx:
            self.total_failures += 1
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                # failed probe: back to OPEN for a full reset window
                self._probe_in_flight = False
                self._opened_at = self._clock()
                self.times_opened += 1
                self._set_state(OPEN)
            elif (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self.times_opened += 1
                self._set_state(OPEN)

    def snapshot(self) -> dict:
        """Degradation state for logs and exporters (the same numbers
        `bind_telemetry` streams into the registry)."""
        with self._mtx:
            self._maybe_half_open()
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "total_failures": self.total_failures,
                "total_successes": self.total_successes,
                "times_opened": self.times_opened,
            }
