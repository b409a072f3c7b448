"""Timeout scheduling (reference `consensus/ticker.go`) and the
measured-latency timeout policy.

One timer; a scheduled timeout replaces any older one and only fires if
still relevant (>= the height/round/step it was scheduled for). Tocks
land on the consensus message queue like any other input.

`AdaptiveTimeouts` replaces the fixed timeout ladder with values derived
from what the node actually measures — the HeightLedger's per-phase
durations and the per-peer vote-arrival rollup — so a healthy net stops
sleeping out static worst-case timeouts (ROADMAP item 3). The derived
values are **clamped to the configured fixed values as ceilings** (a
byzantine peer that inflates its measured latencies can never push a
timeout past what the operator configured) and fall back to the fixed
ladder entirely until enough heights have been measured.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class TimeoutInfo:
    duration: float  # seconds
    height: int
    round: int
    step: int

    def _key(self):
        return (self.height, self.round, self.step)


class TimeoutTicker:
    """Thread-timer implementation of the tick/tock contract."""

    def __init__(self) -> None:
        self._timer: threading.Timer | None = None
        self._current: TimeoutInfo | None = None
        self._lock = threading.Lock()
        self._on_timeout: Callable[[TimeoutInfo], None] | None = None
        self._stopped = False

    def set_on_timeout(self, fn: Callable[[TimeoutInfo], None]) -> None:
        self._on_timeout = fn

    def schedule(self, ti: TimeoutInfo) -> None:
        """Replace the pending timeout unless it's for an older HRS
        (reference ticker ignores ticks for the past)."""
        with self._lock:
            if self._stopped:
                return
            if self._current is not None and ti._key() < self._current._key():
                return
            if self._timer is not None:
                self._timer.cancel()
            self._current = ti
            self._timer = threading.Timer(ti.duration, self._fire, args=(ti,))
            self._timer.daemon = True
            self._timer.start()

    def _fire(self, ti: TimeoutInfo) -> None:
        with self._lock:
            if self._stopped or self._current is not ti:
                return
            self._current = None
        if self._on_timeout is not None:
            self._on_timeout(ti)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()


class AdaptiveTimeouts:
    """Measured-latency timeout derivation, clamped to the config.

    Exposes the same four methods `ConsensusConfig` does, so
    `ConsensusState` calls one policy object either way:

    * `propose_timeout(round)` — how long to wait for a complete
      proposal: p95 of the recent heights' measured `propose` phase
      (which spans proposal creation + gossip + part completion),
      times a safety factor.
    * `prevote_timeout(round)` / `precommit_timeout(round)` — the
      PrevoteWait/PrecommitWait grace after +2/3-any: p95 of the
      matching measured phase. Deliberately NOT the arrival estimate —
      arrival delay measures signing→arrival and misses the remote's
      time-to-decide (block validation before signing), which is
      exactly what grows under load; the phase duration includes it.
    * `commit_timeout()` — the NewHeight pacing whose only purpose is
      gathering the remaining precommits for a fuller last_commit:
      the vote-arrival estimate (signing→arrival IS the gather window).

    Byzantine robustness: the arrival estimate is the **median of the
    per-peer mean delays** — a minority of peers stamping absurd vote
    timestamps (already clamped to `heightlog.MAX_ARRIVAL_S` at
    observation) moves the estimate only if they outnumber honest
    peers, and whatever they achieve is still clamped to the configured
    fixed value. Cold start (fewer than `MIN_HEIGHTS` ledger records,
    or an empty rollup for the arrival-based phases) falls back to the
    fixed ladder.

    Derived values are exported per phase on
    `tendermint_consensus_timeout_derived_seconds{phase=}`.
    """

    MIN_HEIGHTS = 8  # ledger records before derivation engages
    WINDOW = 64  # newest heights considered
    SAFETY = 3.0  # measured -> timeout headroom multiplier
    # WAN floor: a timeout below ~1.5x the measured one-way network
    # delay can NEVER gather remote input — it expires while the
    # honest answer is still in flight. The original fixed floor
    # (`timeout_derived_floor`, 2 ms) was fit to in-process links;
    # under 100–300 ms WAN RTTs it let a fast-measured phase derive a
    # timeout shorter than the wire, and every such round is a
    # guaranteed spurious skip (validated by the slow-WAN scenario,
    # testing/scenario.py). The estimate is the byzantine-robust
    # median-of-per-peer-means, and the configured ceiling still wins,
    # so a minority of slow-stamping peers can only ever raise the
    # floor toward physics, never past the operator's cap.
    RTT_FLOOR_MULT = 1.5

    def __init__(self, config, rollup=None, ledger=None) -> None:
        self.config = config
        self.rollup = rollup
        self.ledger = ledger

    # -- measurement inputs ------------------------------------------------

    def _phase_p95(self, phase: str) -> float | None:
        """p95 of the phase's recent per-height durations (seconds)."""
        if self.ledger is None:
            return None
        recs = self.ledger.recent(self.WINDOW)
        vals = sorted(
            r["phases"][phase]["s"]
            for r in recs
            if isinstance(r.get("phases"), dict) and phase in r["phases"]
        )
        if len(vals) < self.MIN_HEIGHTS:
            return None
        return vals[min(len(vals) - 1, int(0.95 * len(vals)))]

    def _arrival_estimate(self) -> float | None:
        """Median of per-peer mean vote-arrival delays (seconds)."""
        if self.rollup is None:
            return None
        snap = self.rollup.snapshot()
        means = sorted(st["mean_ms"] / 1e3 for st in snap.values())
        if not means or (self.ledger is not None and len(self.ledger) < self.MIN_HEIGHTS):
            return None
        return means[len(means) // 2]

    # -- the policy --------------------------------------------------------

    def _enabled(self) -> bool:
        return bool(getattr(self.config, "adaptive_timeouts", False)) and (
            os.environ.get("TENDERMINT_TPU_ADAPTIVE_TIMEOUTS", "1") != "0"
        )

    def _floor(self) -> float:
        """Configured static floor OR the measured-RTT floor, whichever
        is higher — derived timeouts never drop below what the network
        round trip physically requires (clamping to the ceiling happens
        in `_derive`, so the operator's cap still dominates)."""
        static = getattr(self.config, "timeout_derived_floor", 2) / 1000.0
        rtt = self._arrival_estimate()
        if rtt is None:
            return static
        return max(static, rtt * self.RTT_FLOOR_MULT)

    def _derive(self, phase: str, measured: float | None, ceiling: float) -> float:
        """Clamp SAFETY×measured into [floor, ceiling]; None → ceiling
        (the configured fixed value — cold start / opt-out)."""
        if measured is None or not self._enabled():
            return ceiling
        derived = max(min(ceiling, self._floor()), min(ceiling, measured * self.SAFETY))
        from tendermint_tpu_torch.telemetry import metrics as _metrics

        _metrics.CONSENSUS_TIMEOUT_DERIVED.labels(phase=phase).set(derived)
        return derived

    def propose_timeout(self, round_: int) -> float:
        return self._derive(
            "propose", self._phase_p95("propose"), self.config.propose_timeout(round_)
        )

    def prevote_timeout(self, round_: int) -> float:
        return self._derive(
            "prevote", self._phase_p95("prevote"), self.config.prevote_timeout(round_)
        )

    def precommit_timeout(self, round_: int) -> float:
        return self._derive(
            "precommit",
            self._phase_p95("precommit"),
            self.config.precommit_timeout(round_),
        )

    def commit_timeout(self) -> float:
        return self._derive(
            "commit", self._arrival_estimate(), self.config.commit_timeout()
        )


class MockTicker:
    """Test ticker (reference `consensus/common_test.go:435-478`): only
    fires NewHeight timeouts (step 1) immediately-ish; tests drive every
    other transition by injecting messages."""

    def __init__(self, fire_steps: tuple[int, ...] = (1,)) -> None:
        self._on_timeout: Callable[[TimeoutInfo], None] | None = None
        self.fire_steps = fire_steps
        self.scheduled: list[TimeoutInfo] = []

    def set_on_timeout(self, fn: Callable[[TimeoutInfo], None]) -> None:
        self._on_timeout = fn

    def schedule(self, ti: TimeoutInfo) -> None:
        self.scheduled.append(ti)
        if ti.step in self.fire_steps and self._on_timeout is not None:
            # fire on a fresh thread to mimic the async tock channel
            t = threading.Thread(
                target=self._on_timeout,
                args=(ti,),
                name="consensus-timeout",
                daemon=True,
            )
            t.start()

    def stop(self) -> None:
        pass
