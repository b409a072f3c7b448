"""Typed consensus events + the event switch.

Reference `types/events.go:14-34` + tmlibs/events: the event bus doubles as
the observability plane (SURVEY.md §5.5) — every consensus step fires a typed
event consumed internally by the reactor and externally via RPC subscribe.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable

# -- event name constants (reference types/events.go) -------------------------

EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_POLKA = "Polka"
EVENT_UNLOCK = "Unlock"
EVENT_LOCK = "Lock"
EVENT_RELOCK = "Relock"
EVENT_VOTE = "Vote"
EVENT_TX = "Tx"
EVENT_PROPOSAL_HEARTBEAT = "ProposalHeartbeat"


def event_tx(tx_hash: bytes) -> str:
    """Per-tx event key (reference `EventStringTx`)."""
    return f"Tx:{tx_hash.hex()}"


@dataclass
class EventDataNewBlock:
    block: Any


@dataclass
class EventDataNewBlockHeader:
    header: Any


@dataclass
class EventDataTx:
    height: int
    tx: bytes
    data: bytes
    log: str
    code: int


@dataclass
class EventDataRoundState:
    height: int
    round: int
    step: str
    round_state: Any = None


@dataclass
class EventDataVote:
    vote: Any


@dataclass
class EventDataProposalHeartbeat:
    heartbeat: Any


class EventSwitch:
    """Thread-safe pub/sub registry (tmlibs `events.EventSwitch` role).

    Listeners are keyed by (listener_id, event) so one subscriber can be
    removed wholesale (`remove_listener`), matching the reference semantics
    used by RPC websocket subscriptions.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # event -> list of (listener_id, callback)
        self._listeners: dict[str, list[tuple[str, Callable[[Any], None]]]] = {}

    def add_listener(self, listener_id: str, event: str, cb: Callable[[Any], None]) -> None:
        with self._lock:
            self._listeners.setdefault(event, []).append((listener_id, cb))

    def remove_listener(self, listener_id: str, event: str | None = None) -> None:
        with self._lock:
            events = [event] if event is not None else list(self._listeners)
            for ev in events:
                if ev in self._listeners:
                    self._listeners[ev] = [
                        (lid, cb) for lid, cb in self._listeners[ev] if lid != listener_id
                    ]
                    if not self._listeners[ev]:
                        del self._listeners[ev]

    def fire(self, event: str, data: Any = None) -> None:
        with self._lock:
            cbs = [cb for _, cb in self._listeners.get(event, [])]
        for cb in cbs:
            # Listener callbacks are external code: a raising subscriber
            # must never propagate into the firing component (the
            # consensus loop fires NewBlock between commit and
            # _schedule_round0 — an escaping exception there would stall
            # the node at the new height).
            try:
                cb(data)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "event listener raised for %s", event
                )


class EventCache:
    """Batch events and flush at once (reference `types.EventCache`, used for
    per-tx events inside block execution)."""

    def __init__(self, switch: EventSwitch):
        self._switch = switch
        self._pending: list[tuple[str, Any]] = []

    def fire(self, event: str, data: Any = None) -> None:
        self._pending.append((event, data))

    def flush(self) -> None:
        pending, self._pending = self._pending, []
        for event, data in pending:
            self._switch.fire(event, data)
