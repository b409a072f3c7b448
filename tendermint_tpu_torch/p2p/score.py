"""Per-peer misbehavior scoring + time-limited bans.

Adversarial-input hardening for the switch: every classified offense
(malformed frame, invalid signature, forged block, bogus evidence, …)
debits a per-peer score that DECAYS with time — occasional noise from a
buggy-but-honest peer is forgiven, a sustained attack crosses the ban
threshold fast. Crossing it disconnects the peer and refuses
re-connection until the ban expires.

Scoring is deliberately coarse (integer weights per kind) and cheap
(one dict lookup per offense, exponential decay applied lazily at
touch time): the hot paths that call it — recv loops under flood — must
not pay for their own defense.

The weights encode severity: one garbage frame could be corruption;
one forged block or forged evidence proof is cryptographically
impossible to produce honestly, so it lands most of a ban by itself.

The port's copy of `tendermint_tpu/p2p/score.py`: the same weights,
threshold, decay and bans; its lock is the ranked leaf `p2p.scorer`.
"""

from __future__ import annotations

import threading
import time

from tendermint_tpu_torch.utils.lockrank import ranked_lock


class PeerMisbehavior(Exception):
    """A typed peer-fault signal: carried from the connection layer (bad
    frame, oversize frame) up to the switch, which debits the peer's
    score before dropping it — the recv loop itself never crashes."""

    def __init__(self, kind: str, detail: str = "") -> None:
        super().__init__(f"peer misbehavior [{kind}]: {detail}" if detail else kind)
        self.kind = kind
        self.detail = detail


# offense -> score debit (threshold 100 by default)
MISBEHAVIOR_WEIGHTS: dict[str, int] = {
    "bad_frame": 25,  # unparseable / truncated / length-lying frame
    "oversize_frame": 25,  # frame over the hard size cap
    "bad_msg": 20,  # frame parsed, reactor payload didn't
    "bad_sig": 10,  # invalid signature on a vote/tx/heartbeat
    "bad_vote": 15,  # structurally invalid vote (wrong address/index)
    # a block failing commit verification cannot be served honestly
    # (it would need 2/3 forged signatures): instant ban
    "forged_block": 100,
    # a FullCommit failing light-client certification cannot be served
    # honestly either (forged signatures or an impossible quorum): a
    # replica/peer caught serving one is lying about the chain
    "forged_fullcommit": 100,
    "bad_evidence": 50,  # evidence proof with forged signatures
    "flood": 10,  # per-round state-growth abuse (maj23 claim flood)
}
DEFAULT_WEIGHT = 20

DEFAULT_BAN_THRESHOLD = 100
DEFAULT_HALF_LIFE_S = 60.0
DEFAULT_BAN_DURATION_S = 300.0


class PeerScorer:
    """Decaying misbehavior scores + ban book, keyed by node id."""

    def __init__(
        self,
        threshold: int = DEFAULT_BAN_THRESHOLD,
        half_life_s: float = DEFAULT_HALF_LIFE_S,
        ban_duration_s: float = DEFAULT_BAN_DURATION_S,
        clock=time.monotonic,
    ) -> None:
        self.threshold = threshold
        self.half_life_s = max(1e-3, half_life_s)
        self.ban_duration_s = ban_duration_s
        self._clock = clock
        self._lock = ranked_lock("p2p.scorer")
        self._scores: dict[str, tuple[float, float]] = {}  # id -> (score, at)
        self._bans: dict[str, float] = {}  # id -> ban expiry

    # -- scoring -------------------------------------------------------------

    def _decayed_locked(self, peer_id: str, now: float) -> float:
        entry = self._scores.get(peer_id)
        if entry is None:
            return 0.0
        score, at = entry
        return score * 0.5 ** ((now - at) / self.half_life_s)

    def debit(self, peer_id: str, kind: str, weight: int | None = None) -> bool:
        """Charge one offense; True when the peer just crossed the ban
        threshold (the caller bans + disconnects)."""
        if not peer_id:
            return False
        if weight is None:
            weight = MISBEHAVIOR_WEIGHTS.get(kind, DEFAULT_WEIGHT)
        now = self._clock()
        with self._lock:
            score = self._decayed_locked(peer_id, now) + weight
            self._scores[peer_id] = (score, now)
            if score >= self.threshold:
                already = self._banned_locked(peer_id, now)
                self._bans[peer_id] = now + self.ban_duration_s
                del self._scores[peer_id]  # ban resets the ledger
                return not already
        return False

    def score(self, peer_id: str) -> float:
        with self._lock:
            return self._decayed_locked(peer_id, self._clock())

    # -- bans ----------------------------------------------------------------

    def _banned_locked(self, peer_id: str, now: float) -> bool:
        expiry = self._bans.get(peer_id)
        if expiry is None:
            return False
        if now >= expiry:
            del self._bans[peer_id]
            return False
        return True

    def ban(self, peer_id: str, duration_s: float | None = None) -> None:
        now = self._clock()
        with self._lock:
            self._bans[peer_id] = now + (
                self.ban_duration_s if duration_s is None else duration_s
            )

    def unban(self, peer_id: str) -> None:
        with self._lock:
            self._bans.pop(peer_id, None)

    def is_banned(self, peer_id: str) -> bool:
        with self._lock:
            return self._banned_locked(peer_id, self._clock())

    def banned_peers(self) -> list[str]:
        now = self._clock()
        with self._lock:
            return [p for p in list(self._bans) if self._banned_locked(p, now)]

    def snapshot(self) -> dict:
        """Diagnostics view (dump_telemetry-style, not exported series)."""
        now = self._clock()
        with self._lock:
            return {
                "scores": {
                    p: round(self._decayed_locked(p, now), 1)
                    for p in list(self._scores)
                },
                "bans": {
                    p: round(self._bans[p] - now, 1)
                    for p in list(self._bans)
                    if self._banned_locked(p, now)
                },
            }
