"""EvidencePool: verified misbehavior proofs awaiting commitment.

Reference `evidence/pool.go` + `evidence/store.go`, collapsed to one
WAL-backed pool. Lifecycle of one piece of evidence:

    detected (vote_set conflict / gossip on 0x38)
      -> add_evidence: verify (2-lane batch through the BatchVerifier
         seam), dedup by canonical hash, append to the evidence WAL,
         enter the pending set, fire on_evidence_added (gossip out)
      -> reaped into a proposal (pending_evidence)
      -> update(height, committed): committed evidence leaves pending
         (tendermint_evidence_committed_total), expired evidence
         (height - ev.height > max_age) is pruned
         (tendermint_evidence_expired_total)

Persistence is an append-only log of framed records — `P <evidence>` on
add, `C <hash>` on commit — replayed at construction; the committed
markers keep a restarted node from re-proposing evidence the chain
already holds. A torn tail (crash mid-append) truncates cleanly at the
first bad frame, like the consensus WAL.

The port's copy of `tendermint_tpu/evidence/pool.py`; `verifier=None`
verifies proofs on the port's host verifier, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.telemetry.flightrec import FLIGHT
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.evidence import decode_evidence
from tendermint_tpu_torch.types.params import EvidenceParams
from tendermint_tpu_torch.utils.lockrank import ranked_rlock
from tendermint_tpu_torch.utils.log import kv, logger
import logging

_log = logger("evidence")

_REC_PENDING = 0x01
_REC_COMMITTED = 0x02

_HOST_VERIFIER = None


def _host_verifier():
    global _HOST_VERIFIER
    if _HOST_VERIFIER is None:
        from tendermint_tpu_torch.services.verifier import HostBatchVerifier

        _HOST_VERIFIER = HostBatchVerifier()
    return _HOST_VERIFIER

# committed-hash memory bound: enough to cover any plausible re-gossip
# window without growing forever on a long-lived node
_MAX_COMMITTED_REMEMBERED = 4096


class EvidencePool:
    """Thread-safe pending-evidence set with WAL persistence.

    `val_set_fn(height) -> ValidatorSet | None` resolves the validator
    set evidence must verify against; consensus wires its live set.
    `best_height_fn() -> int` is the freshness clock for max-age expiry
    at admission time (update() prunes at commit time)."""

    def __init__(
        self,
        wal_path: str | None = None,
        params: EvidenceParams | None = None,
        verifier=None,
        chain_id: str = "",
        val_set_fn=None,
        best_height_fn=None,
    ) -> None:
        self.params = params or EvidenceParams()
        self.verifier = verifier
        self.chain_id = chain_id
        self.val_set_fn = val_set_fn
        self.best_height_fn = best_height_fn
        # fires with the freshly added evidence (the reactor broadcasts)
        self.on_evidence_added = None
        # ranked just above consensus.state: _found_conflicting_votes
        # admits evidence while holding the consensus lock; the gossip
        # hook fires OUTSIDE this lock (see add_evidence)
        self._lock = ranked_rlock("evidence.pool")
        self._pending: "OrderedDict[bytes, object]" = OrderedDict()
        self._committed: "OrderedDict[bytes, None]" = OrderedDict()
        self._wal_path = wal_path
        self._wal = None
        if wal_path:
            os.makedirs(os.path.dirname(wal_path) or ".", exist_ok=True)
            self._replay_wal(wal_path)
            self._wal = open(wal_path, "ab")
        self._observe_depth()

    # -- persistence ---------------------------------------------------------

    def _replay_wal(self, path: str) -> None:
        """Rebuild pending/committed from the log; truncate a torn tail."""
        if not os.path.exists(path):
            return
        good = 0
        with open(path, "rb") as f:
            data = f.read()
        r = Reader(data)
        while not r.done():
            try:
                tag = r.uvarint()
                payload = r.bytes()
                if tag == _REC_PENDING:
                    ev = decode_evidence(payload)
                    self._pending[ev.hash()] = ev
                elif tag == _REC_COMMITTED:
                    self._pending.pop(payload, None)
                    self._remember_committed(payload)
                # unknown tags: skip (forward compatibility)
                good = r.offset
            except (ValueError, ValidationError):
                break  # torn tail: keep the prefix that framed cleanly
        if good < len(data):
            with open(path, "r+b") as f:
                f.truncate(good)

    def _append(self, tag: int, payload: bytes) -> None:
        if self._wal is None:
            return
        try:
            self._wal.write(Writer().uvarint(tag).bytes(payload).build())
            self._wal.flush()
        except Exception:
            # the pool must keep working in memory even on a dead disk;
            # the evidence re-arrives via gossip after a restart anyway
            kv(_log, logging.WARNING, "evidence WAL append failed")

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                try:
                    self._wal.close()
                finally:
                    self._wal = None

    # -- admission -----------------------------------------------------------

    def add_evidence(self, ev, val_set=None) -> bool:
        """Verify + admit one piece of evidence. Returns True when it
        newly entered the pending set, False for duplicates / already
        committed / expired. Raises ValidationError when the proof is
        INVALID — callers treat that as peer misbehavior."""
        key = ev.hash()
        with self._lock:
            if key in self._pending or key in self._committed:
                return False
        best = self.best_height_fn() if self.best_height_fn else 0
        if best and best - ev.height > self.params.max_age:
            return False  # expired: unverifiable, not an offense
        if val_set is None and self.val_set_fn is not None:
            val_set = self.val_set_fn(ev.height)
        if val_set is not None:
            # unconfigured pools verify on a plain host backend, NOT the
            # lazily-created process-global coalescer: add_evidence runs
            # on the consensus receive-loop thread, and a 2-lane proof
            # must never wait out (or wedge behind) a shared merge
            # window there — commit-side evidence verification
            # (validate_block) still batches through the node's device
            # spine
            ev.verify(
                self.chain_id, val_set, verifier=self.verifier or _host_verifier()
            )
        else:
            ev.validate_basic()
        with self._lock:
            if key in self._pending or key in self._committed:
                return False
            self._pending[key] = ev
            self._append(_REC_PENDING, ev.encode())
            self._observe_depth()
        kv(
            _log,
            logging.WARNING,
            "evidence admitted",
            evidence=type(ev).__name__,
            validator=ev.address.hex()[:12],
            height=ev.height,
        )
        FLIGHT.record(
            "evidence_added",
            evidence=type(ev).__name__,
            validator=ev.address.hex()[:12],
            height=ev.height,
        )
        cb = self.on_evidence_added
        if cb is not None:
            try:
                cb(ev)
            except Exception:
                pass  # gossip is best-effort; the pool state is what matters
        return True

    # -- queries -------------------------------------------------------------

    def pending_evidence(self, max_n: int | None = None) -> list:
        """Oldest-first pending evidence for a block proposal."""
        with self._lock:
            evs = list(self._pending.values())
        if max_n is None:
            max_n = self.params.max_evidence
        return evs[:max_n]

    def has(self, ev) -> bool:
        key = ev.hash()
        with self._lock:
            return key in self._pending or key in self._committed

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- commit-time maintenance ---------------------------------------------

    def update(self, height: int, committed) -> None:
        """A block at `height` committed carrying `committed` evidence:
        retire it from pending, remember its hashes, prune expired
        stragglers (reference `EvidencePool.Update`)."""
        with self._lock:
            for ev in committed:
                key = ev.hash()
                first_seen = key not in self._committed
                self._pending.pop(key, None)
                self._remember_committed(key)
                self._append(_REC_COMMITTED, key)
                if first_seen:
                    _metrics.EVIDENCE_COMMITTED.inc()
            expired = [
                key
                for key, ev in self._pending.items()
                if height - ev.height > self.params.max_age
            ]
            for key in expired:
                del self._pending[key]
                _metrics.EVIDENCE_EXPIRED.inc()
            self._observe_depth()

    def _remember_committed(self, key: bytes) -> None:
        self._committed[key] = None
        self._committed.move_to_end(key)
        while len(self._committed) > _MAX_COMMITTED_REMEMBERED:
            self._committed.popitem(last=False)

    def _observe_depth(self) -> None:
        _metrics.EVIDENCE_POOL_DEPTH.set(len(self._pending))
