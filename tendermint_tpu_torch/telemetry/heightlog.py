"""Per-height critical-path ledger: one structured record per committed
height — the finality measurement substrate.

Metrics say *how long* a height took in aggregate; spans say how long
one phase took; neither answers the question the pipelined-consensus
work (ROADMAP item 3) starts from: **for height H, where did the time
go, and which stage was the bottleneck?** The `HeightLedger` answers it
with one record per height, assembled by `consensus/state.py` at
finalize from timings the node already measures (phase transitions,
the apply stopwatch, the verify/hash/coalescer/dispatch histograms —
no new per-call plumbing):

* phase-transition durations (NewHeight → Propose → Prevote →
  Precommit → Commit → Applied), each with a wait-vs-work split
  (work = device verify+hash seconds that elapsed during the phase);
* commit-to-commit gap (`finality_s`) — the user-facing number;
* the cross-height pipeline's accounting: `pipelined` (the apply ran
  as a dispatch handle under H+1's voting) and `apply_overlap_s` (the
  share of the apply that ran concurrently — subtract it from the
  phase sum when reconciling against the gap, since overlapped apply
  time did not extend the height);
* **critical-path attribution**: which of {proposal wait, slowest-vote
  gather, commit wait, coalescer flush wait, dispatch launch, ABCI
  apply, Merkle hash} dominated the height;
* the **laggard validator**: whose vote arrived latest (from the
  per-peer vote-arrival rollup below).

Storage follows `telemetry/spanlog.py`: a bounded in-memory ring plus
an optional JSONL file under the data dir, compacted in place to the
newest `capacity` records whenever it doubles past it; the persisted
tail is reloaded on boot so `/health`'s finality window and
`dump_telemetry?heights=N` survive restarts. `tools/finality_report.py`
merges N nodes' ledgers into a per-height waterfall.

Ledgers register themselves in a process-wide set (mirroring the
FLIGHT/TRACER conventions) so flight-recorder dumps can include the
last K height records of every live ledger, and `dump_all()` writes a
stand-alone forensic dump next to the flight recorder's.

Registry-derived work numbers are process-global: the
multi-node-in-process harnesses see cross-node sums in the work split
(documented approximation); the wall-clock phase durations and the
critical-path label are per-node exact.

The port's copy of `tendermint_tpu/telemetry/heightlog.py`; the port's
flight-recorder dumps embed `recent_records(32)` of these ledgers.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref

DEFAULT_CAPACITY = 512
# vote-arrival delays are clamped into [0, MAX_ARRIVAL_S]: a byzantine
# validator controls its vote timestamps, and an absurd value must not
# poison the laggard attribution or the max gauge
MAX_ARRIVAL_S = 60.0

_REG_LOCK = threading.Lock()
_LEDGERS: "weakref.WeakSet[HeightLedger]" = weakref.WeakSet()
_DUMP_SEQ = 0


class HeightLedger:
    """Bounded ring of per-height records + optional JSONL persistence."""

    def __init__(
        self,
        path: str | None = None,
        capacity: int = DEFAULT_CAPACITY,
        node_id: str = "",
    ) -> None:
        self.path = path
        self.capacity = max(1, capacity)
        self.node_id = node_id
        self._lock = threading.Lock()
        self._ring: list[dict] = []
        self._fh = None
        self._count = 0
        self._closed = False
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            for rec in self._load_file():
                self._ring.append(rec)
            self._ring = self._ring[-self.capacity :]
            self._count = len(self._ring)
            self._fh = open(path, "a", encoding="utf-8")
        with _REG_LOCK:
            _LEDGERS.add(self)

    def _load_file(self) -> list[dict]:
        """The newest `capacity` persisted records (oldest first); torn
        final lines from a crash are skipped, not fatal."""
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
            if isinstance(d, dict) and "height" in d:
                out.append(d)
        return out

    # -- recording -----------------------------------------------------------

    def record(self, rec: dict) -> dict:
        """Stamp and append one height record; must never fail the
        committing caller."""
        if self.node_id and "node" not in rec:
            rec["node"] = self.node_id
        with self._lock:
            if self._closed:
                return rec
            self._ring.append(rec)
            if len(self._ring) > self.capacity:
                del self._ring[: len(self._ring) - self.capacity]
            if self._fh is not None:
                try:
                    self._fh.write(
                        json.dumps(rec, separators=(",", ":")) + "\n"
                    )
                    self._fh.flush()
                    self._count += 1
                    if self._count > 2 * self.capacity:
                        self._compact_locked()
                except (OSError, ValueError):
                    pass
        return rec

    def _compact_locked(self) -> None:
        """Rewrite the file to its newest `capacity` lines via tmp +
        atomic rename (spanlog's compaction discipline)."""
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

    # -- reads ---------------------------------------------------------------

    def recent(self, n: int | None = None, height: int | None = None) -> list[dict]:
        with self._lock:
            recs = list(self._ring)
        if height is not None:
            recs = [r for r in recs if r.get("height") == height]
        if n is not None:
            recs = recs[-n:]
        return recs

    def last(self) -> dict | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def finality_window(self, n: int) -> list[float]:
        """The last `n` commit-to-commit gaps (seconds) — the rolling
        window the health SLO evaluates."""
        out = [
            r["finality_s"]
            for r in self.recent(n)
            if isinstance(r.get("finality_s"), (int, float))
        ]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


class VoteArrivalRollup:
    """Per-peer vote-arrival latency (vote timestamp → local arrival),
    bounded by the live peer set. Exported low-cardinality — the
    aggregate histogram + worst-peer gauge live in the metric catalog
    (`tendermint_consensus_vote_arrival_*`), per-peer detail is served
    by `dump_telemetry` only (peer-id cardinality, same discipline as
    `tendermint_p2p_send_queue_depth`)."""

    MAX_PEERS = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._peers: dict[str, list] = {}  # peer_id -> [count, sum, max]

    def observe(self, peer_id: str, delay_s: float) -> None:
        with self._lock:
            st = self._peers.get(peer_id)
            if st is None:
                if len(self._peers) >= self.MAX_PEERS:
                    return  # bounded: a peer-id flood cannot grow this
                st = self._peers[peer_id] = [0, 0.0, 0.0]
            st[0] += 1
            st[1] += delay_s
            if delay_s > st[2]:
                st[2] = delay_s

    def snapshot(self) -> dict:
        with self._lock:
            return {
                pid: {
                    "count": st[0],
                    "mean_ms": round(st[1] / st[0] * 1e3, 3) if st[0] else 0.0,
                    "max_ms": round(st[2] * 1e3, 3),
                }
                for pid, st in self._peers.items()
            }

    def max_delay(self) -> float:
        with self._lock:
            return max((st[2] for st in self._peers.values()), default=0.0)


# -- stitched work totals -----------------------------------------------------


def work_totals() -> dict:
    """Process-wide device-work stopwatch totals, stitched from the
    histograms the verify spine already exports (VerifyHandle launch
    latency, VerifyCoalescer waits, dispatch-queue waits) — the ledger
    deltas these at phase boundaries instead of adding per-call
    plumbing. Sums are across label children (all backends/consumers/
    queues)."""
    from tendermint_tpu_torch.telemetry import metrics as _m

    return {
        "verify": _m.VERIFY_SECONDS.sum_total(),
        "hash": _m.HASH_SECONDS.sum_total(),
        "coalescer": _m.BATCHER_WAIT.sum_total(),
        "dispatch": _m.DISPATCH_QUEUE_WAIT.sum_total(),
    }


# -- process-wide registry ----------------------------------------------------


def ledgers() -> list[HeightLedger]:
    with _REG_LOCK:
        return list(_LEDGERS)


def recent_records(k: int = 32) -> list[dict]:
    """The newest `k` records across every live ledger (commit-time
    order) — what flight-recorder dumps embed so a post-mortem carries
    the heights leading into the fault."""
    out: list[dict] = []
    for led in ledgers():
        out.extend(led.recent(k))
    out.sort(key=lambda r: (r.get("t_commit", 0.0), r.get("height", 0)))
    return out[-k:]


def dump_all(dir: str, reason: str = "manual") -> str | None:
    """Atomically write every live ledger's ring as one JSON file under
    `dir` (tmp + rename, flightrec's discipline); returns the path, or
    None when nothing could be written. Never raises — forensics must
    not mask the fault being dumped."""
    global _DUMP_SEQ
    if not dir:
        return None
    try:
        os.makedirs(dir, exist_ok=True)
        with _REG_LOCK:
            _DUMP_SEQ += 1
            seq = _DUMP_SEQ
        safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)[:48]
        path = os.path.join(dir, f"heightledger-{safe}-{seq}.json")
        tmp = path + ".tmp"
        payload = {
            "reason": reason,
            "dumped_at": time.time(),
            "ledgers": [
                {"node": led.node_id, "records": led.recent()}
                for led in ledgers()
                if len(led)
            ],
        }
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
    except Exception:
        return None
