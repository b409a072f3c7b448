"""Per-launch device ledger (counterpart of
`tendermint_tpu/telemetry/launchlog.py`, same record fields, env knob
and JSONL format): ONE structured record per device launch, assembled
at the seams that already exist.

* `DispatchQueue` (`services/dispatch.py`) opens the record on the
  worker thread and closes it at the consumer's join, which yields the
  stage split: `queue_wait_s` (submit -> launch start), `host_prep_s`
  (lane prep + kernel launch on the worker), `in_flight_s` (launch end
  -> the consumer reaches the join) and `finalize_s` (the copy back
  that blocks the consumer). On the card `host_prep_s` holds card time
  too wherever the prep synchronises (a `.cpu()` or `.item()` before
  the kernel launch returns).
* `VerifyCoalescer` (`services/batcher.py`) tags a merged launch with
  its consumer mix, the rows the `VerifiedSigCache` withheld and its
  request count (`tag`), and launches it under its exemplar trace.
* The executing backends (`services/verifier.py`, `services/hasher.py`,
  `parallel/mesh.py`, `ops/merkle_kernel.py`) annotate what only they
  know: backend, mesh width, padded rows, host->device bytes, and the
  mesh step cache's hit or miss with the miss's warm-up seconds.

Assembly is thread-ambient (`begin`/`annotate`/`observe`/`commit`):
nested wrappers (coalescing -> resilient -> table backend) join the
open record, so exactly one record lands per dispatch unit. Synchronous
device calls open an implicit record at their first annotation and
commit it at the backend's `observe`; host micro-calls outside a launch
record nothing.

Storage: a bounded in-memory ring plus an optional JSONL file
(`attach`), compacted in place; the last 32 records ride every flight
dump, and `tools/device_report.py --ledgers` reads the file.
`TENDERMINT_TPU_LAUNCHLOG=0` disables recording.
"""

from __future__ import annotations

import json
import os
import threading
import time

from tendermint_tpu_torch.utils import shutdown

DEFAULT_CAPACITY = 1024

# launch kinds the ledger (and the tendermint_launch_rows metric) knows
KINDS = ("verify", "hash", "tables", "leaf_hashes")

_REG_LOCK = threading.Lock()
_DUMP_SEQ = 0


class LaunchLedger:
    """Bounded ring of per-launch records + optional JSONL persistence."""

    def __init__(
        self,
        path: str | None = None,
        capacity: int = DEFAULT_CAPACITY,
        node_id: str = "",
    ) -> None:
        self.capacity = max(1, capacity)
        self.node_id = node_id
        self._lock = threading.Lock()
        self._ring: list[dict] = []
        self._fh = None
        self._count = 0
        self._closed = False
        self.path: str | None = None
        # wall time of the last successfully committed launch
        self._last_success_t: float | None = None
        if path:
            self.attach(path, node_id)

    # -- wiring ------------------------------------------------------------

    def attach(self, path: str, node_id: str = "") -> None:
        """Point the ledger at a JSONL file (earlier records in it are
        reloaded into the ring) and adopt `node_id` for new records
        (process-global ledger: the last attach wins)."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            self.path = path
            if node_id:
                self.node_id = node_id
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                for rec in self._load_file():
                    self._ring.append(rec)
                self._ring = self._ring[-self.capacity :]
                self._count = len(self._ring)
                self._fh = open(path, "a", encoding="utf-8")
            except OSError:
                self._fh = None

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
            if isinstance(d, dict) and "kind" in d:
                out.append(d)
        return out

    # -- recording ---------------------------------------------------------

    def record(self, rec: dict) -> dict:
        """Stamp and append one launch record; must never fail the
        launching caller."""
        if self.node_id and "node" not in rec:
            rec["node"] = self.node_id
        with self._lock:
            if self._closed:
                return rec
            if not rec.get("error"):
                self._last_success_t = rec.get("t", time.time())
            self._ring.append(rec)
            if len(self._ring) > self.capacity:
                del self._ring[: len(self._ring) - self.capacity]
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
                    self._fh.flush()
                    self._count += 1
                    if self._count > 2 * self.capacity:
                        self._compact_locked()
                except (OSError, ValueError):
                    pass
        return rec

    def _compact_locked(self) -> None:
        """Rewrite the file to its newest `capacity` lines via tmp +
        atomic rename."""
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

    # -- reads -------------------------------------------------------------

    def recent(self, n: int | None = None, kind: str = "") -> list[dict]:
        with self._lock:
            recs = list(self._ring)
        if kind:
            recs = [r for r in recs if r.get("kind") == kind]
        if n is not None:
            recs = recs[-n:]
        return recs

    def last(self) -> dict | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def seconds_since_success(self) -> float | None:
        """Age of the last successful launch (None before any): is the
        device still answering."""
        with self._lock:
            t = self._last_success_t
        return None if t is None else max(0.0, time.time() - t)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._last_success_t = None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# The process-wide ledger: the dispatch queues and backend stacks that
# launch are process-wide too, so one ledger sees every launch. Its file
# closes at interpreter exit, after the background launches have ended.
LAUNCHLOG = LaunchLedger()
shutdown.at_exit(LAUNCHLOG.close)


def dump_all(dir: str, reason: str = "manual") -> str | None:
    """Atomically write the ledger ring as one JSON file under `dir`
    (tmp + rename). Never raises."""
    global _DUMP_SEQ
    if not dir:
        return None
    try:
        os.makedirs(dir, exist_ok=True)
        with _REG_LOCK:
            _DUMP_SEQ += 1
            seq = _DUMP_SEQ
        safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)[:48]
        path = os.path.join(dir, f"launchledger-{safe}-{seq}.json")
        tmp = path + ".tmp"
        payload = {
            "reason": reason,
            "dumped_at": time.time(),
            "node": LAUNCHLOG.node_id,
            "records": LAUNCHLOG.recent(),
        }
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
    except Exception:
        return None


# -- ambient per-launch assembly ----------------------------------------------
#
# One record is owned by exactly one "launch context": the dispatch
# worker (begin/detach at launch, reattach/commit at the consumer's
# finalize), or — for synchronous device calls — an implicit record
# opened at the first annotation and committed by the backend's
# observe. Thread-local, so concurrent launches on different workers
# never cross.

_tls = threading.local()


def _enabled() -> bool:
    return os.environ.get("TENDERMINT_TPU_LAUNCHLOG", "1") != "0"


def current() -> dict | None:
    return getattr(_tls, "rec", None)


def begin(kind: str, queue: str = "", tags: dict | None = None) -> dict | None:
    """Open the ambient launch record for this thread (the dispatch
    worker's seam). Replaces any stale implicit record a failed
    synchronous launch left behind. `tags=None` adopts this thread's
    ambient `tag()` fields (the synchronous-launch case); the dispatch
    worker passes the tags captured on the submitting thread instead.
    Returns None when disabled."""
    if not _enabled():
        _tls.rec = None
        return None
    rec: dict = {"kind": kind, "rows": 0, "_t0": time.perf_counter()}
    if queue:
        rec["queue"] = queue
    if tags is None:
        tags = current_tags()
    if tags:
        rec.update(tags)
    _tls.rec = rec
    return rec


def detach(rec: dict) -> dict:
    """Remove the ambient record (it crosses to the consumer thread on
    the dispatch handle; `reattach` re-installs it there)."""
    if getattr(_tls, "rec", None) is rec:
        _tls.rec = None
    return rec


def reattach(rec: dict) -> None:
    _tls.rec = rec


def annotate(_additive: bool = False, **fields) -> None:
    """Merge fields into the ambient launch record; synchronous device
    launches (no dispatch queue) get an implicit record on first
    annotation, committed by the backend's `observe`. `_additive` sums
    numeric fields instead of overwriting (chunked launches)."""
    if not _enabled():
        return
    rec = getattr(_tls, "rec", None)
    if rec is None:
        rec = begin("verify")
        if rec is None:
            return
        rec["_implicit"] = True
    if _additive:
        for k, v in fields.items():
            rec[k] = rec.get(k, 0) + v
    else:
        rec.update(fields)


def add_transfer(nbytes: int) -> None:
    """Accumulate host->device transfer bytes into the ambient record
    (lane arrays, padded blocks, sharded-table `device_put`)."""
    annotate(_additive=True, transfer_bytes=int(nbytes))


def observe(kind: str, backend: str, rows: int, seconds: float) -> None:
    """The executing backend's per-call report (`_observe_verify` /
    `_observe_hash` call it). Inside a launch context it annotates the
    open record; outside one it records a standalone launch, unless the
    backend is the host library, whose synchronous micro-calls are not
    device launches."""
    if not _enabled():
        return
    rec = getattr(_tls, "rec", None)
    if rec is None:
        if backend == "host":
            return  # a host micro-call outside any launch context
        rec = begin(kind)
        if rec is None:
            return
        rec["_implicit"] = True
        # opened here, at the call's end: its total is the backend's own
        # seconds (the JAX package's record says ~0 s)
        del rec["_t0"]
    # a record this call's backend opened implicitly (an annotation
    # before the observe) takes the observed kind: a sharded data_hash
    # annotates its leaf lane first (the JAX package files it under
    # `verify`, the kind its implicit records start with)
    if kind in ("tables", "leaf_hashes") or "kind" not in rec or rec.get("_implicit"):
        rec["kind"] = kind
    rec["backend"] = backend
    rec["rows"] = rec.get("rows", 0) + int(rows)
    rec["device_s"] = round(rec.get("device_s", 0.0) + seconds, 6)
    if rec.pop("_implicit", None):
        commit(rec)


def commit(rec: dict, error: BaseException | None = None) -> dict:
    """Close one launch record: strip assembly-internal keys, observe
    the catalog metrics, append to the ledger. Never raises — the
    ledger must not fail the verify spine."""
    try:
        if getattr(_tls, "rec", None) is rec:
            _tls.rec = None
        t0 = rec.pop("_t0", None)
        rec.pop("_t_launch_end", None)
        rec.pop("_implicit", None)
        if error is not None:
            rec["error"] = type(error).__name__
        rec["t"] = time.time()
        if "total_s" not in rec:
            total = (
                time.perf_counter() - t0
                if t0 is not None
                else rec.get("device_s", 0.0)
            )
            rec["total_s"] = round(total, 6)
        for k in ("queue_wait_s", "host_prep_s", "in_flight_s", "finalize_s",
                  "total_s", "device_s", "compile_s", "device_put_s"):
            if k in rec:
                rec[k] = round(float(rec[k]), 6)
        _observe_metrics(rec)
        return LAUNCHLOG.record(rec)
    except Exception:
        return rec


def _observe_metrics(rec: dict) -> None:
    from tendermint_tpu_torch.telemetry import metrics as _m

    kind = rec.get("kind", "verify")
    if kind not in KINDS:
        kind = "verify"
    rows = int(rec.get("rows", 0))
    if rows:
        _m.LAUNCH_ROWS.labels(kind=kind, state="useful").inc(rows)
    padded = int(rec.get("rows_padded", 0))
    if padded:
        _m.LAUNCH_ROWS.labels(kind=kind, state="padded").inc(padded)
    cached = int(rec.get("rows_cached", 0))
    if cached:
        _m.LAUNCH_ROWS.labels(kind=kind, state="cached").inc(cached)
    for stage in ("queue_wait", "host_prep", "in_flight", "finalize"):
        v = rec.get(stage + "_s")
        if v is not None:
            _m.LAUNCH_STAGE_SECONDS.labels(stage=stage).observe(
                v, exemplar=rec.get("trace")
            )
    tb = rec.get("transfer_bytes")
    if tb:
        _m.LAUNCH_TRANSFER_BYTES.observe(float(tb))


class tag:
    """Submit-time annotations: fields set here ride into the NEXT
    launch handle created on this thread (the coalescer tags its flush
    with the consumer mix / cached rows before submitting) and into any
    synchronous launch executed inside the block."""

    def __init__(self, **fields) -> None:
        self._fields = fields
        self._prev: dict | None = None

    def __enter__(self):
        self._prev = getattr(_tls, "tags", None)
        merged = dict(self._prev) if self._prev else {}
        merged.update(self._fields)
        _tls.tags = merged
        return self

    def __exit__(self, *exc):
        _tls.tags = self._prev
        return False


def current_tags() -> dict | None:
    """Snapshot of the submit-time tags ambient on this thread (the
    dispatch handle captures them at construction, like the trace
    context)."""
    tags = getattr(_tls, "tags", None)
    return dict(tags) if tags else None


# -- summaries ----------------------------------------------------------------


def summarize(records: list[dict]) -> dict:
    """Per-kind rollup of a record window (the aggregation
    `tools/device_report.py` applies to a ledger file)."""
    kinds: dict[str, dict] = {}
    for r in records:
        kind = r.get("kind", "verify")
        agg = kinds.setdefault(
            kind,
            {
                "launches": 0,
                "errors": 0,
                "rows": 0,
                "rows_padded": 0,
                "rows_cached": 0,
                "transfer_bytes": 0,
                "compile_hits": 0,
                "compile_misses": 0,
                "compile_s": 0.0,
                "device_put_s": 0.0,
                "stages_s": {
                    "queue_wait": 0.0,
                    "host_prep": 0.0,
                    "in_flight": 0.0,
                    "finalize": 0.0,
                },
                "total_s": 0.0,
                "consumers": {},
            },
        )
        agg["launches"] += 1
        if r.get("error"):
            agg["errors"] += 1
        agg["rows"] += int(r.get("rows", 0))
        agg["rows_padded"] += int(r.get("rows_padded", 0))
        agg["rows_cached"] += int(r.get("rows_cached", 0))
        agg["transfer_bytes"] += int(r.get("transfer_bytes", 0))
        if r.get("compile") == "hit":
            agg["compile_hits"] += 1
        elif r.get("compile") == "miss":
            agg["compile_misses"] += 1
        agg["compile_s"] += float(r.get("compile_s", 0.0))
        agg["device_put_s"] += float(r.get("device_put_s", 0.0))
        for stage in agg["stages_s"]:
            agg["stages_s"][stage] += float(r.get(stage + "_s", 0.0))
        agg["total_s"] += float(r.get("total_s", 0.0))
        for consumer, n in (r.get("consumers") or {}).items():
            agg["consumers"][consumer] = agg["consumers"].get(consumer, 0) + n
    for agg in kinds.values():
        shipped = agg["rows"] + agg["rows_padded"]
        agg["occupancy_pct"] = (
            round(100.0 * agg["rows"] / shipped, 1) if shipped else None
        )
        agg["padding_waste_pct"] = (
            round(100.0 * agg["rows_padded"] / shipped, 1) if shipped else None
        )
        offered = agg["rows"] + agg["rows_cached"]
        agg["cache_withheld_pct"] = (
            round(100.0 * agg["rows_cached"] / offered, 1) if offered else None
        )
        agg["compile_s"] = round(agg["compile_s"], 6)
        agg["device_put_s"] = round(agg["device_put_s"], 6)
        agg["total_s"] = round(agg["total_s"], 6)
        agg["stages_s"] = {
            k: round(v, 6) for k, v in agg["stages_s"].items()
        }
    return kinds
