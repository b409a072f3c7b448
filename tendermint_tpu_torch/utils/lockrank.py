"""Runtime lock-rank sanitizer (counterpart of
`tendermint_tpu/utils/lockrank.py`, same knobs, names and reports).

`RANKS` below declares the acquisition order of the locks the port
builds, under the JAX package's names, ranks and seqs: locks must be
acquired in ascending rank order, and same-rank locks (the sig-cache
shards) only in ascending `seq` order.

Two detectors run on every instrumented acquire:

* **Rank inversion** — acquiring a lock whose rank is <= the highest
  rank this thread already holds (same-rank + ascending seq excepted).
  Caught BEFORE the blocking acquire, so a deliberate ABBA deadlock is
  reported instead of hung.
* **Order-graph cycles** — every first-time edge ``held -> acquired``
  enters a process-global directed graph with the acquiring thread's
  stack; an edge that closes a cycle is a potential deadlock even when
  every participating lock is unranked (rank=None). The report carries
  the acquisition stacks of both sides of the cycle.

The sanitizer sees only the port's locks: in a process that composes
the JAX package's host plane with the port's device plane, each
package's sanitizer checks its own locks, and an inversion across the
two packages is visible to neither.

Zero-overhead discipline: `ranked_lock()` / `ranked_rlock()` return
plain `threading.Lock()` / `RLock()` objects unless
``TENDERMINT_TPU_LOCKRANK=1`` (the test suite sets it for the whole
run), so production hot paths never pay for the bookkeeping.

Violations are RECORDED by default (``violations()`` / ``drain()``;
`tendermint_tpu_torch.testing.lockrank_guard` turns them into failures
of the test that provoked them, carrying ``render_report()``).
``TENDERMINT_TPU_LOCKRANK_RAISE=1`` or ``set_raise(True)`` raises
`LockRankViolation` at the offending acquire instead.

**Contention timing**: armed with ``set_timing(True)``, every
`RankedLock` also records acquire-wait and hold durations into the
``tendermint_lock_wait_seconds{lock}`` /
``tendermint_lock_hold_seconds{lock}`` histograms plus a per-site
accumulator (``contention_snapshot()``). It costs one module-global
bool read when disarmed. Locks are only *instrumentable* when they were
constructed as `RankedLock`s: either the sanitizer is on, or
``TENDERMINT_TPU_PROFILE_HZ`` is set (any value, including ``0``) when
they are built. The JAX package's sampling profiler, which arms the
timing on a schedule, is not ported: a caller arms it.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

# -- the declared rank table ----------------------------------------------------
#
# Ascending rank == legal acquisition order; the rows the port builds,
# with the JAX package's ranks (gaps leave room for new locks).
RANKS: dict[str, int] = {
    # consensus holds its big lock across mempool/evidence/dispatch work,
    # so it is the lowest-ranked lock in the process.
    "consensus.state": 10,  # ConsensusState._mtx
    "evidence.pool": 20,  # EvidencePool._lock
    # mempool: _avail -> lanes -> wal -> counter
    "mempool.avail": 30,  # Mempool._avail's Condition lock
    "mempool.ingress": 35,  # IngressBatcher._cond's lock
    "mempool.lane": 40,  # _Lane.lock (seq = lane index)
    "mempool.txcache": 44,  # TxCache._lock (under lanes via recheck/flush)
    "mempool.wal": 48,  # Mempool._wal_lock
    "mempool.counter": 52,  # Mempool._counter_lock
    "mempool.notif": 56,  # Mempool._notif_lock (under all lanes in update())
    "mempool.trace": 60,  # Mempool._trace_lock
    "dispatch.handle": 64,  # VerifyHandle/ChainedHandle._lock
    "batcher.shard": 68,  # VerifiedSigCache shard locks (seq = shard index)
    "batcher.window": 72,  # VerifyCoalescer._cond's lock
    "dispatch.worker": 76,  # DispatchQueue._thread_lock
    "dispatch.state": 80,  # DispatchQueue._state_lock
    "dispatch.global": 84,  # default_dispatch_queue singleton lock
    # p2p locks are leaves: held only over dict/counter surgery, never
    # across reactor callbacks or sends.
    "p2p.switch": 88,  # Switch._mtx
    "p2p.scorer": 90,  # PeerScorer._lock
    "p2p.conn.write": 92,  # tcp/secret per-connection write locks
    "p2p.flowrate": 94,  # flowrate.Monitor._lock
}

_ENV = "TENDERMINT_TPU_LOCKRANK"
_ENV_RAISE = "TENDERMINT_TPU_LOCKRANK_RAISE"
_ENV_PROFILE = "TENDERMINT_TPU_PROFILE_HZ"

_STACK_FRAMES = 14  # per-side stack depth kept in edge/violation reports


class LockRankViolation(RuntimeError):
    """Raised (in raise mode) before the offending acquire blocks."""


def enabled() -> bool:
    return os.environ.get(_ENV, "0") not in ("", "0")


def timing_capable() -> bool:
    """True when `ranked_lock()` should hand out instrumentable
    `RankedLock`s even without the sanitizer: the profiler env knob is
    present (any value — ``0`` means "off now, armable later")."""
    return os.environ.get(_ENV_PROFILE) is not None


_raise_mode: bool | None = None


def _should_raise() -> bool:
    if _raise_mode is not None:
        return _raise_mode
    return os.environ.get(_ENV_RAISE, "0") not in ("", "0")


def set_raise(on: bool | None) -> None:
    """Force raise mode on/off; None restores the env-var default."""
    global _raise_mode
    _raise_mode = on


# -- process-global state -----------------------------------------------------


class _TLS(threading.local):
    def __init__(self) -> None:
        self.stack: list[_Held] = []


_tls = _TLS()

_graph_lock = threading.Lock()
# edge (from_name, to_name) -> first-observation record
_edges: dict[tuple[str, str], dict] = {}
# adjacency for cycle detection (names)
_adj: dict[str, set[str]] = {}

_viol_lock = threading.Lock()
_violations: list[dict] = []


class _Held:
    __slots__ = ("lock", "count", "t_acquired", "wait_s", "site")

    def __init__(self, lock: "RankedLock") -> None:
        self.lock = lock
        self.count = 1
        # contention-timing stamps, set only while timing is armed at
        # first entry (None otherwise — the pair goes unrecorded)
        self.t_acquired: float | None = None
        self.wait_s = 0.0
        self.site: str | None = None


def _capture_stack() -> list[str]:
    # skip this helper + the sanitizer frames above it
    return traceback.format_list(
        traceback.extract_stack(limit=_STACK_FRAMES + 3)[:-3]
    )


def _record_violation(kind: str, message: str, stacks: list[dict]) -> None:
    v = {
        "kind": kind,
        "message": message,
        "thread": threading.current_thread().name,
        "stacks": stacks,
    }
    with _viol_lock:
        _violations.append(v)
    if _should_raise():
        raise LockRankViolation(message + "\n" + render_violation(v))


def violations() -> list[dict]:
    with _viol_lock:
        return list(_violations)


def drain() -> list[dict]:
    """Return and clear recorded violations (the test guard)."""
    with _viol_lock:
        out = list(_violations)
        _violations.clear()
    return out


def reset() -> None:
    """Clear violations AND the learned order graph (test isolation)."""
    with _viol_lock:
        _violations.clear()
    with _graph_lock:
        _edges.clear()
        _adj.clear()


def render_violation(v: dict) -> str:
    lines = [f"[{v['kind']}] {v['message']} (thread {v['thread']})"]
    for s in v["stacks"]:
        lines.append(f"  -- {s['label']} (thread {s['thread']}):")
        for frame in s["stack"]:
            for ln in frame.rstrip().splitlines():
                lines.append("    " + ln)
    return "\n".join(lines)


def render_report() -> str:
    """Flight-recorder-style dump of every recorded violation."""
    vs = violations()
    if not vs:
        return "lockrank: no violations recorded"
    out = [f"lockrank: {len(vs)} violation(s)"]
    for i, v in enumerate(vs):
        out.append(f"--- violation {i + 1} ---")
        out.append(render_violation(v))
    return "\n".join(out)


# -- contention timing (armed by set_timing) -----------------------------------
#
# One module-global bool gates everything: disarmed, a timed acquire is
# a single global read on top of the sanitizer bookkeeping. Armed, a
# first-entry acquire stamps perf_counter around the blocking acquire
# (wait) and the final release stamps the hold — ONE per-instance stat
# update per acquire/release pair (the stat lock is per RankedLock, so
# it only serializes threads already serialized on that lock).
# Histogram observes and site capture only fire above noise floors —
# an uncontended micro-acquire costs three perf_counter reads and a
# handful of float ops.

_TIMING = False
# registry guard (stat creation + snapshot only — never the hot path);
# deliberately a PLAIN lock, like _graph_lock/_viol_lock above
_stats_lock = threading.Lock()
_STATS: list["_LockStat"] = []
_MAX_SITES = 16  # per-lock site table bound
_HIST_FLOOR_S = 1e-5  # histogram observes below this are noise, dropped
_SITE_FLOOR_S = 5e-5  # waits below this skip the sys._getframe site walk


def set_timing(on: bool) -> None:
    """Arm/disarm contention timing on every live RankedLock.
    Idempotent."""
    global _TIMING
    _TIMING = bool(on)


def timing_enabled() -> bool:
    return _TIMING


def _acquire_site() -> str:
    """`file.py:lineno` of the nearest caller frame outside this module
    — the per-site attribution key. Cheap: no traceback formatting."""
    f = sys._getframe(2)
    here = __file__
    while f is not None and f.f_code.co_filename == here:
        f = f.f_back
    if f is None:
        return "?"
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


class _LockStat:
    """Per-RankedLock contention accumulator (merged by name at
    snapshot). Guarded by its own plain lock; the labeled histogram
    children are resolved once and cached."""

    __slots__ = (
        "name",
        "mtx",
        "wait_count",
        "wait_s",
        "wait_max",
        "hold_count",
        "hold_s",
        "hold_max",
        "sites",
        "wait_child",
        "hold_child",
    )

    def __init__(self, name: str) -> None:
        self.name = name
        self.mtx = threading.Lock()
        self.wait_count = 0
        self.wait_s = 0.0
        self.wait_max = 0.0
        self.hold_count = 0
        self.hold_s = 0.0
        self.hold_max = 0.0
        self.sites: dict[str, list] = {}
        try:
            from tendermint_tpu_torch.telemetry import metrics as _m

            self.wait_child = _m.LOCK_WAIT_SECONDS.labels(lock=name)
            self.hold_child = _m.LOCK_HOLD_SECONDS.labels(lock=name)
        except Exception:  # telemetry must never break a lock acquire
            self.wait_child = None
            self.hold_child = None

    def record(self, wait_s: float, hold_s: float, site: str | None) -> None:
        with self.mtx:
            self.wait_count += 1
            self.wait_s += wait_s
            if wait_s > self.wait_max:
                self.wait_max = wait_s
            self.hold_count += 1
            self.hold_s += hold_s
            if hold_s > self.hold_max:
                self.hold_max = hold_s
            if site is not None:
                s = self.sites.get(site)
                if s is None:
                    if len(self.sites) < _MAX_SITES:
                        self.sites[site] = [1, wait_s]
                else:
                    s[0] += 1
                    s[1] += wait_s
        if wait_s >= _HIST_FLOOR_S and self.wait_child is not None:
            self.wait_child.observe(wait_s)
        if hold_s >= _HIST_FLOOR_S and self.hold_child is not None:
            self.hold_child.observe(hold_s)


def _make_stat(name: str) -> _LockStat:
    st = _LockStat(name)
    with _stats_lock:
        _STATS.append(st)
    return st


def contention_snapshot(top: int = 10) -> dict:
    """Top-contended locks (by total acquire-wait) merged across
    instances sharing a name (the sig-cache shards), with per-site
    attribution (the JAX package's lock view, same fields)."""
    with _stats_lock:
        stats = list(_STATS)
    merged: dict[str, dict] = {}
    for st in stats:
        with st.mtx:
            if st.wait_count == 0 and st.hold_count == 0:
                continue
            row = merged.setdefault(
                st.name,
                {
                    "lock": st.name,
                    "wait_count": 0,
                    "wait_s": 0.0,
                    "wait_max_s": 0.0,
                    "hold_count": 0,
                    "hold_s": 0.0,
                    "hold_max_s": 0.0,
                    "_sites": {},
                },
            )
            row["wait_count"] += st.wait_count
            row["wait_s"] += st.wait_s
            row["wait_max_s"] = max(row["wait_max_s"], st.wait_max)
            row["hold_count"] += st.hold_count
            row["hold_s"] += st.hold_s
            row["hold_max_s"] = max(row["hold_max_s"], st.hold_max)
            for site, (cnt, w) in st.sites.items():
                s = row["_sites"].setdefault(site, [0, 0.0])
                s[0] += cnt
                s[1] += w
    rows = []
    for row in merged.values():
        sites = sorted(
            row.pop("_sites").items(), key=lambda kv: kv[1][1], reverse=True
        )[:3]
        row["wait_s"] = round(row["wait_s"], 6)
        row["wait_max_s"] = round(row["wait_max_s"], 6)
        row["hold_s"] = round(row["hold_s"], 6)
        row["hold_max_s"] = round(row["hold_max_s"], 6)
        row["top_sites"] = [
            {"site": site, "count": cnt, "wait_s": round(w, 6)}
            for site, (cnt, w) in sites
        ]
        rows.append(row)
    rows.sort(key=lambda r: r["wait_s"], reverse=True)
    return {"armed": _TIMING, "locks": rows[: max(0, top)]}


def reset_contention() -> None:
    with _stats_lock:
        stats = list(_STATS)
    for st in stats:
        with st.mtx:
            st.wait_count = 0
            st.wait_s = 0.0
            st.wait_max = 0.0
            st.hold_count = 0
            st.hold_s = 0.0
            st.hold_max = 0.0
            st.sites.clear()


def _find_path(src: str, dst: str) -> list[str] | None:
    """DFS path src -> dst in the order graph (caller holds _graph_lock)."""
    seen = {src}
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        for nxt in _adj.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_edge(held: "RankedLock", acquiring: "RankedLock") -> None:
    """Record held -> acquiring in the order graph; a new edge that
    closes a cycle is a potential deadlock even if every lock is
    unranked (the classic ABBA shows up here as a 2-cycle)."""
    edge = (held.name, acquiring.name)
    if edge[0] == edge[1]:
        return  # same-name pairs (shards) are seq-checked instead
    if edge in _edges:
        return  # lock-free fast path: dict reads are GIL-atomic, and a
        # stale miss just falls through to the locked re-check below
    with _graph_lock:
        if edge in _edges:
            return
        back_path = _find_path(acquiring.name, held.name)
        _edges[edge] = {
            "thread": threading.current_thread().name,
            "stack": _capture_stack(),
        }
        _adj.setdefault(edge[0], set()).add(edge[1])
        if back_path is None:
            return
        # cycle: acquiring -> ... -> held exists, and we just added
        # held -> acquiring. Collect the stacks of every edge on the
        # reverse path plus this thread's — both sides of the deadlock.
        stacks = [
            {
                "label": f"order {edge[0]} -> {edge[1]} (this acquire)",
                "thread": threading.current_thread().name,
                "stack": _capture_stack(),
            }
        ]
        for a, b in zip(back_path, back_path[1:]):
            rec = _edges.get((a, b))
            if rec is not None:
                stacks.append(
                    {
                        "label": f"order {a} -> {b} (first observed)",
                        "thread": rec["thread"],
                        "stack": rec["stack"],
                    }
                )
        cycle = " -> ".join(back_path + [back_path[0]])
    _record_violation(
        "cycle",
        f"lock-order cycle (potential deadlock): {cycle}",
        stacks,
    )


class RankedLock:
    """threading.Lock with rank/order instrumentation.

    `rank=None` means unranked: the lock still participates in the
    order graph (cycle detection) but skips the rank comparison.
    """

    _factory = staticmethod(threading.Lock)

    def __init__(
        self,
        name: str,
        rank: int | None = None,
        seq: int = 0,
        sanitize: bool = True,
    ) -> None:
        self.name = name
        self.rank = RANKS.get(name) if rank is None else rank
        self.seq = seq
        # False when constructed purely for contention timing (profiler
        # env present, sanitizer off): hold-stack bookkeeping runs (the
        # Condition protocol and timing need it) but rank/order checks
        # don't — a timing-only process must never record violations.
        self.sanitize = sanitize
        self._stat: _LockStat | None = None  # lazy, first timed release
        self._inner = self._factory()

    # -- bookkeeping -------------------------------------------------------

    def _held_entry(self) -> _Held | None:
        for h in _tls.stack:
            if h.lock is self:
                return h
        return None

    def _check(self) -> None:
        stack = _tls.stack
        if not stack:
            return
        inverted = False
        if self.rank is not None:
            worst: RankedLock | None = None
            for h in stack:
                r = h.lock.rank
                if r is None:
                    continue
                bad = r > self.rank or (
                    r == self.rank
                    and h.lock is not self
                    and h.lock.seq >= self.seq
                )
                if bad and (worst is None or r >= (worst.rank or 0)):
                    worst = h.lock
            if worst is not None:
                inverted = True
                _record_violation(
                    "rank_inversion",
                    f"acquiring {self.name!r} (rank {self.rank}, seq "
                    f"{self.seq}) while holding {worst.name!r} (rank "
                    f"{worst.rank}, seq {worst.seq}) — declared order is "
                    f"ascending rank (see utils/lockrank.py RANKS)",
                    [
                        {
                            "label": f"acquire of {self.name} "
                            f"holding [{', '.join(h.lock.name for h in stack)}]",
                            "thread": threading.current_thread().name,
                            "stack": _capture_stack(),
                        }
                    ]
                    + self._reverse_edge_stacks(worst),
                )
        if not inverted:
            # an inversion is already the report; feeding it into the
            # order graph would double-report it as a cycle too
            self._note_edges()

    def _reverse_edge_stacks(self, worst: "RankedLock") -> list[dict]:
        """If the legal order (self -> worst) was ever observed, include
        that thread's stack: the report then shows BOTH threads'
        acquisition stacks for the inversion pair."""
        with _graph_lock:
            rec = _edges.get((self.name, worst.name))
        if rec is None:
            return []
        return [
            {
                "label": f"order {self.name} -> {worst.name} (first observed)",
                "thread": rec["thread"],
                "stack": rec["stack"],
            }
        ]

    def _note_edges(self) -> None:
        # one edge per DISTINCT held lock name: the transitive pairs
        # matter both for cycle detection and for inversion reports
        # quoting the legal-order thread's stack
        seen: set[str] = set()
        for h in _tls.stack:
            if h.lock.name in seen:
                continue
            seen.add(h.lock.name)
            _note_edge(h.lock, self)

    # -- lock protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = self._held_entry()
        if held is None and self.sanitize:
            self._check()
        timed = _TIMING and held is None
        if timed:
            t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if held is not None:
                held.count += 1
            else:
                h = _Held(self)
                if timed:
                    h.t_acquired = time.perf_counter()
                    h.wait_s = h.t_acquired - t0
                    if h.wait_s >= _SITE_FLOOR_S:
                        h.site = _acquire_site()
                _tls.stack.append(h)
        return ok

    def release(self) -> None:
        stack = _tls.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].lock is self:
                stack[i].count -= 1
                if stack[i].count == 0:
                    h = stack[i]
                    del stack[i]
                    if h.t_acquired is not None:
                        stat = self._stat
                        if stat is None:
                            stat = self._stat = _make_stat(self.name)
                        stat.record(
                            h.wait_s,
                            time.perf_counter() - h.t_acquired,
                            h.site,
                        )
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition-variable integration: threading.Condition picks these up
    # when present, so Condition(ranked_lock(...)) keeps correct owner
    # semantics (and wait() pops/pushes the hold like any release/acquire).
    def _is_owned(self) -> bool:
        return self._held_entry() is not None

    def _release_save(self):
        held = self._held_entry()
        n = held.count if held is not None else 1
        for _ in range(n):
            self.release()
        return n

    def _acquire_restore(self, n) -> None:
        for _ in range(n):
            self.acquire()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<RankedLock {self.name} rank={self.rank} seq={self.seq}>"


class RankedRLock(RankedLock):
    _factory = staticmethod(threading.RLock)


def ranked_lock(name: str, rank: int | None = None, seq: int = 0):
    """A Lock carrying `name`'s declared rank — or a plain
    `threading.Lock` when neither the sanitizer nor the profiler knob
    is on (zero overhead). With only `TENDERMINT_TPU_PROFILE_HZ` set,
    the returned lock is timing-instrumentable but never rank-checked."""
    if enabled():
        return RankedLock(name, rank, seq)
    if timing_capable():
        return RankedLock(name, rank, seq, sanitize=False)
    return threading.Lock()


def ranked_rlock(name: str, rank: int | None = None, seq: int = 0):
    if enabled():
        return RankedRLock(name, rank, seq)
    if timing_capable():
        return RankedRLock(name, rank, seq, sanitize=False)
    return threading.RLock()
