"""Contention observatory: whole-node sampling wall-clock profiler.

Every perf PR since the mesh work carries the same caveat — host-side
scaling is GIL-flat — and the multi-process refactor (ROADMAP item 4)
cannot be staged until someone *measures* where host threads burn and
where they wait. This module is that measurement: a low-overhead,
always-on-capable sampler that answers, per subsystem, "on-CPU or
blocked — and blocked on what?"

How it works, once armed:

* a background thread walks ``sys._current_frames()`` at
  ``TENDERMINT_TPU_PROFILE_HZ`` (default 29 — prime-ish, so it can't
  beat against 10 ms schedulers; ``0``/unset keeps it off, and
  ``boost()`` lights a temporary window the same way trace sampling's
  boost does);
* each thread's stack is classified into the existing subsystem
  vocabulary (consensus, ingress lane, coalescer, dispatch worker,
  p2p recv/send, statesync, rpc, abci) — by thread-name prefix first,
  innermost ``tendermint_tpu`` frame as the fallback;
* each sample is split **on-CPU vs blocked** via per-thread CPU clocks
  (``clock_gettime`` on the kernel per-thread CPUCLOCK — see
  `_thread_cpuclock_id` for why not ``pthread_getcpuclockid``): a
  thread that
  advanced its CPU clock by ≥ half the wall interval was running,
  anything else was waiting — on a lock, on I/O, or on the GIL. This
  is the direct GIL-pressure signal: a *runnable* thread that can't
  get CPU shows up blocked with reason ``other``;
* blocked samples get a best-effort reason from the innermost frame
  (``threading.py`` wait/acquire → ``lock``; selector/socket frames →
  ``io``; everything else → ``other``);
* samples aggregate into bounded per-subsystem counters and a bounded
  collapsed-stack table (flamegraph format — ``collapsed()`` emits
  ``root;frame;frame;[state] count`` lines).

Arming the profiler also arms the lock-contention timers grown into
the PR 10 ranked locks (`utils/lockrank.py` ``set_timing``): acquire
waits and holds then flow into ``tendermint_lock_wait_seconds{lock}``
/ ``tendermint_lock_hold_seconds{lock}`` with per-site attribution.
``dump_telemetry?profile=1`` serves ``snapshot()`` + the lock view +
the unified queue waits; ``tools/contention_report.py`` turns them
into the per-subsystem on-CPU/blocked waterfall.

Overhead is bench-guarded: `tools/bench_hotpath.py` ``profiler_overhead``
holds the dedup replay within 3% at the default 29 Hz with lock timing
armed (floor in tools/bench_floors.json).

The port's copy of `tendermint_tpu/telemetry/profiler.py`. It arms the
port's `utils/lockrank.py` contention timing (`set_timing`); its state
lock is the ranked `telemetry.profiler` (62).
"""

from __future__ import annotations

import os
import sys
import threading
import time

from tendermint_tpu_torch.utils import lockrank
from tendermint_tpu_torch.utils.lockrank import ranked_lock

HZ_ENV = "TENDERMINT_TPU_PROFILE_HZ"
DEFAULT_HZ = 29.0

# classification vocabulary — the fixed low-cardinality subsystem set
# (`tendermint_profile_samples_total{subsystem=}`)
SUBSYSTEMS = (
    "consensus",
    "ingress",
    "coalescer",
    "dispatch",
    "p2p_recv",
    "p2p_send",
    "statesync",
    "rpc",
    "abci",
    "main",
    "other",
)

# thread-name prefix -> subsystem, most specific first (names come from
# the package's own `threading.Thread(name=...)` sites)
_NAME_MAP: tuple[tuple[str, str], ...] = (
    ("consensus", "consensus"),  # consensus-recv / -timeout / -heartbeat
    ("gossip-", "consensus"),  # consensus reactor per-peer gossip
    ("mempool-ingress", "ingress"),
    ("mempool-bcast", "p2p_send"),
    ("verify-coalescer", "coalescer"),
    ("dispatch-", "dispatch"),
    ("warm-build", "dispatch"),
    ("mconn-recv", "p2p_recv"),
    ("mconn-", "p2p_send"),  # send + ping loops
    ("p2p-", "p2p_recv"),  # accept / handshake (inbound edge)
    ("pex-", "p2p_send"),
    ("persistent-dial", "p2p_send"),
    ("evidence-gossip", "p2p_send"),
    ("statesync", "statesync"),
    ("fastsync", "statesync"),
    ("rpc-", "rpc"),
    ("abci-", "abci"),
    ("MainThread", "main"),
)

# module-path fragment -> subsystem, scanned innermost-out when the
# thread name doesn't classify (HTTP handler threads, bare Thread-N)
_MODULE_MAP: tuple[tuple[str, str], ...] = (
    ("/mempool/ingress", "ingress"),
    ("/mempool/", "ingress"),
    ("/services/batcher", "coalescer"),
    ("/services/dispatch", "dispatch"),
    ("/services/verifier", "dispatch"),
    ("/services/hasher", "dispatch"),
    ("/ops/", "dispatch"),
    ("/parallel/", "dispatch"),
    ("/consensus/", "consensus"),
    ("/statesync/", "statesync"),
    ("/blockchain/", "statesync"),
    ("/rpc/", "rpc"),
    ("/abci/", "abci"),
    ("/p2p/", "p2p_recv"),
)

_STACK_DEPTH = 24
_ON_CPU_FRACTION = 0.5  # CPU-clock advance / wall interval threshold


def classify_thread(name: str, frame=None) -> str:
    """Subsystem for one thread: name prefix first, innermost
    `tendermint_tpu` frame as the fallback, `other` when neither
    answers."""
    for prefix, sub in _NAME_MAP:
        if name.startswith(prefix):
            return sub
    f = frame
    while f is not None:
        fn = f.f_code.co_filename
        if "tendermint_tpu" in fn:
            for frag, sub in _MODULE_MAP:
                if frag in fn:
                    return sub
        f = f.f_back
    return "other"


def blocked_reason(frame) -> str:
    """Best-effort wait reason from the innermost frames: `lock` for
    threading-module waits (Condition/Event/queue all funnel through
    them), `io` for selector/socket-shaped frames, `other` for
    everything else — including runnable-but-GIL-starved, which no
    stack can show."""
    f = frame
    depth = 0
    while f is not None and depth < 4:
        fn = f.f_code.co_filename.rsplit("/", 1)[-1]
        name = f.f_code.co_name
        if fn == "threading.py" and name in (
            "wait",
            "acquire",
            "wait_for",
            "_wait_for_tstate_lock",
        ):
            return "lock"
        # an instrumented ranked-lock acquire is a lock wait by
        # definition (plain Lock.acquire is a builtin and invisible)
        if fn == "lockrank.py" and name in (
            "acquire",
            "__enter__",
            "_acquire_restore",
        ):
            return "lock"
        if fn == "selectors.py" or name in ("select", "poll", "accept"):
            return "io"
        if name in ("recv", "_recv_exact", "recv_into", "readinto", "read"):
            return "io"
        if name == "sleep" or name.endswith("_sleep"):
            return "sleep"
        f = f.f_back
        depth += 1
    return "other"


def _frame_stack(frame, depth: int = _STACK_DEPTH) -> tuple[str, ...]:
    """`file.py:func` frames, OUTERMOST first (flamegraph root order),
    innermost `depth` frames kept."""
    out: list[str] = []
    f = frame
    while f is not None and len(out) < depth:
        code = f.f_code
        out.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
        f = f.f_back
    out.reverse()
    return tuple(out)


def collapse(subsystem: str, stack: tuple[str, ...], state: str) -> str:
    """One collapsed-stack key: subsystem as the root frame, the wait
    state as a leaf pseudo-frame — `flamegraph.pl` renders it as-is."""
    return ";".join((subsystem,) + stack + (f"[{state}]",))


def _thread_cpuclock_id(native_id: int) -> int:
    """Linux MAKE_THREAD_CPUCLOCK(tid, CPUCLOCK_SCHED): the clockid
    `clock_gettime` resolves THROUGH THE KERNEL, which validates the
    tid (a dead thread returns EINVAL). Deliberately NOT
    `pthread_getcpuclockid` — that dereferences the pthread struct,
    which is freed the moment a detached CPython thread exits, and a
    sampled thread can exit between the frame snapshot and this call."""
    return ((~native_id) << 3) | 6


def _cpu_clock(thread) -> float | None:
    """`thread`'s CPU clock (seconds), or None when unreadable (no
    native_id — foreign/exited thread — or a non-Linux platform)."""
    tid = getattr(thread, "native_id", None)
    if tid is None:
        return None
    try:
        return time.clock_gettime(_thread_cpuclock_id(tid))
    except (OSError, OverflowError, ValueError):
        return None


def _probe_cpu_clocks() -> bool:
    """Can this platform read another thread's CPU clock the safe way?
    Probed once on our own thread at import."""
    try:
        time.clock_gettime(_thread_cpuclock_id(threading.get_native_id()))
        return True
    except (AttributeError, OSError, OverflowError, ValueError):
        return False


_CPU_CLOCKS = _probe_cpu_clocks()


class ContentionProfiler:
    """The process-global sampler (`PROFILER` below, mirroring the
    FLIGHT/TRACER singletons). Bounded: per-(subsystem,state) counters,
    a capped collapsed-stack table (overflow lands in one `(truncated)`
    bucket), and a capped per-thread table — a nemesis run can churn
    thousands of short-lived threads without growing this."""

    MAX_STACKS = 4096
    MAX_THREADS = 256

    def __init__(self, hz: float | None = None) -> None:
        self._lock = ranked_lock("telemetry.profiler")
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._started = False
        self._boost_until = 0.0
        self._hz = hz
        # ident -> (wall_t, cpu_t) baseline for the on-CPU split
        self._prev: dict[int, tuple[float, float]] = {}
        self._counts: dict[tuple[str, str, str], int] = {}
        self._stacks: dict[str, int] = {}
        self._threads: dict[str, dict] = {}
        self._samples = 0
        self._ticks = 0
        self._truncated = 0

    # -- arming --------------------------------------------------------------

    def _env_hz(self) -> float:
        try:
            return float(os.environ.get(HZ_ENV, "0") or "0")
        except ValueError:
            return 0.0

    def hz(self) -> float:
        if self._hz is not None and self._hz > 0:
            return self._hz
        env = self._env_hz()
        return env if env > 0 else DEFAULT_HZ

    def _armed(self) -> bool:
        return self._started or time.monotonic() < self._boost_until

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and self._armed()

    def start(self, hz: float | None = None) -> None:
        """Arm continuously (until `stop()`); also arms the ranked-lock
        contention timers. Idempotent."""
        with self._lock:
            if hz is not None:
                self._hz = hz
            self._started = True
            self._ensure_thread_locked()
        lockrank.set_timing(True)

    def boost(self, duration_s: float = 30.0, hz: float | None = None) -> None:
        """Sample for `duration_s` then auto-disarm — the profiler twin
        of trace sampling's boost window."""
        with self._lock:
            if hz is not None:
                self._hz = hz
            self._boost_until = max(
                self._boost_until, time.monotonic() + duration_s
            )
            self._ensure_thread_locked()
        lockrank.set_timing(True)

    def stop(self) -> None:
        with self._lock:
            self._started = False
            self._boost_until = 0.0
        lockrank.set_timing(False)
        self._wake.set()

    def _ensure_thread_locked(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._wake.clear()
        self._thread = threading.Thread(
            target=self._run, name="tpu-profiler", daemon=True
        )
        self._thread.start()

    # -- sampling ------------------------------------------------------------

    def _run(self) -> None:
        while True:
            if not self._armed():
                # boost expired (or stop() raced us): disarm the lock
                # timers too, unless a restart re-armed meanwhile
                with self._lock:
                    if not self._armed():
                        self._thread = None
                        lockrank.set_timing(False)
                        return
            t0 = time.perf_counter()
            try:
                self._sample_once(t0)
            except Exception:
                # the profiler must never take the node down; a torn
                # frame walk on a dying thread just skips one tick
                pass
            elapsed = time.perf_counter() - t0
            from tendermint_tpu_torch.telemetry import metrics as _m

            _m.PROFILE_TICK_SECONDS.observe(elapsed)
            self._wake.wait(max(0.001, 1.0 / self.hz() - elapsed))

    def _sample_once(self, now: float) -> None:
        from tendermint_tpu_torch.telemetry import metrics as _m

        frames = sys._current_frames()
        threads = {t.ident: t for t in threading.enumerate()}
        me = threading.get_ident()
        merged: list[tuple[str, str, str, str, tuple[str, ...]]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue
            t = threads.get(ident)
            name = t.name if t is not None else f"tid-{ident}"
            sub = classify_thread(name, frame)
            reason = blocked_reason(frame)
            cpu = _cpu_clock(t) if _CPU_CLOCKS else None
            prev = self._prev.get(ident)
            if cpu is not None:
                self._prev[ident] = (now, cpu)
            if cpu is not None and prev is not None:
                dt, dcpu = now - prev[0], cpu - prev[1]
                on_cpu = dt > 0 and (dcpu / dt) >= _ON_CPU_FRACTION
            elif cpu is not None:
                continue  # first sight: no baseline yet, skip one tick
            else:
                # no per-thread CPU clocks on this platform: fall back
                # to the stack heuristic alone
                on_cpu = reason == "other"
            state = "on_cpu" if on_cpu else "blocked"
            wait = "" if on_cpu else reason
            merged.append((name, sub, state, wait, _frame_stack(frame)))
        # prune baselines of exited threads so the table stays bounded
        if len(self._prev) > 4 * max(1, len(frames)):
            live = set(frames)
            self._prev = {
                k: v for k, v in self._prev.items() if k in live
            }
        with self._lock:
            self._ticks += 1
            for name, sub, state, wait, stack in merged:
                self._samples += 1
                key = (sub, state, wait)
                self._counts[key] = self._counts.get(key, 0) + 1
                line = collapse(
                    sub,
                    stack,
                    state if state == "on_cpu" else f"blocked:{wait}",
                )
                if line in self._stacks or len(self._stacks) < self.MAX_STACKS:
                    self._stacks[line] = self._stacks.get(line, 0) + 1
                else:
                    self._truncated += 1
                th = self._threads.get(name)
                if th is None:
                    if len(self._threads) >= self.MAX_THREADS:
                        continue
                    th = self._threads[name] = {
                        "subsystem": sub,
                        "samples": 0,
                        "on_cpu": 0,
                    }
                th["samples"] += 1
                if state == "on_cpu":
                    th["on_cpu"] += 1
        for name, sub, state, wait, _stack in merged:
            _m.PROFILE_SAMPLES.labels(
                subsystem=sub, state=state, wait=wait or "none"
            ).inc()

    # -- reads ---------------------------------------------------------------

    def snapshot(self, top_stacks: int = 20) -> dict:
        """Aggregate view: per-subsystem on-CPU/blocked splits with
        wait reasons, a bounded per-thread table (thread-name
        cardinality ⇒ dump-only, docs/OBSERVABILITY.md), and the
        hottest collapsed stacks."""
        with self._lock:
            subsystems: dict[str, dict] = {}
            for (sub, state, wait), n in self._counts.items():
                row = subsystems.setdefault(
                    sub, {"on_cpu": 0, "blocked": 0, "blocked_by": {}}
                )
                if state == "on_cpu":
                    row["on_cpu"] += n
                else:
                    row["blocked"] += n
                    row["blocked_by"][wait] = (
                        row["blocked_by"].get(wait, 0) + n
                    )
            stacks = sorted(
                self._stacks.items(), key=lambda kv: kv[1], reverse=True
            )[: max(0, top_stacks)]
            return {
                "armed": self._armed(),
                "hz": self.hz(),
                "cpu_clock": _CPU_CLOCKS,
                "ticks": self._ticks,
                "samples": self._samples,
                "truncated_stacks": self._truncated,
                "subsystems": subsystems,
                "threads": dict(self._threads),
                "top_stacks": [
                    {"stack": line, "count": n} for line, n in stacks
                ],
            }

    def collapsed(self) -> list[str]:
        """Flamegraph lines, `stack count` — pipe into flamegraph.pl or
        speedscope. Deterministic order (count desc, then lexical)."""
        with self._lock:
            items = list(self._stacks.items())
        items.sort(key=lambda kv: (-kv[1], kv[0]))
        return [f"{line} {n}" for line, n in items]

    def reset(self) -> None:
        with self._lock:
            self._prev.clear()
            self._counts.clear()
            self._stacks.clear()
            self._threads.clear()
            self._samples = 0
            self._ticks = 0
            self._truncated = 0


PROFILER = ContentionProfiler()


def maybe_start_env() -> bool:
    """Start the global profiler when `TENDERMINT_TPU_PROFILE_HZ` > 0
    (node start calls this); returns whether it is running."""
    try:
        hz = float(os.environ.get(HZ_ENV, "0") or "0")
    except ValueError:
        return PROFILER.running()
    if hz > 0:
        PROFILER.start(hz=hz)
    return PROFILER.running()
