"""Orderly interpreter exit for the port's background threads.

The port runs torch in daemon threads: the table `prebuild`, the kernel
warm-up, the dispatch worker's launches and the coalescer's joins. A
daemon thread that is still in torch, or still ending after torch work,
while the interpreter finalizes ends the process with SIGABRT
("terminate called without an active exception", exit code 134).

Two tools keep that from happening:

* `section()` marks one piece of torch work in a long-lived worker (a
  launch, a join). The exit hook waits for the sections in progress to
  end; once it has run, a section refuses to start (`ShuttingDown`).
* `start_thread()` starts a one-shot daemon thread (a prebuild, a
  warm-up) whose body runs in a section; the exit hook also joins it,
  so that it has ended before the interpreter finalizes. Its owner can
  stop it early through the `stop` event it passes (a closed verifier).

Long work (a table build) calls `check()` between its steps, so a
section ends within one step of the exit or of its thread's `stop`.
The hook waits `EXIT_WAIT_S` at most. An idle worker blocked on its
queue holds no torch frame and is not waited for.

`at_exit(fn)` runs `fn` after that wait: the launch ledger's and the
span log's files, which worker threads write, close there, once no
section is left to write them.
"""

from __future__ import annotations

import atexit
import logging
import threading
import time
import weakref
from contextlib import contextmanager

from tendermint_tpu_torch.utils.log import kv, logger

EXIT_WAIT_S = 30.0

_exiting = threading.Event()
_cond = threading.Condition(threading.Lock())
_active = 0
_threads: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
_local = threading.local()  # .stop: the `stop` event of this thread
_exit_hooks: list = []


class ShuttingDown(RuntimeError):
    """The interpreter is exiting, or the owner of a background thread
    stopped it: background work stops here."""


def check() -> None:
    """Raise `ShuttingDown` once the exit hook has run, or once the
    `stop` event of this `start_thread` thread is set."""
    if _exiting.is_set():
        raise ShuttingDown("interpreter exiting")
    stop = getattr(_local, "stop", None)
    if stop is not None and stop.is_set():
        raise ShuttingDown("stopped by its owner")


@contextmanager
def section():
    """Mark torch work in progress; the exit hook waits for it to end.
    Refuses to start once the exit hook has run."""
    global _active
    with _cond:
        check()
        _active += 1
    try:
        yield
    finally:
        with _cond:
            _active -= 1
            _cond.notify_all()


def start_thread(target, name: str, *args, stop: threading.Event | None = None) -> threading.Thread:
    """Run `target(*args)` in a section of a new daemon thread that the
    exit hook joins; `ShuttingDown` ends it quietly, and `check()` in it
    also raises once `stop` is set. Returns the started thread."""

    def run() -> None:
        _local.stop = stop
        try:
            with section():
                target(*args)
        except ShuttingDown:
            pass

    t = threading.Thread(target=run, name=name, daemon=True)
    with _cond:
        _threads.add(t)
    t.start()
    return t


def at_exit(fn) -> None:
    """Run `fn()` at interpreter exit, after the background work has
    drained (in registration order; an error is logged, not raised)."""
    _exit_hooks.append(fn)


def _drain() -> None:
    _exiting.set()
    deadline = time.monotonic() + EXIT_WAIT_S
    with _cond:
        while _active and (left := deadline - time.monotonic()) > 0:
            _cond.wait(left)
        threads = list(_threads)
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    running = sum(t.is_alive() for t in threads)
    if _active or running:
        kv(
            logger("shutdown"),
            logging.WARNING,
            "background torch work still running at exit",
            sections=_active,
            threads=running,
            waited_s=EXIT_WAIT_S,
        )
    for fn in _exit_hooks:
        try:
            fn()
        except Exception as e:  # the exit goes on
            kv(logger("shutdown"), logging.WARNING, "exit hook failed", error=repr(e)[:200])


atexit.register(_drain)
