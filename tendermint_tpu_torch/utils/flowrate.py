"""Flow-rate monitoring + throttling (reference `tmlibs/flowrate`,
used per peer connection at `p2p/connection.go:72-73` with the
500 kB/s default caps at `config/config.go:244-247`).

The port's copy of `tendermint_tpu/utils/flowrate.py`; its lock is the
ranked leaf `p2p.flowrate`.
"""

from __future__ import annotations

import threading
import time

from tendermint_tpu_torch.utils.lockrank import ranked_lock


class Monitor:
    """Byte-rate tracker with an exponential moving average, plus an
    optional limit: `throttle()` sleeps just enough to keep the average
    under the cap (the reference's blocking `Limit` mode)."""

    def __init__(
        self,
        limit_bytes_per_s: int = 0,
        window_s: float = 1.0,
        time_fn=time.monotonic,
    ) -> None:
        self.limit = limit_bytes_per_s
        self._window = window_s
        self._time = time_fn
        self._lock = ranked_lock("p2p.flowrate")
        self._total = 0
        self._rate = 0.0
        self._bucket = 0
        self._bucket_start = self._time()

    def update(self, n: int) -> None:
        with self._lock:
            self._total += n
            self._bucket += n
            self._roll()

    def _roll(self) -> None:
        now = self._time()
        elapsed = now - self._bucket_start
        if elapsed >= self._window:
            inst = self._bucket / elapsed
            # EMA: half the weight to the newest full window
            self._rate = inst if self._rate == 0 else (self._rate + inst) / 2
            self._bucket = 0
            self._bucket_start = now

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    @property
    def rate(self) -> float:
        """Bytes/s over the recent window."""
        with self._lock:
            self._roll()
            now = self._time()
            elapsed = now - self._bucket_start
            if elapsed > 0.05:
                inst = self._bucket / elapsed
                return (self._rate + inst) / 2 if self._rate else inst
            return self._rate

    def throttle(self) -> None:
        """Sleep long enough that the current window stays under the
        limit; no-op when unlimited."""
        if self.limit <= 0:
            return
        with self._lock:
            now = self._time()
            elapsed = now - self._bucket_start
            ahead = self._bucket / self.limit - elapsed
        if ahead > 0:
            time.sleep(min(ahead, self._window))
