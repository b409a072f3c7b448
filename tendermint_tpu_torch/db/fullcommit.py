"""FullCommitStore: DB-backed persistence for CERTIFIED FullCommits.

The durable half of the light-client serving layer's proof cache (the
JAX package's `lightclient/cache.py`): one encoded FullCommit per
height under `fc:%012d` keys, with the `get_by_height` floor-lookup
contract every certifier provider shares (largest stored height <= h —
the bisection walk's restart primitive, `certifiers/provider.py`).

Trust discipline is the CALLER's: only commits that passed
certification may be stored (the cache layer enforces it, same
never-cache-a-negative rule as the VerifiedSigCache) — the store
itself is a dumb ordered map, so a replica restart reloads exactly the
trust it had proven, nothing more.

`prune(keep_recent)` bounds the footprint on long-lived replicas: the
newest N commits stay, plus every retained height stays reachable via
the floor lookup through the gaps below.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.certifiers.certifier import FullCommit
from tendermint_tpu_torch.certifiers.provider import Provider
from tendermint_tpu_torch.db.kv import DB

_PREFIX = b"fc:"


def _key(height: int) -> bytes:
    return _PREFIX + b"%012d" % height


class FullCommitStore(Provider):
    """Ordered-KV-backed Provider of certified FullCommits."""

    def __init__(self, db: DB) -> None:
        self._db = db
        self._lock = threading.RLock()
        # height index kept hot: the floor lookup must not scan the DB
        # per query on the serving path
        self._heights: list[int] = [
            int(k[len(_PREFIX):]) for k, _v in db.iterate(_PREFIX)
        ]
        self._heights.sort()

    def store_commit(self, fc: FullCommit) -> None:
        import bisect

        h = fc.height()
        with self._lock:
            known = self._heights and self._in_index(h)
            self._db.set(_key(h), fc.encode())
            if not known:
                bisect.insort(self._heights, h)

    def _in_index(self, height: int) -> bool:
        import bisect

        i = bisect.bisect_left(self._heights, height)
        return i < len(self._heights) and self._heights[i] == height

    def get_by_height(self, height: int) -> FullCommit | None:
        import bisect

        with self._lock:
            i = bisect.bisect_right(self._heights, height)
            if i == 0:
                return None
            raw = self._db.get(_key(self._heights[i - 1]))
        return FullCommit.decode(raw) if raw is not None else None

    def get_exact(self, height: int) -> FullCommit | None:
        """Exact-height lookup (the serving path: a proof request for
        height H must never be answered with H-1's commit)."""
        raw = self._db.get(_key(height))
        return FullCommit.decode(raw) if raw is not None else None

    def latest_commit(self) -> FullCommit | None:
        with self._lock:
            if not self._heights:
                return None
            raw = self._db.get(_key(self._heights[-1]))
        return FullCommit.decode(raw) if raw is not None else None

    def latest_height(self) -> int:
        with self._lock:
            return self._heights[-1] if self._heights else 0

    def heights(self) -> list[int]:
        with self._lock:
            return list(self._heights)

    def __len__(self) -> int:
        with self._lock:
            return len(self._heights)

    def prune(self, keep_recent: int) -> int:
        """Drop all but the newest `keep_recent` commits; returns the
        number pruned. 0 keeps everything."""
        if keep_recent <= 0:
            return 0
        with self._lock:
            drop = self._heights[:-keep_recent]
            if not drop:
                return 0
            for h in drop:
                self._db.delete(_key(h))
            self._heights = self._heights[-keep_recent:]
        return len(drop)
