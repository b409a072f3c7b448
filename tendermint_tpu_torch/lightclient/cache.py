"""CertifiedCommitCache: sharded, positives-only FullCommit cache.

The proof cache in front of the certifier walk. Discipline mirrors the
`VerifiedSigCache` (services/batcher.py): ONLY commits that passed
certification enter (`put_certified` is the single write path, called
after a walk/skip verification succeeded), so a forged FullCommit can
never pin trust — a lookup hit means "this exact commit was proven by
this process (or a previous run, via the durable store)".

Layout: height-sharded entry maps under per-shard locks (concurrent
readers on the serving path never contend on one lock) + one compact
sorted height index for the floor-lookup contract
(`get_by_height(h)` -> largest cached height <= h, the provider
primitive bisection restarts from). An optional `FullCommitStore`
(db/fullcommit.py) makes the cache write-through durable: a restarted
replica reloads exactly the trust it had proven.

Telemetry: tendermint_lightclient_cache_{hits,misses}_total.

The port's copy of `tendermint_tpu/lightclient/cache.py`. Its shard and
index locks are the ranked `lightclient.cache` (63), `seq` the shard.
"""

from __future__ import annotations

import bisect as _bisect

from tendermint_tpu_torch.certifiers.certifier import FullCommit
from tendermint_tpu_torch.certifiers.provider import Provider
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.utils.lockrank import ranked_lock

DEFAULT_CACHE_SIZE = 2048


class CertifiedCommitCache(Provider):
    """Thread-safe LRU-ish cache of CERTIFIED FullCommits by height.

    Provider-compatible so it slots straight in as a certifier's
    `trusted` store; `store_commit` is an alias of `put_certified` —
    certifiers only store commits they proved, which is exactly the
    positives-only contract.
    """

    SHARDS = 8

    def __init__(self, capacity: int | None = None, store=None) -> None:
        self.capacity = DEFAULT_CACHE_SIZE if capacity is None else capacity
        self.store = store
        self._shards = [
            (ranked_lock("lightclient.cache", seq=i), {})
            for i in range(self.SHARDS)
        ]
        # sorted height index for floor lookups; guarded by shard 0's
        # lock sibling (its own lock instance, same rank — never nested
        # with the shard locks)
        self._index_lock = ranked_lock("lightclient.cache", seq=self.SHARDS)
        self._heights: list[int] = []
        if store is not None:
            # warm from the durable half: everything in the store was
            # certified before it was persisted
            for h in store.heights():
                self._heights.append(h)
            self._heights.sort()

    def _shard(self, height: int):
        return self._shards[height % self.SHARDS]

    # -- write path (certified commits ONLY) -------------------------------

    def put_certified(self, fc: FullCommit) -> None:
        """Admit one PROVEN FullCommit. Callers must only pass commits
        whose certification succeeded — there is deliberately no way to
        cache a rejection, so a forged commit is re-verified (and
        re-rejected) on every offer."""
        h = fc.height()
        lock, entries = self._shard(h)
        with lock:
            entries[h] = fc
        self._index_insert(h)
        if self.store is not None:
            self.store.store_commit(fc)
        self._evict_over_capacity()

    def _index_insert(self, h: int) -> None:
        with self._index_lock:
            i = _bisect.bisect_left(self._heights, h)
            if i >= len(self._heights) or self._heights[i] != h:
                self._heights.insert(i, h)

    def store_commit(self, fc: FullCommit) -> None:
        self.put_certified(fc)

    def _evict_over_capacity(self) -> None:
        """Oldest-height eviction: the hot heights on a serving replica
        are the recent ones (hot-height skew), and floor lookups stay
        correct — an evicted height just restarts a walk lower."""
        if self.capacity <= 0:
            return
        while True:
            with self._index_lock:
                if len(self._heights) <= self.capacity:
                    return
                h = self._heights.pop(0)
            lock, entries = self._shard(h)
            with lock:
                entries.pop(h, None)

    # -- read path ----------------------------------------------------------

    def get_exact(self, height: int) -> FullCommit | None:
        """Exact-height lookup (the proof-serving path)."""
        lock, entries = self._shard(height)
        with lock:
            fc = entries.get(height)
        if fc is not None:
            _metrics.LIGHTCLIENT_CACHE_HITS.inc()
            return fc
        if self.store is not None:
            fc = self.store.get_exact(height)
            if fc is not None:
                # re-admit the durable entry to the hot tier — and back
                # into the height index, or the evictor (which only
                # drops heights it pops from the index) never sees it
                # and the shard grows without bound
                with lock:
                    entries[height] = fc
                self._index_insert(height)
                self._evict_over_capacity()
                _metrics.LIGHTCLIENT_CACHE_HITS.inc()
                return fc
        _metrics.LIGHTCLIENT_CACHE_MISSES.inc()
        return None

    def get_by_height(self, height: int) -> FullCommit | None:
        """Floor lookup (provider contract): newest certified commit at
        or below `height`."""
        with self._index_lock:
            i = _bisect.bisect_right(self._heights, height)
            h = self._heights[i - 1] if i > 0 else None
        if h is None:
            _metrics.LIGHTCLIENT_CACHE_MISSES.inc()
            return None
        return self.get_exact(h)

    def latest_commit(self) -> FullCommit | None:
        with self._index_lock:
            h = self._heights[-1] if self._heights else None
        return self.get_exact(h) if h is not None else None

    def latest_height(self) -> int:
        with self._index_lock:
            return self._heights[-1] if self._heights else 0

    def __len__(self) -> int:
        with self._index_lock:
            return len(self._heights)

    def stats(self) -> dict:
        """Cache-warmth view for `/health`'s serving section."""
        return {
            "capacity": self.capacity,
            "entries": len(self),
            "latest_height": self.latest_height(),
            "hits": _metrics.LIGHTCLIENT_CACHE_HITS.value,
            "misses": _metrics.LIGHTCLIENT_CACHE_MISSES.value,
        }
