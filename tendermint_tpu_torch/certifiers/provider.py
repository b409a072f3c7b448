"""FullCommit storage providers (reference `certifiers/provider.go`,
`memprovider.go`, `files/`).

`get_by_height(h)` returns the stored FullCommit with the LARGEST
height <= h (the bisection walk's primitive).
"""

from __future__ import annotations

import bisect
import os
import threading

from tendermint_tpu_torch.certifiers.certifier import FullCommit


class Provider:
    def store_commit(self, fc: FullCommit) -> None:
        raise NotImplementedError

    def get_by_height(self, height: int) -> FullCommit | None:
        raise NotImplementedError

    def latest_commit(self) -> FullCommit | None:
        raise NotImplementedError


class MemProvider(Provider):
    """In-memory provider (reference `memprovider.go`)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._heights: list[int] = []
        self._by_height: dict[int, FullCommit] = {}

    def store_commit(self, fc: FullCommit) -> None:
        with self._lock:
            h = fc.height()
            if h not in self._by_height:
                bisect.insort(self._heights, h)
            self._by_height[h] = fc

    def get_by_height(self, height: int) -> FullCommit | None:
        with self._lock:
            i = bisect.bisect_right(self._heights, height)
            if i == 0:
                return None
            return self._by_height[self._heights[i - 1]]

    def latest_commit(self) -> FullCommit | None:
        with self._lock:
            if not self._heights:
                return None
            return self._by_height[self._heights[-1]]


class FileProvider(Provider):
    """Directory-backed provider, one encoded FullCommit per height
    (reference `files/provider.go`). Survives restarts — the light
    client's trust store."""

    def __init__(self, dir_path: str) -> None:
        self._dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self._lock = threading.RLock()

    def _path(self, height: int) -> str:
        return os.path.join(self._dir, f"{height:012d}.fc")

    def _heights(self) -> list[int]:
        out = []
        for name in os.listdir(self._dir):
            if name.endswith(".fc"):
                try:
                    out.append(int(name[:-3]))
                except ValueError:
                    continue
        return sorted(out)

    def store_commit(self, fc: FullCommit) -> None:
        with self._lock:
            tmp = self._path(fc.height()) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(fc.encode())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(fc.height()))

    def get_by_height(self, height: int) -> FullCommit | None:
        with self._lock:
            heights = self._heights()
            i = bisect.bisect_right(heights, height)
            if i == 0:
                return None
            with open(self._path(heights[i - 1]), "rb") as f:
                return FullCommit.decode(f.read())

    def latest_commit(self) -> FullCommit | None:
        with self._lock:
            heights = self._heights()
            if not heights:
                return None
            with open(self._path(heights[-1]), "rb") as f:
                return FullCommit.decode(f.read())
