"""Minimal ordered key-value store interface + backends.

Mirrors the `dbm.DB` seam in the reference (`tmlibs/db`): Get/Set/Delete
with synchronous variants and ordered iteration; consumers are the block
store, state DB, tx index, and address book.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Iterator


class DB:
    """Interface: bytes -> bytes with ordered iteration."""

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def iterate(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemDB(DB):
    """In-memory store (reference memdb) — tests and replay fakes."""

    def __init__(self) -> None:
        self._data: dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._data.get(bytes(key))

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data[bytes(key)] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._data.pop(bytes(key), None)

    def iterate(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        with self._lock:
            items = sorted(
                (k, v) for k, v in self._data.items() if k.startswith(prefix)
            )
        yield from items


class SQLiteDB(DB):
    """SQLite-backed store — the persistent backend (goleveldb's role).

    WAL journal mode gives crash safety with one fsync per commit;
    `set_sync` additionally checkpoints for consensus-critical writes
    (the reference distinguishes SetSync at the same call sites).
    """

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )
            self._conn.commit()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (bytes(key),)
            ).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                (bytes(key), bytes(value)),
            )
            self._conn.commit()

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)
        with self._lock:
            self._conn.execute("PRAGMA wal_checkpoint(FULL)")

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (bytes(key),))
            self._conn.commit()

    def iterate(self, prefix: bytes = b"") -> Iterator[tuple[bytes, bytes]]:
        with self._lock:
            if prefix:
                hi = bytes(prefix[:-1] + bytes([prefix[-1] + 1])) if prefix[-1] < 255 else None
                if hi is not None:
                    rows = self._conn.execute(
                        "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                        (bytes(prefix), hi),
                    ).fetchall()
                else:
                    rows = self._conn.execute(
                        "SELECT k, v FROM kv WHERE k >= ? ORDER BY k", (bytes(prefix),)
                    ).fetchall()
                    rows = [(k, v) for k, v in rows if bytes(k).startswith(prefix)]
            else:
                rows = self._conn.execute("SELECT k, v FROM kv ORDER BY k").fetchall()
        for k, v in rows:
            yield bytes(k), bytes(v)

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def db_provider(name: str, backend: str, db_dir: str) -> DB:
    """Factory matching the reference's node DBProvider seam
    (`node/node.go:59-72`)."""
    if backend == "memdb":
        return MemDB()
    if backend == "sqlite":
        return SQLiteDB(os.path.join(db_dir, f"{name}.db"))
    raise ValueError(f"unknown db backend {backend!r}")
