"""Address book: remembered peer addresses with new/old buckets.

Reference `p2p/addrbook.go:28-98` — bitcoin-style: addresses arrive in
NEW buckets (hashed by source group so one gossiper can't flood a
bucket), get promoted to OLD buckets after a successful connection,
accumulate failed-attempt counts, and persist to a JSON file. The
bucket/eviction structure is kept; the crypto-hardened salting is a
plain keyed hash here.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
from dataclasses import dataclass

NEW_BUCKETS = 64
OLD_BUCKETS = 16
BUCKET_SIZE = 32
MAX_ATTEMPTS = 5  # drop a new address after this many failed dials
MAX_OLD_ATTEMPTS = 10  # demote an old address back to new after this many


@dataclass
class NetAddress:
    node_id: str
    addr: str  # "host:port"

    @property
    def host(self) -> str:
        return self.addr.rpartition(":")[0]

    def to_dict(self) -> dict:
        return {"node_id": self.node_id, "addr": self.addr}

    @classmethod
    def from_dict(cls, d: dict) -> "NetAddress":
        return cls(node_id=d["node_id"], addr=d["addr"])


@dataclass
class _Entry:
    address: NetAddress
    src_id: str = ""
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    is_old: bool = False
    bucket: int = 0


SAVE_INTERVAL_S = 5.0  # debounce: reference persists on a periodic routine


class AddrBook:
    def __init__(self, file_path: str | None = None, key: bytes | None = None):
        self._path = file_path
        self._key = key if key is not None else os.urandom(8)
        self._lock = threading.RLock()
        self._entries: dict[str, _Entry] = {}  # node_id -> entry
        self._rng = random.Random()
        self._dirty = False
        self._last_save = 0.0
        if file_path and os.path.exists(file_path):
            self._load()

    # -- bucketing ---------------------------------------------------------

    def _bucket(self, addr: NetAddress, src_id: str, old: bool) -> int:
        n = OLD_BUCKETS if old else NEW_BUCKETS
        group = addr.host if old else src_id  # new buckets keyed by SOURCE
        h = hashlib.sha256(self._key + group.encode() + addr.node_id.encode())
        return int.from_bytes(h.digest()[:4], "big") % n

    def _bucket_load(self, bucket: int, old: bool) -> int:
        return sum(
            1
            for e in self._entries.values()
            if e.is_old == old and e.bucket == bucket
        )

    # -- writes ------------------------------------------------------------

    def add_address(self, addr: NetAddress, src_id: str = "") -> bool:
        """Record an address heard from `src_id` (reference `AddAddress`).
        Known-old addresses are left alone; a full bucket evicts the
        stalest NEW entry."""
        if not addr.addr or not addr.node_id:
            return False
        with self._lock:
            cur = self._entries.get(addr.node_id)
            if cur is not None:
                # never let later gossip overwrite a stored dial address
                # (an attacker could re-point NEW entries at itself — the
                # eclipse vector the reference's no-overwrite rule closes)
                return False
            bucket = self._bucket(addr, src_id, old=False)
            if self._bucket_load(bucket, old=False) >= BUCKET_SIZE:
                self._evict_new(bucket)
            self._entries[addr.node_id] = _Entry(
                address=addr, src_id=src_id, bucket=bucket
            )
            self._save()
            return True

    def _evict_new(self, bucket: int) -> None:
        victims = [
            (nid, e)
            for nid, e in self._entries.items()
            if not e.is_old and e.bucket == bucket
        ]
        if victims:
            nid, _ = min(victims, key=lambda kv: kv[1].last_success or 0)
            del self._entries[nid]

    def mark_attempt(self, node_id: str) -> None:
        with self._lock:
            e = self._entries.get(node_id)
            if e is None:
                return
            e.attempts += 1
            e.last_attempt = time.time()
            if not e.is_old and e.attempts >= MAX_ATTEMPTS:
                del self._entries[node_id]  # consistently unreachable
            elif e.is_old and e.attempts >= MAX_OLD_ATTEMPTS:
                # a proven address that went dark: demote so it competes
                # as NEW again and can age out instead of being redialed
                # forever (reference moveToNew on repeated failure)
                e.is_old = False
                e.attempts = 0
                e.bucket = self._bucket(e.address, e.src_id, old=False)
            self._save()

    def mark_good(self, node_id: str) -> None:
        """Successful connection: promote to an OLD bucket (reference
        `MarkGood` / `moveToOld`)."""
        with self._lock:
            e = self._entries.get(node_id)
            if e is None:
                return
            e.attempts = 0
            e.last_success = time.time()
            if not e.is_old:
                e.is_old = True
                e.bucket = self._bucket(e.address, e.src_id, old=True)
            self._save()

    def remove(self, node_id: str) -> None:
        with self._lock:
            self._entries.pop(node_id, None)
            self._save()

    # -- reads -------------------------------------------------------------

    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def has(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self._entries

    def pick_address(
        self, bias_old: float = 0.5, exclude: set[str] | None = None
    ) -> NetAddress | None:
        """Random address to dial, biased between old (proven) and new
        entries (reference `PickAddress`); `exclude` filters node ids
        already connected or already attempted this pass."""
        with self._lock:
            entries = [
                e
                for e in self._entries.values()
                if not exclude or e.address.node_id not in exclude
            ]
            old = [e for e in entries if e.is_old]
            new = [e for e in entries if not e.is_old]
            pool = old if (old and self._rng.random() < bias_old) else new
            pool = pool or old
            if not pool:
                return None
            return self._rng.choice(pool).address

    def sample(self, n: int = 16) -> list[NetAddress]:
        """Random subset for a PEX response (reference `GetSelection`)."""
        with self._lock:
            entries = list(self._entries.values())
            self._rng.shuffle(entries)
            return [e.address for e in entries[:n]]

    # -- persistence -------------------------------------------------------

    def _save(self) -> None:
        """Debounced: mutations mark dirty; the file is rewritten at most
        once per SAVE_INTERVAL_S (reference `dumpAddressRoutine` persists
        periodically, not per mutation — a 32-address PEX message would
        otherwise serialize the whole book 32 times inside the peer's
        recv thread). Call `flush()` for a synchronous write (shutdown).
        """
        self._dirty = True
        if time.time() - self._last_save < SAVE_INTERVAL_S:
            return
        self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            if self._dirty:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._path:
            self._dirty = False
            return
        self._dirty = False
        self._last_save = time.time()
        doc = {
            "key": self._key.hex(),
            "entries": [
                {
                    **e.address.to_dict(),
                    "src_id": e.src_id,
                    "attempts": e.attempts,
                    "last_success": e.last_success,
                    "is_old": e.is_old,
                    "bucket": e.bucket,
                }
                for e in self._entries.values()
            ],
        }
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self._path)

    def _load(self) -> None:
        with open(self._path) as f:
            doc = json.load(f)
        self._key = bytes.fromhex(doc["key"])
        for d in doc["entries"]:
            e = _Entry(
                address=NetAddress.from_dict(d),
                src_id=d.get("src_id", ""),
                attempts=d.get("attempts", 0),
                last_success=d.get("last_success", 0.0),
                is_old=d.get("is_old", False),
                bucket=d.get("bucket", 0),
            )
            self._entries[e.address.node_id] = e
