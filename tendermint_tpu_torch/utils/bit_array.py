"""Thread-safe bit array (role of tmlibs `cmn.BitArray`; used for vote
bookkeeping `types/vote_set.go` and part-set completion tracking)."""

from __future__ import annotations

import random
import threading


class BitArray:
    def __init__(self, n: int, bits: int = 0):
        if n < 0:
            raise ValueError("negative size")
        self._n = n
        self._bits = bits & ((1 << n) - 1) if n else 0
        self._lock = threading.RLock()

    @property
    def size(self) -> int:
        return self._n

    def get(self, i: int) -> bool:
        if not (0 <= i < self._n):
            return False
        with self._lock:
            return bool((self._bits >> i) & 1)

    def set(self, i: int, v: bool) -> bool:
        if not (0 <= i < self._n):
            return False
        with self._lock:
            if v:
                self._bits |= 1 << i
            else:
                self._bits &= ~(1 << i)
        return True

    def copy(self) -> "BitArray":
        with self._lock:
            return BitArray(self._n, self._bits)

    def or_(self, other: "BitArray") -> "BitArray":
        return BitArray(max(self._n, other._n), self._bits | other._bits)

    def and_(self, other: "BitArray") -> "BitArray":
        return BitArray(min(self._n, other._n), self._bits & other._bits)

    def not_(self) -> "BitArray":
        return BitArray(self._n, ~self._bits)

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other."""
        return BitArray(self._n, self._bits & ~other._bits)

    def count(self) -> int:
        """Number of set bits."""
        with self._lock:
            return self._bits.bit_count()

    def is_empty(self) -> bool:
        with self._lock:
            return self._bits == 0

    def is_full(self) -> bool:
        with self._lock:
            return self._n > 0 and self._bits == (1 << self._n) - 1

    def pick_random(self, rng: random.Random | None = None) -> tuple[int, bool]:
        """A uniformly random set bit (used by gossip to pick a part to send,
        reference `consensus/reactor.go:418-497`)."""
        with self._lock:
            set_bits = [i for i in range(self._n) if (self._bits >> i) & 1]
        if not set_bits:
            return 0, False
        r = rng or random
        return r.choice(set_bits), True

    def num_set(self) -> int:
        with self._lock:
            return bin(self._bits).count("1")

    def to_int(self) -> int:
        with self._lock:
            return self._bits

    def update(self, other: "BitArray") -> None:
        with self._lock:
            self._bits = other._bits & ((1 << self._n) - 1) if self._n else 0

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, BitArray):
            return NotImplemented
        return self._n == other._n and self._bits == other._bits

    def __repr__(self) -> str:
        return "BA{" + "".join("x" if self.get(i) else "_" for i in range(self._n)) + "}"
