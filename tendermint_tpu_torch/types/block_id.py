"""BlockID: block hash + part-set header (reference `types/block.go` BlockID)."""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.codec import Reader, Writer
from tendermint_tpu_torch.types.part_set import PartSetHeader


@dataclass(frozen=True)
class BlockID:
    hash: bytes
    parts_header: PartSetHeader

    @classmethod
    def zero(cls) -> "BlockID":
        return cls(hash=b"", parts_header=PartSetHeader.zero())

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.parts_header.is_zero()

    def key(self) -> bytes:
        """Stable dict key for vote tallies (reference `BlockID.Key`)."""
        return self.hash + b"|" + self.parts_header.hash + self.parts_header.total.to_bytes(8, "little")

    def encode(self) -> bytes:
        return Writer().bytes(self.hash).raw(self.parts_header.encode()).build()

    @classmethod
    def decode_from(cls, r: Reader) -> "BlockID":
        h = r.bytes()
        psh = PartSetHeader.decode_from(r)
        return cls(hash=h, parts_header=psh)

    def to_dict(self) -> dict:
        """Canonical-JSON form for sign-bytes (reference types/canonical_json.go)."""
        return {
            "hash": self.hash,
            "parts": {"total": self.parts_header.total, "hash": self.parts_header.hash},
        }

    def __str__(self) -> str:
        return f"{self.hash.hex()[:12]}:{self.parts_header.total}"
