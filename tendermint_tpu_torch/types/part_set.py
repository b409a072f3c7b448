"""PartSet: block sharding with Merkle integrity proofs.

Role of `types/part_set.go` in the reference: a serialized block (the "long
sequence") is split into fixed-size parts, each carrying a Merkle inclusion
proof against the PartSetHeader root, gossiped peer-to-peer and reassembled
(`types/part_set.go:95-133,188-214`). This is the reference's blockwise
sequence-sharding structure (SURVEY.md §5.7); a `TreeHasher` passed as
`hasher=` builds all part proofs in one batched tree reduction.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from tendermint_tpu_torch.codec import Reader, Writer
from tendermint_tpu_torch.merkle import (
    SimpleProof,
    simple_proofs_from_byte_slices,
    verify_proof,
)
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.utils.bit_array import BitArray

DEFAULT_PART_SIZE = 4096  # reference: ConsensusParams.BlockPartSizeBytes (types/params.go:20-25)


@dataclass(frozen=True)
class PartSetHeader:
    total: int
    hash: bytes

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def encode(self) -> bytes:
        return Writer().uvarint(self.total).bytes(self.hash).build()

    @classmethod
    def decode_from(cls, r: Reader) -> "PartSetHeader":
        return cls(total=r.uvarint(), hash=r.bytes())

    def to_dict(self) -> dict:
        return {"total": self.total, "hash": self.hash}

    @classmethod
    def zero(cls) -> "PartSetHeader":
        return cls(total=0, hash=b"")


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: SimpleProof

    def encode(self) -> bytes:
        return (
            Writer().uvarint(self.index).bytes(self.bytes_).bytes(self.proof.encode()).build()
        )

    @classmethod
    def decode(cls, data: bytes) -> "Part":
        r = Reader(data)
        index = r.uvarint()
        bytes_ = r.bytes()
        proof = SimpleProof.decode(r.bytes())
        r.expect_done()
        return cls(index=index, bytes_=bytes_, proof=proof)


class PartSet:
    """Complete (maker side) or incrementally-filled (gossip side) part set."""

    def __init__(self, header: PartSetHeader):
        self.header = header
        self._parts: list[Part | None] = [None] * header.total
        self.parts_bit_array = BitArray(header.total)
        self._count = 0
        # Gossip side: concurrent peer readers deliver parts — guard the
        # check-then-set (reference part_set.go holds a mutex in AddPart).
        self._lock = threading.RLock()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_data(
        cls, data: bytes, part_size: int = DEFAULT_PART_SIZE, hasher=None
    ) -> "PartSet":
        """Split serialized data into Merkle-proved parts
        (reference `NewPartSetFromData types/part_set.go:95-122`)."""
        if part_size <= 0:
            raise ValueError("part_size must be positive")
        chunks = [data[i : i + part_size] for i in range(0, len(data), part_size)] or [b""]
        if hasher is not None:
            root, proofs = hasher.proofs(chunks)
        else:
            root, proofs = simple_proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=len(chunks), hash=root))
        for i, (chunk, proof) in enumerate(zip(chunks, proofs)):
            ps._parts[i] = Part(index=i, bytes_=chunk, proof=proof)
            ps.parts_bit_array.set(i, True)
        ps._count = len(chunks)
        return ps

    @classmethod
    def from_header(cls, header: PartSetHeader) -> "PartSet":
        return cls(header)

    # -- gossip side -------------------------------------------------------

    def add_part(self, part: Part) -> bool:
        """Verify the part's Merkle proof and slot it in
        (reference `AddPart types/part_set.go:188-214`)."""
        if not (0 <= part.index < self.header.total):
            raise ValidationError(f"part index {part.index} out of range")
        if part.proof.index != part.index or part.proof.total != self.header.total:
            raise ValidationError("part proof shape mismatch")
        if not verify_proof(self.header.hash, part.bytes_, part.proof):
            raise ValidationError("invalid part Merkle proof")
        with self._lock:
            if self._parts[part.index] is not None:
                return False  # already have it
            self._parts[part.index] = part
            self.parts_bit_array.set(part.index, True)
            self._count += 1
        return True

    # -- accessors ---------------------------------------------------------

    def get_part(self, index: int) -> Part | None:
        with self._lock:
            return self._parts[index]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> int:
        return self.header.total

    def is_complete(self) -> bool:
        with self._lock:
            return self._count == self.header.total

    def assemble(self) -> bytes:
        """Reassemble the original serialized data (reader side)."""
        with self._lock:
            if not self.is_complete():
                raise ValidationError("part set incomplete")
            return b"".join(p.bytes_ for p in self._parts)  # type: ignore[union-attr]

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header == header
