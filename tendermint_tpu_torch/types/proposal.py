"""Proposal: the proposer's signed offer of a block for a round
(reference `types/proposal.go`). POLRound/POLBlockID carry proof-of-lock
info for the lock/unlock safety rules (`consensus/state.go:963-1053`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from tendermint_tpu_torch.codec import Reader, Writer, canonical_dumps
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.part_set import PartSetHeader


@dataclass(frozen=True)
class Proposal:
    height: int
    round: int
    block_parts_header: PartSetHeader
    pol_round: int  # -1 if no proof-of-lock
    pol_block_id: BlockID
    timestamp: int  # ns
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_dumps(
            {
                "chain_id": chain_id,
                "proposal": {
                    "height": self.height,
                    "round": self.round,
                    "block_parts_header": {
                        "total": self.block_parts_header.total,
                        "hash": self.block_parts_header.hash,
                    },
                    "pol_round": self.pol_round,
                    "pol_block_id": self.pol_block_id.to_dict(),
                    "timestamp": self.timestamp,
                },
            }
        )

    def with_signature(self, sig: bytes) -> "Proposal":
        return replace(self, signature=sig)

    def encode(self) -> bytes:
        return (
            Writer()
            .uvarint(self.height)
            .uvarint(self.round)
            .raw(self.block_parts_header.encode())
            .svarint(self.pol_round)
            .raw(self.pol_block_id.encode())
            .svarint(self.timestamp)
            .bytes(self.signature)
            .build()
        )

    @classmethod
    def decode_from(cls, r: Reader) -> "Proposal":
        return cls(
            height=r.uvarint(),
            round=r.uvarint(),
            block_parts_header=PartSetHeader.decode_from(r),
            pol_round=r.svarint(),
            pol_block_id=BlockID.decode_from(r),
            timestamp=r.svarint(),
            signature=r.bytes(),
        )

    @classmethod
    def decode(cls, data: bytes) -> "Proposal":
        r = Reader(data)
        p = cls.decode_from(r)
        r.expect_done()
        return p

    def __str__(self) -> str:
        return f"Proposal{{{self.height}/{self.round} parts={self.block_parts_header.total} pol={self.pol_round}}}"
