"""Proposer heartbeat (reference `types/heartbeat.go`): signed liveness ping
broadcast while the proposer waits for txs in no-empty-blocks mode."""

from __future__ import annotations

from dataclasses import dataclass, replace

from tendermint_tpu_torch.codec import Reader, Writer, canonical_dumps


@dataclass(frozen=True)
class Heartbeat:
    validator_address: bytes
    validator_index: int
    height: int
    round: int
    sequence: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_dumps(
            {
                "chain_id": chain_id,
                "heartbeat": {
                    "validator_address": self.validator_address,
                    "validator_index": self.validator_index,
                    "height": self.height,
                    "round": self.round,
                    "sequence": self.sequence,
                },
            }
        )

    def with_signature(self, sig: bytes) -> "Heartbeat":
        return replace(self, signature=sig)

    def encode(self) -> bytes:
        return (
            Writer()
            .bytes(self.validator_address)
            .uvarint(self.validator_index)
            .uvarint(self.height)
            .uvarint(self.round)
            .uvarint(self.sequence)
            .bytes(self.signature)
            .build()
        )

    @classmethod
    def decode(cls, data: bytes) -> "Heartbeat":
        r = Reader(data)
        hb = cls(
            validator_address=r.bytes(),
            validator_index=r.uvarint(),
            height=r.uvarint(),
            round=r.uvarint(),
            sequence=r.uvarint(),
            signature=r.bytes(),
        )
        r.expect_done()
        return hb
