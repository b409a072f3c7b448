"""On-chain consensus parameters, carried in the GenesisDoc
(reference `types/params.go:13-35`, ADR-005)."""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.types.errors import ValidationError

MAX_BLOCK_SIZE_BYTES = 22020096  # 21MB hard cap (reference params.go Validate)


@dataclass
class BlockSizeParams:
    max_bytes: int = 22020096
    max_txs: int = 10000  # reference config.go:379 MaxBlockSizeTxs
    max_gas: int = -1


@dataclass
class TxSizeParams:
    max_bytes: int = 10240
    max_gas: int = -1


@dataclass
class BlockGossipParams:
    block_part_size_bytes: int = 4096  # reference types/params.go:20-25


@dataclass
class EvidenceParams:
    """On-chain evidence policy (reference `types/params.go` EvidenceParams).
    `max_age` is in heights: evidence older than `committing_height -
    max_age` is expired — unverifiable against any retained validator
    set, so pools prune it and proposals must not carry it. `max_evidence`
    caps the evidence list of one block (DoS bound on block size and on
    the per-block 2-lane verify batches)."""

    max_age: int = 100000
    max_evidence: int = 64


@dataclass
class ConsensusParams:
    block_size: BlockSizeParams = field(default_factory=BlockSizeParams)
    tx_size: TxSizeParams = field(default_factory=TxSizeParams)
    block_gossip: BlockGossipParams = field(default_factory=BlockGossipParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)

    def validate(self) -> None:
        if self.block_size.max_bytes <= 0 or self.block_size.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValidationError(f"invalid block max_bytes {self.block_size.max_bytes}")
        if self.block_gossip.block_part_size_bytes <= 0:
            raise ValidationError("block_part_size_bytes must be positive")
        if self.evidence.max_age <= 0:
            raise ValidationError("evidence max_age must be positive")
        if self.evidence.max_evidence < 0:
            raise ValidationError("evidence max_evidence must be >= 0")

    def to_dict(self) -> dict:
        return {
            "block_size": {
                "max_bytes": self.block_size.max_bytes,
                "max_txs": self.block_size.max_txs,
                "max_gas": self.block_size.max_gas,
            },
            "tx_size": {"max_bytes": self.tx_size.max_bytes, "max_gas": self.tx_size.max_gas},
            "block_gossip": {
                "block_part_size_bytes": self.block_gossip.block_part_size_bytes
            },
            "evidence": {
                "max_age": self.evidence.max_age,
                "max_evidence": self.evidence.max_evidence,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ConsensusParams":
        p = cls()
        if "block_size" in d:
            b = d["block_size"]
            p.block_size = BlockSizeParams(
                max_bytes=b.get("max_bytes", p.block_size.max_bytes),
                max_txs=b.get("max_txs", p.block_size.max_txs),
                max_gas=b.get("max_gas", p.block_size.max_gas),
            )
        if "tx_size" in d:
            t = d["tx_size"]
            p.tx_size = TxSizeParams(
                max_bytes=t.get("max_bytes", p.tx_size.max_bytes),
                max_gas=t.get("max_gas", p.tx_size.max_gas),
            )
        if "block_gossip" in d:
            g = d["block_gossip"]
            p.block_gossip = BlockGossipParams(
                block_part_size_bytes=g.get(
                    "block_part_size_bytes", p.block_gossip.block_part_size_bytes
                )
            )
        if "evidence" in d:
            e = d["evidence"]
            p.evidence = EvidenceParams(
                max_age=e.get("max_age", p.evidence.max_age),
                max_evidence=e.get("max_evidence", p.evidence.max_evidence),
            )
        return p
