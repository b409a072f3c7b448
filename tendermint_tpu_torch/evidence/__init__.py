"""Evidence subsystem: pool + p2p gossip for validator-misbehavior proofs.

The accountability half of BFT (PAPERS.md: fork detection is only
useful if the fork is *attributable*): `EvidencePool` collects verified
`DuplicateVoteEvidence` (WAL-backed, deduped, pruned on commit/expiry),
`EvidenceReactor` gossips it on channel 0x38, and consensus commits
pending evidence into proposed blocks so every full node — and the app,
at BeginBlock — learns who equivocated.
"""

from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.evidence.reactor import EVIDENCE_CHANNEL, EvidenceReactor

__all__ = ["EVIDENCE_CHANNEL", "EvidencePool", "EvidenceReactor"]
