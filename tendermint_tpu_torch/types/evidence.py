"""Evidence of validator misbehavior (reference `types/evidence.go`).

`DuplicateVoteEvidence` — two signed, conflicting votes from one
validator at the same (height, round, type) — is the proof object the
whole Byzantine accountability pipeline moves: detected at the
`ErrVoteConflictingVotes` sites in `types/vote_set.py`, pooled and
gossiped (`evidence/`), committed into blocks (`Block.evidence` +
`Header.evidence_hash`), and reported to the application at BeginBlock
so the app can slash (PAPERS.md: "A Tendermint Light Client" — fork
*attribution*; "Practical Light Clients for Committee-Based
Blockchains" — committee members must be accountable for equivocation).

Verification rides the existing `BatchVerifier` seam as a 2-lane batch
(both votes share the offender's pubkey): on the card, evidence checks
coalesce with the consensus verify traffic instead of stealing host
cycles; the breaker ladder degrades them like any other verify.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.codec import Reader, Writer
from tendermint_tpu_torch.crypto.hashing import tmhash
from tendermint_tpu_torch.merkle import simple_hash_from_byte_slices
from tendermint_tpu_torch.types.errors import ErrEvidenceUnprovable, ValidationError
from tendermint_tpu_torch.types.vote import Vote

# wire tag for the one concrete evidence kind; new kinds extend the
# registry below (unknown tags are a decode error, never a crash)
_TAG_DUPLICATE_VOTE = 0x01


@dataclass(frozen=True)
class DuplicateVoteEvidence:
    """One validator, two different signed votes for the same
    (height, round, type) — reference `types/evidence.go` DupeoutTx /
    DuplicateVoteEvidence. Votes are stored in canonical order (sorted
    by block-id key, then signature) so the SAME equivocation hashes
    identically no matter which vote was seen first — the dedup key of
    the evidence pool and the gossip layer."""

    vote_a: Vote
    vote_b: Vote

    @classmethod
    def make(cls, vote_a: Vote, vote_b: Vote) -> "DuplicateVoteEvidence":
        """Canonicalize the pair (detection order varies per node)."""
        ka = (vote_a.block_id.key(), vote_a.signature)
        kb = (vote_b.block_id.key(), vote_b.signature)
        if kb < ka:
            vote_a, vote_b = vote_b, vote_a
        return cls(vote_a=vote_a, vote_b=vote_b)

    # -- identity ------------------------------------------------------------

    @property
    def height(self) -> int:
        return self.vote_a.height

    @property
    def address(self) -> bytes:
        """The offending validator's address."""
        return self.vote_a.validator_address

    def hash(self) -> bytes:
        return tmhash(self.encode())

    # -- checks --------------------------------------------------------------

    def validate_basic(self) -> None:
        """Structural proof checks — everything except the signatures
        (reference `DuplicateVoteEvidence.Verify` minus the crypto)."""
        a, b = self.vote_a, self.vote_b
        a.validate_basic()
        b.validate_basic()
        if a.validator_address != b.validator_address:
            raise ValidationError("duplicate-vote evidence: different validators")
        if a.validator_index != b.validator_index:
            raise ValidationError("duplicate-vote evidence: different indices")
        if (a.height, a.round, a.type) != (b.height, b.round, b.type):
            raise ValidationError(
                "duplicate-vote evidence: votes are for different steps"
            )
        if a.block_id == b.block_id:
            raise ValidationError(
                "duplicate-vote evidence: votes agree (no conflict)"
            )
        if not a.signature or not b.signature:
            raise ValidationError("duplicate-vote evidence: unsigned vote")

    def verify(self, chain_id: str, val_set, verifier=None) -> None:
        """Full proof check: structure, the offender is (or was) in
        `val_set`, and both signatures are genuine — verified as one
        2-lane batch through the `BatchVerifier` seam so evidence
        checks ride the device verify spine."""
        self.validate_basic()
        idx, val = val_set.get_by_address(self.address)
        if idx < 0 or val is None:
            raise ErrEvidenceUnprovable(
                f"evidence validator {self.address.hex()[:12]} not in validator set"
            )
        if verifier is None:
            from tendermint_tpu_torch.services.verifier import default_verifier

            verifier = default_verifier()
        pk = val.pub_key.data
        verdicts = verifier.verify_batch(
            [
                (pk, self.vote_a.sign_bytes(chain_id), self.vote_a.signature),
                (pk, self.vote_b.sign_bytes(chain_id), self.vote_b.signature),
            ]
        )
        if not (bool(verdicts[0]) and bool(verdicts[1])):
            raise ValidationError(
                f"duplicate-vote evidence: forged signature(s) "
                f"(a={bool(verdicts[0])}, b={bool(verdicts[1])})"
            )

    # -- wire ----------------------------------------------------------------

    def encode(self) -> bytes:
        return (
            Writer()
            .uvarint(_TAG_DUPLICATE_VOTE)
            .bytes(self.vote_a.encode())
            .bytes(self.vote_b.encode())
            .build()
        )

    @classmethod
    def decode_from(cls, r: Reader) -> "DuplicateVoteEvidence":
        return cls(
            vote_a=Vote.decode(r.bytes()),
            vote_b=Vote.decode(r.bytes()),
        )

    def __str__(self) -> str:
        return (
            f"DuplicateVoteEvidence{{val={self.address.hex()[:12]} "
            f"{self.height}/{self.vote_a.round}/{self.vote_a.type}}}"
        )


def decode_evidence(data: bytes):
    """One evidence object from its tagged wire form."""
    r = Reader(data)
    ev = decode_evidence_from(r)
    r.expect_done()
    return ev


def decode_evidence_from(r: Reader):
    tag = r.uvarint()
    if tag == _TAG_DUPLICATE_VOTE:
        return DuplicateVoteEvidence.decode_from(r)
    raise ValidationError(f"unknown evidence tag {tag:#x}")


def verify_evidence_batch(
    chain_id: str, evidence: list, val_sets: list, verifier=None
) -> None:
    """Verify a whole block's evidence list in ONE device batch (2 lanes
    per proof) — the commit-side analog of the fast-sync commit window:
    N proofs cost one launch, not N. `val_sets` are the candidate
    validator sets, tried in order per offender (typically [validators,
    last_validators]). Raises ValidationError naming the first bad
    proof."""
    if not evidence:
        return
    triples = []
    for ev in evidence:
        ev.validate_basic()
        val = None
        for vs in val_sets:
            if vs is None or vs.size() == 0:
                continue
            idx, cand = vs.get_by_address(ev.address)
            if idx >= 0 and cand is not None:
                val = cand
                break
        if val is None:
            raise ErrEvidenceUnprovable(
                f"evidence validator {ev.address.hex()[:12]} not in any "
                f"retained validator set"
            )
        pk = val.pub_key.data
        triples.append((pk, ev.vote_a.sign_bytes(chain_id), ev.vote_a.signature))
        triples.append((pk, ev.vote_b.sign_bytes(chain_id), ev.vote_b.signature))
    if verifier is None:
        from tendermint_tpu_torch.services.verifier import default_verifier

        verifier = default_verifier()
    verdicts = verifier.verify_batch(triples)
    for i, ev in enumerate(evidence):
        if not (bool(verdicts[2 * i]) and bool(verdicts[2 * i + 1])):
            raise ValidationError(f"evidence {i} carries forged signature(s): {ev}")


def evidence_hash(evidence: list, hasher=None) -> bytes:
    """Merkle root over an evidence list (the `Header.evidence_hash`
    commitment); b"" for no evidence — headers of evidence-free blocks
    stay byte-identical to the pre-evidence format. `hasher` routes the
    root build through a TreeHasher backend (same seam as `Txs.hash`;
    host and device trees are bit-equal by construction)."""
    if not evidence:
        return b""
    items = [ev.encode() for ev in evidence]
    if hasher is not None:
        return hasher.root_from_items(items)
    return simple_hash_from_byte_slices(items)
