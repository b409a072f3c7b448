"""Forged-FullCommit attribution: turn a forgery into evidence.

A peer serving a FullCommit that fails certification is lying — the
client-side rejection (and the `forged_fullcommit` scorer debit) stops
the immediate attack, but PR 9's lesson is that rejection without
attribution lets a compromised VALIDATOR hide behind a disposable
relay: the interesting forgeries embed genuinely double-signed votes
(the compromised signer re-signed a fake header at a height the chain
already committed). Those are slashable, chain-committable proof.

`extract_double_sign_evidence` compares the forged commit against the
honest commit the client already trusts at the same height: every
precommit in the forgery that (a) names a DIFFERENT block than the
honest chain, (b) matches a validator of the honest set at that
height, (c) carries a GENUINE signature (verified — a garbage sig is
peer noise, not validator fault), and (d) has a conflicting honest
counterpart at the same (height, round), becomes a
`DuplicateVoteEvidence` ready for the evidence pool -> 0x38 gossip ->
block commitment pipeline.

The port's copy of `tendermint_tpu/lightclient/evidence.py`.
`verifier=None` is the port's `default_verifier()`, as in
`lightclient/bisect.py`.
"""

from __future__ import annotations

from tendermint_tpu_torch.certifiers.certifier import FullCommit
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT


def extract_double_sign_evidence(
    forged: FullCommit,
    honest: FullCommit,
    chain_id: str,
    verifier=None,
) -> list[DuplicateVoteEvidence]:
    """Double-sign proofs embedded in a rejected FullCommit.

    `honest` is the client's own certified commit at the same height
    (from its trusted cache/store); returns [] when heights/rounds
    cannot pair (no same-step conflict exists), when the forged sigs
    are all garbage, or when the forged block is actually the honest
    one. Never raises on malformed forgeries — the caller already
    rejected them; this is best-effort attribution.
    """
    if forged.height() != honest.height():
        return []
    try:
        forged_round = forged.commit.round()
        honest_round = honest.commit.round()
    except (ValidationError, ValueError, IndexError):
        return []
    if forged_round != honest_round:
        # DuplicateVoteEvidence requires one (height, round, type) step;
        # a different-round forgery cannot pair with the honest commit
        return []
    if forged.commit.block_id == honest.commit.block_id:
        return []
    honest_vals = honest.validators
    # honest precommits by validator address (index-aligned to the
    # honest set; the forged commit's own index alignment is untrusted)
    honest_by_addr = {}
    for idx, pc in enumerate(honest.commit.precommits):
        if pc is None or pc.type != VOTE_TYPE_PRECOMMIT:
            continue
        val = honest_vals.get_by_index(idx)
        if val is not None:
            honest_by_addr[val.address] = pc
    candidates = []  # (forged_vote, honest_vote, pubkey)
    for pc in forged.commit.precommits:
        if pc is None or pc.type != VOTE_TYPE_PRECOMMIT:
            continue
        if pc.height != forged.height() or pc.round != forged_round:
            continue
        if not pc.signature:
            continue
        hpc = honest_by_addr.get(pc.validator_address)
        if hpc is None or hpc.block_id == pc.block_id:
            continue
        _, val = honest_vals.get_by_address(pc.validator_address)
        if val is None:
            continue
        candidates.append((pc, hpc, val.pub_key.data))
    if not candidates:
        return []
    # only GENUINE forged-side signatures convict a validator; verify
    # the whole candidate set as one batch (the honest side was already
    # proven when the client certified `honest`)
    triples = [
        (pk, fv.sign_bytes(chain_id), fv.signature)
        for fv, _hv, pk in candidates
    ]
    from tendermint_tpu_torch.types.validator_set import _verify_triples

    mask = _verify_triples(triples, verifier, consumer="lightclient")
    out: list[DuplicateVoteEvidence] = []
    for ok, (fv, hv, _pk) in zip(mask, candidates):
        if not ok:
            continue
        ev = DuplicateVoteEvidence.make(fv, hv)
        try:
            ev.validate_basic()
        except ValidationError:
            continue  # structurally unpairable (index mismatch etc.)
        out.append(ev)
    return out
