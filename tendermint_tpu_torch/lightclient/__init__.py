"""Planet-scale light-client serving layer (ROADMAP item 1).

Three cooperating pieces turn the sequential `InquiringCertifier` walk
into a horizontally scalable read path:

* `bisect.BisectingCertifier` — skipping verification: jump straight to
  the target height while the trusted valset still vouches for >1/3 of
  the new commit's power (trust-period rule), bisect on
  ErrTooMuchChange, and batch every bisection round's commit verifies
  into ONE device launch through the `VerifyCoalescer`
  (consumer="lightclient", the verify spine's sixth consumer);
* `cache.CertifiedCommitCache` — sharded, POSITIVES-ONLY cache of
  certified FullCommits (same never-cache-a-negative discipline as the
  VerifiedSigCache), durable through `db/fullcommit.FullCommitStore`;
* `reactor.LightClientReactor` — p2p channel 0x68: FullCommit
  request/response + a subscription push stream, so certifiers fetch
  proofs from any peer/replica instead of one full node, and stateless
  read replicas follow the chain tip without joining consensus.

The attribution half (PR 9): a peer caught serving a forged FullCommit
is scored (`forged_fullcommit`, instant ban) AND any genuinely
double-signed vote embedded in the forgery becomes committed
`DuplicateVoteEvidence` (`evidence.extract_double_sign_evidence`) —
not just a client-side rejection.

docs/LIGHTCLIENT.md covers the trust model, the bisection rule, the
replica topology, and every knob.

The port's copy of `tendermint_tpu/lightclient/__init__.py`. The same
exports as the JAX package's `lightclient`.
"""

from tendermint_tpu_torch.lightclient.bisect import BisectingCertifier
from tendermint_tpu_torch.lightclient.cache import CertifiedCommitCache
from tendermint_tpu_torch.lightclient.evidence import extract_double_sign_evidence
from tendermint_tpu_torch.lightclient.reactor import (
    LIGHTCLIENT_CHANNEL,
    LightClientReactor,
    PeerProvider,
)

__all__ = [
    "BisectingCertifier",
    "CertifiedCommitCache",
    "LightClientReactor",
    "PeerProvider",
    "LIGHTCLIENT_CHANNEL",
    "extract_double_sign_evidence",
]
