"""Light client: certify headers without replaying the chain
(reference `certifiers/`).

A light client holds a trusted validator set and certifies incoming
(header, commit) pairs against it; validator-set changes are followed
with the >2/3-continuity rule (`VerifyCommitAny`), bisecting through
stored intermediate commits when one jump changes too much.

Device angle (BASELINE config 2): commit replay is embarrassingly
batchable — `StaticCertifier.certify_batch` verifies K same-valset
commits in one device call through the valset-table kernel
(`madd_chain_fused` on the card).

The port's copy of `tendermint_tpu.certifiers`, with the same exports.
A certifier given `verifier=None` verifies on the port's
`default_verifier()`, the card's stack, which raises without a card.
`node_provider` reads a node over RPC and waits for the port's `rpc`.
"""

from tendermint_tpu_torch.certifiers.certifier import (
    DynamicCertifier,
    FullCommit,
    InquiringCertifier,
    StaticCertifier,
)
from tendermint_tpu_torch.certifiers.provider import (
    FileProvider,
    MemProvider,
    Provider,
)

__all__ = [
    "DynamicCertifier",
    "FileProvider",
    "FullCommit",
    "InquiringCertifier",
    "MemProvider",
    "Provider",
    "StaticCertifier",
]
