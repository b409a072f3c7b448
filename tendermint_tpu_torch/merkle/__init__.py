"""Merkle trees: the host reference implementation and proofs.

The batched tree build on the card lives in
`tendermint_tpu_torch.ops.merkle_kernel` behind
`tendermint_tpu_torch.services.hasher.TreeHasher`.
"""

from tendermint_tpu_torch.merkle.simple import (
    SimpleProof,
    simple_hash_from_byte_slices,
    simple_hash_from_hashes,
    simple_hash_from_map,
    simple_proofs_from_byte_slices,
    verify_proof,
)

__all__ = [
    "simple_hash_from_hashes",
    "simple_hash_from_byte_slices",
    "simple_hash_from_map",
    "simple_proofs_from_byte_slices",
    "SimpleProof",
    "verify_proof",
]
