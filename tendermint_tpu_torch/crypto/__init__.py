"""Host-side ed25519 (the pure-Python RFC 8032 module, `PubKey`,
`PrivKey`) and the host hash functions: the port's copy of
`tendermint_tpu.crypto`'s surface."""

from tendermint_tpu_torch.crypto.hashing import ADDRESS_LEN, address_hash, ripemd160, sha256, tmhash
from tendermint_tpu_torch.crypto.keys import (
    PRIVKEY_SEED_LEN,
    PUBKEY_LEN,
    SIGNATURE_LEN,
    PrivKey,
    PubKey,
    gen_priv_key,
)

__all__ = [
    "PrivKey",
    "PubKey",
    "gen_priv_key",
    "sha256",
    "ripemd160",
    "tmhash",
    "address_hash",
    "ADDRESS_LEN",
    "PUBKEY_LEN",
    "SIGNATURE_LEN",
    "PRIVKEY_SEED_LEN",
]
