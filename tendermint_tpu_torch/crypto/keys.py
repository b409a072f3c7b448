"""ed25519 keys and host-side sign/verify.

Counterpart of `tendermint_tpu/crypto/keys.py` (`PubKey`, `PrivKey`,
`gen_priv_key`), over the copied pure-Python RFC 8032 module
(`crypto/ed25519_ref.py`): the port's host path needs no `cryptography`
package. Ed25519 signing is deterministic, so `PrivKey.sign` gives the
same bytes as the JAX package's library-backed signer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from tendermint_tpu_torch.crypto import ed25519_ref
from tendermint_tpu_torch.crypto.hashing import address_hash

PRIVKEY_SEED_LEN = 32
PUBKEY_LEN = 32
SIGNATURE_LEN = 64

# pubkey -> unsafe? memo (keys repeat heavily: valset members, signed-tx
# senders); bounded so an attacker cycling fresh garbage keys cannot
# grow it without limit
_UNSAFE_PK_CACHE: dict[bytes, bool] = {}
_UNSAFE_PK_CACHE_MAX = 8192


def _unsafe_pubkey(pub: bytes) -> bool:
    """Small-order / non-canonical screen (ed25519_ref.is_small_order),
    memoized per key."""
    v = _UNSAFE_PK_CACHE.get(pub)
    if v is None:
        v = ed25519_ref.is_small_order(pub)
        if len(_UNSAFE_PK_CACHE) >= _UNSAFE_PK_CACHE_MAX:
            _UNSAFE_PK_CACHE.clear()
        _UNSAFE_PK_CACHE[pub] = v
    return v


@dataclass(frozen=True)
class PubKey:
    """32-byte ed25519 public key."""

    data: bytes

    def __post_init__(self) -> None:
        if len(self.data) != PUBKEY_LEN:
            raise ValueError(f"pubkey must be {PUBKEY_LEN} bytes, got {len(self.data)}")

    def verify(self, msg: bytes, signature: bytes) -> bool:
        """One-at-a-time host verification."""
        if len(signature) != SIGNATURE_LEN:
            return False
        # Small-order / non-canonical keys are keyless-forgery inputs
        # (the zero key "verifies" ~1/4 of messages through cofactorless
        # verifies) — screened here so every consumer of the host path
        # is covered.
        if _unsafe_pubkey(self.data):
            return False
        return ed25519_ref.verify(self.data, msg, signature)

    @property
    def address(self) -> bytes:
        return address_hash(self.data)

    def __bytes__(self) -> bytes:
        return self.data

    def hex(self) -> str:
        return self.data.hex()


@dataclass(frozen=True)
class PrivKey:
    """ed25519 private key from a 32-byte seed (RFC 8032 style)."""

    seed: bytes

    def __post_init__(self) -> None:
        if len(self.seed) != PRIVKEY_SEED_LEN:
            raise ValueError(f"privkey seed must be {PRIVKEY_SEED_LEN} bytes")

    def sign(self, msg: bytes) -> bytes:
        return ed25519_ref.sign(self.seed, msg)

    @property
    def pub_key(self) -> PubKey:
        return PubKey(ed25519_ref.public_from_seed(self.seed))

    def __repr__(self) -> str:  # never leak the seed
        return f"PrivKey(pub={self.pub_key.hex()[:16]}…)"


def gen_priv_key(seed: bytes | None = None) -> PrivKey:
    """Generate a key; pass a fixed seed for deterministic test fixtures."""
    return PrivKey(seed if seed is not None else os.urandom(PRIVKEY_SEED_LEN))
