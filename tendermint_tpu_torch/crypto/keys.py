"""ed25519 public keys and host-side verification.

Counterpart of `tendermint_tpu/crypto/keys.py::PubKey`, over the copied
pure-Python RFC 8032 module (`crypto/ed25519_ref.py`): the port's host
path needs no `cryptography` package.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.crypto import ed25519_ref

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

    def __bytes__(self) -> bytes:
        return self.data

    def hex(self) -> str:
        return self.data.hex()
