"""HKDF-SHA256 (RFC 5869) on the standard library's `hmac` and
`hashlib`: the key split of the port's SecretConnection
(`p2p/secret.py`), in place of `cryptography`'s `HKDF`. A salt of None
is HashLen zero bytes, as the RFC and `cryptography` have it."""

from __future__ import annotations

import hashlib
import hmac

HASH_LEN = 32


def hkdf_extract(salt: bytes | None, ikm: bytes) -> bytes:
    return hmac.new(salt if salt else bytes(HASH_LEN), ikm, hashlib.sha256).digest()


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    if length > 255 * HASH_LEN:
        raise ValueError(f"Cannot derive keys larger than {255 * HASH_LEN} octets.")
    out = b""
    block = b""
    counter = 1
    while len(out) < length:
        block = hmac.new(prk, block + info + bytes([counter]), hashlib.sha256).digest()
        out += block
        counter += 1
    return out[:length]


def hkdf_sha256(ikm: bytes, salt: bytes | None, info: bytes, length: int) -> bytes:
    """`length` bytes of output keying material from `ikm`."""
    return hkdf_expand(hkdf_extract(salt, ikm), info, length)
