"""Host hash functions (the port's copy of `tendermint_tpu.crypto.hashing`).

The framework's tree and leaf hash is SHA-256 (`DEFAULT_ALGO`), with
RIPEMD-160 kept as the reference-compatible variant; both have batched
CUDA kernels in `tendermint_tpu_torch.ops`.
"""

from __future__ import annotations

import hashlib

ADDRESS_LEN = 20

# Default tree/leaf hash algorithm for the whole framework.
DEFAULT_ALGO = "sha256"


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def ripemd160(data: bytes) -> bytes:
    h = hashlib.new("ripemd160")
    h.update(data)
    return h.digest()


def tmhash(data: bytes, algo: str = DEFAULT_ALGO) -> bytes:
    """The framework hash: SHA-256 (32B) by default, RIPEMD-160 (20B) compat."""
    if algo == "sha256":
        return sha256(data)
    if algo == "ripemd160":
        return ripemd160(data)
    raise ValueError(f"unknown hash algo {algo!r}")


def address_hash(pubkey_bytes: bytes) -> bytes:
    """Validator/node address = first 20 bytes of SHA-256 of the raw pubkey."""
    return sha256(pubkey_bytes)[:ADDRESS_LEN]
