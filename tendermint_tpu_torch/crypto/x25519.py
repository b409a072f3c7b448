"""Pure-Python X25519 (RFC 7748): the ephemeral Diffie-Hellman of the
port's SecretConnection (`p2p/secret.py`).

It stands in for `cryptography`'s `X25519PrivateKey` / `X25519PublicKey`
with the same surface the handshake uses, and gives the same bytes:
the scalar is clamped (RFC 7748 §5), the top bit of u is masked, and
the Montgomery ladder runs the same steps for every scalar (a
conditional swap by arithmetic masks, never a branch on a key bit).
`exchange` raises `ValueError` on an all-zero shared secret, as
`cryptography` does for a small-order peer key. Arithmetic is on Python
ints modulo 2^255 - 19.
"""

from __future__ import annotations

import os

P = 2**255 - 19
A24 = 121665  # (486662 - 2) / 4
BASE_POINT = (9).to_bytes(32, "little")
KEY_LEN = 32


def _decode_scalar(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def _decode_u(u: bytes) -> int:
    return (int.from_bytes(u, "little") & ((1 << 255) - 1)) % P


def x25519(k: bytes, u: bytes) -> bytes:
    """The X25519 function of RFC 7748 §5: scalar `k` times the point
    with u-coordinate `u`, both 32 bytes little-endian."""
    if len(k) != KEY_LEN or len(u) != KEY_LEN:
        raise ValueError("X25519 scalars and u-coordinates are 32 bytes")
    scalar = _decode_scalar(k)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (scalar >> t) & 1
        swap ^= k_t
        mask = -swap  # all ones or zero: the swap is arithmetic
        d = mask & (x2 ^ x3)
        x2, x3 = x2 ^ d, x3 ^ d
        d = mask & (z2 ^ z3)
        z2, z3 = z2 ^ d, z3 ^ d
        swap = k_t
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        dd = (x3 - z3) % P
        da = dd * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = x1 * (z3 * z3 % P) % P
        x2 = aa * bb % P
        z2 = e * ((aa + A24 * e) % P) % P
    mask = -swap
    d = mask & (x2 ^ x3)
    x2 ^= d
    d = mask & (z2 ^ z3)
    z2 ^= d
    return (x2 * pow(z2, P - 2, P) % P).to_bytes(32, "little")


class X25519PublicKey:
    """A peer's 32-byte u-coordinate."""

    def __init__(self, data: bytes) -> None:
        self._data = bytes(data)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "X25519PublicKey":
        if len(data) != KEY_LEN:
            raise ValueError("An X25519 public key is 32 bytes long")
        return cls(data)

    def public_bytes_raw(self) -> bytes:
        return self._data


class X25519PrivateKey:
    """A 32-byte scalar; `generate()` draws it from `os.urandom`."""

    def __init__(self, data: bytes) -> None:
        self._data = bytes(data)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(os.urandom(KEY_LEN))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "X25519PrivateKey":
        if len(data) != KEY_LEN:
            raise ValueError("An X25519 private key is 32 bytes long")
        return cls(data)

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(x25519(self._data, BASE_POINT))

    def exchange(self, peer: X25519PublicKey) -> bytes:
        shared = x25519(self._data, peer.public_bytes_raw())
        if shared == bytes(KEY_LEN):
            raise ValueError("Error computing shared key.")
        return shared
