"""ChaCha20-Poly1305 AEAD (RFC 8439): the frame cipher of the port's
SecretConnection (`p2p/secret.py`), in place of `cryptography`'s
`ChaCha20Poly1305`, with the same `encrypt` / `decrypt` surface and the
same bytes: a 32-byte key, a 12-byte nonce, the 16-byte tag appended to
the ciphertext, and `InvalidTag` raised when a tag does not match.

The ChaCha20 keystream of a frame is computed for all of its 64-byte
blocks at once, with numpy `uint32` lanes: block 0 (the Poly1305 key)
and the data blocks 1..n in one pass of 20 rounds, each round a column
or a diagonal step on the whole (4, 4, n) state. Poly1305 runs on
Python ints.
"""

from __future__ import annotations

import hmac
import operator
import struct

import numpy as np

KEY_LEN = 32
NONCE_LEN = 12
TAG_LEN = 16

_SIGMA = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32)
_P1305 = (1 << 130) - 5
_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
_HIBIT = 1 << 128
_MASK128 = (1 << 128) - 1
_STRIDE = 32  # Poly1305 blocks folded into one reduction


class InvalidTag(Exception):
    """The tag does not authenticate the ciphertext and data."""


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter(a, b, c, d) -> None:
    """RFC 8439 §2.1 on every column of the (4, n) rows, in place."""
    a += b
    d ^= a
    d[:] = _rotl(d, 16)
    c += d
    b ^= c
    b[:] = _rotl(b, 12)
    a += b
    d ^= a
    d[:] = _rotl(d, 8)
    c += d
    b ^= c
    b[:] = _rotl(b, 7)


def chacha20_blocks(key: bytes, nonce: bytes, counter: int, nblocks: int) -> bytes:
    """`nblocks` consecutive ChaCha20 blocks (RFC 8439 §2.3) from block
    `counter`, as 64 * nblocks keystream bytes."""
    n = max(0, nblocks)
    init = np.empty((4, 4, n), dtype=np.uint32)
    init[0] = _SIGMA[:, None]
    init[1:3] = np.frombuffer(key, dtype="<u4").astype(np.uint32).reshape(2, 4)[:, :, None]
    init[3, 0] = (np.arange(counter, counter + n, dtype=np.uint64) & 0xFFFFFFFF).astype(np.uint32)
    init[3, 1:] = np.frombuffer(nonce, dtype="<u4").astype(np.uint32)[:, None]
    x = init.copy()
    a, b, c, d = x[0], x[1], x[2], x[3]
    for _ in range(10):
        _quarter(a, b, c, d)  # columns
        # diagonals: word i of a meets word i+1 of b, i+2 of c, i+3 of d
        b[:] = np.roll(b, -1, axis=0)
        c[:] = np.roll(c, -2, axis=0)
        d[:] = np.roll(d, -3, axis=0)
        _quarter(a, b, c, d)
        b[:] = np.roll(b, 1, axis=0)
        c[:] = np.roll(c, 2, axis=0)
        d[:] = np.roll(d, 3, axis=0)
    x += init
    # block j's 16 words, little-endian, in order
    return x.reshape(16, n).T.astype("<u4").tobytes()


def poly1305(key: bytes, msg: bytes) -> bytes:
    """The Poly1305 tag (RFC 8439 §2.5) of `msg` under the 32-byte
    one-time `key`.

    Horner's rule taken `_STRIDE` blocks a step: acc = (acc * r^k +
    c_1 r^k + ... + c_k r) mod p, the same polynomial with one reduction
    a step instead of one a block."""
    r = int.from_bytes(key[:16], "little") & _CLAMP
    s = int.from_bytes(key[16:32], "little")
    full = len(msg) - len(msg) % 16
    words = np.frombuffer(msg, dtype="<u8", count=full // 8).reshape(-1, 2)
    blocks = [lo | (hi << 64) | _HIBIT for lo, hi in zip(words[:, 0].tolist(), words[:, 1].tolist())]
    if full < len(msg):
        blocks.append(int.from_bytes(msg[full:] + b"\x01", "little"))
    powers = [pow(r, _STRIDE - j, _P1305) for j in range(_STRIDE)]  # r^k .. r^1
    r_k = powers[0]
    n = len(blocks)
    stepped = n - n % _STRIDE
    acc = 0
    for i in range(0, stepped, _STRIDE):
        acc = (acc * r_k + sum(map(operator.mul, blocks[i : i + _STRIDE], powers))) % _P1305
    for c in blocks[stepped:]:
        acc = (acc + c) * r % _P1305
    return ((acc + s) & _MASK128).to_bytes(16, "little")


def _pad16(n: int) -> bytes:
    return bytes(-n % 16)


class ChaCha20Poly1305:
    """The AEAD of RFC 8439 §2.8 under one 32-byte key."""

    def __init__(self, key: bytes) -> None:
        if len(key) != KEY_LEN:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes.")
        self._key = bytes(key)

    def _stream(self, nonce: bytes, nbytes: int) -> tuple[bytes, bytes]:
        """(the Poly1305 key, `nbytes` of keystream from block 1)."""
        if len(nonce) != NONCE_LEN:
            raise ValueError("Nonce must be 12 bytes")
        blocks = chacha20_blocks(self._key, nonce, 0, 1 + (nbytes + 63) // 64)
        return blocks[:32], blocks[64 : 64 + nbytes]

    @staticmethod
    def _tag(otk: bytes, aad: bytes, ct: bytes) -> bytes:
        mac_data = b"".join(
            (aad, _pad16(len(aad)), ct, _pad16(len(ct)), struct.pack("<QQ", len(aad), len(ct)))
        )
        return poly1305(otk, mac_data)

    @staticmethod
    def _xor(data: bytes, stream: bytes) -> bytes:
        return (np.frombuffer(data, dtype=np.uint8) ^ np.frombuffer(stream, dtype=np.uint8)).tobytes()

    def encrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        aad = associated_data or b""
        otk, stream = self._stream(nonce, len(data))
        ct = self._xor(data, stream)
        return ct + self._tag(otk, aad, ct)

    def decrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        aad = associated_data or b""
        if len(data) < TAG_LEN:
            raise InvalidTag
        ct, tag = data[:-TAG_LEN], data[-TAG_LEN:]
        otk, stream = self._stream(nonce, len(ct))
        if not hmac.compare_digest(self._tag(otk, aad, ct), tag):
            raise InvalidTag
        return self._xor(ct, stream)
