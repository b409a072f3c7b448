"""Host-side message padding into fixed-shape u32 block arrays (numpy).

The port's copy of `tendermint_tpu.ops.padding`: variable-length messages
are padded to bucketed block counts, one row a message. The arrays are
the JAX package's, word for word (uint32); the hash wrappers hand them
to the card as int32 bit patterns (`.view(np.int32)`).

One packer serves the three hashes: the messages are grouped by length
and written into one byte buffer a group at a time, so 65k leaves cost a
handful of numpy writes, not a Python loop a message (the JAX package
packs RIPEMD-160 and SHA-512 message by message; the arrays are equal).
"""

from __future__ import annotations

import numpy as np

SHA256_BLOCK_BYTES = 64
SHA512_BLOCK_BYTES = 128


def bucket_blocks(n: int, buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32)) -> int:
    """Smallest bucket >= n; beyond the largest, a multiple of it."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def _md_pad(msg: bytes, block: int, length_bytes: int, length_le: bool) -> bytes:
    """Merkle-Damgård padding: 0x80, zeros, message bit-length."""
    bitlen = len(msg) * 8
    padded = msg + b"\x80"
    rem = (len(padded) + length_bytes) % block
    if rem:
        padded += b"\x00" * (block - rem)
    return padded + bitlen.to_bytes(length_bytes, "little" if length_le else "big")


def _pack(
    msgs: list[bytes],
    prefix: bytes,
    max_blocks: int | None,
    block: int,
    length_bytes: int,
    order: str,
) -> tuple[np.ndarray, np.ndarray]:
    """Merkle-Damgård padding of `prefix || msg` for every message, the
    bit length in `order` ("big"/"little"), packed as u32 words of the
    same byte order -> (blocks[B, max_blocks, block // 4] u32,
    n_blocks[B] i32)."""
    n = len(msgs)
    words = block // 4
    if n == 0:
        return np.zeros((0, max_blocks or 1, words), dtype=np.uint32), np.zeros(0, dtype=np.int32)
    plen = len(prefix)
    lens = np.fromiter(map(len, msgs), dtype=np.int64, count=n) + plen
    counts = ((lens + 1 + length_bytes + block - 1) // block).astype(np.int32)
    mb = max_blocks if max_blocks is not None else bucket_blocks(int(counts.max()))
    buf = np.zeros((n, mb * block), dtype=np.uint8)
    # group by length in one O(n log n) pass
    order_idx = np.argsort(lens, kind="stable")
    run_starts = np.nonzero(np.diff(lens[order_idx]))[0] + 1
    for idx in np.split(order_idx, run_starts):
        total = int(lens[idx[0]])
        body = total - plen
        # a run of consecutive rows (every row of a batch of one length)
        # is written through a slice, not a scatter
        rows = slice(int(idx[0]), int(idx[-1]) + 1) if idx[-1] - idx[0] == len(idx) - 1 else idx
        if body:
            group = msgs[rows] if isinstance(rows, slice) else [msgs[i] for i in idx.tolist()]
            buf[rows, plen:total] = np.frombuffer(b"".join(group), dtype=np.uint8).reshape(len(idx), body)
        if plen:
            buf[rows, :plen] = np.frombuffer(prefix, dtype=np.uint8)
        buf[rows, total] = 0x80
        end = int((total + 1 + length_bytes + block - 1) // block) * block
        bitlen = np.frombuffer((total * 8).to_bytes(length_bytes, order), dtype=np.uint8)
        buf[rows, end - length_bytes : end] = bitlen
    out = buf.view(np.uint32)
    if (order == "little") != np.little_endian:
        out.byteswap(inplace=True)  # words of the other byte order; the bytes are not needed again
    return out.reshape(n, mb, words), counts


def pad_sha256(msgs: list[bytes], max_blocks: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """-> (blocks[B, max_blocks, 16] u32 big-endian words, n_blocks[B] i32)."""
    return pad_sha256_prefixed(msgs, b"", max_blocks)


def pad_sha256_prefixed(
    msgs: list[bytes], prefix: bytes = b"", max_blocks: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """SHA-256 padding of `prefix || msg` for every message.
    -> (blocks[B, max_blocks, 16] u32 big-endian words, n_blocks[B] i32)."""
    return _pack(msgs, prefix, max_blocks, SHA256_BLOCK_BYTES, 8, "big")


def pad_sha512(msgs: list[bytes], max_blocks: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """-> (blocks[B, max_blocks, 32] u32: words 2i = hi, 2i+1 = lo of the
    64-bit big-endian words, n_blocks[B] i32)."""
    return _pack(msgs, b"", max_blocks, SHA512_BLOCK_BYTES, 16, "big")


def pad_ripemd160(msgs: list[bytes], max_blocks: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """-> (blocks[B, max_blocks, 16] u32 little-endian words, n_blocks[B] i32)."""
    return pad_ripemd160_prefixed(msgs, b"", max_blocks)


def pad_ripemd160_prefixed(
    msgs: list[bytes], prefix: bytes = b"", max_blocks: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """RIPEMD-160 padding of `prefix || msg` (LE words, LE bit length)."""
    return _pack(msgs, prefix, max_blocks, SHA256_BLOCK_BYTES, 8, "little")


def pad_rows_to(arrays: list[np.ndarray], size: int) -> list[np.ndarray]:
    """Zero-pad every array's leading (row) axis up to exactly `size`. A
    zero leaf row carries n_blocks = 0, so it can never give a real
    digest; callers slice outputs back to the true row count."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if n == size:
            out.append(a)
            continue
        if n > size:
            raise ValueError(f"cannot pad {n} rows down to {size}")
        pad = np.zeros((size - n,) + a.shape[1:], dtype=a.dtype)
        out.append(np.concatenate([a, pad]))
    return out


def pad_rows_to_multiple(
    arrays: list[np.ndarray], multiple: int
) -> tuple[list[np.ndarray], int]:
    """Zero-pad row counts up to the next multiple of `multiple`;
    returns (padded arrays, true row count) for post-kernel slicing."""
    n = arrays[0].shape[0]
    size = ((n + multiple - 1) // multiple) * multiple
    return pad_rows_to(arrays, size), n


def digests_to_bytes_be(digests: np.ndarray) -> list[bytes]:
    """(B, W) u32 big-endian word digests -> list of byte digests."""
    arr = np.ascontiguousarray(np.asarray(digests, dtype=np.uint32).astype(">u4"))
    return [row.tobytes() for row in arr]


def digests_to_bytes_le(digests: np.ndarray) -> list[bytes]:
    """(B, W) u32 little-endian word digests (RIPEMD-160) -> bytes."""
    arr = np.ascontiguousarray(np.asarray(digests, dtype=np.uint32).astype("<u4"))
    return [row.tobytes() for row in arr]
