"""SimpleMerkle tree with inclusion proofs (host reference implementation).

The port's copy of `tendermint_tpu.merkle.simple`, with the same two
deliberate deviations from the Go reference's SimpleTree:

* **Split rule.** Split at the largest power of two strictly less than n
  (RFC 6962), not at ceil(n/2). It equals bottom-up adjacent pairing with
  an unpaired trailing node promoted, which the card builds as log2(N)
  batched levels (`ops/merkle_kernel.py`).
* **Domain separation.** leaf = H(0x00 || data), inner = H(0x01 || L || R).

Host and card trees implement the same rule and are bit-equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.codec import Reader, Writer, encode_bytes, encode_string
from tendermint_tpu_torch.crypto.hashing import DEFAULT_ALGO, tmhash

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def leaf_hash(data: bytes, algo: str = DEFAULT_ALGO) -> bytes:
    return tmhash(LEAF_PREFIX + data, algo)


def inner_hash(left: bytes, right: bytes, algo: str = DEFAULT_ALGO) -> bytes:
    return tmhash(INNER_PREFIX + left + right, algo)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (RFC 6962 split rule)."""
    if n < 2:
        raise ValueError("split requires n >= 2")
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def simple_hash_from_hashes(hashes: list[bytes], algo: str = DEFAULT_ALGO) -> bytes:
    """Root from precomputed *leaf* hashes (already leaf-prefixed)."""
    n = len(hashes)
    if n == 0:
        return b""
    if n == 1:
        return hashes[0]
    k = _split_point(n)
    left = simple_hash_from_hashes(hashes[:k], algo)
    right = simple_hash_from_hashes(hashes[k:], algo)
    return inner_hash(left, right, algo)


def simple_hash_from_byte_slices(items: list[bytes], algo: str = DEFAULT_ALGO) -> bytes:
    """Root over raw byte slices (each hashed as a domain-separated leaf)."""
    return simple_hash_from_hashes([leaf_hash(x, algo) for x in items], algo)


@dataclass
class SimpleProof:
    """Inclusion proof: aunt hashes bottom-up (reference: merkle SimpleProof)."""

    index: int
    total: int
    leaf: bytes  # leaf hash (prefixed)
    aunts: list[bytes] = field(default_factory=list)

    def root(self, algo: str = DEFAULT_ALGO) -> bytes:
        return _root_from_aunts(self.index, self.total, self.leaf, self.aunts, algo)

    def encode(self) -> bytes:
        w = Writer().uvarint(self.index).uvarint(self.total).bytes(self.leaf)
        w.uvarint(len(self.aunts))
        for a in self.aunts:
            w.bytes(a)
        return w.build()

    @classmethod
    def decode(cls, data: bytes) -> "SimpleProof":
        r = Reader(data)
        index, total, leaf = r.uvarint(), r.uvarint(), r.bytes()
        aunts = [r.bytes() for _ in range(r.uvarint())]
        return cls(index=index, total=total, leaf=leaf, aunts=aunts)


def _root_from_aunts(
    index: int, total: int, leaf: bytes, aunts: list[bytes], algo: str
) -> bytes:
    if total == 0 or not (0 <= index < total):
        raise ValueError("invalid proof shape")
    if total == 1:
        if aunts:
            raise ValueError("unexpected aunts for single leaf")
        return leaf
    k = _split_point(total)
    if not aunts:
        raise ValueError("missing aunts")
    if index < k:
        left = _root_from_aunts(index, k, leaf, aunts[:-1], algo)
        return inner_hash(left, aunts[-1], algo)
    right = _root_from_aunts(index - k, total - k, leaf, aunts[:-1], algo)
    return inner_hash(aunts[-1], right, algo)


def _proofs(hashes: list[bytes], algo: str) -> tuple[bytes, list[list[bytes]]]:
    n = len(hashes)
    if n == 1:
        return hashes[0], [[]]
    k = _split_point(n)
    lroot, lproofs = _proofs(hashes[:k], algo)
    rroot, rproofs = _proofs(hashes[k:], algo)
    root = inner_hash(lroot, rroot, algo)
    return root, [p + [rroot] for p in lproofs] + [p + [lroot] for p in rproofs]


def simple_proofs_from_byte_slices(
    items: list[bytes], algo: str = DEFAULT_ALGO
) -> tuple[bytes, list[SimpleProof]]:
    """Root + per-item inclusion proofs (reference: SimpleProofsFromHashers)."""
    if not items:
        return b"", []
    leaves = [leaf_hash(x, algo) for x in items]
    root, aunt_lists = _proofs(leaves, algo)
    total = len(items)
    proofs = [
        SimpleProof(index=i, total=total, leaf=leaves[i], aunts=aunts)
        for i, aunts in enumerate(aunt_lists)
    ]
    return root, proofs


def simple_hash_from_map(kvs: dict[str, bytes], algo: str = DEFAULT_ALGO) -> bytes:
    """Root over a string->bytes map, keys sorted (reference: SimpleHashFromMap)."""
    items = [encode_string(k) + encode_bytes(v) for k, v in sorted(kvs.items())]
    return simple_hash_from_byte_slices(items, algo)


def verify_proof(
    root: bytes, item: bytes, proof: SimpleProof, algo: str = DEFAULT_ALGO
) -> bool:
    """Check an item's inclusion proof against a known root."""
    if proof.leaf != leaf_hash(item, algo):
        return False
    try:
        return proof.root(algo) == root
    except ValueError:
        return False
