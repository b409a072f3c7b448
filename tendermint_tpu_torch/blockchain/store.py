"""Persistent block storage (reference `blockchain/store.go:31-230`).

Per height: block meta, the block's parts (individually, so gossip can
serve single parts), the canonical commit of the *previous* block, and
the locally-seen commit (+2/3 precommits this node saw — may differ from
the canonical one and is needed to reconstruct the consensus LastCommit
on restart, `consensus/state.go:392-411`). A JSON height watermark marks
the contiguous store head.

The port's copy of `tendermint_tpu/blockchain/store.py`: the same keys
and encodings, on the port's `db.kv` and `types`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from tendermint_tpu_torch.codec import Reader, Writer
from tendermint_tpu_torch.db.kv import DB
from tendermint_tpu_torch.types.block import Block, Commit, Header
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.part_set import Part, PartSet


@dataclass
class BlockMeta:
    """BlockID + header, servable without the full block
    (reference `types.BlockMeta`)."""

    block_id: BlockID
    header: Header

    def encode(self) -> bytes:
        return Writer().raw(self.block_id.encode()).bytes(self.header.encode()).build()

    @classmethod
    def decode(cls, data: bytes) -> "BlockMeta":
        r = Reader(data)
        block_id = BlockID.decode_from(r)
        header = Header.decode_from(Reader(r.bytes()))
        return cls(block_id=block_id, header=header)


class BlockStore:
    def __init__(self, db: DB) -> None:
        self._db = db
        self._height = 0
        self._base = 0
        raw = db.get(b"blockStore")
        if raw is not None:
            doc = json.loads(raw.decode())
            self._height = doc["height"]
            # pre-base-tracking watermarks imply a store contiguous from 1
            self._base = doc.get("base", 1 if doc["height"] > 0 else 0)

    @property
    def height(self) -> int:
        """Height of the newest stored block (0 if empty)."""
        return self._height

    @property
    def base(self) -> int:
        """Lowest stored height (0 if empty). Snapshot-restored and
        pruned stores start above 1; `load_block*` below the base
        answers None, never a decode error."""
        return self._base

    def _save_watermark(self) -> None:
        self._db.set_sync(
            b"blockStore",
            json.dumps({"height": self._height, "base": self._base}).encode(),
        )

    # -- keys ----------------------------------------------------------------

    @staticmethod
    def _meta_key(height: int) -> bytes:
        return b"H:%d" % height

    @staticmethod
    def _part_key(height: int, index: int) -> bytes:
        return b"P:%d:%d" % (height, index)

    @staticmethod
    def _commit_key(height: int) -> bytes:
        return b"C:%d" % height

    @staticmethod
    def _seen_commit_key(height: int) -> bytes:
        return b"SC:%d" % height

    # -- save ----------------------------------------------------------------

    def save_block(self, block: Block, part_set: PartSet, seen_commit: Commit) -> None:
        """Reference `SaveBlock :148`: must be called with height ==
        store height + 1 (contiguous chain)."""
        height = block.header.height
        if height != self._height + 1:
            raise ValidationError(
                f"BlockStore can only save contiguous blocks: have {self._height}, got {height}"
            )
        if not part_set.is_complete():
            raise ValidationError("BlockStore can only save complete part sets")
        meta = BlockMeta(
            block_id=BlockID(block.hash(), part_set.header), header=block.header
        )
        self._db.set(self._meta_key(height), meta.encode())
        for i in range(part_set.total):
            part = part_set.get_part(i)
            self._db.set(self._part_key(height, i), part.encode())
        # commit of block H-1 (carried inside block H)
        self._db.set(self._commit_key(height - 1), block.last_commit.encode())
        # commit that made THIS block (what we saw locally)
        self._db.set(self._seen_commit_key(height), seen_commit.encode())
        self._height = height
        if self._base == 0:
            self._base = height
        self._save_watermark()

    def bootstrap(self, tail: list) -> None:
        """Seed an EMPTY store from a snapshot's block tail
        `[(block, seen_commit), ...]` (consecutive, ascending). The
        store's base becomes the first tail height — earlier heights
        were never stored here and `load_block*` answers None for them.
        """
        if self._height != 0:
            raise ValidationError(
                f"bootstrap requires an empty store (height {self._height})"
            )
        if not tail:
            return
        prev = None
        for block, seen_commit in tail:
            height = block.header.height
            if prev is not None and height != prev + 1:
                raise ValidationError(
                    f"snapshot tail is not consecutive: {prev} -> {height}"
                )
            prev = height
            part_set = block.make_part_set()
            meta = BlockMeta(
                block_id=BlockID(block.hash(), part_set.header), header=block.header
            )
            self._db.set(self._meta_key(height), meta.encode())
            for i in range(part_set.total):
                self._db.set(self._part_key(height, i), part_set.get_part(i).encode())
            self._db.set(self._commit_key(height - 1), block.last_commit.encode())
            self._db.set(self._seen_commit_key(height), seen_commit.encode())
        self._base = tail[0][0].header.height
        self._height = tail[-1][0].header.height
        self._save_watermark()

    def prune(self, retain_height: int) -> int:
        """Delete blocks below `retain_height` (exclusive), bounding the
        disk a snapshot-serving node spends on history (reference
        `PruneBlocks store.go`). Returns the number of heights pruned;
        the head block is always retained."""
        if retain_height > self._height:
            retain_height = self._height
        if self._base == 0 or retain_height <= self._base:
            return 0
        pruned = 0
        for h in range(self._base, retain_height):
            meta = self.load_block_meta(h)
            if meta is not None:
                for i in range(meta.block_id.parts_header.total):
                    self._db.delete(self._part_key(h, i))
            self._db.delete(self._meta_key(h))
            self._db.delete(self._seen_commit_key(h))
            # C:h-1 rides with block h, so this keeps the canonical
            # commit for retain_height-1 (written by block retain_height)
            self._db.delete(self._commit_key(h - 1))
            pruned += 1
        self._base = retain_height
        self._save_watermark()
        return pruned

    # -- load ----------------------------------------------------------------

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self._db.get(self._meta_key(height))
        return BlockMeta.decode(raw) if raw is not None else None

    def load_block_part(self, height: int, index: int) -> Part | None:
        raw = self._db.get(self._part_key(height, index))
        return Part.decode(raw) if raw is not None else None

    def load_block(self, height: int) -> Block | None:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        buf = b""
        for i in range(meta.block_id.parts_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            buf += part.bytes_
        return Block.decode(buf)

    def load_block_commit(self, height: int) -> Commit | None:
        """Canonical commit for block at `height` (from block height+1)."""
        raw = self._db.get(self._commit_key(height))
        if raw is None:
            return None
        return Commit.decode_from(Reader(raw))

    def load_seen_commit(self, height: int) -> Commit | None:
        raw = self._db.get(self._seen_commit_key(height))
        if raw is None:
            return None
        return Commit.decode_from(Reader(raw))
