"""SnapshotStore: periodic app+state snapshots as Merkle-verified chunks.

A snapshot of height H packs three things into one payload:

* the consensus `State` at H (canonical JSON — what a restored node
  boots from),
* the app's opaque state bytes (via the `snapshot_state()` hook on
  `abci.Application`),
* a short block-store tail ending at H (blocks + their seen commits),
  so the restored node can reconstruct LastCommit for consensus and
  serve recent blocks without re-downloading them.

The payload splits into fixed-size chunks; the chunk tree hashes
through the TreeHasher seam (`services/hasher.py`) so snapshot creation
AND restore-side verification ride the batched device Merkle path on
the card, with the circuit breaker degrading to host hashlib
(`services/resilient.py`). Manifests + chunks persist in a `db/kv.py`
store under prefixed keys.

The port's copy of `tendermint_tpu/statesync/snapshot.py`. `hasher=None`
is the host tree; the port's `default_hasher()` hashes a chunk set of
8,192 or more on the card (`sha256_masked`, then `merkle_level` for the
root).
"""

from __future__ import annotations

import json
import time

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.db.kv import DB
from tendermint_tpu_torch.merkle.simple import leaf_hash
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.types.block import Block, Commit
from tendermint_tpu_torch.types.errors import ValidationError

SNAPSHOT_FORMAT = 1
DEFAULT_CHUNK_SIZE = 64 * 1024
DEFAULT_TAIL_LEN = 2  # blocks carried alongside the state
MAX_CHUNKS = 1 << 20  # manifest sanity cap (64 GiB at the default size)

_MANIFEST_PREFIX = b"ssm:"
_CHUNK_PREFIX = b"ssc:"


class SnapshotManifest:
    """Everything a syncing peer needs to fetch + verify one snapshot.

    `root` commits to the ordered chunk list (SimpleMerkle over raw
    chunk bytes); `chunk_hashes` are the per-chunk leaf hashes so single
    chunks can be blamed on arrival. `app_hash` is the state's app hash
    at `height` — trusted only once the header at `height + 1` carrying
    it passes certifier anchoring (`statesync/trust.py`).
    """

    def __init__(
        self,
        height: int,
        chunks: int,
        chunk_size: int,
        root: bytes,
        chunk_hashes: list[bytes],
        app_hash: bytes,
        chain_id: str,
        payload_len: int,
        format: int = SNAPSHOT_FORMAT,
    ) -> None:
        self.height = height
        self.format = format
        self.chunks = chunks
        self.chunk_size = chunk_size
        self.root = root
        self.chunk_hashes = chunk_hashes
        self.app_hash = app_hash
        self.chain_id = chain_id
        self.payload_len = payload_len

    def key(self) -> tuple[int, int]:
        return (self.height, self.format)

    def validate_basic(self) -> None:
        if self.height < 1:
            raise ValidationError(f"snapshot height {self.height} < 1")
        if not (0 < self.chunks <= MAX_CHUNKS):
            raise ValidationError(f"snapshot chunk count {self.chunks} out of range")
        if len(self.chunk_hashes) != self.chunks:
            raise ValidationError(
                f"manifest lists {len(self.chunk_hashes)} chunk hashes "
                f"for {self.chunks} chunks"
            )
        if self.chunk_size < 1 or self.payload_len < 1:
            raise ValidationError("bad snapshot chunk size / payload length")
        if self.payload_len > self.chunks * self.chunk_size:
            raise ValidationError("payload length exceeds chunk capacity")
        if not self.root:
            raise ValidationError("manifest has no root hash")

    def verify_root(self, hasher) -> None:
        """Bind the per-chunk hash list to the root via one batched tree
        reduction (the device path on the card). A manifest whose list does not
        fold to its root could blame honest chunks later."""
        if _root_from_leaf_hashes(self.chunk_hashes, hasher) != self.root:
            raise ValidationError("manifest chunk hashes do not match root")

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "height": self.height,
                "format": self.format,
                "chunks": self.chunks,
                "chunk_size": self.chunk_size,
                "root": self.root.hex(),
                "chunk_hashes": [h.hex() for h in self.chunk_hashes],
                "app_hash": self.app_hash.hex(),
                "chain_id": self.chain_id,
                "payload_len": self.payload_len,
            },
            sort_keys=True,
        ).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "SnapshotManifest":
        d = json.loads(raw.decode())
        return cls(
            height=d["height"],
            format=d["format"],
            chunks=d["chunks"],
            chunk_size=d["chunk_size"],
            root=bytes.fromhex(d["root"]),
            chunk_hashes=[bytes.fromhex(h) for h in d["chunk_hashes"]],
            app_hash=bytes.fromhex(d["app_hash"]),
            chain_id=d["chain_id"],
            payload_len=d["payload_len"],
        )


def _root_from_leaf_hashes(hashes: list[bytes], hasher) -> bytes:
    if hasher is not None:
        return hasher.root_from_hashes(hashes)
    from tendermint_tpu_torch.merkle.simple import simple_hash_from_hashes

    return simple_hash_from_hashes(hashes)


def _chunk_leaf_hashes(chunks: list[bytes], hasher) -> list[bytes]:
    """Leaf hashes for raw chunks, batched through the hasher seam when
    it exposes one (device SHA-256 over all chunks in one launch)."""
    if hasher is not None and hasattr(hasher, "leaf_hashes"):
        return hasher.leaf_hashes(chunks)
    return [leaf_hash(c) for c in chunks]


# -- payload ------------------------------------------------------------------


def build_payload(state, app_state: bytes, tail: list[tuple[Block, Commit]]) -> bytes:
    """Serialize (state, app bytes, block tail) into the chunkable blob."""
    w = Writer().bytes(state.to_json()).bytes(app_state)
    w.uvarint(len(tail))
    for block, seen_commit in tail:
        w.bytes(block.encode()).bytes(seen_commit.encode())
    return w.build()


def decode_payload(payload: bytes) -> tuple[bytes, bytes, list[tuple[Block, Commit]]]:
    """-> (state_json, app_state, [(block, seen_commit), ...])."""
    r = Reader(payload)
    state_json = r.bytes()
    app_state = r.bytes()
    tail = []
    for _ in range(r.uvarint()):
        block = Block.decode(r.bytes())
        commit = Commit.decode_from(Reader(r.bytes()))
        tail.append((block, commit))
    return state_json, app_state, tail


def split_chunks(payload: bytes, chunk_size: int) -> list[bytes]:
    return [payload[i : i + chunk_size] for i in range(0, len(payload), chunk_size)]


def verify_chunks_async(
    manifest: SnapshotManifest, chunks: list[bytes], hasher=None, queue=None
):
    """The chunk-verify gate as a dispatch HANDLE: the whole-set leaf
    hashing launches through the hasher's async seam (device batch on
    the card, breaker-guarded), the per-chunk comparison + root fold run at
    the join. The restore path overlaps payload decoding with the
    in-flight hash launch and joins this gate before applying anything.
    The handle's `.result()` raises the same ValidationErrors the
    blocking `verify_chunks` did."""
    from tendermint_tpu_torch.services.dispatch import CompletedHandle

    if len(chunks) != manifest.chunks:
        return CompletedHandle(
            exc=ValidationError(
                f"have {len(chunks)} chunks, manifest wants {manifest.chunks}"
            )
        )
    t0 = time.perf_counter()

    def _gate(hashes) -> bool:
        try:
            for i, (got, want) in enumerate(zip(hashes, manifest.chunk_hashes)):
                if got != want:
                    raise ValidationError(f"chunk {i} hash mismatch")
            if _root_from_leaf_hashes(hashes, hasher) != manifest.root:
                raise ValidationError("chunk tree does not fold to manifest root")
            return True
        finally:
            _metrics.STATESYNC_CHUNK_VERIFY_SECONDS.observe(
                time.perf_counter() - t0
            )

    if hasher is not None and hasattr(hasher, "leaf_hashes_async"):
        return hasher.leaf_hashes_async(chunks, queue=queue).then(_gate)
    hashes = _chunk_leaf_hashes(chunks, hasher)
    try:
        return CompletedHandle(_gate(hashes))
    except ValidationError as e:
        return CompletedHandle(exc=e)


def verify_chunks(
    manifest: SnapshotManifest, chunks: list[bytes], hasher=None
) -> None:
    """Blocking chunk-set verification (submit + join of the async
    gate): leaf-hash every chunk and fold the tree in one device batch
    (host hashlib behind the breaker otherwise). Raises ValidationError
    naming the first bad chunk index."""
    verify_chunks_async(manifest, chunks, hasher).result()


# -- store --------------------------------------------------------------------


class SnapshotStore:
    """Persists manifests + chunks; takes new snapshots from live state.

    Keys: `ssm:<height>:<format>` -> manifest JSON,
    `ssc:<height>:<format>:<index>` -> raw chunk bytes. Heights are
    zero-padded so `iterate` returns snapshots in height order.
    """

    def __init__(
        self,
        db: DB,
        hasher=None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        keep_recent: int = 2,
    ) -> None:
        self._db = db
        self.hasher = hasher
        self.chunk_size = chunk_size
        self.keep_recent = keep_recent

    @staticmethod
    def _manifest_key(height: int, format: int) -> bytes:
        return _MANIFEST_PREFIX + b"%020d:%d" % (height, format)

    @staticmethod
    def _chunk_key(height: int, format: int, index: int) -> bytes:
        return _CHUNK_PREFIX + b"%020d:%d:%d" % (height, format, index)

    # -- creation ------------------------------------------------------------

    def take(
        self,
        state,
        app_state: bytes,
        block_store=None,
        tail_len: int = DEFAULT_TAIL_LEN,
    ) -> SnapshotManifest:
        """Snapshot the given state (at `state.last_block_height`).

        `app_state` comes from the app's `snapshot_state()` hook; the
        block tail is read from `block_store` (bounded by its base, so
        pruned stores snapshot what they still have).
        """
        height = state.last_block_height
        if height < 1:
            raise ValidationError("cannot snapshot before the first block")
        t0 = time.perf_counter()
        tail: list[tuple[Block, Commit]] = []
        if block_store is not None and tail_len > 0:
            lo = max(height - tail_len + 1, getattr(block_store, "base", 1), 1)
            for h in range(lo, height + 1):
                block = block_store.load_block(h)
                seen = block_store.load_seen_commit(h)
                if block is None or seen is None:
                    raise ValidationError(f"block store missing tail height {h}")
                tail.append((block, seen))
        payload = build_payload(state, app_state, tail)
        chunks = split_chunks(payload, self.chunk_size)
        chunk_hashes = _chunk_leaf_hashes(chunks, self.hasher)
        root = _root_from_leaf_hashes(chunk_hashes, self.hasher)
        manifest = SnapshotManifest(
            height=height,
            chunks=len(chunks),
            chunk_size=self.chunk_size,
            root=root,
            chunk_hashes=chunk_hashes,
            app_hash=state.app_hash,
            chain_id=state.chain_id,
            payload_len=len(payload),
        )
        for i, chunk in enumerate(chunks):
            self._db.set(self._chunk_key(height, manifest.format, i), chunk)
        # manifest last: a crash mid-write leaves orphan chunks, never a
        # manifest advertising chunks that are not there
        self._db.set_sync(
            self._manifest_key(height, manifest.format), manifest.to_json()
        )
        self.prune_snapshots()
        _metrics.STATESYNC_SNAPSHOT_SECONDS.observe(time.perf_counter() - t0)
        _metrics.STATESYNC_SNAPSHOTS_TAKEN.inc()
        return manifest

    # -- access --------------------------------------------------------------

    def list_manifests(self) -> list[SnapshotManifest]:
        """All stored manifests, ascending by height."""
        out = []
        for _k, raw in self._db.iterate(_MANIFEST_PREFIX):
            out.append(SnapshotManifest.from_json(raw))
        return out

    def get_manifest(self, height: int, format: int = SNAPSHOT_FORMAT):
        raw = self._db.get(self._manifest_key(height, format))
        return SnapshotManifest.from_json(raw) if raw is not None else None

    def load_chunk(
        self, height: int, format: int, index: int
    ) -> bytes | None:
        return self._db.get(self._chunk_key(height, format, index))

    def corrupt_chunk(
        self, height: int, format: int = SNAPSHOT_FORMAT, index: int = 0
    ) -> bool:
        """Chaos hook (tests, tools/statesync_demo.py): flip every byte
        of a STORED chunk so a peer serves garbage without knowing."""
        key = self._chunk_key(height, format, index)
        chunk = self._db.get(key)
        if chunk is None:
            return False
        self._db.set(key, bytes(b ^ 0xFF for b in chunk))
        return True

    def delete_snapshot(self, height: int, format: int = SNAPSHOT_FORMAT) -> None:
        m = self.get_manifest(height, format)
        self._db.delete(self._manifest_key(height, format))
        if m is not None:
            for i in range(m.chunks):
                self._db.delete(self._chunk_key(height, format, i))

    def prune_snapshots(self) -> None:
        """Keep only the newest `keep_recent` snapshots."""
        manifests = self.list_manifests()
        for m in manifests[: -self.keep_recent or None]:
            self.delete_snapshot(m.height, m.format)
