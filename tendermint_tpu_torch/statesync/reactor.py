"""StateSyncReactor: snapshot discovery + chunk sync over its own p2p
channel (0x60).

Protocol (all frames `uvarint tag || fields`, like the blockchain
channel):

* `snapshots_request` -> `snapshots_response` (the serving node's
  manifests, newest last);
* `chunk_request(height, format, index)` -> `chunk_response(...)` or
  `no_chunk(...)`;
* `commit_request(height)` -> `commit_response(height, FullCommit?)` —
  the light-client material (header + commit + valset) the trust anchor
  (`statesync/trust.py`) certifies before any chunk is applied.

The client side runs a sync routine: discover -> anchor trust -> fetch
chunks (per-peer in-flight limits, timeout/requeue via ChunkPool — the
`blockchain/pool.py` requester pattern) -> batch-verify the chunk tree
through the device hasher -> restore state/app/block-tail -> hand off
to fast-sync via `on_synced`.

The server side answers from the SnapshotStore and, when wired to the
consensus event bus, takes a new snapshot every `snapshot_interval`
committed heights.

The port's copy of `tendermint_tpu/statesync/reactor.py`. Channel 0x60,
the JAX reactor's wire.
"""

from __future__ import annotations

import logging
import threading
import time

from tendermint_tpu_torch.certifiers.certifier import FullCommit
from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.merkle.simple import leaf_hash
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.peer import Peer
from tendermint_tpu_torch.p2p.switch import Reactor
from tendermint_tpu_torch.statesync.snapshot import (
    SnapshotManifest,
    SnapshotStore,
    decode_payload,
    verify_chunks_async,
)
from tendermint_tpu_torch.statesync.trust import TrustAnchor
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.utils.log import kv, logger

STATESYNC_CHANNEL = 0x60

_MSG_SNAPSHOTS_REQUEST = 0x01
_MSG_SNAPSHOTS_RESPONSE = 0x02
_MSG_CHUNK_REQUEST = 0x03
_MSG_CHUNK_RESPONSE = 0x04
_MSG_NO_CHUNK = 0x05
_MSG_COMMIT_REQUEST = 0x06
_MSG_COMMIT_RESPONSE = 0x07

_SYNC_TICK_S = 0.05
_MAX_OFFERED_SNAPSHOTS = 8  # per peer; drop floods

_log = logger("statesync")


def decode_message(payload: bytes):
    r = Reader(payload)
    tag = r.uvarint()
    if tag == _MSG_SNAPSHOTS_REQUEST:
        return ("snapshots_request", None)
    if tag == _MSG_SNAPSHOTS_RESPONSE:
        manifests = [
            SnapshotManifest.from_json(r.bytes()) for _ in range(r.uvarint())
        ]
        return ("snapshots_response", manifests)
    if tag == _MSG_CHUNK_REQUEST:
        return ("chunk_request", (r.uvarint(), r.uvarint(), r.uvarint()))
    if tag == _MSG_CHUNK_RESPONSE:
        return ("chunk_response", (r.uvarint(), r.uvarint(), r.uvarint(), r.bytes()))
    if tag == _MSG_NO_CHUNK:
        return ("no_chunk", (r.uvarint(), r.uvarint(), r.uvarint()))
    if tag == _MSG_COMMIT_REQUEST:
        return ("commit_request", r.uvarint())
    if tag == _MSG_COMMIT_RESPONSE:
        height = r.uvarint()
        raw = r.bytes()
        return ("commit_response", (height, FullCommit.decode(raw) if raw else None))
    raise ValueError(f"unknown statesync message tag {tag:#x}")


def _enc_snapshots_response(manifests: list[SnapshotManifest]) -> bytes:
    w = Writer().uvarint(_MSG_SNAPSHOTS_RESPONSE).uvarint(len(manifests))
    for m in manifests:
        w.bytes(m.to_json())
    return w.build()


def _enc_chunk_request(height: int, format: int, index: int) -> bytes:
    return (
        Writer()
        .uvarint(_MSG_CHUNK_REQUEST)
        .uvarint(height)
        .uvarint(format)
        .uvarint(index)
        .build()
    )


def _enc_chunk_response(height: int, format: int, index: int, data: bytes) -> bytes:
    return (
        Writer()
        .uvarint(_MSG_CHUNK_RESPONSE)
        .uvarint(height)
        .uvarint(format)
        .uvarint(index)
        .bytes(data)
        .build()
    )


def _enc_no_chunk(height: int, format: int, index: int) -> bytes:
    return (
        Writer()
        .uvarint(_MSG_NO_CHUNK)
        .uvarint(height)
        .uvarint(format)
        .uvarint(index)
        .build()
    )


def _enc_commit_request(height: int) -> bytes:
    return Writer().uvarint(_MSG_COMMIT_REQUEST).uvarint(height).build()


def _enc_commit_response(height: int, fc: FullCommit | None) -> bytes:
    return (
        Writer()
        .uvarint(_MSG_COMMIT_RESPONSE)
        .uvarint(height)
        .bytes(fc.encode() if fc is not None else b"")
        .build()
    )


class ChunkPool:
    """Chunk-request bookkeeping: per-peer in-flight limits with
    timeout/requeue of stalled requests (the `blockchain/pool.py`
    requester pattern applied to snapshot chunk indices)."""

    def __init__(
        self,
        n_chunks: int,
        inflight_per_peer: int = 4,
        request_timeout_s: float = 10.0,
        time_fn=time.monotonic,
    ) -> None:
        self.n_chunks = n_chunks
        self.inflight_per_peer = inflight_per_peer
        self.request_timeout_s = request_timeout_s
        self._time_fn = time_fn
        self._lock = threading.Lock()
        self._peers: set[str] = set()
        self._requests: dict[int, tuple[str, float]] = {}  # idx -> (peer, sent_at)
        self._chunks: dict[int, bytes] = {}

    def add_peer(self, peer_id: str) -> None:
        with self._lock:
            self._peers.add(peer_id)

    def remove_peer(self, peer_id: str) -> None:
        """Forget the peer; its in-flight chunk requests requeue."""
        with self._lock:
            self._peers.discard(peer_id)
            for i in [i for i, (p, _) in self._requests.items() if p == peer_id]:
                del self._requests[i]

    def num_peers(self) -> int:
        with self._lock:
            return len(self._peers)

    def schedule(self, now: float | None = None) -> tuple[list[tuple[str, int]], list[str]]:
        """One tick -> (requests to send, peers to evict). A request
        older than the timeout evicts its peer (a peer advertising a
        snapshot it never serves must not stall the restore) and its
        chunk reassigns to the survivors in the same tick."""
        now = now if now is not None else self._time_fn()
        out: list[tuple[str, int]] = []
        evict: list[str] = []
        with self._lock:
            for i, (p, sent_at) in list(self._requests.items()):
                if now - sent_at > self.request_timeout_s:
                    if p in self._peers and p not in evict:
                        evict.append(p)
            for p in evict:
                self._peers.discard(p)
                for i in [i for i, (q, _) in self._requests.items() if q == p]:
                    del self._requests[i]
            if not self._peers:
                return out, evict
            loads = {p: 0 for p in self._peers}
            for p, _ in self._requests.values():
                if p in loads:
                    loads[p] += 1
            for i in range(self.n_chunks):
                if i in self._chunks or i in self._requests:
                    continue
                peer = min(
                    (p for p in loads if loads[p] < self.inflight_per_peer),
                    key=lambda p: loads[p],
                    default=None,
                )
                if peer is None:
                    break
                loads[peer] += 1
                self._requests[i] = (peer, now)
                out.append((peer, i))
        return out, evict

    def add_chunk(self, peer_id: str, index: int, data: bytes) -> bool:
        """Accept a response only for an index requested from that peer."""
        with self._lock:
            req = self._requests.get(index)
            if req is None or req[0] != peer_id:
                return False
            del self._requests[index]
            self._chunks[index] = data
        return True

    def requeue(self, index: int) -> None:
        """A delivered chunk failed its hash check: fetch it again."""
        with self._lock:
            self._chunks.pop(index, None)
            self._requests.pop(index, None)

    def is_complete(self) -> bool:
        with self._lock:
            return len(self._chunks) == self.n_chunks

    def chunks(self) -> list[bytes]:
        with self._lock:
            return [self._chunks[i] for i in range(self.n_chunks)]


class _Candidate:
    __slots__ = ("manifest", "peers", "root_checked")

    def __init__(self, manifest: SnapshotManifest) -> None:
        self.manifest = manifest
        self.peers: set[str] = set()
        self.root_checked = False


class StateSyncReactor(Reactor):
    """Serves snapshots to peers; optionally bootstraps from them.

    `on_synced(state_or_none)` fires once when the sync routine ends:
    with the restored State on success, with None when state sync gave
    up (no snapshots / all rejected) and the node should fall back to
    plain fast-sync from its current state.
    """

    def __init__(
        self,
        snapshot_store: SnapshotStore,
        block_store,
        state,
        sync: bool = False,
        trust_anchor: TrustAnchor | None = None,
        state_db=None,
        app_restore_fn=None,
        app_snapshot_fn=None,
        on_synced=None,
        hasher=None,
        snapshot_interval: int = 0,
        retain_blocks: int = 0,
        discovery_time_s: float = 3.0,
        chunk_request_timeout_s: float = 10.0,
        chunk_inflight_per_peer: int = 4,
        commit_timeout_s: float = 5.0,
        giveup_time_s: float = 45.0,
    ) -> None:
        super().__init__()
        self.snapshot_store = snapshot_store
        self.block_store = block_store
        self.state = state  # serving-side: load_validators / chain identity
        self.sync = sync
        self.trust_anchor = trust_anchor
        self.state_db = state_db
        self.app_restore_fn = app_restore_fn
        self.app_snapshot_fn = app_snapshot_fn
        self.on_synced = on_synced
        self.hasher = hasher
        self.snapshot_interval = snapshot_interval
        self.retain_blocks = retain_blocks
        self.discovery_time_s = discovery_time_s
        self.chunk_request_timeout_s = chunk_request_timeout_s
        self.chunk_inflight_per_peer = chunk_inflight_per_peer
        self.commit_timeout_s = commit_timeout_s
        self.giveup_time_s = giveup_time_s

        self._running = False
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._candidates: dict[tuple, _Candidate] = {}
        self._rejected: set[tuple] = set()
        self._pool: ChunkPool | None = None
        self._active_key: tuple | None = None
        # commit_request correlation: height -> (event, [FullCommit|None])
        self._commit_waits: dict[int, tuple[threading.Event, list]] = {}
        # Resume the snapshot cadence from the persisted store: a
        # restarted serving node advertises its existing snapshots
        # immediately and only re-takes once the interval elapses past
        # the newest persisted height (instead of re-taking at the next
        # interval as if it had never snapshotted).
        manifests = snapshot_store.list_manifests()
        self._last_snapshot_height = manifests[-1].height if manifests else 0
        self.restored_state = None  # set on successful restore; fast-sync
        # then advances it IN PLACE — read restored_manifest for the
        # height the snapshot itself landed at
        self.restored_manifest: SnapshotManifest | None = None

    # -- reactor interface -------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        # chunk frames are big (chunk_size + framing); keep the queue
        # shallow so backpressure reaches the scheduler, not the switch
        return [
            ChannelDescriptor(
                STATESYNC_CHANNEL, priority=3, send_queue_capacity=32
            )
        ]

    def on_start(self) -> None:
        self._running = True
        if self.sync:
            self._thread = threading.Thread(
                target=self._sync_routine, name="statesync", daemon=True
            )
            self._thread.start()

    def on_stop(self) -> None:
        self._running = False

    def add_peer(self, peer: Peer) -> None:
        if self.sync:
            peer.try_send(
                STATESYNC_CHANNEL, Writer().uvarint(_MSG_SNAPSHOTS_REQUEST).build()
            )

    def remove_peer(self, peer: Peer, reason) -> None:
        with self._lock:
            for cand in self._candidates.values():
                cand.peers.discard(peer.id)
        if self._pool is not None:
            self._pool.remove_peer(peer.id)

    def receive(self, chan_id: int, peer: Peer, payload: bytes) -> None:
        kind, arg = decode_message(payload)
        if kind == "snapshots_request":
            manifests = self.snapshot_store.list_manifests()
            peer.try_send(STATESYNC_CHANNEL, _enc_snapshots_response(manifests))
        elif kind == "snapshots_response":
            self._on_snapshots(peer, arg)
        elif kind == "chunk_request":
            height, fmt, index = arg
            chunk = self.snapshot_store.load_chunk(height, fmt, index)
            if chunk is not None:
                _metrics.STATESYNC_CHUNKS_SERVED.inc()
                peer.try_send(
                    STATESYNC_CHANNEL, _enc_chunk_response(height, fmt, index, chunk)
                )
            else:
                peer.try_send(STATESYNC_CHANNEL, _enc_no_chunk(height, fmt, index))
        elif kind == "chunk_response":
            self._on_chunk(peer, *arg)
        elif kind == "no_chunk":
            height, fmt, index = arg
            if self._pool is not None and self._active_key is not None:
                if self._active_key[:2] == (height, fmt):
                    # the peer lied about having this snapshot
                    self._pool.remove_peer(peer.id)
        elif kind == "commit_request":
            peer.try_send(
                STATESYNC_CHANNEL,
                _enc_commit_response(arg, self._serve_commit(arg)),
            )
        elif kind == "commit_response":
            height, fc = arg
            with self._lock:
                wait = self._commit_waits.get(height)
            if wait is not None:
                wait[1].append(fc)
                wait[0].set()

    # -- serving side ------------------------------------------------------

    def _serve_commit(self, height: int) -> FullCommit | None:
        """FullCommit for `height` from local stores: header from the
        block meta, canonical commit (falling back to the seen commit),
        validators from the historical valset index."""
        meta = self.block_store.load_block_meta(height)
        if meta is None:
            return None
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            commit = self.block_store.load_seen_commit(height)
        if commit is None:
            return None
        try:
            validators = self.state.load_validators(height)
        except ValidationError:
            return None
        return FullCommit(header=meta.header, commit=commit, validators=validators)

    def maybe_take_snapshot(self, state, app=None) -> SnapshotManifest | None:
        """Take a snapshot when the interval elapsed. Wired to the
        consensus EVENT_NEW_BLOCK listener (runs on the consensus thread
        right after commit, so state + app are at the same height)."""
        if self.snapshot_interval <= 0:
            return None
        height = state.last_block_height
        if height < self.snapshot_interval:
            return None
        if height - self._last_snapshot_height < self.snapshot_interval:
            return None
        snapshot_fn = self.app_snapshot_fn
        if snapshot_fn is None and app is not None:
            snapshot_fn = getattr(app, "snapshot_state", None)
        if snapshot_fn is None:
            return None
        app_state = snapshot_fn()
        if app_state is None:
            return None  # app opted out of snapshots
        self._last_snapshot_height = height
        manifest = self.snapshot_store.take(
            state, app_state, block_store=self.block_store
        )
        kv(
            _log,
            logging.INFO,
            "snapshot taken",
            height=height,
            chunks=manifest.chunks,
            root=manifest.root.hex()[:12],
        )
        self._maybe_prune_blocks(height)
        return manifest

    def _maybe_prune_blocks(self, height: int) -> None:
        """Retention-driven `BlockStore.prune` ([statesync]
        retain_blocks): runs right AFTER a snapshot lands so the chunked
        payload — not the block store — carries the history peers need;
        the store keeps a bounded `retain_blocks` tail for fast-sync
        serving and the next snapshot's block tail."""
        if self.retain_blocks <= 0 or not hasattr(self.block_store, "prune"):
            return
        retain_height = height - self.retain_blocks + 1
        if retain_height <= 1:
            return
        try:
            pruned = self.block_store.prune(retain_height)
        except Exception:
            logging.getLogger(__name__).exception("block-store prune failed")
            return
        if pruned:
            kv(
                _log,
                logging.INFO,
                "pruned block store",
                retain_height=retain_height,
                pruned=pruned,
                base=getattr(self.block_store, "base", None),
            )

    # -- syncing side: message handling ------------------------------------

    def _on_snapshots(self, peer: Peer, manifests: list[SnapshotManifest]) -> None:
        for m in manifests[:_MAX_OFFERED_SNAPSHOTS]:
            try:
                m.validate_basic()
            except ValidationError as e:
                if self.switch is not None:
                    self.switch.stop_peer_for_error(peer, f"bad snapshot offer: {e}")
                return
            key = (m.height, m.format, m.root)
            with self._lock:
                if key in self._rejected:
                    continue
                cand = self._candidates.get(key)
                if cand is None:
                    cand = self._candidates[key] = _Candidate(m)
                cand.peers.add(peer.id)
            if self._pool is not None and self._active_key == key:
                self._pool.add_peer(peer.id)

    def _on_chunk(
        self, peer: Peer, height: int, fmt: int, index: int, data: bytes
    ) -> None:
        pool, key = self._pool, self._active_key
        if pool is None or key is None or key[:2] != (height, fmt):
            return
        manifest = self._candidates[key].manifest
        if index >= manifest.chunks:
            return
        # cheap host check on arrival — single-chunk blame; the batched
        # device pass over the WHOLE set gates the actual restore
        if leaf_hash(data) != manifest.chunk_hashes[index]:
            _metrics.STATESYNC_CHUNKS.labels(result="corrupt").inc()
            pool.remove_peer(peer.id)
            pool.requeue(index)
            if self.switch is not None:
                self.switch.stop_peer_for_error(
                    peer, f"corrupt statesync chunk {index}@{height}"
                )
            return
        if pool.add_chunk(peer.id, index, data):
            _metrics.STATESYNC_CHUNKS.labels(result="ok").inc()

    # -- syncing side: the routine -----------------------------------------

    def _peers_by_id(self) -> dict[str, Peer]:
        if self.switch is None:
            return {}
        return {p.id: p for p in self.switch.peers()}

    def _request_commit(self, height: int) -> FullCommit | None:
        """Fetch the FullCommit at `height` from any candidate-serving
        peer (each peer gets one `commit_timeout_s` shot)."""
        ev = threading.Event()
        box: list = []
        with self._lock:
            self._commit_waits[height] = (ev, box)
            peer_ids = set()
            for cand in self._candidates.values():
                peer_ids |= cand.peers
        try:
            peers = self._peers_by_id()
            for pid in peer_ids:
                peer = peers.get(pid)
                if peer is None:
                    continue
                ev.clear()
                peer.try_send(STATESYNC_CHANNEL, _enc_commit_request(height))
                if ev.wait(self.commit_timeout_s) and box and box[-1] is not None:
                    return box[-1]
            return None
        finally:
            with self._lock:
                self._commit_waits.pop(height, None)

    def _pick_candidate(self) -> tuple | None:
        """Best un-rejected candidate: highest height with a live peer."""
        with self._lock:
            best = None
            for key, cand in self._candidates.items():
                if key in self._rejected or not cand.peers:
                    continue
                if self.trust_anchor is not None:
                    if cand.manifest.chain_id != self.trust_anchor.chain_id:
                        continue
                    if (
                        self.trust_anchor.options.height > 0
                        and cand.manifest.height < self.trust_anchor.options.height
                    ):
                        continue
                if best is None or key[0] > best[0]:
                    best = key
            return best

    def _reject(self, key: tuple, reason: str) -> None:
        with self._lock:
            self._rejected.add(key)
        _metrics.STATESYNC_SNAPSHOTS_REJECTED.inc()
        kv(
            _log,
            logging.WARNING,
            "snapshot rejected",
            height=key[0],
            root=key[2].hex()[:12],
            reason=reason[:120],
        )

    def _sync_routine(self) -> None:
        t_start = time.monotonic()
        deadline = t_start + self.giveup_time_s
        last_discover = 0.0
        try:
            while self._running:
                now = time.monotonic()
                if now > deadline:
                    kv(
                        _log,
                        logging.WARNING,
                        "state sync gave up",
                        waited_s=round(now - t_start, 1),
                    )
                    self._finish(None)
                    return
                if now - last_discover > self.discovery_time_s:
                    last_discover = now
                    if self.switch is not None:
                        self.switch.broadcast(
                            STATESYNC_CHANNEL,
                            Writer().uvarint(_MSG_SNAPSHOTS_REQUEST).build(),
                        )
                if now - t_start < self.discovery_time_s:
                    time.sleep(_SYNC_TICK_S)
                    continue  # let first offers arrive before committing
                key = self._pick_candidate()
                if key is None:
                    time.sleep(_SYNC_TICK_S)
                    continue
                state = self._attempt(key)
                if state is not None:
                    self._finish(state)
                    return
                time.sleep(_SYNC_TICK_S)
        except Exception:
            logging.getLogger(__name__).exception("state sync failed")
            self._finish(None)

    def _attempt(self, key: tuple) -> object | None:
        """Try one candidate end-to-end; None means rejected/failed (the
        routine keeps discovering)."""
        cand = self._candidates[key]
        manifest = cand.manifest
        t0 = time.perf_counter()
        # 1. trust anchoring BEFORE fetching a single chunk
        try:
            if self.trust_anchor is not None:
                pin_fc = None
                if self.trust_anchor.options.height > 0:
                    pin_fc = self._request_commit(self.trust_anchor.options.height)
                    if pin_fc is None:
                        self._reject(key, "no peer served the trust-root commit")
                        return None
                anchor_fc = self._request_commit(
                    self.trust_anchor.anchor_height(manifest.height)
                )
                if anchor_fc is None:
                    self._reject(key, "no peer served the anchoring commit")
                    return None
                self.trust_anchor.verify_snapshot(manifest, anchor_fc, pin_fc)
            else:
                anchor_fc = None
            # bind the per-chunk hash list to the root (one device batch)
            manifest.verify_root(self.hasher)
        except ValidationError as e:
            self._reject(key, f"trust anchoring failed: {e}")
            return None
        kv(
            _log,
            logging.INFO,
            "snapshot anchored",
            height=manifest.height,
            chunks=manifest.chunks,
        )
        # 2. chunk fetch with per-peer in-flight limits + requeue
        pool = ChunkPool(
            manifest.chunks,
            inflight_per_peer=self.chunk_inflight_per_peer,
            request_timeout_s=self.chunk_request_timeout_s,
        )
        for pid in set(cand.peers):
            pool.add_peer(pid)
        self._pool, self._active_key = pool, key
        try:
            fetch_deadline = time.monotonic() + self.giveup_time_s
            while self._running and not pool.is_complete():
                if time.monotonic() > fetch_deadline:
                    self._reject(key, "chunk fetch timed out")
                    return None
                if pool.num_peers() == 0:
                    self._reject(key, "no peers left serving the snapshot")
                    return None
                requests, evictions = pool.schedule()
                for pid in evictions:
                    _metrics.STATESYNC_CHUNKS.labels(result="timeout").inc()
                peers = self._peers_by_id()
                for pid, index in requests:
                    peer = peers.get(pid)
                    if peer is None:
                        pool.remove_peer(pid)
                        continue
                    peer.try_send(
                        STATESYNC_CHANNEL,
                        _enc_chunk_request(manifest.height, manifest.format, index),
                    )
                time.sleep(_SYNC_TICK_S)
            if not pool.is_complete():
                return None
            # 3. whole-set verification in one device batch — launched
            # as a dispatch handle so the payload decode (pure parsing,
            # applies nothing) overlaps the in-flight hash kernel; the
            # gate is joined BEFORE any restore side effect
            chunks = pool.chunks()
            try:
                gate = verify_chunks_async(manifest, chunks, self.hasher)
                payload = b"".join(chunks)[: manifest.payload_len]
                try:
                    decoded = decode_payload(payload)
                except Exception as decode_err:
                    try:
                        gate.result()  # release the handle's queue slot
                    except ValidationError:
                        pass
                    raise ValidationError(
                        f"snapshot payload undecodable: {decode_err}"
                    ) from decode_err
                gate.result()
                state = self._restore(manifest, decoded, anchor_fc)
            except ValidationError as e:
                self._reject(key, f"restore failed: {e}")
                _metrics.STATESYNC_RESTORES.labels(result="failed").inc()
                return None
            _metrics.STATESYNC_RESTORES.labels(result="ok").inc()
            _metrics.STATESYNC_RESTORE_SECONDS.observe(time.perf_counter() - t0)
            self.restored_manifest = manifest
            return state
        finally:
            self._pool, self._active_key = None, None

    def _restore(self, manifest: SnapshotManifest, decoded, anchor_fc):
        """Apply a fully-decoded, fully-VERIFIED chunk payload: state
        DB, app state, block-store tail. Only reached after the batched
        Merkle gate joined clean (decoding itself happens earlier,
        overlapped with the in-flight hash launch)."""
        from tendermint_tpu_torch.state.state import State

        state_json, app_state, tail = decoded
        state = State.from_json(state_json, db=self.state_db)
        if state.last_block_height != manifest.height:
            raise ValidationError(
                f"snapshot state is at {state.last_block_height}, "
                f"manifest says {manifest.height}"
            )
        if self.trust_anchor is not None and anchor_fc is not None:
            self.trust_anchor.verify_restored_state(state, anchor_fc)
        if self.app_restore_fn is None:
            raise ValidationError("app does not support state restore")
        self.app_restore_fn(app_state)
        # seed the historical-valset index before the first save writes
        # a change-height pointer into history this node never stored
        state.save_validators_full()
        state.save()
        if tail and hasattr(self.block_store, "bootstrap"):
            self.block_store.bootstrap(tail)
        kv(
            _log,
            logging.INFO,
            "state restored",
            height=manifest.height,
            app_hash=state.app_hash.hex()[:12],
            tail_blocks=len(tail),
        )
        return state

    def _finish(self, state) -> None:
        self.sync = False
        self.restored_state = state
        if self.on_synced is not None:
            self.on_synced(state)
