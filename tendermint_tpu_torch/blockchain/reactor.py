"""Fast-sync reactor: catch a fresh node up by downloading + batch-
verifying blocks (reference `blockchain/reactor.go`, channel 0x40).

Batch-first twist on the reference's serial verify loop
(`reactor.go:242-289`, one `VerifyCommit` per block): the sync loop
gathers a WINDOW of consecutive downloaded blocks and verifies all
their commits in ONE device batch via
`ValidatorSet.verify_commit_batched` (the valset-table kernel path —
BASELINE config 3's 50k-blocks-at-1000-validators shape), then applies
them with the per-block signature pass skipped.

Trust rule per reference: block H is applied only once +2/3 of the
current validators are seen precommitting it — H's commit travels as
block H+1's LastCommit, so the window always holds one more block than
it applies.

The port's copy of `tendermint_tpu/blockchain/reactor.py`. The window
verify is the port's `ValidatorSet.verify_commit_batched_async` on the
port's `DispatchQueue(name="fastsync")`: with `verifier=None` that is
the port's `default_verifier()`, the card's stack, where a window of 16
commits of one set is one `madd_chain_fused` launch and one finish;
`adaptive_pipeline_depth` reads the port's dispatch telemetry.
"""

from __future__ import annotations

import os
import threading
import time

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.peer import Peer
from tendermint_tpu_torch.p2p.switch import Reactor
from tendermint_tpu_torch.blockchain.pool import BlockPool
from tendermint_tpu_torch.state.execution import apply_block
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.utils.log import kv, logger
import logging

BLOCKCHAIN_CHANNEL = 0x40

_MSG_BLOCK_REQUEST = 0x01
_MSG_BLOCK_RESPONSE = 0x02
_MSG_NO_BLOCK = 0x03
_MSG_STATUS_REQUEST = 0x04
_MSG_STATUS_RESPONSE = 0x05

_SYNC_TICK_S = 0.01
_STATUS_INTERVAL_S = 2.0  # reference statusUpdateIntervalSeconds=10, scaled
VERIFY_WINDOW = 16  # commits batched per device call

# Verify windows kept in flight on device at once (docs/PERFORMANCE.md).
# 2 is the classic software pipeline: window K's verdict flies while the
# host preps K+1's part sets/lanes and applies K-1's blocks via ABCI.
# 1 degenerates to the synchronous verify->apply loop (the bench
# baseline); >2 only helps when launches are slower than applies.
PIPELINE_DEPTH = int(os.environ.get("TENDERMINT_TPU_PIPELINE_DEPTH", "2"))


def adaptive_pipeline_depth() -> int:
    """Default pipeline depth from the measured launch:apply ratio.

    The env knob always wins. Without it, the dispatch telemetry's
    overlap histogram (what the fastsync queue already exports) gives
    launch:apply ≈ (1-o)/o; `1 + round(ratio)` windows keep the device
    busy while one window applies — balanced pipelines land on the
    classic depth 2, launch-dominated ones deepen, apply-dominated ones
    collapse to the synchronous loop. Clamped to [1, 4]: beyond 4 the
    extra in-flight windows only add redo-drain latency.
    """
    env = os.environ.get("TENDERMINT_TPU_PIPELINE_DEPTH")
    if env:
        return max(1, int(env))
    from tendermint_tpu_torch.services.dispatch import measured_launch_apply_ratio

    ratio = measured_launch_apply_ratio("fastsync")
    if ratio is None:
        return 2
    return max(1, min(4, 1 + int(round(ratio))))


def _enc(tag: int, *fields) -> bytes:
    w = Writer().uvarint(tag)
    for f in fields:
        if isinstance(f, int):
            w.uvarint(f)
        else:
            w.bytes(f)
    return w.build()


def decode_message(payload: bytes):
    r = Reader(payload)
    tag = r.uvarint()
    if tag == _MSG_BLOCK_REQUEST:
        return ("block_request", r.uvarint())
    if tag == _MSG_BLOCK_RESPONSE:
        return ("block_response", Block.decode(r.bytes()))
    if tag == _MSG_NO_BLOCK:
        return ("no_block", r.uvarint())
    if tag == _MSG_STATUS_REQUEST:
        return ("status_request", None)
    if tag == _MSG_STATUS_RESPONSE:
        return ("status_response", r.uvarint())
    raise ValueError(f"unknown blockchain message tag {tag:#x}")


class BlockchainReactor(Reactor):
    """Serves stored blocks to peers; optionally fast-syncs from them.

    `on_caught_up(state)` fires once when the pool has drained to every
    peer's advertised height — the node uses it to start consensus
    (reference `SwitchToConsensus reactor.go:233-241`).
    """

    def __init__(
        self,
        state,
        store,
        app_conn,
        fast_sync: bool = False,
        on_caught_up=None,
        verifier=None,
        tx_indexer=None,
        hasher=None,
        deferred: bool = False,
        pipeline_depth: int | None = None,
        follow: bool = False,
    ) -> None:
        super().__init__()
        self.state = state
        self.store = store
        self.app_conn = app_conn
        self.fast_sync = fast_sync
        self.on_caught_up = on_caught_up
        # follow mode (read replicas): never exit fast-sync — keep
        # tailing the chain as peers advance instead of handing off to
        # consensus. `is_caught_up` then just means "at the tip".
        self.follow = follow
        self.verifier = verifier
        self.tx_indexer = tx_indexer
        self.hasher = hasher
        # `deferred` parks the sync thread until state sync restores a
        # snapshot and calls begin_fast_sync() — the pool's start height
        # is unknowable before the restore lands
        self.deferred = deferred
        self.pool = BlockPool(start_height=store.height + 1)
        self.pipeline_depth = max(
            1,
            adaptive_pipeline_depth() if pipeline_depth is None else pipeline_depth,
        )
        self._dispatch_queue = None  # lazy: only fast-syncing nodes need it
        self._running = False
        self._thread: threading.Thread | None = None
        self.blocks_synced = 0
        self._progress_mark = time.monotonic()

    # -- reactor interface -------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(BLOCKCHAIN_CHANNEL, priority=5)]

    def on_start(self) -> None:
        self._running = True
        if self.fast_sync and not self.deferred:
            self._start_sync_thread()

    def _start_sync_thread(self) -> None:
        self._thread = threading.Thread(
            target=self._sync_routine, name="fastsync", daemon=True
        )
        self._thread.start()

    def begin_fast_sync(self, state=None) -> None:
        """State-sync handoff: adopt the restored state, re-aim the pool
        at the (snapshot-height advanced) store head, and start syncing
        the tail. The node calls this from the statesync reactor's
        `on_synced` (with state=None when state sync gave up and plain
        fast-sync from the current state proceeds)."""
        if not self.deferred:
            return
        self.deferred = False
        if state is not None:
            self.state = state
        self.pool = BlockPool(start_height=self.store.height + 1)
        # re-learn peer heights on the fresh pool (status responses that
        # arrived during state sync went to the old one)
        if self.switch is not None:
            self.switch.broadcast(BLOCKCHAIN_CHANNEL, _enc(_MSG_STATUS_REQUEST))
        if self._running and self.fast_sync:
            self._start_sync_thread()

    def on_stop(self) -> None:
        self._running = False
        if self._dispatch_queue is not None:
            self._dispatch_queue.close()

    def add_peer(self, peer: Peer) -> None:
        # advertise our height + learn theirs (reference `AddPeer`)
        peer.try_send(
            BLOCKCHAIN_CHANNEL, _enc(_MSG_STATUS_RESPONSE, self.store.height)
        )
        peer.try_send(BLOCKCHAIN_CHANNEL, _enc(_MSG_STATUS_REQUEST))

    def remove_peer(self, peer: Peer, reason) -> None:
        self.pool.remove_peer(peer.id)

    def receive(self, chan_id: int, peer: Peer, payload: bytes) -> None:
        kind, arg = decode_message(payload)
        if kind == "block_request":
            block = self.store.load_block(arg)
            if block is not None:
                peer.try_send(
                    BLOCKCHAIN_CHANNEL, _enc(_MSG_BLOCK_RESPONSE, block.encode())
                )
            else:
                peer.try_send(BLOCKCHAIN_CHANNEL, _enc(_MSG_NO_BLOCK, arg))
        elif kind == "block_response":
            self.pool.add_block(peer.id, arg, size=len(payload))
        elif kind == "status_request":
            peer.try_send(
                BLOCKCHAIN_CHANNEL, _enc(_MSG_STATUS_RESPONSE, self.store.height)
            )
        elif kind == "status_response":
            self.pool.set_peer_height(peer.id, arg)
        # no_block: ignore (the request will time out and reassign)

    # -- sync loop ---------------------------------------------------------

    def _send_request(self, peer_id: str, height: int) -> None:
        for p in self.switch.peers() if self.switch else []:
            if p.id == peer_id:
                p.try_send(BLOCKCHAIN_CHANNEL, _enc(_MSG_BLOCK_REQUEST, height))
                return

    def _sync_routine(self) -> None:
        last_status = 0.0
        while self._running and self.fast_sync:
            now = time.monotonic()
            if now - last_status > _STATUS_INTERVAL_S:
                last_status = now
                if self.switch is not None:
                    self.switch.broadcast(
                        BLOCKCHAIN_CHANNEL, _enc(_MSG_STATUS_REQUEST)
                    )
            requests, evictions = self.pool.schedule_requests(now)
            for peer_id in evictions:
                self._drop_peer(peer_id, "fast-sync request timeout")
            for peer_id, height in requests:
                self._send_request(peer_id, height)
            try:
                self._try_sync()
            except Exception:
                # _try_sync handles bad blocks via redo; anything else
                # (e.g. app execution failure) must not kill the sync
                # thread silently — log and keep going
                import logging

                logging.getLogger(__name__).exception("fast-sync step failed")
                time.sleep(0.5)
            if not self.follow and self.pool.is_caught_up():
                self.fast_sync = False
                if self.on_caught_up is not None:
                    self.on_caught_up(self.state)
                return
            time.sleep(_SYNC_TICK_S)

    def tip_lag(self) -> int:
        """Heights between the best-known peer tip and our store head
        (0 at the tip). Follow-mode replicas stay in fast-sync forever,
        so health derives their readiness from this instead of the
        `fast_sync` flag."""
        return max(0, self.pool.max_peer_height() - self.store.height)

    def _queue(self):
        """The reactor-owned dispatch queue (one per fast-syncing node,
        so another consumer's unjoined handles can't backpressure us)."""
        if self._dispatch_queue is None:
            from tendermint_tpu_torch.services.dispatch import DispatchQueue

            self._dispatch_queue = DispatchQueue(
                depth=self.pipeline_depth, name="fastsync"
            )
        return self._dispatch_queue

    def _try_sync(self) -> None:
        """Verify + apply as many downloaded blocks as possible, commits
        batched per device call (reference `trySync` loop `:242-289`) —
        run as a SOFTWARE PIPELINE over the async dispatch layer: while
        window K's commit verdict is in flight on device, the host preps
        window K+1's part sets/lanes and applies window K-1's blocks
        through ABCI. Windows join strictly in submission order; any
        redo / valset change / verdict failure drains the in-flight
        suffix WITHOUT applying its blocks (they chain off the fault).
        """
        from collections import deque

        pipeline: "deque" = deque()  # submitted windows, oldest first
        try:
            while True:
                cursor = (
                    pipeline[-1]["next_height"]
                    if pipeline
                    else self.pool.height
                )
                entry = None
                if len(pipeline) < self.pipeline_depth:
                    entry = self._prep_window(cursor)
                if isinstance(entry, dict):
                    pipeline.append(entry)
                    continue  # keep filling until depth / no window
                if entry == "redo":
                    # linkage broke at `cursor`'s window: its suffix is
                    # already dropped from the pool, but the OLDER
                    # windows in flight verified under intact linkage —
                    # apply them before leaving
                    self._drain(pipeline, apply=True)
                    return
                if pipeline:
                    # depth reached, or no next window yet: join the
                    # oldest verdict and run its ABCI applies — this is
                    # the overlap stage, younger windows are in flight
                    if not self._join_and_apply(pipeline.popleft()):
                        self._drain(pipeline, apply=False)
                        return
                    continue
                if entry == "boundary":
                    # valset changed at the very next block: verify it
                    # alone via its successor's commit the slow way
                    # (pipeline is empty here, so the valset is current)
                    window = self.pool.peek(2)
                    if len(window) < 2:
                        return
                    self._sync_one(window[0], window[1])
                    continue
                return  # nothing downloaded, nothing in flight
        except BaseException:
            # non-verification failure (app execution, dispatch layer):
            # release the in-flight windows' queue slots, then let the
            # sync routine's catch-all log and retry
            self._drain(pipeline, apply=False)
            raise

    def _prep_window(self, cursor: int):
        """Host-prep stage: claim up to VERIFY_WINDOW applyable blocks
        at `cursor`, build part sets + block ids, check commit linkage,
        and submit ONE batched commit verify to the dispatch queue.

        Returns the in-flight window entry, None (no full window there
        yet), "boundary" (valset changes at `cursor` — needs a drained
        pipeline + `_sync_one`), or "redo" (linkage mismatch; the pool
        suffix is already dropped)."""
        window = self.pool.peek(VERIFY_WINDOW + 1, from_height=cursor)
        if len(window) < 2:
            return None
        # the batch spans consecutive blocks under ONE valset — windows
        # beyond an EndBlock valset rotation never enter the pipeline,
        # their headers carry a different validators_hash
        val_hash = self.state.validators.hash()
        usable = 0
        for b in window:
            if b.header.validators_hash != val_hash:
                break
            usable += 1
        if usable < 2:
            return "boundary"
        blocks = window[:usable]
        # commit for blocks[i] rides in blocks[i+1].last_commit; the
        # final block waits for its successor in a later window, so
        # only the applied prefix needs part sets / ids built
        apply_n = usable - 1
        parts = [b.make_part_set() for b in blocks[:apply_n]]
        block_ids = [
            BlockID(b.hash(), ps.header)
            for b, ps in zip(blocks[:apply_n], parts)
        ]
        entries = []
        for i in range(apply_n):
            commit = blocks[i + 1].last_commit
            if commit.block_id != block_ids[i]:
                self._redo(blocks[i].header.height)
                return "redo"
            entries.append((block_ids[i], blocks[i].header.height, commit))
        try:
            handle = self.state.validators.verify_commit_batched_async(
                self.state.chain_id,
                entries,
                verifier=self.verifier,
                queue=self._queue(),
                consumer="fastsync",
            )
        except ValidationError:
            # malformed commit caught during prep — same treatment as a
            # failed verdict on this window
            self._redo(blocks[0].header.height)
            return "redo"
        return {
            "blocks": blocks,
            "parts": parts,
            "handle": handle,
            "apply_n": apply_n,
            "start_height": blocks[0].header.height,
            "next_height": blocks[0].header.height + apply_n,
        }

    def _join_and_apply(self, entry) -> bool:
        """Join one window's in-flight verdict, then store + apply its
        blocks. False means the window failed and the pool suffix was
        redone — the caller must discard younger in-flight windows."""
        try:
            entry["handle"].result()
        except ValidationError:
            self._redo(entry["start_height"])
            return False
        blocks, parts = entry["blocks"], entry["parts"]
        for i in range(entry["apply_n"]):
            commit = blocks[i + 1].last_commit
            try:
                self.store.save_block(blocks[i], parts[i], commit)
                apply_block(
                    self.state,
                    blocks[i],
                    parts[i].header,
                    self.app_conn,
                    verifier=self.verifier,
                    tx_indexer=self.tx_indexer,
                    commit_preverified=True,
                    hasher=self.hasher,
                )
            except ValidationError:
                # commit verified but the block body is inconsistent
                # (possible only past a 2/3-byzantine signer set):
                # drop the suffix + serving peer rather than spin
                self._redo(blocks[i].header.height)
                return False
            self.pool.pop()
            self.blocks_synced += 1
            self._log_progress()
        return True

    def _drain(self, pipeline, apply: bool) -> None:
        """Empty the pipeline in submission order. While `apply` holds
        and windows keep verifying, their blocks go through ABCI; after
        the first failure (or when draining a stale suffix) remaining
        verdicts are joined ONLY to release their dispatch-queue slots —
        stale blocks are never applied."""
        while pipeline:
            entry = pipeline.popleft()
            if apply:
                apply = self._join_and_apply(entry)
            else:
                try:
                    entry["handle"].result()
                # tmlint: disable=T001 -- stale-suffix drain: joined only to release the dispatch slot, the failure was already handled upstream
                except Exception:
                    pass

    def _log_progress(self) -> None:
        """blocks/s every 100 blocks (reference `reactor.go:281-286`)."""
        if self.blocks_synced % 100 != 0:
            return
        now = time.monotonic()
        rate = 100.0 / max(now - self._progress_mark, 1e-9)
        self._progress_mark = now
        kv(
            logger("blockchain"),
            logging.INFO,
            "fast-sync progress",
            height=self.pool.height - 1,
            blocks_per_s=round(rate, 1),
        )

    def _sync_one(self, block, successor) -> None:
        if successor is None:
            return
        parts = block.make_part_set()
        block_id = BlockID(block.hash(), parts.header)
        commit = successor.last_commit
        if commit.block_id != block_id:
            self._redo(block.header.height)
            return
        try:
            self.state.validators.verify_commit(
                self.state.chain_id,
                block_id,
                block.header.height,
                commit,
                verifier=self.verifier,
                consumer="fastsync",
            )
        except ValidationError:
            self._redo(block.header.height)
            return
        try:
            self.store.save_block(block, parts, commit)
            apply_block(
                self.state,
                block,
                parts.header,
                self.app_conn,
                verifier=self.verifier,
                tx_indexer=self.tx_indexer,
                commit_preverified=True,
                hasher=self.hasher,
            )
        except ValidationError:
            self._redo(block.header.height)
            return
        self.pool.pop()
        self.blocks_synced += 1

    def _redo(self, height: int) -> None:
        """Bad block/commit: drop the chain suffix and the peer that
        served it (reference `RedoRequest` + peer eviction). A block
        whose commit fails verification cannot be produced honestly —
        debit the server's misbehavior score so a lying fast-sync peer
        gets banned, not just disconnected-and-redialed."""
        bad_peer = self.pool.redo(height)
        if bad_peer:
            if self.switch is not None:
                self.switch.report_misbehavior(
                    bad_peer, "forged_block", detail=f"height {height}"
                )
            self._drop_peer(bad_peer, "bad fast-sync block")

    def _drop_peer(self, peer_id: str, reason: str) -> None:
        self.pool.remove_peer(peer_id)
        if self.switch is not None:
            for p in self.switch.peers():
                if p.id == peer_id:
                    self.switch.stop_peer_for_error(p, reason)
                    return
