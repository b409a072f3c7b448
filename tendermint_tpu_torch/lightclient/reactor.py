"""LightClientReactor: FullCommit serving + subscription on channel 0x68.

Protocol (all frames `uvarint tag || fields`, like the statesync
channel):

* `fc_request(height)` -> `fc_response(height, FullCommit?)` — the
  proof-serving path. `height=0` asks for the chain tip. The serving
  side answers exact-height first (certified cache, then local
  stores), falling back to the newest commit it has at/below the
  request (the provider floor contract `certifiers/provider.py`);
* `fc_subscribe` -> a stream of `fc_announce(FullCommit)` pushes — the
  replica follow stream: every node that commits (or certifies) a new
  height pushes the FullCommit to its subscribers, so replicas serve
  the tip without polling and without joining consensus.

Client-side trust is NEVER the transport's: a pushed/fetched
FullCommit only enters the certified cache after the node's
`BisectingCertifier` proved it. A push that fails certification with a
hard error is a FORGED commit: the peer is scored
(`forged_fullcommit`, instant ban) and any genuinely double-signed
vote inside the forgery becomes `DuplicateVoteEvidence` routed to the
evidence pool (`lightclient/evidence.py`) — the PR 9 attribution
pipeline, applied to the read path.

`PeerProvider` adapts the request/response half to the certifier
`Provider` contract so a walk can fetch candidates from ANY connected
peer — the piece that turns "one full node" into "the fleet".

The port's copy of `tendermint_tpu/lightclient/reactor.py`. Channel
0x68, the JAX reactor's wire; its bookkeeping lock is the ranked
`lightclient.reactor` (86).
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time

from tendermint_tpu_torch.certifiers.certifier import FullCommit
from tendermint_tpu_torch.certifiers.provider import Provider
from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.p2p.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.peer import Peer
from tendermint_tpu_torch.p2p.switch import Reactor
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.types.errors import (
    ErrNoSourceCommit,
    ErrTooMuchChange,
    ErrTrustExpired,
    ErrValidatorsChanged,
    ValidationError,
)
from tendermint_tpu_torch.utils.lockrank import ranked_lock
from tendermint_tpu_torch.utils.log import kv, logger

LIGHTCLIENT_CHANNEL = 0x68

_MSG_FC_REQUEST = 0x01
_MSG_FC_RESPONSE = 0x02
_MSG_FC_SUBSCRIBE = 0x03
_MSG_FC_ANNOUNCE = 0x04

_log = logger("lightclient")


def decode_message(payload: bytes):
    r = Reader(payload)
    tag = r.uvarint()
    if tag == _MSG_FC_REQUEST:
        return ("fc_request", r.uvarint())
    if tag == _MSG_FC_RESPONSE:
        height = r.uvarint()
        raw = r.bytes()
        return ("fc_response", (height, FullCommit.decode(raw) if raw else None))
    if tag == _MSG_FC_SUBSCRIBE:
        return ("fc_subscribe", None)
    if tag == _MSG_FC_ANNOUNCE:
        return ("fc_announce", FullCommit.decode(r.bytes()))
    raise ValueError(f"unknown lightclient message tag {tag:#x}")


def _enc_fc_request(height: int) -> bytes:
    return Writer().uvarint(_MSG_FC_REQUEST).uvarint(height).build()


def _enc_fc_response(height: int, fc: FullCommit | None) -> bytes:
    return (
        Writer()
        .uvarint(_MSG_FC_RESPONSE)
        .uvarint(height)
        .bytes(fc.encode() if fc is not None else b"")
        .build()
    )


def _enc_fc_subscribe() -> bytes:
    return Writer().uvarint(_MSG_FC_SUBSCRIBE).build()


def _enc_fc_announce(fc: FullCommit) -> bytes:
    return Writer().uvarint(_MSG_FC_ANNOUNCE).bytes(fc.encode()).build()


class LightClientReactor(Reactor):
    """Serves FullCommits to light clients; optionally follows pushes.

    Every node runs the serving half. Nodes built with `subscribe=True`
    (replicas, and any client that wants the tip stream) additionally
    subscribe to each peer and certify incoming pushes through
    `certifier` before caching/forwarding them.
    """

    def __init__(
        self,
        chain_id: str = "",
        block_store=None,
        state=None,
        cache=None,
        certifier=None,
        subscribe: bool = False,
        evidence_pool=None,
        verifier=None,
        request_timeout_s: float = 5.0,
    ) -> None:
        super().__init__()
        self.chain_id = chain_id
        self.block_store = block_store
        self.state = state
        self.cache = cache
        self.certifier = certifier
        self.subscribe = subscribe
        self.evidence_pool = evidence_pool
        self.verifier = verifier
        self.request_timeout_s = request_timeout_s
        # leaf lock: held over set/dict surgery only, never across sends
        self._mtx = ranked_lock("lightclient.reactor")
        self._subscribers: set[str] = set()
        # request correlation: height -> list of (event, box) waiters —
        # a LIST so concurrent same-height requests each keep their own
        # slot instead of clobbering a shared one
        self._waits: dict[int, list[tuple[threading.Event, list]]] = {}
        # subscription-liveness clock (health's serving section)
        self._last_push_mono: float | None = None
        self._last_pushed_height = 0
        # pushes certify OFF the p2p recv thread: certification may
        # fetch intermediate bisection commits from peers (PeerProvider
        # request/response), and a recv thread waiting on its own
        # peer's response would deadlock a 1-peer topology
        self._push_q: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        self._push_pending = 0
        self._running = False
        self._push_thread: threading.Thread | None = None

    # -- reactor interface ---------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        # FullCommit frames are commit + valset sized (tens of KB at
        # large valsets); modest queue, below block/statesync priority
        return [
            ChannelDescriptor(LIGHTCLIENT_CHANNEL, priority=2, send_queue_capacity=64)
        ]

    def on_start(self) -> None:
        self._running = True
        if self.subscribe:
            self._push_thread = threading.Thread(
                target=self._push_loop, name="lightclient-push", daemon=True
            )
            self._push_thread.start()

    def on_stop(self) -> None:
        self._running = False
        if self._push_thread is not None:
            self._push_q.put(None)

    def add_peer(self, peer: Peer) -> None:
        if self.subscribe:
            peer.try_send(LIGHTCLIENT_CHANNEL, _enc_fc_subscribe())

    def remove_peer(self, peer: Peer, reason) -> None:
        with self._mtx:
            self._subscribers.discard(peer.id)

    def receive(self, chan_id: int, peer: Peer, payload: bytes) -> None:
        kind, arg = decode_message(payload)
        if kind == "fc_request":
            fc = self.serve_commit(arg)
            if fc is not None:
                _metrics.REPLICA_PROOFS_SERVED.labels(kind="full_commit").inc()
            peer.try_send(LIGHTCLIENT_CHANNEL, _enc_fc_response(arg, fc))
        elif kind == "fc_response":
            height, fc = arg
            with self._mtx:
                waiters = list(self._waits.get(height, ()))
            for ev, box in waiters:
                box.append(fc)
                ev.set()
        elif kind == "fc_subscribe":
            with self._mtx:
                self._subscribers.add(peer.id)
        elif kind == "fc_announce":
            if self.certifier is None or not self._running:
                return  # not following: pushes are noise, not offenses
            with self._mtx:
                if self._push_pending >= 64:
                    return  # push flood: drop, the tip re-announces
                self._push_pending += 1
            self._push_q.put((peer.id, arg))

    # -- serving side --------------------------------------------------------

    def _serve_from_stores(self, height: int) -> FullCommit | None:
        """FullCommit from the local block store + historical valset
        index (the statesync reactor's `_serve_commit` shape)."""
        if self.block_store is None or self.state is None:
            return None
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

    def serve_commit(self, height: int) -> FullCommit | None:
        """Answer one proof request: exact height first (certified
        cache, then stores), else the newest commit at/below it —
        `height=0` means the chain tip."""
        tip = self.block_store.height if self.block_store is not None else 0
        if height <= 0:
            height = max(
                tip, self.cache.latest_height() if self.cache is not None else 0
            )
            if height <= 0:
                return None
        if self.cache is not None:
            fc = self.cache.get_exact(height)
            if fc is not None:
                return fc
        fc = self._serve_from_stores(height)
        if fc is not None:
            return fc
        # floor fallbacks: the tip commit for an ahead-of-us request,
        # else the newest certified commit below the request
        if 0 < tip < height:
            fc = self._serve_from_stores(tip)
            if fc is not None:
                return fc
        if self.cache is not None:
            return self.cache.get_by_height(height)
        return None

    def announce(self, fc: FullCommit) -> None:
        """Push one (locally committed or freshly certified) FullCommit
        to every subscriber. Monotonic: never re-push old heights, so a
        forwarding replica cannot loop with its upstream."""
        with self._mtx:
            if fc.height() <= self._last_pushed_height:
                return
            self._last_pushed_height = fc.height()
            subs = set(self._subscribers)
        if not subs:
            return
        frame = _enc_fc_announce(fc)
        for p in self.switch.peers() if self.switch is not None else []:
            if p.id in subs:
                p.try_send(LIGHTCLIENT_CHANNEL, frame)

    def announce_height(self, height: int) -> None:
        """Serving-node hook (wired to EVENT_NEW_BLOCK in node.py):
        build + push the FullCommit for a height this node just
        committed. Cheap when nobody subscribed."""
        with self._mtx:
            has_subs = bool(self._subscribers)
        if not has_subs:
            return
        fc = self._serve_from_stores(height)
        if fc is not None:
            self.announce(fc)

    # -- subscribing side ----------------------------------------------------

    def _push_loop(self) -> None:
        while True:
            item = self._push_q.get()
            if item is None or not self._running:
                return
            with self._mtx:
                self._push_pending -= 1
            peer_id, fc = item
            try:
                self._on_push(peer_id, fc)
            except Exception:
                # one bad push must not kill the follow stream
                logging.getLogger(__name__).exception(
                    "fullcommit push handling failed"
                )

    def _on_push(self, peer_id: str, fc: FullCommit) -> None:
        if self.certifier is None:
            return
        cached = (
            self.cache.get_exact(fc.height()) if self.cache is not None else None
        )
        if cached is not None:
            if cached.header.hash() == fc.header.hash():
                return  # already proven (duplicate push)
            # a DIFFERENT commit at a height we already certified is a
            # fork attempt by construction — attribution, not dedup
            # (this is what catches even a fully-signed forged header)
            self._handle_forged(
                peer_id,
                fc,
                ValidationError(
                    f"conflicts with certified commit at height {fc.height()}"
                ),
            )
            return
        try:
            self.certifier.certify(fc)
        except (ErrTooMuchChange, ErrValidatorsChanged):
            # can't bridge to this height YET (e.g. still fast-syncing
            # through a valset rotation) — drop, a later push will land
            return
        except (ErrTrustExpired, ErrNoSourceCommit) as e:
            # CLIENT-side failure (stale local pin, bisection fetch
            # timed out mid-walk) — the pushing peer did nothing wrong;
            # scoring it here would ban honest peers and can partition
            # a replica fleet
            kv(
                _log,
                logging.DEBUG,
                "fullcommit push dropped (environmental)",
                height=fc.height(),
                from_peer=peer_id[:12],
                error=str(e)[:80],
            )
            return
        except ValidationError as e:
            self._handle_forged(peer_id, fc, e)
            return
        with self._mtx:
            self._last_push_mono = time.monotonic()
        if self.cache is not None:
            self.cache.put_certified(fc)
        kv(
            _log,
            logging.DEBUG,
            "fullcommit certified",
            height=fc.height(),
            from_peer=peer_id[:12],
        )
        # fan the proven tip onward to OUR subscribers (replica chains)
        self.announce(fc)

    def _handle_forged(self, peer_id: str, fc: FullCommit, err: Exception) -> None:
        """The attribution half: score the serving peer AND extract any
        genuinely double-signed votes into committed evidence."""
        _metrics.LIGHTCLIENT_BISECTIONS.labels(result="forged").inc()
        kv(
            _log,
            logging.WARNING,
            "forged fullcommit",
            height=fc.height(),
            from_peer=peer_id[:12],
            error=str(err)[:80],
        )
        if self.switch is not None:
            self.switch.report_misbehavior(
                peer_id, "forged_fullcommit", detail=str(err)
            )
        if self.evidence_pool is None:
            return
        honest = self.serve_commit(fc.height())
        if honest is None or honest.height() != fc.height():
            return
        from tendermint_tpu_torch.lightclient.evidence import (
            extract_double_sign_evidence,
        )

        try:
            evs = extract_double_sign_evidence(
                fc, honest, self.chain_id, verifier=self.verifier
            )
        except Exception:
            logging.getLogger(__name__).exception("evidence extraction failed")
            return
        for ev in evs:
            try:
                self.evidence_pool.add_evidence(ev, val_set=honest.validators)
            except ValidationError:
                continue  # unprovable under this valset: drop

    # -- request/response client (PeerProvider's transport) ------------------

    def request_commit(self, height: int) -> FullCommit | None:
        """Fetch one FullCommit from any connected peer (each peer gets
        one `request_timeout_s` shot, like the statesync commit fetch)."""
        if self.switch is None:
            return None
        ev = threading.Event()
        box: list = []
        waiter = (ev, box)
        with self._mtx:
            self._waits.setdefault(height, []).append(waiter)
        try:
            for peer in self.switch.peers():
                ev.clear()
                peer.try_send(LIGHTCLIENT_CHANNEL, _enc_fc_request(height))
                if ev.wait(self.request_timeout_s) and box and box[-1] is not None:
                    return box[-1]
            return None
        finally:
            with self._mtx:
                waiters = self._waits.get(height)
                if waiters is not None:
                    try:
                        waiters.remove(waiter)
                    except ValueError:
                        pass
                    if not waiters:
                        self._waits.pop(height, None)

    # -- health --------------------------------------------------------------

    def serving_stats(self) -> dict:
        """The `/health` serving section's raw material (reported, not
        folded — docs/OBSERVABILITY.md "Health & SLO" conventions)."""
        with self._mtx:
            subs = len(self._subscribers)
            last_push = self._last_push_mono
        tip = self.block_store.height if self.block_store is not None else 0
        certified = self.cache.latest_height() if self.cache is not None else 0
        out = {
            "subscribers": subs,
            "subscribed": self.subscribe,
            "chain_tip": tip,
            "certified_tip": certified,
            # proof-serving lag: heights the chain is ahead of what this
            # node can prove to a light client
            "serving_lag": max(0, tip - certified) if certified else None,
            "last_push_age_s": (
                round(time.monotonic() - last_push, 3)
                if last_push is not None
                else None
            ),
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out


class PeerProvider(Provider):
    """Certifier `Provider` over the 0x68 request/response channel —
    candidates come from ANY connected peer/replica, not one full node.
    `store_commit` is a no-op (persistence belongs to the certified
    cache in front of this)."""

    def __init__(self, reactor: LightClientReactor) -> None:
        self._reactor = reactor

    def store_commit(self, fc: FullCommit) -> None:  # noqa: B027
        pass

    def get_by_height(self, height: int) -> FullCommit | None:
        fc = self._reactor.request_commit(height)
        if fc is not None and fc.height() <= height:
            return fc
        return None

    def latest_commit(self) -> FullCommit | None:
        return self._reactor.request_commit(0)
