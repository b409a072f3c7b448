"""Gossip observatory: per-peer/channel/kind traffic + redundancy rollups.

An observatory pointed at the gossip network, which the finality,
contention, device and tracing observatories do not measure.
`p2p/connection.py` counts only aggregate frame bytes, and every
duplicate vote/part/tx/evidence dedups silently — at large committee
scales, that invisible over-gossip is exactly what dominates.

The pattern the other observatories follow:

* **Instrument at existing seams.** One `GossipRollup` per node lives
  on its Switch; the MConnection send/recv loops call `record()` where
  frames already pass (the `on_traffic` hook `Peer` wires with the
  remote id), the consensus state's duplicate-add branches and the
  mempool/evidence dedup sites call `redundant()`, and successful
  vote/part adds call `first_seen()`. Accounting observes frames; it
  NEVER touches them — the wire format stays byte-identical (golden
  test in tests/test_gossiplog.py).
* **Dump-only cardinality.** Exported series are bounded by
  construction: `channel` and `kind` come from the fixed vocabularies
  in telemetry/metrics.py (GOSSIP_CHANNELS / GOSSIP_KINDS), never peer
  ids or heights. Per-peer tables and first-seen stamps are served
  ONLY through `dump_telemetry?gossip=1` (telemetry/views.py).
* **A report tool names the top waste source.** `tools/gossip_report.py`
  merges N nodes' dumps into the per-channel bandwidth waterfall, the
  per-kind redundancy ranking, and the region-to-region propagation
  matrix, ending in a fix-first verdict.

Bounded tables (a byzantine peer cannot grow memory): at most
`MAX_PEERS` per-peer rows (overflow folds into a synthetic "~overflow"
row), first-seen stamps for the newest `MAX_FIRST_HEIGHTS` heights with
a per-height entry cap. Locking mirrors `heightlog.VoteArrivalRollup`:
one plain leaf mutex, held only over dict surgery, never across
callbacks.

Knob: `TENDERMINT_TPU_GOSSIPLOG=0` disables the rollup at construction
(the sampled-out configuration — the bench's off half and the interop
test's plain node). Disabled means the p2p loops get no hook at all:
zero per-frame overhead, not an early return.

The port's copy of `tendermint_tpu/telemetry/gossiplog.py`, over the
port's metric catalog; the same classification tables, bounds and knob.
"""

from __future__ import annotations

import os
import threading
import time

from tendermint_tpu_torch.telemetry import metrics as _metrics

# -- classification -----------------------------------------------------------
#
# Channel ids and first-byte message tags are the stable constants of
# every reactor's wire vocabulary (consensus/mempool/evidence/
# blockchain/statesync/lightclient/pex). They are mirrored here as ONE
# static table so classification is bounded by construction and needs
# no import-order handshake with the reactors;
# tests/test_gossiplog.py::test_kind_table_matches_reactors cross-checks
# this table against the reactor modules' own constants, so drift fails
# tier-1 instead of silently classifying as "other".

CHANNEL_NAMES: dict[int, str] = {
    0x00: "pex",
    0x20: "cns_state",
    0x21: "cns_data",
    0x22: "cns_vote",
    0x23: "cns_votebits",
    0x30: "mempool",
    0x38: "evidence",
    0x40: "blockchain",
    0x60: "statesync",
    0x68: "lightclient",
    0xFF: "ctrl",
}

KIND_TAGS: dict[int, dict[int, str]] = {
    0x00: {0x01: "pex_request", 0x02: "pex_addrs"},
    0x20: {
        0x01: "new_round_step",
        0x02: "commit_step",
        0x07: "has_vote",
        0x08: "vote_set_maj23",
        0x20: "proposal_heartbeat",
    },
    0x21: {0x03: "proposal", 0x04: "proposal_pol", 0x05: "block_part"},
    0x22: {0x06: "vote"},
    0x23: {0x09: "vote_set_bits"},
    0x30: {0x01: "tx"},
    0x38: {0x01: "evidence_list"},
    0x40: {
        0x01: "block_request",
        0x02: "block_response",
        0x03: "no_block",
        0x04: "status_request",
        0x05: "status_response",
    },
    0x60: {
        0x01: "snapshots_request",
        0x02: "snapshots_response",
        0x03: "chunk_request",
        0x04: "chunk_response",
        0x05: "no_chunk",
        0x06: "commit_request",
        0x07: "commit_response",
    },
    0x68: {
        0x01: "fc_request",
        0x02: "fc_response",
        0x03: "fc_subscribe",
        0x04: "fc_announce",
    },
    0xFF: {0x01: "ping", 0x02: "pong"},
}


def channel_name(chan_id: int) -> str:
    return CHANNEL_NAMES.get(chan_id, "other")


def classify(chan_id: int, payload: bytes) -> str:
    """Message kind from the payload's leading uvarint tag (every
    reactor tag is a single byte < 0x80, so byte 0 IS the tag).
    Unknown channel or tag -> "other" — the labels stay bounded no
    matter what a peer sends."""
    if not payload:
        return "other"
    return KIND_TAGS.get(chan_id, {}).get(payload[0], "other")


def enabled_from_env() -> bool:
    return os.environ.get("TENDERMINT_TPU_GOSSIPLOG", "1") != "0"


# -- the rollup ---------------------------------------------------------------


class GossipRollup:
    """One node's gossip accounting: bounded per-peer traffic tables,
    per-kind redundancy counters, and first-seen propagation stamps.

    Thread-safe the VoteArrivalRollup way: one plain leaf lock over
    dict surgery only. Metric increments happen outside the lock (the
    registry counters carry their own synchronization)."""

    MAX_PEERS = 64
    # first-seen retention: the propagation map only needs the recent
    # window (cross-node merges subtract wall clocks per key), and a
    # byzantine height/round/index flood must not grow memory
    MAX_FIRST_HEIGHTS = 8
    MAX_FIRST_PER_HEIGHT = 2048
    _OVERFLOW = "~overflow"

    def __init__(self, enabled: bool | None = None) -> None:
        self.enabled = enabled_from_env() if enabled is None else bool(enabled)
        self._lock = threading.Lock()
        # peer_id -> {(channel, kind, dir): [msgs, bytes]}
        self._traffic: dict[str, dict[tuple, list]] = {}
        # kind -> [msgs, bytes]
        self._red: dict[str, list] = {}
        # height -> {(kind, round, index): wall-clock first-seen}
        self._first: dict[int, dict[tuple, float]] = {}

    # -- traffic (MConnection send/recv loops via Peer's on_traffic) -------

    def record(
        self, peer_id: str, direction: str, chan_id: int, payload: bytes,
        frame_len: int,
    ) -> None:
        if not self.enabled:
            return
        channel = channel_name(chan_id)
        kind = classify(chan_id, payload)
        _metrics.P2P_CHANNEL_BYTES.labels(channel=channel, dir=direction).inc(
            frame_len
        )
        _metrics.GOSSIP_MSGS.labels(kind=kind, dir=direction).inc()
        key = (channel, kind, direction)
        with self._lock:
            row = self._traffic.get(peer_id)
            if row is None:
                if len(self._traffic) >= self.MAX_PEERS:
                    peer_id = self._OVERFLOW
                    row = self._traffic.get(peer_id)
                if row is None:
                    row = self._traffic[peer_id] = {}
            st = row.get(key)
            if st is None:
                st = row[key] = [0, 0]
            st[0] += 1
            st[1] += frame_len

    # -- redundancy (the silent dedup sites) --------------------------------

    def redundant(self, kind: str, nbytes: int) -> None:
        """One duplicate delivery of `kind` that dedup'd silently before
        this observatory existed: a VoteSet exact-duplicate add, a
        PartSet already-have part, a mempool dup-cache hit on gossip
        re-arrival, an evidence-pool re-offer."""
        if not self.enabled:
            return
        _metrics.GOSSIP_REDUNDANT.labels(kind=kind).inc()
        _metrics.GOSSIP_REDUNDANT_BYTES.labels(kind=kind).inc(max(0, nbytes))
        with self._lock:
            st = self._red.get(kind)
            if st is None:
                st = self._red[kind] = [0, 0]
            st[0] += 1
            st[1] += max(0, nbytes)

    # -- propagation stamps (consensus add sites) ---------------------------

    def first_seen(
        self, kind: str, height: int, round_: int, index: int
    ) -> None:
        """Wall-clock stamp of the FIRST delivery of (kind, height,
        round, index) on this node; repeats are no-ops so the earliest
        stamp wins. `tools/gossip_report.py` subtracts these across
        nodes into the region-to-region propagation matrix."""
        if not self.enabled:
            return
        now = time.time()
        key = (kind, round_, index)
        with self._lock:
            per_h = self._first.get(height)
            if per_h is None:
                if len(self._first) >= self.MAX_FIRST_HEIGHTS:
                    oldest = min(self._first)
                    if height < oldest:
                        return  # older than the whole window: drop
                    del self._first[oldest]
                per_h = self._first[height] = {}
            if key in per_h or len(per_h) >= self.MAX_FIRST_PER_HEIGHT:
                return
            per_h[key] = now

    # -- read side ----------------------------------------------------------

    def snapshot(self) -> dict:
        """The dump view (`dump_telemetry?gossip=1`): per-peer tables
        (dump-only cardinality), the channel/kind aggregates derived
        from them, redundancy counters, and the first-seen stamps keyed
        "kind/height/round/index"."""
        with self._lock:
            traffic = {
                pid: {f"{c}/{k}/{d}": list(st) for (c, k, d), st in row.items()}
                for pid, row in self._traffic.items()
            }
            red = {k: {"msgs": st[0], "bytes": st[1]} for k, st in self._red.items()}
            first = {
                f"{k}/{h}/{r}/{i}": t
                for h, per_h in self._first.items()
                for (k, r, i), t in per_h.items()
            }
            chans: dict[str, dict] = {}
            kinds: dict[str, dict] = {}
            for row in self._traffic.values():
                for (c, k, d), st in row.items():
                    ch = chans.setdefault(
                        c,
                        {"send_msgs": 0, "send_bytes": 0,
                         "recv_msgs": 0, "recv_bytes": 0},
                    )
                    ch[f"{d}_msgs"] += st[0]
                    ch[f"{d}_bytes"] += st[1]
                    kd = kinds.setdefault(
                        k,
                        {"send_msgs": 0, "send_bytes": 0,
                         "recv_msgs": 0, "recv_bytes": 0},
                    )
                    kd[f"{d}_msgs"] += st[0]
                    kd[f"{d}_bytes"] += st[1]
        return {
            "enabled": self.enabled,
            "peers": traffic,
            "channels": chans,
            "kinds": kinds,
            "redundant": red,
            "first_seen": first,
        }

    def headline(self) -> dict:
        """The two numbers `GET /health`'s gossip section reports (top
        redundant kind, hottest channel by total bytes) — cheap enough
        for a health probe, reported-never-folded like the SLO."""
        with self._lock:
            top_red = max(
                self._red.items(), key=lambda kv: kv[1][0], default=None
            )
            chan_bytes: dict[str, int] = {}
            for row in self._traffic.values():
                for (c, _k, _d), st in row.items():
                    chan_bytes[c] = chan_bytes.get(c, 0) + st[1]
            hot = max(chan_bytes.items(), key=lambda kv: kv[1], default=None)
        out: dict = {"enabled": self.enabled}
        if top_red is not None:
            out["top_redundant_kind"] = top_red[0]
            out["top_redundant_msgs"] = top_red[1][0]
            out["top_redundant_bytes"] = top_red[1][1]
        if hot is not None:
            out["hottest_channel"] = hot[0]
            out["hottest_channel_bytes"] = hot[1]
        return out

    # -- derived ------------------------------------------------------------

    def redundancy_factors(self) -> dict[str, float]:
        """delivered / useful per redundant kind: recv msgs of the kind
        divided by (recv - redundant). 1.0 = no waste; N = the net
        shipped every message N times. Kinds with no recv traffic fall
        back to counting redundant deliveries on top of the dedup'd
        adds themselves."""
        snap = self.snapshot()
        out: dict[str, float] = {}
        kind_of = {"vote": "vote", "block_part": "block_part",
                   "tx": "tx", "evidence": "evidence_list"}
        for kind, red in snap["redundant"].items():
            wire = snap["kinds"].get(kind_of.get(kind, kind), {})
            recv = wire.get("recv_msgs", 0)
            useful = recv - red["msgs"]
            if useful > 0:
                out[kind] = round(recv / useful, 3)
            elif red["msgs"]:
                out[kind] = float(red["msgs"] + 1)
        return out
