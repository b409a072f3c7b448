"""Consensus write-ahead log (reference `consensus/wal.go`).

Every consensus input (peer/internal message, timeout) is persisted
*before* processing (`consensus/state.go:519-528`), so a crash at any
point replays deterministically. Records are CRC32-framed:

    [crc32 u32 BE][length u32 BE][type u8][payload]

`#ENDHEIGHT` markers delimit completed heights; on restart, replay
starts after the last marker (`SearchForEndHeight :122`). `light` mode
skips persisting peer block-parts (reference `wal.go:97-104`).
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Iterator

from tendermint_tpu_torch.codec import Reader, Writer
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.types.part_set import Part
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

# record types
_T_END_HEIGHT = 0x01
_T_VOTE = 0x02
_T_PROPOSAL = 0x03
_T_BLOCK_PART = 0x04
_T_TIMEOUT = 0x05
_T_ROUND_STATE = 0x06


@dataclass(frozen=True)
class EndHeightMessage:
    height: int


@dataclass(frozen=True)
class TimeoutRecord:
    duration: float
    height: int
    round: int
    step: int


@dataclass(frozen=True)
class RoundStateRecord:
    """Step-transition marker (the reference WALs EventDataRoundState)."""

    height: int
    round: int
    step: int


@dataclass(frozen=True)
class MsgRecord:
    """A consensus input: vote/proposal/block-part + its origin peer.

    `ctx`/`arrived` are IN-MEMORY tracing metadata (the trace context
    ambient when the input was enqueued + its wall-clock arrival) —
    deliberately not WAL-encoded and excluded from equality: replayed
    records are the same consensus input with or without a trace."""

    msg: object  # Vote | Proposal | (height, round, Part)
    peer_id: str
    ctx: object = field(default=None, compare=False, repr=False)
    arrived: float = field(default=0.0, compare=False, repr=False)
    # IN-MEMORY like ctx/arrived: True only for votes this node signed
    # itself this session — the tally skips re-verifying its own fresh
    # signature. Never WAL-encoded, so replayed records verify fully.
    self_signed: bool = field(default=False, compare=False, repr=False)


def _encode_record(item) -> bytes:
    if isinstance(item, EndHeightMessage):
        return bytes([_T_END_HEIGHT]) + Writer().uvarint(item.height).build()
    if isinstance(item, TimeoutRecord):
        payload = (
            Writer()
            .uvarint(int(item.duration * 1e6))
            .uvarint(item.height)
            .uvarint(item.round)
            .uvarint(item.step)
            .build()
        )
        return bytes([_T_TIMEOUT]) + payload
    if isinstance(item, RoundStateRecord):
        payload = Writer().uvarint(item.height).uvarint(item.round).uvarint(item.step).build()
        return bytes([_T_ROUND_STATE]) + payload
    if isinstance(item, MsgRecord):
        m = item.msg
        if isinstance(m, Vote):
            body = bytes([_T_VOTE]) + Writer().string(item.peer_id).bytes(m.encode()).build()
        elif isinstance(m, Proposal):
            body = bytes([_T_PROPOSAL]) + Writer().string(item.peer_id).bytes(m.encode()).build()
        else:
            height, round_, part = m
            payload = (
                Writer()
                .string(item.peer_id)
                .uvarint(height)
                .uvarint(round_)
                .bytes(part.encode())
                .build()
            )
            body = bytes([_T_BLOCK_PART]) + payload
        return body
    raise TypeError(f"cannot WAL {type(item)}")


def _decode_record(data: bytes):
    t, payload = data[0], data[1:]
    r = Reader(payload)
    if t == _T_END_HEIGHT:
        return EndHeightMessage(r.uvarint())
    if t == _T_TIMEOUT:
        dur = r.uvarint() / 1e6
        return TimeoutRecord(dur, r.uvarint(), r.uvarint(), r.uvarint())
    if t == _T_ROUND_STATE:
        return RoundStateRecord(r.uvarint(), r.uvarint(), r.uvarint())
    if t == _T_VOTE:
        peer = r.string()
        return MsgRecord(Vote.decode(r.bytes()), peer)
    if t == _T_PROPOSAL:
        peer = r.string()
        return MsgRecord(Proposal.decode(r.bytes()), peer)
    if t == _T_BLOCK_PART:
        peer = r.string()
        return MsgRecord((r.uvarint(), r.uvarint(), Part.decode(r.bytes())), peer)
    raise ValueError(f"unknown WAL record type {t}")


class WAL:
    """Write-ahead log with size-based file rotation (reference
    `autofile.Group` rolling files under `consensus/wal.go`). Segments
    rotate only at ENDHEIGHT boundaries, so every file is a valid
    record stream beginning at a height boundary; readers walk
    `path.N` segments oldest-first, then the live `path` file."""

    MAX_FILE_BYTES = 10 * 1024 * 1024  # reference autofile default
    MAX_SEGMENTS = 10  # pruned oldest-first (reference Group head cap)

    def __init__(
        self,
        path: str,
        light: bool = False,
        max_file_bytes: int | None = None,
        max_segments: int | None = None,
    ) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.light = light
        self.max_file_bytes = (
            self.MAX_FILE_BYTES if max_file_bytes is None else max_file_bytes
        )
        self.max_segments = (
            self.MAX_SEGMENTS if max_segments is None else max_segments
        )
        self._f = open(path, "ab")

    @staticmethod
    def segment_paths(path: str) -> list[str]:
        """All WAL files in replay order: rotated segments (ascending
        index) then the live file."""
        base = os.path.basename(path)
        dirname = os.path.dirname(path) or "."
        segs = []
        if os.path.isdir(dirname):
            for name in os.listdir(dirname):
                if name.startswith(base + "."):
                    suffix = name[len(base) + 1 :]
                    if suffix.isdigit():
                        segs.append((int(suffix), os.path.join(dirname, name)))
        out = [p for _, p in sorted(segs)]
        if os.path.exists(path):
            out.append(path)
        return out

    def save(self, item) -> None:
        """Frame + append + fsync (writes happen BEFORE processing)."""
        if self.light and isinstance(item, MsgRecord) and isinstance(item.msg, tuple):
            if item.peer_id != "":
                return  # light mode: drop peer block-parts
        body = _encode_record(item)
        frame = struct.pack(">II", zlib.crc32(body) & 0xFFFFFFFF, len(body)) + body
        # the fsync IS the consensus write barrier — its latency gates
        # every input the receive loop processes, so it gets a histogram
        t0 = time.perf_counter()
        self._f.write(frame)
        self._f.flush()
        os.fsync(self._f.fileno())
        _metrics.WAL_FSYNC_SECONDS.observe(time.perf_counter() - t0)
        _metrics.WAL_WRITTEN_BYTES.inc(len(frame))
        # rotate only at height boundaries: every segment then starts
        # with the records of a fresh height (replay never spans a cut)
        if (
            isinstance(item, EndHeightMessage)
            and self._f.tell() >= self.max_file_bytes
        ):
            self._rotate()

    def _rotate(self) -> None:
        self._f.close()
        existing = self.segment_paths(self.path)
        next_idx = 0
        for seg in existing:
            suffix = os.path.basename(seg)[len(os.path.basename(self.path)) + 1 :]
            if suffix.isdigit():
                next_idx = max(next_idx, int(suffix) + 1)
        os.replace(self.path, f"{self.path}.{next_idx}")
        # prune oldest segments beyond the cap
        segs = [p for p in self.segment_paths(self.path) if p != self.path]
        while len(segs) > self.max_segments:
            os.remove(segs.pop(0))
        self._f = open(self.path, "ab")

    def close(self) -> None:
        self._f.close()

    # -- reading --------------------------------------------------------------

    @staticmethod
    def iter_records(path: str) -> Iterator[object]:
        """Decode records across ALL segments in order. A truncated or
        corrupt TAIL of the live (last) file is tolerated — that is the
        crash-mid-write case recovery exists for. Corruption inside a
        ROTATED segment is data loss in the middle of the stream and
        raises instead of silently yielding a gapped replay."""
        segments = WAL.segment_paths(path)
        for i, seg in enumerate(segments):
            end = 0
            for off, rec, frame_len in WAL._iter_frames(seg):
                end = off + frame_len
                yield rec
            # non-tail segments must decode to EOF in the SAME pass
            if i < len(segments) - 1:
                size = os.path.getsize(seg)
                if end != size:
                    raise ValueError(
                        f"corrupt WAL segment {seg}: decoded {end} of {size} bytes"
                    )

    @staticmethod
    def iter_records_with_offsets(path: str) -> Iterator[tuple[int, object]]:
        """(start_offset, record) pairs — WAL tooling truncates at these
        offsets."""
        for off, rec, _ in WAL._iter_frames(path):
            yield off, rec

    @staticmethod
    def _iter_frames(path: str) -> Iterator[tuple[int, object, int]]:
        """(start_offset, record, frame_length) — the single place that
        knows the on-disk frame layout; stops at a truncated/corrupt
        tail."""
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + 8 <= len(data):
            crc, length = struct.unpack_from(">II", data, off)
            if off + 8 + length > len(data):
                return  # truncated tail
            body = data[off + 8 : off + 8 + length]
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                return  # corrupt tail
            try:
                rec = _decode_record(body)
            except Exception:
                return
            yield off, rec, 8 + length
            off += 8 + length

    @classmethod
    def records_since_last_end_height(cls, path: str, height: int) -> list[object] | None:
        """Records after `#ENDHEIGHT <height-1>` — the inputs to replay
        for an in-progress `height`. None if no marker for height-1
        exists (reference `SearchForEndHeight :122`)."""
        if not WAL.segment_paths(path):
            return None
        found = False
        out: list[object] = []
        for rec in cls.iter_records(path):
            if isinstance(rec, EndHeightMessage):
                if rec.height == height - 1:
                    found = True
                    out = []
                elif rec.height >= height:
                    # marker for a later height exists: caller's height is stale
                    found = True
                    out = []
                continue
            if found:
                out.append(rec)
        return out if found else None
