"""WebSocket event subscription (reference `rpc/lib/server/handlers.go:384`
WebsocketManager + `rpc/core/routes.go` subscribe/unsubscribe).

Minimal RFC 6455 implementation over the RPC HTTP server's socket:
clients upgrade at `/websocket`, then speak JSON-RPC —
`{"method":"subscribe","params":{"event":"NewBlock"}}` — and receive
each matching event as a JSON-RPC notification. Supported event names
are the `types.events` constants (NewBlock, NewRound, Vote, Tx, …) and
per-tx keys (`Tx:<hash>`).

The port's copy of `tendermint_tpu/rpc/websocket.py`. Frames and event
JSON byte-equal to the JAX package's.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def accept_key(client_key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((client_key + _GUID).encode()).digest()
    ).decode()


# -- frame codec --------------------------------------------------------------


def encode_frame(payload: bytes, opcode: int = 0x1, mask: bool = False) -> bytes:
    """One frame. Servers send unmasked; clients MUST mask (RFC 6455)."""
    import os

    header = bytes([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        header += bytes([mask_bit | n])
    elif n < 65536:
        header += bytes([mask_bit | 126]) + struct.pack(">H", n)
    else:
        header += bytes([mask_bit | 127]) + struct.pack(">Q", n)
    if not mask:
        return header + payload
    key = os.urandom(4)
    masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return header + key + masked


def _read_exact(rfile, n: int) -> bytes | None:
    buf = rfile.read(n)
    return buf if buf is not None and len(buf) == n else None


def read_frame(rfile) -> tuple[int, bytes] | None:
    """(opcode, payload) or None on EOF/short read (abrupt disconnect at
    ANY header position ends the stream cleanly instead of raising)."""
    head = _read_exact(rfile, 2)
    if head is None:
        return None
    opcode = head[0] & 0x0F
    masked = bool(head[1] & 0x80)
    n = head[1] & 0x7F
    if n == 126:
        ext = _read_exact(rfile, 2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = _read_exact(rfile, 8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    if n > 1 << 20:
        return None
    mask = b""
    if masked:
        mask = _read_exact(rfile, 4)
        if mask is None:
            return None
    payload = _read_exact(rfile, n)
    if payload is None:
        return None
    if masked:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, payload


# -- event serialization ------------------------------------------------------


def event_to_json(event: str, data) -> dict:
    """Compact JSON view of the typed event payloads."""
    out: dict = {"event": event}
    block = getattr(data, "block", None)
    if block is not None:
        out["height"] = block.header.height
        out["hash"] = block.hash().hex()
        return out
    header = getattr(data, "header", None)
    if header is not None and hasattr(header, "height"):
        out["height"] = header.height
        return out
    if hasattr(data, "sequence") and hasattr(data, "validator_address"):
        out.update(
            height=data.height,
            round=data.round,
            sequence=data.sequence,
            validator=data.validator_address.hex(),
        )
        return out  # ProposalHeartbeat
    vote = getattr(data, "vote", None)
    if vote is not None:
        out.update(
            height=vote.height,
            round=vote.round,
            type=vote.type,
            index=vote.validator_index,
        )
        return out
    for field in ("height", "round", "step", "tx", "data", "log", "code"):
        v = getattr(data, field, None)
        if v is not None:
            out[field] = v.hex() if isinstance(v, bytes) else v
    return out


# -- per-connection session ---------------------------------------------------


class WSSession:
    """One upgraded connection: subscription bookkeeping + event pump.

    Runs on the HTTP handler's thread (reads frames); event callbacks
    fire from other threads and write under a lock.
    """

    def __init__(self, handler, event_switch) -> None:
        self._handler = handler
        self._events = event_switch
        self._wlock = threading.Lock()
        self._id = f"ws-{id(self):x}"
        self._subs: set[str] = set()
        self._alive = True

    def _send_json(self, obj: dict) -> bool:
        data = encode_frame(json.dumps(obj).encode())
        try:
            with self._wlock:
                self._handler.wfile.write(data)
                self._handler.wfile.flush()
            return True
        except OSError:
            self._alive = False
            return False

    def _on_event(self, event: str, data) -> None:
        if self._alive:
            self._send_json(
                {"jsonrpc": "2.0", "method": "event", "params": event_to_json(event, data)}
            )

    def run(self) -> None:
        try:
            while self._alive:
                frame = read_frame(self._handler.rfile)
                if frame is None:
                    return
                opcode, payload = frame
                if opcode == 0x8:  # close
                    with self._wlock:
                        self._handler.wfile.write(encode_frame(b"", 0x8))
                    return
                if opcode == 0x9:  # ping -> pong
                    with self._wlock:
                        self._handler.wfile.write(encode_frame(payload, 0xA))
                    continue
                if opcode != 0x1:
                    continue
                self._handle_rpc(payload)
        finally:
            self._alive = False
            self._events.remove_listener(self._id)

    def _handle_rpc(self, payload: bytes) -> None:
        try:
            req = json.loads(payload)
            method = req.get("method", "")
            params = req.get("params", {}) or {}
            req_id = req.get("id")
        except (json.JSONDecodeError, AttributeError):
            self._send_json(
                {"jsonrpc": "2.0", "id": None, "error": {"code": -32700, "message": "parse error"}}
            )
            return
        if method == "subscribe":
            event = params.get("event", "")
            if not event:
                self._send_json(
                    {"jsonrpc": "2.0", "id": req_id, "error": {"code": -32602, "message": "missing event"}}
                )
                return
            if event not in self._subs:
                self._subs.add(event)
                self._events.add_listener(
                    self._id, event, lambda d, ev=event: self._on_event(ev, d)
                )
            self._send_json({"jsonrpc": "2.0", "id": req_id, "result": {"subscribed": event}})
        elif method == "unsubscribe":
            event = params.get("event", "")
            self._subs.discard(event)
            self._events.remove_listener(self._id, event)
            self._send_json({"jsonrpc": "2.0", "id": req_id, "result": {"unsubscribed": event}})
        else:
            self._send_json(
                {"jsonrpc": "2.0", "id": req_id, "error": {"code": -32601, "message": f"unknown ws method {method}"}}
            )
