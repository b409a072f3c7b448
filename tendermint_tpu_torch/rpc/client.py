"""RPC clients: HTTP and in-process Local (reference `rpc/client/`
HTTP + Local implementing one interface, `interface.go`).

Every method mirrors a route in `rpc/core.py`; both clients are
interchangeable (the reference's test pattern) — HTTPClient speaks
JSON-RPC 2.0 over HTTP, LocalClient calls the route table directly.

The port's copy of `tendermint_tpu/rpc/client.py`. Its clients speak to
either package's server.
"""

from __future__ import annotations

import json
import urllib.request


class RPCClientError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code


class _ClientBase:
    def _call(self, method: str, **params):
        raise NotImplementedError

    # -- the client interface (reference rpc/client/interface.go) ---------

    def status(self):
        return self._call("status")

    def net_info(self):
        return self._call("net_info")

    def block(self, height: int):
        return self._call("block", height=height)

    def blockchain(self, min_height: int = 1, max_height: int = 0):
        return self._call("blockchain", min_height=min_height, max_height=max_height)

    def commit(self, height: int):
        return self._call("commit", height=height)

    def validators(self, height: int | None = None):
        if height is None:
            return self._call("validators")
        return self._call("validators", height=height)

    def dump_consensus_state(self):
        return self._call("dump_consensus_state")

    def abci_query(self, path: str = "", data: bytes = b"", height: int = 0, prove: bool = False):
        return self._call(
            "abci_query", path=path, data=data.hex(), height=height, prove=prove
        )

    def num_unconfirmed_txs(self):
        return self._call("num_unconfirmed_txs")

    def unconfirmed_txs(self):
        return self._call("unconfirmed_txs")

    def abci_info(self):
        return self._call("abci_info")

    def genesis(self):
        return self._call("genesis")

    def tx(self, tx_hash: bytes, prove: bool = False):
        return self._call("tx", hash=tx_hash.hex(), prove=prove)

    def broadcast_tx_async(self, tx: bytes):
        return self._call("broadcast_tx_async", tx=tx.hex())

    def broadcast_tx_sync(self, tx: bytes):
        return self._call("broadcast_tx_sync", tx=tx.hex())

    def broadcast_tx_commit(self, tx: bytes):
        return self._call("broadcast_tx_commit", tx=tx.hex())


class HTTPClient(_ClientBase):
    """JSON-RPC 2.0 over HTTP (reference `rpc/client/httpclient.go`)."""

    def __init__(self, address: str, timeout: float = 90.0):
        # accepts "host:port", "tcp://host:port", or "http://host:port"
        addr = address.split("://", 1)[-1]
        self.url = f"http://{addr}/"
        self.timeout = timeout
        self._id = 0

    def _call(self, method: str, **params):
        self._id += 1
        req = urllib.request.Request(
            self.url,
            data=json.dumps(
                {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.load(resp)
        if "error" in out:
            raise RPCClientError(out["error"]["code"], out["error"]["message"])
        return out["result"]


class WSClient:
    """WebSocket event-subscription client (reference
    `rpc/lib/client/ws_client.go`). Blocking iterator interface:

        ws = WSClient("127.0.0.1:46657")
        ws.subscribe("NewBlock")
        for event in ws.events(timeout=10): ...

    When `reconnect=True` (default), a dead connection is transparently
    re-established with jittered exponential backoff and all active
    subscriptions re-issued (reference auto-reconnect + resubscribe,
    `rpc/lib/client/ws_client.go:46-59`).
    """

    def __init__(
        self,
        address: str,
        timeout: float = 30.0,
        reconnect: bool = True,
        max_reconnect_attempts: int = 25,
        reconnect_base_backoff_s: float = 0.25,
    ):
        from tendermint_tpu_torch.p2p.tcp import parse_laddr

        self._host, self._port = parse_laddr(
            address if "://" in address else f"tcp://{address}"
        )
        self._timeout = timeout
        self._reconnect_enabled = reconnect
        self._max_reconnect_attempts = max_reconnect_attempts
        self._reconnect_base_backoff_s = reconnect_base_backoff_s
        self._id = 0
        self._pending_events: list[dict] = []
        self._subscriptions: set[str] = set()
        self._closed = False
        self._connect()

    def _connect(self) -> None:
        import base64
        import os
        import socket

        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        )
        key = base64.b64encode(os.urandom(16)).decode()
        self._sock.sendall(
            (
                f"GET /websocket HTTP/1.1\r\nHost: {self._host}\r\n"
                "Connection: Upgrade\r\nUpgrade: websocket\r\n"
                f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        self._rfile = self._sock.makefile("rb")
        status = self._rfile.readline()
        if b"101" not in status:
            raise RPCClientError(-32000, f"ws upgrade failed: {status!r}")
        while self._rfile.readline() not in (b"\r\n", b""):
            pass

    def _try_reconnect(self) -> bool:
        """Dial + resubscribe with jittered exponential backoff; False when
        disabled, closed, or out of attempts."""
        import time as _time

        if not self._reconnect_enabled or self._closed:
            return False
        try:
            self._sock.close()
        except OSError:
            pass
        from tendermint_tpu_torch.utils.backoff import backoff_delay

        for attempt in range(self._max_reconnect_attempts):
            _time.sleep(
                backoff_delay(attempt, self._reconnect_base_backoff_s, cap=10.0)
            )
            if self._closed:
                return False
            try:
                self._connect()
                for event in list(self._subscriptions):
                    self._send("subscribe", event=event)
                    resp = self._recv_response(self._id, timeout=10)
                    if resp is None or "error" in resp:
                        raise RPCClientError(-32000, f"resubscribe failed: {resp}")
                return True
            except (OSError, RPCClientError):
                # don't leak a half-set-up conn when resubscribe fails
                try:
                    self._sock.close()
                except OSError:
                    pass
                continue
        return False

    def _send(self, method: str, **params) -> None:
        from tendermint_tpu_torch.rpc.websocket import encode_frame

        self._id += 1
        payload = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        self._sock.sendall(encode_frame(payload, mask=True))

    def _recv_json(self, timeout: float | None = None) -> dict | None:
        from tendermint_tpu_torch.rpc.websocket import read_frame

        self._sock.settimeout(timeout)
        frame = read_frame(self._rfile)
        if frame is None:
            return None
        opcode, payload = frame
        if opcode != 0x1:
            return self._recv_json(timeout)
        return json.loads(payload)

    def _recv_response(self, req_id: int, timeout: float) -> dict | None:
        """Next message with our request id; event notifications that
        arrive in the meantime are buffered for events()."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            msg = self._recv_json(max(deadline - _time.monotonic(), 0.05))
            if msg is None:
                return None
            if msg.get("method") == "event":
                self._pending_events.append(msg["params"])
                continue
            if msg.get("id") == req_id:
                return msg
        return None

    def subscribe(self, event: str) -> None:
        self._send("subscribe", event=event)
        resp = self._recv_response(self._id, timeout=10)
        if resp is None or "error" in resp:
            raise RPCClientError(-32000, f"subscribe failed: {resp}")
        self._subscriptions.add(event)

    def unsubscribe(self, event: str) -> None:
        self._subscriptions.discard(event)
        self._send("unsubscribe", event=event)

    def events(self, timeout: float = 30.0):
        """Yield event notification params until timeout/close. A dead
        connection triggers transparent reconnect + resubscribe. The
        iterator ends cleanly only on a quiet-period timeout or explicit
        close(); reconnect exhaustion raises RPCClientError so callers
        can tell "no events" from "connection permanently lost"."""

        def _recovered() -> bool:
            """True when reconnected, False on explicit close; raises on
            reconnect exhaustion of a live client."""
            if self._try_reconnect():
                return True
            if self._closed:
                return False
            raise RPCClientError(
                -32000,
                f"websocket connection lost and not recovered after "
                f"{self._max_reconnect_attempts} reconnect attempts",
            )

        while self._pending_events:
            yield self._pending_events.pop(0)
        while True:
            try:
                msg = self._recv_json(timeout)
            except TimeoutError:
                return  # no events within `timeout`: normal iterator end
            except OSError:
                if not _recovered():
                    return
                # resubscribe may have buffered events that raced the
                # subscribe responses — deliver them in order now
                while self._pending_events:
                    yield self._pending_events.pop(0)
                continue
            if msg is None:  # server closed the stream
                if not _recovered():
                    return
                while self._pending_events:
                    yield self._pending_events.pop(0)
                continue
            if msg.get("method") == "event":
                yield msg["params"]

    def close(self) -> None:
        self._closed = True
        self._sock.close()


class LocalClient(_ClientBase):
    """In-process client over a Node's route table (reference
    `rpc/client/localclient.go` — no HTTP hop, same interface)."""

    def __init__(self, node):
        from tendermint_tpu_torch.rpc.core import make_routes

        self._routes = make_routes(node)

    def _call(self, method: str, **params):
        # mirror the HTTP server's error mapping so the two clients are
        # genuinely interchangeable (same except-clauses work for both)
        from tendermint_tpu_torch.rpc.server import RPCError

        fn = self._routes.get(method)
        if fn is None:
            raise RPCClientError(-32601, f"unknown method {method}")
        try:
            return fn(**params)
        except RPCError as e:
            raise RPCClientError(e.code, e.message) from e
        except TypeError as e:
            raise RPCClientError(-32602, f"invalid params: {e}") from e
        except Exception as e:
            raise RPCClientError(-32603, str(e)) from e
