"""Minimal JSON-RPC 2.0 server: HTTP POST + GET-URI forms.

Reference `rpc/lib/server/handlers.go:101` (JSON-RPC over POST) and
`:234` (GET with query params). Handlers are plain callables registered
by name with keyword params; results must be JSON-serializable dicts.
WebSocket event subscription lives in `rpc/websocket.py` (RFC 6455
upgrade served off this same listener).

The port's copy of `tendermint_tpu/rpc/server.py`. It counts into the
port's `RPC_REQUESTS` and `RPC_SECONDS`.
"""

from __future__ import annotations

import json
import socket as socket_mod
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse


class RPCError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class _TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that can sever live connections on stop.

    Long-lived WebSocket upgrades would otherwise outlive `shutdown()`
    (which only stops the accept loop), leaving clients half-open and
    unaware the server is gone."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._live: set = set()
        self._live_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._live_lock:
            self._live.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._live_lock:
            self._live.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self) -> None:
        with self._live_lock:
            live = list(self._live)
        for sock in live:
            try:
                sock.shutdown(socket_mod.SHUT_RDWR)
            except OSError:
                pass


class RPCServer:
    def __init__(
        self, routes: dict, laddr: str = "tcp://127.0.0.1:46657", event_switch=None
    ):
        from tendermint_tpu_torch.p2p.tcp import parse_laddr

        self.routes = routes
        host, port = parse_laddr(laddr)
        handler = _make_handler(routes, event_switch)
        self._httpd = _TrackingHTTPServer((host, port), handler)
        self.addr = self._httpd.server_address
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.addr[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="rpc-http", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        # sever in-flight conns (WS subscribers) so clients see the close
        self._httpd.close_all_connections()


def _make_handler(routes: dict, event_switch=None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _respond(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _call(self, req_id, method, params):
            import time as time_mod

            from tendermint_tpu_torch.telemetry import metrics as _metrics

            fn = routes.get(method)
            if fn is None:
                _metrics.RPC_REQUESTS.labels(
                    method="<unknown>", result="error"
                ).inc()
                return {
                    "jsonrpc": "2.0",
                    "id": req_id,
                    "error": {"code": -32601, "message": f"unknown method {method}"},
                }
            t0 = time_mod.perf_counter()
            try:
                result = fn(**params) if isinstance(params, dict) else fn(*params)
                _metrics.RPC_SECONDS.labels(method=method).observe(
                    time_mod.perf_counter() - t0
                )
                _metrics.RPC_REQUESTS.labels(method=method, result="ok").inc()
                return {"jsonrpc": "2.0", "id": req_id, "result": result}
            except RPCError as e:
                _metrics.RPC_SECONDS.labels(method=method).observe(
                    time_mod.perf_counter() - t0
                )
                _metrics.RPC_REQUESTS.labels(method=method, result="error").inc()
                return {
                    "jsonrpc": "2.0",
                    "id": req_id,
                    "error": {"code": e.code, "message": e.message},
                }
            except TypeError as e:
                _metrics.RPC_REQUESTS.labels(method=method, result="error").inc()
                return {
                    "jsonrpc": "2.0",
                    "id": req_id,
                    "error": {"code": -32602, "message": f"invalid params: {e}"},
                }
            except Exception as e:
                _metrics.RPC_REQUESTS.labels(method=method, result="error").inc()
                return {
                    "jsonrpc": "2.0",
                    "id": req_id,
                    "error": {"code": -32603, "message": str(e)},
                }

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._respond(
                    {
                        "jsonrpc": "2.0",
                        "id": None,
                        "error": {"code": -32700, "message": "parse error"},
                    }
                )
                return
            if not isinstance(req, dict):
                self._respond(
                    {
                        "jsonrpc": "2.0",
                        "id": None,
                        "error": {
                            "code": -32600,
                            "message": "request must be a JSON object",
                        },
                    }
                )
                return
            self._respond(
                self._call(req.get("id"), req.get("method", ""), req.get("params", {}))
            )

        def do_GET(self):
            url = urlparse(self.path)
            method = url.path.strip("/")
            if (
                method == "websocket"
                and event_switch is not None
                and "upgrade" in self.headers.get("Connection", "").lower()
            ):
                self._upgrade_websocket()
                return
            if method == "metrics":
                # Prometheus text exposition — plain HTTP, not JSON-RPC,
                # so any scraper can point straight at the RPC listener
                self._serve_metrics()
                return
            if method == "health" and "health" in routes:
                # plain-HTTP readiness probe: the health dict as the raw
                # body, 503 when not ready — load balancers act on the
                # status code, dashboards read the JSON
                self._serve_health()
                return
            if method == "":
                # route listing (reference serves an index page)
                self._respond({"jsonrpc": "2.0", "id": -1, "result": sorted(routes)})
                return
            params = {}
            for k, v in parse_qsl(url.query):
                # keep values as strings except explicit booleans —
                # handlers coerce numerics themselves (json.loads would
                # mangle all-digit hex params like tx/hash/data into ints)
                if v in ("true", "false"):
                    params[k] = v == "true"
                else:
                    params[k] = v.strip('"')
            self._respond(self._call(-1, method, params))

        def _serve_metrics(self):
            from tendermint_tpu_torch.telemetry import REGISTRY
            from tendermint_tpu_torch.telemetry import metrics as _metrics

            body = REGISTRY.prometheus_text().encode()
            _metrics.RPC_REQUESTS.labels(method="metrics", result="ok").inc()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _serve_health(self):
            from tendermint_tpu_torch.telemetry import metrics as _metrics

            try:
                body = routes["health"]()
            except Exception as e:
                _metrics.RPC_REQUESTS.labels(method="health", result="error").inc()
                self._respond({"status": "error", "error": str(e)}, status=500)
                return
            _metrics.RPC_REQUESTS.labels(method="health", result="ok").inc()
            status = 200 if body.get("ready", False) else 503
            self._respond(body, status=status)

        def _upgrade_websocket(self):
            from tendermint_tpu_torch.rpc.websocket import WSSession, accept_key

            key = self.headers.get("Sec-WebSocket-Key", "")
            if not key:
                self.send_error(400, "missing Sec-WebSocket-Key")
                return
            self.send_response(101, "Switching Protocols")
            self.send_header("Upgrade", "websocket")
            self.send_header("Connection", "Upgrade")
            self.send_header("Sec-WebSocket-Accept", accept_key(key))
            self.end_headers()
            self.close_connection = True
            WSSession(self, event_switch).run()

    return Handler
