"""TCP transport: run the Switch over real sockets.

Frames are 4-byte big-endian length-prefixed (carrying the same
channel-multiplexed payloads as the in-memory pipe). Connecting sides
exchange NodeInfo as the first frame (version/chain-id compat handshake
— reference `p2p/peer.go`). When a `priv_key` is supplied (config
p2p.secret_connections, the default), every link is wrapped in the
SecretConnection STS handshake (`p2p/secret.py`) before the NodeInfo
exchange, and the peer's claimed node_id must match the address of its
authenticated identity key (see `_check_identity`).

The port's copy of `tendermint_tpu/p2p/tcp.py`: the same framing and
handshake order, so a port node and a JAX node dial each other in
either direction, with or without a SecretConnection.
"""

from __future__ import annotations

import socket
import struct
import threading

from tendermint_tpu_torch.p2p.peer import NodeInfo
from tendermint_tpu_torch.p2p.switch import Switch
from tendermint_tpu_torch.p2p.transport import EndpointClosed
from tendermint_tpu_torch.utils.lockrank import ranked_lock

_MAX_FRAME = 8 * 1024 * 1024


class TcpEndpoint:
    """transport.Endpoint over a connected socket."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        # seq 1: a SecretEndpoint (seq 0) holds its own write lock while
        # it writes through this one, a fixed layering the sanitizer
        # would otherwise report as a same-rank inversion
        self._wlock = ranked_lock("p2p.conn.write", seq=1)
        self._closed = threading.Event()
        try:
            host, port = sock.getpeername()[:2]
            # the socket's REAL remote address — peer filters must use
            # this, never the peer's self-reported listen_addr
            self.remote_addr = f"{host}:{port}"
        except OSError:
            self.remote_addr = ""
        sock.settimeout(None)

    def send(self, data: bytes, timeout: float = 10.0) -> bool:
        if self._closed.is_set():
            raise EndpointClosed
        try:
            with self._wlock:
                self._sock.sendall(struct.pack(">I", len(data)) + data)
            return True
        except OSError as e:
            self.close()
            raise EndpointClosed from e

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise EndpointClosed
            buf += chunk
        return buf

    def recv(self, timeout: float | None = None) -> bytes:
        if self._closed.is_set():
            raise EndpointClosed
        try:
            self._sock.settimeout(timeout)
            (length,) = struct.unpack(">I", self._read_exact(4))
            if length > _MAX_FRAME:
                raise EndpointClosed
            return self._read_exact(length)
        except socket.timeout as e:
            raise TimeoutError from e
        except OSError as e:
            self.close()
            raise EndpointClosed from e
        finally:
            try:
                self._sock.settimeout(None)
            except OSError:
                pass

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()


def parse_laddr(laddr: str) -> tuple[str, int]:
    """'tcp://host:port' -> (host, port)."""
    addr = laddr.split("://", 1)[-1]
    host, _, port = addr.rpartition(":")
    return host or "0.0.0.0", int(port)


class TcpListener:
    """Accept loop: handshake NodeInfo, hand peers to the switch.

    With `priv_key` set, every connection is wrapped in a
    SecretConnection (X25519 + transcript-signature STS, see
    `p2p/secret.py`) before the NodeInfo exchange, and the peer's
    claimed node_id must match its authenticated identity key."""

    def __init__(
        self, switch: Switch, laddr: str, priv_key=None, start: bool = True
    ) -> None:
        self.switch = switch
        self.priv_key = priv_key
        host, port = parse_laddr(laddr)
        self._srv = socket.create_server((host, port), reuse_port=False)
        self.addr = self._srv.getsockname()  # actual (host, port) after bind
        self._running = False
        self._thread: threading.Thread | None = None
        if start:
            self.start_accepting()

    def start_accepting(self) -> None:
        """Begin accepting connections. Separated from binding so a node
        can learn its port (for the advertised listen_addr) BEFORE any
        inbound peer can reach reactors that haven't started."""
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._accept_loop, name="p2p-accept", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self.addr[1]

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handshake,
                args=(sock, False),
                name="p2p-handshake",
                daemon=True,
            ).start()

    def _handshake(self, sock: socket.socket, outbound: bool) -> None:
        ep = TcpEndpoint(sock)
        try:
            ep = _maybe_secure(ep, self.priv_key)
            ep.send(self.switch.node_info.encode())
            remote = NodeInfo.decode(ep.recv(timeout=10.0))
            _check_identity(ep, remote)
            self.switch.add_peer_endpoint(remote, ep, outbound=outbound)
        except Exception:
            ep.close()

    def stop(self) -> None:
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass


def _maybe_secure(ep, priv_key):
    if priv_key is None:
        return ep
    from tendermint_tpu_torch.p2p.secret import SecretEndpoint

    return SecretEndpoint(ep, priv_key)


def _check_identity(ep, remote: NodeInfo) -> None:
    """On a secured link, the claimed node_id must be the address of the
    authenticated identity key (impersonation check)."""
    remote_pub = getattr(ep, "remote_pub_key", None)
    if remote_pub is not None and remote.node_id != remote_pub.address.hex():
        raise ValueError(
            f"node_id {remote.node_id[:12]} != authenticated identity "
            f"{remote_pub.address.hex()[:12]}"
        )


def dial(switch: Switch, addr: str, timeout: float = 10.0, priv_key=None):
    """Connect out to host:port (or tcp://host:port) and add the peer."""
    host, port = parse_laddr(addr)
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    ep = TcpEndpoint(sock)
    try:
        ep = _maybe_secure(ep, priv_key)
        ep.send(switch.node_info.encode())
        remote = NodeInfo.decode(ep.recv(timeout=timeout))
        _check_identity(ep, remote)
        return switch.add_peer_endpoint(remote, ep, outbound=True)
    except Exception:
        ep.close()
        raise
