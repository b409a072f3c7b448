"""SecretConnection: authenticated encryption for peer links.

Fills the reference's `p2p/secret_connection.go:36-115` slot — a
Station-to-Station handshake (ephemeral ECDH, then each side signs the
handshake transcript with its long-lived ed25519 node key) under
per-direction nonce-counter AEAD framing.

DELIBERATE MODERNIZATION (not bit-compatible, like the rest of this
framework's wire layer): X25519 + HKDF-SHA256 + ChaCha20Poly1305
replaces the reference's hand-rolled nacl secretbox construction with
nonces derived from sorted ephemeral keys. Same security shape —
authenticated, forward-secret per connection, MITM-excluded by the
transcript signature.

The port's copy of `tendermint_tpu/p2p/secret.py`: the same transcript,
salt, key split and nonce rule, so a port node and a JAX node complete
the handshake with each other. The three primitives are the port's own
pure-Python X25519, HKDF-SHA256 and ChaCha20-Poly1305
(`crypto/x25519.py`, `hkdf.py`, `chacha20poly1305.py`), byte-equal to
`cryptography`'s, which the port does not import. As in the JAX
package, a peer's small-order ephemeral key makes `exchange` raise
`ValueError` out of the handshake.
"""

from __future__ import annotations

import struct
import threading

from tendermint_tpu_torch.crypto.chacha20poly1305 import ChaCha20Poly1305
from tendermint_tpu_torch.crypto.hkdf import hkdf_sha256
from tendermint_tpu_torch.crypto.keys import PrivKey, PubKey
from tendermint_tpu_torch.crypto.x25519 import X25519PrivateKey, X25519PublicKey
from tendermint_tpu_torch.p2p.transport import EndpointClosed
from tendermint_tpu_torch.utils.lockrank import ranked_lock

_TRANSCRIPT_PREFIX = b"tendermint_tpu/secret-connection/v1"


class HandshakeError(Exception):
    pass


def _kdf(shared: bytes, salt: bytes) -> bytes:
    return hkdf_sha256(shared, salt=salt, info=_TRANSCRIPT_PREFIX, length=64)


class SecretEndpoint:
    """Wrap any Endpoint with an authenticated encrypted channel.

    After construction the handshake has completed: `remote_pub_key`
    holds the peer's verified long-lived ed25519 identity (the Switch
    checks it against the claimed NodeInfo.node_id).
    """

    def __init__(self, inner, priv_key: PrivKey) -> None:
        self._inner = inner
        # socket-level identity passes through the encryption layer
        self.remote_addr = getattr(inner, "remote_addr", "")
        self.remote_pub_key: PubKey | None = None
        self._send_nonce = 0
        self._recv_nonce = 0
        self._send_lock = ranked_lock("p2p.conn.write")
        self._handshake(priv_key)

    # -- handshake ---------------------------------------------------------

    def _handshake(self, priv_key: PrivKey) -> None:
        eph = X25519PrivateKey.generate()
        eph_pub = eph.public_key().public_bytes_raw()
        self._inner.send(eph_pub)
        remote_eph = self._inner.recv(timeout=10.0)
        if len(remote_eph) != 32:
            raise HandshakeError("bad ephemeral key")
        shared = eph.exchange(X25519PublicKey.from_public_bytes(remote_eph))

        # both sides derive identical key material: salt = sorted eph keys
        lo, hi = sorted((eph_pub, remote_eph))
        keys = _kdf(shared, lo + hi)
        # the lexicographically-lower ephemeral key sends with the first
        # half (reference derives nonces from sorted eph keys the same way)
        if eph_pub == lo:
            self._send_key = ChaCha20Poly1305(keys[:32])
            self._recv_key = ChaCha20Poly1305(keys[32:])
        else:
            self._send_key = ChaCha20Poly1305(keys[32:])
            self._recv_key = ChaCha20Poly1305(keys[:32])

        # authenticate: sign the transcript with the node identity key
        # (sent through the just-established encrypted channel, so the
        # identity is hidden from passive observers — reference behavior)
        transcript = _TRANSCRIPT_PREFIX + lo + hi
        sig = priv_key.sign(transcript)
        self.send(priv_key.pub_key.data + sig)
        auth = self.recv(timeout=10.0)
        if len(auth) != 32 + 64:
            raise HandshakeError("bad auth frame")
        remote_pub = PubKey(auth[:32])
        if not remote_pub.verify(transcript, auth[32:]):
            raise HandshakeError("peer failed transcript authentication")
        self.remote_pub_key = remote_pub

    # -- framing -----------------------------------------------------------

    def _nonce(self, counter: int) -> bytes:
        return struct.pack(">IQ", 0, counter)

    def send(self, data: bytes, timeout: float = 10.0) -> bool:
        with self._send_lock:
            # the wire write stays INSIDE the lock: frames must hit the
            # transport in nonce order or the receiver's counter
            # desyncs and the AEAD check kills the link. The counter
            # advances ONLY on a successful write — a backpressure drop
            # (inner send returning False) must not burn a nonce, or
            # the very next frame kills the connection.
            nonce = self._nonce(self._send_nonce)
            sealed = self._send_key.encrypt(nonce, data, None)
            ok = self._inner.send(sealed, timeout)
            if ok:
                self._send_nonce += 1
            return ok

    def recv(self, timeout: float | None = None) -> bytes:
        sealed = self._inner.recv(timeout)
        nonce = self._nonce(self._recv_nonce)
        self._recv_nonce += 1
        try:
            return self._recv_key.decrypt(nonce, sealed, None)
        except Exception as e:
            # tampered/replayed/reordered frame: kill the link
            self._inner.close()
            raise EndpointClosed from e

    def close(self) -> None:
        self._inner.close()

    @property
    def closed(self) -> bool:
        return self._inner.closed
