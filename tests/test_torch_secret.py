"""The port's SecretConnection and its pure-Python primitives.

`tendermint_tpu_torch.crypto.x25519`, `hkdf` and `chacha20poly1305`
stand in for the `cryptography` package, which a host with the card need
not have. They are held to RFC 7748 §5.2 and §6.1, RFC 5869 A.1-A.3 and
RFC 8439 §2.8.2, and to the `cryptography` package byte for byte on
seeded random keys and on messages of 0, 1, 63, 64, 65 and 2^20 bytes; a
flipped tag or ciphertext byte must raise in both.

The JAX package's `tests/test_secret_connection.py` runs again on the
port's `SecretEndpoint`. Across the packages, a JAX endpoint and a port
endpoint complete the handshake in either role and exchange frames, and
with the ephemeral keys fixed both packages put the same bytes on the
wire: ephemeral keys, the sealed auth frame and every sealed frame.
A small-order ephemeral key escapes the handshake as `ValueError` in
both packages.
"""

from __future__ import annotations

import os
import random
import threading

import pytest
from cryptography.exceptions import InvalidTag as CInvalidTag
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey as CXPriv
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PublicKey as CXPub
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305 as CAead
from cryptography.hazmat.primitives.kdf.hkdf import HKDF

from tendermint_tpu.crypto.keys import PrivKey as JPrivKey
from tendermint_tpu.p2p import secret as J_secret
from tendermint_tpu_torch.crypto import x25519
from tendermint_tpu_torch.crypto.chacha20poly1305 import ChaCha20Poly1305, InvalidTag, chacha20_blocks, poly1305
from tendermint_tpu_torch.crypto.hkdf import hkdf_sha256
from tendermint_tpu_torch.crypto.keys import PrivKey
from tendermint_tpu_torch.p2p import secret
from tendermint_tpu_torch.p2p.secret import HandshakeError, SecretEndpoint
from tendermint_tpu_torch.p2p.transport import EndpointClosed, pipe_pair
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture

h = bytes.fromhex


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))


# -- X25519 (RFC 7748) ------------------------------------------------------------


@pytest.mark.parametrize("scalar, u, out", [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
])
def test_x25519_rfc7748_section_5_2(scalar, u, out):
    assert x25519.x25519(h(scalar), h(u)).hex() == out


def test_x25519_rfc7748_iterated():
    k = u = x25519.BASE_POINT
    for i in range(1000):
        k, u = x25519.x25519(k, u), k
        if i == 0:
            assert k.hex() == "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"
    assert k.hex() == "684cf59ba83309552800ef566f2f4d3c1c3887c49360e3875f2eb94d99532c51"


def test_x25519_rfc7748_section_6_1():
    alice = x25519.X25519PrivateKey(h("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"))
    bob = x25519.X25519PrivateKey(h("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"))
    assert alice.public_key().public_bytes_raw().hex() == (
        "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    assert bob.public_key().public_bytes_raw().hex() == (
        "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    shared = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    assert alice.exchange(bob.public_key()).hex() == shared
    assert bob.exchange(alice.public_key()).hex() == shared


def _craw(pub) -> bytes:
    return pub.public_bytes(serialization.Encoding.Raw, serialization.PublicFormat.Raw)


def test_x25519_equals_cryptography_on_seeded_keys():
    rng = random.Random(7748)
    for _ in range(24):
        a, b, u = rng.randbytes(32), rng.randbytes(32), rng.randbytes(32)
        ours, theirs = x25519.X25519PrivateKey.from_private_bytes(a), CXPriv.from_private_bytes(a)
        assert ours.public_key().public_bytes_raw() == _craw(theirs.public_key())
        peer = CXPriv.from_private_bytes(b).public_key()
        assert ours.exchange(x25519.X25519PublicKey.from_public_bytes(_craw(peer))) == theirs.exchange(peer)
        # an arbitrary u, top bit set or not, reduced or not
        assert ours.exchange(x25519.X25519PublicKey(u)) == theirs.exchange(CXPub.from_public_bytes(u))


# u-coordinates of small order or out of range (0, 1, a point of order
# 8, p - 1, p, p + 1, 2^255 - 1 after the mask): whatever cryptography
# does with each (a shared secret, or ValueError on an all-zero one),
# the port does the same
EDGE_U = [
    "00" * 32,
    "01" + "00" * 31,
    "e0eb7a7c3b41b8ae1656e3faf19fc46ada098deb9c32b1fd866205165f49b800",
    "ecffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "edffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "eeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "ff" * 32,
]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("u", EDGE_U)
def test_x25519_edge_points_behave_like_cryptography(u):
    k = bytes(range(32))
    theirs = _outcome(lambda: CXPriv.from_private_bytes(k).exchange(CXPub.from_public_bytes(h(u))))
    ours = _outcome(lambda: x25519.X25519PrivateKey(k).exchange(x25519.X25519PublicKey(h(u))))
    assert ours == theirs


def test_x25519_zero_point_raises():
    with pytest.raises(ValueError, match="Error computing shared key"):
        x25519.X25519PrivateKey(bytes(range(32))).exchange(x25519.X25519PublicKey(bytes(32)))


def test_x25519_key_sizes_are_checked():
    with pytest.raises(ValueError):
        x25519.X25519PublicKey.from_public_bytes(b"\x01" * 31)
    with pytest.raises(ValueError):
        x25519.X25519PrivateKey.from_private_bytes(b"\x01" * 33)
    assert len(x25519.X25519PrivateKey.generate().public_key().public_bytes_raw()) == 32


# -- HKDF-SHA256 (RFC 5869) ----------------------------------------------------------


@pytest.mark.parametrize("ikm, salt, info, length, okm", [
    (b"\x0b" * 22, bytes(range(13)), bytes(range(0xF0, 0xFA)), 42,
     "3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf34007208d5b887185865"),
    (bytes(range(0x50)), bytes(range(0x60, 0xB0)), bytes(range(0xB0, 0x100)), 82,
     "b11e398dc80327a1c8e7f78c596a49344f012eda2d4efad8a050cc4c19afa97c59045a99cac7827271cb41c65e590e09da3275600c2f09b8367793a9aca3db71cc30c58179ec3e87c14c01d5c1f3434f1d87"),
    (b"\x0b" * 22, b"", b"", 42,
     "8da4e775a563c18f715f802a063c5a31b8a11f5c5ee1879ec3454e5f3c738d2d9d201395faa4b61a96c8"),
], ids=["A.1", "A.2", "A.3"])
def test_hkdf_rfc5869(ikm, salt, info, length, okm):
    assert hkdf_sha256(ikm, salt=salt, info=info, length=length).hex() == okm


@pytest.mark.parametrize("length", [1, 32, 64, 100, 255 * 32])
def test_hkdf_equals_cryptography(length):
    rng = random.Random(length)
    for salt in (None, b"", rng.randbytes(64)):
        ikm, info = rng.randbytes(32), rng.randbytes(rng.randrange(50))
        want = HKDF(algorithm=hashes.SHA256(), length=length, salt=salt, info=info).derive(ikm)
        assert hkdf_sha256(ikm, salt=salt, info=info, length=length) == want
    with pytest.raises(ValueError):
        hkdf_sha256(b"k", salt=None, info=b"", length=255 * 32 + 1)


# -- ChaCha20-Poly1305 (RFC 8439) ----------------------------------------------------

RFC8439_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one tip for the future, "
              b"sunscreen would be it.")
RFC8439_CT = (
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d63dbea45e8ca9671282fafb69da92728b"
    "1a71de0a9e060b2905d6a5b67ecd3b3692ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
    "3ff4def08e4b7a9de576d26586cec64b6116"
)
RFC8439_TAG = "1ae10b594f09e26a7e902ecbd0600691"


def test_aead_rfc8439_section_2_8_2():
    aead = ChaCha20Poly1305(bytes(range(0x80, 0xA0)))
    nonce, aad = h("070000004041424344454647"), h("50515253c0c1c2c3c4c5c6c7")
    sealed = aead.encrypt(nonce, RFC8439_PT, aad)
    assert sealed.hex() == RFC8439_CT + RFC8439_TAG
    assert aead.decrypt(nonce, sealed, aad) == RFC8439_PT


def test_chacha20_block_rfc8439_section_2_3_2():
    key = bytes(range(32))
    block = chacha20_blocks(key, h("000000090000004a00000000"), 1, 1)
    assert block.hex() == (
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")


def test_poly1305_rfc8439_section_2_5_2():
    key = h("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b")
    assert poly1305(key, b"Cryptographic Forum Research Group").hex() == "a8061dc1305136c6c22b8baf0c0127a9"


@pytest.mark.parametrize("size", [0, 1, 63, 64, 65, 1 << 20])
def test_aead_equals_cryptography(size):
    rng = random.Random(size)
    for aad in (None, b"", rng.randbytes(rng.randrange(1, 40))):
        key, nonce, msg = rng.randbytes(32), rng.randbytes(12), rng.randbytes(size)
        ours, theirs = ChaCha20Poly1305(key), CAead(key)
        sealed = ours.encrypt(nonce, msg, aad)
        assert sealed == theirs.encrypt(nonce, msg, aad)
        assert ours.decrypt(nonce, sealed, aad) == msg
        for pos in (len(sealed) - 1, len(sealed) - 16, 0):  # tag bytes, then the first ciphertext byte
            bad = bytearray(sealed)
            bad[pos] ^= 0x01
            with pytest.raises(InvalidTag):
                ours.decrypt(nonce, bytes(bad), aad)
            with pytest.raises(CInvalidTag):
                theirs.decrypt(nonce, bytes(bad), aad)
        if aad:
            with pytest.raises(InvalidTag):
                ours.decrypt(nonce, sealed, aad[:-1])


def test_aead_rejects_bad_sizes():
    with pytest.raises(ValueError):
        ChaCha20Poly1305(b"k" * 31)
    with pytest.raises(ValueError):
        ChaCha20Poly1305(b"k" * 32).encrypt(b"n" * 8, b"x", None)
    with pytest.raises(InvalidTag):
        ChaCha20Poly1305(b"k" * 32).decrypt(b"n" * 12, b"short", None)


# -- tests/test_secret_connection.py ---------------------------------------------------


def _pair(key_a=None, key_b=None):
    a, b = pipe_pair()
    ka = key_a or PrivKey(b"\x01" * 32)
    kb = key_b or PrivKey(b"\x02" * 32)
    out = {}

    def side_b():
        out["b"] = SecretEndpoint(b, kb)

    t = threading.Thread(target=side_b, daemon=True)
    t.start()
    sa = SecretEndpoint(a, ka)
    t.join(timeout=10)
    return sa, out["b"], ka, kb


class TestSecretConnection:
    def test_round_trip_and_identity(self):
        sa, sb, ka, kb = _pair()
        assert sa.remote_pub_key.data == kb.pub_key.data
        assert sb.remote_pub_key.data == ka.pub_key.data
        sa.send(b"over the wire")
        assert sb.recv(timeout=2) == b"over the wire"
        sb.send(b"and back")
        assert sa.recv(timeout=2) == b"and back"

    def test_many_frames_nonce_progression(self):
        sa, sb, _, _ = _pair()
        for i in range(50):
            sa.send(b"frame-%d" % i)
        for i in range(50):
            assert sb.recv(timeout=2) == b"frame-%d" % i

    def test_tampered_frame_kills_link(self):
        a, mid_a = pipe_pair()
        mid_b, b = pipe_pair()
        done = {}

        def side_b():
            done["b"] = SecretEndpoint(b, PrivKey(b"\x02" * 32))

        t = threading.Thread(target=side_b, daemon=True)
        t.start()

        def relay(n):
            for _ in range(n):
                mid_b.send(mid_a.recv(timeout=5))

        relay_t = threading.Thread(target=lambda: relay(2), daemon=True)  # eph key + auth frame
        relay_back = threading.Thread(
            target=lambda: [mid_a.send(mid_b.recv(timeout=5)) for _ in range(2)], daemon=True
        )
        relay_t.start()
        relay_back.start()
        sa = SecretEndpoint(a, PrivKey(b"\x01" * 32))
        t.join(timeout=10)
        sb = done["b"]

        sa.send(b"legit")
        frame = bytearray(mid_a.recv(timeout=2))
        frame[0] ^= 0xFF
        mid_b.send(bytes(frame))
        with pytest.raises(EndpointClosed):
            sb.recv(timeout=2)

    def test_mitm_cannot_forge_identity(self):
        a, b = pipe_pair()

        def bad_side():
            eph = x25519.X25519PrivateKey.generate()
            b.send(eph.public_key().public_bytes_raw())
            b.recv(timeout=5)  # peer eph
            b.send(b"\x00" * 96)  # garbage instead of a sealed auth frame

        t = threading.Thread(target=bad_side, daemon=True)
        t.start()
        with pytest.raises((HandshakeError, EndpointClosed)):
            SecretEndpoint(a, PrivKey(b"\x01" * 32))

    def test_dropped_write_burns_no_nonce(self):
        """A backpressure drop (the inner send returning False) leaves the
        counter where it was: the next frame still opens."""
        sa, sb, _, _ = _pair()
        inner = sa._inner
        real_send = inner.send
        inner.send = lambda data, timeout=10.0: False
        assert sa.send(b"dropped") is False
        inner.send = real_send
        assert sa.send(b"after the drop")
        assert sb.recv(timeout=2) == b"after the drop"


# -- across the packages -----------------------------------------------------------------


def _handshake(make_a, make_b, a, b):
    out = {}

    def side_b():
        try:
            out["b"] = make_b(b)
        except Exception as e:  # noqa: BLE001 - carried to the main thread
            out["b"] = e

    t = threading.Thread(target=side_b, daemon=True)
    t.start()
    sa = make_a(a)
    t.join(timeout=10)
    return sa, out["b"]


@pytest.mark.parametrize("port_side", ["a", "b"])
def test_port_and_jax_endpoints_handshake_and_talk(port_side):
    ka, kb = b"\x03" * 32, b"\x04" * 32
    port = lambda ep, k: SecretEndpoint(ep, PrivKey(k))  # noqa: E731
    jax = lambda ep, k: J_secret.SecretEndpoint(ep, JPrivKey(k))  # noqa: E731
    make_a, make_b = (port, jax) if port_side == "a" else (jax, port)
    a, b = pipe_pair()
    sa, sb = _handshake(lambda ep: make_a(ep, ka), lambda ep: make_b(ep, kb), a, b)
    assert sa.remote_pub_key.data == PrivKey(kb).pub_key.data
    assert sb.remote_pub_key.data == PrivKey(ka).pub_key.data
    for i in range(5):
        msg = os.urandom(1 + 977 * i)
        assert sa.send(msg)
        assert sb.recv(timeout=5) == msg
        assert sb.send(msg[::-1])
        assert sa.recv(timeout=5) == msg[::-1]


class _Tap:
    def __init__(self, inner, log):
        self._inner, self._log = inner, log

    def send(self, data, timeout=10.0):
        self._log.append(bytes(data))
        return self._inner.send(data, timeout)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _fixed_ephemerals(monkeypatch, main_seed, other_seed):
    """Both packages draw `main_seed` as the ephemeral key on the main
    thread and `other_seed` on any other."""

    def seed():
        return main_seed if threading.current_thread() is threading.main_thread() else other_seed

    class _CShim:
        @staticmethod
        def generate():
            return CXPriv.from_private_bytes(seed())

    monkeypatch.setattr(J_secret, "X25519PrivateKey", _CShim)
    monkeypatch.setattr(secret.X25519PrivateKey, "generate", classmethod(lambda cls: cls(seed())))


def test_both_packages_put_the_same_bytes_on_the_wire(monkeypatch):
    _fixed_ephemerals(monkeypatch, b"\x11" * 32, b"\x22" * 32)
    frames = {}
    for name, mk, key in (("port", SecretEndpoint, PrivKey), ("jax", J_secret.SecretEndpoint, JPrivKey)):
        log_a, log_b = [], []
        a, b = pipe_pair()
        sa, sb = _handshake(lambda ep: mk(_Tap(ep, log_a), key(b"\x05" * 32)),
                            lambda ep: mk(_Tap(ep, log_b), key(b"\x06" * 32)), a, b)
        for msg in (b"", b"x", b"y" * 64, b"z" * 4099):
            sa.send(msg)
            assert sb.recv(timeout=5) == msg
        frames[name] = (log_a, log_b)
    assert frames["port"] == frames["jax"]
    assert len(frames["port"][0]) == 2 + 4  # eph key, auth frame, four data frames


@pytest.mark.parametrize("victim", ["port", "jax"])
def test_a_small_order_ephemeral_key_escapes_as_value_error(victim):
    """A peer that sends an all-zero ephemeral key makes `exchange`
    raise, and the handshake lets it escape: `ValueError` in both
    packages, with cryptography's message."""
    a, b = pipe_pair()
    b.send(bytes(32))
    make = (lambda ep: SecretEndpoint(ep, PrivKey(b"\x07" * 32))) if victim == "port" else (
        lambda ep: J_secret.SecretEndpoint(ep, JPrivKey(b"\x07" * 32)))
    with pytest.raises(ValueError, match="Error computing shared key"):
        make(a)
