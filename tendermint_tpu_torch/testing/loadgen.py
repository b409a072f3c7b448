"""The scenario library's load generator: `TxFactory`, the payload
maker of the repo's `tools/loadgen.py`, for the port's `_LoadFeeder`
(`testing/scenario.py`). Payloads and their order are those of the
tool's `TxFactory` for equal arguments and seed; signed payloads are
signed with the port's own keys (`crypto.keys.gen_priv_key`) and
envelopes (`mempool.ingress.make_signed_tx`)."""

from __future__ import annotations

import random
import threading


class TxFactory:
    """Payload maker with hot-key and duplicate skew. Hot keys model
    many users hammering the same state (`k<i>=` collides app-side);
    duplicates model gossip re-arrivals of the SAME tx bytes."""

    def __init__(self, payload: int, hot_keys: int, hot_prob: float,
                 dup_prob: float, signed: bool, signers: int, seed: int = 7):
        self._rng = random.Random(seed)
        self._payload = max(8, payload)
        self._hot_keys = max(0, hot_keys)
        self._hot_prob = hot_prob
        self._dup_prob = dup_prob
        self._recent: list[bytes] = []
        self._recent_lock = threading.Lock()
        self._privs = []
        if signed:
            from tendermint_tpu_torch.crypto.keys import gen_priv_key

            self._privs = [
                gen_priv_key(bytes([i % 256]) * 32) for i in range(max(1, signers))
            ]

    def make(self, n: int) -> bytes:
        rng = self._rng
        if self._dup_prob > 0 and rng.random() < self._dup_prob:
            with self._recent_lock:
                if self._recent:
                    return self._recent[rng.randrange(len(self._recent))]
        if self._hot_keys and rng.random() < self._hot_prob:
            key = b"hot%d" % rng.randrange(self._hot_keys)
        else:
            key = b"k%d" % n
        body = b"%s=%d;" % (key, n)
        body += b"x" * max(0, self._payload - len(body))
        if self._privs:
            from tendermint_tpu_torch.mempool.ingress import make_signed_tx

            tx = make_signed_tx(self._privs[n % len(self._privs)], body)
        else:
            tx = body
        with self._recent_lock:
            self._recent.append(tx)
            if len(self._recent) > 4096:
                self._recent.pop(0)
        return tx
