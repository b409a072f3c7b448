"""Dedicated p2p transport identity key, separate from the validator
signing key.

The reference keeps the node's network identity distinct from the block
signing key so that (a) transport handshake signatures never share a key
with consensus signatures (no cross-protocol signing under the validator
key) and (b) remote-signer/HSM topologies — where the validator private
key never touches the network-facing host — can still run encrypted p2p.
The node id is the address (RIPEMD-160 of the pubkey) of THIS key, not
the validator's.

The port's copy of `tendermint_tpu/p2p/node_key.py`; the key file has
the same JSON form.
"""

from __future__ import annotations

import json
import os

from tendermint_tpu_torch.crypto import PrivKey, gen_priv_key


class NodeKey:
    """File-backed p2p identity key (`$TMHOME/config/node_key.json`)."""

    def __init__(self, priv_key: PrivKey):
        self.priv_key = priv_key

    @property
    def node_id(self) -> str:
        return self.priv_key.pub_key.address.hex()

    def save(self, file_path: str) -> None:
        tmp = file_path + ".tmp"
        os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
        # key material: owner-only from creation (reference WriteFileAtomic
        # 0600, `types/priv_validator.go`), never umask-dependent
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump({"priv_key_seed": self.priv_key.seed.hex()}, f)
        os.replace(tmp, file_path)

    @classmethod
    def load(cls, file_path: str) -> "NodeKey":
        with open(file_path) as f:
            doc = json.load(f)
        return cls(PrivKey(bytes.fromhex(doc["priv_key_seed"])))

    @classmethod
    def load_or_gen(cls, file_path: str, seed: bytes | None = None) -> "NodeKey":
        if os.path.exists(file_path):
            return cls.load(file_path)
        nk = cls(gen_priv_key(seed))
        nk.save(file_path)
        return nk
