"""State sync: snapshot store + chunk-sync reactor + trust anchoring.

A fresh node normally joins by fast-syncing every block
(`blockchain/reactor.py`) — O(chain length) replay. This subsystem lands
a node at a recent snapshot height instead: peers serve fixed-size
snapshot chunks whose Merkle tree is built AND verified through the
batched device hasher (`services/hasher.py`), and the snapshot's
app_hash is trusted only after its sealing commit passes the light-
client certifier (`certifiers/certifier.py`) from a configured trust
root. Fast-sync then takes over for the tail.

The port's copy of `tendermint_tpu/statesync/__init__.py`. The same
exports as the JAX package's `statesync`.
"""

from tendermint_tpu_torch.statesync.snapshot import (
    SnapshotManifest,
    SnapshotStore,
    build_payload,
    decode_payload,
)
from tendermint_tpu_torch.statesync.reactor import STATESYNC_CHANNEL, StateSyncReactor
from tendermint_tpu_torch.statesync.trust import TrustAnchor, TrustOptions

__all__ = [
    "STATESYNC_CHANNEL",
    "SnapshotManifest",
    "SnapshotStore",
    "StateSyncReactor",
    "TrustAnchor",
    "TrustOptions",
    "build_payload",
    "decode_payload",
]
