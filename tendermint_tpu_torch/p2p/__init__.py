"""P2P communication backend (reference `p2p/`).

Host-side control plane: multiplexed prioritized channels over pluggable
byte transports (in-memory pipes for tests and local multi-node,
TCP-ready framing), a Reactor registry Switch, and network fault
injection. WAN gossip is latency-bound tiny-payload work, so this layer
stays on the host by design (SURVEY.md §5.8); the device plane lives in
`parallel/` and `ops/`.

The port's copy of `tendermint_tpu/p2p/__init__.py`, with the same
exports: `pex`, `addrbook` and `upnp` are imported from their modules,
which only the node and the command line reach.
"""

from tendermint_tpu_torch.p2p.connection import ChannelDescriptor, MConnection
from tendermint_tpu_torch.p2p.peer import NodeInfo, Peer
from tendermint_tpu_torch.p2p.score import PeerMisbehavior, PeerScorer
from tendermint_tpu_torch.p2p.switch import (
    Reactor,
    Switch,
    connect_switches,
    make_connected_switches,
)
from tendermint_tpu_torch.p2p.transport import FuzzedEndpoint, FuzzConfig, pipe_pair

__all__ = [
    "ChannelDescriptor",
    "MConnection",
    "NodeInfo",
    "Peer",
    "PeerMisbehavior",
    "PeerScorer",
    "Reactor",
    "Switch",
    "connect_switches",
    "make_connected_switches",
    "FuzzedEndpoint",
    "FuzzConfig",
    "pipe_pair",
]
