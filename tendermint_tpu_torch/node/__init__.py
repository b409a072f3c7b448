"""Node composition root (reference `node/node.go:75-353`)."""

from tendermint_tpu_torch.node.node import Node

__all__ = ["Node"]
