"""Telemetry of the port's verify spine: the metric registry and the
metric catalog (`metrics.py`).

Counterpart of the pieces of `tendermint_tpu/telemetry/` that the
services layer calls, under the same metric names and label sets; the
port keeps its own process-wide registry. Import-cheap and
dependency-free.
"""

from tendermint_tpu_torch.telemetry.registry import REGISTRY

__all__ = ["REGISTRY"]
