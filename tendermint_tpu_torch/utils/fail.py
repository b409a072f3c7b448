"""Device fault injection (counterpart of the device-fault half of
`tendermint_tpu/utils/fail.py`).

Forces device backend calls (batch verify, device Merkle trees, comb
table construction) to raise deterministically, so the resilient
dispatch layer (`services/resilient.py`) can be driven through its
degrade -> probe -> recover cycle. Selected by the
TENDERMINT_TPU_DEVICE_FAIL env var — "verify", "hash", "tables" or
"all", with an optional per-kind budget: "verify:3" fails the first 3
verify dispatches then clears; comma-separate for several kinds — or at
run time through `set_device_fault()` / `clear_device_faults()`.

The armed faults are this module's own state: arming the JAX package's
module does not arm the port, though both read the same env var.
"""

from __future__ import annotations

import os


class InjectedDeviceFault(RuntimeError):
    """A test-injected device failure. The resilient layer degrades to
    host crypto on this (and on its own dispatch timeout) only: a real
    build, launch or CUDA error raises to the caller."""


_device_faults: dict[str, int] | None = None  # kind -> remaining (-1 = forever)


def _load_device_faults() -> dict[str, int]:
    global _device_faults
    if _device_faults is None:
        faults: dict[str, int] = {}
        spec = os.environ.get("TENDERMINT_TPU_DEVICE_FAIL", "")
        for part in filter(None, (p.strip() for p in spec.split(","))):
            kind, _, count = part.partition(":")
            faults[kind] = int(count) if count else -1
        _device_faults = faults
    return _device_faults


def set_device_fault(kind: str, count: int = -1) -> None:
    """Arm fault injection for `kind` ("verify"/"hash"/"tables"/"all");
    `count` dispatches fail (-1 = until cleared)."""
    _load_device_faults()[kind] = count


def clear_device_faults() -> None:
    global _device_faults
    _device_faults = {}


def device_fail_point(kind: str) -> None:
    """Raise InjectedDeviceFault when a fault is armed for `kind` (or
    "all"), consuming one unit of a bounded budget."""
    faults = _load_device_faults()
    for k in (kind, "all"):
        remaining = faults.get(k)
        if remaining is None or remaining == 0:
            continue
        if remaining > 0:
            faults[k] = remaining - 1
        raise InjectedDeviceFault(f"injected {kind} device fault")


class ShardDeviceFault(InjectedDeviceFault):
    """A device fault attributable to one shard of a mesh (the per-card
    counterpart of InjectedDeviceFault): the mesh layer catches it and
    re-meshes onto the survivors instead of tripping the whole verify
    breaker."""

    def __init__(self, shard: int):
        super().__init__(f"injected device fault on mesh shard {shard}")
        self.shard = shard


def shard_fail_point(indices) -> None:
    """Per-shard counterpart of `device_fail_point`: spec entries of the
    form "shard<i>" (optionally "shard<i>:<count>") fail launches whose
    active mesh includes shard `i`. Raises `ShardDeviceFault(i)` for the
    first armed index in `indices`, consuming one unit of its budget."""
    faults = _load_device_faults()
    if not faults:
        return
    for i in indices:
        remaining = faults.get(f"shard{i}")
        if remaining is None or remaining == 0:
            continue
        if remaining > 0:
            faults[f"shard{i}"] = remaining - 1
        raise ShardDeviceFault(i)


def shard_fault_armed(index: int) -> bool:
    """True while a fault is still armed for mesh shard `index` (the
    re-probe peeks without consuming budget)."""
    return bool(_load_device_faults().get(f"shard{index}"))
