"""Multi-host seam over `torch.distributed` (counterpart of
`tendermint_tpu/parallel/distributed.py`).

Every host runs the same program. `initialize` joins the processes into
one process group (NCCL between cards, gloo for CPU shards), and each
process builds its mesh over its own cards with `global_batch_mesh`: a
mesh whose tallies all-reduce (SUM) over the group after the local sum.
Each process verifies only its own lanes and reads only its own
verdicts, and every process reads the global tally — the counterpart of
the JAX package's process-spanning mesh and its psum:

    # on every host (same code, per-host rank):
    from tendermint_tpu_torch.parallel import distributed as dist
    dist.initialize(coordinator="host0:8476", num_processes=4, process_id=rank)
    mesh = dist.global_batch_mesh()
    placed = [dist.host_local_to_global(mesh, BATCH_AXIS, a) for a in my_rows]
    ok, total = mesh.verify_step()(*placed)   # total: the global tally

Every process must run the same sequence of tallied steps, since each
tally is a collective.
"""

from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve_device
from tendermint_tpu_torch.parallel.mesh import BATCH_AXIS, MeshManager, place_shards

_init_mode: str | None = None  # None | "local" | "multi"


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> None:
    """Join this process to the multi-host process group.

    A no-op with no arguments in a single-process setup, so call sites
    run the same code on one host or many. Idempotent for the same mode;
    a multi-host request after a local init raises instead of running
    local-only (every host would otherwise verify just its own lanes
    while believing its tally global). In multi mode this calls
    `torch.distributed.init_process_group` with
    `init_method="tcp://" + coordinator`, NCCL on the card and gloo with
    `device="cpu"`."""
    global _init_mode
    want_multi = coordinator is not None or (num_processes is not None and num_processes > 1)
    if _init_mode is not None:
        if want_multi and _init_mode == "local":
            raise RuntimeError(
                "distributed.initialize: already initialized single-process; "
                "multi-host init must happen before any local initialize()"
            )
        return
    if not want_multi:
        _init_mode = "local"  # single process: nothing to join
        return
    import torch.distributed as tdist

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    tdist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )
    _init_mode = "multi"


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) for a single process."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def global_batch_mesh(device=None) -> MeshManager:
    """This process's mesh over its own cards (or its CPU shards with
    `device="cpu"`), whose tallies all-reduce over the process group
    when `initialize` joined one."""
    return MeshManager(device=device, spans_processes=_init_mode == "multi")


def host_local_to_global(mesh: MeshManager, spec, host_local):
    """Place this host's rows on its mesh: `spec` BATCH_AXIS splits the
    rows over the active shards, one contiguous block a shard (the
    layout the steps take); None puts the whole array on every shard.
    Returns one tensor a shard, which the mesh steps take in place of a
    host array. The port's own spec: `PartitionSpec` is JAX's."""
    devices = mesh.active_devices()
    if spec == BATCH_AXIS:
        return place_shards(host_local, devices)
    if spec is None:
        t = host_local if isinstance(host_local, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(host_local))
        return [t.to(dev) for dev in devices]
    raise ValueError(f"unknown spec {spec!r}: expected {BATCH_AXIS!r} or None")
