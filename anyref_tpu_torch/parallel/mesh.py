"""The ("data", "model") grid of ranks (port of anyref_tpu/parallel/mesh.py).

The reference places one program on a mesh of devices; the port runs one
process per rank, each calling its local ops, with torch.distributed
collectives where the reference's compiler inserts them. Ranks are laid out
as the reference's device array reshaped (data, model): rank = d * model +
m. Data parallelism splits a batch's rows over "data"; tensor parallelism
splits the LLaMA decoder over "model" (parallel/partition.py).

The backend is the caller's: ``gloo`` for CPU tensors and for ranks that
share one card (gloo reduces CUDA tensors through the host), ``nccl`` for
ranks on distinct cards (NCCL refuses two ranks on one device). Every
process group gets a timeout, so a rank that dies fails the others instead
of hanging them; the one exception is the group on which the serving
followers wait for the leader's next batch (``serve_group``), whose
timeout is a year, since a Server may be idle for as long as it likes.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from ..params import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)
# how long a serving follower waits for the leader's next batch
SERVE_WAIT = datetime.timedelta(days=365)


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the grid. ``shape`` is {"data": D, "model": M}
    as the reference's ``mesh.shape``; ``coords`` this rank's {"data": d,
    "model": m}; ``groups`` the process group of each axis that this rank
    belongs to (the ranks sharing its other coordinate; None where the
    axis has size 1); ``host_group`` a gloo group over every rank for host
    objects (None on one rank); ``serve_group`` a gloo group over every
    rank with the SERVE_WAIT timeout, which carries only the Server's
    batches to its followers (serve.py; None on one rank)."""
    shape: dict
    coords: dict
    device: torch.device
    groups: dict = field(default_factory=dict)
    host_group: Optional[object] = None
    serve_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def rank(self) -> int:
        return (self.coords[DATA_AXIS] * self.shape[MODEL_AXIS]
                + self.coords[MODEL_AXIS])

    def group(self, axis: str):
        """The process group over ``axis`` (None where it has size 1)."""
        return self.groups.get(axis) if self.shape[axis] > 1 else None


def model_parallel(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` has a "model" axis above 1. Such a mesh's programs
    hold the axis's collectives in every decoder layer, which gloo cannot
    capture, so they run from the host; every other mesh's programs hold
    none and are captured on every rank (eval/runner.py,
    train/trainer.py)."""
    return mesh is not None and mesh.shape[MODEL_AXIS] > 1


def init_process_group(rank: int, world_size: int, init_method: str,
                       backend: str = "gloo",
                       timeout_s: float = 300.0) -> None:
    """torch.distributed.init_process_group with a timeout: every
    collective that waits longer raises on the ranks still alive."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(data: Optional[int] = None, model: Optional[int] = None,
              device="cuda") -> Mesh:
    """The grid over every rank of the initialised process group (one
    rank, the 1 x 1 grid, without one), defaulted as the reference: model
    1 unless data is given, data the rest. Collective: every rank calls it,
    creating each axis's subgroups in the same order. ``device`` is this
    rank's device (the card it runs on, or "cpu")."""
    dev = resolve_device(device)
    distributed = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    if model is None:
        model = 1 if data is None else n // data
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    shape = {DATA_AXIS: data, MODEL_AXIS: model}
    coords = {DATA_AXIS: rank // model, MODEL_AXIS: rank % model}
    if n == 1:
        return Mesh(shape, coords, dev)
    members = {
        DATA_AXIS: [[d * model + m for d in range(data)]
                    for m in range(model)],
        MODEL_AXIS: [[d * model + m for m in range(model)]
                     for d in range(data)]}
    groups = {axis: dist.new_subgroups_by_enumeration(members[axis])[0]
              for axis in AXES if shape[axis] > 1}
    host = (dist.group.WORLD if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo"))
    serve = dist.new_group(backend="gloo", timeout=SERVE_WAIT)
    return Mesh(shape, coords, dev, groups, host, serve)
