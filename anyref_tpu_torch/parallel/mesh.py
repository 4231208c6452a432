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

The sums over "model" inside the programs (every decoder layer's, the
embedding's, the logits', rephrase's head sum, the clipping norm's and the
backward's) go through the all-reduce op of ops/flash.py, not through the
backend: on a CUDA device ``make_mesh`` sets up the "model" group's device
exchange (csrc/all_reduce.cu: each rank's exchange area, the areas opened
by the other ranks through CUDA IPC, a kernel barrier that traps after
``make_mesh``'s ``timeout_s``, the process group's), so a CUDA graph holds
those sums and the programs compile on every mesh; on the CPU the op's
plain version all-reduces over the group. Ranks that share one card run by
time slices of its contexts. A rank's card may read the other ranks'
exchange areas until its last all-reduce ends, so every rank calls
``Mesh.close`` before it exits or destroys the process group: it
synchronises the card, meets the other ranks and frees the exchange.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from ..ops import flash
from ..params import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)
# how long a serving follower waits for the leader's next batch
SERVE_WAIT = datetime.timedelta(days=365)
# the default timeout of a process group's collectives, and of a wait in
# the all-reduce kernel
TIMEOUT_S = 300.0


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the grid. ``shape`` is {"data": D, "model": M}
    as the reference's ``mesh.shape``; ``coords`` this rank's {"data": d,
    "model": m}; ``groups`` the process group of each axis that this rank
    belongs to (the ranks sharing its other coordinate; None where the
    axis has size 1); ``host_group`` a gloo group over every rank for host
    objects (None on one rank); ``serve_group`` a gloo group over every
    rank with the SERVE_WAIT timeout, which carries only the Server's
    batches to its followers (serve.py; None on one rank); ``exchange``
    the "model" group's device exchange on this rank (ops/flash.py
    DeviceExchange; None off the card and without a "model" axis)."""
    shape: dict
    coords: dict
    device: torch.device
    groups: dict = field(default_factory=dict)
    host_group: Optional[object] = None
    serve_group: Optional[object] = None
    exchange: Optional[flash.DeviceExchange] = None

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

    def close(self) -> None:
        """Collective, once every rank has launched its last sum over the
        mesh and before any rank exits or destroys the process group: with
        a device exchange, synchronises the card, meets every rank over the
        host group and frees this rank's exchange (a peer's kernel reads
        it until that peer's last all-reduce ends); the "model" group
        leaves the all-reduce op, whose later calls with its key raise."""
        if self.exchange is not None and self.exchange.state is not None:
            torch.cuda.synchronize(self.device)
            dist.barrier(group=self.host_group)
            self.exchange.close()
        if MODEL_AXIS in self.groups:
            flash.unregister_group(self.groups[MODEL_AXIS])


def init_process_group(rank: int, world_size: int, init_method: str,
                       backend: str = "gloo",
                       timeout_s: float = TIMEOUT_S) -> None:
    """torch.distributed.init_process_group with a timeout: every
    collective that waits longer raises on the ranks still alive (give
    make_mesh the same ``timeout_s``)."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(data: Optional[int] = None, model: Optional[int] = None,
              device="cuda", timeout_s: float = TIMEOUT_S) -> Mesh:
    """The grid over every rank of the initialised process group (one
    rank, the 1 x 1 grid, without one), defaulted as the reference: model
    1 unless data is given, data the rest. Collective: every rank calls it,
    creating each axis's subgroups in the same order, and, with a "model"
    axis above 1, registering the "model" group with the all-reduce op
    and, on a CUDA device, setting up its device exchange, whose kernel
    traps after a wait of ``timeout_s`` (the process group's; every rank
    calls ``Mesh.close`` at its end). ``device`` is this rank's device
    (the card it runs on, or "cpu")."""
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
    exchange = None
    if model > 1:
        if dev.type == "cuda":
            exchange = _device_exchange(rank, model, dev, host, timeout_s)
        flash.register_group(groups[MODEL_AXIS], exchange)
    return Mesh(shape, coords, dev, groups, host, serve, exchange)


def _device_exchange(rank: int, model: int, dev: torch.device, host,
                     timeout_s: float) -> flash.DeviceExchange:
    """This rank's side of its "model" group's device exchange: its area
    made, every rank's IPC handle gathered over the host group, the other
    model ranks' areas opened. Collective over every rank."""
    exchange = flash.DeviceExchange(rank % model, model, dev, timeout_s)
    handles = [None] * dist.get_world_size()
    dist.all_gather_object(handles, exchange.handle, group=host)
    first = rank - rank % model
    exchange.open(handles[first:first + model])
    return exchange
