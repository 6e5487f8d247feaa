"""Ranks laid out as the JAX package's ('data', 'grid') mesh, and the
collectives the port runs over them.

Counterpart of ``sqtpu/parallel/mesh.py`` (:19-49). The JAX package puts
its devices in a ``(n_data, n_grid)`` array; here each device is a rank of
``torch.distributed``, launched by ``python -m torch.distributed.run``,
and rank r sits at data index r // n_grid and grid index r % n_grid
(data-major, as ``reshape(n_data, n_grid)``). Each rank belongs to two
process groups:

* the **data group**, the ranks with its grid index: they hold other rows
  of the global batch (the JAX batch sharding over 'data');
* the **grid group**, the ranks with its data index: they hold the same
  rows and sweep other column slabs of the implicit loss (the 'grid'
  axis).

A group of one rank is ``None``: a layout of one rank runs no collective
at all, and without the launcher's environment the port is one rank.

The backend follows one rule, chosen once (:func:`choose_backend`):
``nccl`` when each rank has a card of its own, ``gloo`` when ranks share a
card (NCCL refuses two ranks on one device) or run on the CPU. It never
switches after a failure. Every collective has the process group's
timeout, so a rank that dies ends the others' run with an error instead
of a hang.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0   # any collective that waits longer raises


@dataclass
class Layout:
    """This rank's place in the ('data', 'grid') layout, its device and
    its two process groups (``None`` where the group has one rank)."""

    rank: int = 0
    world: int = 1
    n_data: int = 1
    n_grid: int = 1
    device: torch.device = torch.device("cpu")
    backend: str = ""
    data_group: Optional[dist.ProcessGroup] = None
    grid_group: Optional[dist.ProcessGroup] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_grid

    @property
    def grid_index(self) -> int:
        return self.rank % self.n_grid

    @property
    def is_main(self) -> bool:
        """Rank 0 logs and writes the checkpoints."""
        return self.rank == 0

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch (the 'data' sharding), a
        multiple of the data axis (``utils.config.check_layout``)."""
        per = batch // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def launcher_world_size() -> int:
    """The world size the launcher set (``WORLD_SIZE``), 1 without it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def choose_backend(device: torch.device, ranks_on_host: int) -> str:
    """``nccl`` when each of the host's ranks has a card of its own,
    ``gloo`` when ranks share a card or run on the CPU. ``gloo`` reduces
    CUDA tensors through host memory."""
    if device.type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_layout(n_grid: int, device: torch.device,
                timeout_s: float = TIMEOUT_S) -> Layout:
    """The layout of this process from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``): joins the process group
    (:func:`join`) and builds the data and grid groups
    (:func:`make_layout`). One rank (no ``WORLD_SIZE``, or 1) joins
    nothing. The layout must fit the world (``utils.config.check_layout``
    checks it before training)."""
    if launcher_world_size() == 1:
        return Layout(device=device)
    return make_layout(n_grid, join(device, timeout_s))


def join(device: torch.device, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the launcher's process group with the backend of
    :func:`choose_backend`; returns this rank's device (a CUDA ``device``
    becomes the card ``LOCAL_RANK`` modulo the host's cards)."""
    world = launcher_world_size()
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        choose_backend(device, on_host), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def make_layout(n_grid: int, device: torch.device) -> Layout:
    """The ('data', 'grid') layout with ``n_grid`` ranks on the grid axis
    over the joined process group, with its data and grid groups. Every
    rank calls it, in the same order: each group is created by all."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n_data = world // n_grid
    layout = Layout(rank=rank, world=world, n_data=n_data, n_grid=n_grid,
                    device=device, backend=dist.get_backend())
    if n_data > 1:
        for g in range(n_grid):
            group = dist.new_group([d * n_grid + g for d in range(n_data)])
            if g == layout.grid_index:
                layout.data_group = group
    if n_grid > 1:
        for d in range(n_data):
            group = dist.new_group([d * n_grid + g for g in range(n_grid)])
            if d == layout.data_index:
                layout.grid_group = group
    return layout


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(layout: Layout) -> None:
    if layout.world > 1:
        dist.barrier()


def gather_objects(obj, layout: Layout) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if layout.world == 1:
        return [obj]
    out = [None] * layout.world
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over a group, differentiable: the backward sums the cotangents
    over the same group (every rank differentiates its copy of the
    result, and each input feeds every copy)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of ``x`` over ``group`` with autograd; ``x`` for no group."""
    return x if group is None else _AllReduceSum.apply(x, group)


class _SumGrad(torch.autograd.Function):
    """The identity forward; the backward sums the cotangent over a
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group`` in the backward."""
    return x if group is None else _SumGrad.apply(x, group)


def sum_value(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of ``x`` over ``group`` as the value, with the gradient of ``x``
    alone: the cotangent reaches this rank's ``x`` once, unsummed."""
    if group is None:
        return x
    total = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(total, group=group)
    return total + (x - x.detach())


def data_mean(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The mean of a per-rank batch mean over the data group, with
    autograd: equal shards make it the global batch's mean."""
    if layout.data_group is None:
        return x
    return all_reduce_sum(x, layout.data_group) / layout.n_data


@torch.no_grad()
def average_gradients(params, layout: Layout) -> None:
    """Mean of each ``.grad`` over the world, in place, through one flat
    buffer. Every rank differentiates its copy of the global loss, so the
    sum over the world is W times the gradient (see
    :class:`_AllReduceSum`) and the mean is the gradient itself."""
    if layout.world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= layout.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def broadcast_state(tensors, layout: Layout, src: int = 0) -> None:
    """Copy rank ``src``'s floating tensors (parameters or buffers) to
    every rank, in place, through one flat buffer."""
    if layout.world == 1:
        return
    tensors = [t for t in tensors if t.is_floating_point()]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=src)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
