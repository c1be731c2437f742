"""Data-parallel group: one process per device, batches split by rows.

Counterpart of the JAX package's ``parallel/mesh.py``.  The JAX package
builds a 1-D ``data`` mesh over the devices of one program and lets XLA
insert the collectives from the shardings.  PyTorch runs one process per
device: the mesh becomes a :class:`DataGroup` (the world size, this
process's rank, the ``torch.distributed`` process group), each rank holds
rows ``[rank * b, (rank + 1) * b)`` of a global batch of ``world * b``
rows, and the collectives are explicit:

* :meth:`DataGroup.sum` and :meth:`DataGroup.gather`: an all-reduce
  (sum) and an all-gather along axis 0, without gradient;
* :meth:`DataGroup.all_sum` and :meth:`DataGroup.all_gather`: the same
  as ``torch.autograd.Function``s.  The backward of the sum is the sum
  of the output gradients over the ranks; that of the gather is the sum
  of the output gradients over the ranks, cut to this rank's rows.  With
  every rank's loss its share of the global loss (so that the shares add
  up to it), summing the parameter gradients over the ranks gives the
  gradient of the global loss, as the JAX program computes it.

A world of one runs the same code: over a process group of one rank
(``distributed: true`` with ``num_processes: 1``) the collectives run as
they would over more, and in a process that no group was started for
(:func:`make_mesh` with ``-1``) each collective is the identity.  Where
one rank holds the whole batch (:attr:`DataGroup.splits` false), the
moments and means are taken as one process takes them, to the bit.
"""

from __future__ import annotations

from typing import Iterable

import torch


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world, rank):
        import torch.distributed as dist
        ctx.group, ctx.world, ctx.rank = group, world, rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.world)[ctx.rank].contiguous(), None, None, None


class DataGroup:
    """The ranks that split a batch: ``world`` processes, this one's
    ``rank``, and the process group (None in a process that no group was
    started for: a world of one whose collectives are the identity)."""

    def __init__(self, world: int = 1, rank: int = 0, group=None):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        if world > 1 and group is None:
            raise ValueError("a world of more than one needs a process group")
        self.world, self.rank, self.group = world, rank, group

    def __repr__(self) -> str:
        return f"DataGroup(world={self.world}, rank={self.rank})"

    @property
    def splits(self) -> bool:
        """Whether the batch is split over more than one rank: with one
        rank its rows are the global batch, and the moments and means
        are taken as one process takes them (the same bits)."""
        return self.world > 1

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes logs, summaries and checkpoints."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n`` (a multiple of the world size)."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) of ``t`` over the ranks, without gradient."""
        if self.group is None:
            return t
        import torch.distributed as dist
        t = t.detach().contiguous().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable all-reduce (sum)."""
        return t if self.group is None else _AllSum.apply(t, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated on axis 0 in
        rank order, without gradient."""
        if self.group is None:
            return t
        import torch.distributed as dist
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable :meth:`gather`."""
        return t if self.group is None else _AllGather.apply(
            t, self.group, self.world, self.rank)

    def broadcast(self, tensors: Iterable[torch.Tensor]) -> None:
        """Rank 0's values into every rank's ``tensors``, in place."""
        if self.group is None:
            return
        import torch.distributed as dist
        for t in tensors:
            dist.broadcast(t.data, src=0, group=self.group)


def world() -> tuple:
    """(world size, rank) of the default process group, or (1, 0)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_data: int = -1) -> DataGroup:
    """The data group of ``n_data`` processes: ``-1`` is the whole world
    (the default process group, or this process alone when none was
    started), as the JAX ``-1`` is all devices; any other count must be
    the world size (one process per device)."""
    size, rank = world()
    n = size if n_data == -1 else int(n_data)
    if n != size:
        raise ValueError(
            f"mesh_data: {n_data} asks for {n} data-parallel processes, "
            f"but the world has {size} (one process per device: start "
            f"{n} ranks, e.g. torchrun --nproc-per-node {n}, or set "
            f"mesh_data: -1)")
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return DataGroup()
    return DataGroup(size, rank, dist.group.WORLD)


def config_value(conf, key: str, default=None):
    """``conf[key]`` of a config mapping or ``conf.key`` of a namespace."""
    if isinstance(conf, dict):
        return conf.get(key, default)
    return getattr(conf, key, default)


def mesh_of(conf):
    """The data group that a config's ``mesh_data`` asks for (``-1`` or
    more than 1; raises when it is not the world size), else None."""
    n = int(config_value(conf, "mesh_data", 0) or 0)
    return make_mesh(n) if n == -1 or n > 1 else None


def shard_batch(group: DataGroup, batch: dict) -> dict:
    """This rank's rows of every array of a global batch (axis 0); other
    values as they are."""
    return {k: v[group.rows(v.shape[0])]
            if hasattr(v, "shape") and len(v.shape) > 0 else v
            for k, v in batch.items()}


def replicate(group: DataGroup, tensors) -> None:
    """Rank 0's values into every rank's copy: a module's parameters and
    buffers, or an iterable of tensors (in place)."""
    if isinstance(tensors, torch.nn.Module):
        tensors = [*tensors.parameters(), *tensors.buffers()]
    group.broadcast(list(tensors))

