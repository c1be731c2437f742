"""Data-parallel training and serving steps over a data group.

Counterpart of the JAX package's ``parallel/train_parallel.py``.  The JAX
steps are jitted with the batch sharded over the ``data`` mesh axis and
the parameters replicated; XLA inserts the gradient all-reduce.  Here
each rank is a process holding its rows of the global batch:

* :func:`data_parallel` wraps a model in ``DistributedDataParallel`` over
  its trainable parameters, with the module states broadcast from rank 0
  when it is built (the JAX ``replicate``), buffers left to the model
  (the data group's BatchNorm keeps them equal on every rank), unused
  trainable tensors allowed (the decoder prompt tokens under
  ``unetr_up_block: unetr``) and the gradients SUMMED over the ranks by a
  communication hook: each rank's loss is its share of the global loss,
  so the sum is the gradient of the global loss.  DDP's own hook would
  average.
* :func:`make_dp_train_step`: the downstream step (DiceFocal, gamma 4, on
  the labels remapped to ``active_labels``) of one optimizer step on a
  global batch; :func:`make_dp_serving_step`: the eval-mode forward of a
  global window batch, the logits gathered on every rank.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..losses import dice_focal_loss
from ..ops.augment import map_label_indices
from ..utils import trace
from .mesh import DataGroup, shard_batch


def _sum_hook(group, bucket):
    """DDP communication hook: all-reduce (sum) of the bucket, no mean."""
    import torch.distributed as dist
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


class Forwards(torch.nn.Module):
    """``model`` run on each of several inputs, in order, in one call:
    the pretraining steps' students (or views), so that DDP sees one
    forward per backward."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *xs):
        out = []
        for x in xs:
            with trace.span("train.forward"):
                out.append(self.model(x))
        return out


def data_parallel(model: torch.nn.Module, group: DataGroup):
    """``model`` (on its device, trainable tensors marked) wrapped in
    ``DistributedDataParallel`` over ``group``, gradients summed; the
    model itself where no process group was started (a world of one)."""
    if group.group is None:
        return model
    from torch.nn.parallel import DistributedDataParallel
    device = next(model.parameters()).device
    ddp = DistributedDataParallel(
        model, device_ids=[device.index if device.index is not None
                           else torch.cuda.current_device()]
        if device.type == "cuda" else None,
        process_group=group.group, broadcast_buffers=False,
        find_unused_parameters=True)
    ddp.register_comm_hook(group.group, _sum_hook)
    return ddp


def make_dp_train_step(model: torch.nn.Module, optimizer, group: DataGroup,
                       active_labels: Sequence[int],
                       include_background: bool = True) -> Callable:
    """``step(image, mask) -> loss``: one optimizer step on a global
    batch (every rank passes the same ``[B, ...]`` host or device arrays;
    ``B`` a multiple of the world size).  The model trains on this rank's
    rows as one rank of ``group`` (global BatchNorm moments, dropout at
    the global window index), the loss is the global batch's mean, and
    every rank steps with its gradient; returns the global loss."""
    model.set_data_group(group)
    net = data_parallel(model, group)
    device = next(model.parameters()).device
    active = tuple(active_labels)

    def step(image, mask):
        rows = shard_batch(group, {"image": image, "mask": mask})
        x = torch.as_tensor(rows["image"], device=device)
        seg = map_label_indices(torch.as_tensor(rows["mask"], device=device),
                                active)
        loss = dice_focal_loss(net(x), seg, gamma=4.0,
                               include_background=include_background,
                               group=group)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return group.sum(loss.detach())

    return step


def make_dp_serving_step(model: torch.nn.Module, group: DataGroup
                         ) -> Callable:
    """``serve(windows) -> logits``: the eval-mode forward of a window
    batch ``[N, *roi, C]`` (``N`` a multiple of the world size), each
    rank running its rows, the logits gathered on every rank."""
    model.eval()

    @torch.no_grad()
    def serve(windows):
        return group.gather(model(windows[group.rows(windows.shape[0])]))

    return serve
