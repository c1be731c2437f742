"""Process-group start and multi-process batch staging.

Counterpart of the JAX package's ``parallel/distributed.py``.  Its config
keys keep their meaning:

  distributed: true            # opt-in; default off (single process)
  coordinator_address: host:port
  num_processes: N             # omit to take torchrun's WORLD_SIZE
  process_id: i                # omit to take torchrun's RANK

:func:`maybe_initialize_distributed` starts the default process group
with ``init_process_group(init_method="tcp://<coordinator_address>",
world_size=num_processes, rank=process_id)``; keys left out come from
``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), the counterpart of ``jax.distributed``'s
autodetection.  It also starts one for ``mesh_data`` (``-1`` or more than
1) in a process that ``torchrun`` started.  The backend follows the
device: NCCL for CUDA, each rank on ``cuda:LOCAL_RANK`` (set before the
group starts; without ``LOCAL_RANK``, the rank modulo the cards), and
gloo for the CPU.  A process group that the caller started already is
used as it is.

:func:`stage_global_batch` is the multi-process staging of the JAX
package: each process holds local rows of the global batch; the ranks
wrap-pad theirs to a common length and mark the real rows in ``_valid``.
The trainers stage through ``train/common.py::DeviceCtx`` instead, where
every rank reads the same global batch and takes its rows.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import DataGroup, config_value, world


def wants_distributed(conf) -> bool:
    """``distributed: true``, or ``mesh_data`` asking for data parallel
    in a process that torchrun started."""
    if config_value(conf, "distributed", False):
        return True
    n = int(config_value(conf, "mesh_data", 0) or 0)
    return (n == -1 or n > 1) and "WORLD_SIZE" in os.environ


def _key(conf, key: str):
    val = config_value(conf, key)
    return None if val is None or val == "" else val


def maybe_initialize_distributed(conf, device="cpu") -> bool:
    """Start the default process group when the config asks for one;
    idempotent.  Returns True when the world has more than one process
    after the call."""
    import torch.distributed as dist
    if wants_distributed(conf) and not dist.is_initialized():
        env = os.environ
        rank = _key(conf, "process_id")
        rank = int(env.get("RANK", 0) if rank is None else rank)
        size = _key(conf, "num_processes")
        size = int(env.get("WORLD_SIZE", 1) if size is None else size)
        addr = _key(conf, "coordinator_address")
        if addr is None:
            addr = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                    f"{env.get('MASTER_PORT', '29500')}")
        cuda = torch.device(device).type == "cuda"
        if cuda:
            local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://{addr}",
                                world_size=size, rank=rank)
    return world()[0] > 1


def stage_global_batch(group: DataGroup, batch: dict, device="cpu",
                       exclude=("name",)) -> dict:
    """Multi-process staging: ``batch`` holds this process's LOCAL rows
    of the global batch.  The ranks wrap-pad their rows to the longest
    rank's count, so that every rank holds as many (the collectives need
    equal shapes), and ``_valid`` marks the real rows (1) against the
    padding (0).  Returns the rows as tensors on ``device``."""
    rows = next(len(v) for k, v in batch.items()
                if k not in exclude and hasattr(v, "shape"))
    n = torch.tensor([rows], device=device)
    if group.group is not None:
        import torch.distributed as dist
        dist.all_reduce(n, op=dist.ReduceOp.MAX, group=group.group)
    target = int(n.item())
    out = {}
    for k, v in batch.items():
        if k in exclude or not hasattr(v, "shape"):
            out[k] = v
            continue
        v = np.asarray(v)
        if target > rows:
            reps = -(-target // rows)
            v = np.concatenate([v] * reps)[:target]
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    valid = np.zeros((target,), np.float32)
    valid[:rows] = 1.0
    out["_valid"] = torch.from_numpy(valid).to(device)
    return out


def masked_mean(group: DataGroup, x: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
    """Mean of ``x`` ``[b, ...]`` over the real rows of every rank
    (``valid`` 1) -- the reduction the JAX package's multi-process test
    holds ``stage_global_batch`` to."""
    w = valid.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
    total = group.sum(torch.stack([(x * w).sum(),
                                   valid.to(x.dtype).sum() * x[0].numel()]))
    return total[0] / total[1]
