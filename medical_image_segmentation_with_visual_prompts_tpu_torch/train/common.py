"""Shared trainer machinery: the optimizer, its checkpoint state and the
loss accumulators.

Counterpart of the JAX package's ``train/common.py``.  The JAX trainers
split the parameters into (trainable, frozen) trees; here the frozen ones
carry ``requires_grad=False`` (``models/partition.py``) and the optimizer
holds the trainable ones.

:func:`adamw_leaves` and :func:`load_adamw_leaves` carry the optimizer
state across checkpoints in the JAX trainer's form: the flat leaves of
``optax.inject_hyperparams(adamw)(lr=, weight_decay=)`` over the
trainable subtree, ``[count, lr, weight_decay, adam count, mu..., nu...]``
with one ``mu`` and one ``nu`` per trainable flax leaf in the tree's leaf
order (``utils/torch_import.py::flax_paths``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

from ..utils.checkpoint import restore_like
from ..utils.torch_import import flax_paths, from_flax, to_flax


def adamw(params, lr: float, weight_decay: float) -> torch.optim.AdamW:
    """AdamW with betas 0.9/0.999, eps 1e-8 and decoupled weight decay:
    the same update as the JAX package's ``optax.adamw``."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def _optimized(optimizer, model) -> Dict[str, torch.nn.Parameter]:
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: p for g in optimizer.param_groups
            for p in g["params"]}


def adamw_leaves(optimizer: torch.optim.AdamW, model) -> List[np.ndarray]:
    """The optimizer's state as the JAX trainer's optax leaf list.  Before
    the first step the moments are zero and the counts 0."""
    params = _optimized(optimizer, model)
    steps = {float(optimizer.state[p]["step"]) for p in params.values()
             if optimizer.state.get(p)}
    if len(steps) > 1:
        raise ValueError(f"parameters at different steps: {sorted(steps)}")
    count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
    group = optimizer.param_groups[0]
    paths = flax_paths(model, params)

    def moments(key):
        arrays = {n: (optimizer.state[p][key] if optimizer.state.get(p)
                      else torch.zeros_like(p)).detach().to(
                          "cpu", torch.float32).numpy()
                  for n, p in params.items()}
        return [np.ascontiguousarray(to_flax(parts, arrays), np.float32)
                for _, parts in paths]

    return [count, np.asarray(group["lr"], np.float32),
            np.asarray(group["weight_decay"], np.float32), count.copy(),
            *moments("exp_avg"), *moments("exp_avg_sq")]


def load_adamw_leaves(optimizer: torch.optim.AdamW, model, state) -> None:
    """Set the optimizer's state from an optax leaf list (a checkpoint's
    ``optimizer_state_dict``): the hyperparameters of every group, and
    each trainable parameter's step and moments."""
    leaves = restore_like(adamw_leaves(optimizer, model), state)
    params = _optimized(optimizer, model)
    paths = flax_paths(model, params)
    n = len(paths)
    for group in optimizer.param_groups:
        group["lr"] = float(leaves[1])
        group["weight_decay"] = float(leaves[2])
    step = float(int(leaves[3]))
    for (_, parts), mu, nu in zip(paths, leaves[4:4 + n], leaves[4 + n:]):
        for name, tf in parts:
            p = params[name]
            optimizer.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.array(from_flax(tf, mu))).to(p),
                "exp_avg_sq": torch.from_numpy(
                    np.array(from_flax(tf, nu))).to(p)}


class AvgLosses:
    """Per-epoch loss accumulators (values are host floats)."""

    def __init__(self, names: Iterable[str]):
        self.store: Dict[str, list] = {n: [] for n in names}

    def append(self, name: str, value) -> None:
        self.store[name].append(float(value))

    def last(self, name: str) -> float:
        return self.store[name][-1]

    def mean_and_clear(self) -> Dict[str, float]:
        out = {}
        for name, vals in self.store.items():
            if vals:
                out[name] = float(np.mean(vals))
            vals.clear()
        return out
