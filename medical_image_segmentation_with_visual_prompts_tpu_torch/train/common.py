"""Shared trainer machinery: the optimizers, their checkpoint state, the
teacher's EMA and the loss accumulators.

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

The pretraining trainers' optimizer is :func:`grouped_adamw`: one torch
param group per optax group of the JAX trainer's ``optax.multi_transform``
of schedule-driven ``adamw``s (phase 2: ``"base"`` and ``"prompt"``;
phase 1: ``"body"`` and, with encoder prompting, ``"prompt"``), its ``lr``
set from the group's schedule at the step count before each step, as
optax evaluates it.  :func:`grouped_adamw_leaves` /
:func:`load_grouped_adamw_leaves` carry its state as that
``multi_transform``'s leaves: per group, in sorted name order, ``[adam
count, mu..., nu..., schedule count]`` over the group's own flax leaves
(optax's ``MaskedNode`` placeholders of the other group's leaves have no
leaves); an empty group keeps its two counts.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

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


def _moments(optimizer, params, paths, key) -> List[np.ndarray]:
    """One flax-layout fp32 leaf per path: the state ``key`` of the
    parameters (zeros before the first step)."""
    arrays = {n: (optimizer.state[p][key] if optimizer.state.get(p)
                  else torch.zeros_like(p)).detach().to(
                      "cpu", torch.float32).numpy()
              for n, p in params.items()}
    return [np.ascontiguousarray(to_flax(parts, arrays), np.float32)
            for _, parts in paths]


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
    return [count, np.asarray(group["lr"], np.float32),
            np.asarray(group["weight_decay"], np.float32), count.copy(),
            *_moments(optimizer, params, paths, "exp_avg"),
            *_moments(optimizer, params, paths, "exp_avg_sq")]


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
    _set_state(optimizer, params, paths, float(int(leaves[3])),
               leaves[4:4 + n], leaves[4 + n:])


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for every optimized tensor the loss did not reach
    (the decoder prompt tokens under ``unetr_up_block: unetr``), so that it
    steps as optax steps it: weight decay, moments and count; torch's
    AdamW would skip it."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def _set_state(optimizer, params, paths, step: float, mus, nus) -> None:
    for (_, parts), mu, nu in zip(paths, mus, nus):
        for name, tf in parts:
            p = params[name]
            optimizer.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.array(from_flax(tf, mu))).to(p),
                "exp_avg_sq": torch.from_numpy(
                    np.array(from_flax(tf, nu))).to(p)}


def grouped_adamw(groups: Dict[str, Tuple[list, Callable, float]]
                  ) -> torch.optim.AdamW:
    """AdamW (the update of :func:`adamw`) over named groups: ``name ->
    (parameters, lr schedule, weight decay)``; a group may be empty."""
    return torch.optim.AdamW(
        [{"params": list(params), "name": name, "schedule": schedule,
          "lr": 0.0, "weight_decay": wd}
         for name, (params, schedule, wd) in sorted(groups.items())],
        lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def set_scheduled_lr(optimizer: torch.optim.AdamW, step: int) -> None:
    """Each group's lr from its schedule at ``step``, the count of steps
    taken (optax evaluates a schedule before it counts the step)."""
    for group in optimizer.param_groups:
        group["lr"] = group["schedule"](step)


def _group_layout(optimizer, model):
    """Per group, in sorted name order: (its parameters by name, their
    flax paths)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = []
    for group in sorted(optimizer.param_groups, key=lambda g: g["name"]):
        params = {names[id(p)]: p for p in group["params"]}
        out.append((params, flax_paths(model, params) if params else []))
    return out


def grouped_adamw_leaves(optimizer: torch.optim.AdamW, model, step: int
                         ) -> List[np.ndarray]:
    """The :func:`grouped_adamw` state after ``step`` steps as the JAX
    pretraining trainer's optax leaf list."""
    taken = {float(optimizer.state[p]["step"]) for g in optimizer.param_groups
             for p in g["params"] if optimizer.state.get(p)}
    if taken - {float(step)}:
        raise ValueError(f"parameters at steps {sorted(taken)}, not {step}")
    return _grouped_leaves(optimizer, model, step)


def _grouped_leaves(optimizer, model, step: int) -> List[np.ndarray]:
    leaves = []
    for params, paths in _group_layout(optimizer, model):
        count = np.asarray(step, np.int32)
        leaves += [count, *_moments(optimizer, params, paths, "exp_avg"),
                   *_moments(optimizer, params, paths, "exp_avg_sq"),
                   count.copy()]
    return leaves


def load_grouped_adamw_leaves(optimizer: torch.optim.AdamW, model, state
                              ) -> int:
    """Set the :func:`grouped_adamw` state from an optax leaf list (a
    pretraining checkpoint's ``optimizer_state_dict``); returns the step
    count."""
    leaves = restore_like(_grouped_leaves(optimizer, model, 0), state)
    counts, i = set(), 0
    for params, paths in _group_layout(optimizer, model):
        n = len(paths)
        counts |= {int(leaves[i]), int(leaves[i + 1 + 2 * n])}
        _set_state(optimizer, params, paths, float(int(leaves[i])),
                   leaves[i + 1:i + 1 + n], leaves[i + 1 + n:i + 1 + 2 * n])
        i += 2 + 2 * n
    if len(counts) != 1:
        raise ValueError(f"optimizer counts differ: {sorted(counts)}")
    return counts.pop()


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module,
               tau: float) -> None:
    """``teacher = tau * teacher + (1 - tau) * student`` over the
    parameters (not the BatchNorm statistics), in place: the in-place ops
    bump each parameter's version, which drops the teacher blocks' operand
    caches."""
    t, s = list(teacher.parameters()), list(student.parameters())
    if len(t) != len(s):
        raise ValueError("teacher and student differ in parameters")
    torch._foreach_mul_(t, tau)
    torch._foreach_add_(t, s, alpha=1.0 - tau)


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
