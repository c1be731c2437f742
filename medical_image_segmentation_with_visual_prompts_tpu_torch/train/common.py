"""Shared trainer machinery: the optimizer and the loss accumulators.

Counterpart of the JAX package's ``train/common.py``.  The JAX trainers
split the parameters into (trainable, frozen) trees; here the frozen ones
carry ``requires_grad=False`` (``models/partition.py``) and the optimizer
holds the trainable ones.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch


def adamw(params, lr: float, weight_decay: float) -> torch.optim.AdamW:
    """AdamW with betas 0.9/0.999, eps 1e-8 and decoupled weight decay:
    the same update as the JAX package's ``optax.adamw``."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


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
