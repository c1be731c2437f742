"""Learning-rate schedules (counterpart of the JAX ``utils/schedules.py``).

Plain Python functions of the step (or epoch) count; a trainer sets each
optimizer group's ``lr`` from them before the optimizer's step.
"""

from __future__ import annotations

import math


def warmup_cosine(base_lr: float, warmup_steps: int, t_total: int,
                  cycles: float = 0.5):
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then cosine
    decay to 0 at ``t_total`` (clamped at 0), with the JAX schedule's
    ``max(1, warmup_steps)`` and ``max(1, t_total - warmup_steps)``
    guards.  ``schedule(0)`` is 0: the first step moves only the
    moments."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(1.0, float(warmup_steps))
        progress = (step - warmup_steps) / float(max(1, t_total
                                                     - warmup_steps))
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(
            math.pi * float(cycles) * 2.0 * progress)))

    return schedule


def step_decay(base_lr: float, step_size: int = 100, gamma: float = 0.8):
    """torch StepLR semantics, stepped per epoch by the downstream
    trainer: ``lr = base_lr * gamma ** (epoch // step_size)``."""

    def schedule(epoch) -> float:
        return base_lr * gamma ** (int(epoch) // step_size)

    return schedule
