"""Learning-rate schedules (counterpart of the JAX ``utils/schedules.py``)."""

from __future__ import annotations


def step_decay(base_lr: float, step_size: int = 100, gamma: float = 0.8):
    """torch StepLR semantics, stepped per epoch by the downstream
    trainer: ``lr = base_lr * gamma ** (epoch // step_size)``."""

    def schedule(epoch) -> float:
        return base_lr * gamma ** (int(epoch) // step_size)

    return schedule
