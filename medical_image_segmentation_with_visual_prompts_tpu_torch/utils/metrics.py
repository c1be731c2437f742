"""Segmentation metrics: per-class statistics and the MeanIoU and
DiceCoefficient accumulators.

Counterpart of the JAX package's ``utils/metrics.py``: argmax over the
class channel, per-class running intersection and union across updates,

* MeanIoU.compute = mean_c I_c / (U_c + 1e-6), U = |P| + |T| - I
* Dice.compute    = mean_c 2 I_c / (S_c + 1e-6), S = |P| + |T|

:func:`seg_stats` runs on the logits' device; only the three
``[num_classes]`` vectors reach the host.
"""

from __future__ import annotations

import numpy as np
import torch


def seg_stats(preds: torch.Tensor, target: torch.Tensor, num_classes: int,
              sample_weights=None):
    """Per-class (intersection, pred_sum, target_sum), three fp32
    ``[num_classes]`` tensors, from logits ``[B, ..., num_classes]`` and
    labels ``[B, ...]`` or ``[B, ..., 1]``."""
    pred = preds.argmax(-1)
    target = target.reshape(pred.shape).long()
    classes = torch.arange(num_classes, device=pred.device)
    p1 = (pred[..., None] == classes).float()
    t1 = (target[..., None] == classes).float()
    axes = tuple(range(1, pred.dim()))
    inter, psum, tsum = ((p1 * t1).sum(axes), p1.sum(axes), t1.sum(axes))
    if sample_weights is not None:
        w = sample_weights.float()[:, None]
        inter, psum, tsum = inter * w, psum * w, tsum * w
    return inter.sum(0), psum.sum(0), tsum.sum(0)


class _SegMetric:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        self.intersection = np.zeros(self.num_classes, dtype=np.float64)
        self.union = np.zeros(self.num_classes, dtype=np.float64)

    def update_stats(self, intersection, pred_sum, target_sum) -> None:
        raise NotImplementedError

    def update(self, preds, target) -> None:
        self.update_stats(*(t.cpu().numpy() for t in
                            seg_stats(preds, target, self.num_classes)))


class MeanIoU(_SegMetric):
    def update_stats(self, intersection, pred_sum, target_sum) -> None:
        self.intersection += intersection
        self.union += pred_sum + target_sum - intersection

    def compute(self) -> float:
        return float(np.mean(self.intersection / (self.union + 1e-6)))


class DiceCoefficient(_SegMetric):
    def update_stats(self, intersection, pred_sum, target_sum) -> None:
        self.intersection += intersection
        self.union += pred_sum + target_sum

    def compute(self) -> float:
        return float(np.mean(2.0 * self.intersection / (self.union + 1e-6)))
