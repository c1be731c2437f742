"""Dice, Focal and DiceFocal segmentation losses (MONAI semantics).

Counterpart of the JAX package's ``losses/dice.py``: softmax over the
class channel, one-hot target, optional background-channel drop,
per-(batch, class) dice over the spatial dims with ``smooth_nr =
smooth_dr = 1e-5``, mean reduction; focal term ``-(1 - p_t)^gamma *
log(p_t)`` on the softmax probabilities (clipped to [1e-8, 1]) with mean
reduction; DiceFocal = dice + focal.

Layout: channels-last -- ``preds`` are logits ``[B, ..., C]``, ``target``
integer labels ``[B, ..., 1]`` or ``[B, ...]``.  ``sample_weights``
(``[B]``) turns each batch mean into a weighted mean over the samples.

``group`` (a ``parallel/mesh.py::DataGroup``): the batch is this rank's
rows of a global batch, and each mean is over the global batch: the
rank's weighted sum over the global sum of the weights (the sample
count without weights), so that the ranks' losses add up to the global
loss and their gradients to its gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _prep(preds: torch.Tensor, target: torch.Tensor,
          include_background: bool):
    num_classes = preds.shape[-1]
    p = torch.softmax(preds.float(), dim=-1)
    if target.shape[-1] == 1 and target.dim() == preds.dim():
        target = target[..., 0]
    t = F.one_hot(target.long(), num_classes).to(p.dtype)
    if not include_background:
        p, t = p[..., 1:], t[..., 1:]
    return p, t


def _wmean_over_batch(per_sample: torch.Tensor, w, group=None
                      ) -> torch.Tensor:
    if group is not None and not group.splits:
        group = None
    if w is None and group is None:
        return per_sample.mean()
    rest = tuple(range(1, per_sample.dim()))
    per_sample = per_sample.mean(rest) if rest else per_sample
    if w is None:
        total = per_sample.new_tensor(float(per_sample.shape[0]))
        return per_sample.sum() / group.sum(total)
    w = w.to(per_sample.dtype)
    total = w.sum() if group is None else group.sum(w.sum())
    return (per_sample * w).sum() / total.clamp_min(1e-8)


def dice_loss(preds, target, include_background: bool = True,
              smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
              sample_weights=None, group=None) -> torch.Tensor:
    p, t = _prep(preds, target, include_background)
    spatial = tuple(range(1, p.dim() - 1))
    intersection = (p * t).sum(spatial)
    denom = p.sum(spatial) + t.sum(spatial)
    dice = 1.0 - (2.0 * intersection + smooth_nr) / (denom + smooth_dr)
    return _wmean_over_batch(dice, sample_weights, group)


def focal_loss(preds, target, gamma: float = 2.0,
               include_background: bool = True,
               sample_weights=None, group=None) -> torch.Tensor:
    p, t = _prep(preds, target, include_background)
    p = p.clamp(1e-8, 1.0)
    loss = -t * (1.0 - p) ** gamma * torch.log(p)
    return _wmean_over_batch(loss, sample_weights, group)


def dice_focal_loss(preds, target, gamma: float = 4.0,
                    include_background: bool = True,
                    lambda_dice: float = 1.0, lambda_focal: float = 1.0,
                    sample_weights=None, group=None) -> torch.Tensor:
    return (lambda_dice * dice_loss(preds, target, include_background,
                                    sample_weights=sample_weights,
                                    group=group)
            + lambda_focal * focal_loss(preds, target, gamma,
                                        include_background,
                                        sample_weights=sample_weights,
                                        group=group))
