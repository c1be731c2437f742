"""Label remapping (counterpart of the JAX ``ops/augment.py``)."""

from __future__ import annotations

from typing import Sequence

import torch


def map_label_indices(masks: torch.Tensor,
                      active_labels: Sequence[int]) -> torch.Tensor:
    """Keep the active labels, zero the others, and renumber the active
    ones 0..K-1 in sorted order."""
    out = torch.zeros_like(masks)
    for new, lbl in enumerate(sorted(int(v) for v in active_labels)):
        out = torch.where(masks == float(lbl),
                          torch.full_like(masks, float(new)), out)
    return out
