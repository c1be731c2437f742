"""SimCLR NT-Xent pair loss.

Counterpart of the JAX package's ``losses/contrastive_pair.py``: the
2N x 2N cosine-similarity matrix of the two views' normalized codes
(norms clipped at 1e-12), positives on the +-N diagonals, negatives every
off-identity entry, temperature 0.5, mean over 2N.
"""

from __future__ import annotations

import torch


def contrastive_pair_loss(x_i: torch.Tensor, x_j: torch.Tensor,
                          temp: float = 0.5) -> torch.Tensor:
    """x_i, x_j: ``[bs, D]`` contrastive codes of the two views."""
    bs = x_i.shape[0]
    z_i = x_i / torch.linalg.vector_norm(x_i, dim=1,
                                         keepdim=True).clamp_min(1e-12)
    z_j = x_j / torch.linalg.vector_norm(x_j, dim=1,
                                         keepdim=True).clamp_min(1e-12)
    z = torch.cat([z_i, z_j], dim=0)                    # [2bs, D]
    sim = z @ z.T
    pos = torch.exp(torch.cat([torch.diagonal(sim, offset=bs),
                               torch.diagonal(sim, offset=-bs)]) / temp)
    eye = torch.eye(2 * bs, dtype=torch.bool, device=sim.device)
    neg = torch.exp(sim / temp).masked_fill(eye, 0.0)
    return torch.sum(-torch.log(pos / neg.sum(dim=1))) / (2 * bs)
