"""SimCLR NT-Xent pair loss.

Counterpart of the JAX package's ``losses/contrastive_pair.py``: the
2N x 2N cosine-similarity matrix of the two views' normalized codes
(norms clipped at 1e-12), positives on the +-N diagonals, negatives every
off-identity entry, temperature 0.5, mean over 2N.

``group`` (a ``parallel/mesh.py::DataGroup``): the codes are this rank's
rows of a data-parallel batch.  Both views' codes are gathered from every
rank (differentiably) into the global 2N x 2N matrix, and the rank takes
the terms of its own rows over 2N: the ranks' losses add up to the
global loss, and their gradients (the gather's backward sums over the
ranks) to its gradient.
"""

from __future__ import annotations

import torch


def contrastive_pair_loss(x_i: torch.Tensor, x_j: torch.Tensor,
                          temp: float = 0.5, group=None) -> torch.Tensor:
    """x_i, x_j: ``[bs, D]`` contrastive codes of the two views."""
    bs = x_i.shape[0]
    z_i = x_i / torch.linalg.vector_norm(x_i, dim=1,
                                         keepdim=True).clamp_min(1e-12)
    z_j = x_j / torch.linalg.vector_norm(x_j, dim=1,
                                         keepdim=True).clamp_min(1e-12)
    if group is not None and group.splits:
        return _global_pair_loss(z_i, z_j, temp, group)
    z = torch.cat([z_i, z_j], dim=0)                    # [2bs, D]
    sim = z @ z.T
    pos = torch.exp(torch.cat([torch.diagonal(sim, offset=bs),
                               torch.diagonal(sim, offset=-bs)]) / temp)
    eye = torch.eye(2 * bs, dtype=torch.bool, device=sim.device)
    neg = torch.exp(sim / temp).masked_fill(eye, 0.0)
    return torch.sum(-torch.log(pos / neg.sum(dim=1))) / (2 * bs)


def _global_pair_loss(z_i, z_j, temp: float, group) -> torch.Tensor:
    """This rank's share of the NT-Xent loss of the gathered batch."""
    b = z_i.shape[0]
    z = torch.cat([group.all_gather(z_i), group.all_gather(z_j)])
    n = z.shape[0] // 2                                 # global batch
    own = torch.arange(group.rank * b, (group.rank + 1) * b,
                       device=z.device)
    rows = torch.cat([own, own + n])                    # [2b] of [2n]
    sim = z[rows] @ z.T                                 # [2b, 2n]
    r = torch.arange(2 * b, device=z.device)
    pos = torch.exp(sim[r, (rows + n) % (2 * n)] / temp)
    neg = torch.exp(sim / temp).masked_fill(
        rows[:, None] == torch.arange(2 * n, device=z.device), 0.0)
    return torch.sum(-torch.log(pos / neg.sum(dim=1))) / (2 * n)
