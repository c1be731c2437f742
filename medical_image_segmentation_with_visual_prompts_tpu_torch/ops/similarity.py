"""Prompt-token similarity aggregation and pseudo-mask generation.

Counterpart of the JAX package's ``ops/similarity.py``, its
``sinkhorn_knopp`` included.  No trainer calls these functions: they are
library surface for prompt-similarity analysis.
"""

from __future__ import annotations

import torch

from .augment import align_rotation, permute_inverse


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def similarity_aggregation(latent: torch.Tensor, prompt: torch.Tensor,
                           temp: float = 0.1,
                           mean_aggregation: bool = False) -> torch.Tensor:
    """Cosine similarity of latent voxels to prompt tokens, mapped to
    [0, 1] and aggregated over each prompt's tokens (softmax-weighted with
    the weights detached, or the mean).

    latent: ``[B, M, C]``; prompt: ``[B, I, N, C]`` (I prompts of N
    tokens).  Returns ``[B, I, M]``.
    """
    sim = (torch.einsum("bmc,binc->binm", _normalize(latent),
                        _normalize(prompt)) + 1.0) / 2.0
    if not mean_aggregation:
        weights = torch.softmax(sim.detach() / temp, dim=2)
        return torch.sum(weights * sim, dim=2)
    return torch.mean(sim, dim=2)


def generate_pseudo_mask_from_multi_view(latent: torch.Tensor,
                                         prompt: torch.Tensor,
                                         n_tokens: int, src_rot=None,
                                         dst_rot=None,
                                         permutation_choice=None
                                         ) -> torch.Tensor:
    """Pseudo-mask from prompt-token similarity maps.

    latent: ``[B, H, W, D, C]``; prompt: ``[B, I * n_tokens, C]``.
    Returns ``[B, H, W, D, I]`` similarity volumes, optionally
    un-permuted and rotation-aligned back to the source view.
    """
    b, h, w, d, c = latent.shape
    sim = similarity_aggregation(latent.reshape(b, -1, c),
                                 prompt.reshape(b, -1, n_tokens, c))
    pse = sim.reshape(b, sim.shape[1], h, w, d).permute(0, 2, 3, 4, 1)
    if permutation_choice is not None:
        pse = permute_inverse(pse, permutation_choice)
    if src_rot is not None or dst_rot is not None:
        pse = align_rotation(pse, src_rot=src_rot, dst_rot=dst_rot)
    return pse


def sinkhorn_knopp(q: torch.Tensor, num_iters: int = 3) -> torch.Tensor:
    """Sinkhorn-Knopp normalization of channels-last scores ``[B, H, W,
    D, C]``."""
    b, h, w, d, c = q.shape
    qf = q.reshape(b, h * w * d, c).transpose(1, 2)       # [B, C, M]
    qf = torch.exp(qf / torch.linalg.vector_norm(
        qf, dim=1, keepdim=True).clamp_min(1e-12))
    qf = qf / torch.sum(qf)
    for _ in range(num_iters):
        qf = qf / torch.sum(qf, dim=0, keepdim=True)
        qf = qf / c
        qf = qf / torch.sum(qf, dim=1, keepdim=True)
        qf = qf / b
    qf = qf * b
    return qf.transpose(1, 2).reshape(b, h, w, d, c)
