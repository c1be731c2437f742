"""Decomposed per-axis relative positional bias with prompt-token bias.

Counterpart of the JAX package's ``models/relative_pe.py``: per-axis
embeddings ``[2*win-1, E]`` indexed by clamped relative distances,
projected per head, averaged over the three axes (/3) and scaled by
``E**-0.5``; prompt-token COLUMNS get ``weights_token . enc_token``
scores, token ROWS (and the token-token block) stay 0.

The token parameters exist whether or not prompting is on, as in the
reference (checkpoint schema); the ``relative_dist_*`` index tables are
non-persistent buffers, rebuilt from the geometry and never exported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn


def relative_index(max_abs_pos: int, max_cap_dist: int) -> np.ndarray:
    """Clamped relative-distance index table ``[max_abs_pos, max_abs_pos]``."""
    pos = np.arange(max_abs_pos, dtype=np.int64)
    rel = pos.reshape(1, -1) - pos.reshape(-1, 1)
    return np.clip(rel + max_cap_dist - 1, 0, (max_cap_dist - 1) * 2)


class RelativePE(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 max_abs_pos: Sequence[int], max_cap_dist: Sequence[int],
                 max_prompts: int, tokens_per_prompt: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        for name, cap, ap in zip("hwd", max_cap_dist, max_abs_pos):
            setattr(self, f"enc_content_{name}",
                    nn.Parameter(torch.empty(2 * cap - 1, embed_dim)))
            setattr(self, f"weights_content_{name}",
                    nn.Parameter(torch.empty(num_heads, embed_dim)))
            self.register_buffer(f"relative_dist_{name}",
                                 torch.from_numpy(relative_index(ap, cap)),
                                 persistent=False)
        self.enc_token = nn.ParameterList(
            [nn.Parameter(torch.empty(tokens_per_prompt, embed_dim))
             for _ in range(max_prompts)])
        self.weights_token = nn.Parameter(torch.empty(num_heads, embed_dim))

    @property
    def scale(self) -> float:
        return self.embed_dim ** -0.5

    def axis_tables(self, dim_h: int, dim_w: int, dim_d: int):
        """The per-axis tables ``[heads, dim, dim]`` of the content bias
        (rows, columns, depth)."""
        axes = []
        for name, dim in zip("hwd", (dim_h, dim_w, dim_d)):
            idx = getattr(self, f"relative_dist_{name}")[:dim, :dim]
            emb = getattr(self, f"enc_content_{name}")[idx]      # [dim, dim, E]
            axes.append(torch.einsum("hc,nmc->hnm",
                                     getattr(self, f"weights_content_{name}"),
                                     emb))
        return tuple(axes)

    def forward(self, dim_h: int, dim_w: int, dim_d: int,
                dim_i: int = 0, axes=None) -> torch.Tensor:
        """Bias ``[heads, n + dim_i, n + dim_i]``, n = dim_h*dim_w*dim_d
        (fp32), from ``axes`` (:meth:`axis_tables`) when given."""
        scale = self.scale
        if axes is None:
            axes = self.axis_tables(dim_h, dim_w, dim_d)
        row, col, dep = axes
        content = (row[:, :, None, None, :, None, None]
                   + col[:, None, :, None, None, :, None]
                   + dep[:, None, None, :, None, None, :]) / 3.0
        n = dim_h * dim_w * dim_d
        content = content.reshape(self.num_heads, n, n) * scale
        if dim_i == 0:
            return content
        token_emb = torch.cat(list(self.enc_token))[:dim_i]
        token_scores = torch.einsum("hc,nc->hn", self.weights_token,
                                    token_emb) * scale
        total = content.new_zeros(self.num_heads, n + dim_i, n + dim_i)
        total[:, :n, :n] = content
        total[:, :n, n:] = token_scores[:, None, :]
        return total
