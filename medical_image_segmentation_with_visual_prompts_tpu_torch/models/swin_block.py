"""Prompted shifted-window Swin transformer blocks.

Counterpart of the JAX package's ``models/swin_block.py`` on its fused-
block path.  A block pads to window multiples (or pad-folds, below),
rolls for the shift and partitions into dilated windows (one gather,
outside the kernel: ``ops/windows.py::gather_indices``), runs the whole
block body in one call of ``ops/fused_block.py::fused_swin_block`` (LN1
-> attention over content queries and content + extra keys -> proj ->
LN2 -> single-Linear MLP), then gathers back and crops.

Pad folding (the JAX ``swin_block.py:359-380`` decision): axes whose
feature extent is smaller than the window are not padded; the identical
pad tokens of every window fold into one virtual key column whose bias
is the logsumexp of their positional biases (no shift, ``FOLD_KEY``) or
``ln(n_pad)`` with a zero key (shift, ``FOLD_COUNT``).  It applies only
when the folded axes are the only padding and the pad split is
symmetric; other geometries pad materially.

Everything a block call needs besides ``x`` -- the assembled bias
``[H, M, N]``, the labels ``[P, N]`` and the extra K/V rows -- depends
only on the parameters and the geometry.  Without grad it is built once
per geometry and cached (the counterpart of the JAX ``bias_cache``); the
cache is dropped when any parameter or the prompt tokens change.  With
grad enabled it is built on every call and keeps its graph, so the
gradient reaches the prompt tokens and the positional-bias parameters.

Training: in train mode with a nonzero rate, each block call draws two
uint32 dropout seeds from the generator :meth:`set_dropout_generator`
gave it (the counterpart of the JAX ``make_rng("dropout")``) and the
fused block applies counter-based attention and projection dropout.
``use_checkpoint`` needs no ``torch.utils.checkpoint`` here: the block's
autograd Function already saves only its inputs (the windowed ``x``, the
operands, the labels and the seeds) and recomputes the rest in the
backward kernel, which is what the JAX package's per-block remat buys;
the gathers around it save indices only.  So a training step runs the
forward kernel once and the backward kernel once per block (the JAX
package's remat runs its forward kernel twice).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_block import (FOLD_COUNT, FOLD_KEY, FOLD_NONE, NO_DROPOUT,
                               Dropout, block_reference, fused_swin_block,
                               labels_tensor, make_operands)
from ..ops.windows import (compute_paddings, content_indices, fold_geometry,
                           gather_indices, get_attn_labels, unpad_paddings)
from .patch_merging import PatchMerging
from .relative_pe import RelativePE


class WindowAttention(nn.Module):
    """Parameter holder with the reference's names (bias-free q/k/v,
    biased output projection); the attention itself runs in the block."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError("WindowAttention: The dimension is not "
                             "compatible with the number of heads!")
        self.num_heads = num_heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)


def _pad5(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Zero-pad the spatial axes of ``[B, H, W, D, C]`` by (lo, hi) x 3."""
    return F.pad(x, (0, 0, pads[4], pads[5], pads[2], pads[3],
                     pads[0], pads[1]))


def _crop5(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    return x[:, pads[0]: x.shape[1] - pads[1], pads[2]: x.shape[2] - pads[3],
             pads[4]: x.shape[3] - pads[5]]


class SwinTransformerBlock(nn.Module):
    def __init__(self, hidden_channels: int, window_size: Sequence[int],
                 pos_bias_embed_dim: int, num_heads: int, max_prompts: int,
                 tokens_per_prompt: int,
                 shift_size: Optional[Sequence[int]] = None,
                 pad_mode: str = "reference",
                 dtype: torch.dtype = torch.float32,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.attn_drop = float(attn_drop)
        self.proj_drop = float(proj_drop)
        self.dropout_generator = None
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.shift_size = tuple(shift_size) if shift_size is not None \
            else (0, 0, 0)
        self.pad_mode = pad_mode
        self.dtype = dtype
        # False routes the block straight to the plain version (the
        # reference the kernel is compared with; SwinUnetR.set_kernels).
        self.use_kernels = True
        self.pe = RelativePE(pos_bias_embed_dim, num_heads, self.window_size,
                             self.window_size, max_prompts,
                             tokens_per_prompt)
        self.attn_norm = nn.LayerNorm(hidden_channels, eps=1e-6)
        self.attn = WindowAttention(hidden_channels, num_heads)
        self.mlp_norm = nn.LayerNorm(hidden_channels, eps=1e-6)
        self.mlp = nn.Linear(hidden_channels, hidden_channels)
        self._cache = {}
        self._cache_stamp = None

    def get_shift_size(self, shape_x: Sequence[int]) -> Tuple[int, ...]:
        """Zero the shift on axes not larger than the window."""
        return tuple(0 if d <= w else s for d, w, s in
                     zip(shape_x, self.window_size, self.shift_size))

    def block_params(self) -> dict:
        """The block's parameters in the kernel's (in, out) layout."""
        return {
            "ln1_scale": self.attn_norm.weight, "ln1_bias": self.attn_norm.bias,
            "wq": self.attn.to_q.weight.t(), "wk": self.attn.to_k.weight.t(),
            "wv": self.attn.to_v.weight.t(),
            "wproj": self.attn.proj.weight.t(), "bproj": self.attn.proj.bias,
            "ln2_scale": self.mlp_norm.weight, "ln2_bias": self.mlp_norm.bias,
            "wmlp": self.mlp.weight.t(), "bmlp": self.mlp.bias,
        }

    def set_dropout_generator(self, generator: torch.Generator) -> None:
        """The generator the block draws its dropout seeds from."""
        self.dropout_generator = generator

    def dropout(self) -> Dropout:
        """This call's dropout: fresh seeds in train mode, else none."""
        if not self.training or (self.attn_drop == 0.0
                                 and self.proj_drop == 0.0):
            return NO_DROPOUT
        if self.dropout_generator is None:
            raise RuntimeError("SwinTransformerBlock: training with dropout "
                               "needs set_dropout_generator()")
        seeds = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                              generator=self.dropout_generator).tolist()
        return Dropout(tuple(seeds), self.attn_drop, self.proj_drop)

    def _operands(self, key, tokens, build):
        """(ops, labels) for one geometry: built afresh with its graph
        when grad is enabled, else cached and dropped when a parameter or
        the prompt tokens change (in place or moved)."""
        if torch.is_grad_enabled():
            return build()
        watched = list(self.parameters()) + \
            ([] if tokens is None else [tokens])
        stamp = tuple((t.data_ptr(), t._version) for t in watched)
        if stamp != self._cache_stamp:
            self._cache.clear()
            self._cache_stamp = stamp
        if key not in self._cache:
            with torch.no_grad():
                self._cache[key] = build()
        return self._cache[key]

    def _make(self, bias, labels, fold_mode, tokens, device):
        ops = make_operands(self.block_params(), tokens, bias.to(device),
                            fold_mode, self.num_heads,
                            (self.hidden_channels // self.num_heads) ** -0.5,
                            self.dtype)
        return ops, labels_tensor(labels, device)

    def forward(self, x: torch.Tensor,
                tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: ``[B, H, W, D, C]``; tokens: ``[I, C]`` prompt tokens or None."""
        x_win, ops, labels, undo = self.windows(x, tokens)
        fn = fused_swin_block if self.use_kernels else block_reference
        return undo(fn(x_win, ops, labels, self.dropout()))

    def windows(self, x: torch.Tensor, tokens: Optional[torch.Tensor] = None):
        """The block call for ``x``: ``(x_win, ops, labels, undo)`` -- the
        padded, shifted, partitioned input ``[B, P, M, C]``, the cached
        operands and labels of this geometry, and the function taking the
        block's windowed output back to ``[B, H, W, D, C]``."""
        dims = tuple(x.shape[1:4])
        ws = self.window_size
        shift = self.get_shift_size(dims)
        paddings = compute_paddings(dims, ws, self.pad_mode)
        ref_pads = unpad_paddings(paddings, self.pad_mode)
        fold_axes = tuple(i for i, dim in enumerate(dims) if dim < ws[i])
        _, pads_eff = fold_geometry(dims, ws, fold_axes, paddings)
        n_tok = 0 if tokens is None else tokens.shape[0]
        if fold_axes and not any(pads_eff) and paddings == ref_pads:
            wc, _ = fold_geometry(dims, ws, fold_axes, paddings)
            key = ("fold", dims, shift, paddings, n_tok, x.device)
            build = lambda: self._build_folded(  # noqa: E731
                dims, shift, paddings, fold_axes, tokens, x.device)
            crop = None
        else:
            if any(paddings):
                x = _pad5(x, paddings)
            wc = ws
            key = ("plain", tuple(x.shape[1:4]), shift, ref_pads, n_tok,
                   x.device)
            build = lambda: self._build_padded(  # noqa: E731
                tuple(x.shape[1:4]), shift, ref_pads, tokens, x.device)
            crop = ref_pads if any(paddings) else None
        ops, labels = self._operands(key, tokens, build)
        b, c = x.shape[0], x.shape[-1]
        grid = tuple(x.shape[1:4])
        idx, inv = gather_indices(grid, wc, shift, x.device)
        m = int(np.prod(wc))
        x_win = x.reshape(b, -1, c).index_select(1, idx).view(b, -1, m, c)

        def undo(out_win: torch.Tensor) -> torch.Tensor:
            out = out_win.reshape(b, -1, c).index_select(1, inv).view(
                b, *grid, c)
            return out if crop is None else _crop5(out, crop)

        return x_win, ops, labels, undo

    def _build_padded(self, padded, shift, ref_pads, tokens, device):
        """Operands of a materially padded (or unpadded) geometry."""
        ws = self.window_size
        n_tok = 0 if tokens is None else tokens.shape[0]
        bias = self.pe(*ws, n_tok)[:, :int(np.prod(ws)), :]
        labels = None
        if any(shift):
            labels = get_attn_labels(padded, ws, shift, ref_pads)
            if n_tok:
                # Prompt-token key columns are never masked: label -1.
                labels = np.concatenate(
                    [labels, np.full((labels.shape[0], n_tok), -1,
                                     np.int32)], axis=-1)
        return self._make(bias, labels, FOLD_NONE, tokens, device)

    def _build_folded(self, dims, shift, paddings, fold_axes, tokens, device):
        """Operands of a pad-folded geometry: content rows and columns of
        the full-window bias, the virtual fold column, the prompt columns."""
        ws = self.window_size
        n_tok = 0 if tokens is None else tokens.shape[0]
        ci = content_indices(dims, ws, paddings, fold_axes)
        n_full = int(np.prod(ws))
        n_pad = n_full - ci.size
        pos_bias = self.pe(*ws, n_tok)                    # [H, N+I, N+I]
        ci_t = torch.as_tensor(ci, device=pos_bias.device)
        rows = pos_bias[:, ci_t]                          # [H, Mc, N+I]
        if any(shift):
            # Masked pad columns each contribute exp(0): one unmasked
            # column with zero key and bias ln(n_pad).
            fold_col = rows.new_full((rows.shape[0], ci.size, 1),
                                     float(np.log(n_pad)))
            padded_full = tuple(dims[i] + paddings[2 * i]
                                + paddings[2 * i + 1] for i in range(3))
            labels_c = get_attn_labels(padded_full, ws, shift,
                                       tuple(paddings))[:, ci]
            labels = np.concatenate(
                [labels_c, np.full((labels_c.shape[0], 1 + n_tok), -1,
                                   np.int32)], axis=-1)
            fold_mode = FOLD_COUNT
        else:
            # Unmasked pad columns share one key: fold their positional
            # biases by logsumexp.
            pi = torch.as_tensor(np.setdiff1d(np.arange(n_full), ci),
                                 device=rows.device)
            fold_col = torch.logsumexp(rows[:, :, pi], dim=-1, keepdim=True)
            labels = None
            fold_mode = FOLD_KEY
        bias = torch.cat([rows[:, :, ci_t], fold_col, rows[:, :, n_full:]],
                         dim=-1)
        return self._make(bias, labels, fold_mode, tokens, device)


class ConsecutiveSwinBlocks(nn.Module):
    """A (no-shift, shifted) block pair with optional PatchMerging."""

    def __init__(self, hidden_channels: int, num_heads: int,
                 pos_bias_embed_dim: int, max_prompts: int,
                 tokens_per_prompt: int, window_size: Sequence[int],
                 down: bool = True, merge_last_dim: bool = True,
                 out_channels: Optional[int] = None,
                 pad_mode: str = "reference",
                 dtype: torch.dtype = torch.float32,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        shift = tuple(s // 2 for s in window_size)
        self.swin_blocks = nn.ModuleList([
            SwinTransformerBlock(
                hidden_channels, window_size, pos_bias_embed_dim, num_heads,
                max_prompts, tokens_per_prompt,
                shift_size=(0, 0, 0) if i == 0 else shift,
                pad_mode=pad_mode, dtype=dtype, attn_drop=attn_drop,
                proj_drop=proj_drop)
            for i in range(2)])
        self.merge = PatchMerging(
            hidden_channels,
            2 * hidden_channels if out_channels is None else out_channels,
            merge_last_dim) if down else None

    def forward(self, x: torch.Tensor, tokens=(None, None)) -> torch.Tensor:
        for blk, tok in zip(self.swin_blocks, tokens):
            x = blk(x, tok)
        if self.merge is not None:
            x = self.merge(x)
        return x
