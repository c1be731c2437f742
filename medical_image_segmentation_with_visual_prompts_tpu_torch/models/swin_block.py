"""Prompted shifted-window Swin transformer blocks.

Counterpart of the JAX package's ``models/swin_block.py``.  A block pads
to window multiples (or pad-folds, below), rolls for the shift and
partitions into dilated windows (one gather, outside the kernel:
``ops/windows.py::gather_indices``), runs the block body on the windows,
then gathers back and crops.  Two bodies, as in the JAX package:

* the fused block (the default): LN1 -> attention over content queries
  and content + extra keys -> proj -> LN2 -> single-Linear MLP in one call
  of ``ops/fused_block.py::fused_swin_block`` (B1);
* the unfused block (``fused_block`` False: ``MIVP_NO_FUSED_BLOCK=1`` or
  ``SwinUnetR.set_fused_block(False)``; the JAX ``_forward_attn_mlp`` with
  ``use_fused_block`` false): the prompt tokens broadcast and concatenated
  after the content rows, LN1 over both, ``WindowAttention`` over the
  content queries (kernels B6/B7/B8), residual, LN2, the MLP, residual.
  It never pad-folds: every misaligned geometry pads materially.  Nothing
  switches to it on its own: it is chosen only explicitly.

A block pair (:class:`ConsecutiveSwinBlocks`) can also run both fused
blocks as one call of ``ops/fused_pair.py::fused_swin_pair`` (B5; the
JAX package's ``_pair_forward``), opt-in as in the JAX package.

Pad folding (the JAX ``swin_block.py:359-380`` decision, fused block
only): axes whose feature extent is smaller than the window are not
padded; the identical pad tokens of every window fold into one virtual
key column whose bias is the logsumexp of their positional biases (no
shift, ``FOLD_KEY``) or ``ln(n_pad)`` with a zero key (shift,
``FOLD_COUNT``).  It applies only when the folded axes are the only
padding and the pad split is symmetric; other geometries pad materially.

Everything a block call needs besides ``x`` -- the assembled bias
``[H, M, N]``, the labels ``[P, N]`` and (fused) the extra K/V rows --
depends only on the parameters and the geometry.  Without grad it is
built once per geometry and cached (the counterpart of the JAX
``bias_cache``); the cache is dropped when any parameter or the prompt
tokens change.  With grad enabled it is built on every call and keeps its
graph, so the gradient reaches the prompt tokens and the positional-bias
parameters.

Training (fused block): in train mode with a nonzero rate, each block
call draws two uint32 dropout seeds from the generator
:meth:`set_dropout_generator` gave it (the counterpart of the JAX
``make_rng("dropout")``) and the fused block applies counter-based
attention and projection dropout.  ``use_checkpoint`` needs no
``torch.utils.checkpoint`` here: the block's autograd Function already
saves only its inputs (the windowed ``x``, the operands, the labels and
the seeds) and recomputes the rest in the backward kernel, which is what
the JAX package's per-block remat buys; the gathers around it save
indices only.  So a training step runs the forward kernel once and the
backward kernel once per block (the JAX package's remat runs its forward
kernel twice).

Training (unfused block): the attention kernels' autograd Functions
(``ops/window_attention.py``) carry the JAX package's recompute as their
backward; with attention dropout on, the attention is the JAX XLA
branch instead (``models/window_attention.py``), with the block call's
seeds.  With ``use_checkpoint`` (set by ``SwinUnetR`` from its config)
in train mode, the unfused body runs under ``torch.utils.checkpoint``
(non-reentrant), as the JAX block runs under ``nn.remat``: its forward
is recomputed in the backward, kernels included, and the dropout seeds,
drawn before it, give the recompute the same masks.

The trunk is fp32 or bf16 (``dtype``); the block's matmul operands are
bf16 on the card, where the kernels compute, and the trunk's dtype on the
CPU (``ops/fused_block.py::kernel_matmul_dtype``), as the JAX package
rounds them in its kernels on the TPU and not on its XLA path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.fused_block import (FOLD_COUNT, FOLD_KEY, FOLD_NONE, NO_DROPOUT,
                               BiasFactors, Dropout, block_reference,
                               fused_swin_block,
                               kernel_matmul_dtype, labels_tensor,
                               layer_norm, make_operands)
from ..ops.fused_pair import fused_swin_pair, pair_reference
from ..ops.window_attention import BiasTables
from ..ops.windows import (PairPlan, compute_paddings, content_indices,
                           fold_geometry, gather_indices, get_attn_labels,
                           pair_plan, unpad_paddings)
from .patch_merging import PatchMerging
from .relative_pe import RelativePE
from .window_attention import WindowAttention, linear


def _pad5(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Zero-pad the spatial axes of ``[B, H, W, D, C]`` by (lo, hi) x 3."""
    return F.pad(x, (0, 0, pads[4], pads[5], pads[2], pads[3],
                     pads[0], pads[1]))


def _crop5(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    return x[:, pads[0]: x.shape[1] - pads[1], pads[2]: x.shape[2] - pads[3],
             pads[4]: x.shape[3] - pads[5]]


class UnfusedOperands(NamedTuple):
    """What the unfused body takes besides ``x`` and the labels: the
    ``[H, M, N]`` bias and its :class:`BiasTables`, from which the
    attention kernel builds it (None for a window the factor form does
    not take: the kernel reads the array)."""

    bias: torch.Tensor
    factors: Optional[BiasTables]


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
        # The data group whose rows this process holds (the dropout
        # counters' first window; SwinUnetR.set_data_group).
        self.data_group = None
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.shift_size = tuple(shift_size) if shift_size is not None \
            else (0, 0, 0)
        self.pad_mode = pad_mode
        self.dtype = dtype
        # False routes the block straight to the plain version (the
        # reference the kernel is compared with; SwinUnetR.set_kernels).
        self.use_kernels = True
        # False: the unfused body (SwinUnetR.set_fused_block).
        self.fused_block = True
        # True: the unfused body is recomputed in the backward (training).
        self.use_checkpoint = False
        self.pe = RelativePE(pos_bias_embed_dim, num_heads, self.window_size,
                             self.window_size, max_prompts,
                             tokens_per_prompt)
        self.attn_norm = nn.LayerNorm(hidden_channels, eps=1e-6)
        self.attn = WindowAttention(hidden_channels, num_heads, dtype)
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

    def dropout(self, x_win: Optional[torch.Tensor] = None) -> Dropout:
        """This call's dropout on windows ``x_win`` ``[B, P, M, C]``: fresh
        seeds in train mode, else none.  Under a data group the counters
        start at the global index of this rank's first window, ``rank * B
        * P`` (every rank holds B rows), so that a rank draws the global
        batch's masks for its rows."""
        if not self.training or (self.attn_drop == 0.0
                                 and self.proj_drop == 0.0):
            return NO_DROPOUT
        if self.dropout_generator is None:
            raise RuntimeError("SwinTransformerBlock: training with dropout "
                               "needs set_dropout_generator()")
        seeds = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                              generator=self.dropout_generator).tolist()
        drop = Dropout(tuple(seeds), self.attn_drop, self.proj_drop)
        group = self.data_group
        if group is not None and x_win is not None:
            drop = drop.at(group.rank * x_win.shape[0] * x_win.shape[1])
        return drop

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

    def _make(self, bias, labels, fold_mode, tokens, device, axes, index):
        """The block's operands; ``axes`` and ``index`` (the content rows'
        flat window positions) are the bias's factors, which B1 and B5
        take in place of the ``[H, M, N]`` array."""
        factors = BiasFactors(tuple(t.detach().to(device) for t in axes),
                              torch.as_tensor(index, device=device),
                              self.pe.scale)
        ops = make_operands(self.block_params(), tokens, bias.to(device),
                            fold_mode, self.num_heads,
                            (self.hidden_channels // self.num_heads) ** -0.5,
                            kernel_matmul_dtype(self.dtype, device), factors)
        return ops, labels_tensor(labels, device)

    def forward(self, x: torch.Tensor,
                tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: ``[B, H, W, D, C]``; tokens: ``[I, C]`` prompt tokens or None."""
        x_win, ops, labels, undo = self.windows(x, tokens)
        if not self.fused_block:
            drop = self.dropout(x_win)
            if self.use_checkpoint and self.training and \
                    torch.is_grad_enabled():
                return undo(torch.utils.checkpoint.checkpoint(
                    self.unfused_body, x_win, tokens, ops, labels, drop,
                    use_reentrant=False, preserve_rng_state=False))
            return undo(self.unfused_body(x_win, tokens, ops, labels, drop))
        fn = fused_swin_block if self.use_kernels else block_reference
        return undo(fn(x_win, ops, labels, self.dropout(x_win)))

    def attn_input(self, x_win: torch.Tensor,
                   tokens: Optional[torch.Tensor]) -> torch.Tensor:
        """LN1 of the content rows, then of the prompt tokens broadcast to
        every window: ``[B, P, M + I, C]`` (fp32 statistics, x's dtype),
        the ``y`` that B6's JAX signature takes (the unfused body gives the
        attention the two parts apart)."""
        b, pw, _, c = x_win.shape
        kv = x_win if tokens is None else torch.cat(
            [x_win, tokens.to(x_win.dtype).expand(b, pw, -1, c)], dim=2)
        return self._norm(kv, self.attn_norm)

    def _norm(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        return layer_norm(x.float(), norm.weight, norm.bias).to(x.dtype)

    def unfused_body(self, x_win: torch.Tensor, tokens: Optional[torch.Tensor],
                     ops: UnfusedOperands, labels: Optional[torch.Tensor],
                     drop: Dropout = NO_DROPOUT) -> torch.Tensor:
        """The unfused block on windows ``[B, P, M, C]``: LN1 over content
        and prompt rows, attention of the content queries (with the call's
        dropout ``drop``), residual, LN2, MLP, residual (JAX
        ``swin_block.py:459-471``).  The attention kernels take the bias
        as its factors; LN1 of the prompt tokens is computed once and goes
        to the attention apart from the content rows (every window shares
        it)."""
        if tokens is None:
            y = self.attn_input(x_win, None)
            a = self.attn(y, y, y, ops.bias, labels, factors=ops.factors,
                          drop=drop)
        else:
            a = self.attn.forward_prompts(
                self._norm(x_win, self.attn_norm),
                self._norm(tokens.to(x_win.dtype), self.attn_norm),
                ops.bias, labels, factors=ops.factors, drop=drop)
        x1 = x_win + a
        return x1 + linear(self._norm(x1, self.mlp_norm), self.mlp)

    def operands(self, x: torch.Tensor,
                 tokens: Optional[torch.Tensor] = None):
        """This block's geometry for ``x``: ``(x, wc, ops, labels, crop)``
        -- ``x`` padded where the geometry pads materially, the window of
        the partition (the content window ``wc`` when pad-folded), the
        cached operands and labels (``ops``: the fused block's
        :class:`BlockOperands`, or the unfused body's
        :class:`UnfusedOperands`),
        and the un-pad crop or None."""
        dims = tuple(x.shape[1:4])
        ws = self.window_size
        shift = self.get_shift_size(dims)
        paddings = compute_paddings(dims, ws, self.pad_mode)
        ref_pads = unpad_paddings(paddings, self.pad_mode)
        fold_axes = tuple(i for i, dim in enumerate(dims) if dim < ws[i])
        _, pads_eff = fold_geometry(dims, ws, fold_axes, paddings)
        n_tok = 0 if tokens is None else tokens.shape[0]
        if self.fused_block and fold_axes and not any(pads_eff) \
                and paddings == ref_pads:
            wc, _ = fold_geometry(dims, ws, fold_axes, paddings)
            key = ("fold", dims, shift, paddings, n_tok, x.device)
            build = lambda: self._build_folded(  # noqa: E731
                dims, shift, paddings, fold_axes, tokens, x.device)
            crop = None
        else:
            if any(paddings):
                x = _pad5(x, paddings)
            wc = ws
            padded = tuple(x.shape[1:4])
            key = ("plain" if self.fused_block else "unfused", padded, shift,
                   ref_pads, n_tok, x.device)
            build = lambda: self._build_padded(  # noqa: E731
                padded, shift, ref_pads, tokens, x.device)
            crop = ref_pads if any(paddings) else None
        ops, labels = self._operands(key, tokens, build)
        return x, wc, ops, labels, crop

    def windows(self, x: torch.Tensor, tokens: Optional[torch.Tensor] = None):
        """The block call for ``x``: ``(x_win, ops, labels, undo)`` -- the
        padded, shifted, partitioned input ``[B, P, M, C]``, the
        :meth:`operands` of this geometry, and the function taking the
        block's windowed output back to ``[B, H, W, D, C]``."""
        shift = self.get_shift_size(tuple(x.shape[1:4]))
        x, wc, ops, labels, crop = self.operands(x, tokens)
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
        """Operands of a materially padded (or unpadded) geometry: the
        fused block's, or (unfused) the bias with its factor tables, and
        the labels."""
        ws = self.window_size
        n_tok = 0 if tokens is None else tokens.shape[0]
        n_full = int(np.prod(ws))
        axes = self.pe.axis_tables(*ws)
        bias = self.pe(*ws, n_tok, axes=axes)[:, :n_full, :]
        labels = None
        if any(shift):
            labels = get_attn_labels(padded, ws, shift, ref_pads)
            if n_tok:
                # Prompt-token key columns are never masked: label -1.
                labels = np.concatenate(
                    [labels, np.full((labels.shape[0], n_tok), -1,
                                     np.int32)], axis=-1)
        if not self.fused_block:
            bias = bias.to(device).float().contiguous()
            tables = None
            if BiasTables.takes(ws):
                tables = BiasTables.from_factors(BiasFactors(
                    tuple(t.detach().to(device) for t in axes),
                    torch.arange(n_full, device=device), self.pe.scale),
                    bias.detach())
            return (UnfusedOperands(bias, tables),
                    labels_tensor(labels, device))
        return self._make(bias, labels, FOLD_NONE, tokens, device, axes,
                          np.arange(n_full))

    def _build_folded(self, dims, shift, paddings, fold_axes, tokens, device):
        """Operands of a pad-folded geometry: content rows and columns of
        the full-window bias, the virtual fold column, the prompt columns."""
        ws = self.window_size
        n_tok = 0 if tokens is None else tokens.shape[0]
        ci = content_indices(dims, ws, paddings, fold_axes)
        n_full = int(np.prod(ws))
        n_pad = n_full - ci.size
        axes = self.pe.axis_tables(*ws)
        pos_bias = self.pe(*ws, n_tok, axes=axes)         # [H, N+I, N+I]
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
        return self._make(bias, labels, fold_mode, tokens, device, axes, ci)


class ConsecutiveSwinBlocks(nn.Module):
    """A (no-shift, shifted) block pair with optional PatchMerging.

    With :attr:`pair_kernel` on (``SwinUnetR.set_pair_kernel``, or
    ``MIVP_PAIR_KERNEL=1`` when the model is built) the pair runs as one
    call of ``ops/fused_pair.py::fused_swin_pair`` (B5) where the JAX
    package's ``_pair_fusable`` would take it: fused blocks, no material
    padding (pad-folded axes qualify), equal prompt-token counts, and a
    shift that :func:`ops.windows.pair_plan` can express (no depth shift).
    One partition in and one reverse out serve both blocks; each block's
    operands and labels are its own cached ones.  Other geometries run the
    two block calls, decided from the geometry alone before any launch.
    """

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
        self.pair_kernel = False

    def pair_plan(self, x: torch.Tensor, tokens=(None, None)
                  ) -> Optional[PairPlan]:
        """The pair path's plan for ``x``, or None where the two block
        calls run (the JAX ``_pair_fusable`` and ``_run_pair_kernel``
        gates, ``swin_block.py:553-626``)."""
        b0, b1 = self.swin_blocks
        if not (self.pair_kernel and b0.fused_block and b1.fused_block):
            return None
        if (0 if tokens[0] is None else tokens[0].shape[0]) != \
                (0 if tokens[1] is None else tokens[1].shape[0]):
            return None
        dims = tuple(x.shape[1:4])
        ws = b0.window_size
        paddings = compute_paddings(dims, ws, b0.pad_mode)
        fold_axes = tuple(i for i, dim in enumerate(dims) if dim < ws[i])
        wc, pads_eff = fold_geometry(dims, ws, fold_axes, paddings)
        if any(pads_eff) or paddings != unpad_paddings(paddings,
                                                       b0.pad_mode):
            return None
        return pair_plan(dims, wc, b1.get_shift_size(dims), x.device)

    def pair_windows(self, x: torch.Tensor, tokens=(None, None)):
        """The pair call for ``x``: ``(x_win, ops0, ops1, labels, plan,
        undo)`` -- the unshifted windows, each block's operands, the
        shifted block's labels, the :meth:`pair_plan` and the reverse of
        the partition; None where the two block calls run."""
        plan = self.pair_plan(x, tokens)
        if plan is None:
            return None
        x_win, ops0, _, undo = self.swin_blocks[0].windows(x, tokens[0])
        _, _, ops1, labels, _ = self.swin_blocks[1].operands(x, tokens[1])
        return x_win, ops0, ops1, labels, plan, undo

    def forward(self, x: torch.Tensor, tokens=(None, None)) -> torch.Tensor:
        pair = self.pair_windows(x, tokens)
        if pair is None:
            for blk, tok in zip(self.swin_blocks, tokens):
                x = blk(x, tok)
        else:
            x_win, ops0, ops1, labels, plan, undo = pair
            b0, b1 = self.swin_blocks
            fn = fused_swin_pair if b0.use_kernels else pair_reference
            x = undo(fn(x_win, ops0, ops1, labels, plan, b0.dropout(x_win),
                        b1.dropout(x_win)))
        if self.merge is not None:
            x = self.merge(x)
        return x
