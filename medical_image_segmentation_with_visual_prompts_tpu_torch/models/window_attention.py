"""Multi-head window attention over ``[B, P, N, C]`` token windows.

Counterpart of the JAX package's ``models/window_attention.py``: bias-free
q/k/v projections, scaled QK^T, additive positional bias, multiplicative
0/1 mask (masked logits become 0, not -inf), softmax, value aggregation,
output projection.  The attribute names (``to_q``, ``to_k``, ``to_v``,
``proj``) are the reference's state-dict keys.

The fused Swin block path reads only the parameters (the whole block is
one kernel there); the unfused path (``MIVP_NO_FUSED_BLOCK=1``,
``SwinUnetR.set_fused_block(False)``) calls :meth:`forward`, which
dispatches as the JAX module does:

* ``dim <= 128`` and q is k is v: B6, the projections inside the kernel
  (``ops/window_attention.py::fused_window_attention_packed_qkv``);
* ``dim <= 128`` otherwise: the projections here, then B7
  (``fused_window_attention_packed``);
* ``dim > 128``: the projections here, heads split, then B8
  (``fused_window_attention``);

then ``proj``.  :meth:`forward_prompts` takes the unfused block's call
apart: the content rows and the prompt rows that every window shares,
which B6 takes as two tensors
(``fused_window_attention_packed_qkv_prompts``).  The projections
outside a kernel and ``proj`` are plain
linear layers, as XLA runs them in the JAX package.  With
``use_kernels`` False (``SwinUnetR.set_kernels``) the plain versions run
instead of the kernel wrappers; on CPU tensors the wrappers run them too.
``matmul_dtype`` is their rounding: bf16 on the card, where the kernels
compute, and the model's compute dtype on the CPU (fp32: the JAX XLA
path's math; ``ops/fused_block.py::kernel_matmul_dtype``).  The kernel
wrappers are autograd Functions (kernel forward, the JAX package's fp32
recompute as backward), so this path trains.

Dropout (``drop``, the block call's :class:`~..ops.fused_block.Dropout`:
its rates and seeds; the block passes rates only in train mode).  With
attention dropout on, no kernel runs: the JAX module's XLA branch
(``models/window_attention.py:131-143``), fp32 scores, ``+ bias``, ``*
mask``, softmax, dropout on the probabilities, the probabilities cast to
v's dtype, ``@ v`` (:meth:`WindowAttention.attend_dropout`), as the JAX
``_use_pallas`` picks it.  The projection dropout follows ``proj`` on
every branch.  Each mask comes from a generator on the activation's
device seeded with one of the call's seeds (attention ``seeds[0]``,
projection ``seeds[1]``; :func:`dropout_keep`), so a recompute draws the
same masks; flax's masks are not reproduced bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import window_attention as wa
from ..ops.fused_block import (NO_DROPOUT, Dropout, kernel_matmul_dtype,
                               qkv_kernel_weight)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` in x's dtype (the parameters cast to it)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def dropout_keep(shape, rate: float, seed: int, device) -> torch.Tensor:
    """Boolean keep mask of ``shape`` on ``device`` (each element kept with
    probability ``1 - rate``), drawn from a generator on that device
    seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device) >= rate


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout of ``x`` as flax's ``nn.Dropout``: kept elements
    divided by ``1 - rate``, the others 0 (identity at rate 0)."""
    if rate == 0.0:
        return x
    keep = dropout_keep(x.shape, rate, seed, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError("WindowAttention: The dimension is not "
                             "compatible with the number of heads!")
        self.dim = dim
        self.num_heads = num_heads
        self.matmul_dtype = dtype
        self.use_kernels = True
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self._wqkv = None

    def kernel_weight(self) -> torch.Tensor:
        """B6's per-head weight layout, cached until a weight changes in
        place or moves."""
        ws = (self.to_q.weight, self.to_k.weight, self.to_v.weight)
        stamp = tuple((w.data_ptr(), w._version) for w in ws)
        if self._wqkv is None or self._wqkv[0] != stamp:
            with torch.no_grad():
                self._wqkv = (stamp, qkv_kernel_weight(
                    *(w.t() for w in ws), self.num_heads))
        return self._wqkv[1]

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos_bias: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                q_rows: Optional[int] = None,
                factors: Optional[wa.BiasTables] = None,
                drop: Dropout = NO_DROPOUT) -> torch.Tensor:
        """q: ``[B, P, M, C]``; k/v: ``[B, P, N, C]``; pos_bias
        ``[H, M', N]``; labels ``[P, N]`` int32 or None.  When q, k and v
        are the same tensor, ``q_rows`` restricts the queries to its first
        rows (content-query attention).  ``factors``: the
        :class:`~..ops.window_attention.BiasTables` of ``pos_bias``, which
        the kernels read in its place.  ``drop``: the call's dropout.
        Returns ``[B, P, M', C]``."""
        b, p = q.shape[:2]
        m = q_rows if (q_rows is not None and q is k) else q.shape[2]
        h = self.num_heads
        scale = (self.dim // h) ** -0.5
        dt = kernel_matmul_dtype(self.matmul_dtype, k.device)
        kern = self.use_kernels
        if drop.attn > 0.0:
            return self.project(self.attend_dropout(q, k, v, pos_bias, labels,
                                                    m, drop), drop)
        if self.dim <= 128 and q is k and k is v:
            ws = (self.to_q.weight.t(), self.to_k.weight.t(),
                  self.to_v.weight.t())
            if kern:
                out = wa.fused_window_attention_packed_qkv(
                    k, *ws, m, pos_bias, labels, scale, h, dt,
                    wqkv=self.kernel_weight() if k.is_cuda else None,
                    factors=factors)
            else:
                out = wa.fused_window_attention_packed_qkv_reference(
                    k, *ws, m, pos_bias, labels, scale, h, dt)
            return self.project(out, drop)
        qp = linear(q[:, :, :m], self.to_q).contiguous()
        kp = linear(k, self.to_k).contiguous()
        vp = linear(v, self.to_v).contiguous()
        kw = {"factors": factors} if kern else {}
        if self.dim <= 128:
            fn = wa.fused_window_attention_packed if kern \
                else wa.fused_window_attention_packed_reference
            out = fn(qp, kp, vp, pos_bias, labels, scale, h, dt, **kw)
        else:
            fn = wa.fused_window_attention if kern \
                else wa.fused_window_attention_reference
            split = lambda t: t.view(b, p, t.shape[2], h, -1)  # noqa: E731
            out = fn(split(qp), split(kp), split(vp), pos_bias, labels,
                     scale, dt, **kw).reshape(b, p, m, self.dim)
        return self.project(out, drop)

    def project(self, out: torch.Tensor, drop: Dropout) -> torch.Tensor:
        """``proj``, then the projection dropout."""
        return dropout(linear(out, self.proj), drop.proj, drop.seeds[1])

    def attend_dropout(self, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, pos_bias: torch.Tensor,
                       labels: Optional[torch.Tensor], m: int,
                       drop: Dropout) -> torch.Tensor:
        """The JAX XLA branch with attention dropout, pre-proj: the
        projections in the activations' dtype, fp32 scores ``(q k^T *
        scale + bias) * mask``, softmax, dropout on the probabilities,
        the probabilities cast to v's dtype, ``@ v``.  Returns ``[B, P, m,
        C]``."""
        b, p = q.shape[:2]
        h = self.num_heads
        split = lambda t: t.reshape(  # noqa: E731
            b, p, t.shape[2], h, -1).transpose(2, 3)     # [B, P, H, R, Dh]
        qh = split(linear(q[:, :, :m], self.to_q))
        kh, vh = split(linear(k, self.to_k)), split(linear(v, self.to_v))
        n = kh.shape[3]
        s = (qh.float() @ kh.float().transpose(-1, -2)) \
            * (self.dim // h) ** -0.5 + pos_bias.reshape(h, m, n).float()
        if labels is not None:
            mask = wa.label_mask(labels.to(s.device), m)
            s = s * mask.repeat(p // mask.shape[0], 1, 1)[:, None]
        probs = dropout(torch.softmax(s, dim=-1), drop.attn, drop.seeds[0])
        out = probs.to(vh.dtype) @ vh
        return out.transpose(2, 3).reshape(b, p, m, self.dim)

    def forward_prompts(self, y: torch.Tensor, y_prompt: torch.Tensor,
                        pos_bias: torch.Tensor,
                        labels: Optional[torch.Tensor] = None,
                        factors: Optional[wa.BiasTables] = None,
                        drop: Dropout = NO_DROPOUT) -> torch.Tensor:
        """Content-query attention of the rows ``y [B, P, M, C]`` over
        them and the rows ``y_prompt [I, C]`` that follow them in every
        window: :meth:`forward` of ``kv = [y | y_prompt]`` (per window)
        with ``q_rows`` M.  B6 takes the two apart and projects the prompt
        rows' K/V once per call.  Returns ``[B, P, M, C]``."""
        b, p, m, c = y.shape
        if self.use_kernels and self.dim <= 128 and drop.attn == 0.0:
            h = self.num_heads
            ws = (self.to_q.weight.t(), self.to_k.weight.t(),
                  self.to_v.weight.t())
            out = wa.fused_window_attention_packed_qkv_prompts(
                y, y_prompt, *ws, pos_bias, labels, (c // h) ** -0.5, h,
                kernel_matmul_dtype(self.matmul_dtype, y.device),
                wqkv=self.kernel_weight() if y.is_cuda else None,
                factors=factors)
            return self.project(out, drop)
        kv = torch.cat([y, y_prompt.expand(b, p, -1, c)], dim=2)
        return self(kv, kv, kv, pos_bias, labels, q_rows=m, factors=factors,
                    drop=drop)
