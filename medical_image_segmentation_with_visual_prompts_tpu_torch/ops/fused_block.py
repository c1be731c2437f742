"""Fused Swin block: plain PyTorch version, CUDA kernel wrapper, counter,
and the autograd Function that trains through both.

Counterpart of the JAX package's ``ops/fused_block.py`` (TPU kernel
``_block_kernel``; its jnp mirror ``_block_reference`` defines the
arithmetic; ``_fused_block``'s ``custom_vjp`` the gradient).  One call
runs a whole Swin block on windowed tokens::

    y   = LN1(x)                          fp32 statistics, eps 1e-6
    q   = y Wq (content rows)  k|v = [y Wk | y Wv ; extra K/V rows]
    s   = (q.k * scale + bias) * mask     mask = label equality, 0/1
    p   = softmax(s) * keep_a             attention dropout (training)
    x1  = x + (p v Wproj + bproj) * keep_p
    out = x1 + LN2(x1) Wmlp + bmlp

The extra K/V rows are the pad-fold row (``FOLD_KEY``: k = LN1_bias Wk;
``FOLD_COUNT``: k = 0; both v = LN1_bias Wv) followed by the prompt
tokens after LN1, projected here with ``torch.matmul`` -- a few rows per
block, like the XLA side of the TPU kernel.  The masked logits become 0,
not -inf (the reference's multiplicative mask).

Dropout is counter-based (``ops/prng.py``): ``keep_a`` hashes
``((w*H + head)*M + row)*n_cols + col`` with the first seed, ``keep_p``
hashes ``(w*M + row)*C + col`` with the second, where ``w`` is the flat
window index in ``[B*P]`` order.  ``n_cols`` and ``col`` count the JAX
kernel's key columns, which include ``fold_width - 1`` alignment columns
after a fold column (``BlockOperands.drop_cols``), so the masks are the
JAX package's bit for bit.

``matmul_dtype`` is bf16 for the kernel's arithmetic (bf16 operands,
fp32 sums; emulated on the CPU as ``a.bfloat16().float() @
b.bfloat16().float()``) or fp32 for parity with the JAX model's fp32
XLA path.

The kernels (``csrc/fused_block.cu``, and ``csrc/fused_block_bwd.cu`` for
the gradient, ``ops/fused_block_bwd.py``) run for CUDA tensors; CPU
tensors take :func:`block_reference` and its autograd.  The one
arithmetic difference: the kernel feeds the (dropped) softmax
probabilities to its P.V tensor-core product as bf16, the plain version
(like the JAX ``_block_reference``) keeps them fp32.
``fused_swin_block.launches`` counts the forward kernel's launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .prng import keep_mask, keep_scale, keep_threshold

FOLD_NONE = 0    # no virtual pad column
FOLD_KEY = 1     # unshifted: k_pad = LN1_bias Wk, bias carries logsumexp
FOLD_COUNT = 2   # shifted: k_pad = 0, bias carries ln(n_pad)

PARAM_KEYS = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wproj", "bproj",
              "ln2_scale", "ln2_bias", "wmlp", "bmlp")
_EPS = 1e-6
KERNEL_HEAD_DIMS = (8, 12, 16, 24, 32, 48, 64)


def fold_width(m: int, n_tokens: int) -> int:
    """Key columns the JAX kernel gives a fold: the fold column plus
    alignment columns up to a multiple of 8 keys (JAX ``fold_width``)."""
    return 1 + (-(m + n_tokens + 1)) % 8


@dataclasses.dataclass(frozen=True)
class Dropout:
    """Counter-based dropout of one block call: two uint32 seeds
    (attention, projection) and the two rates."""

    seeds: Tuple[int, int]
    attn: float
    proj: float

    def __post_init__(self):
        for rate in (self.attn, self.proj):
            if not 0.0 <= rate < 1.0:
                raise ValueError(f"Dropout: rates must be in [0, 1), got "
                                 f"{self.attn}, {self.proj}")
        object.__setattr__(self, "seeds",
                           tuple(int(s) & 0xFFFFFFFF for s in self.seeds))

    def kernel_args(self):
        """(seed_a, seed_p, threshold_a, threshold_p, scale_a, scale_p)."""
        return (self.seeds[0], self.seeds[1], keep_threshold(self.attn),
                keep_threshold(self.proj), keep_scale(self.attn),
                keep_scale(self.proj))


NO_DROPOUT = Dropout((0, 0), 0.0, 0.0)


def layer_norm(x: torch.Tensor, scale, bias, eps: float = _EPS):
    """LayerNorm as the JAX kernel computes it: var = E[x^2] - mu^2."""
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 tensor holding ``t`` rounded to ``dtype`` (identity for fp32)."""
    return t.float() if dtype == torch.float32 else t.to(dtype).float()


def matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """``a @ b`` with operands rounded to ``dtype`` and fp32 sums."""
    return round_to(a, dtype) @ round_to(b, dtype)


@dataclasses.dataclass
class BlockOperands:
    """Everything one block call needs besides ``x``, the labels and the
    dropout seeds.

    ``params`` hold fp32 tensors in (in, out) layout; ``bias`` is the
    assembled ``[H, M, N]`` fp32 bias; ``ext_k``/``ext_v`` the ``[E, C]``
    extra K/V rows (None when E = 0).  In training they are built from
    tensors that require grad and carry it.  ``drop_cols`` is the key
    count of the attention-dropout counter (``N`` plus the JAX kernel's
    fold alignment columns).  ``kernel`` holds the same operands,
    detached, in the CUDA kernel's layout, built by :func:`make_operands`
    for CUDA tensors only.
    """

    params: dict
    bias: torch.Tensor
    ext_k: Optional[torch.Tensor]
    ext_v: Optional[torch.Tensor]
    num_heads: int
    scale: float
    matmul_dtype: torch.dtype
    drop_cols: int
    kernel: Optional[dict] = None

    @property
    def n_ext(self) -> int:
        return 0 if self.ext_k is None else self.ext_k.shape[0]

    def tensors(self) -> tuple:
        """The differentiable operands: bias, ext_k, ext_v, params."""
        return (self.bias, self.ext_k, self.ext_v,
                *(self.params[k] for k in PARAM_KEYS))

    def with_tensors(self, tensors) -> "BlockOperands":
        bias, ext_k, ext_v, *params = tensors
        return dataclasses.replace(self, bias=bias, ext_k=ext_k, ext_v=ext_v,
                                   params=dict(zip(PARAM_KEYS, params)))


def extra_kv_rows(params: dict, tokens: Optional[torch.Tensor],
                  fold_mode: int, matmul_dtype: torch.dtype):
    """``[E, C]`` K and V rows after the content keys: the fold row (if
    ``fold_mode``), then the LN1'd prompt tokens.  Differentiable."""
    rows = []
    if fold_mode:
        # A zero pad voxel after LN1 is exactly the LN1 bias.
        rows.append(params["ln1_bias"].float()[None])
    if tokens is not None:
        rows.append(layer_norm(tokens.float(), params["ln1_scale"],
                               params["ln1_bias"]))
    if not rows:
        return None, None
    y = torch.cat(rows)
    k = round_to(matmul(y, params["wk"], matmul_dtype), matmul_dtype)
    v = round_to(matmul(y, params["wv"], matmul_dtype), matmul_dtype)
    if fold_mode == FOLD_COUNT:
        k = torch.cat([torch.zeros_like(k[:1]), k[1:]])
    return k, v


def _kernel_layout(ops: BlockOperands) -> dict:
    """Operands in ``csrc/fused_block.cu``'s layout: bf16 weights stored
    transposed (out, in) for the tensor-core B operand, each head's q|k|v
    rows zero-padded to a multiple of 16 (the k-step), and the extra K/V
    rows per head with the same padding."""
    p = {k: v.detach() for k, v in ops.params.items()}
    c = p["wq"].shape[0]
    h = ops.num_heads
    dh = c // h
    dhp = -(-dh // 16) * 16

    def heads(w):   # (in, out) [C, C] -> [H, DHP, C]
        return torch.nn.functional.pad(
            w.float().t().reshape(h, dh, c), (0, 0, 0, dhp - dh))

    wqkv = torch.stack([heads(p["wq"]), heads(p["wk"]), heads(p["wv"])],
                       dim=1)                                # [H, 3, DHP, C]
    e = ops.n_ext
    ext = torch.zeros(h, 2, max(e, 1), dhp, device=wqkv.device)
    if e:
        for i, rows in enumerate((ops.ext_k, ops.ext_v)):
            ext[:, i, :e, :dh] = rows.detach().float().reshape(
                e, h, dh).permute(1, 0, 2)
    bf = torch.bfloat16
    return {
        "wqkv": wqkv.to(bf).contiguous(),
        "ext_kv": ext.to(bf).contiguous(),
        "bias": ops.bias.detach().float().contiguous(),
        "wproj": p["wproj"].t().to(bf).contiguous(),
        "wmlp": p["wmlp"].t().to(bf).contiguous(),
        **{k: p[k].float().contiguous() for k in
           ("ln1_scale", "ln1_bias", "bproj", "ln2_scale", "ln2_bias",
            "bmlp")},
    }


def make_operands(params: dict, tokens: Optional[torch.Tensor],
                  bias: torch.Tensor, fold_mode: int, num_heads: int,
                  scale: float, matmul_dtype: torch.dtype = torch.bfloat16
                  ) -> BlockOperands:
    """Assemble a block's operands.  Under ``torch.no_grad`` the result
    holds no graph (callers cache it per geometry); with grad enabled the
    extra rows and the bias keep theirs, so gradients reach the prompt
    tokens, the block parameters and the positional-bias parameters."""
    params = {k: params[k].float() for k in PARAM_KEYS}
    ext_k, ext_v = extra_kv_rows(params, tokens, fold_mode, matmul_dtype)
    m, n = bias.shape[1], bias.shape[2]
    n_tok = 0 if tokens is None else tokens.shape[0]
    drop_cols = n + (fold_width(m, n_tok) - 1 if fold_mode else 0)
    ops = BlockOperands(params, bias.float(), ext_k, ext_v, num_heads,
                        float(scale), matmul_dtype, drop_cols)
    if bias.is_cuda:
        with torch.no_grad():
            ops.kernel = _kernel_layout(ops)
    return ops


def key_columns(n: int, m: int, drop_cols: int, device) -> torch.Tensor:
    """Dropout-counter column of each key: keys after the fold column
    (index ``m``) skip the JAX kernel's ``drop_cols - n`` alignment
    columns."""
    j = torch.arange(n, device=device, dtype=torch.int64)
    return j + (j > m).to(torch.int64) * (drop_cols - n)


def attn_keep(dropout: Dropout, bp: int, h: int, m: int, n: int,
              drop_cols: int, device) -> torch.Tensor:
    """``[BP, H, M, N]`` attention keep mask (values 0 or 1/(1-rate))."""
    w = torch.arange(bp, device=device, dtype=torch.int64)[:, None, None, None]
    hh = torch.arange(h, device=device, dtype=torch.int64)[None, :, None, None]
    rr = torch.arange(m, device=device, dtype=torch.int64)[None, None, :, None]
    jj = key_columns(n, m, drop_cols, device)[None, None, None, :]
    idx = ((w * h + hh) * m + rr) * drop_cols + jj
    return keep_mask(dropout.seeds[0], idx, dropout.attn)


def proj_keep(dropout: Dropout, bp: int, m: int, c: int,
              device) -> torch.Tensor:
    """``[BP, M, C]`` projection keep mask."""
    w = torch.arange(bp, device=device, dtype=torch.int64)[:, None, None]
    rr = torch.arange(m, device=device, dtype=torch.int64)[None, :, None]
    jj = torch.arange(c, device=device, dtype=torch.int64)[None, None, :]
    return keep_mask(dropout.seeds[1], (w * m + rr) * c + jj, dropout.proj)


def block_reference(x_win: torch.Tensor, ops: BlockOperands,
                    labels: Optional[torch.Tensor] = None,
                    dropout: Dropout = NO_DROPOUT) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[B, P, M, C]`` -> same.
    Differentiable in ``x_win`` and every operand."""
    b, pw, m, c = x_win.shape
    bp = b * pw
    dt = ops.matmul_dtype
    p = ops.params
    h = ops.num_heads
    dh = c // h
    x = x_win.reshape(bp, m, c).float()
    y = layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    q = round_to(matmul(y, p["wq"], dt), dt)
    k = round_to(matmul(y, p["wk"], dt), dt)
    v = round_to(matmul(y, p["wv"], dt), dt)
    if ops.ext_k is not None:
        e = ops.n_ext
        k = torch.cat([k, ops.ext_k.to(k.device).expand(bp, e, c)], 1)
        v = torch.cat([v, ops.ext_v.to(v.device).expand(bp, e, c)], 1)
    n = k.shape[1]
    qh = q.reshape(bp, m, h, dh).transpose(1, 2)
    kh = k.reshape(bp, n, h, dh).transpose(1, 2)
    vh = v.reshape(bp, n, h, dh).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * ops.scale + ops.bias.to(x.device)
    if labels is not None:
        lab = torch.as_tensor(labels, device=x.device).repeat(b, 1)
        mask = (lab[:, :m, None] == lab[:, None, :]) | (lab[:, None, :] < 0)
        s = s * mask[:, None].to(s.dtype)
    probs = torch.softmax(s, dim=-1)
    if dropout.attn > 0.0:
        probs = probs * attn_keep(dropout, bp, h, m, n, ops.drop_cols,
                                  x.device)
    attn = (probs @ vh).transpose(1, 2).reshape(bp, m, c)
    proj = matmul(attn, p["wproj"], dt) + p["bproj"]
    if dropout.proj > 0.0:
        proj = proj * proj_keep(dropout, bp, m, c, x.device)
    x1 = x + proj
    l2 = layer_norm(x1, p["ln2_scale"], p["ln2_bias"])
    out = x1 + (matmul(l2, p["wmlp"], dt) + p["bmlp"])
    return out.to(x_win.dtype).reshape(b, pw, m, c)


def _check_args(x_win: torch.Tensor, ops: BlockOperands,
                labels: Optional[torch.Tensor]) -> None:
    """Shape and type checks common to both paths, naming the argument."""
    if x_win.dim() != 4:
        raise ValueError(f"fused_swin_block: x_win must be [B, P, M, C], "
                         f"got shape {tuple(x_win.shape)}")
    _, pw, m, c = x_win.shape
    h = ops.num_heads
    if ops.params["wq"].shape != (c, c) or c % h:
        raise ValueError(f"fused_swin_block: x_win has C={c}, operands "
                         f"have wq {tuple(ops.params['wq'].shape)} and "
                         f"{h} heads")
    n = m + ops.n_ext
    if tuple(ops.bias.shape) != (h, m, n):
        raise ValueError(f"fused_swin_block: bias must be [H, M, N] = "
                         f"{(h, m, n)}, got {tuple(ops.bias.shape)}")
    if labels is not None and tuple(labels.shape) != (pw, n):
        raise ValueError(f"fused_swin_block: labels must be [P, N] = "
                         f"{(pw, n)}, got {tuple(labels.shape)}")


def check_kernel_args(x_win: torch.Tensor, ops: BlockOperands,
                      labels: Optional[torch.Tensor],
                      name: str = "fused_swin_block") -> None:
    """What the CUDA kernels take; raises naming the offending argument."""
    if not x_win.is_cuda:
        raise ValueError(f"{name}: x_win must be on a CUDA device")
    if x_win.dtype != torch.bfloat16:
        raise ValueError(f"{name}: x_win must be bfloat16, got "
                         f"{x_win.dtype}")
    if not x_win.is_contiguous():
        raise ValueError(f"{name}: x_win must be contiguous")
    _, _, m, c = x_win.shape
    dh = c // ops.num_heads
    if c % 16 or dh not in KERNEL_HEAD_DIMS or m > 1024:
        raise ValueError(f"{name}: the kernel takes C % 16 == 0, head dim "
                         f"in {KERNEL_HEAD_DIMS} and M <= 1024; got C={c}, "
                         f"head dim {dh}, M={m}")
    if ops.matmul_dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel computes with bf16 operands, "
                         f"ops were built for {ops.matmul_dtype}")
    if ops.kernel is None:
        raise ValueError(f"{name}: ops were built from CPU tensors "
                         "(make_operands on the CUDA device)")
    for key, t in ops.kernel.items():
        if t.device != x_win.device:
            raise ValueError(f"{name}: operand {key} is on {t.device}, "
                             f"x_win on {x_win.device}")
    if labels is not None and (labels.device != x_win.device
                               or labels.dtype != torch.int32
                               or not labels.is_contiguous()):
        raise ValueError(f"{name}: labels must be a contiguous int32 tensor "
                         f"on x_win's device, got {labels.dtype} on "
                         f"{labels.device}")


def _forward(x_win: torch.Tensor, ops: BlockOperands,
             labels: Optional[torch.Tensor], dropout: Dropout
             ) -> torch.Tensor:
    """One block forward: the kernel for CUDA tensors, else the plain
    version."""
    if not x_win.is_cuda:
        return block_reference(x_win, ops, labels, dropout)
    check_kernel_args(x_win, ops, labels)
    from . import kernels
    b, pw, m, c = x_win.shape
    k = ops.kernel
    out = torch.empty_like(x_win)
    err = kernels.library().mivp_fused_swin_block(
        x_win.data_ptr(), out.data_ptr(), k["wqkv"].data_ptr(),
        k["ext_kv"].data_ptr(), k["bias"].data_ptr(),
        kernels.ptr(labels), k["ln1_scale"].data_ptr(),
        k["ln1_bias"].data_ptr(), k["wproj"].data_ptr(),
        k["bproj"].data_ptr(), k["ln2_scale"].data_ptr(),
        k["ln2_bias"].data_ptr(), k["wmlp"].data_ptr(),
        k["bmlp"].data_ptr(), b * pw, m, c, ops.num_heads,
        c // ops.num_heads, ops.n_ext, pw, ops.scale,
        *dropout.kernel_args(), ops.drop_cols, kernels.stream_of(x_win))
    kernels.check(err, "fused_swin_block")
    fused_swin_block.launches += 1
    return out


class FusedBlockFunction(torch.autograd.Function):
    """Forward: the B1 kernel (CUDA) or :func:`block_reference` (CPU).
    Backward: the B4 kernel (``ops/fused_block_bwd.py``, CUDA) or the
    autograd of :func:`block_reference` (CPU).  Saves only ``x_win``, the
    operands, the labels and the seeds, like the JAX ``custom_vjp``
    residuals; everything else is recomputed in the backward."""

    @staticmethod
    def forward(ctx, x_win, labels, ops, dropout, *tensors):
        ctx.save_for_backward(x_win, *tensors)
        ctx.labels, ctx.ops, ctx.dropout = labels, ops, dropout
        return _forward(x_win, ops, labels, dropout)

    @staticmethod
    def backward(ctx, dout):
        from .fused_block_bwd import block_backward, block_backward_reference
        x_win, *tensors = ctx.saved_tensors
        ops = ctx.ops.with_tensors(tensors)
        fn = block_backward if x_win.is_cuda else block_backward_reference
        dx, dtensors = fn(x_win, dout.contiguous(), ops, ctx.labels,
                          ctx.dropout)
        return (dx, None, None, None, *dtensors)


def fused_swin_block(x_win: torch.Tensor, ops: BlockOperands,
                     labels: Optional[torch.Tensor] = None,
                     dropout: Dropout = NO_DROPOUT) -> torch.Tensor:
    """Run one Swin block on windowed content tokens.

    Args:
      x_win: ``[B, P, M, C]`` content window tokens (pre-LN).
      ops: :func:`make_operands` of the block for this geometry.
      labels: ``[P, N]`` int32 shift-region labels, -1 on the always-
        attendable fold/prompt columns, or None (no mask).
      dropout: seeds and rates of the counter-based dropout.

    CUDA tensors run ``csrc/fused_block.cu`` (bf16 ``x_win``); CPU
    tensors run :func:`block_reference`.  When grad is enabled and
    ``x_win`` or an operand requires it, the call is differentiable
    (:class:`FusedBlockFunction`).
    """
    _check_args(x_win, ops, labels)
    tensors = ops.tensors()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x_win, *tensors)):
        return FusedBlockFunction.apply(x_win, labels, ops, dropout,
                                        *tensors)
    return _forward(x_win, ops, labels, dropout)


fused_swin_block.launches = 0


def labels_tensor(labels: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    return None if labels is None else torch.as_tensor(
        np.ascontiguousarray(labels, np.int32), device=device)
