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
XLA path (:func:`kernel_matmul_dtype` picks it).  ``x_win`` may be fp32
or bf16 on both paths: LN statistics, softmax and the residuals are fp32,
and the output takes x's dtype, as the JAX kernel's does.

The bias is ``[H, M, N]``: the content part from the relative-position
module's per-axis tables, then the fold column and the prompt-token
columns.  The forward kernels build it in shared memory from those
factors (:class:`BiasFactors`, :func:`bias_tables`; :func:`table_bias` is
the plain version of that build), and so does the backward kernel; the
plain version and autograd take the assembled array, so the gradients to
the positional-bias parameters flow through it (the backward kernel
writes the gradient of that array).

The kernels (``csrc/fused_block.cu``, and ``csrc/fused_block_bwd.cu`` for
the gradient, ``ops/fused_block_bwd.py``) run for CUDA tensors; CPU
tensors take :func:`block_reference` and its autograd.  The one
arithmetic difference: the kernel feeds the (dropped) softmax
probabilities to its P.V tensor-core product as bf16, the plain version
(like the JAX ``_block_reference``) keeps them fp32.
``fused_swin_block.launches`` counts the forward kernel's launches, and
``fused_swin_block.launches_by_shape`` the same launches by the
per-sample shape of ``x_win`` (``(P, M, C)``).
"""

from __future__ import annotations

import collections
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
# Activation dtypes the kernels read and write (one flag per launch).
ACT_DTYPES = (torch.float32, torch.bfloat16)


def is_f32(t: torch.Tensor) -> int:
    """The kernels' activation-dtype flag of ``t`` (1: fp32, 0: bf16)."""
    return int(t.dtype == torch.float32)


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


def kernel_matmul_dtype(dtype: torch.dtype, device) -> torch.dtype:
    """Matmul operand dtype of a model in ``dtype`` on ``device``: bf16 on
    the card, where the kernels compute (the JAX kernels round their
    matmul operands to bf16 whatever the activations' dtype), else the
    model's own (the JAX XLA path on the CPU)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else dtype


def round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 tensor holding ``t`` rounded to ``dtype`` (identity for fp32)."""
    return t.float() if dtype == torch.float32 else t.to(dtype).float()


def matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """``a @ b`` with operands rounded to ``dtype`` and fp32 sums."""
    return round_to(a, dtype) @ round_to(b, dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class BiasFactors:
    """The content part of a block's bias as ``models/relative_pe.py``
    builds it: ``((R[ih_i, ih_j] + Cw[iw_i, iw_j]) + D[id_i, id_j]) / 3 *
    scale`` for content rows and keys i, j.

    ``axes``: the per-axis tables ``(R [H, ph, ph], Cw [H, pw, pw], D [H,
    pd, pd])`` (fp32, no graph); ``index``: ``[M]`` flat position of each
    content row in the ``(ph, pw, pd)`` window (``arange`` when padded,
    ``content_indices`` when pad-folded); ``scale``: the module's
    embedding scale."""

    axes: tuple
    index: torch.Tensor
    scale: float

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(int(t.shape[-1]) for t in self.axes)

    def coords(self) -> torch.Tensor:
        """``[M, 3]`` int64 window coordinates (ih, iw, id) of the rows."""
        _, pw, pd = self.dims
        i = self.index.to(torch.int64)
        return torch.stack([i // (pw * pd), (i // pd) % pw, i % pd], -1)


@dataclasses.dataclass
class BlockOperands:
    """Everything one block call needs besides ``x``, the labels and the
    dropout seeds.

    ``params`` hold fp32 tensors in (in, out) layout; ``bias`` is the
    assembled ``[H, M, N]`` fp32 bias; ``ext_k``/``ext_v`` the ``[E, C]``
    extra K/V rows (None when E = 0).  In training they are built from
    tensors that require grad and carry it.  ``drop_cols`` is the key
    count of the attention-dropout counter (``N`` plus the JAX kernel's
    fold alignment columns).  ``factors`` are the bias's content factors
    and ``fold_mode`` says whether column ``M`` is a fold column; the
    forward kernels need both.  ``kernel`` holds the same operands,
    detached, in the CUDA kernels' layout, built by :func:`make_operands`
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
    factors: Optional[BiasFactors] = None
    fold_mode: int = FOLD_NONE

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


def qkv_kernel_weight(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """(in, out) ``[C, C]`` q/k/v weights -> the kernels' bf16
    ``[H, 3, DHP, C]``: each head's output columns stored transposed (out,
    in) for the tensor-core B operand and zero-padded to ``DHP``, the head
    dim rounded up to a multiple of 16 (the k-step).  Shared by
    ``csrc/fused_block.cu`` and ``csrc/window_attention.cu``."""
    c = wq.shape[0]
    dh = c // num_heads
    dhp = -(-dh // 16) * 16

    def heads(w):   # (in, out) [C, C] -> [H, DHP, C]
        return torch.nn.functional.pad(
            w.detach().float().t().reshape(num_heads, dh, c),
            (0, 0, 0, dhp - dh))

    return torch.stack([heads(wq), heads(wk), heads(wv)], dim=1).to(
        torch.bfloat16).contiguous()


def bias_tables(ops: BlockOperands, bias: torch.Tensor):
    """The forward kernels' bias operands: ``pe_tab`` ``[H, tabw]`` fp32,
    each head's R, Cw and D tables flattened, its ``E`` extra columns (row
    0's: the prompt columns, after the fold column's slot) and, with a
    fold, its fold column ``[M]``; ``pe_coord`` ``[M]`` int32, each row's
    window coordinate packed as ``ih | iw << 8 | id << 16``, plus ``1 <<
    24`` where the next row is ``(ih, iw, id + 1)``, whose key shares ``R
    + Cw`` (``csrc/fused_block_common.cuh::FactoredBias``)."""
    return factor_tables(ops.factors, bias, ops.fold_mode != FOLD_NONE)


def factor_tables(f: BiasFactors, bias: torch.Tensor, fold: bool):
    """:func:`bias_tables` of the content factors ``f`` of ``bias`` (with
    a fold column at index ``M`` when ``fold``)."""
    h, m, _ = bias.shape
    parts = [t.float().reshape(h, -1) for t in f.axes]
    parts.append(bias[:, 0, m:])
    if fold:
        parts.append(bias[:, :, m])
    coords = f.coords()
    nxt = torch.cat([coords[1:], torch.full_like(coords[:1], -1)])
    step = torch.tensor([0, 0, 1], device=coords.device)
    next_in_depth = (nxt == coords + step).all(-1).to(torch.int64)
    packed = (coords[:, 0] | (coords[:, 1] << 8) | (coords[:, 2] << 16)
              | (next_in_depth << 24))
    return (torch.cat(parts, 1).contiguous(),
            packed.to(device=bias.device, dtype=torch.int32).contiguous())


def table_bias(pe_tab: torch.Tensor, pe_coord: torch.Tensor, dims,
               m: int, n: int, fold: bool, scale: float) -> torch.Tensor:
    """Plain version of the bias that B1 and B5 build from
    :func:`bias_tables`' operands: ``[H, M, N]``, with
    ``FactoredBias``'s indexing and order of operations (two adds, the
    division by 3 -- on the card PyTorch's and the kernel's product with
    the fp32 reciprocal --, the scale)."""
    ph, pw, pd = dims
    oc = ph * ph
    od = oc + pw * pw
    oe = od + pd * pd
    h, e = pe_tab.shape[0], n - m
    c = pe_coord.to(torch.int64)
    ih, iw, id_ = c & 255, (c >> 8) & 255, (c >> 16) & 255
    t = pe_tab[:, ih[:, None] * ph + ih[None, :]] \
        + pe_tab[:, oc + iw[:, None] * pw + iw[None, :]]
    t = t + pe_tab[:, od + id_[:, None] * pd + id_[None, :]]
    ext = pe_tab[:, None, oe:oe + e].expand(h, m, e)
    if fold:
        ext = torch.cat([pe_tab[:, oe + e:oe + e + m, None], ext[:, :, 1:]],
                        -1)
    return torch.cat([t / 3.0 * scale, ext], -1)


def pack_k16(w: torch.Tensor) -> torch.Tensor:
    """The forward kernels' k-packed weight layout (``warp_gemm_acc``): along
    the last (k) dim, within each block of 16, the values 2c, 2c + 1, 8 +
    2c, 9 + 2c of lane quad c become adjacent."""
    *lead, k = w.shape
    return w.reshape(*lead, k // 16, 2, 4, 2).transpose(-3, -2).reshape(
        *lead, k).contiguous()


def _kernel_layout(ops: BlockOperands) -> dict:
    """Operands in the CUDA kernels' layout, k-packed (:func:`pack_k16`)
    for the tensor-core B operand: the forward's bf16 weights stored
    transposed (out, in), each head's q|k|v rows zero-padded to a
    multiple of 16 (the k-step, :func:`qkv_kernel_weight`); the extra K/V
    rows per head with the same padding; the fp32 vectors; the bias
    tables (:func:`bias_tables`, where the operands carry factors); and
    the backward's weights in (in, out) layout: ``wproj_io_kp``,
    ``wmlp_io_kp`` and ``wqkv_io_kp`` (``[C, 3C]``, Wq | Wk | Wv) for
    d(attention output), d(LN2 output) and the head sum of d(LN1
    output)."""
    p = {k: v.detach() for k, v in ops.params.items()}
    c = p["wq"].shape[0]
    h = ops.num_heads
    dh = c // h
    dhp = -(-dh // 16) * 16
    wqkv = qkv_kernel_weight(p["wq"], p["wk"], p["wv"], h)
    e = ops.n_ext
    ext = torch.zeros(h, 2, max(e, 1), dhp, device=wqkv.device)
    if e:
        for i, rows in enumerate((ops.ext_k, ops.ext_v)):
            ext[:, i, :e, :dh] = rows.detach().float().reshape(
                e, h, dh).permute(1, 0, 2)
    bf = torch.bfloat16
    out = {
        "wqkv_kp": pack_k16(wqkv),
        "ext_kv": ext.to(bf).contiguous(),
        "wproj_kp": pack_k16(p["wproj"].t().to(bf)),
        "wmlp_kp": pack_k16(p["wmlp"].t().to(bf)),
        "wproj_io_kp": pack_k16(p["wproj"].to(bf)),
        "wmlp_io_kp": pack_k16(p["wmlp"].to(bf)),
        "wqkv_io_kp": pack_k16(torch.cat([p["wq"], p["wk"], p["wv"]], 1)
                               .to(bf)),
        **{k: p[k].float().contiguous() for k in
           ("ln1_scale", "ln1_bias", "bproj", "ln2_scale", "ln2_bias",
            "bmlp")},
    }
    if ops.factors is not None:
        out["pe_tab"], out["pe_coord"] = bias_tables(
            ops, ops.bias.detach().float())
    return out


def make_operands(params: dict, tokens: Optional[torch.Tensor],
                  bias: torch.Tensor, fold_mode: int, num_heads: int,
                  scale: float, matmul_dtype: torch.dtype = torch.bfloat16,
                  factors: Optional[BiasFactors] = None) -> BlockOperands:
    """Assemble a block's operands.  Under ``torch.no_grad`` the result
    holds no graph (callers cache it per geometry); with grad enabled the
    extra rows and the bias keep theirs, so gradients reach the prompt
    tokens, the block parameters and the positional-bias parameters.
    ``factors``: the content factors of ``bias`` (the forward kernels
    read them in its place)."""
    params = {k: params[k].float() for k in PARAM_KEYS}
    ext_k, ext_v = extra_kv_rows(params, tokens, fold_mode, matmul_dtype)
    m, n = bias.shape[1], bias.shape[2]
    n_tok = 0 if tokens is None else tokens.shape[0]
    drop_cols = n + (fold_width(m, n_tok) - 1 if fold_mode else 0)
    if factors is not None and tuple(factors.index.shape) != (m,):
        raise ValueError(f"make_operands: bias factors index {m} rows, got "
                         f"{tuple(factors.index.shape)}")
    ops = BlockOperands(params, bias.float(), ext_k, ext_v, num_heads,
                        float(scale), matmul_dtype, drop_cols,
                        factors=factors, fold_mode=fold_mode)
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
                labels: Optional[torch.Tensor],
                name: str = "fused_swin_block") -> None:
    """Shape and type checks common to both paths, naming the argument."""
    if x_win.dim() != 4:
        raise ValueError(f"{name}: x_win must be [B, P, M, C], "
                         f"got shape {tuple(x_win.shape)}")
    _, pw, m, c = x_win.shape
    h = ops.num_heads
    if ops.params["wq"].shape != (c, c) or c % h:
        raise ValueError(f"{name}: x_win has C={c}, operands "
                         f"have wq {tuple(ops.params['wq'].shape)} and "
                         f"{h} heads")
    n = m + ops.n_ext
    if tuple(ops.bias.shape) != (h, m, n):
        raise ValueError(f"{name}: bias must be [H, M, N] = "
                         f"{(h, m, n)}, got {tuple(ops.bias.shape)}")
    if labels is not None and tuple(labels.shape) != (pw, n):
        raise ValueError(f"{name}: labels must be [P, N] = "
                         f"{(pw, n)}, got {tuple(labels.shape)}")


def check_kernel_args(x_win: torch.Tensor, ops: BlockOperands,
                      labels: Optional[torch.Tensor],
                      name: str = "fused_swin_block") -> None:
    """What the CUDA kernels take; raises naming the offending argument."""
    if not x_win.is_cuda:
        raise ValueError(f"{name}: x_win must be on a CUDA device")
    if x_win.dtype not in ACT_DTYPES:
        raise ValueError(f"{name}: x_win must be float32 or bfloat16, got "
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
    if "pe_tab" not in ops.kernel:
        raise ValueError(f"{name}: ops carry no bias factors (make_operands "
                         "with factors=BiasFactors(...))")
    if max(ops.factors.dims) > 255:
        raise ValueError(f"{name}: the kernel takes window dims up to 255, "
                         f"got {ops.factors.dims}")
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


def _launch(x_win: torch.Tensor, out: Optional[torch.Tensor],
            ops: BlockOperands, labels: Optional[torch.Tensor],
            dropout: Dropout, info=None) -> int:
    """Call ``csrc/fused_block.cu``: launch into ``out``, or (``info`` an
    int[7] ctypes array) only size the launch."""
    import ctypes
    from . import kernels
    b, pw, m, c = x_win.shape
    k = ops.kernel
    return kernels.library().mivp_fused_swin_block(
        x_win.data_ptr(), kernels.ptr(out), k["wqkv_kp"].data_ptr(),
        k["ext_kv"].data_ptr(), k["pe_tab"].data_ptr(),
        k["pe_coord"].data_ptr(), kernels.ptr(labels),
        k["ln1_scale"].data_ptr(), k["ln1_bias"].data_ptr(),
        k["wproj_kp"].data_ptr(), k["bproj"].data_ptr(),
        k["ln2_scale"].data_ptr(), k["ln2_bias"].data_ptr(),
        k["wmlp_kp"].data_ptr(), k["bmlp"].data_ptr(),
        None if info is None else ctypes.addressof(info), b * pw, m, c,
        ops.num_heads, c // ops.num_heads, ops.n_ext, pw, *ops.factors.dims,
        int(ops.fold_mode != FOLD_NONE), ops.scale, ops.factors.scale,
        *dropout.kernel_args(), ops.drop_cols, is_f32(x_win),
        kernels.stream_of(x_win))


def launch_info(x_win: torch.Tensor, ops: BlockOperands,
                labels: Optional[torch.Tensor] = None,
                dropout: Dropout = NO_DROPOUT) -> dict:
    """Shape of B1's launch for these arguments (CUDA only; nothing
    runs): cluster size (CTAs per window), CTAs, threads per CTA, CTAs
    per SM, registers, spill bytes per thread, shared bytes per CTA."""
    from . import kernels
    check_kernel_args(x_win, ops, labels)
    info = kernels.info_array()
    kernels.check(_launch(x_win, None, ops, labels, dropout, info),
                  "fused_swin_block")
    return kernels.info_dict(info)


def _forward(x_win: torch.Tensor, ops: BlockOperands,
             labels: Optional[torch.Tensor], dropout: Dropout
             ) -> torch.Tensor:
    """One block forward: the kernel for CUDA tensors, else the plain
    version."""
    if not x_win.is_cuda:
        return block_reference(x_win, ops, labels, dropout)
    check_kernel_args(x_win, ops, labels)
    from . import kernels
    out = torch.empty_like(x_win)
    kernels.check(_launch(x_win, out, ops, labels, dropout),
                  "fused_swin_block")
    fused_swin_block.launches += 1
    fused_swin_block.launches_by_shape[tuple(x_win.shape[1:])] += 1
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

    CUDA tensors run ``csrc/fused_block.cu`` (fp32 or bf16 ``x_win``); CPU
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
fused_swin_block.launches_by_shape = collections.Counter()


def labels_tensor(labels: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    return None if labels is None else torch.as_tensor(
        np.ascontiguousarray(labels, np.int32), device=device)
