"""Window attention of the unfused Swin block path: plain PyTorch
versions, CUDA kernel wrappers and launch counters.

Counterpart of the JAX package's ``ops/window_attention_pallas.py``: three
public functions, each with a plain version (``*_reference``) and a
``launches`` counter.

* :func:`fused_window_attention_packed_qkv` (TPU kernel
  ``_packed_qkv_kernel``, B6): the q/k/v projections of the LN1 output
  ``y`` in the kernel, then attention over the first ``m_len`` (content)
  query rows.  q/k/v are rounded to bf16 after the projection, and the
  fp32 scores are multiplied by ``scale``.
* :func:`fused_window_attention_packed` (``_packed_kernel``, B7) and
  :func:`fused_window_attention` (``_attention_kernel``, B8): attention on
  q/k/v that are already projected; ``scale`` is folded into q in fp32,
  then q/k/v are rounded to bf16.

Then, for every head::

    s = (s + bias) * mask         mask: 0/1, multiplicative (masked
                                  logits become 0, not -inf)
    out = round(softmax(s)) @ v   fp32 softmax with max subtraction, P
                                  rounded to bf16 before P.V

Shapes are the JAX package's: ``[B, P, N, C]`` / ``[B, P, M, C]`` /
``[B, P, M, H, Dh]``, bias ``[H, M, N]``.  The mask comes as the ``[P, N]``
int32 shift-region labels the fused block takes (label -1 on the prompt
key columns): a key may be attended where its label equals the query's or
is negative.  The kernel compares labels; the plain version expands them
into the float ``[P, M, N]`` mask (:func:`label_mask`).

``matmul_dtype`` is the rounding of the plain versions: bf16 for the
kernels' arithmetic (bf16 operands, fp32 sums), or fp32 for parity with
the JAX model's fp32 XLA path.  CUDA tensors run ``csrc/
window_attention.cu`` (bf16 operands; B7 and B8 are one kernel, B6 the
same kernel with the projection prologue); CPU tensors run the plain
version.  Both take fp32 or bf16 inputs and return the inputs' dtype, as
the JAX kernels' ``out_shape`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_block import (ACT_DTYPES, KERNEL_HEAD_DIMS, is_f32, matmul,
                          qkv_kernel_weight, round_to)


def label_mask(labels: torch.Tensor, m: int) -> torch.Tensor:
    """``[P, N]`` labels -> the float ``[P, m, N]`` 0/1 mask of the first
    ``m`` (content) query rows: 1 where the key's label equals the query's
    or is negative (prompt columns)."""
    lab = labels.long()
    return ((lab[:, :m, None] == lab[:, None, :])
            | (lab[:, None, :] < 0)).float()


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[BP, R, C]`` -> ``[BP, H, R, Dh]``."""
    bp, r, c = t.shape
    return t.reshape(bp, r, num_heads, c // num_heads).transpose(1, 2)


def _attend(q, k, v, bias, labels, scale: float, matmul_dtype):
    """Plain attention of head-split, already rounded q ``[BP, H, M, Dh]``
    and k/v ``[BP, H, N, Dh]``; returns ``[BP, M, C]`` fp32."""
    bp, h, m, _ = q.shape
    s = (q @ k.transpose(-1, -2)) * scale + bias.float()
    if labels is not None:
        mask = label_mask(labels.to(s.device), m)
        s = s * mask.repeat(bp // mask.shape[0], 1, 1)[:, None]
    probs = torch.softmax(s, dim=-1)
    out = round_to(probs, matmul_dtype) @ v
    return out.transpose(1, 2).reshape(bp, m, -1)


def fused_window_attention_packed_qkv_reference(
        y: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
        wv: torch.Tensor, m_len: int, pos_bias: torch.Tensor,
        labels: Optional[torch.Tensor], scale: float, num_heads: int,
        matmul_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of B6: ``y [B, P, N, C]``, ``w* [C, C]`` (in, out) ->
    ``[B, P, m_len, C]`` in y's dtype.  Differentiable."""
    b, p, n, c = y.shape
    dt = matmul_dtype
    yf = y.reshape(b * p, n, c)
    q = round_to(matmul(yf[:, :m_len], wq, dt), dt)
    k = round_to(matmul(yf, wk, dt), dt)
    v = round_to(matmul(yf, wv, dt), dt)
    out = _attend(_heads(q, num_heads), _heads(k, num_heads),
                  _heads(v, num_heads), pos_bias.reshape(num_heads, m_len, n),
                  labels, scale, dt)
    return out.reshape(b, p, m_len, c).to(y.dtype)


def fused_window_attention_packed_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        pos_bias: torch.Tensor, labels: Optional[torch.Tensor],
        scale: float, num_heads: int,
        matmul_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of B7: ``q [B, P, M, C]``, ``k/v [B, P, N, C]`` ->
    ``[B, P, M, C]`` in q's dtype.  Differentiable."""
    b, p, m, c = q.shape
    n = k.shape[2]
    dt = matmul_dtype
    qs = round_to(q.reshape(b * p, m, c).float() * scale, dt)
    ks = round_to(k.reshape(b * p, n, c), dt)
    vs = round_to(v.reshape(b * p, n, c), dt)
    out = _attend(_heads(qs, num_heads), _heads(ks, num_heads),
                  _heads(vs, num_heads), pos_bias.reshape(num_heads, m, n),
                  labels, 1.0, dt)
    return out.reshape(b, p, m, c).to(q.dtype)


def fused_window_attention_reference(
        qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
        pos_bias: torch.Tensor, labels: Optional[torch.Tensor],
        scale: float, matmul_dtype: torch.dtype = torch.bfloat16
        ) -> torch.Tensor:
    """Plain version of B8: ``qh [B, P, M, H, Dh]``, ``kh/vh
    [B, P, N, H, Dh]`` -> ``[B, P, M, H, Dh]``: B7's function on the same
    memory."""
    b, p, m, h, dh = qh.shape
    flat = lambda t: t.reshape(b, p, t.shape[2], h * dh)  # noqa: E731
    out = fused_window_attention_packed_reference(
        flat(qh), flat(kh), flat(vh), pos_bias, labels, scale, h,
        matmul_dtype)
    return out.reshape(b, p, m, h, dh)


def _check_shapes(name, q, kv, m, num_heads, pos_bias, labels):
    """Shape checks common to both paths, naming the argument."""
    if q.dim() != 4 or kv.dim() != 4 or q.shape[:2] != kv.shape[:2] \
            or q.shape[-1] != kv.shape[-1]:
        raise ValueError(f"{name}: q/y and k/v must be [B, P, rows, C] with "
                         f"equal B, P and C; got {tuple(q.shape)} and "
                         f"{tuple(kv.shape)}")
    _, pw, _, c = kv.shape
    n = kv.shape[2]
    if c % num_heads:
        raise ValueError(f"{name}: C={c} is not a multiple of {num_heads} "
                         "heads")
    if m < 1 or (q is kv and m > n):     # B6: queries are the first rows
        raise ValueError(f"{name}: {m} query rows for {n} keys")
    if pos_bias.numel() != num_heads * m * n:
        raise ValueError(f"{name}: bias must be [H, M, N] = "
                         f"{(num_heads, m, n)}, got {tuple(pos_bias.shape)}")
    if labels is not None and (labels.dim() != 2 or labels.shape[1] != n
                               or pw % labels.shape[0]):
        raise ValueError(f"{name}: labels must be [P, N] with N={n} and P "
                         f"dividing {pw}, got {tuple(labels.shape)}")


def _launch(name, inputs, y, wqkv, q, k, v, dims, pos_bias, labels, scale,
            num_heads, matmul_dtype) -> torch.Tensor:
    """Check what ``csrc/window_attention.cu`` takes, raising with the
    argument's name, and launch it once.  ``inputs``: every tensor the
    call reads or differentiates; ``dims``: ``(B, P, M, N, C)``.  Returns
    ``[B, P, M, C]``."""
    b, pw, m, n, c = dims
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise ValueError(f"{name}: the inputs require grad; the kernel has "
                         "no backward")
    if matmul_dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel computes with bf16 operands, "
                         f"asked for {matmul_dtype}")
    ref = inputs[0]
    act = y if y is not None else q
    for t in (y, wqkv, q, k, v):
        if t is None:
            continue
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name}: every input must be on the first "
                             f"input's CUDA device, got {t.device}")
        want = torch.bfloat16 if t is wqkv else act.dtype
        if act.dtype not in ACT_DTYPES or t.dtype != want \
                or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous float32 or "
                             f"bfloat16 of one dtype (wqkv bfloat16), got "
                             f"{t.dtype}")
    dh = c // num_heads
    if dh not in KERNEL_HEAD_DIMS or (y is not None and c % 16):
        raise ValueError(f"{name}: the kernel takes head dims in "
                         f"{KERNEL_HEAD_DIMS} (and C % 16 == 0 with the "
                         f"projections); got C={c}, head dim {dh}")
    bias = pos_bias.reshape(num_heads, m, n)
    if bias.device != ref.device or bias.dtype != torch.float32 \
            or not bias.is_contiguous():
        raise ValueError(f"{name}: bias must be a contiguous float32 tensor "
                         f"on the inputs' device")
    if labels is not None and (labels.device != ref.device
                               or labels.dtype != torch.int32
                               or not labels.is_contiguous()):
        raise ValueError(f"{name}: labels must be a contiguous int32 tensor "
                         f"on the inputs' device, got {labels.dtype} on "
                         f"{labels.device}")
    from . import kernels
    out = torch.empty((b, pw, m, c), device=ref.device, dtype=act.dtype)
    err = kernels.library().mivp_window_attention(
        kernels.ptr(y), kernels.ptr(wqkv), kernels.ptr(q), kernels.ptr(k),
        kernels.ptr(v), bias.data_ptr(), kernels.ptr(labels), out.data_ptr(),
        b * pw, m, n, c, num_heads,
        0 if labels is None else labels.shape[0], float(scale), is_f32(act),
        kernels.stream_of(ref))
    kernels.check(err, name)
    return out


def fused_window_attention_packed_qkv(
        y: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
        wv: torch.Tensor, m_len: int, pos_bias: torch.Tensor,
        labels: Optional[torch.Tensor], scale: float, num_heads: int,
        matmul_dtype: torch.dtype = torch.bfloat16,
        wqkv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B6: attention of the first ``m_len`` rows of ``y [B, P, N, C]``
    over all N, with q/k/v projected by ``w* [C, C]`` (in, out) inside the
    kernel.  Returns ``[B, P, m_len, C]`` (pre-proj).

    ``wqkv`` (CUDA only): the cached
    :func:`~.fused_block.qkv_kernel_weight` of the three weights."""
    name = "fused_window_attention_packed_qkv"
    _check_shapes(name, y, y, m_len, num_heads, pos_bias, labels)
    if not y.is_cuda:
        return fused_window_attention_packed_qkv_reference(
            y, wq, wk, wv, m_len, pos_bias, labels, scale, num_heads,
            matmul_dtype)
    if wqkv is None:
        wqkv = qkv_kernel_weight(wq, wk, wv, num_heads)
    if tuple(wqkv.shape[:2]) != (num_heads, 3) or wqkv.shape[-1] != y.shape[-1]:
        raise ValueError(f"{name}: wqkv must be [H, 3, DHP, C], got "
                         f"{tuple(wqkv.shape)}")
    b, p, n, c = y.shape
    out = _launch(name, (y, wq, wk, wv), y, wqkv, None, None, None,
                  (b, p, m_len, n, c), pos_bias, labels, scale, num_heads,
                  matmul_dtype)
    fused_window_attention_packed_qkv.launches += 1
    return out


fused_window_attention_packed_qkv.launches = 0


def fused_window_attention_packed(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        pos_bias: torch.Tensor, labels: Optional[torch.Tensor],
        scale: float, num_heads: int,
        matmul_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B7: attention of ``q [B, P, M, C]`` over ``k/v [B, P, N, C]`` with
    the heads not split.  Returns ``[B, P, M, C]``."""
    name = "fused_window_attention_packed"
    _check_shapes(name, q, k, q.shape[2], num_heads, pos_bias, labels)
    if k.shape != v.shape:
        raise ValueError(f"{name}: k and v differ: {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if not q.is_cuda:
        return fused_window_attention_packed_reference(
            q, k, v, pos_bias, labels, scale, num_heads, matmul_dtype)
    b, p, m, c = q.shape
    out = _launch(name, (q, k, v), None, None, q, k, v,
                  (b, p, m, k.shape[2], c), pos_bias, labels, scale,
                  num_heads, matmul_dtype)
    fused_window_attention_packed.launches += 1
    return out


fused_window_attention_packed.launches = 0


def fused_window_attention(
        qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
        pos_bias: torch.Tensor, labels: Optional[torch.Tensor],
        scale: float, matmul_dtype: torch.dtype = torch.bfloat16
        ) -> torch.Tensor:
    """B8: per-head attention of ``qh [B, P, M, H, Dh]`` over ``kh/vh
    [B, P, N, H, Dh]``.  Returns ``[B, P, M, H, Dh]``.  The kernel is
    B7's: ``[.., H, Dh]`` is ``[.., C]`` in memory."""
    name = "fused_window_attention"
    if qh.dim() != 5 or kh.shape != vh.shape or kh.dim() != 5 \
            or qh.shape[3:] != kh.shape[3:]:
        raise ValueError(f"{name}: qh must be [B, P, M, H, Dh] and kh/vh "
                         f"[B, P, N, H, Dh]; got {tuple(qh.shape)}, "
                         f"{tuple(kh.shape)}, {tuple(vh.shape)}")
    b, p, m, h, dh = qh.shape
    flat = lambda t: t.reshape(b, p, t.shape[2], h * dh)  # noqa: E731
    _check_shapes(name, flat(qh), flat(kh), m, h, pos_bias, labels)
    if not qh.is_cuda:
        return fused_window_attention_reference(
            qh, kh, vh, pos_bias, labels, scale, matmul_dtype)
    out = _launch(name, (qh, kh, vh), None, None, qh, kh, vh,
                  (b, p, m, kh.shape[2], h * dh), pos_bias, labels, scale, h,
                  matmul_dtype)
    fused_window_attention.launches += 1
    return out.reshape(b, p, m, h, dh)


fused_window_attention.launches = 0
