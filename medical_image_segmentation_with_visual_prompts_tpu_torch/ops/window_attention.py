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
  :func:`fused_window_attention_packed_qkv_prompts` is the same function
  on y's content rows and the prompt rows that every window shares,
  given apart (the unfused block's call): the kernel projects the prompt
  rows' K/V once per call and stages only the content rows per window.
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

The keyword ``factors`` (:class:`BiasTables`, the bias's factors) makes
the kernel build ``pos_bias`` in shared memory (as B1 does) instead of
reading the ``[H, M, N]`` array; it changes no bit of the output, and
the plain versions ignore it.  The unfused block passes it; a caller
without factors gets the dense form, which the tests hold equal.

:func:`attention_plan` sizes a launch (threads, shared bytes, CTAs per
SM; one CTA per (window, head)) from the shapes alone; :func:`launch_info`
asks the card for the launch's shape.  ``.launches`` counts each
kernel's launches (B6's on :func:`fused_window_attention_packed_qkv`,
whichever of its two functions launched it), ``.factor_launches``
those that built the bias from its factors, and B6's
``.launches_by_shape`` its launches by the per-sample content shape
``(P, M, C)``.

Training: each public function is a ``torch.autograd.Function``
(:class:`PackedQKVFunction` for B6, :class:`AttentionFunction` for B7
and B8) whose forward is the kernel on a CUDA tensor and the plain
version on a CPU tensor, and whose backward is the JAX package's
recompute (``_fused_bwd``, ``_fused_packed_bwd``,
``_fused_packed_qkv_bwd``): the plain version at fp32, recomputed from
the saved inputs and differentiated by autograd (B6 projects q/k/v
again in fp32, not the kernel's bf16 operands).  It returns the
gradients of y (and of the prompt rows, summed over every window), of
the weights or q/k/v, and of the dense ``[H, M, N]`` bias, summed over
windows; the bias keeps its graph to the positional-bias parameters
while the kernel reads its factors.  The backward launches no kernel and is not counted.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from .fused_block import (ACT_DTYPES, KERNEL_HEAD_DIMS, BiasFactors,
                          factor_tables, is_f32, matmul, qkv_kernel_weight,
                          round_to, table_bias)

SMEM_PER_CTA = 227 * 1024     # shared bytes a CTA may use (H100)
SMEM_PER_SM = 228 * 1024      # shared memory of an SM
SMEM_RESERVED = 1024          # reserved per resident CTA
MAX_THREADS = 256             # threads of a CTA (8 warps of 32 rows)


@dataclasses.dataclass(frozen=True, eq=False)
class BiasTables:
    """The ``[H, M, N]`` bias of a full window as the kernel builds it in
    shared memory (``csrc/window_attention.cu::WindowBias``, the values of
    ``fused_block_common.cuh::FactoredBias``): ``tab`` ``[H, tabw]`` fp32
    (each head's per-axis tables of the ``dims`` window, then its prompt
    columns), ``coord`` ``[M]`` int32 (each row's packed window
    coordinate) and the embedding ``scale`` (``fused_block.factor_tables``;
    :meth:`dense` is the plain version of the build).  The rows are the
    whole window in order (M = ph * pw * pd) and the depth pd is 2, 4 or
    8: then each pair of keys shares its R + Cw terms and each lane its
    depth terms."""

    tab: torch.Tensor
    coord: torch.Tensor
    dims: Tuple[int, int, int]
    scale: float

    @staticmethod
    def takes(dims) -> bool:
        """Whether a full window of these dims has a factor form."""
        return dims[2] in (2, 4, 8) and max(dims) <= 255

    @classmethod
    def from_factors(cls, factors: BiasFactors,
                     bias: torch.Tensor) -> "BiasTables":
        """The tables of ``bias`` ``[H, M, N]``, whose content part
        ``factors`` hold for the whole window in order (no fold column);
        raises ValueError for other factors."""
        m = bias.shape[1]
        if not cls.takes(factors.dims) or \
                m != factors.dims[0] * factors.dims[1] * factors.dims[2] or \
                not torch.equal(factors.index.cpu(), torch.arange(m)):
            raise ValueError(f"BiasTables: the factors must index a whole "
                             f"window of depth 2, 4 or 8 in order; got dims "
                             f"{factors.dims} for {m} rows")
        tab, coord = factor_tables(factors, bias, False)
        return cls(tab, coord, factors.dims, factors.scale)

    def dense(self, n: int) -> torch.Tensor:
        """The ``[H, M, n]`` bias the kernel builds from the tables."""
        return table_bias(self.tab, self.coord, self.dims,
                          self.coord.shape[0], n, False, self.scale)


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


def _recompute(plain, inputs, needs, g):
    """The JAX custom VJPs' backward (``_fused_bwd``,
    ``_fused_packed_bwd``, ``_fused_packed_qkv_bwd``): ``plain``, a plain
    version at fp32, recomputed from the saved ``inputs`` and
    differentiated by autograd for the output gradient ``g``.  Returns
    the gradients of the inputs that ``needs`` flags (None elsewhere) in
    the inputs' dtypes."""
    leaves = [None if t is None else t.detach().float().requires_grad_(n)
              for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        out = plain(*leaves)
    got = iter(torch.autograd.grad(
        out, [t for t, n in zip(leaves, needs) if n], g.float()))
    return [next(got).to(t.dtype) if n else None
            for t, n in zip(inputs, needs)]


class AttentionFunction(torch.autograd.Function):
    """B7 (and B8, on the same memory) with the JAX ``_fused_packed_bwd``:
    ``forward(fwd, q [B, P, M, C], k/v [B, P, N, C], bias [H, M, N],
    labels, scale, num_heads)`` returns ``fwd()``, the kernel or plain
    call on those tensors."""

    @staticmethod
    def forward(ctx, fwd, q, k, v, bias, labels, scale, num_heads):
        ctx.save_for_backward(q, k, v, bias, labels)
        ctx.scale, ctx.num_heads = scale, num_heads
        return fwd()

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, labels = ctx.saved_tensors

        def plain(q, k, v, bias):
            return fused_window_attention_packed_reference(
                q, k, v, bias, labels, ctx.scale, ctx.num_heads,
                torch.float32)

        return (None, *_recompute(plain, (q, k, v, bias),
                                  ctx.needs_input_grad[1:5], g),
                None, None, None)


class PackedQKVFunction(torch.autograd.Function):
    """B6 with the JAX ``_fused_packed_qkv_bwd``: ``forward(fwd, y, y_prompt,
    wq, wk, wv, bias [H, M, N], labels, m_len, scale, num_heads)`` returns
    ``fwd()``.  ``y [B, P, N, C]`` with ``y_prompt`` None, or the content
    rows ``y [B, P, M, C]`` and the prompt rows ``y_prompt [E, C]`` that
    follow them in every window (their gradient summed over the
    windows)."""

    @staticmethod
    def forward(ctx, fwd, y, y_prompt, wq, wk, wv, bias, labels, m_len,
                scale, num_heads):
        ctx.save_for_backward(y, y_prompt, wq, wk, wv, bias, labels)
        ctx.m, ctx.scale, ctx.num_heads = m_len, scale, num_heads
        return fwd()

    @staticmethod
    def backward(ctx, g):
        y, y_prompt, wq, wk, wv, bias, labels = ctx.saved_tensors

        def plain(y, y_prompt, wq, wk, wv, bias):
            if y_prompt is not None:
                b, p, _, c = y.shape
                y = torch.cat([y, y_prompt.expand(b, p, -1, c)], 2)
            return fused_window_attention_packed_qkv_reference(
                y, wq, wk, wv, ctx.m, bias, labels, ctx.scale,
                ctx.num_heads, torch.float32)

        return (None, *_recompute(plain, (y, y_prompt, wq, wk, wv, bias),
                                  ctx.needs_input_grad[1:7], g),
                None, None, None, None)


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def attention_smem(m: int, n: int, c: int, heads: int, proj: bool,
                   hoisted: bool = False, tabw: int = 0) -> int:
    """Shared bytes per CTA of a launch (``csrc/window_attention.cu``'s
    ``Smem``, region for region): B6's y rows (the content rows, and the
    prompt rows unless ``hoisted``) and, at head dims up to 16, its Q; K,
    V^T, the labels and, for the factor form (``tabw`` > 0), the head's
    table and the coordinates."""
    dhk, npad = _pad16(c // heads), _pad16(n)
    yrows = -(-(m if hoisted else n) // 32) * 32 if proj else 0
    qrows = -(-m // 32) * 32 if proj and dhk == 16 else 0
    off = _pad16(yrows * (c + 8) * 2)
    for size in (qrows * (dhk + 8) * 2, npad * (dhk + 8) * 2,
                 dhk * (npad + 8) * 2, npad * 4):
        off = _pad16(off + size)
    if tabw:
        off = _pad16(_pad16(off + (tabw + 16) * 4) + m * 4)
    return off


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """A launch of one CTA per (window, head): ``threads`` per CTA,
    ``smem`` shared bytes per CTA and ``ctas_per_sm`` that fit by threads,
    registers and shared memory."""

    threads: int
    smem: int
    ctas_per_sm: int


@functools.lru_cache(maxsize=256)
def attention_plan(m: int, n: int, c: int, heads: int, proj: bool,
                   hoisted: bool = False, tabw: int = 0) -> AttentionPlan:
    """The launch of one call, from the shapes alone: B6 (``proj``, with
    the prompt rows apart when ``hoisted``) or B7/B8, the factor form when
    ``tabw`` > 0.  One CTA of up to 256 threads (a warp per 32 query rows)
    per (window, head).  Raises ValueError where the launch is not
    possible."""
    smem = attention_smem(m, n, c, heads, proj, hoisted, tabw)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"attention_plan: {smem} shared bytes per CTA, "
                         f"more than {SMEM_PER_CTA}")
    threads = min(MAX_THREADS, -(-m // 32) * 32)
    # The kernel's launch bounds hold registers to 80 a thread at head
    # dims up to 16 (3 CTAs of 256 threads per SM), else to 128.
    regs = 80 if _pad16(c // heads) == 16 else 128
    return AttentionPlan(threads, smem,
                         min(2048 // threads, 65536 // (threads * regs),
                             SMEM_PER_SM // (smem + SMEM_RESERVED)))


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


def _check_factors(name, factors, num_heads, m, n, device):
    """What the factor form takes, raising with the argument's name."""
    ph, pw, pd = factors.dims
    tab, coord = factors.tab, factors.coord
    want = ph * ph + pw * pw + pd * pd + n - m
    if tab.dim() != 2 or tab.shape[0] != num_heads or tab.shape[1] < want \
            or tuple(coord.shape) != (m,) or m != ph * pw * pd \
            or not BiasTables.takes(factors.dims):
        raise ValueError(f"{name}: factors must hold tab [H, tabw] with "
                         f"H={num_heads}, tabw >= {want} and coord [{m}] of "
                         f"a whole window of {m} rows, depth 2, 4 or 8; got "
                         f"{tuple(tab.shape)}, {tuple(coord.shape)}, dims "
                         f"{factors.dims}")
    for t, dtype in ((tab, torch.float32), (coord, torch.int32)):
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: factors must be contiguous "
                             f"float32 / int32 tensors on the inputs' "
                             f"device, got {t.dtype} on {t.device}")


def _launch(name, inputs, y, wqkv, q, k, v, dims, pos_bias, labels, scale,
            num_heads, matmul_dtype, factors=None,
            y_prompt=None) -> torch.Tensor:
    """Check what ``csrc/window_attention.cu`` takes, raising with the
    argument's name, and launch it once.  ``inputs``: every tensor the
    call reads (the first sets the device); ``dims``: ``(B, P, M, N, C)``;
    ``y_prompt``: B6's prompt rows ``[N - M, C]``, given apart from y's
    content rows.  Returns ``[B, P, M, C]``."""
    b, pw, m, n, c = dims
    if matmul_dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel computes with bf16 operands, "
                         f"asked for {matmul_dtype}")
    ref = inputs[0]
    act = y if y is not None else q
    for t in (y, y_prompt, wqkv, q, k, v):
        if t is None:
            continue
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name}: every input must be on the first "
                             f"input's CUDA device, got {t.device}")
        want = torch.bfloat16 if t is wqkv else act.dtype
        if act.dtype not in ACT_DTYPES or t.dtype != want \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous, 16-byte "
                             f"aligned float32 or bfloat16 of one dtype "
                             f"(wqkv bfloat16), got {t.dtype}")
    dh = c // num_heads
    if dh not in KERNEL_HEAD_DIMS or (y is not None and c % 16):
        raise ValueError(f"{name}: the kernel takes head dims in "
                         f"{KERNEL_HEAD_DIMS} (and C % 16 == 0 with the "
                         f"projections); got C={c}, head dim {dh}")
    if factors is not None:
        _check_factors(name, factors, num_heads, m, n, ref.device)
        bias, tab, coord = None, factors.tab, factors.coord
        pdims, tabw = factors.dims, factors.tab.shape[1]
    else:
        bias = pos_bias.reshape(num_heads, m, n)
        if bias.device != ref.device or bias.dtype != torch.float32 \
                or not bias.is_contiguous():
            raise ValueError(f"{name}: bias must be a contiguous float32 "
                             f"tensor on the inputs' device")
        tab = coord = None
        pdims, tabw = (0, 0, 0), 0
    if labels is not None and (labels.device != ref.device
                               or labels.dtype != torch.int32
                               or not labels.is_contiguous()):
        raise ValueError(f"{name}: labels must be a contiguous int32 tensor "
                         f"on the inputs' device, got {labels.dtype} on "
                         f"{labels.device}")
    hoisted = y_prompt is not None
    attention_plan(m, n, c, num_heads, y is not None, hoisted, tabw)
    from . import kernels
    out = torch.empty((b, pw, m, c), device=ref.device, dtype=act.dtype)
    prompt_kv = torch.empty((num_heads, 2, n - m, _pad16(dh)),
                            device=ref.device, dtype=torch.bfloat16) \
        if hoisted else None
    mode = 0 if y is None else (2 if hoisted else 1)
    err = kernels.library().mivp_window_attention(
        kernels.ptr(y), kernels.ptr(y_prompt), kernels.ptr(wqkv),
        kernels.ptr(prompt_kv), kernels.ptr(q), kernels.ptr(k),
        kernels.ptr(v), kernels.ptr(bias), kernels.ptr(tab),
        kernels.ptr(coord), kernels.ptr(labels), out.data_ptr(), None,
        b * pw, m, n, c, num_heads, 0 if labels is None else labels.shape[0],
        mode, *pdims, tabw, float(scale),
        0.0 if factors is None else float(factors.scale), is_f32(act),
        kernels.stream_of(ref))
    kernels.check(err, name)
    return out


def launch_info(bp: int, m: int, n: int, c: int, heads: int, proj: bool,
                factors: Optional[BiasTables] = None, hoisted: bool = False,
                f32: bool = False) -> dict:
    """Shape of the launch of one call (CUDA only; nothing runs): B6
    (``proj``; with the prompt rows apart, as
    :func:`fused_window_attention_packed_qkv_prompts` takes them, when
    ``hoisted``) or B7/B8, the factor form when ``factors`` are given.
    CTAs per window (1), CTAs, threads per CTA, CTAs per SM (the occupancy
    calculator's), registers, spill bytes per thread and shared bytes per
    CTA."""
    import ctypes
    from . import kernels
    hoisted = proj and hoisted and n > m
    tabw = 0 if factors is None else factors.tab.shape[1]
    attention_plan(m, n, c, heads, proj, hoisted, tabw)
    info = kernels.info_array()
    mode = 0 if not proj else (2 if hoisted else 1)
    kernels.check(kernels.library().mivp_window_attention(
        *([None] * 12), ctypes.addressof(info), bp, m, n, c, heads, 0, mode,
        *((0, 0, 0) if factors is None else factors.dims), tabw, 1.0, 1.0,
        int(f32), torch.cuda.current_stream().cuda_stream), "launch_info")
    return kernels.info_dict(info)


def _weights(name, wq, wk, wv, wqkv, num_heads, c):
    """B6's per-head kernel weight: ``wqkv`` as given (checked), else
    built from the three ``[C, C]`` weights."""
    if wqkv is None:
        wqkv = qkv_kernel_weight(wq, wk, wv, num_heads)
    if tuple(wqkv.shape[:2]) != (num_heads, 3) or wqkv.shape[-1] != c:
        raise ValueError(f"{name}: wqkv must be [H, 3, DHP, C], got "
                         f"{tuple(wqkv.shape)}")
    return wqkv


def _count_b6(p: int, m: int, c: int, factors) -> None:
    fn = fused_window_attention_packed_qkv
    fn.launches += 1
    fn.factor_launches += factors is not None
    fn.launches_by_shape[(p, m, c)] += 1


def fused_window_attention_packed_qkv(
        y: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
        wv: torch.Tensor, m_len: int, pos_bias: torch.Tensor,
        labels: Optional[torch.Tensor], scale: float, num_heads: int,
        matmul_dtype: torch.dtype = torch.bfloat16,
        wqkv: Optional[torch.Tensor] = None,
        factors: Optional[BiasTables] = None) -> torch.Tensor:
    """B6: attention of the first ``m_len`` rows of ``y [B, P, N, C]``
    over all N, with q/k/v projected by ``w* [C, C]`` (in, out) inside the
    kernel.  Returns ``[B, P, m_len, C]`` (pre-proj); differentiable in
    y, the weights and the bias (:class:`PackedQKVFunction`).

    CUDA only: ``wqkv``, the cached
    :func:`~.fused_block.qkv_kernel_weight` of the three weights;
    ``factors``, the :class:`BiasTables` of ``pos_bias``."""
    name = "fused_window_attention_packed_qkv"
    _check_shapes(name, y, y, m_len, num_heads, pos_bias, labels)
    b, p, n, c = y.shape
    bias = pos_bias.reshape(num_heads, m_len, n)

    def fwd():
        if not y.is_cuda:
            return fused_window_attention_packed_qkv_reference(
                y, wq, wk, wv, m_len, bias, labels, scale, num_heads,
                matmul_dtype)
        out = _launch(name, (y, wq, wk, wv), y,
                      _weights(name, wq, wk, wv, wqkv, num_heads, c), None,
                      None, None, (b, p, m_len, n, c), bias, labels, scale,
                      num_heads, matmul_dtype, factors)
        _count_b6(p, m_len, c, factors)
        return out

    return PackedQKVFunction.apply(fwd, y, None, wq, wk, wv, bias, labels,
                                   m_len, scale, num_heads)


fused_window_attention_packed_qkv.launches = 0
fused_window_attention_packed_qkv.factor_launches = 0
fused_window_attention_packed_qkv.launches_by_shape = collections.Counter()


def fused_window_attention_packed_qkv_prompts(
        y: torch.Tensor, y_prompt: torch.Tensor, wq: torch.Tensor,
        wk: torch.Tensor, wv: torch.Tensor, pos_bias: torch.Tensor,
        labels: Optional[torch.Tensor], scale: float, num_heads: int,
        matmul_dtype: torch.dtype = torch.bfloat16,
        wqkv: Optional[torch.Tensor] = None,
        factors: Optional[BiasTables] = None) -> torch.Tensor:
    """B6 on the content rows ``y [B, P, M, C]`` of each window and the
    prompt rows ``y_prompt [E, C]`` that follow them in every window:
    :func:`fused_window_attention_packed_qkv` of ``y`` with ``y_prompt``
    appended to each window (N = M + E keys, the M content rows the
    queries), with the same bits.  The kernel projects the prompt rows'
    K/V once per call and stages only the content rows per window.
    Returns ``[B, P, M, C]`` (pre-proj), differentiable also in
    ``y_prompt`` (its gradient summed over the windows); ``wqkv`` and
    ``factors`` as for :func:`fused_window_attention_packed_qkv`, whose
    counters count the launch."""
    name = "fused_window_attention_packed_qkv_prompts"
    if y.dim() != 4 or y_prompt.dim() != 2 or y_prompt.shape[0] < 1 \
            or y_prompt.shape[1] != y.shape[-1]:
        raise ValueError(f"{name}: y must be [B, P, M, C] and y_prompt "
                         f"[E, C] with E >= 1; got {tuple(y.shape)} and "
                         f"{tuple(y_prompt.shape)}")
    b, p, m, c = y.shape
    n = m + y_prompt.shape[0]
    whole = y[:, :, :1].expand(b, p, n, c)   # the whole windows' shape
    _check_shapes(name, whole, whole, m, num_heads, pos_bias, labels)
    bias = pos_bias.reshape(num_heads, m, n)

    def fwd():
        if not y.is_cuda:
            full = torch.cat([y, y_prompt.to(y.dtype).expand(b, p, -1, c)],
                             2)
            return fused_window_attention_packed_qkv_reference(
                full, wq, wk, wv, m, bias, labels, scale, num_heads,
                matmul_dtype)
        out = _launch(name, (y, y_prompt, wq, wk, wv), y,
                      _weights(name, wq, wk, wv, wqkv, num_heads, c), None,
                      None, None, (b, p, m, n, c), bias, labels, scale,
                      num_heads, matmul_dtype, factors, y_prompt)
        _count_b6(p, m, c, factors)
        return out

    return PackedQKVFunction.apply(fwd, y, y_prompt, wq, wk, wv, bias,
                                   labels, m, scale, num_heads)


def fused_window_attention_packed(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        pos_bias: torch.Tensor, labels: Optional[torch.Tensor],
        scale: float, num_heads: int,
        matmul_dtype: torch.dtype = torch.bfloat16,
        factors: Optional[BiasTables] = None) -> torch.Tensor:
    """B7: attention of ``q [B, P, M, C]`` over ``k/v [B, P, N, C]`` with
    the heads not split.  Returns ``[B, P, M, C]``; differentiable in
    q/k/v and the bias (:class:`AttentionFunction`).  CUDA only:
    ``factors`` as for B6."""
    name = "fused_window_attention_packed"
    _check_shapes(name, q, k, q.shape[2], num_heads, pos_bias, labels)
    if k.shape != v.shape:
        raise ValueError(f"{name}: k and v differ: {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, p, m, c = q.shape
    n = k.shape[2]
    bias = pos_bias.reshape(num_heads, m, n)

    def fwd():
        if not q.is_cuda:
            return fused_window_attention_packed_reference(
                q, k, v, bias, labels, scale, num_heads, matmul_dtype)
        out = _launch(name, (q, k, v), None, None, q, k, v,
                      (b, p, m, n, c), bias, labels, scale, num_heads,
                      matmul_dtype, factors)
        fused_window_attention_packed.launches += 1
        fused_window_attention_packed.factor_launches += factors is not None
        return out

    return AttentionFunction.apply(fwd, q, k, v, bias, labels, scale,
                                   num_heads)


fused_window_attention_packed.launches = 0
fused_window_attention_packed.factor_launches = 0


def fused_window_attention(
        qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
        pos_bias: torch.Tensor, labels: Optional[torch.Tensor],
        scale: float, matmul_dtype: torch.dtype = torch.bfloat16,
        factors: Optional[BiasTables] = None) -> torch.Tensor:
    """B8: per-head attention of ``qh [B, P, M, H, Dh]`` over ``kh/vh
    [B, P, N, H, Dh]``.  Returns ``[B, P, M, H, Dh]``; differentiable as
    B7.  The kernel is B7's: ``[.., H, Dh]`` is ``[.., C]`` in memory.
    CUDA only: ``factors`` as for B7."""
    name = "fused_window_attention"
    if qh.dim() != 5 or kh.shape != vh.shape or kh.dim() != 5 \
            or qh.shape[3:] != kh.shape[3:]:
        raise ValueError(f"{name}: qh must be [B, P, M, H, Dh] and kh/vh "
                         f"[B, P, N, H, Dh]; got {tuple(qh.shape)}, "
                         f"{tuple(kh.shape)}, {tuple(vh.shape)}")
    b, p, m, h, dh = qh.shape
    n = kh.shape[2]
    flat = lambda t: t.reshape(b, p, t.shape[2], h * dh)  # noqa: E731
    _check_shapes(name, flat(qh), flat(kh), m, h, pos_bias, labels)
    bias = pos_bias.reshape(h, m, n)

    def fwd():
        if not qh.is_cuda:
            return flat(fused_window_attention_reference(
                qh, kh, vh, bias, labels, scale, matmul_dtype))
        out = _launch(name, (qh, kh, vh), None, None, qh, kh, vh,
                      (b, p, m, n, h * dh), bias, labels, scale, h,
                      matmul_dtype, factors)
        fused_window_attention.launches += 1
        fused_window_attention.factor_launches += factors is not None
        return out

    return AttentionFunction.apply(fwd, flat(qh), flat(kh), flat(vh), bias,
                                   labels, scale, h).reshape(b, p, m, h, dh)


fused_window_attention.launches = 0
fused_window_attention.factor_launches = 0
