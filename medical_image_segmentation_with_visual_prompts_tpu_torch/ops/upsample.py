"""Trilinear upsample with a crop, and the downstream head as its
epilogue: the serving decoder's resize chain as one kernel.

No counterpart in the JAX package's kernels: it resizes with per-axis
einsums (``ops/resize.py``), as the port's plain path does.  Two forms:

* plain: ``resize(x, floor(in * scale))[:, :oh, :ow, :od]``, written
  contiguous in x's dtype (``SwinUpBlock``'s eval branch, and the final
  upsample where no head follows);
* head: the downstream seg head after the final upsample, as
  ``SwinUnetR._head`` computes it::

      y      = resize(x)                       x's dtype
      a      = S(y.float() * scale + shift)    the folded BatchNorm
      logits = conv3x3x3_same(a, S(weight)) + S(bias), rounded to S, fp32

  with S the trunk's dtype (``Head.dtype``: x's, but bf16 where a UNETR
  up block's fp32 output feeds a bf16 trunk's head);

CUDA tensors run ``csrc/upsample.cu``, which computes each axis'
weights on the card from the output index (:func:`axis_taps` is their
plain version, equal to ``interp_matrix``'s entries), so no matrix is
sent to the card and the forward never waits for a copy; the head form
never writes the full-size ``y`` or ``a``.  It keeps the plain path's
rounding points (module note of the source); its conv sums in another
order than cuDNN.  CPU tensors take :func:`upsample_reference`, the
chain the model ran before this kernel, bit for bit.

``upsample.launches`` counts the kernel's launches and
``upsample.launches_by_shape`` the same launches by (per-sample input
shape, per-sample output shape, form) with form ``"plain"`` or
``"head"``.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .resize import upsample_trilinear

# Classes per launch of the head form (the kernel's accumulators); a head
# with more classes takes one launch per group of them.
MAX_CLASSES = 4


class HeadOperands(NamedTuple):
    """The head's conv as the kernel reads it (:func:`kernel_operands`)."""
    weights: Tuple[torch.Tensor, ...]   # per class group
    bias: torch.Tensor                  # [K] fp32, rounded to the trunk


class Head(NamedTuple):
    """The downstream head: the inference BatchNorm folded into ``(scale,
    shift)`` (``models/unet_blocks.py::bn_fold``), the 3x3x3 "same"
    conv's torch ``weight`` ``[K, C, 3, 3, 3]`` and ``bias`` ``[K]``, and
    the trunk's ``dtype`` it computes in; ``kernel`` (CUDA only): its
    cached :func:`kernel_operands`."""
    scale: torch.Tensor
    shift: torch.Tensor
    weight: torch.Tensor
    bias: torch.Tensor
    dtype: torch.dtype
    kernel: Optional[HeadOperands] = None


def axis_taps(in_size: int, out_size: int, align_corners: bool):
    """Each output index's two source indices and float32 weights along
    one axis, as the kernel computes them (``csrc/upsample.cu::
    axis_tap``): ``interp_matrix``'s formula in float64, a row's two
    entries, or where both indices coincide their float32 sum and 0.
    Returns ``(lo, hi, w_lo, w_hi)`` arrays of ``out_size``."""
    o = np.arange(out_size, dtype=np.float64)
    if in_size == 1:
        zeros = np.zeros(out_size, dtype=np.int64)
        return (zeros, zeros, np.ones(out_size, np.float32),
                np.zeros(out_size, np.float32))
    if align_corners:
        src = o * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = np.maximum((o + 0.5) * in_size / out_size - 0.5, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w = src - lo
    w_lo, w_hi = (1.0 - w).astype(np.float32), w.astype(np.float32)
    same = lo == hi
    w_lo = np.where(same, w_lo + w_hi, w_lo)
    w_hi = np.where(same, np.float32(0), w_hi)
    return lo, hi, w_lo, w_hi


def upsample_reference(x: torch.Tensor, scale: Sequence[int],
                       out_size: Optional[Sequence[int]] = None,
                       align_corners: bool = False,
                       head: Optional[Head] = None) -> torch.Tensor:
    """Plain PyTorch version: ``upsample_trilinear``, then with
    ``out_size`` the crop to it written contiguous (``SwinUpBlock``), then
    with ``head`` the head's BatchNorm, cast and conv (``SwinUnetR.
    _head``); without ``out_size`` the resize as it returns."""
    y = upsample_trilinear(x, scale, align_corners=align_corners)
    if out_size is not None:
        oh, ow, od = out_size
        y = y[:, :oh, :ow, :od].contiguous()
    if head is None:
        return y
    return head_conv(y.float() * head.scale + head.shift, head.weight,
                     head.bias, head.dtype)


def head_conv(a: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The seg head after its BatchNorm, in plain PyTorch (``SwinUnetR.
    _head`` and :func:`upsample_reference`): the normalised channels-last
    ``a`` rounded to ``dtype``, the 3x3x3 "same" conv with ``weight`` and
    ``bias`` in ``dtype``, the logits as fp32."""
    out = F.conv3d(a.to(dtype).permute(0, 4, 1, 2, 3), weight.to(dtype),
                   bias.to(dtype), padding=1)
    return out.permute(0, 2, 3, 4, 1).float()


def vector_width(dtype: torch.dtype) -> int:
    """Channels per 16-byte vector of the kernel."""
    return 16 // dtype.itemsize


def kernel_operands(weight: torch.Tensor, bias: torch.Tensor,
                    dtype: torch.dtype, x_dtype: torch.dtype) -> HeadOperands:
    """The head conv for the kernel: ``weight`` ``[K, C, 3, 3, 3]``
    rounded to the trunk ``dtype``, as fp32 ``[C / N, 27, N / 4, k, 4]``
    per group of up to :data:`MAX_CLASSES` classes (N channels per
    16-byte vector of ``x_dtype``, the upsample's input; taps ``kh * 9 +
    kw * 3 + kd``); ``bias`` rounded to ``dtype``, fp32."""
    k, c = weight.shape[:2]
    n = vector_width(x_dtype)
    w = weight.detach().to(dtype).float().reshape(k, c // n, n // 4, 4, 27)
    w = w.permute(1, 4, 2, 0, 3)
    groups = tuple(w[:, :, :, k0:k0 + MAX_CLASSES].contiguous()
                   for k0 in range(0, k, MAX_CLASSES))
    return HeadOperands(groups, bias.detach().to(dtype).float().contiguous())


def _check(x, out_size, full, head) -> None:
    if x.dim() != 5:
        raise ValueError(f"upsample: x must be [B, H, W, D, C], got "
                         f"{tuple(x.shape)}")
    if len(out_size) != 3 or not all(
            1 <= o <= f for o, f in zip(out_size, full)):
        raise ValueError(f"upsample: out_size {tuple(out_size)} must lie "
                         f"within the resized size {full}")
    if head is None:
        return
    c = x.shape[-1]
    k = head.weight.shape[0]
    if head.weight.shape[1:] != (c, 3, 3, 3) or head.bias.shape != (k,):
        raise ValueError(f"upsample: the head conv must be [K, {c}, 3, 3, 3] "
                         f"with bias [K], got {tuple(head.weight.shape)} and "
                         f"{tuple(head.bias.shape)}")
    for arg in ("scale", "shift"):
        if getattr(head, arg).shape != (c,):
            raise ValueError(f"upsample: head {arg} must be [{c}], got "
                             f"{tuple(getattr(head, arg).shape)}")


def _check_kernel_args(x, head) -> None:
    """What the kernel takes; raises naming the offending argument."""
    if x.requires_grad:
        raise ValueError("upsample: x requires grad; the serving kernel has "
                         "no backward")
    for arg, dtype in (("x", x.dtype),
                       ("the head's dtype", getattr(head, "dtype", x.dtype))):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"upsample: {arg} must be float32 or bfloat16, "
                             f"got {dtype}")
    n = vector_width(x.dtype)
    if x.shape[-1] % n:
        raise ValueError(f"upsample: the kernel takes channel counts that "
                         f"are multiples of {n} in {x.dtype}; got "
                         f"{x.shape[-1]}")
    tensors = [("x", x, x.dtype)]
    if head is not None:
        tensors += [("scale", head.scale, torch.float32),
                    ("shift", head.shift, torch.float32)]
        if head.kernel is not None:
            tensors += [("bias", head.kernel.bias, torch.float32)]
            tensors += [("weights", w, torch.float32)
                        for w in head.kernel.weights]
    for arg, t, dtype in tensors:
        if t.device != x.device:
            raise ValueError(f"upsample: {arg} must be on x's device "
                             f"{x.device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"upsample: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"upsample: {arg} must be contiguous and 16-byte "
                             "aligned")


def upsample(x: torch.Tensor, scale: Sequence[int],
             out_size: Optional[Sequence[int]] = None,
             align_corners: bool = False,
             head: Optional[Head] = None) -> torch.Tensor:
    """Trilinear upsample of channels-last ``x`` ``[B, H, W, D, C]`` by
    ``scale`` (``nn.Upsample`` sizes), cropped to ``out_size`` (default
    the resized size); with ``head`` the head's fp32 logits ``[B, *size,
    K]`` instead (module docstring).  CPU tensors: the plain version.
    On a CUDA card a strided ``x`` is made contiguous first."""
    full = tuple(int(s * f) for s, f in zip(x.shape[1:4], scale))
    size = full if out_size is None else tuple(out_size)
    _check(x, size, full, head)
    if not x.is_cuda:
        return upsample_reference(x, scale, out_size, align_corners, head)
    from . import kernels
    # The kernel reads x densely: a strided view (the unfused blocks'
    # decoder input) is copied first, as the einsums copy it.
    x = x.contiguous()
    _check_kernel_args(x, head)
    if head is not None and head.kernel is None:
        head = head._replace(kernel=kernel_operands(
            head.weight, head.bias, head.dtype, x.dtype))
        _check_kernel_args(x, head)
    lib, stream = kernels.library(), kernels.stream_of(x)
    dims = (*x.shape, *full, *size, int(align_corners))
    f32 = int(x.dtype == torch.float32)
    if head is None:
        out = torch.empty((x.shape[0], *size, x.shape[-1]), device=x.device,
                          dtype=x.dtype)
        kernels.check(lib.mivp_upsample(x.data_ptr(), out.data_ptr(), *dims,
                                        f32, stream), "upsample")
        launches = 1
    else:
        k = head.weight.shape[0]
        out = torch.empty((x.shape[0], *size, k), device=x.device,
                          dtype=torch.float32)
        for g, w in enumerate(head.kernel.weights):
            k0 = g * MAX_CLASSES
            kernels.check(lib.mivp_upsample_head(
                x.data_ptr(), head.scale.data_ptr(), head.shift.data_ptr(),
                w.data_ptr(), head.kernel.bias[k0:].data_ptr(),
                out.data_ptr() + 4 * k0, *dims, w.shape[3], k, f32,
                int(head.dtype == torch.bfloat16), stream), "upsample (head)")
        launches = len(head.kernel.weights)
    upsample.launches += launches
    key = (tuple(x.shape[1:]), tuple(out.shape[1:]),
           "plain" if head is None else "head")
    upsample.launches_by_shape[key] += launches
    return out


upsample.launches = 0
upsample.launches_by_shape = collections.Counter()
