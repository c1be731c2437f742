"""3x3x3 convs with a BN + LeakyReLU prologue: pair input (B2) and one
input (B3).

Counterpart of the JAX package's ``ops/conv_pallas.py``:
``conv3x3_fused_pair`` (TPU kernel ``_kernel_pair``), the SwinUpBlock's
``conv(leaky(bn(concat(xa, xb))))`` without building the concat::

    a   = leaky_relu(concat(xa, xb) * scale + shift, 0.01)   bf16 operand
    out = conv3x3x3_same(a, kernel) + bias                   fp32 sums

and ``conv3x3_fused`` (TPU kernel ``_kernel``), the one-input form whose
affine and LeakyReLU are each optional.  No model code calls B3, in the
JAX package or here.

Zero padding comes AFTER the prologue: out-of-range taps contribute 0,
not ``leaky(shift)``.  ``scale``/``shift`` are the inference BatchNorm
folded into an affine (``models/unet_blocks.py::bn_fold``).

CUDA tensors run ``csrc/conv3x3_pair.cu`` (B3 is its one-input case):
fp32 inputs are rounded to bf16 first, as the JAX wrapper rounds them
(``conv_pallas.py``), and the output is written in ``out_dtype`` (the
block's dtype; default the input's).  CPU tensors run :func:`conv_pair_reference` /
:func:`conv_reference`.  ``conv3x3_fused_pair.launches`` and
``conv3x3_fused.launches`` count the kernel launches;
``conv3x3_fused_pair.launches_by_shape`` counts the pair's by the
per-sample shape of ``xa`` (``(D, H, W, Ca)``).
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F

from .fused_block import round_to


CHUNK = 16    # input channels per staged chunk of the kernel


def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch conv weight ``[Co, Ci, 3, 3, 3]`` -> the kernel's bf16
    ``[Ci / 16, 27, Co, 16]``: per chunk of 16 input channels, per tap
    (``kh * 9 + kw * 3 + kd``), each output channel's 16 weights, the
    rows the kernel stages for one chunk.  ``Ci`` is zero-padded to a
    multiple of 16 (the kernel itself takes multiples of 16 only)."""
    co, ci = weight.shape[:2]
    cp = -(-ci // CHUNK) * CHUNK
    w = F.pad(weight.detach(), (0, 0, 0, 0, 0, 0, 0, cp - ci))
    return w.reshape(co, cp // CHUNK, CHUNK, 27).permute(1, 3, 0, 2).to(
        torch.bfloat16).contiguous()


def conv_reference(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None, leaky: bool = False,
                   matmul_dtype: torch.dtype = torch.bfloat16,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of B3.  x: ``[B, H, W, D, Ci]``
    channels-last; weight: torch ``[Co, Ci, 3, 3, 3]``.  The input is
    rounded to ``matmul_dtype`` before the prologue (as the kernel reads
    it), the prologue output before the conv."""
    a = round_to(x, matmul_dtype)
    if scale is not None:
        a = a * scale.float() + shift.float()
    if leaky:
        a = F.leaky_relu(a, 0.01)
    a = round_to(a, matmul_dtype).permute(0, 4, 1, 2, 3)
    out = F.conv3d(a, round_to(weight, matmul_dtype), bias.float(),
                   padding=1)
    return out.permute(0, 2, 3, 4, 1).to(out_dtype or x.dtype)


def conv_pair_reference(xa: torch.Tensor, xb: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor,
                        matmul_dtype: torch.dtype = torch.bfloat16,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of B2.  xa/xb: ``[B, H, W, D, C*]``
    channels-last; weight: torch ``[Co, Ca + Cb, 3, 3, 3]``.  Inputs are
    rounded to ``matmul_dtype`` before the prologue (as the kernel reads
    them)."""
    x = torch.cat([round_to(xa, matmul_dtype), round_to(xb, matmul_dtype)],
                  dim=-1)
    return conv_reference(x, weight, bias, scale, shift, True, matmul_dtype,
                          out_dtype or xa.dtype)


def _check_args(xa, xb, weight, bias, scale, shift,
                name: str = "conv3x3_fused_pair"):
    """Shape checks common to both paths; ``xb`` (B3) and ``scale``/
    ``shift`` may be None."""
    if xa.requires_grad or (xb is not None and xb.requires_grad):
        raise ValueError(f"{name}: the inputs require grad; the serving "
                         "kernel has no backward yet")
    if xb is None:
        if xa.dim() != 5:
            raise ValueError(f"{name}: x must be [B, H, W, D, Ci], got "
                             f"{tuple(xa.shape)}")
    elif xa.dim() != 5 or xb.dim() != 5 or xa.shape[:4] != xb.shape[:4]:
        raise ValueError(f"{name}: xa and xb must be [B, H, W, D, C*] with "
                         f"equal B, H, W, D; got {tuple(xa.shape)} and "
                         f"{tuple(xb.shape)}")
    cin = xa.shape[-1] + (0 if xb is None else xb.shape[-1])
    if weight.dim() != 5 or weight.shape[1:] != (cin, 3, 3, 3):
        raise ValueError(f"{name}: weight must be [Co, {cin}, 3, 3, 3], got "
                         f"{tuple(weight.shape)}")
    co = weight.shape[0]
    if bias.shape != (co,):
        raise ValueError(f"{name}: bias must be [{co}], got "
                         f"{tuple(bias.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{name}: give scale and shift together")
    for arg, t in (("scale", scale), ("shift", shift)):
        if t is not None and t.shape != (cin,):
            raise ValueError(f"{name}: {arg} must be [{cin}], got "
                             f"{tuple(t.shape)}")


def check_kernel_args(xa, xb, w27, bias, scale, shift,
                      name: str = "conv3x3_fused_pair") -> None:
    """What the CUDA kernel takes; raises naming the offending argument.
    ``xa``/``xb`` are the bf16 operands (the wrapper rounds fp32 inputs
    first); ``w27`` is :func:`kernel_weight` of the conv weight; ``xb``
    (B3) and ``scale``/``shift`` may be None."""
    for arg, t, dtype in (("xa", xa, torch.bfloat16),
                          ("xb", xb, torch.bfloat16),
                          ("weight", w27, torch.bfloat16),
                          ("bias", bias, torch.float32),
                          ("scale", scale, torch.float32),
                          ("shift", shift, torch.float32)):
        if t is None:
            continue
        if not t.is_cuda or t.device != xa.device:
            raise ValueError(f"{name}: {arg} must be on xa's CUDA device, "
                             f"got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte "
                             "aligned")
    ca, co = xa.shape[-1], w27.shape[2]
    cb = 0 if xb is None else xb.shape[-1]
    if ca % 16 or cb % 16 or co % 16:
        raise ValueError(f"{name}: the kernel takes channel counts that are "
                         f"multiples of 16; got Ca={ca}, Cb={cb}, Co={co}")
    if tuple(w27.shape) != ((ca + cb) // CHUNK, 27, co, CHUNK):
        raise ValueError(f"{name}: weight must be kernel_weight's "
                         f"[{(ca + cb) // CHUNK}, 27, {co}, {CHUNK}], got "
                         f"{tuple(w27.shape)}")
    if xa.numel() // ca >= 2 ** 31:
        raise ValueError(f"{name}: xa has too many voxels")


def _operand(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """An input as the kernel reads it: fp32 rounded to bf16 (the JAX
    wrapper's cast), anything else as it is (and refused by the check)."""
    if x is not None and x.dtype == torch.float32:
        return x.to(torch.bfloat16)
    return x


def _launch(xa, xb, w27, bias, scale, shift, leaky: bool, name: str,
            out_dtype: torch.dtype, tile=(0, 0)) -> torch.Tensor:
    """One launch of ``csrc/conv3x3_pair.cu`` on checked bf16 operands;
    ``tile``: (rows per warp, output channels per CTA), 0 for the
    kernel's default."""
    from . import kernels
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: the output must be float32 or bfloat16, "
                         f"got {out_dtype}")
    b, h, w, d, ca = xa.shape
    co = w27.shape[2]
    out = torch.empty((b, h, w, d, co), device=xa.device, dtype=out_dtype)
    err = kernels.library().mivp_conv3x3(
        xa.data_ptr(), kernels.ptr(xb), w27.data_ptr(), bias.data_ptr(),
        kernels.ptr(scale), kernels.ptr(shift), out.data_ptr(),
        b, h, w, d, ca, 0 if xb is None else xb.shape[-1], co,
        int(scale is not None), int(leaky),
        int(out_dtype == torch.float32), *tile, kernels.stream_of(xa))
    kernels.check(err, name)
    return out


def tile_info(shape, co: int, tile=(0, 0)) -> dict:
    """What a launch of the kernel on ``shape`` = (B, H, W, D) with ``co``
    output channels uses (CUDA only): CTAs per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    spill bytes per thread, dynamic shared memory per CTA, CTAs of the
    grid, rows per warp and output channels per CTA."""
    import ctypes
    from . import kernels
    info = (ctypes.c_int * 7)()
    kernels.check(kernels.library().mivp_conv3x3_info(
        *shape, co, *tile, ctypes.addressof(info)), "conv3x3 tile_info")
    return dict(zip(("ctas_per_sm", "registers", "spill_bytes", "smem",
                     "ctas", "rows_per_warp", "bn"), info))


def conv3x3_fused_pair(xa: torch.Tensor, xb: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor,
                       scale: torch.Tensor, shift: torch.Tensor,
                       w27: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """``conv(leaky(concat(xa, xb) * scale + shift)) + bias``, "same"
    3x3x3, channels-last; output in ``out_dtype`` (default xa's dtype).
    The operands are bf16 on the kernel path (fp32 inputs rounded first)
    and xa's dtype on the plain path.

    ``w27`` (CUDA only): the cached :func:`kernel_weight` of ``weight``.
    """
    _check_args(xa, xb, weight, bias, scale, shift)
    out_dtype = out_dtype or xa.dtype
    if not xa.is_cuda:
        return conv_pair_reference(xa, xb, weight, bias, scale, shift,
                                   matmul_dtype=xa.dtype,
                                   out_dtype=out_dtype)
    if w27 is None:
        w27 = kernel_weight(weight)
    a16, b16 = _operand(xa), _operand(xb)
    check_kernel_args(a16, b16, w27, bias, scale, shift)
    out = _launch(a16, b16, w27, bias, scale, shift, True,
                  "conv3x3_fused_pair", out_dtype)
    conv3x3_fused_pair.launches += 1
    conv3x3_fused_pair.launches_by_shape[tuple(xa.shape[1:])] += 1
    return out


conv3x3_fused_pair.launches = 0
conv3x3_fused_pair.launches_by_shape = collections.Counter()


def conv3x3_fused(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None, leaky: bool = False,
                  w27: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv(act(x * scale + shift)) + bias``, "same" 3x3x3,
    channels-last, with the affine skipped when ``scale`` is None and
    LeakyReLU(0.01) only when ``leaky``; output in x's dtype.  The operand
    is bf16 on the kernel path (fp32 input rounded first) and x's dtype on
    the plain path.

    ``w27`` (CUDA only): the cached :func:`kernel_weight` of ``weight``.
    """
    _check_args(x, None, weight, bias, scale, shift, "conv3x3_fused")
    if not x.is_cuda:
        return conv_reference(x, weight, bias, scale, shift, leaky,
                              matmul_dtype=x.dtype)
    if w27 is None:
        w27 = kernel_weight(weight)
    x16 = _operand(x)
    check_kernel_args(x16, None, w27, bias, scale, shift, "conv3x3_fused")
    out = _launch(x16, None, w27, bias, scale, shift, leaky, "conv3x3_fused",
                  x.dtype)
    conv3x3_fused.launches += 1
    return out


conv3x3_fused.launches = 0
