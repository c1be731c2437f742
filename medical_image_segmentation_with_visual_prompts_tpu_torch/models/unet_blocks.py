"""Decoder building blocks.

Counterpart of the JAX package's ``models/unet_blocks.py``: channels-
last 3D convs, BatchNorm (the inference fold, or batch statistics in
training), and

* ``SwinUpBlock`` -- trilinear upsample (``align_corners=False``), crop
  to the skip, ``conv(leaky(bn(concat(x, skip))))`` written in the
  block's dtype, then a no-down Swin block pair with the decoder prompts.
  In eval mode the upsample and crop are one kernel
  (``ops/upsample.py``) and the conv is the pair-input kernel of
  ``ops/conv_fused.py`` (the concat is never built); in train mode, as in
  the JAX package, the einsum upsample, the concat, the batch-statistics
  BatchNorm, LeakyReLU(0.01) and a library conv.
* the UNETR blocks (MONAI semantics, as the JAX package builds them):
  ``UnetBasicBlock`` (conv-IN-LeakyReLU twice), ``UnetResBlock`` (with a
  1x1 conv + IN projection of the residual where the channel count
  changes), ``UnetrBasicBlock`` (one of the two under ``layer``) and
  ``UnetrUpBlock`` (2x2x2 transposed conv, crop to the skip, concat,
  ``conv_block``).  Instance norms have no affine, eps 1e-5.  The JAX
  blocks give their convs no dtype, so flax computes them in the
  promotion of the input and the fp32 kernel: fp32 under any trunk.
  These do the same.  Each conv sits in a holder (``conv1.conv``,
  ``transp_conv.conv``): the reference's torch key names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_fused import (conv3x3_fused_pair, conv_pair_reference,
                              kernel_weight)
from ..ops.fused_block import kernel_matmul_dtype
from ..ops.upsample import upsample, upsample_reference
from .swin_block import ConsecutiveSwinBlocks


def conv3d(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """Channels-last conv in ``x``'s dtype with torch-style "same"
    padding for odd kernels (``conv``'s own padding and stride)."""
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride=conv.stride,
                 padding=conv.padding)
    return y.permute(0, 2, 3, 4, 1)


def same_conv(cin: int, cout: int, k: Sequence[int] = (3, 3, 3)) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, tuple(k), padding=tuple(kk // 2 for kk in k))


def bn_fold(norm: nn.BatchNorm3d):
    """(scale, shift) of an inference BatchNorm as a per-channel affine
    ``y = x * scale + shift`` with its own eps and running stats (fp32)."""
    scale = norm.weight.float() * torch.rsqrt(norm.running_var.float()
                                              + norm.eps)
    shift = norm.bias.float() - norm.running_mean.float() * scale
    return scale, shift


def batch_norm(x: torch.Tensor, norm: nn.BatchNorm3d) -> torch.Tensor:
    """BatchNorm of a channels-last tensor, in fp32.

    Eval mode: the running statistics (:func:`bn_fold`).  Train mode: the
    batch statistics as flax computes them -- mean and the *biased*
    variance ``max(E[x^2] - E[x]^2, 0)`` over every axis but the channel
    -- and the running statistics updated in place with them, by hand:
    ``F.batch_norm`` would store the unbiased variance.  torch's momentum
    0.1 is flax's 0.9.

    Under a data group (``norm.data_group``, set by
    ``SwinUnetR.set_data_group``) the moments are those of the global
    batch, wrap-pad rows included, as the JAX BatchNorm sees them in a
    sharded program: one differentiable all-reduce of ``[sum x, sum x^2,
    count]`` per call, so every rank's running statistics stay equal.
    """
    if not norm.training:
        scale, shift = bn_fold(norm)
        return x.float() * scale + shift
    xf = x.float()
    dims = tuple(range(xf.dim() - 1))
    group = getattr(norm, "data_group", None)
    if group is None or not group.splits:
        mean = xf.mean(dims)
        var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
    else:
        c = xf.shape[-1]
        sums = group.all_sum(torch.cat([
            xf.sum(dims), (xf * xf).sum(dims),
            xf.new_full((1,), float(xf.numel() // c))]))
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        m = norm.momentum
        norm.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        norm.running_var.mul_(1.0 - m).add_(var, alpha=m)
        norm.num_batches_tracked.add_(1)
    return (xf - mean) * torch.rsqrt(var + norm.eps) * norm.weight.float() \
        + norm.bias.float()


class ConvUnit(nn.Module):
    """Holder of a "same" conv under the reference's ``<name>.conv``
    keys (``conv_concat.conv``, ``conv1.conv``, ...)."""

    def __init__(self, cin: int, cout: int, kernel_size: Sequence[int]):
        super().__init__()
        self.conv = same_conv(cin, cout, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x, self.conv)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm without affine over the spatial axes of a channels-
    last fp32 tensor, per sample and channel, as flax computes it: the
    variance ``max(E[x^2] - E[x]^2, 0)``."""
    dims = tuple(range(1, x.dim() - 1))
    mean = x.mean(dims, keepdim=True)
    var = ((x * x).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps)


class ConvTranspose3d(nn.Module):
    """Transposed conv with kernel = stride (VALID), ``out = in * stride``,
    channels-last, fp32.  ``conv`` holds the torch weight ``[Cin, Cout,
    k...]`` the reference holds; flax's kernel is its spatial mirror
    (``utils/torch_import.py`` flips it)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 2,
                 stride: int = 2):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, kernel_size, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose3d(x.float().permute(0, 4, 1, 2, 3),
                               self.conv.weight.float(),
                               self.conv.bias.float(),
                               stride=self.conv.stride)
        return y.permute(0, 2, 3, 4, 1)


class UnetBasicBlock(nn.Module):
    """conv-IN-LeakyReLU(0.01) twice, in fp32."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        k = (kernel_size,) * 3
        self.conv1 = ConvUnit(cin, cout, k)
        self.conv2 = ConvUnit(cout, cout, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for conv in (self.conv1, self.conv2):
            x = F.leaky_relu(instance_norm(conv(x)), 0.01)
        return x


class UnetResBlock(nn.Module):
    """conv-IN-LeakyReLU-conv-IN, plus the input (through a 1x1 conv + IN
    where ``cin != cout``), then LeakyReLU(0.01); in fp32."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        k = (kernel_size,) * 3
        self.conv1 = ConvUnit(cin, cout, k)
        self.conv2 = ConvUnit(cout, cout, k)
        if cin != cout:
            self.conv3 = ConvUnit(cin, cout, (1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        y = F.leaky_relu(instance_norm(self.conv1(x)), 0.01)
        y = instance_norm(self.conv2(y))
        if hasattr(self, "conv3"):
            x = instance_norm(self.conv3(x))
        return F.leaky_relu(y + x, 0.01)


def unet_block(cin: int, cout: int, residual: bool,
               kernel_size: int = 3) -> nn.Module:
    return (UnetResBlock if residual else UnetBasicBlock)(cin, cout,
                                                          kernel_size)


class UnetrBasicBlock(nn.Module):
    """``UnetResBlock`` (``res_block``) or ``UnetBasicBlock`` under
    ``layer``."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 res_block: bool = True):
        super().__init__()
        self.layer = unet_block(cin, cout, res_block, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Transposed conv up (kernel = stride = ``upsample_kernel_size``),
    crop to the skip's spatial size, concat the skip, ``conv_block``
    (res or basic by ``res_block``); in fp32.  The prompts the decoder
    passes are not read (as in the JAX block)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 upsample_kernel_size: int = 2, res_block: bool = False):
        super().__init__()
        self.transp_conv = ConvTranspose3d(cin, cout, upsample_kernel_size,
                                           upsample_kernel_size)
        self.conv_block = unet_block(2 * cout, cout, res_block, kernel_size)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                tokens=(None, None)) -> torch.Tensor:
        x = self.transp_conv(x)
        x = x[:, :skip.shape[1], :skip.shape[2], :skip.shape[3]]
        return self.conv_block(torch.cat([x, skip.float()], -1))


class SwinUpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 strides: Sequence[int], kernel_size: Sequence[int],
                 pos_bias_embed_dim: int, num_heads: int,
                 window_size: Sequence[int], max_prompts: int,
                 tokens_per_prompt: int, pad_mode: str = "reference",
                 dtype: torch.dtype = torch.float32, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        if tuple(kernel_size) != (3, 3, 3):
            raise NotImplementedError("SwinUpBlock: the port runs the 3x3x3 "
                                      "pair conv only")
        self.strides = tuple(strides)
        self.dtype = dtype
        self.use_kernels = True    # False: the plain version (set_kernels)
        cin = in_channels + out_channels
        self.norm_concat = nn.BatchNorm3d(cin, eps=1e-5, momentum=0.1)
        self.conv_concat = ConvUnit(cin, out_channels, kernel_size)
        self.swin_layer = ConsecutiveSwinBlocks(
            out_channels, num_heads, pos_bias_embed_dim, max_prompts,
            tokens_per_prompt, window_size, down=False, pad_mode=pad_mode,
            dtype=dtype, attn_drop=attn_drop, proj_drop=proj_drop)
        self._w27 = None

    def _kernel_weight(self) -> torch.Tensor:
        w = self.conv_concat.conv.weight
        stamp = (w.data_ptr(), w._version)
        if self._w27 is None or self._w27[0] != stamp:
            self._w27 = (stamp, kernel_weight(w))
        return self._w27[1]

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                tokens=(None, None)) -> torch.Tensor:
        # The upsample cropped to the skip: the kernel in serving, else
        # the einsum chain.
        resize = (upsample if self.use_kernels and not self.training
                  else upsample_reference)
        x = resize(x, self.strides, tuple(skip.shape[1:4]))
        conv = self.conv_concat.conv
        if self.training:
            # Training (as the JAX package): concat in the promoted dtype,
            # BatchNorm on batch statistics, LeakyReLU, then the conv in
            # the block's dtype.
            y = F.leaky_relu(batch_norm(torch.cat([x, skip], -1),
                                        self.norm_concat), 0.01)
            return self.swin_layer(conv3d(y.to(self.dtype), conv), tokens)
        # Serving (as the JAX kernel path): the skip in the trunk's dtype,
        # the conv written in the block's dtype.
        skip = skip.to(x.dtype).contiguous()
        scale, shift = bn_fold(self.norm_concat)
        if self.use_kernels:
            w27 = self._kernel_weight() if x.is_cuda else None
            x = conv3x3_fused_pair(x, skip, conv.weight, conv.bias, scale,
                                   shift, w27=w27, out_dtype=self.dtype)
        else:
            x = conv_pair_reference(
                x, skip, conv.weight, conv.bias, scale, shift,
                matmul_dtype=kernel_matmul_dtype(x.dtype, x.device),
                out_dtype=self.dtype)
        return self.swin_layer(x, tokens)
