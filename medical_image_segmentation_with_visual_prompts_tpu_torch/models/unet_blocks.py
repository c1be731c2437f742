"""Decoder building blocks.

Counterpart of the JAX package's ``models/unet_blocks.py``: channels-
last 3D convs, BatchNorm (the inference fold, or batch statistics in
training), and ``SwinUpBlock`` -- trilinear upsample
(``align_corners=False``), crop to the skip, ``conv(leaky(bn(concat(x,
skip))))``, then a no-down Swin block pair with the decoder prompts.  In
eval mode the conv is the pair-input kernel of ``ops/conv_fused.py`` (the
concat is never built); in train mode, as in the JAX package, the concat,
the batch-statistics BatchNorm, LeakyReLU(0.01) and a library conv.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_fused import (conv3x3_fused_pair, conv_pair_reference,
                              kernel_weight)
from ..ops.fused_block import kernel_matmul_dtype
from ..ops.resize import upsample_trilinear
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
    """
    if not norm.training:
        scale, shift = bn_fold(norm)
        return x.float() * scale + shift
    xf = x.float()
    dims = tuple(range(xf.dim() - 1))
    mean = xf.mean(dims)
    var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        m = norm.momentum
        norm.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        norm.running_var.mul_(1.0 - m).add_(var, alpha=m)
        norm.num_batches_tracked.add_(1)
    return (xf - mean) * torch.rsqrt(var + norm.eps) * norm.weight.float() \
        + norm.bias.float()


class ConvConcat(nn.Module):
    """Holder of the reference's ``conv_concat.conv`` parameters."""

    def __init__(self, cin: int, cout: int, kernel_size: Sequence[int]):
        super().__init__()
        self.conv = same_conv(cin, cout, kernel_size)


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
        self.use_kernels = True    # False: the plain version (set_kernels)
        cin = in_channels + out_channels
        self.norm_concat = nn.BatchNorm3d(cin, eps=1e-5, momentum=0.1)
        self.conv_concat = ConvConcat(cin, out_channels, kernel_size)
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
        x = upsample_trilinear(x, self.strides, align_corners=False)
        x = x[:, :skip.shape[1], :skip.shape[2], :skip.shape[3]].contiguous()
        skip = skip.to(x.dtype).contiguous()
        conv = self.conv_concat.conv
        if self.training:
            # Training (as the JAX package): concat, BatchNorm on batch
            # statistics, LeakyReLU, then the conv.
            y = F.leaky_relu(batch_norm(torch.cat([x, skip], -1),
                                        self.norm_concat), 0.01)
            return self.swin_layer(conv3d(y.to(x.dtype), conv), tokens)
        scale, shift = bn_fold(self.norm_concat)
        if self.use_kernels:
            w27 = self._kernel_weight() if x.is_cuda else None
            x = conv3x3_fused_pair(x, skip, conv.weight, conv.bias, scale,
                                   shift, w27=w27)
        else:
            x = conv_pair_reference(
                x, skip, conv.weight, conv.bias, scale, shift,
                matmul_dtype=kernel_matmul_dtype(x.dtype, x.device))
        return self.swin_layer(x, tokens)
