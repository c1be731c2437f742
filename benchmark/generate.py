"""The benchmark's inputs, all drawn from ``--seed``: model weights (on
the device), CT-like int16 volumes, training crops with label maps, and
the phase-1 view draws.  The same seed gives the same inputs; every seed
gives the same sizes.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
from torch import nn


def weights(template: nn.Module, seed: int, device) -> dict:
    """A state dict for ``template``'s names and shapes, drawn on
    ``device`` in two calls: Linear, conv and token weights
    xavier-uniform; LayerNorm and BatchNorm scales 1 + 0.1 N and their
    shifts 0.1 N; other biases 0.02 N; BatchNorm running means 0.1 N and
    variances 0.5 + U."""
    state = template.state_dict()
    owner = {}
    for mname, mod in template.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = mod
    total = sum(t.numel() for t in state.values()
                if t.is_floating_point())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, t in state.items():
        if not t.is_floating_point():
            out[name] = torch.zeros_like(t, device=device)
            continue
        n = t.numel()
        z = normal[off:off + n].view(t.shape)
        u = uniform[off:off + n].view(t.shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        mod = owner.get(name)
        if leaf == "running_mean":
            out[name] = 0.1 * z
        elif leaf == "running_var":
            out[name] = 0.5 + u
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm3d)):
            out[name] = (1.0 if leaf == "weight" else 0.0) + 0.1 * z
        elif leaf == "bias":
            out[name] = 0.02 * z
        else:
            fan_out = t.shape[0]
            fan_in = t[0].numel() if t.dim() > 1 else t.shape[0]
            if t.dim() > 2:
                rf = t[0, 0].numel()
                fan_in, fan_out = t.shape[1] * rf, t.shape[0] * rf
            a = math.sqrt(6.0 / (fan_in + fan_out))
            out[name] = (2.0 * u - 1.0) * a
    return out


def ct_volumes(seed: int, n: int, shape, device) -> List[np.ndarray]:
    """``n`` int16 CT-like volumes ``[H, W, D, 1]`` (HU): noise around 40
    with sd 300 and a
    bright ellipsoid (+800) whose centre moves with each volume, clipped
    to [-1024, 3071].  Drawn on ``device``, handed back in host memory."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    axes = [torch.linspace(-1, 1, s, device=device) for s in shape]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    out = []
    for _ in range(n):
        c = 0.3 * (2 * torch.rand(3, generator=gen, device=device) - 1)
        hu = 40.0 + 300.0 * torch.randn(tuple(shape), generator=gen,
                                        device=device)
        inside = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + \
            ((xx - c[2]) / 2) ** 2 < 0.3
        hu = hu + 800.0 * inside
        out.append(hu.clamp(-1024, 3071).to(torch.int16)[..., None].cpu()
                   .numpy())
    return out


def training_batches(seed: int, n_batches: int, batch: int, roi,
                     device, labels: bool) -> List[dict]:
    """``n_batches`` host batches of ``batch`` distinct crops ``[B, H, W,
    D, 1]`` fp32 in [0, 1] (CT-like HU windowed to [-1000, 1000]); with
    ``labels`` a ``mask`` of label 5 in the ellipsoid, 2 in a slab at the
    back of the crop, 0 elsewhere."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    axes = [torch.linspace(-1, 1, s, device=device) for s in roi]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    out = []
    for _ in range(n_batches):
        c = 0.5 * (2 * torch.rand(batch, 3, 1, 1, 1, generator=gen,
                                  device=device) - 1)
        r = 0.15 + 0.2 * torch.rand(batch, 1, 1, 1, generator=gen,
                                    device=device)
        inside = (zz - c[:, 0]) ** 2 + (yy - c[:, 1]) ** 2 + \
            ((xx - c[:, 2]) / 2) ** 2 < r
        hu = 40.0 + 300.0 * torch.randn((batch, *roi), generator=gen,
                                        device=device) + 800.0 * inside
        image = ((hu.clamp(-1024, 3071) + 1000.0) / 2000.0).clamp(0.0, 1.0)
        item = {"image": image[..., None].float().cpu().numpy()}
        if labels:
            mask = torch.where(inside, 5.0, 0.0)
            mask = torch.where((zz > 0.7) & ~inside, 2.0, mask)
            item["mask"] = mask[..., None].float().cpu().numpy()
        out.append(item)
    return out


def view_draws(gen: torch.Generator, batch: int, n_patches: int) -> dict:
    """One phase-1 step's draws: rotation classes per sample and a patch
    rank (a permutation) per view; no axis swap."""
    return {"rot_i": torch.randint(0, 4, (batch,), generator=gen),
            "rot_j": torch.randint(0, 4, (batch,), generator=gen),
            "rank_i": torch.randperm(n_patches, generator=gen),
            "rank_j": torch.randperm(n_patches, generator=gen)}
