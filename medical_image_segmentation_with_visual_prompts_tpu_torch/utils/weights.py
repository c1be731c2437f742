"""Weights of the port: seeded initialisation and reference checkpoints.

The port's module attributes carry the reference's torch key names
(the schema of the JAX package's ``utils/torch_export.py`` /
``torch_import.py::build_key_rules``), so

* ``model.load_state_dict(export_state_dict(variables, conf))`` loads a
  JAX model's parameters (numpy arrays) strictly, and
* a ``.pt`` written by ``mivp-export-checkpoint`` (or a reference
  checkpoint) loads with :func:`load_reference_checkpoint`.

The ``pe.relative_dist_*`` tables are derived buffers: not in the
port's state dict, and dropped from loaded checkpoints.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Union

import torch
from torch import nn


def _uniform(t: torch.Tensor, bound: float, gen: torch.Generator):
    t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter and BatchNorm statistic from ``generator``.

    Linear/conv weights and embeddings are xavier-uniform; LayerNorm and
    BatchNorm affines are perturbed around (1, 0) and the BatchNorm
    running statistics are non-trivial, so the inference BN folds and the
    pad-fold row (the LN1 bias) are exercised.
    """
    g = generator
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = model.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else model
        if isinstance(owner, (nn.LayerNorm, nn.BatchNorm3d)):
            base = 1.0 if leaf == "weight" else 0.0
            p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
        elif leaf == "bias":
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
        else:
            fan_out = p.shape[0]
            fan_in = p[0].numel() if p.dim() > 1 else p.shape[0]
            if p.dim() > 2:    # conv [out, in, k...]
                rf = p[0, 0].numel()
                fan_in, fan_out = p.shape[1] * rf, p.shape[0] * rf
            _uniform(p, math.sqrt(6.0 / (fan_in + fan_out)), g)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm3d):
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                   generator=g))
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                 generator=g))
    return model


def load_reference_checkpoint(path: Union[str, Path], derived: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """State dict of a reference-schema ``.pt`` (a bare state dict or
    ``{"model_state_dict": ...}``), without the derived
    ``pe.relative_dist_*`` buffers unless ``derived``."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    return {k: v for k, v in sd.items()
            if derived or ".pe.relative_dist_" not in k}
