"""Plain reference of the first training steps of the two trainers.

Downstream prompt tuning: the backbone frozen; AdamW (decoupled weight
decay, betas 0.9/0.999, eps 1e-8) on the prompt tokens, the prompt
columns' bias parameters (``enc_token``, ``weights_token``) and the
downstream head; loss DiceFocal (softmax, one-hot target, smooth 1e-5,
focal gamma 4, means over the batch) on labels remapped to the active
ones.

Phase-1 multi-view pretraining: two views of the batch (each sample
rotated by its class in the H-W plane, then ``masking_shape`` patches
zeroed by the rank draw, an exact count at ``masking_ratio``); losses
``rec`` (MSE of the masked reconstructions over the kept share),
``rot`` (cross-entropy of the rotation classes), ``con`` (NT-Xent,
temperature 0.5); AdamW on the encoder, its heads and the encoder
prompts with a linear-warmup cosine learning rate of the step count (0
at the first step).

Both run the model in train mode: batch-statistics BatchNorm and the
counter-based dropout.  Each function returns per step the loss, and the
first step's gradients and the change of every trainable parameter over
the steps, by parameter name.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .model import Arith, reference_model


def trainable_names(names: Sequence[str], phase1: bool) -> List[str]:
    """The parameters each trainer updates."""
    out = []
    for n in names:
        parts = n.split(".")
        prompt = n.startswith("prompt_tokens.") or (
            "pe" in parts and parts[parts.index("pe") + 1] in
            ("enc_token", "weights_token"))
        if phase1:
            keep = n.startswith(("input_layer", "encoder_blocks",
                                 "prompt_tokens.enc", "extra_heads."))
        else:
            keep = prompt or n.startswith("extra_heads.downstream")
        if keep:
            out.append(n)
    return out


class AdamW:
    """AdamW written out, one lr and weight decay per parameter."""

    def __init__(self, params: Dict[str, torch.Tensor], wd: Dict[str, float]):
        self.params, self.wd = params, wd
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: Dict[str, float]):
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n, p in self.params.items():
            g = grads[n]
            p.mul_(1.0 - lr[n] * self.wd[n])
            self.m[n].mul_(b1).add_((1 - b1) * g)
            self.v[n].mul_(b2).add_((1 - b2) * g * g)
            denom = (self.v[n].sqrt() / math.sqrt(1 - b2 ** self.t)) + eps
            p.add_(-lr[n] / (1 - b1 ** self.t) * self.m[n] / denom)


def warmup_cosine(base: float, warmup: int, total: int, step: int) -> float:
    if step < warmup:
        return base * step / max(1.0, float(warmup))
    progress = (step - warmup) / float(max(1, total - warmup))
    return base * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def dice_focal(logits, labels, gamma: float = 4.0) -> torch.Tensor:
    """DiceFocal with background, means over batch and classes."""
    p = torch.softmax(logits.float(), -1)
    t = F.one_hot(labels.long(), p.shape[-1]).float()
    spatial = tuple(range(1, p.dim() - 1))
    dice = 1.0 - (2.0 * (p * t).sum(spatial) + 1e-5) / \
        (p.sum(spatial) + t.sum(spatial) + 1e-5)
    pc = p.clamp(1e-8, 1.0)
    focal = -t * (1.0 - pc) ** gamma * torch.log(pc)
    return dice.mean() + focal.mean()


def remap_labels(mask: torch.Tensor, active: Sequence[int]) -> torch.Tensor:
    out = torch.zeros_like(mask)
    for new, lbl in enumerate(sorted(int(v) for v in active)):
        out[mask == lbl] = new
    return out


def rotate(x: torch.Tensor, ks) -> torch.Tensor:
    return torch.stack([torch.rot90(x[i], int(k), dims=(0, 1))
                        for i, k in enumerate(ks)])


def patch_mask(rank, roi, patch, ratio: float) -> torch.Tensor:
    """Keep-mask ``[H, W, D]``: patches whose rank is under
    ``round(n * (1 - ratio))``."""
    grid = [r // p for r, p in zip(roi, patch)]
    n = int(np.prod(grid))
    keep = (torch.as_tensor(rank).reshape(-1) < round(n * (1 - ratio)))
    keep = keep.reshape(grid)
    for ax, rep in enumerate(patch):
        keep = keep.repeat_interleave(int(rep), dim=ax)
    return keep


def nt_xent(a: torch.Tensor, b: torch.Tensor, temp: float = 0.5):
    n = a.shape[0]
    z = torch.cat([a / a.norm(dim=1, keepdim=True).clamp_min(1e-12),
                   b / b.norm(dim=1, keepdim=True).clamp_min(1e-12)])
    sim = z @ z.T
    idx = torch.arange(2 * n, device=z.device)
    pos = torch.exp(sim[idx, (idx + n) % (2 * n)] / temp)
    neg = torch.exp(sim / temp).masked_fill(
        torch.eye(2 * n, dtype=torch.bool, device=z.device), 0.0)
    return torch.sum(-torch.log(pos / neg.sum(1))) / (2 * n)


def phase1_losses(model, image, draw, conf) -> torch.Tensor:
    roi, patch = tuple(conf["roi_size"]), tuple(conf["masking_shape"])
    ratio = float(conf["masking_ratio"])
    views, keeps = [], []
    for rot, rank in ((draw["rot_i"], draw["rank_i"]),
                      (draw["rot_j"], draw["rank_j"])):
        keep = patch_mask(rank, roi, patch, ratio).to(image.device)
        views.append(rotate(image, rot) * keep[None, ..., None])
        keeps.append(keep[None, ..., None].float())
    outs = [model(v) for v in views]
    rec = torch.cat([o["reconstruction"] * k for o, k in zip(outs, keeps)])
    img = torch.cat([v * k for v, k in zip(views, keeps)])
    l_rec = torch.mean((rec - img) ** 2) / (1 - ratio)
    labels = torch.cat([torch.as_tensor(draw["rot_i"]),
                        torch.as_tensor(draw["rot_j"])]).to(image.device)
    l_rot = F.cross_entropy(torch.cat([o["rotation_prediction"]
                                       for o in outs]), labels)
    l_con = nt_xent(outs[0]["contrastive_coding"],
                    outs[1]["contrastive_coding"])
    return float(conf["weight_rec"]) * l_rec + \
        float(conf["weight_rot"]) * l_rot + float(conf["weight_con"]) * l_con


def follow_steps(conf: dict, state: dict, batches: list, draws: list,
                 device, arith: Arith, dropout_seed: int) -> dict:
    """Run the first ``len(batches)`` training steps of the trainer that
    ``conf`` selects from the weights ``state``.  Returns ``{"loss":
    [per step], "grad": {name: first step's gradient}, "change": {name:
    parameter after the steps minus before}}`` (host fp32)."""
    phase1 = conf["training_mode"] == "self_supervised_learning_encoder"
    model = reference_model(conf, state, device, arith, dropout_seed,
                            train=True)
    named = dict(model.named_parameters())
    names = trainable_names(list(named), phase1)
    for n, p in named.items():
        p.requires_grad_(n in names)
    params = {n: named[n] for n in names}
    if phase1:
        wd = {n: float(conf["weight_decay_prompt_tokens"] if _is_prompt(n)
                       else conf["weight_decay_multi_view"]) for n in names}
    else:
        wd = {n: float(conf["weight_decay_downstream"]) for n in names}
    opt = AdamW(params, wd)
    start = {n: p.detach().clone() for n, p in params.items()}
    out = {"loss": [], "grad": None, "change": None}
    for step, batch in enumerate(batches):
        image = torch.as_tensor(batch["image"], device=device).float()
        if phase1:
            loss = phase1_losses(model, image, draws[step], conf)
            lr = {n: warmup_cosine(
                float(conf["lr_prompt_tokens"] if _is_prompt(n)
                      else conf["lr_multi_view"]),
                int(conf["warmup_steps_multi_view"]),
                int(conf["t_total_multi_view"]), step) for n in names}
        else:
            labels = remap_labels(torch.as_tensor(batch["mask"],
                                                  device=device)[..., 0],
                                  conf["active_labels_downstream"])
            loss = dice_focal(model(image), labels)
            lr = {n: float(conf["lr_downstream"]) for n in names}
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        if step == 0:
            out["grad"] = {n: g.detach().float().cpu()
                           for n, g in grads.items()}
        out["loss"].append(float(loss.detach()))
        opt.step(grads, lr)
    out["change"] = {n: (p.detach() - start[n]).float().cpu()
                     for n, p in params.items()}
    return out


def _is_prompt(name: str) -> bool:
    return name.startswith("prompt_tokens.enc") or \
        ".pe.enc_token" in name or ".pe.weights_token" in name
