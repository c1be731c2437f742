"""Plain float32 Swin-UNETR with prompt tokens (downstream and phase-1
modes), written out from the model's description.

Layout channels-last ``[B, H, W, D, C]``.  Parameter names are those of
the published reference's torch keys, so one state dict loads into this
model and into the program.  What it follows, step by step:

* patch embed: a stride-2 conv, then BatchNorm (eps 1e-6);
* encoder stages: a (no-shift, shifted) pair of Swin blocks, then patch
  merging; heads ``num_heads_encoder * 2**i``;
* a Swin block: zero-padding to window multiples (``pad_mode``), a roll
  by the shift, a *dilated* window partition (window size as the slow
  factor of each axis), attention of the content rows over the content
  keys plus the block's prompt tokens after LN1, a multiplicative 0/1
  mask of the shift regions, softmax, projection, residual, LN2, a single
  Linear MLP, residual.  Where an axis is shorter than the window and is
  the only padding, the pad rows are folded into one key column (its
  bias the log-sum-exp of the pad columns' biases, or ``ln(n_pad)`` with
  a zero key under a shift), which is what padding computes for the
  content rows;
* the relative positional bias: per-axis embeddings projected per head,
  averaged over the axes and scaled by ``E**-0.5``; prompt columns get
  ``weights_token . enc_token``;
* dropout (training): counter-based, the murmur3 finalizer over
  ``idx * 0x9E3779B9 + seed``, dropped where the low 24 bits fall under
  ``rate * 2**24``; two seeds per block call from one CPU generator;
* decoder (downstream): a 3x3x3 bottleneck conv plus residual, three
  Swin up blocks (trilinear upsample, crop to the skip, BatchNorm,
  LeakyReLU, 3x3x3 conv of ``[x, skip]``, a no-shift/shift pair with the
  decoder prompts), a x2 trilinear upsample, the head (BatchNorm, 3x3x3
  conv);
* phase-1 heads: reconstruction (conv, instance norm, LeakyReLU,
  trilinear upsample per stage, then a 1x1x1 conv), rotation and
  contrastive linears on the spatial mean of the deepest features.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

F8_MAX = 448.0          # largest float8 e4m3 value
_MASK32 = 0xFFFFFFFF


class Arith:
    """The precision of every product: ``fp32`` or ``fp8`` (operands
    rounded to float8 e4m3 with a per-tensor scale; sums in fp32; the
    gradient passes the rounding unchanged)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {mode}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.mode == "fp32":
            return t
        scale = (t.detach().abs().amax() / F8_MAX).clamp_min(1e-30)
        deq = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (deq - t.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def linear(self, x, weight, bias=None):
        return F.linear(self.q(x), self.q(weight),
                        None if bias is None else bias.float())

    def conv(self, x, conv: nn.Conv3d) -> torch.Tensor:
        """Channels-last conv with ``conv``'s stride and padding."""
        y = F.conv3d(self.q(x).permute(0, 4, 1, 2, 3), self.q(conv.weight),
                     None if conv.bias is None else conv.bias.float(),
                     stride=conv.stride, padding=conv.padding)
        return y.permute(0, 2, 3, 4, 1)


# ------------------------------------------------------------------ dropout
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash_u32(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer of ``idx * 0x9E3779B9 + seed`` (uint32 in int64)."""
    x = idx.to(torch.int64) & _MASK32
    x = (_mul32(x, 0x9E3779B9) + (int(seed) & _MASK32)) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_mask(seed: int, idx: torch.Tensor, rate: float) -> torch.Tensor:
    """0 where dropped, ``1 / float32(1 - rate)`` where kept."""
    keep = (hash_u32(seed, idx) & 0xFFFFFF) >= int(round(rate * (1 << 24)))
    scale = float(np.float32(1.0) / np.float32(1.0 - rate))
    return keep.float() * scale


# ------------------------------------------------------------------ windows
def window_partition_np(m: np.ndarray, ws) -> np.ndarray:
    """``[H, W, D]`` -> ``[P, N]``: window ``(p1, p2, p3)`` holds the
    voxels ``(i * p1 + a, j * p2 + b, k * p3 + c)`` (dilated)."""
    h, w, d = m.shape
    p1, p2, p3 = h // ws[0], w // ws[1], d // ws[2]
    m = m.reshape(ws[0], p1, ws[1], p2, ws[2], p3).transpose(1, 3, 5, 0, 2, 4)
    return m.reshape(p1 * p2 * p3, int(np.prod(ws)))


def shift_labels(shape, ws, shift, pads) -> np.ndarray:
    """``[P, N]`` region labels of the shifted partition: 27 regions by
    the literal slices ``(0, -w), (-w, -s), (-s, None)`` per axis, and
    the unpadded interior relabelled 100 where padded."""
    img = np.zeros(shape, np.float32)
    cuts = [(slice(0, -w), slice(-w, -s), slice(-s, None))
            for w, s in zip(ws, shift)]
    cnt = 0
    for a in cuts[0]:
        for b in cuts[1]:
            for c in cuts[2]:
                img[a, b, c] = cnt
                cnt += 1
    if any(pads):
        img[pads[0]:shape[0] - pads[1], pads[2]:shape[1] - pads[3],
            pads[4]:shape[2] - pads[5]] = 100
    return window_partition_np(img, ws).astype(np.int64)


def paddings_of(dims, ws, mode: str) -> Tuple[int, ...]:
    """(lo, hi) zero padding per axis up to window multiples, as applied:
    ``reference`` pads every axis once any is misaligned, (ceil, floor);
    ``aligned`` pads misaligned axes only, (floor, ceil)."""
    if mode == "reference" and not any(d % w for d, w in zip(dims, ws)):
        return (0,) * 6
    out = []
    for d, w in zip(dims, ws):
        if mode == "reference":
            t = w - d % w
            out += [math.ceil(t / 2), math.floor(t / 2)]
        else:
            t = (w - d % w) % w
            out += [t // 2, t - t // 2]
    return tuple(out)


def crop_paddings(pads, mode: str) -> Tuple[int, ...]:
    """The (lo, hi) of the un-pad crop and the interior relabel: the
    applied ones swapped under ``reference``."""
    if mode != "reference":
        return tuple(pads)
    return (pads[1], pads[0], pads[3], pads[2], pads[5], pads[4])


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm with ``var = E[x^2] - mean^2``."""
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


# --------------------------------------------------------------- modules
class RelativePE(nn.Module):
    def __init__(self, e: int, heads: int, ws, max_prompts: int,
                 tokens: int):
        super().__init__()
        self.e, self.heads = e, heads
        for name, w in zip("hwd", ws):
            setattr(self, f"enc_content_{name}",
                    nn.Parameter(torch.zeros(2 * w - 1, e)))
            setattr(self, f"weights_content_{name}",
                    nn.Parameter(torch.zeros(heads, e)))
        self.enc_token = nn.ParameterList(
            [nn.Parameter(torch.zeros(tokens, e)) for _ in range(max_prompts)])
        self.weights_token = nn.Parameter(torch.zeros(heads, e))

    def bias(self, ws, n_tok: int) -> torch.Tensor:
        """``[H, N, N + T]`` content rows' bias over content and prompt
        columns."""
        axes = []
        for name, w in zip("hwd", ws):
            pos = np.arange(w)
            rel = np.clip(pos[None, :] - pos[:, None] + w - 1, 0, 2 * w - 2)
            emb = getattr(self, f"enc_content_{name}")[torch.as_tensor(
                rel, device=self.weights_token.device)]
            axes.append(torch.einsum(
                "he,nme->hnm", getattr(self, f"weights_content_{name}"), emb))
        r, c, d = axes
        content = (r[:, :, None, None, :, None, None]
                   + c[:, None, :, None, None, :, None]
                   + d[:, None, None, :, None, None, :]) / 3.0
        n = int(np.prod(ws))
        content = content.reshape(self.heads, n, n) * self.e ** -0.5
        if n_tok == 0:
            return content
        tok = torch.cat(list(self.enc_token))[:n_tok]
        scores = torch.einsum("he,ne->hn", self.weights_token, tok) \
            * self.e ** -0.5
        return torch.cat([content, scores[:, None, :].expand(-1, n, -1)], -1)


class Attention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(c, c, bias=False)
        self.to_v = nn.Linear(c, c, bias=False)
        self.proj = nn.Linear(c, c)


class SwinBlock(nn.Module):
    def __init__(self, c, ws, e, heads, max_prompts, tokens, shift,
                 pad_mode, drop, ctx):
        super().__init__()
        self.c, self.ws, self.heads = c, tuple(ws), heads
        self.shift, self.pad_mode, self.drop = tuple(shift), pad_mode, drop
        self.ctx = ctx
        self.pe = RelativePE(e, heads, ws, max_prompts, tokens)
        self.attn_norm = nn.LayerNorm(c, eps=1e-6)
        self.attn = Attention(c)
        self.mlp_norm = nn.LayerNorm(c, eps=1e-6)
        self.mlp = nn.Linear(c, c)

    def _geometry(self, dims, n_tok):
        """(grid, window, pads to apply, crop, bias, labels, fold, extra
        columns before the prompts) of a block call at ``dims``."""
        ws = self.ws
        shift = tuple(0 if d <= w else s
                      for d, w, s in zip(dims, ws, self.shift))
        pads = paddings_of(dims, ws, self.pad_mode)
        crop = crop_paddings(pads, self.pad_mode)
        fold_axes = [i for i in range(3) if dims[i] < ws[i]]
        other_pads = any(pads[2 * i] or pads[2 * i + 1]
                         for i in range(3) if i not in fold_axes)
        full = self.pe.bias(ws, n_tok)                 # [H, N, N + T]
        n_full = int(np.prod(ws))
        dev = full.device
        if fold_axes and not other_pads and pads == crop:
            keep = [np.arange(pads[2 * i], pads[2 * i] + dims[i])
                    if i in fold_axes else np.arange(ws[i]) for i in range(3)]
            grid = np.zeros(ws, bool)
            grid[np.ix_(*keep)] = True
            ci = np.where(grid.reshape(-1))[0]
            ci_t = torch.as_tensor(ci, device=dev)
            pi_t = torch.as_tensor(np.setdiff1d(np.arange(n_full), ci),
                                   device=dev)
            rows = full[:, ci_t]                       # [H, Mc, N + T]
            padded = tuple(d + pads[2 * i] + pads[2 * i + 1]
                           for i, d in enumerate(dims))
            if any(shift):
                fold_col = rows.new_full((rows.shape[0], ci.size, 1),
                                         float(np.log(n_full - ci.size)))
                lab = shift_labels(padded, ws, shift, pads)[:, ci]
                labels = np.concatenate(
                    [lab, np.full((lab.shape[0], 1 + n_tok), -1)], -1)
                fold = "count"
            else:
                fold_col = torch.logsumexp(rows[:, :, pi_t], -1, keepdim=True)
                labels = None
                fold = "key"
            bias = torch.cat([rows[:, :, ci_t], fold_col,
                              rows[:, :, n_full:]], -1)
            window = tuple(dims[i] if i in fold_axes else ws[i]
                           for i in range(3))
            return dims, window, None, None, bias, labels, fold, shift
        padded = tuple(d + pads[2 * i] + pads[2 * i + 1]
                       for i, d in enumerate(dims))
        labels = None
        if any(shift):
            lab = shift_labels(padded, ws, shift, crop)
            labels = np.concatenate(
                [lab, np.full((lab.shape[0], n_tok), -1)], -1)
        return (padded, ws, pads if any(pads) else None,
                crop if any(pads) else None, full, labels, None, shift)

    def forward(self, x: torch.Tensor, tokens: Optional[torch.Tensor]):
        ar = self.ctx.arith
        b, c = x.shape[0], x.shape[-1]
        dims = tuple(x.shape[1:4])
        n_tok = 0 if tokens is None else tokens.shape[0]
        grid, window, pads, crop, bias, labels, fold, shift = \
            self._geometry(dims, n_tok)
        if pads is not None:
            x = F.pad(x, (0, 0, pads[4], pads[5], pads[2], pads[3],
                          pads[0], pads[1]))
        src = np.roll(np.arange(int(np.prod(grid))).reshape(grid),
                      tuple(-s for s in shift), axis=(0, 1, 2))
        idx = torch.as_tensor(window_partition_np(src, window).reshape(-1),
                              device=x.device)
        m = int(np.prod(window))
        xw = x.reshape(b, -1, c)[:, idx].reshape(-1, m, c).float()
        bp = xw.shape[0]
        h = self.heads
        dh = c // h
        wq, wk, wv = (self.attn.to_q.weight.t(), self.attn.to_k.weight.t(),
                      self.attn.to_v.weight.t())
        y = layer_norm(xw, self.attn_norm.weight, self.attn_norm.bias)
        q, k, v = ar.mm(y, wq), ar.mm(y, wk), ar.mm(y, wv)
        ext = []
        if fold is not None:
            ext.append(self.attn_norm.bias.float()[None])
        if tokens is not None:
            ext.append(layer_norm(tokens.float(), self.attn_norm.weight,
                                  self.attn_norm.bias))
        if ext:
            e = torch.cat(ext)
            ek, ev = ar.mm(e, wk), ar.mm(e, wv)
            if fold == "count":
                ek = torch.cat([torch.zeros_like(ek[:1]), ek[1:]])
            k = torch.cat([k, ek.expand(bp, -1, -1)], 1)
            v = torch.cat([v, ev.expand(bp, -1, -1)], 1)
        n = k.shape[1]
        qh = q.reshape(bp, m, h, dh).transpose(1, 2)
        kh = k.reshape(bp, n, h, dh).transpose(1, 2)
        vh = v.reshape(bp, n, h, dh).transpose(1, 2)
        s = ar.mm(qh, kh.transpose(-1, -2)) * dh ** -0.5 + bias
        if labels is not None:
            lab = torch.as_tensor(labels, device=x.device).repeat(b, 1)
            allowed = (lab[:, :m, None] == lab[:, None, :]) | \
                (lab[:, None, :] < 0)
            s = s * allowed[:, None].float()
        p = torch.softmax(s, -1)
        seeds = self.ctx.seeds() if self.training and any(self.drop) \
            else None
        if seeds is not None and self.drop[0] > 0:
            cols = n + (1 + (-(m + n_tok + 1)) % 8 - 1 if fold else 0)
            j = torch.arange(n, device=x.device)
            j = j + (j > m).long() * (cols - n)
            cnt = ((torch.arange(bp, device=x.device)[:, None, None, None]
                    * h + torch.arange(h, device=x.device)[:, None, None])
                   * m + torch.arange(m, device=x.device)[:, None]) * cols + j
            p = p * keep_mask(seeds[0], cnt, self.drop[0])
        o = ar.mm(p, vh).transpose(1, 2).reshape(bp, m, c)
        proj = ar.linear(o, self.attn.proj.weight, self.attn.proj.bias)
        if seeds is not None and self.drop[1] > 0:
            cnt = (torch.arange(bp, device=x.device)[:, None, None] * m
                   + torch.arange(m, device=x.device)[:, None]) * c \
                + torch.arange(c, device=x.device)
            proj = proj * keep_mask(seeds[1], cnt, self.drop[1])
        x1 = xw + proj
        out = x1 + ar.linear(layer_norm(x1, self.mlp_norm.weight,
                                        self.mlp_norm.bias),
                             self.mlp.weight, self.mlp.bias)
        inv = torch.argsort(idx)
        out = out.reshape(b, -1, c)[:, inv].reshape(b, *grid, c)
        if crop is not None:
            out = out[:, crop[0]:grid[0] - crop[1], crop[2]:grid[1] - crop[3],
                      crop[4]:grid[2] - crop[5]]
        return out


class PatchMerging(nn.Module):
    def __init__(self, c: int, cout: int, merge_last: bool, ctx):
        super().__init__()
        self.merge_last, self.ctx = merge_last, ctx
        k = 8 if merge_last else 4
        self.norm = nn.LayerNorm(k * c, eps=1e-6)
        self.reduction = nn.Linear(k * c, cout, bias=False)

    def forward(self, x):
        _, h, w, d, _ = x.shape
        x = F.pad(x, (0, 0, d % 2, 0, w % 2, 0, h % 2, 0))
        if self.merge_last:
            parts = [x[:, a::2, b::2, c::2] for a, b, c in (
                (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
                (1, 0, 1), (0, 1, 1), (1, 1, 1))]
        else:
            parts = [x[:, a::2, b::2] for a, b in ((0, 0), (1, 0), (0, 1),
                                                     (1, 1))]
        x = self.norm(torch.cat(parts, -1).float())
        return self.ctx.arith.linear(x, self.reduction.weight)


class BlockPair(nn.Module):
    def __init__(self, c, heads, conf, tokens, down, merge_last, ctx):
        super().__init__()
        ws = tuple(conf.attn_window_size)
        drop = (float(conf.attn_drop), float(conf.proj_drop))
        self.swin_blocks = nn.ModuleList([
            SwinBlock(c, ws, conf.pos_bias_embed_dim, heads, conf.max_prompts,
                      tokens, (0, 0, 0) if i == 0 else
                      tuple(w // 2 for w in ws), conf.pad_mode, drop, ctx)
            for i in range(2)])
        self.merge = PatchMerging(c, 2 * c, merge_last, ctx) if down else None

    def forward(self, x, tokens=(None, None)):
        for blk, tok in zip(self.swin_blocks, tokens):
            x = blk(x, tok)
        return x if self.merge is None else self.merge(x)


def batch_norm(x: torch.Tensor, norm: nn.BatchNorm3d) -> torch.Tensor:
    """Channels-last BatchNorm in fp32: running statistics in eval mode;
    batch mean and biased variance ``max(E[x^2] - E[x]^2, 0)`` in train
    mode, the running statistics updated with momentum 0.1."""
    x = x.float()
    if not norm.training:
        scale = norm.weight * torch.rsqrt(norm.running_var + norm.eps)
        return x * scale + (norm.bias - norm.running_mean * scale)
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        norm.running_mean.mul_(0.9).add_(0.1 * mean)
        norm.running_var.mul_(0.9).add_(0.1 * var)
    return (x - mean) * torch.rsqrt(var + norm.eps) * norm.weight + norm.bias


def upsample(x, scale, align_corners: bool) -> torch.Tensor:
    """Trilinear upsample of channels-last ``x`` to ``floor(dim * s)``."""
    out = tuple(int(d * s) for d, s in zip(x.shape[1:4], scale))
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=out, mode="trilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 4, 1)


def instance_norm(x, eps: float = 1e-5):
    dims = tuple(range(1, x.dim() - 1))
    mean = x.mean(dims, keepdim=True)
    var = ((x * x).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps)


class ConvUnit(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 3, padding=1)


class SwinUpBlock(nn.Module):
    def __init__(self, cin, cout, strides, conf, ctx):
        super().__init__()
        self.strides, self.ctx = tuple(strides), ctx
        self.norm_concat = nn.BatchNorm3d(cin + cout, eps=1e-5)
        self.conv_concat = ConvUnit(cin + cout, cout)
        self.swin_layer = BlockPair(cout, conf.num_heads_decoder, conf,
                                    conf.tokens_per_prompt_decoder, False,
                                    False, ctx)

    def forward(self, x, skip, tokens):
        x = upsample(x, self.strides, False)
        x = x[:, :skip.shape[1], :skip.shape[2], :skip.shape[3]]
        y = F.leaky_relu(batch_norm(torch.cat([x, skip], -1),
                                    self.norm_concat), 0.01)
        return self.swin_layer(self.ctx.arith.conv(y, self.conv_concat.conv),
                               tokens)


class Context:
    """What every module shares: the arithmetic and the dropout seeds'
    generator (two uint32 seeds per block call, in call order)."""

    def __init__(self, arith: Arith, dropout_seed: int):
        self.arith = arith
        self.generator = torch.Generator().manual_seed(int(dropout_seed))

    def seeds(self):
        return torch.randint(0, 2 ** 32, (2,), dtype=torch.int64,
                             generator=self.generator).tolist()


class SwinUnetR(nn.Module):
    """``conf``: the model keys of the benchmark's configuration (a
    mapping); ``training_mode`` ``downstream`` or
    ``self_supervised_learning_encoder``."""

    def __init__(self, conf: dict, arith: Optional[Arith] = None,
                 dropout_seed: int = 0):
        super().__init__()
        conf = SimpleNamespace(**conf)
        self.conf = conf
        self.ctx = Context(arith or Arith(), dropout_seed)
        self.phase1 = conf.training_mode == "self_supervised_learning_encoder"
        depth, hc = conf.depth_unet, list(conf.hidden_channels)
        patch = tuple(conf.input_patch_size)
        enc_tok = conf.tokens_per_prompt_encoder
        self.input_layer = nn.Sequential(
            nn.Conv3d(conf.input_channels, hc[0], patch, stride=patch),
            nn.BatchNorm3d(hc[0], eps=1e-6))
        self.encoder_blocks = nn.ModuleList([
            BlockPair(hc[i], conf.num_heads_encoder * 2 ** i, conf, enc_tok,
                      True, i < 1, self.ctx) for i in range(depth)])
        self.prompt_tokens = nn.Module()
        if conf.use_encoder_prompting:
            self.prompt_tokens.enc = nn.ParameterList([
                nn.Parameter(torch.zeros(enc_tok, hc[i // 2]))
                for i in range(2 * depth)])
        if self.phase1:
            self.extra_heads = nn.ModuleDict(self._ssl_heads(conf))
            return
        if conf.use_decoder_prompting:
            self.prompt_tokens.dec = nn.ParameterList([
                nn.Parameter(torch.zeros(conf.tokens_per_prompt_decoder,
                                         hc[-(i + 1) // 2 - 1]))
                for i in range(2 * depth)])
        in_chs = hc[:depth][::-1]
        out_chs = hc[1:depth + 1][::-1]
        self.bottleneck = nn.Conv3d(out_chs[0], out_chs[0], 3, padding=1)
        self.decoder_blocks = nn.ModuleList([
            SwinUpBlock(out_chs[i], in_chs[i],
                        (2, 2, 1 if i < depth - 1 else 2), conf, self.ctx)
            for i in range(depth)])
        self.extra_heads = nn.ModuleDict({"downstream": nn.Sequential(
            nn.BatchNorm3d(hc[0], eps=1e-5),
            nn.Conv3d(hc[0], conf.output_channels_downstream, 3, padding=1))})

    @staticmethod
    def _ssl_heads(conf) -> dict:
        depth, top = conf.depth_unet, conf.hidden_channels[-1]
        chs = [top // 2 ** i for i in range(depth + 1)] + [top // 2 ** depth]
        layers = []
        for i in range(depth + 1):
            layers += [nn.Conv3d(chs[i], chs[i + 1], 3, padding=1),
                       nn.InstanceNorm3d(chs[i + 1]), nn.LeakyReLU(0.01),
                       nn.Identity()]
        layers.append(nn.Conv3d(chs[-1], conf.input_channels, 1))
        return {"reconstruction": nn.Sequential(*layers),
                "rotation_prediction": nn.Linear(top, 4),
                "contrastive_coding": nn.Linear(top,
                                                conf.contrastive_coding_dim)}

    def _tokens(self, name, i):
        tokens = getattr(self.prompt_tokens, name, None)
        return None if tokens is None else tokens[i]

    def forward(self, x: torch.Tensor):
        ar, conf = self.ctx.arith, self.conf
        enc = batch_norm(ar.conv(x.float(), self.input_layer[0]),
                         self.input_layer[1])
        feats = [enc]
        for j, stage in enumerate(self.encoder_blocks):
            enc = stage(enc, (self._tokens("enc", 2 * j),
                              self._tokens("enc", 2 * j + 1)))
            feats.insert(0, enc)
        if self.phase1:
            return self._ssl_outputs(feats[0])
        dec = ar.conv(feats[0], self.bottleneck) + feats[0]
        for j, up in enumerate(self.decoder_blocks):
            dec = up(dec, feats[j + 1], (self._tokens("dec", 2 * j),
                                         self._tokens("dec", 2 * j + 1)))
        out = upsample(dec, (2, 2, 2), False)
        head = self.extra_heads["downstream"]
        return ar.conv(batch_norm(out, head[0]), head[1])

    def _ssl_outputs(self, top: torch.Tensor) -> dict:
        ar, heads = self.ctx.arith, self.extra_heads
        depth = self.conf.depth_unet
        rec, layers = top, list(heads["reconstruction"])
        for i in range(depth + 1):
            scale = (2, 2, 1 if i < depth - 1 else 2)
            rec = F.leaky_relu(instance_norm(ar.conv(rec, layers[4 * i])),
                               0.01)
            rec = upsample(rec, scale, True)
        pooled = top.mean(dim=(1, 2, 3))
        return {"reconstruction": ar.conv(rec, layers[-1]),
                "rotation_prediction": ar.linear(
                    pooled, heads["rotation_prediction"].weight,
                    heads["rotation_prediction"].bias),
                "contrastive_coding": ar.linear(
                    pooled, heads["contrastive_coding"].weight,
                    heads["contrastive_coding"].bias)}


def model_keys(conf: dict) -> dict:
    """The keys of a configuration that the model reads."""
    keys = ("training_mode", "input_channels", "depth_unet",
            "hidden_channels", "input_patch_size", "num_heads_encoder",
            "num_heads_decoder", "attn_window_size", "pos_bias_embed_dim",
            "attn_drop", "proj_drop", "max_prompts",
            "tokens_per_prompt_encoder", "tokens_per_prompt_decoder",
            "use_encoder_prompting", "use_decoder_prompting",
            "contrastive_coding_dim", "output_channels_downstream",
            "pad_mode")
    return {k: conf[k] for k in keys}


def shape_check(conf: dict) -> None:
    """The decoder layout and heads this reference writes out."""
    if conf.get("unetr_res_block", "none") != "none" or \
            conf.get("unetr_up_block", "swin") != "swin":
        raise ValueError("the reference covers unetr_res_block none with "
                         "unetr_up_block swin")
    if conf.get("use_mutual_learning"):
        raise ValueError("the reference covers phase 1 without mutual "
                         "learning")


@contextlib.contextmanager
def strict_fp32():
    """Products in true fp32 on the card (no TF32) inside the block; the
    process's settings as they were after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_model(conf: dict, state: dict, device, arith: Arith,
                    dropout_seed: int = 0, train: bool = False) -> SwinUnetR:
    """The reference of ``conf`` loaded (strictly) with ``state``."""
    shape_check(conf)
    model = SwinUnetR(model_keys(conf), arith, dropout_seed)
    model.load_state_dict(state, strict=True)
    model.to(device)
    return model.train(train)

