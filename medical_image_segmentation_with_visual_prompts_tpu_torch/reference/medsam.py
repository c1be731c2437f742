"""Plain float32 reference of MedSAM: SAM ViT-B prompted with a box, and
MedSAM's slice protocol for a CT study.

Written out from MedSAM's code (github.com/bowang-lab/MedSAM:
``segment_anything/build_sam.py::build_sam_vit_b``, the modules under
``segment_anything/modeling/`` and ``MedSAM_Inference.py``), in plain
``torch`` operations with explicit softmax attention.  Imports ``torch``,
``math`` and ``numpy`` only.  Parameter names are segment_anything's, so
MedSAM's ``medsam_vit_b.pth`` state dict loads into :class:`MedSAM`.

What it follows, step by step:

* image encoder: a 16x16 stride-16 patch conv, plus the absolute
  position embedding; 12 pre-norm blocks (LayerNorm eps 1e-6; attention;
  residual; LayerNorm; MLP ``lin1``, exact-erf GELU, ``lin2``; residual).
  Blocks 2, 5, 8 and 11 attend over the whole 64x64 grid; the others in
  14x14 windows of the grid zero-padded (after ``norm1``) to 70x70, the
  padded tokens attended to unmasked.  Every block adds the decomposed
  relative position bias to the scores: ``attn[q, (kh, kw)] += <q,
  Rh[qh - kh + S - 1]> + <q, Rw[qw - kw + S - 1]>`` with the *unscaled*
  q (the scores themselves take ``q * hd**-0.5``).  Neck: 1x1 conv
  (no bias), LayerNorm2d (eps 1e-6), 3x3 conv (no bias), LayerNorm2d;
* prompt encoder, a box: ``+ 0.5`` (pixel centres), two corners divided
  by the image size, random Fourier features ``[sin, cos](2 pi (2c - 1)
  G)`` of the 2x128 Gaussian matrix ``G``; corner 0 adds
  ``point_embeddings[2]``, corner 1 ``point_embeddings[3]``.  The dense
  prompt is ``no_mask_embed`` over the 64x64 grid; the image's position
  encoding the same Fourier map of the grid's pixel centres.  The
  Fourier products stay in float32 in every precision (the program keeps
  them so);
* mask decoder: tokens ``[iou, 4 mask tokens, 2 box corners]``; a
  two-way transformer of depth 2 (width 256, 8 heads, LayerNorm eps
  1e-5, MLP 2048 with ReLU): token self-attention (layer 0: without the
  position encoding and without its residual), token-to-image
  cross-attention, the MLP, image-to-token cross-attention, each
  followed by its LayerNorm; the cross-attentions project to 128; the
  position encodings are added to q and k, never to v.  A final
  token-to-image attention and LayerNorm.  Upscaling: ConvTranspose
  256->64 (k2 s2), LayerNorm2d, GELU, ConvTranspose 64->32, GELU; a
  3-layer ReLU hypernetwork MLP per mask token; masks ``hyper_in @
  upscaled``.  MedSAM's ``multimask_output=False`` keeps mask 0.  The
  image embedding is repeated per prompt only when their counts differ
  (MedSAM's fork; here one box per slice);
* slice protocol (:func:`study_probs`): the int16 slices windowed to
  ``hu_window`` (-160..240 HU) and scaled to [0, 1], resized to 1024^2,
  min-max normalised per slice, read as 3 equal channels; the box scaled
  from the slice to 1024 (``box / [W, H, W, H] * 1024``); the encoder,
  the prompt encoder and the decoder per slice; ``sigmoid`` of the
  low-res logits, then a bilinear resize (``align_corners=False``) to
  the slice: probabilities, which MedSAM thresholds at 0.5.

Departures from the published code, all in the slice protocol:

* the resize to 1024^2 is torch's bicubic (``align_corners=False``, a =
  -0.75) where MedSAM's host code calls skimage's order-3 spline
  (``anti_aliasing``, which does nothing when upsampling), and the
  resized slice is not rounded to uint8 before the min-max;
* the window is taken in float32 from the int16 slice (MedSAM's CT
  pipeline writes windowed uint8 images first);
* a 3D box ``(x0, y0, x1, y1, z0, z1)`` is the 2D box ``(x0, y0, x1,
  y1)`` on each slice ``z0 <= z < z1``: x along the slice's columns
  (axis 1 of ``[H, W, D]``), y along its rows (axis 0).

:class:`Arith` selects the precision of every product of the networks:
``fp32`` (the reference; :func:`strict_fp32` turns TF32 off while it
runs) or ``fp8`` (operands rounded to float8 e4m3 with a per-tensor
scale, sums in fp32), the control of the benchmark's check.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

F8_MAX = 448.0          # largest float8 e4m3 value

# build_sam_vit_b's sizes, MedSAM's CT window and the serving batch.
VIT_B = dict(
    image_size=1024, patch_size=16, in_chans=3, encoder_embed_dim=768,
    encoder_depth=12, encoder_num_heads=12,
    encoder_global_attn_indexes=[2, 5, 8, 11], window_size=14,
    mlp_ratio=4.0, prompt_embed_dim=256, mask_in_chans=16, decoder_depth=2,
    decoder_num_heads=8, decoder_mlp_dim=2048, num_multimask_outputs=3,
    iou_head_depth=3, iou_head_hidden_dim=256, attention_downsample_rate=2,
    hu_window=[-160.0, 240.0])


class Arith:
    """The precision of every product: ``fp32`` or ``fp8`` (operands
    rounded to float8 e4m3 with a per-tensor scale; sums in fp32)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {mode}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.mode == "fp32":
            return t
        scale = (t.abs().amax() / F8_MAX).clamp_min(1e-30)
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def linear(self, x, lin: nn.Linear) -> torch.Tensor:
        return F.linear(self.q(x), self.q(lin.weight),
                        None if lin.bias is None else lin.bias.float())

    def einsum(self, eq: str, a, b) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))

    def conv(self, x, conv: nn.Conv2d) -> torch.Tensor:
        return F.conv2d(self.q(x), self.q(conv.weight),
                        None if conv.bias is None else conv.bias.float(),
                        stride=conv.stride, padding=conv.padding)

    def conv_t(self, x, conv: nn.ConvTranspose2d) -> torch.Tensor:
        return F.conv_transpose2d(self.q(x), self.q(conv.weight),
                                  conv.bias.float(), stride=conv.stride)


class strict_fp32:
    """float32 products in float32 on the card (no TF32) while inside:
    ``with strict_fp32(): ...``."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
        return False


# ------------------------------------------------------------ parameters
# The modules hold segment_anything's parameters under its names; the
# arithmetic is in the functions below them.
class LayerNorm2d(nn.Module):
    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, depth: int):
        super().__init__()
        sizes = [dim] + [hidden] * (depth - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(sizes[:-1], sizes[1:]))


class EncoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, side: int):
        super().__init__()
        self.num_heads = heads
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, hd))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, window: int,
                 grid: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = EncoderAttention(dim, heads, window or grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, mlp_dim)
        self.window_size = window


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, cin: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride=patch)


class ImageEncoderViT(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        dim, grid = c["encoder_embed_dim"], c["image_size"] // c["patch_size"]
        self.patch_embed = PatchEmbed(c["patch_size"], c["in_chans"], dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        glob = set(c["encoder_global_attn_indexes"])
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, c["encoder_num_heads"],
                         int(dim * c["mlp_ratio"]),
                         0 if i in glob else c["window_size"], grid)
            for i in range(c["encoder_depth"]))
        out = c["prompt_embed_dim"]
        self.neck = nn.Sequential(
            nn.Conv2d(dim, out, 1, bias=False), LayerNorm2d(out),
            nn.Conv2d(out, out, 3, padding=1, bias=False), LayerNorm2d(out))


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, feats))


class PromptEncoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        dim, mic = c["prompt_embed_dim"], c["mask_in_chans"]
        self.pe_layer = PositionEmbeddingRandom(dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, dim)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, dim)
        # Mask prompts (unused here; held for the state dict).
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mic // 4, 2, stride=2), LayerNorm2d(mic // 4),
            nn.GELU(), nn.Conv2d(mic // 4, mic, 2, stride=2),
            LayerNorm2d(mic), nn.GELU(), nn.Conv2d(mic, dim, 1))
        self.no_mask_embed = nn.Embedding(1, dim)


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        self.num_heads = heads
        inner = dim // downsample
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim, heads, mlp_dim, downsample, skip_first_pe):
        super().__init__()
        self.self_attn = DecoderAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = DecoderAttention(dim, heads,
                                                          downsample)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = DecoderAttention(dim, heads,
                                                          downsample)
        self.skip_first_layer_pe = skip_first_pe


class TwoWayTransformer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        dim, heads = c["prompt_embed_dim"], c["decoder_num_heads"]
        down = c["attention_downsample_rate"]
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, heads, c["decoder_mlp_dim"], down,
                                 i == 0)
            for i in range(c["decoder_depth"]))
        self.final_attn_token_to_image = DecoderAttention(dim, heads, down)
        self.norm_final_attn = nn.LayerNorm(dim)


class MaskDecoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        dim = c["prompt_embed_dim"]
        self.transformer = TwoWayTransformer(c)
        self.num_mask_tokens = c["num_multimask_outputs"] + 1
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, stride=2),
            LayerNorm2d(dim // 4), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(dim, dim, dim // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(dim, c["iou_head_hidden_dim"],
                                       self.num_mask_tokens,
                                       c["iou_head_depth"])


# ------------------------------------------------------------ arithmetic
def layer_norm(x, norm: nn.LayerNorm) -> torch.Tensor:
    u = x.mean(-1, keepdim=True)
    s = (x - u).pow(2).mean(-1, keepdim=True)
    return (x - u) / torch.sqrt(s + norm.eps) * norm.weight + norm.bias


def layer_norm2d(x, norm: LayerNorm2d) -> torch.Tensor:
    """segment_anything's LayerNorm2d: over the channels of ``[B, C, H,
    W]``."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + norm.eps)
    return norm.weight[:, None, None] * x + norm.bias[:, None, None]


def gelu(x) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def mlp(ar: Arith, m: MLP, x) -> torch.Tensor:
    for i, lin in enumerate(m.layers):
        x = ar.linear(x, lin)
        if i < len(m.layers) - 1:
            x = torch.relu(x)
    return x


def rel_table(table: torch.Tensor, size: int) -> torch.Tensor:
    """``[size, size, C]``: row ``q - k + size - 1`` of the table for query
    position ``q`` and key position ``k`` (``get_rel_pos`` at equal query
    and key sizes, where the table has ``2 size - 1`` rows)."""
    if table.shape[0] != 2 * size - 1:
        raise ValueError(f"a rel-pos table of {table.shape[0]} rows for "
                         f"{size} positions")
    q = torch.arange(size, device=table.device)[:, None]
    k = torch.arange(size, device=table.device)[None, :]
    return table[q - k + size - 1]


def encoder_attention(ar: Arith, m: EncoderAttention, x) -> torch.Tensor:
    b, h, w, c = x.shape
    heads = m.num_heads
    hd = c // heads
    qkv = ar.linear(x, m.qkv).reshape(b, h * w, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * heads, h * w,
                                                 hd).unbind(0)
    attn = ar.mm(q * hd ** -0.5, k.transpose(-2, -1))
    r_q = q.reshape(b * heads, h, w, hd)
    rel_h = ar.einsum("bhwc,hkc->bhwk", r_q, rel_table(m.rel_pos_h, h))
    rel_w = ar.einsum("bhwc,wkc->bhwk", r_q, rel_table(m.rel_pos_w, w))
    attn = (attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b * heads, h * w, h * w)
    attn = torch.softmax(attn, dim=-1)
    out = ar.mm(attn, v).view(b, heads, h, w, hd).permute(0, 2, 3, 1, 4)
    return ar.linear(out.reshape(b, h, w, c), m.proj)


def window_partition(x, ws: int):
    """``[B, H, W, C]`` zero-padded to multiples of ``ws`` and cut into
    ``[B * nH * nW, ws, ws, C]`` windows (row-major over the grid)."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp * wp // ws // ws)
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def encoder_block(ar: Arith, m: EncoderBlock, x) -> torch.Tensor:
    shortcut = x
    x = layer_norm(x, m.norm1)
    if m.window_size > 0:
        hw = x.shape[1:3]
        x, pad_hw = window_partition(x, m.window_size)
    x = encoder_attention(ar, m.attn, x)
    if m.window_size > 0:
        x = window_unpartition(x, m.window_size, pad_hw, hw)
    x = shortcut + x
    y = gelu(ar.linear(layer_norm(x, m.norm2), m.mlp.lin1))
    return x + ar.linear(y, m.mlp.lin2)


def image_encoder(ar: Arith, m: ImageEncoderViT, images) -> torch.Tensor:
    """``[B, 3, S, S]`` in [0, 1] -> the image embedding ``[B, 256, S/16,
    S/16]``."""
    x = ar.conv(images.float(), m.patch_embed.proj).permute(0, 2, 3, 1)
    x = x + m.pos_embed
    for blk in m.blocks:
        x = encoder_block(ar, blk, x)
    x = x.permute(0, 3, 1, 2)
    x = layer_norm2d(ar.conv(x, m.neck[0]), m.neck[1])
    return layer_norm2d(ar.conv(x, m.neck[2]), m.neck[3])


def fourier(pe: PositionEmbeddingRandom, coords) -> torch.Tensor:
    """Random Fourier features of coordinates in [0, 1] (float32)."""
    c = (2.0 * coords.float() - 1.0) @ pe.positional_encoding_gaussian_matrix
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(m: PromptEncoder, grid: int) -> torch.Tensor:
    """The image's position encoding ``[1, 256, grid, grid]``: Fourier
    features of the pixel centres, x (columns) first."""
    dev = m.pe_layer.positional_encoding_gaussian_matrix.device
    centres = (torch.arange(grid, device=dev, dtype=torch.float32)
               + 0.5) / grid
    y, x = torch.meshgrid(centres, centres, indexing="ij")
    pe = fourier(m.pe_layer, torch.stack([x, y], dim=-1))
    return pe.permute(2, 0, 1)[None]


def prompt_encoder(m: PromptEncoder, boxes, image_size: int, grid: int):
    """Boxes ``[B, 4]`` (x0, y0, x1, y1) in the image's pixels -> the
    sparse embeddings ``[B, 2, 256]`` and the dense ``[B, 256, grid,
    grid]``."""
    coords = (boxes.float() + 0.5).reshape(-1, 2, 2) / image_size
    corners = fourier(m.pe_layer, coords)
    corners = torch.stack([corners[:, 0] + m.point_embeddings[2].weight[0],
                           corners[:, 1] + m.point_embeddings[3].weight[0]],
                          dim=1)
    dense = m.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
        boxes.shape[0], -1, grid, grid)
    return corners, dense


def decoder_attention(ar: Arith, m: DecoderAttention, q, k, v):
    heads = m.num_heads
    q, k, v = (ar.linear(q, m.q_proj), ar.linear(k, m.k_proj),
               ar.linear(v, m.v_proj))

    def split(t):
        b, n, c = t.shape
        return t.reshape(b, n, heads, c // heads).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    attn = ar.mm(q, k.permute(0, 1, 3, 2)) / math.sqrt(q.shape[-1])
    out = ar.mm(torch.softmax(attn, dim=-1), v)
    b, _, n, _ = out.shape
    return ar.linear(out.transpose(1, 2).reshape(b, n, -1), m.out_proj)


def two_way_block(ar: Arith, m: TwoWayAttentionBlock, queries, keys,
                  query_pe, key_pe):
    if m.skip_first_layer_pe:
        queries = decoder_attention(ar, m.self_attn, queries, queries,
                                    queries)
    else:
        q = queries + query_pe
        queries = queries + decoder_attention(ar, m.self_attn, q, q,
                                              queries)
    queries = layer_norm(queries, m.norm1)
    q, k = queries + query_pe, keys + key_pe
    queries = queries + decoder_attention(ar, m.cross_attn_token_to_image,
                                          q, k, keys)
    queries = layer_norm(queries, m.norm2)
    y = ar.linear(torch.relu(ar.linear(queries, m.mlp.lin1)), m.mlp.lin2)
    queries = layer_norm(queries + y, m.norm3)
    q, k = queries + query_pe, keys + key_pe
    keys = keys + decoder_attention(ar, m.cross_attn_image_to_token, k, q,
                                    queries)
    return queries, layer_norm(keys, m.norm4)


def mask_decoder(ar: Arith, m: MaskDecoder, image_embeddings, image_pe,
                 sparse, dense):
    """Low-res mask logits ``[B, 1, 4g, 4g]`` of mask 0 and its IoU
    prediction ``[B, 1]`` (``multimask_output=False``)."""
    tokens = torch.cat([m.iou_token.weight, m.mask_tokens.weight], dim=0)
    tokens = torch.cat([tokens[None].expand(sparse.shape[0], -1, -1),
                        sparse], dim=1)
    src = image_embeddings
    if src.shape[0] != tokens.shape[0]:
        src = torch.repeat_interleave(src, tokens.shape[0], dim=0)
    src = src + dense
    pos = torch.repeat_interleave(image_pe, tokens.shape[0], dim=0)
    b, c, h, w = src.shape
    t = m.transformer
    keys = src.flatten(2).permute(0, 2, 1)
    key_pe = pos.flatten(2).permute(0, 2, 1)
    queries = tokens
    for layer in t.layers:
        queries, keys = two_way_block(ar, layer, queries, keys, tokens,
                                      key_pe)
    q, k = queries + tokens, keys + key_pe
    queries = queries + decoder_attention(ar, t.final_attn_token_to_image,
                                          q, k, keys)
    hs = layer_norm(queries, t.norm_final_attn)
    src = keys.transpose(1, 2).reshape(b, c, h, w)
    up = m.output_upscaling
    x = gelu(layer_norm2d(ar.conv_t(src, up[0]), up[1]))
    x = gelu(ar.conv_t(x, up[3]))
    hyper = torch.stack([mlp(ar, m.output_hypernetworks_mlps[i],
                             hs[:, 1 + i]) for i in range(m.num_mask_tokens)],
                        dim=1)
    b, c, h, w = x.shape
    masks = ar.mm(hyper, x.reshape(b, c, h * w)).view(b, -1, h, w)
    iou = mlp(ar, m.iou_prediction_head, hs[:, 0])
    return masks[:, 0:1], iou[:, 0:1]


class MedSAM(nn.Module):
    """SAM ViT-B's three modules under segment_anything's names; ``conf``
    holds :data:`VIT_B`'s keys (the model's sizes)."""

    def __init__(self, conf: dict | None = None, arith: Arith | None = None):
        super().__init__()
        self.conf = dict(VIT_B, **(conf or {}))
        self.arith = arith or Arith()
        self.image_encoder = ImageEncoderViT(self.conf)
        self.prompt_encoder = PromptEncoder(self.conf)
        self.mask_decoder = MaskDecoder(self.conf)

    @property
    def grid(self) -> int:
        return self.conf["image_size"] // self.conf["patch_size"]

    def encode(self, images) -> torch.Tensor:
        with strict_fp32():
            return image_encoder(self.arith, self.image_encoder, images)

    def prompt(self, boxes):
        return prompt_encoder(self.prompt_encoder, boxes,
                              self.conf["image_size"], self.grid)

    def dense_pe(self) -> torch.Tensor:
        return dense_pe(self.prompt_encoder, self.grid)

    def decode(self, embeddings, boxes) -> torch.Tensor:
        """Low-res mask logits ``[B, 1, 4g, 4g]`` of one box per image."""
        sparse, dense = self.prompt(boxes)
        with strict_fp32():
            return mask_decoder(self.arith, self.mask_decoder, embeddings,
                                self.dense_pe(), sparse, dense)[0]

    def forward(self, images, boxes) -> torch.Tensor:
        return self.decode(self.encode(images), boxes)


def window_slices(volume, hu_window) -> torch.Tensor:
    """int16 ``[H, W, n]`` -> float32 in [0, 1]: clipped to the HU window
    and scaled."""
    lo, hi = float(hu_window[0]), float(hu_window[1])
    return ((volume.float() - lo) / (hi - lo)).clamp(0.0, 1.0)


def slice_images(windowed, size: int) -> torch.Tensor:
    """``[H, W, n]`` in [0, 1] -> ``[n, 1, size, size]``: bicubic resize,
    then min-max per slice."""
    x = windowed.permute(2, 0, 1)[:, None]
    x = F.interpolate(x, size=(size, size), mode="bicubic",
                      align_corners=False)
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo).clamp_min(1e-8)


def box_to_image(box, hw: tuple, size: int) -> list:
    """The 2D box ``(x0, y0, x1, y1)`` of an ``[H, W]`` slice in the
    ``size``-pixel image: ``box / [W, H, W, H] * size`` (float64)."""
    h, w = hw
    return [float(box[0]) / w * size, float(box[1]) / h * size,
            float(box[2]) / w * size, float(box[3]) / h * size]


def study_probs(model: MedSAM, volume, box, device,
                chunk: int = 4) -> torch.Tensor:
    """MedSAM's probabilities over a study's box: ``volume`` int16 ``[H,
    W, D]`` (or ``[H, W, D, 1]``), ``box`` ``(x0, y0, x1, y1, z0, z1)`` in
    voxels -> float32 ``[H, W, z1 - z0]`` on ``device``, computed
    ``chunk`` slices at a time."""
    vol = torch.as_tensor(np.asarray(volume))
    if vol.dim() == 4:
        vol = vol[..., 0]
    x0, y0, x1, y1, z0, z1 = (int(v) for v in box)
    h, w = vol.shape[:2]
    size = model.conf["image_size"]
    b = torch.tensor(box_to_image((x0, y0, x1, y1), (h, w), size),
                     dtype=torch.float32, device=device)
    out = []
    with torch.no_grad(), strict_fp32():
        for s in range(z0, z1, chunk):
            e = min(s + chunk, z1)
            img = slice_images(window_slices(vol[:, :, s:e].to(device),
                                             model.conf["hu_window"]), size)
            logits = model(img.expand(-1, 3, -1, -1), b[None].expand(e - s,
                                                                     -1))
            p = F.interpolate(torch.sigmoid(logits), size=(h, w),
                              mode="bilinear", align_corners=False)
            out.append(p[:, 0])
    return torch.cat(out).permute(1, 2, 0)
