"""MedSAM: SAM ViT-B prompted with a box (Ma et al., Nature Communications
2024; Kirillov et al. 2023), as MedSAM serves it slice by slice.

Three modules under segment_anything's parameter names (``image_encoder``,
``prompt_encoder``, ``mask_decoder``), so MedSAM's ``medsam_vit_b.pth``
state dict loads strictly into :class:`Sam`.  Plain torch operations
but the image encoder's attention core, ``ops/sam_attention.py`` (a
hand-written kernel on the card, its decomposed relative position bias
inside); the mask decoder's attention is
``F.scaled_dot_product_attention``.  The encoder and the mask decoder
run in ``SamConfig.compute_dtype`` (their parameters are held in it); the
prompt encoder's Fourier features stay in float32.
``reference/medsam.py`` is the plain float32 reference.

The published quirks, kept:

* the windowed blocks pad the 64x64 grid with zeros (after ``norm1``) to
  70x70 and attend over the 196 tokens of each 14x14 window, padded
  tokens included and unmasked;
* the relative position bias takes the *unscaled* q: ``attn[q, (kh,
  kw)] = q.k / sqrt(hd) + <q, Rh[qh - kh + S - 1]> + <q, Rw[qw - kw + S -
  1]>``, one table per axis shared by the heads (S = 64 in the global
  blocks, 14 in the windowed); the attention core computes it inside the
  attention's scores, never as a ``[N, N]`` bias;
* LayerNorm eps 1e-6 in the encoder (its blocks and the neck's
  LayerNorm2d) and in the decoder's LayerNorm2d, 1e-5 in the two-way
  transformer;
* exact-erf GELU in the encoder's MLPs and the decoder's upscaling, ReLU
  in the two-way transformer and the hypernetwork and IoU MLPs;
* no position encoding and no residual on layer 0's token
  self-attention;
* a box gets ``+ 0.5`` (pixel centres) before it is normalised;
* the serving path takes ``sigmoid`` of the low-res logits before the
  bilinear resize to the slice (``parallel/sam_slices.py``).

The one departure from the published arithmetic: the encoder takes a
one-channel image as its three equal channels, the patch embed's weight
summed over its input channels (the tests hold it to the reference's
three-channel input).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SamConfig
from ..ops import sam_attention


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of ``[B, C, H, W]``."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight,
                         self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, act):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class MLP(nn.Module):
    """Linears with ReLU between them."""

    def __init__(self, dim: int, hidden: int, out: int, depth: int):
        super().__init__()
        sizes = [dim] + [hidden] * (depth - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


# ---------------------------------------------------------- image encoder
def window_partition(x: torch.Tensor, ws: int):
    """``[B, H, W, C]`` zero-padded to multiples of ``ws`` and cut into
    ``[B * nH * nW, ws, ws, C]`` windows; returns them and the padded
    size."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp * wp // ws // ws)
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, hp, wp, -1)
    return x[:, :h, :w] if (hp, wp) != (h, w) else x


class Attention(nn.Module):
    """Multi-head attention over a ``[B, H, W, C]`` grid with the
    decomposed relative position bias (segment_anything's image-encoder
    ``Attention``): ``qkv``, the attention core
    (``ops/sam_attention.py``: the bias inside one kernel on the card,
    never a ``[N, N]`` array), ``proj``."""

    def __init__(self, dim: int, num_heads: int, side: int):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, head_dim))
        self._index: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def rel_table(self, table: torch.Tensor, size: int) -> torch.Tensor:
        """``[size, size, hd]``: the table's row ``q - k + c`` for query
        ``q`` and key ``k``, ``c`` its centre row (``size - 1`` for the
        table of ``2 size - 1`` rows that every block has)."""
        key = (size, table.shape[0], table.device)
        idx = self._index.get(key)
        if idx is None:
            pos = torch.arange(size, device=table.device)
            idx = pos[:, None] - pos[None, :] + (table.shape[0] - 1) // 2
            self._index[key] = idx
        return table[idx]

    def rel_terms(self, q: torch.Tensor, h: int, w: int):
        """``q . Rh`` ``[B, heads, h w, h]`` and ``q . Rw`` ``[B, heads,
        h w, w]`` of the unscaled ``q`` ``[B, heads, h w, hd]``."""
        return sam_attention.rel_terms(q, self.rel_table(self.rel_pos_h, h),
                                       self.rel_table(self.rel_pos_w, w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        o = sam_attention.sam_attention(
            self.qkv(x), self.rel_table(self.rel_pos_h, h),
            self.rel_table(self.rel_pos_w, w), self.num_heads)
        return self.proj(o)


class Block(nn.Module):
    """Pre-norm ViT block; ``window_size`` 0 attends over the whole grid."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 window_size: int, grid: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, window_size or grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, mlp_dim, nn.GELU())
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, C, S, S]`` -> ``[B, S/p, S/p, dim]``; a one-channel image
        is taken as ``in_chans`` equal channels."""
        weight = self.proj.weight
        if x.shape[1] == 1 and weight.shape[1] > 1:
            weight = weight.float().sum(1, keepdim=True).to(weight.dtype)
        # Channels-last and contiguous: every op of the residual stream
        # after it then runs on a contiguous tensor.
        return F.conv2d(x, weight, self.proj.bias,
                        stride=self.proj.stride).permute(0, 2, 3,
                                                         1).contiguous()


class ImageEncoderViT(nn.Module):
    def __init__(self, conf: SamConfig):
        super().__init__()
        dim, grid = conf.encoder_embed_dim, conf.embedding_size
        self.patch_embed = PatchEmbed(conf.patch_size, conf.in_chans, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        glob = set(conf.encoder_global_attn_indexes)
        self.blocks = nn.ModuleList(
            Block(dim, conf.encoder_num_heads, int(dim * conf.mlp_ratio),
                  0 if i in glob else conf.window_size, grid)
            for i in range(conf.encoder_depth))
        out = conf.prompt_embed_dim
        self.neck = nn.Sequential(
            nn.Conv2d(dim, out, 1, bias=False), LayerNorm2d(out),
            nn.Conv2d(out, out, 3, padding=1, bias=False), LayerNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, 1 or 3, S, S]`` -> the image embedding ``[B, 256, S/16,
        S/16]``."""
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------- prompt encoder
class PositionEmbeddingRandom(nn.Module):
    """Random Fourier features ``[sin, cos](2 pi (2c - 1) G)`` of
    coordinates ``c`` in [0, 1]."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        c = (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def forward(self, size: int) -> torch.Tensor:
        """``[dim, size, size]`` at the pixel centres of a square grid."""
        dev = self.positional_encoding_gaussian_matrix.device
        centres = (torch.arange(size, device=dev, dtype=torch.float32)
                   + 0.5) / size
        y, x = torch.meshgrid(centres, centres, indexing="ij")
        return self.encode(torch.stack([x, y], dim=-1)).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    """Box prompts (MedSAM's use).  The point and mask-prompt parameters
    are held for the state dict; no forward here reads them."""

    def __init__(self, conf: SamConfig):
        super().__init__()
        dim, mic = conf.prompt_embed_dim, conf.mask_in_chans
        self.image_size = conf.image_size
        self.grid = conf.embedding_size
        self.pe_layer = PositionEmbeddingRandom(dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, dim)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mic // 4, 2, stride=2), LayerNorm2d(mic // 4),
            nn.GELU(), nn.Conv2d(mic // 4, mic, 2, stride=2),
            LayerNorm2d(mic), nn.GELU(), nn.Conv2d(mic, dim, 1))
        self.no_mask_embed = nn.Embedding(1, dim)

    def get_dense_pe(self) -> torch.Tensor:
        """The image embedding's position encoding ``[1, dim, g, g]``."""
        return self.pe_layer(self.grid)[None]

    def forward(self, boxes: torch.Tensor):
        """Boxes ``[B, 4]`` (x0, y0, x1, y1 in the image's pixels) -> the
        sparse embeddings ``[B, 2, dim]`` and the dense ``[B, dim, g, g]``
        (float32)."""
        coords = (boxes.float() + 0.5).reshape(-1, 2, 2) / self.image_size
        corners = self.pe_layer.encode(coords)
        corners = corners + torch.cat([self.point_embeddings[2].weight,
                                       self.point_embeddings[3].weight])
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            boxes.shape[0], -1, self.grid, self.grid)
        return corners, dense


# ------------------------------------------------------------ mask decoder
class DecoderAttention(nn.Module):
    """segment_anything's two-way ``Attention``: q, k and v projected to
    ``dim / downsample_rate``, heads, softmax attention, out."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        self.num_heads = num_heads
        inner = dim // downsample_rate
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.view(b, n, self.num_heads, c // self.num_heads).transpose(
            1, 2)

    def forward(self, q, k, v) -> torch.Tensor:
        o = F.scaled_dot_product_attention(self._heads(self.q_proj(q)),
                                           self._heads(self.k_proj(k)),
                                           self._heads(self.v_proj(v)))
        b, _, n, _ = o.shape
        return self.out_proj(o.transpose(1, 2).reshape(b, n, -1))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 downsample_rate: int, skip_first_layer_pe: bool):
        super().__init__()
        self.self_attn = DecoderAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = DecoderAttention(
            dim, num_heads, downsample_rate)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, nn.ReLU())
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = DecoderAttention(
            dim, num_heads, downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, conf: SamConfig):
        super().__init__()
        dim, heads = conf.prompt_embed_dim, conf.decoder_num_heads
        down = conf.attention_downsample_rate
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, heads, conf.decoder_mlp_dim, down,
                                 i == 0)
            for i in range(conf.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(dim, heads, down)
        self.norm_final_attn = nn.LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """``[B, C, h, w]`` image, its ``[B, C, h, w]`` encoding and the
        ``[B, T, C]`` tokens -> the tokens and the image ``[B, h w, C]``."""
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, conf: SamConfig):
        super().__init__()
        dim = conf.prompt_embed_dim
        self.transformer = TwoWayTransformer(conf)
        self.num_mask_tokens = conf.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, stride=2),
            LayerNorm2d(dim // 4), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(dim, dim, dim // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(dim, conf.iou_head_hidden_dim,
                                       self.num_mask_tokens,
                                       conf.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse, dense):
        """One prompt per image (or per prompt of one image): low-res
        logits ``[B, 1, 4g, 4g]`` of mask 0 and its IoU ``[B, 1]``
        (``multimask_output=False``), in the decoder's dtype."""
        dt = self.iou_token.weight.dtype
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([tokens[None].expand(sparse.shape[0], -1, -1),
                            sparse.to(dt)], dim=1)
        src = image_embeddings.to(dt)
        if src.shape[0] != tokens.shape[0]:
            src = torch.repeat_interleave(src, tokens.shape[0], dim=0)
        src = src + dense.to(dt)
        pos = image_pe.to(dt).expand(tokens.shape[0], -1, -1, -1)
        b, c, h, w = src.shape
        hs, keys = self.transformer(src, pos, tokens)
        up = self.output_upscaling(keys.transpose(1, 2).reshape(b, c, h, w))
        hyper = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = up.shape
        masks = (hyper @ up.reshape(b, c, h * w)).view(b, -1, h, w)
        iou = self.iou_prediction_head(hs[:, 0])
        return masks[:, 0:1], iou[:, 0:1]


class Sam(nn.Module):
    """MedSAM's model: the encoder and the mask decoder in
    ``conf.compute_dtype``, the prompt encoder in float32."""

    def __init__(self, conf: SamConfig):
        super().__init__()
        self.conf = conf
        self.image_encoder = ImageEncoderViT(conf).to(conf.dtype)
        self.prompt_encoder = PromptEncoder(conf)
        self.mask_decoder = MaskDecoder(conf).to(conf.dtype)

    def forward(self, images: torch.Tensor, boxes: torch.Tensor):
        """Images ``[B, 1 or 3, S, S]`` in [0, 1], one box each ``[B, 4]``
        in the image's pixels -> low-res mask logits ``[B, 1, 4g, 4g]``."""
        emb = self.image_encoder(images.to(self.conf.dtype))
        sparse, dense = self.prompt_encoder(boxes)
        return self.mask_decoder(emb, self.prompt_encoder.get_dense_pe(),
                                 sparse, dense)[0]
