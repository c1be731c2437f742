"""SwinUnetR, downstream path: serving and prompt-tuning training.

Counterpart of the JAX package's ``models/swin_unetr.py`` for
``training_mode="downstream"`` with the flagship decoder
(``unetr_res_block="none"``, ``unetr_up_block="swin"``):

* patch embed: Conv3d with stride = patch, then BatchNorm (eps 1e-6);
* ``depth_unet`` encoder stages of Swin block pairs + PatchMerging
  (depth merged at stage 0 only), heads doubling per stage;
* bottleneck 3x3x3 conv + residual;
* ``depth_unet`` SwinUpBlocks (pair-input conv, then a Swin pair);
* x2 trilinear upsample (``align_corners=False``);
* seg head: BatchNorm (eps 1e-5) then a 3x3x3 conv.

Prompt tokens are ``[tokens, C]`` parameters, two per stage (window and
shifted block) for encoder and decoder.  Attribute names follow the
reference's torch keys, so ``load_state_dict`` takes a reference-schema
state dict (``utils/weights.py``).  ``eval()`` (serving): BatchNorms use
their running statistics, dropout is off, the decoder convs run the pair
kernel.  ``train()`` (the default of a new module, as in torch): batch
statistics with the running-statistic update, counter-based dropout at
the config's ``attn_drop``/``proj_drop`` with seeds drawn from
:attr:`dropout_generator`, and the JAX package's training decoder path.
``use_checkpoint`` is read and needs no extra work (``swin_block.py``).
Layout: channels-last ``[B, H, W, D, C]``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops.resize import upsample_trilinear
from .swin_block import ConsecutiveSwinBlocks
from .unet_blocks import SwinUpBlock, batch_norm, conv3d, same_conv


class SwinUnetR(nn.Module):
    def __init__(self, conf: ModelConfig, dropout_seed: int = 0):
        super().__init__()
        if conf.training_mode != "downstream" or \
                conf.unetr_res_block != "none" or \
                conf.unetr_up_block != "swin":
            raise NotImplementedError(
                "the PyTorch port serves training_mode='downstream' with "
                "unetr_res_block='none' and unetr_up_block='swin'; got "
                f"{conf.training_mode}/{conf.unetr_res_block}/"
                f"{conf.unetr_up_block}")
        self.conf = conf
        depth = conf.depth_unet
        hc = conf.hidden_channels
        dt = conf.dtype
        ws = tuple(conf.attn_window_size)
        patch = tuple(conf.input_patch_size)

        self.input_layer = nn.Sequential(
            nn.Conv3d(conf.input_channels, hc[0], patch, stride=patch),
            nn.BatchNorm3d(hc[0], eps=1e-6, momentum=0.1))
        self.encoder_blocks = nn.ModuleList([
            ConsecutiveSwinBlocks(
                hc[i], conf.num_heads_encoder * 2 ** i,
                conf.pos_bias_embed_dim, conf.max_prompts,
                conf.tokens_per_prompt_encoder, ws, down=True,
                merge_last_dim=i < 1, pad_mode=conf.pad_mode, dtype=dt,
                attn_drop=conf.attn_drop, proj_drop=conf.proj_drop)
            for i in range(depth)])

        self.prompt_tokens = nn.Module()
        if conf.use_encoder_prompting:
            self.prompt_tokens.enc = nn.ParameterList([
                nn.Parameter(torch.empty(conf.tokens_per_prompt_encoder,
                                         hc[i // 2]))
                for i in range(2 * depth)])
        if conf.use_decoder_prompting:
            self.prompt_tokens.dec = nn.ParameterList([
                nn.Parameter(torch.empty(conf.tokens_per_prompt_decoder,
                                         hc[-(i + 1) // 2 - 1]))
                for i in range(2 * depth)])

        in_chs = [hc[i] for i in range(depth)][::-1]
        out_chs = [hc[i + 1] for i in range(depth)][::-1]
        self.bottleneck = same_conv(out_chs[0], out_chs[0])
        self.decoder_blocks = nn.ModuleList([
            SwinUpBlock(out_chs[i], in_chs[i],
                        (2, 2, 1 if i < depth - 1 else 2), (3, 3, 3),
                        conf.pos_bias_embed_dim, conf.num_heads_decoder, ws,
                        conf.max_prompts, conf.tokens_per_prompt_decoder,
                        pad_mode=conf.pad_mode, dtype=dt,
                        attn_drop=conf.attn_drop, proj_drop=conf.proj_drop)
            for i in range(depth)])
        self.extra_heads = nn.ModuleDict({"downstream": nn.Sequential(
            nn.BatchNorm3d(hc[0], eps=1e-5, momentum=0.1),
            same_conv(hc[0], conf.output_channels_downstream))})
        self.use_checkpoint = conf.use_checkpoint
        # Dropout seeds of every block call come from this generator.
        self.dropout_generator = torch.Generator().manual_seed(dropout_seed)
        for m in self.modules():
            if hasattr(m, "set_dropout_generator"):
                m.set_dropout_generator(self.dropout_generator)

    def set_kernels(self, enabled: bool) -> "SwinUnetR":
        """Route the blocks and the decoder convs through the CUDA kernel
        wrappers (``True``) or straight to their plain versions."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = enabled
        return self

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict`` that also takes numpy arrays
        (``export_state_dict`` of the JAX package returns those)."""
        state_dict = {k: torch.from_numpy(np.array(v))
                      if isinstance(v, np.ndarray) else v
                      for k, v in state_dict.items()}
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def _tokens(self, name: str, idx: int):
        tokens = getattr(self.prompt_tokens, name, None)
        return None if tokens is None else tokens[idx]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, H, W, D, C_in]`` -> downstream logits
        ``[B, H, W, D, classes]`` (fp32)."""
        conf = self.conf
        enc = batch_norm(conv3d(x.to(conf.dtype), self.input_layer[0]),
                         self.input_layer[1]).to(conf.dtype)
        feats = [enc]
        for j, stage in enumerate(self.encoder_blocks):
            enc = stage(enc, (self._tokens("enc", 2 * j),
                              self._tokens("enc", 2 * j + 1)))
            feats.insert(0, enc)
        dec = conv3d(feats[0], self.bottleneck) + feats[0]
        for j, up in enumerate(self.decoder_blocks):
            dec = up(dec, feats[j + 1], (self._tokens("dec", 2 * j),
                                         self._tokens("dec", 2 * j + 1)))
        out = upsample_trilinear(dec, (2, 2, 2), align_corners=False).float()
        head = self.extra_heads["downstream"]
        out = batch_norm(out, head[0]).to(conf.dtype)
        return conv3d(out, head[1]).float()
