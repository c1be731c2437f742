"""SwinUnetR: serving, prompt tuning and pretraining (phases 1 and 2).

Counterpart of the JAX package's ``models/swin_unetr.py`` in all six
training modes, in every decoder layout (``unetr_res_block`` none |
simple | full x ``unetr_up_block`` swin | unetr):

* patch embed: Conv3d with stride = patch, then BatchNorm (eps 1e-6);
* ``depth_unet`` encoder stages of Swin block pairs + PatchMerging
  (depth merged at stage 0 only), heads doubling per stage;
* bottleneck: a ``UnetrBasicBlock`` under ``full``, else a 3x3x3 conv;
  plus the residual;
* ``depth_unet + 1`` skip blocks (identity under ``none``, a 3x3x3 conv
  under ``simple``, a ``UnetrBasicBlock`` under ``full``); the last one
  takes the raw input;
* ``depth_unet`` up blocks: ``SwinUpBlock`` (pair-input conv, then a Swin
  pair) or ``UnetrUpBlock`` (transposed conv, conv block);
* output layer: a x2 trilinear upsample (``align_corners=False``) under
  ``none``, else one more up block at full resolution onto the last skip
  (a ``SwinUpBlock`` with its own two prompt tokens, or a
  ``UnetrUpBlock``); in eval mode the x2 upsample is the kernel of
  ``ops/upsample.py``, and in the downstream mode the seg head is its
  epilogue (``set_kernels(False)``: the plain chain);
* seg head: BatchNorm (eps 1e-5) then a 3x3x3 conv: ``head_downstream``
  (``extra_heads.downstream``) in the downstream mode,
  ``head_segmentation`` (``extra_heads.segmentation``, to
  ``output_channels_pretrain``) in the supervised phase-2 modes, none in
  the self-supervised ones.

``forward`` returns the downstream logits tensor in the downstream mode,
and in the phase-2 modes the dict ``{"latent_outputs": fp32 decoder
output [B, H, W, D, C0]}`` plus ``"seg_pred"`` (the head's fp32 logits)
in the supervised ones.

The phase-1 mode (``self_supervised_learning_encoder``) builds no
decoder (no bottleneck, skips, up blocks or decoder prompts) and, each
under its flag, the proxy heads in ``extra_heads``:

* ``reconstruction`` (``use_reconstruction`` or ``use_mutual_learning``):
  ``depth_unet + 1`` stages of a 3x3x3 conv halving the channels (the
  last keeps them), an instance norm without affine (eps 1e-5),
  LeakyReLU(0.01) and a trilinear upsample (``align_corners=True``) by
  (2, 2, 1) for the first ``depth_unet - 1`` stages and (2, 2, 2) after,
  then a 1x1x1 ``conv_out`` to the input channels; in fp32, as flax
  computes it (no dtype: the promotion of the input and fp32 kernels).
  Its modules sit at the reference's ``Sequential`` indices (conv ``i``
  at ``4 * i``, ``conv_out`` at ``4 * (depth_unet + 1)``);
* ``rotation_prediction`` (``use_rotation_prediction``): a linear layer
  to the 4 rotation classes; ``contrastive_coding``
  (``use_contrastive_learning``): a linear layer to
  ``contrastive_coding_dim``; both on the fp32 spatial mean of the
  encoder's last output.

Its ``forward`` returns ``{"reconstruction": fp32 [B, H', W', D',
C_in], "rotation_prediction", "contrastive_coding", "out_vit": the
encoder outputs deepest first, the input last}`` (the heads that are
built); :meth:`SwinUnetR.reconstruction_shape` gives ``H', W', D'`` for
an input shape without running anything.

Prompt tokens are ``[tokens, C]`` parameters, two per stage (window and
shifted block) for encoder and decoder, and two (``prompt_tokens.out``)
for a Swin output layer.  Under ``unetr_up_block: unetr`` the decoder
tokens exist but no block reads them, as in the JAX model, so checkpoints
keep the same leaves.  The 3x3x3 convs of the trunk (bottleneck, simple
skips) run in the trunk's dtype; the UNETR blocks in fp32, as flax
computes them (``unet_blocks.py``).  Attribute names follow the
reference's torch keys, so ``load_state_dict`` takes a reference-schema
state dict (``utils/weights.py``).  ``eval()`` (serving): BatchNorms use
their running statistics, dropout is off, the decoder convs run the pair
kernel.  ``train()`` (the default of a new module, as in torch): batch
statistics with the running-statistic update, counter-based dropout at
the config's ``attn_drop``/``proj_drop`` with seeds drawn from
:attr:`dropout_generator`, and the JAX package's training decoder path.
``use_checkpoint`` needs no extra work in the fused blocks; the unfused
blocks' body runs under ``torch.utils.checkpoint`` (``swin_block.py``).
Layout: channels-last ``[B, H, W, D, C]``.

The Swin blocks run the fused block (B1) unless ``MIVP_NO_FUSED_BLOCK``
is set to anything but ``0`` when the model is built (read once, as the
JAX package reads it) or :meth:`set_fused_block` says otherwise: then the
unfused block with its attention kernels B6/B8, which serves and trains
(with attention dropout on, the attention of the JAX XLA branch).
Nothing falls back from one to the other: a kernel that fails to build
or launch raises.

``MIVP_PAIR_KERNEL=1`` at build (``MIVP_NO_PAIR_KERNEL=1`` wins over it, as
in the JAX package) or :meth:`set_pair_kernel` runs each Swin block pair
whose geometry allows it as one pair call (B5, ``ops/fused_pair.py``), in
serving and in training; the unfused block wins over both.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import PHASE1_MODE, SUPERVISED_MODES, ModelConfig
from ..ops.resize import upsample_trilinear
from ..ops.upsample import Head, head_conv, kernel_operands, upsample
from .swin_block import ConsecutiveSwinBlocks
from .unet_blocks import (SwinUpBlock, UnetrBasicBlock, UnetrUpBlock,
                          batch_norm, bn_fold, conv3d, instance_norm,
                          same_conv)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "0") not in ("0", "")


def _rec_scales(depth: int):
    """The reconstruction head's upsample scale per stage."""
    return [(2, 2, 1 if i < depth - 1 else 2) for i in range(depth + 1)]


class SwinUnetR(nn.Module):
    def __init__(self, conf: ModelConfig, dropout_seed: int = 0):
        super().__init__()
        self.conf = conf
        phase1 = conf.training_mode == PHASE1_MODE
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
        if conf.use_decoder_prompting and not phase1:
            self.prompt_tokens.dec = nn.ParameterList([
                nn.Parameter(torch.empty(conf.tokens_per_prompt_decoder,
                                         hc[-(i + 1) // 2 - 1]))
                for i in range(2 * depth)])
        if phase1:
            self.head_name = None
            self.extra_heads = nn.ModuleDict(self._ssl_heads(conf))
        else:
            self._build_decoder(conf)
        self.use_checkpoint = conf.use_checkpoint
        self.use_kernels = True       # False: the plain versions (set_kernels)
        self._head_cache = None       # _head_operands
        self.data_group = None        # set_data_group
        # Dropout seeds of every block call come from this generator.
        self.dropout_generator = torch.Generator().manual_seed(dropout_seed)
        for m in self.modules():
            if hasattr(m, "set_dropout_generator"):
                m.set_dropout_generator(self.dropout_generator)
                m.use_checkpoint = conf.use_checkpoint
        self.set_fused_block(not _env_flag("MIVP_NO_FUSED_BLOCK"))
        self.set_pair_kernel(_env_flag("MIVP_PAIR_KERNEL")
                             and not _env_flag("MIVP_NO_PAIR_KERNEL"))

    @staticmethod
    def _ssl_heads(conf: ModelConfig) -> dict:
        """The phase-1 proxy heads that ``conf`` turns on."""
        depth, top = conf.depth_unet, conf.hidden_channels[-1]
        heads = {}
        if conf.use_reconstruction or conf.use_mutual_learning:
            chs = [top // 2 ** i for i in range(depth + 1)] \
                + [top // 2 ** depth]
            # The reference's Sequential, for its state-dict indices;
            # _ssl_outputs applies it channels-last.
            layers = []
            for i, scale in enumerate(_rec_scales(depth)):
                layers += [same_conv(chs[i], chs[i + 1]),
                           nn.InstanceNorm3d(chs[i + 1], eps=1e-5),
                           nn.LeakyReLU(0.01),
                           nn.Upsample(scale_factor=scale, mode="trilinear",
                                       align_corners=True)]
            layers.append(nn.Conv3d(chs[-1], conf.input_channels, 1))
            heads["reconstruction"] = nn.Sequential(*layers)
        if conf.use_rotation_prediction:
            heads["rotation_prediction"] = nn.Linear(top, 4)
        if conf.use_contrastive_learning:
            heads["contrastive_coding"] = nn.Linear(
                top, conf.contrastive_coding_dim)
        return heads

    def _build_decoder(self, conf: ModelConfig) -> None:
        depth = conf.depth_unet
        hc = conf.hidden_channels
        dt = conf.dtype
        ws = tuple(conf.attn_window_size)
        in_chs = [hc[i] for i in range(depth)][::-1]
        out_chs = [hc[i + 1] for i in range(depth)][::-1]
        res, swin = conf.unetr_res_block, conf.unetr_up_block == "swin"
        if res != "none" and swin and conf.use_decoder_prompting:
            self.prompt_tokens.out = nn.ParameterList([
                nn.Parameter(torch.empty(conf.tokens_per_prompt_decoder,
                                         hc[0]))
                for _ in range(2)])
        if res == "full":
            self.bottleneck = UnetrBasicBlock(
                out_chs[0], out_chs[0], res_block=conf.basic_block_res)
            # The last skip block takes the raw input.
            self.residual_blocks = nn.ModuleList([
                UnetrBasicBlock(c, in_chs[min(i, depth - 1)],
                                res_block=conf.basic_block_res)
                for i, c in enumerate(in_chs + [conf.input_channels])])
        else:
            self.bottleneck = same_conv(out_chs[0], out_chs[0])
            if res == "simple":
                self.residual_blocks = nn.ModuleList([
                    same_conv(c, in_chs[min(i, depth - 1)])
                    for i, c in enumerate(in_chs + [conf.input_channels])])

        def up_block(cin, cout, strides):
            if not swin:
                return UnetrUpBlock(cin, cout, res_block=conf.res_block)
            return SwinUpBlock(
                cin, cout, strides, (3, 3, 3), conf.pos_bias_embed_dim,
                conf.num_heads_decoder, ws, conf.max_prompts,
                conf.tokens_per_prompt_decoder, pad_mode=conf.pad_mode,
                dtype=dt, attn_drop=conf.attn_drop,
                proj_drop=conf.proj_drop)

        # Depth is re-expanded at the last level only, mirroring stage 0.
        self.decoder_blocks = nn.ModuleList([
            up_block(out_chs[i], in_chs[i], (2, 2, 1 if i < depth - 1 else 2))
            for i in range(depth)])
        if res != "none":
            self.output_layer = up_block(hc[0], hc[0], (2, 2, 2))
        self.head_name, classes = None, 0
        if conf.training_mode == "downstream":
            self.head_name = "downstream"
            classes = conf.output_channels_downstream
        elif conf.training_mode in SUPERVISED_MODES:
            self.head_name = "segmentation"
            classes = conf.output_channels_pretrain
        self.extra_heads = nn.ModuleDict({} if classes == 0 else {
            self.head_name: nn.Sequential(
                nn.BatchNorm3d(hc[0], eps=1e-5, momentum=0.1),
                same_conv(hc[0], classes))})

    def set_data_group(self, group) -> "SwinUnetR":
        """Train as one rank of a data group (``parallel/mesh.py``; None:
        alone): BatchNorm on the global batch's moments and the Swin
        blocks' dropout counters at the global window index."""
        for m in self.modules():
            if isinstance(m, nn.BatchNorm3d) or hasattr(m, "data_group"):
                m.data_group = group
        return self

    def set_kernels(self, enabled: bool) -> "SwinUnetR":
        """Route the blocks and the decoder convs through the CUDA kernel
        wrappers (``True``) or straight to their plain versions."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = enabled
        return self

    def set_fused_block(self, enabled: bool) -> "SwinUnetR":
        """Run every Swin block as the fused block (``True``) or as the
        unfused block with the window-attention kernels."""
        for m in self.modules():
            if hasattr(m, "fused_block"):
                m.fused_block = enabled
        return self

    def set_pair_kernel(self, enabled: bool) -> "SwinUnetR":
        """Run each Swin block pair as one pair call (``True``) where its
        geometry allows, or as two block calls."""
        for m in self.modules():
            if hasattr(m, "pair_kernel"):
                m.pair_kernel = enabled
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

    def _skip(self, i: int, c: torch.Tensor) -> torch.Tensor:
        res = self.conf.unetr_res_block
        if res == "none":
            return c
        block = self.residual_blocks[i]
        if res == "simple":
            return conv3d(c.to(self.conf.dtype), block)
        return block(c)

    def reconstruction_shape(self, spatial: Sequence[int]
                             ) -> Tuple[int, int, int]:
        """``[H, W, D]`` of the phase-1 reconstruction of an input of
        ``spatial`` shape: the patch embedding (floor), each stage's merge
        (every odd axis padded by one, then H and W halved, and D at stage
        0 only), the head's upsamples (floor)."""
        conf = self.conf
        shape = [s // p for s, p in zip(spatial, conf.input_patch_size)]
        for i in range(conf.depth_unet):
            shape = [(s + s % 2) // (2 if a < 2 or i < 1 else 1)
                     for a, s in enumerate(shape)]
        for scale in _rec_scales(conf.depth_unet):
            shape = [int(s * f) for s, f in zip(shape, scale)]
        return tuple(shape)

    def forward(self, x: torch.Tensor):
        """x: ``[B, H, W, D, C_in]`` -> the downstream logits ``[B, H, W,
        D, classes]`` (fp32), or the phase-1 or phase-2 dict (module
        docstring)."""
        conf = self.conf
        enc = batch_norm(conv3d(x.to(conf.dtype), self.input_layer[0]),
                         self.input_layer[1]).to(conf.dtype)
        feats = [enc, x]
        for j, stage in enumerate(self.encoder_blocks):
            enc = stage(enc, (self._tokens("enc", 2 * j),
                              self._tokens("enc", 2 * j + 1)))
            feats.insert(0, enc)
        if conf.training_mode == PHASE1_MODE:
            return self._ssl_outputs(feats)
        if conf.unetr_res_block == "full":
            dec = self.bottleneck(feats[0]) + feats[0]
        else:
            dec = conv3d(feats[0], self.bottleneck) + feats[0]
        for j, up in enumerate(self.decoder_blocks):
            dec = up(dec, self._skip(j, feats[j + 1]),
                     (self._tokens("dec", 2 * j),
                      self._tokens("dec", 2 * j + 1)))
        if conf.unetr_res_block == "none":
            if self.training or not self.use_kernels:
                out = upsample_trilinear(dec, (2, 2, 2), align_corners=False)
            elif conf.training_mode == "downstream":
                # Serving: the upsample with the head as its epilogue.
                return upsample(dec, (2, 2, 2), head=self._head_operands(dec))
            else:
                out = upsample(dec, (2, 2, 2))
        else:
            out = self.output_layer(
                dec, self._skip(conf.depth_unet, feats[-1]),
                (self._tokens("out", 0), self._tokens("out", 1)))
        if conf.training_mode == "downstream":
            return self._head(out)
        outputs = {"latent_outputs": out.float()}
        if self.head_name is not None:
            outputs["seg_pred"] = self._head(out)
        return outputs

    def _head_operands(self, x: torch.Tensor) -> Head:
        """The head as ``ops/upsample.py`` takes it; on a CUDA card with
        its kernel operands, kept while no parameter or statistic of the
        head changes or moves."""
        norm, conv = self.extra_heads[self.head_name]
        dtype = self.conf.dtype
        if not x.is_cuda:
            return Head(*bn_fold(norm), conv.weight, conv.bias, dtype)
        leaves = (norm.weight, norm.bias, norm.running_mean,
                  norm.running_var, conv.weight, conv.bias)
        stamp = tuple((t.data_ptr(), t._version) for t in leaves) + (x.dtype,)
        if self._head_cache is None or self._head_cache[0] != stamp:
            head = Head(*bn_fold(norm), conv.weight, conv.bias, dtype,
                        kernel_operands(conv.weight, conv.bias, dtype,
                                        x.dtype))
            self._head_cache = (stamp, head)
        return self._head_cache[1]

    def _head(self, out: torch.Tensor) -> torch.Tensor:
        norm, conv = self.extra_heads[self.head_name]
        return head_conv(batch_norm(out.float(), norm), conv.weight,
                         conv.bias, self.conf.dtype)

    def _ssl_outputs(self, out_vit: list) -> dict:
        heads, outputs = self.extra_heads, {}
        top = out_vit[0].float()
        if "reconstruction" in heads:
            rec, layers = top, list(heads["reconstruction"])
            for i, scale in enumerate(_rec_scales(self.conf.depth_unet)):
                rec = F.leaky_relu(instance_norm(conv3d(rec, layers[4 * i])),
                                   0.01)
                rec = upsample_trilinear(rec, scale, align_corners=True)
            outputs["reconstruction"] = conv3d(rec, layers[-1])
        pooled = top.mean(dim=(1, 2, 3))
        for name in ("rotation_prediction", "contrastive_coding"):
            if name in heads:
                outputs[name] = heads[name](pooled)
        outputs["out_vit"] = out_vit
        return outputs
