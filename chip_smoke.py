#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (first use) and drives
the port's paths:

* serving: B1 (fused Swin block) and B2 (pair-input decoder conv) against
  their plain PyTorch versions at every shape the flagship serving path
  gives them (and B3, B2's one-input form, which no model calls), the
  flagship model (seeded random weights, bf16 trunk) on a 27-window batch
  with and without the kernels, then a seeded 320x320x24 int16 CT volume
  served through ``infer.make_runner`` / ``infer.serve_volumes`` (stride
  0.75, 27 windows);
* unfused serving (``SwinUnetR.set_fused_block(False)``, the
  ``MIVP_NO_FUSED_BLOCK=1`` path): the window-attention kernels B6
  (projections in the kernel), B7 and B8 against their plain versions at
  every geometry of that path, shifted and unshifted, called as the
  unfused blocks call them (the bias built from its factor tables, B6's
  prompt rows projected once per call), each with its launch shape and
  timed beside one ``scaled_dot_product_attention`` call where it
  computes the same function; the same flagship model through the
  unfused blocks (kernels vs plain, and vs the fused path; every B6/B8
  launch in the factor form), and the same volume served through it;
* training: B1 with counter-hash dropout and B4 (the block backward)
  against their plain versions at the six flagship block geometries at
  batch 2, then ``train.SegmentationTrainer.train()`` on a seeded
  synthetic NIfTI set at the flagship training config (dropout 0.1/0.1,
  ``use_checkpoint``, AdamW 5e-4 / 0.1, DiceFocal gamma 4, batch 2 of
  128x128x8 crops), once with the kernels and once with the plain
  versions, and a ``torch.profiler`` breakdown of two kernel steps;
* block pairs (``SwinUnetR.set_pair_kernel(True)``, the
  ``MIVP_PAIR_KERNEL=1`` path): B5 (both blocks of a Swin block pair in
  one launch) against its plain version and, element for element, against
  B1 + the pair's row gather + B1 + the inverse gather at the 6 flagship
  pair geometries (and with dropout at the training batch), then the
  flagship model, the served volume and the trainer through it (6 B5 + 3
  B2 per forward; 6 B5 + 6 B1 + 12 B4 per training step);
* an fp32 trunk: the model of ``configurations/example_configs.yml``
  (``compute_dtype: float32``, ``pad_mode: reference``; found by the
  port's config lookup, seeded random weights) with and without the
  kernels and served as above (12 B1 + 3 B2 per forward, fp32
  activations in B1, B2 rounding its inputs to bf16 and writing fp32),
  then two training steps of the flagship training config with an fp32
  trunk (12 B1 + 12 B4 per step);
* the downstream workflow through the CLIs (phase ``cli``): the same
  example config with 64+64 prompt tokens on a seeded synthetic set,
  ``main.main`` fitting epochs 0-1 and saving ``0001.ckpt``, resuming from
  it (the restored model and optimizer state bit for bit the file's;
  its 16x16x2 stages' M 256 windows take B4's device-memory form),
  testing from it per window (argmax against the plain path) and
  Gaussian-stitched, and ``infer --ckpt`` of one 320x320x24 test volume
  (labels against the Gaussian test's); 12 B1 + 12 B4 per fit step, 12
  B1 + 3 B2 per validation step and per test or infer forward, 4 of a
  fit step's B4 launches in the device-memory form; before it, that form
  at those 4 calls per step, against its plain version and timed beside
  it; and ``infer`` with the intensities windowed on the host
  (``device_windowing=False``), its labels against the Gaussian test's;
* the other decoder layouts (phase ``layouts``) at the flagship widths:
  B1, B2 and B4 at the Swin output layer's shapes (C 48, 4 heads,
  128x128x8: 13,824 windows per 27-window forward, 48 + 48 -> 48 conv),
  the ``full``/``swin`` model (UNETR skip blocks and bottleneck, Swin
  output layer with its prompt tokens) on a 27-window batch through the
  fused blocks (14 B1 + 4 B2), the block pairs (6 B5 + 2 B1 + 4 B2: the
  output layer's pair shifts the depth axis) and the unfused blocks (10
  B6 + 4 B8 + 4 B2), the served volume, the per-window stitcher and
  ``infer.watch_directory``, three training steps (14 B1 + 14 B4 each),
  and one forward of ``none``/``unetr`` and ``simple``/``unetr`` (6 B1)
  and ``simple``/``swin`` (14 B1 + 4 B2); a Swin output layer's plain
  forward runs 9 windows at a time;
* phase-2 students-teacher training (phases ``students-blocks`` and
  ``students-teacher``): B1 with dropout and B4 at the 24 block calls of
  the two students' crops (96x96x8 and 80x80x8 at window 8x8x4: depth
  folded at 24x24x2, H/W and depth padded at 12x12x2, 20x20x2 and
  10x10x2) and B2 at their 6 decoder convs, against their plain versions;
  then ``main --mode fit --training-mode supervised_learning_all`` at the
  flagship model with the example config's phase-2 section on seeded
  synthetic volumes (4 steps of 36 B1 + 24 B4, 2 validation steps of 36
  B1 + 9 B2), with the kernels and with the plain versions (losses within
  2e-2), its epoch-0 checkpoint resumed bit for bit (student, teacher,
  optimizer, step), the teacher's EMA after one step against host fp64,
  a profile of 2 steps and the prototype loss's device time; and
  ``self_supervised_learning_decoder`` for 2 steps (36 B1 + 12 B4 each;
  the encoder bit for bit its initial values);
* phase-1 multi-view pretraining (phases ``multi-view-blocks``,
  ``multi-view`` and ``multi-view-mutual``): B1 with dropout and B4 at
  the 12 encoder block calls of a step at batch 14 (the reference's 2
  volumes x 7 crops) at the flagship (bf16, aligned) and the example
  config (fp32, reference padding: B4's device-memory form at C 192), B5
  at the 6 pair calls, against their plain versions; ``main --mode fit
  --training-mode self_supervised_learning_encoder`` at the flagship
  model with the example config's multi-view section (batch 2 of 7 crops
  per volume: 7 steps of 12 B1 + 12 B4, 3 validation steps of 12 B1),
  kernels vs plain, its checkpoint resumed bit for bit, a profile; one
  step on the block pairs (6 B5 + 6 B1 + 12 B4); the same fit at batch
  14; one phase-2 ``self_supervised_learning_all`` step from the phase-1
  checkpoint (the encoder the checkpoint's, the teacher the student);
  and mutual learning at the flagship roi: one step at the H-W swap (18
  B1 + 18 B4, against plain) and a ``ValueError`` before any launch at
  the two swaps whose reconstruction is not the roi's shape;
* training through the unfused blocks (phases ``unfused-grads``,
  ``train-unfused`` and ``pretrain-unfused``): the autograd Functions of
  B6/B8 (kernel forward, the JAX package's fp32 recompute as backward,
  plain torch) at the 12 calls of a flagship training step at batch 2
  (and B7 at one C 96 call), gradients against autograd of the fp32
  plain version within 2^-10, the forward bit for bit the serving
  call's, the backward timed; ``SegmentationTrainer.train()`` through
  the unfused blocks at attention dropout 0 (8 B6 + 4 B8 per step) and
  at 0.1/0.1 with ``use_checkpoint`` (the JAX XLA attention, no kernel;
  the dropped share; checkpointed gradients against unchecked ones),
  with validation (8 B6 + 4 B8 + 3 B2 per forward), kernels vs plain,
  profiled beside the fused step; and ``main --mode fit`` of
  ``self_supervised_learning_all`` and
  ``self_supervised_learning_encoder`` under ``MIVP_NO_FUSED_BLOCK=1``;
* the single-card CLI rest: ``view: true`` in the three trainers (phase
  ``view``: the PNGs decoded by this script's own reader) and the two
  checkpoint converter CLIs on the flagship's weights (phase
  ``convert``: msgpack -> ``.pt`` -> msgpack bit for bit);
* data parallel (phases ``dp-kernels``, ``dp-nccl`` and
  ``dp-two-ranks``): B1, B5 and B4 with dropout on one rank's rows of a
  batch of 4 at their ``win_base`` against the whole call's rows (bit for
  bit) and their plain versions; ``main.main`` over a real NCCL process
  group of one rank (``distributed: true``; the flagship fit, 6 steps,
  and a Gaussian test) against no group; and two processes of this
  script (``--dp-rank R --dp-port P --dp-root DIR``) as a gloo group
  over CUDA tensors on the one card: the flagship fit at ``mesh_data: 2``
  and global batch 4 against the one-process fit, each rank's launches,
  and DP serving of the 320x320x24 volume against one-process serving.

* the rest of the JAX package's surface (phases ``native-serve``,
  ``segment-volume``, ``profile-trace``, ``flops``): the native data
  library (``data/native.py``, built from ``native/miseg_native.cpp``)
  against numpy on the 320x320x24 volume, that volume served from disk
  with the native and the numpy decoder (labels equal to each other and
  to the in-memory run; vol/s of each in alternating repeated arms);
  ``infer.segment_volume`` against ``predict_device``; ``main.main``
  fitting the flagship training config for 7 steps with ``profile_dir``,
  the trace's B1/B4 events of steps 2-6 against the launch counters
  over them; model FLOPs per window (``utils/flops.py``) and the shares
  of the card's peak that serving and the pretraining steps reach.

Device busy shares (``print_profile`` and the trace) count kernels,
copies and fills only, not user-annotation spans.  The peaks that
``Bound`` divides by come from the card's name (``utils/flops.py``).

B2 and B3 are timed beside one cuDNN ``conv3d`` on the same shapes
without the prologue (bf16, channels-last), and each B2 launch reports
its tile, registers, spills and CTAs per SM; each B1 and B5 launch of the
serving geometries and each B4 launch of the training geometries reports
its cluster size (CTAs per window), CTAs, CTAs per SM, registers, spills
and shared bytes, and B4 runs twice on the same inputs with bit-identical
outputs.

Each path runs with the launch counters set to 0 just before and read
just after.  It prints one JSON line describing the kernels (times,
bounds, launches per path), the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``.  Any failed check ends the
run with a non-zero exit code and no result line; so does a machine
without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from argparse import Namespace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "medical_image_segmentation_with_visual_prompts_tpu_torch"
JAX_PKG = "medical_image_segmentation_with_visual_prompts_tpu"
BATCH = 27          # windows of the 320x320x24 volume at stride 0.75
TRAIN_BATCH = 2     # crops per training step
SEED = 0
# Kernel vs plain version, both with bf16 operands and fp32 sums: the
# outputs are bf16, and a sum taken in another order can flip the
# rounding of a bf16 intermediate (K, V, the attention output, the conv
# input) or of the output itself.  Allowed: 4 bf16 ulps (4 * 2^-8
# relative) of the largest reference magnitude.
KERNEL_TOL = 2.0 ** -6
# B4 vs the autograd of the plain block, per gradient output, relative
# to that output's largest magnitude: the kernel rounds P, dS, dP and the
# row gradients to bf16 for its tensor-core products where the plain
# version keeps fp32, and sums in another (fixed) order.
GRAD_TOL = 2.0 ** -5
# Flagship logits, kernels vs plain versions on the same weights: the
# bf16 rounding differences above pass through 12 blocks and 4 convs.
MODEL_MIN_ARGMAX_AGREEMENT = 0.999
# A seeded model whose logits leave many voxels within the kernels' noise
# of a tie flips a share of them whatever the kernels' accuracy (0.2% of
# the flagship's voxels have a margin under twice the largest logit
# difference; 3-4% in the layouts with a Swin output layer, 8-20% in the
# others, on the H100).  Where the argmax agreement is printed only, the
# forward is held to limits that the reference's logits alone set, so
# that a larger error cannot widen them: the mean |logit difference| under
# one bf16 epsilon of the largest |logit| over all windows, and under two
# in every window (an error confined to one window of 27 cannot hide in
# the mean); no voxel flipped whose reference margin (top-1 minus top-2)
# is NEAR_TIE of the largest |logit| or more; at most FLIP_SHARE of the
# voxels under that margin flipped.
LOGIT_MEAN_TOL = 2.0 ** -8
WINDOW_MEAN_TOL = 2.0 ** -7
NEAR_TIE = 2.0 ** -4
FLIP_SHARE = 0.1
# Windows per plain forward (the untimed reference; each window's logits
# are its own in eval mode): a Swin output layer's plain block holds
# [windows x 512, 4, 256, 320] fp32 scores.
PLAIN_CHUNK = 9
SERVE_MIN_LABEL_AGREEMENT = 0.999
SERVE_REPEATS = 10
# Trainer, kernels vs plain versions from the same weights, crops and
# dropout seeds: per-step loss within 2% relative.  Each step's loss is a
# mean over 2x128x128x8 voxels; the kernels' bf16 rounding of P (forward
# and backward) moves the gradients by ~1% (GRAD_TOL above) and so the
# AdamW updates of the following steps.
TRAIN_LOSS_RTOL = 2e-2
TRAIN_VOLUMES = 8   # 6 train volumes x 2 crops = 6 steps of batch 2
DROP_RATE = 0.1
# The card's dense bf16 tensor-core FLOP/s and memory bytes/s (NVIDIA's
# data sheet, by the card's name: utils/flops.py), set by card_peaks().
PEAKS = {}

# (name, C, heads, spatial dims) of the 6 flagship block
# geometries on a 128x128x8 roi: encoder stages 0-2 and decoder blocks
# 0-2 (the 32x32x2 and 16x16x2 stages pad-fold their depth axis).
BLOCK_GEOMETRIES = (
    ("enc0", 48, 4, (64, 64, 4)),
    ("enc1", 96, 8, (32, 32, 2)),
    ("enc2", 192, 16, (16, 16, 2)),
    ("dec0", 192, 4, (16, 16, 2)),
    ("dec1", 96, 4, (32, 32, 2)),
    ("dec2", 48, 4, (64, 64, 4)),
)
# Unfused serving: the 12 blocks pad the depth-2 stages to 4 (no pad
# folding), so every call has M 256 and N 320; B6 runs at C <= 128 (8 per
# forward), B8 at C 192 (4 per forward).
UNFUSED_LAUNCHES = {"B6": 8, "B8": 4, "B2": 3}
# (name, Ca, Cb, Co, spatial dims) of the 3 decoder pair convs.
CONV_SHAPES = (
    ("dec0", 384, 192, 192, (16, 16, 2)),
    ("dec1", 192, 96, 96, (32, 32, 2)),
    ("dec2", 96, 48, 48, (64, 64, 4)),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_peaks():
    """(bf16 FLOP/s, bytes/s) of this card; an unknown card raises."""
    if not PEAKS:
        from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
            .flops import chip_peak_tbytes, chip_peak_tflops
        PEAKS.update(flops=chip_peak_tflops() * 1e12,
                     bytes=chip_peak_tbytes() * 1e12)
    return PEAKS["flops"], PEAKS["bytes"]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Bound:
    """Sum over a path's kernel calls of the least time the card could
    take for each: the larger of its bf16 operations over the peak rate
    and its bytes (each input read once, each output written once) over
    the memory rate."""

    def __init__(self):
        self.ms = self.ops_ms = self.bytes_ms = 0.0

    def add(self, flops: float, nbytes: float) -> None:
        peak_flops, peak_bytes = card_peaks()
        t_ops = 1e3 * flops / peak_flops
        t_bytes = 1e3 * nbytes / peak_bytes
        self.ms += max(t_ops, t_bytes)
        self.ops_ms += t_ops
        self.bytes_ms += t_bytes

    @property
    def by(self) -> str:
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"


def block_work(x_win, ops, labels):
    """(flops, bytes) of one B1 call: five C x C products per row and the
    two attention products over N keys; x in and out (its dtype), bf16
    weights and extra K/V rows, the bias's factors (fp32 tables, int32
    coordinates), fp32 vectors, int32 labels."""
    b, p, m, c = x_win.shape
    bp, n, e = b * p, m + ops.n_ext, ops.n_ext
    flops = bp * (10 * m * c * c + 4 * m * n * c)
    bias = ops.kernel["pe_tab"].numel() * 4 + ops.kernel["pe_coord"].numel() * 4
    nbytes = (2 * bp * m * c * x_win.element_size() + 5 * c * c * 2
              + 2 * e * c * 2 + bias + 6 * c * 4
              + (0 if labels is None else labels.numel() * 4))
    return flops, nbytes


def block_bwd_work(x_win, ops, labels):
    """(flops, bytes) of one B4 call: the forward's products once more
    (recompute) and twice for the gradients; reads x, dout and the
    forward's inputs (the bias as its factors), writes dx (x's dtype) and
    the fp32 operand gradients (the bias's as [H, M, N])."""
    b, p, m, c = x_win.shape
    bp, n, h, e = b * p, m + ops.n_ext, ops.num_heads, ops.n_ext
    fwd_flops, fwd_bytes = block_work(x_win, ops, labels)
    nbytes = fwd_bytes + bp * m * c * x_win.element_size() + (
        5 * c * c * 4 + 6 * c * 4 + h * m * n * 4 + 2 * e * c * 4)
    return 3 * fwd_flops, nbytes


def attention_work(bp, m, n, c, heads, labels, proj: bool, factors=None):
    """(flops, bytes) of one B6 (``proj``) or B7/B8 call as the unfused
    block makes it: the two attention products per head, plus B6's q/k/v
    projections (the prompt rows' K/V once per call: they are the same in
    every window); bf16 y (B6: each window's content rows, the prompt rows
    once) or q/k/v in, the bf16 weights (B6), the bias (its factor tables,
    fp32 and int32, where ``factors`` are given, else the fp32 [H, M, N]
    array), int32 labels, the bf16 output."""
    e = n - m
    flops = 4 * bp * m * n * c + (2 * (bp * 3 * m + 2 * e) * c * c if proj
                                  else 0)
    ins = (bp * m + e) * c * 2 + 3 * c * c * 2 if proj else \
        bp * (m + 2 * n) * c * 2
    bias = heads * m * n * 4 if factors is None else \
        factors.tab.numel() * 4 + factors.coord.numel() * 4
    nbytes = (ins + bias + bp * m * c * 2
              + (0 if labels is None else labels.numel() * 4))
    return flops, nbytes


def check_close(name: str, got, ref, failures: list,
                tol: float = KERNEL_TOL, floor: float = 1.0) -> float:
    """Max abs error of ``got`` against ``ref``, held to ``tol`` of
    ``max(floor, max|ref|)``."""
    import torch
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        failures.append(f"{name}: non-finite output")
        return float("inf")
    err = (got - ref).abs().max().item()
    big = ref.abs().max().item()
    limit = tol * max(floor, big)
    print(f"  {name}: max_abs_err {err:.6g} (of max {big:.4g}, rel "
          f"{err / max(big, 1e-12):.3g}, tol {limit:.3g})")
    if not err <= limit:
        failures.append(f"{name}: max_abs_err {err} > {limit}")
    return err


def make_block(c, heads, shift, gen, drop=0.0):
    """A flagship-geometry Swin block (seeded random weights, bf16)."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinTransformerBlock
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                               shift_size=shift, pad_mode="aligned",
                               dtype=torch.bfloat16, attn_drop=drop,
                               proj_drop=drop)
    return init_weights(blk, gen).cuda()


def block_tag(name, c, heads, dims, x_win, ops, labels) -> str:
    return (f"{name} C{c} h{heads} {'x'.join(map(str, dims))} "
            f"BP{x_win.shape[0] * x_win.shape[1]} M{x_win.shape[2]} "
            f"N{x_win.shape[2] + ops.n_ext} "
            f"{'shift' if labels is not None else 'noshift'}")


def phase_blocks(gen_seed: int = SEED):
    """B1 at the 6 flagship geometries, no-shift and shift, 27 windows."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import block_reference, fused_swin_block, launch_info
    print("phase B1: fused Swin block vs block_reference (bf16, serving)")
    failures, errs = [], []
    ms = plain_ms = 0.0
    bound = Bound()
    g = torch.Generator().manual_seed(gen_seed)
    for name, c, heads, dims in BLOCK_GEOMETRIES:
        for shift in ((0, 0, 0), (4, 4, 2)):
            blk = make_block(c, heads, shift, g)
            x = torch.randn((BATCH, *dims, c), generator=g).to(
                "cuda", torch.bfloat16)
            tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
            with torch.inference_mode():
                x_win, ops, labels, _ = blk.windows(x, tok)
                ref = block_reference(x_win, ops, labels)
                out = fused_swin_block(x_win, ops, labels)
                torch.cuda.synchronize()
                tag = block_tag(name, c, heads, dims, x_win, ops, labels)
                errs.append(check_close(tag, out, ref, failures))
                t_k = cuda_ms(lambda: fused_swin_block(x_win, ops, labels))
                t_p = cuda_ms(lambda: block_reference(x_win, ops, labels), 3)
            bound.add(*block_work(x_win, ops, labels))
            print(f"    kernel {t_k:.4f} ms, plain {t_p:.4f} ms; launch "
                  f"{launch_info(x_win, ops, labels)}")
            ms += t_k
            plain_ms += t_p
    if failures:
        raise RuntimeError("phase B1 failed: " + "; ".join(failures))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound": bound}


def phase_convs(gen_seed: int = SEED + 1, shapes=CONV_SHAPES,
                batch: int = BATCH, one_input: bool = True):
    """B2 at the decoder pair-conv ``shapes`` (default: the 3 of the
    serving forward) on ``batch`` samples; with ``one_input`` also B3."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .conv_fused import (conv3x3_fused_pair, conv_pair_reference,
                            kernel_weight)
    import torch.nn.functional as F
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .conv_fused import tile_info
    print("phase B2: pair conv vs conv_pair_reference (bf16), beside cuDNN "
          "conv3d of the concat without the prologue (bf16, channels-last)")
    failures, errs, tiles = [], [], {}
    ms = plain_ms = cudnn_ms = 0.0
    bound = Bound()
    g = torch.Generator().manual_seed(gen_seed)
    for name, ca, cb, co, dims in shapes:
        cin = ca + cb
        xa = torch.randn((batch, *dims, ca), generator=g).to(
            "cuda", torch.bfloat16)
        xb = torch.randn((batch, *dims, cb), generator=g).to(
            "cuda", torch.bfloat16)
        w = (torch.randn((co, cin, 3, 3, 3), generator=g)
             * (27 * cin) ** -0.5).cuda()
        bias = (0.1 * torch.randn(co, generator=g)).cuda()
        scale = (0.5 + torch.rand(cin, generator=g)).cuda()
        # A shift large enough that leaky(shift) != 0 at the padded
        # border if padding were applied before the prologue.
        shift = (1.0 + torch.randn(cin, generator=g)).cuda()
        w27 = kernel_weight(w)
        with torch.inference_mode():
            ref = conv_pair_reference(xa, xb, w, bias, scale, shift)
            out = conv3x3_fused_pair(xa, xb, w, bias, scale, shift, w27=w27)
            torch.cuda.synchronize()
            tag = f"{name} {ca}+{cb}->{co} @{'x'.join(map(str, dims))}"
            errs.append(check_close(tag, out, ref, failures))
            t_k = cuda_ms(lambda: conv3x3_fused_pair(xa, xb, w, bias, scale,
                                                     shift, w27=w27))
            t_p = cuda_ms(lambda: conv_pair_reference(xa, xb, w, bias, scale,
                                                      shift))
            xc = torch.cat([xa, xb], -1).permute(0, 4, 1, 2, 3)
            wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
            t_l = cuda_ms(lambda: F.conv3d(xc, wb, bb, padding=1))
        tiles[name] = tile_info((batch, *dims), co)
        print(f"    tile {tiles[name]}")
        cudnn_ms += t_l
        vox = batch * dims[0] * dims[1] * dims[2]
        # bf16 inputs, bf16 27-tap weight, fp32 scale/shift/bias, bf16 out.
        bound.add(2 * vox * co * 27 * cin,
                  vox * cin * 2 + 27 * cin * co * 2 + cin * 8 + co * 4
                  + vox * co * 2)
        print(f"    kernel {t_k:.4f} ms, plain {t_p:.4f} ms, cuDNN conv3d "
              f"{t_l:.4f} ms")
        ms += t_k
        plain_ms += t_p
    print(f"  B2: {ms:.4f} ms per forward (cuDNN conv3d without the prologue "
          f"{cudnn_ms:.4f}, bound {bound.ms:.4f} ({bound.by}))")
    b3 = phase_conv_one_input(g, failures) if one_input else None
    if failures:
        raise RuntimeError("phase B2 failed: " + "; ".join(failures))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound": bound, "cudnn_ms": cudnn_ms, "tiles": tiles}, b3


def phase_conv_one_input(g, failures):
    """B3 (B2's kernel with one input) at 48->48 on 64x64x4, with the BN +
    LeakyReLU prologue and without either; the second is timed beside the
    cuDNN conv that computes the same function."""
    import torch
    import torch.nn.functional as F
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .conv_fused import conv3x3_fused, conv_reference, kernel_weight
    ci = co = 48
    dims = (64, 64, 4)
    x = torch.randn((BATCH, *dims, ci), generator=g).to("cuda", torch.bfloat16)
    w = (torch.randn((co, ci, 3, 3, 3), generator=g) * (27 * ci) ** -0.5).cuda()
    bias = (0.1 * torch.randn(co, generator=g)).cuda()
    scale = (0.5 + torch.rand(ci, generator=g)).cuda()
    shift = (1.0 + torch.randn(ci, generator=g)).cuda()
    w27 = kernel_weight(w)
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound": Bound(),
           "library_ms": None}
    vox = BATCH * dims[0] * dims[1] * dims[2]
    for prologue in (True, False):
        args = (scale, shift, True) if prologue else (None, None, False)
        with torch.inference_mode():
            ref = conv_reference(x, w, bias, *args)
            out = conv3x3_fused(x, w, bias, *args, w27=w27)
            torch.cuda.synchronize()
            tag = (f"B3 {ci}->{co} @{'x'.join(map(str, dims))} "
                   f"{'BN+LeakyReLU' if prologue else 'no prologue'}")
            res["max_abs_err"] = max(res["max_abs_err"],
                                     check_close(tag, out, ref, failures))
            t_k = cuda_ms(lambda: conv3x3_fused(x, w, bias, *args, w27=w27))
            t_p = cuda_ms(lambda: conv_reference(x, w, bias, *args))
            line = f"    kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
            if not prologue:
                xc = x.permute(0, 4, 1, 2, 3)
                wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
                t_l = cuda_ms(lambda: F.conv3d(xc, wb, bb, padding=1))
                res["library_ms"] = t_l
                res["no_prologue_ms"] = t_k
                line += f", cuDNN conv3d {t_l:.4f} ms"
        res["bound"].add(2 * vox * co * 27 * ci,
                         vox * ci * 2 + 27 * ci * co * 2 + co * 4
                         + (ci * 8 if prologue else 0) + vox * co * 2)
        print(line)
        res["ms"] += t_k
        res["plain_ms"] += t_p
    return res


def phase_attention(gen_seed: int = SEED + 7):
    """B6, B7 and B8 at the 12 block calls of an unfused flagship forward
    (27 windows), each held to its plain version.  B6 and B8 run as the
    unfused blocks call them (the bias as its factor tables; B6 on the
    content rows and the prompt rows that every window shares, given apart,
    their K/V projected once per call); B7 runs at B6's geometries on q/k/v
    that the plain linear layers projected.  Each call prints its launch
    shape.  Unshifted B7/B8 calls are also timed as one
    ``scaled_dot_product_attention`` call (the same function with an
    additive bias; the shifted calls' multiplicative mask has no such call,
    nor does B6's in-kernel projection)."""
    import torch
    import torch.nn.functional as F
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        .window_attention import linear
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import window_attention as wa
    print("phase B6-B8: window attention vs plain versions (bf16, unfused "
          "serving, 27 windows)")
    failures = []
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound": Bound(), "library_ms": 0.0, "ms_unshifted": 0.0}
           for k in ("B6", "B7", "B8")}
    g = torch.Generator().manual_seed(gen_seed)

    def run(key, tag, kernel, plain, work, shape, library=None):
        r = res[key]
        ref = plain()
        out = kernel()
        torch.cuda.synchronize()
        r["max_abs_err"] = max(r["max_abs_err"],
                               check_close(f"{key} {tag}", out, ref, failures))
        t_k = cuda_ms(kernel)
        t_p = cuda_ms(plain, 3)
        r["bound"].add(*work)
        one = Bound()
        one.add(*work)
        print(f"    launch: {shape}")
        line = (f"    kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                f"{one.ms:.4f} ms ({one.by})")
        if library is not None:
            t_l = cuda_ms(library)
            r["library_ms"] += t_l
            r["ms_unshifted"] += t_k
            line += f", scaled_dot_product_attention {t_l:.4f} ms"
        print(line)
        r["ms"] += t_k
        r["plain_ms"] += t_p

    for name, c, heads, dims in BLOCK_GEOMETRIES:
        for shift in ((0, 0, 0), (4, 4, 2)):
            blk = make_block(c, heads, shift, g)
            blk.fused_block = False
            x = torch.randn((BATCH, *dims, c), generator=g).to(
                "cuda", torch.bfloat16)
            tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
            at = blk.attn
            scale = (c // heads) ** -0.5
            with torch.inference_mode():
                x_win, ops, labels, _ = blk.windows(x, tok)
                bias, tables = ops.bias, ops.factors
                y = blk.attn_input(x_win, tok)
                b, pw, n = y.shape[:3]
                m = x_win.shape[2]
                bp = b * pw
                tag = (f"{name} C{c} h{heads} BP{bp} M{m} N{n} "
                       f"{'shift' if labels is not None else 'noshift'}")
                q = linear(y[:, :, :m], at.to_q).contiguous()
                k = linear(y, at.to_k).contiguous()
                v = linear(y, at.to_v).contiguous()
                lib = None
                if labels is None:
                    sp = lambda t: t.view(bp, t.shape[2], heads, -1) \
                        .transpose(1, 2)  # noqa: E731
                    qs, ks, vs = sp(q), sp(k), sp(v)
                    bias16 = bias.to(torch.bfloat16)[None]
                    lib = lambda: F.scaled_dot_product_attention(  # noqa
                        qs, ks, vs, attn_mask=bias16, scale=scale)
                attend_shape = wa.launch_info(bp, m, n, c, heads, False,
                                              factors=tables)
                if c <= 128:
                    ws = tuple(lin.weight.t() for lin in
                               (at.to_q, at.to_k, at.to_v))
                    wqkv = at.kernel_weight()
                    yc = y[:, :, :m].contiguous()
                    yp = y[0, 0, m:].contiguous()
                    run("B6", tag,
                        lambda: wa.fused_window_attention_packed_qkv_prompts(
                            yc, yp, *ws, bias, labels, scale, heads,
                            wqkv=wqkv, factors=tables),
                        lambda: wa.fused_window_attention_packed_qkv_reference(
                            y, *ws, m, bias, labels, scale, heads),
                        attention_work(bp, m, n, c, heads, labels, True,
                                       tables),
                        wa.launch_info(bp, m, n, c, heads, True,
                                       factors=tables, hoisted=True))
                    run("B7", tag,
                        lambda: wa.fused_window_attention_packed(
                            q, k, v, bias, labels, scale, heads,
                            factors=tables),
                        lambda: wa.fused_window_attention_packed_reference(
                            q, k, v, bias, labels, scale, heads),
                        attention_work(bp, m, n, c, heads, labels, False,
                                       tables),
                        attend_shape, lib)
                else:
                    hs = lambda t: t.view(b, pw, t.shape[2], heads, -1)  # noqa
                    run("B8", tag,
                        lambda: wa.fused_window_attention(
                            hs(q), hs(k), hs(v), bias, labels, scale,
                            factors=tables),
                        lambda: wa.fused_window_attention_reference(
                            hs(q), hs(k), hs(v), bias, labels, scale),
                        attention_work(bp, m, n, c, heads, labels, False,
                                       tables),
                        attend_shape, lib)
    if failures:
        raise RuntimeError("phase B6-B8 failed: " + "; ".join(failures))
    for key, r in res.items():
        line = (f"  {key}: {r['ms']:.4f} ms per forward (plain "
                f"{r['plain_ms']:.4f}, bound {r['bound'].ms:.4f})")
        if r["ms_unshifted"]:
            line += (f"; unshifted calls {r['ms_unshifted']:.4f} ms vs "
                     f"scaled_dot_product_attention {r['library_ms']:.4f} ms")
        print(line)
    return res


def phase_blocks_train(gen_seed: int = SEED + 5,
                       geometries=BLOCK_GEOMETRIES,
                       name: str = "blocks-train"):
    """B1 with dropout and B4 at the block ``geometries`` (default: the 6
    flagship ones), no-shift and shift, at the training batch's window
    counts (the flagship's: the 12 block calls of one training step)."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import (PARAM_KEYS, Dropout, block_reference,
                             fused_swin_block)
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block_bwd import (block_backward, block_backward_reference,
                                 launch_info)
    phase = name
    print(f"phase {phase}: B1 with dropout {DROP_RATE}/{DROP_RATE} and "
          f"B4 vs their plain versions (bf16, batch {TRAIN_BATCH}); B4 run "
          "twice, its outputs bit-identical")
    failures, fwd_errs, bwd_errs = [], [], []
    fwd = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound()}
    bwd = {"ms": 0.0, "plain_ms": 0.0, "big_ms": 0.0, "bound": Bound()}
    names = ("x", "bias", "ext_k", "ext_v", *PARAM_KEYS)
    g = torch.Generator().manual_seed(gen_seed)
    for i, (name, c, heads, dims) in enumerate(geometries):
        for j, shift in enumerate(((0, 0, 0), (4, 4, 2))):
            blk = make_block(c, heads, shift, g, DROP_RATE)
            x = torch.randn((TRAIN_BATCH, *dims, c), generator=g).to(
                "cuda", torch.bfloat16)
            tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
            drop = Dropout((1000 + 2 * (2 * i + j), 1001 + 2 * (2 * i + j)),
                           DROP_RATE, DROP_RATE)
            with torch.no_grad():
                x_win, ops, labels, _ = blk.windows(x, tok)
            dout = torch.randn(x_win.shape, generator=g).to(
                "cuda", torch.bfloat16)
            tag = block_tag(name, c, heads, dims, x_win, ops, labels)
            with torch.inference_mode():
                ref = block_reference(x_win, ops, labels, drop)
                out = fused_swin_block(x_win, ops, labels, drop)
                torch.cuda.synchronize()
                fwd_errs.append(check_close(f"B1 {tag}", out, ref, failures))
                t_k = cuda_ms(lambda: fused_swin_block(x_win, ops, labels,
                                                       drop))
                t_p = cuda_ms(lambda: block_reference(x_win, ops, labels,
                                                      drop), 3)
            fwd["bound"].add(*block_work(x_win, ops, labels))
            fwd["ms"] += t_k
            fwd["plain_ms"] += t_p
            ref_dx, ref_g = block_backward_reference(x_win, dout, ops,
                                                     labels, drop)
            dx, got_g = block_backward(x_win, dout, ops, labels, drop)
            dx2, got_g2 = block_backward(x_win, dout, ops, labels, drop)
            torch.cuda.synchronize()
            print(f"  B4 {tag}; launch {launch_info(x_win, ops, labels, drop)}")
            for gname, a, b in zip(names, (dx, *got_g), (dx2, *got_g2)):
                if a is not None and not torch.equal(a, b):
                    failures.append(f"B4 {tag} d{gname}: two runs differ in "
                                    f"{int((a != b).sum())} elements")
            for gname, got, want in zip(names, (dx, *got_g),
                                        (ref_dx, *ref_g)):
                if want is None:
                    if got is not None:
                        failures.append(f"B4 {tag} {gname}: unexpected")
                    continue
                bwd_errs.append(check_close(f"  d{gname}", got, want,
                                            failures, GRAD_TOL, 1e-6))
            t_bk = cuda_ms(lambda: block_backward(x_win, dout, ops, labels,
                                                  drop))
            t_bp = cuda_ms(lambda: block_backward_reference(
                x_win, dout, ops, labels, drop), 3)
            bwd["bound"].add(*block_bwd_work(x_win, ops, labels))
            bwd["ms"] += t_bk
            bwd["plain_ms"] += t_bp
            # B4's device-memory form forced on the same call (the plan
            # takes it only where the shared-memory form does not fit):
            # against the plain version, timed beside the shared form.
            dxb, big_g = block_backward(x_win, dout, ops, labels, drop,
                                        big=True)
            torch.cuda.synchronize()
            print(f"    device-memory form: launch "
                  f"{launch_info(x_win, ops, labels, drop, big=True)}")
            for gname, got, want in zip(names, (dxb, *big_g),
                                        (ref_dx, *ref_g)):
                if want is not None:
                    bwd_errs.append(check_close(f"  d{gname}", got, want,
                                                failures, GRAD_TOL, 1e-6))
            t_bb = cuda_ms(lambda: block_backward(x_win, dout, ops, labels,
                                                  drop, big=True))
            bwd["big_ms"] += t_bb
            print(f"    B1 kernel {t_k:.4f} ms, plain {t_p:.4f} ms; "
                  f"B4 kernel {t_bk:.4f} ms (device-memory form {t_bb:.4f} "
                  f"ms), plain {t_bp:.4f} ms")
    if failures:
        raise RuntimeError(f"phase {phase} failed: " + "; ".join(failures))
    fwd["max_abs_err"] = max(fwd_errs)
    bwd["max_abs_err"] = max(bwd_errs)
    return fwd, bwd


def make_pair(c, heads, gen, drop=0.0):
    """A flagship-geometry Swin block pair (seeded random weights, bf16)
    with the pair switch on."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import ConsecutiveSwinBlocks
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    pair = ConsecutiveSwinBlocks(c, heads, 64, 1, 64, (8, 8, 4), down=False,
                                 pad_mode="aligned", dtype=torch.bfloat16,
                                 attn_drop=drop, proj_drop=drop)
    pair = init_weights(pair, gen).cuda()
    pair.pair_kernel = True
    return pair


def pair_work(x_win, ops0, ops1, labels):
    """(flops, bytes) of one B5 call: both blocks' products; x in and out
    once, both operand sets, the shifted block's labels."""
    f0, b0 = block_work(x_win, ops0, None)
    f1, b1 = block_work(x_win, ops1, labels)
    io = 2 * x_win.numel() * x_win.element_size()
    return f0 + f1, b0 + b1 - io


def phase_pair(gen_seed: int = SEED + 8):
    """B5 at the 6 flagship pair geometries (27 windows, no dropout, as
    the serve path calls it): against ``pair_reference`` within
    KERNEL_TOL, and against its two-launch counterpart (B1, the plan's
    row gather, B1, the inverse gather) element for element; then with
    dropout at the training batch.  Prints the launch shapes (cluster
    size, CTAs, CTAs per SM, registers, spills, shared bytes) of B1 and
    B5."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import NO_DROPOUT, Dropout, fused_swin_block, launch_info
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_pair import fused_swin_pair, pair_reference, plan_gather
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_pair import launch_info as pair_launch_info
    print("phase B5: Swin block pair vs pair_reference and vs B1 + gather + "
          "B1 + gather (bf16, serving, 27 windows)")
    failures, errs = [], []
    res = {"ms": 0.0, "plain_ms": 0.0, "two_launch_ms": 0.0, "bound": Bound(),
           "differing": 0, "elements": 0, "library_ms": None}
    train = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound()}
    g = torch.Generator().manual_seed(gen_seed)
    for i, (name, c, heads, dims) in enumerate(BLOCK_GEOMETRIES):
        pair = make_pair(c, heads, g)
        x = torch.randn((BATCH, *dims, c), generator=g).to("cuda",
                                                          torch.bfloat16)
        toks = tuple((0.5 * torch.randn((64, c), generator=g)).cuda()
                     for _ in range(2))
        with torch.inference_mode():
            x_win, ops0, ops1, labels, plan, _ = pair.pair_windows(x, toks)

            def two_launch(xs, d0=NO_DROPOUT, d1=NO_DROPOUT):
                x1 = fused_swin_block(xs, ops0, None, d0)
                x2 = fused_swin_block(plan_gather(x1, plan.index), ops1,
                                      labels, d1)
                return plan_gather(x2, plan.inverse)

            ref = pair_reference(x_win, ops0, ops1, labels, plan)
            out = fused_swin_pair(x_win, ops0, ops1, labels, plan)
            chain = two_launch(x_win)
            torch.cuda.synchronize()
            tag = (f"{name} C{c} h{heads} {'x'.join(map(str, dims))} "
                   f"BP{x_win.shape[0] * x_win.shape[1]} M{x_win.shape[2]} "
                   f"N{x_win.shape[2] + ops0.n_ext}")
            errs.append(check_close(tag, out, ref, failures))
            differ = int((out != chain).sum())
            res["differing"] += differ
            res["elements"] += out.numel()
            check_close(f"{tag} vs two launches", out, chain, failures)
            t_k = cuda_ms(lambda: fused_swin_pair(x_win, ops0, ops1, labels,
                                                  plan))
            t_2 = cuda_ms(lambda: two_launch(x_win))
            t_p = cuda_ms(lambda: pair_reference(x_win, ops0, ops1, labels,
                                                 plan), 3)
            shapes = {"B1": launch_info(x_win, ops0),
                      "B5": pair_launch_info(x_win, ops0, ops1, labels, plan)}
            # Dropout (the train path's instantiation) at the batch of 2.
            d0 = Dropout((2000 + 4 * i, 2001 + 4 * i), DROP_RATE, DROP_RATE)
            d1 = Dropout((2002 + 4 * i, 2003 + 4 * i), DROP_RATE, DROP_RATE)
            xs = x_win[:TRAIN_BATCH].contiguous()
            ref_d = pair_reference(xs, ops0, ops1, labels, plan, d0, d1)
            out_d = fused_swin_pair(xs, ops0, ops1, labels, plan, d0, d1)
            chain_d = two_launch(xs, d0, d1)
            torch.cuda.synchronize()
            errs.append(check_close(f"{tag} dropout batch {TRAIN_BATCH}",
                                    out_d, ref_d, failures))
            differ_d = int((out_d != chain_d).sum())
            t_kd = cuda_ms(lambda: fused_swin_pair(xs, ops0, ops1, labels,
                                                   plan, d0, d1))
            t_pd = cuda_ms(lambda: pair_reference(xs, ops0, ops1, labels,
                                                  plan, d0, d1), 3)
        res["bound"].add(*pair_work(x_win, ops0, ops1, labels))
        train["bound"].add(*pair_work(xs, ops0, ops1, labels))
        print(f"    kernel {t_k:.4f} ms, B1 + gather + B1 + gather {t_2:.4f} "
              f"ms, plain {t_p:.4f} ms; {differ} of {out.numel()} elements "
              f"differ from the two launches ({differ_d} with dropout); "
              f"launches: {shapes}; dropout batch {TRAIN_BATCH}: kernel "
              f"{t_kd:.4f} ms, plain {t_pd:.4f} ms")
        res["differing"] += differ_d
        res["elements"] += out_d.numel()
        res["ms"] += t_k
        res["two_launch_ms"] += t_2
        res["plain_ms"] += t_p
        train["ms"] += t_kd
        train["plain_ms"] += t_pd
    if failures:
        raise RuntimeError("phase B5 failed: " + "; ".join(failures))
    res["max_abs_err"] = max(errs)
    print(f"  B5: {res['ms']:.4f} ms per forward vs {res['two_launch_ms']:.4f} "
          f"ms for B1 + gather + B1 + gather (plain {res['plain_ms']:.4f}, "
          f"bound {res['bound'].ms:.4f} ({res['bound'].by})); "
          f"{res['differing']} of {res['elements']} elements differ")
    return res, train


def counters():
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import window_attention as wa
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .conv_fused import conv3x3_fused, conv3x3_fused_pair
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import fused_swin_block
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block_bwd import block_backward
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_pair import fused_swin_pair
    return {"B1": fused_swin_block, "B2": conv3x3_fused_pair,
            "B3": conv3x3_fused, "B4": block_backward, "B5": fused_swin_pair,
            "B6": wa.fused_window_attention_packed_qkv,
            "B7": wa.fused_window_attention_packed,
            "B8": wa.fused_window_attention}


# The per-sample input shape of each kernel the Swin output layer runs
# (``launches_by_shape``; no other call of any layout has these shapes):
# B1, B4 and B6 (P, M, C), 512 windows of 8x8x4 at C 48; B2 (D, H, W, Ca).
OUT_SHAPES = {"B1": (512, 256, 48), "B2": (128, 128, 8, 48),
              "B4": (512, 256, 48), "B6": (512, 256, 48)}


def counter_keys() -> list:
    """The keys of :func:`read_counters`: each kernel's launches, and
    ``"<kernel>@out"``, those of them at the output layer's shape."""
    return list(counters()) + [k + "@out" for k in OUT_SHAPES]


def expect(per_step: dict, times: int = 1) -> dict:
    """Every counter's expected launches: ``per_step`` times ``times``,
    0 for the counters it does not name."""
    return {k: per_step.get(k, 0) * times for k in counter_keys()}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0
        for key in ("factor_launches", "big_launches"):
            if hasattr(fn, key):
                setattr(fn, key, 0)
        if hasattr(fn, "launches_by_shape"):
            fn.launches_by_shape.clear()


def read_counters() -> dict:
    fns = counters()
    got = {k: fn.launches for k, fn in fns.items()}
    for k, shape in OUT_SHAPES.items():
        got[k + "@out"] = fns[k].launches_by_shape[shape]
    return got


def check_factor_form(launches: dict, failures: list) -> None:
    """Every B6/B7/B8 launch since the counters were reset built the bias
    from its factors (the unfused blocks pass them)."""
    for key, fn in counters().items():
        if hasattr(fn, "factor_launches") and \
                fn.factor_launches != launches[key]:
            failures.append(f"{key}: {fn.factor_launches} of "
                            f"{launches[key]} launches in the factor form")


def flagship_model():
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import flagship_conf
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    model = SwinUnetR(flagship_conf())
    init_weights(model, torch.Generator().manual_seed(SEED + 2))
    return model.cuda().eval()


def example_model():
    """The model of ``configurations/example_configs.yml`` (fp32 trunk,
    ``pad_mode: reference``, no prompts), found by the port's config
    lookup as the serving CLI finds it and built by ``infer.build_model``,
    with seeded random weights, on the card."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import load_conf
    from medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
        import build_model
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    model = build_model(load_conf("example_configs.yml"), device="cpu")
    init_weights(model, torch.Generator().manual_seed(SEED + 9))
    if model.conf.compute_dtype != "float32":
        raise RuntimeError("example_configs.yml no longer has an fp32 trunk")
    return model.cuda().eval()


def argmax_agreement(name: str, y, ref) -> float:
    """Share of voxels whose argmax class agrees; prints the logit and
    probability differences beside it."""
    import torch
    diff = (y - ref).abs()
    agree = (y.argmax(-1) == ref.argmax(-1)).float().mean().item()
    dp = (torch.softmax(y, -1) - torch.softmax(ref, -1)).abs()
    top2 = ref.topk(2, -1).values
    ties = ((top2[..., 0] - top2[..., 1]) < 2 * diff.max()).float().mean()
    print(f"  logits vs {name}: max_abs {diff.max().item():.6g}, mean_abs "
          f"{diff.mean().item():.6g}, max |logit| "
          f"{ref.abs().max().item():.4g}; probs max_abs "
          f"{dp.max().item():.6g}; argmax agreement {agree:.6f}; share of "
          f"voxels whose margin is under twice the max_abs (the only ones "
          f"that can flip) {ties.item():.6f}")
    return agree


def flip_failures(flipped, ref) -> list:
    """``flipped`` (a boolean per voxel of the reference logits ``ref``)
    held to the near-tie limits of the note on ``NEAR_TIE``."""
    top2 = ref.topk(2, -1).values
    near = (top2[..., 0] - top2[..., 1]) < NEAR_TIE * ref.abs().max()
    share = flipped.float().mean().item()
    near_share = near.float().mean().item()
    far = int((flipped & ~near).sum())
    print(f"    gate: flipped share {share:.6g} <= {FLIP_SHARE} x near-tie "
          f"share {near_share:.6g} (margin under {NEAR_TIE} x max |logit|); "
          f"flipped outside the near ties {far} == 0")
    failures = []
    if not share <= FLIP_SHARE * near_share:
        failures.append(f"flipped {share} of near-tie {near_share}")
    if far:
        failures.append(f"{far} voxels flipped outside the near ties")
    return failures


def logit_failures(y, ref) -> list:
    """Logits ``y`` against ``ref`` (``[windows, ..., classes]``) held to
    the limits of the note on ``NEAR_TIE``."""
    diff = (y - ref).abs().float()
    big = ref.abs().max().item()
    rel = diff.mean().item() / big
    win = diff.flatten(1).mean(1).max().item() / big
    print(f"    gate: mean_abs / max |logit| {rel:.6g} <= "
          f"{LOGIT_MEAN_TOL:.6g}; in the worst window {win:.6g} <= "
          f"{WINDOW_MEAN_TOL:.6g}")
    failures = []
    if not rel <= LOGIT_MEAN_TOL:
        failures.append(f"mean_abs / max {rel}")
    if not win <= WINDOW_MEAN_TOL:
        failures.append(f"worst window's mean_abs / max {win}")
    return failures + flip_failures(y.argmax(-1) != ref.argmax(-1), ref)


# The model's block paths: fused blocks (B1), unfused blocks (B6/B8),
# and fused blocks run as pairs (B5, MIVP_PAIR_KERNEL=1).
MODES = {"fused": "fused blocks", "unfused": "unfused blocks",
         "pair": "fused block pairs"}


def set_mode(model, mode: str):
    model.set_fused_block(mode != "unfused")
    return model.set_pair_kernel(mode == "pair")


def ct_windows():
    """The 27 windows of :func:`serve_volume` at stride 0.75 (its centre
    crop), intensity-windowed as serving windows them: ``[27, 128, 128,
    8, 1]`` fp32 on the card."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
        import device_scale_intensity
    from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel \
        import window_starts
    roi = (128, 128, 8)
    vol = serve_volume()
    slices, starts, _ = window_starts(vol.shape, roi, 0.75)
    crop = torch.from_numpy(np.ascontiguousarray(vol[slices])).cuda()
    x = torch.stack([crop[a:a + roi[0], b:b + roi[1], c:c + roi[2]]
                     for a, b, c in starts])[..., None]
    if x.shape[0] != BATCH:
        raise RuntimeError(f"{x.shape[0]} CT windows, not {BATCH}")
    return device_scale_intensity()(x)


def phase_model(model, per_forward: dict, mode: str = "fused",
                name: str = "flagship", gate_argmax: bool = True, x=None):
    """Forward of ``model`` (the flagship, or ``name``) on a 27-window
    batch: kernels vs plain versions (``PLAIN_CHUNK`` windows at a time);
    the unfused blocks and the block pairs also against the fused blocks
    on the same weights.  Launches, shape and finiteness always gate; the
    argmax agreement on this uniform-noise batch gates unless
    ``gate_argmax`` is off (then the served labels of :func:`phase_serve`
    carry the agreement gate, and the logits the limits of the note on
    ``NEAR_TIE``).  ``x`` replaces the noise batch (:func:`ct_windows`).
    Returns the kernel forward's ms (CUDA events) and its launches."""
    import torch
    label = MODES[mode]
    tag = "" if name == "flagship" else "-" + name
    print(f"phase model{'' if mode == 'fused' else '-' + mode}{tag}: {name} "
          f"SwinUnetR, {label}, {model.conf.compute_dtype} trunk, "
          f"[27, 128, 128, 8, 1] {'noise' if x is None else 'CT windows'}")
    if x is None:
        g = torch.Generator().manual_seed(SEED + 3)
        x = torch.rand((BATCH, 128, 128, 8, 1), generator=g).cuda()
    set_mode(model, mode)
    with torch.inference_mode():
        model.set_kernels(False)
        y_plain = torch.cat([model(x[i:i + PLAIN_CHUNK])
                             for i in range(0, BATCH, PLAIN_CHUNK)])
        model.set_kernels(True)
        reset_counters()
        y = model(x)
        torch.cuda.synchronize()
        got = read_counters()
        failures = []
        check_factor_form(got, failures)
        fwd_ms = cuda_ms(lambda: model(x), 5)
        y_fused = None if mode == "fused" else set_mode(model, "fused")(x)
        set_mode(model, mode)
    print(f"  launches per forward: {got}; forward {fwd_ms:.4f} ms "
          "(CUDA events)")
    if got != expect(per_forward):
        failures.append(f"expected launches {expect(per_forward)}, got {got}")
    if tuple(y.shape) != (BATCH, 128, 128, 8, 2) or \
            not torch.isfinite(y).all():
        failures.append(f"bad logits: shape {tuple(y.shape)}, finite "
                        f"{bool(torch.isfinite(y).all())}")
    refs = [("plain", y_plain)] + ([] if y_fused is None
                                   else [("fused blocks", y_fused)])
    for ref_name, ref in refs:
        agree = argmax_agreement(ref_name, y, ref)
        if gate_argmax:
            print(f"    gate: argmax agreement >= "
                  f"{MODEL_MIN_ARGMAX_AGREEMENT}")
            if not agree >= MODEL_MIN_ARGMAX_AGREEMENT:
                failures.append(f"argmax agreement vs {ref_name} {agree} < "
                                f"{MODEL_MIN_ARGMAX_AGREEMENT}")
            continue
        failures += [f"logits vs {ref_name}: {f}"
                     for f in logit_failures(y, ref)]
    if failures:
        raise RuntimeError(f"phase model ({label}) failed: "
                           + "; ".join(failures))
    return fwd_ms, got


def serve_volume(seed: int = SEED + 4):
    """The seeded 320x320x24 int16 CT volume: noise around 40 HU with a
    bright ellipsoid."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hu = rng.normal(40.0, 300.0, size=(320, 320, 24))
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in (320, 320, 24)),
                             indexing="ij")
    hu += 800.0 * ((zz ** 2 + yy ** 2 + (xx / 2) ** 2) < 0.3)
    return np.clip(hu, -1024, 3071).astype(np.int16)


def phase_serve(model, card: str, per_volume: dict, mode: str = "fused",
                name: str = "flagship"):
    """Serve a seeded 320x320x24 int16 volume through ``model`` (the
    flagship, or ``name``); kernels vs plain labels (the plain path in
    window batches of ``PLAIN_CHUNK``).
    Returns the launches of the timed run and the served volumes per
    second from disk and in memory."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import load_nifti, save_nifti
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        .transforms import load_served
    from medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
        import make_runner, predict_device, serve_volumes
    label = MODES[mode]
    tag = "" if name == "flagship" else "-" + name
    print(f"phase serve{'' if mode == 'fused' else '-' + mode}{tag}: "
          f"320x320x24 int16 CT, stride 0.75, coverage crop, {name} model, "
          f"{label}, {model.conf.compute_dtype} trunk")
    vol = serve_volume()
    conf = {"roi_size": [128, 128, 8]}
    set_mode(model, mode)
    runner = make_runner(conf, model, chunk=None, stride=0.75,
                         device_windowing=True, coverage="crop")
    plain_runner = make_runner(conf, model, chunk=PLAIN_CHUNK, stride=0.75,
                               device_windowing=True, coverage="crop")
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "ct.nii.gz"
        save_nifti(str(src), vol)
        model.set_kernels(False)
        plain_dst = Path(tmp) / "plain_seg.nii.gz"
        if serve_volumes(conf, None, [(src, plain_dst)],
                         runner=plain_runner) != (1, 0):
            raise RuntimeError("phase serve failed: plain-path serve")
        model.set_kernels(True)
        pairs = [(src, Path(tmp) / f"seg_{i}.nii.gz")
                 for i in range(SERVE_REPEATS)]
        # Warm-up at the timed run's length, so that every IO worker
        # process has started and imported its modules before the clock.
        if serve_volumes(conf, None, pairs, runner=runner) != \
                (SERVE_REPEATS, 0):
            raise RuntimeError("phase serve failed: warm-up serve")
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        done = serve_volumes(conf, None, pairs, runner=runner)
        dt = time.perf_counter() - t0
        launches = read_counters()
        failures = []
        check_factor_form(launches, failures)
        if done != (SERVE_REPEATS, 0):
            raise RuntimeError(f"phase serve failed: served {done}")
        plain = load_nifti(str(plain_dst))[0]
        labels = [load_nifti(str(d))[0] for _, d in pairs]
        decoded = load_served(str(src), True)     # as serve_volumes feeds it
    # In memory: the stitched forward, argmax and label download only.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_REPEATS):
        predict_device(runner, conf["roi_size"], decoded)[0].cpu()
    dt_mem = time.perf_counter() - t0
    vps = SERVE_REPEATS / dt
    vps_mem = SERVE_REPEATS / dt_mem
    agree = min(float((lab == plain).mean()) for lab in labels)
    print(f"  served {SERVE_REPEATS} volumes in {dt:.4f} s: {vps:.4f} vol/s "
          f"on {card} (from disk, pipelined host IO); in memory "
          f"{vps_mem:.4f} vol/s")
    print(f"  launches during the served run: {launches}")
    print(f"  label agreement vs plain path: {agree:.6f} "
          f"(min {SERVE_MIN_LABEL_AGREEMENT}); foreground share "
          f"{float((plain > 0).mean()):.4f}")
    want = expect(per_volume, SERVE_REPEATS)
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")
    if not agree >= SERVE_MIN_LABEL_AGREEMENT:
        failures.append(f"label agreement {agree}")
    if labels[0].shape != (320, 320, 24):
        failures.append(f"label volume shape {labels[0].shape}")
    if failures:
        raise RuntimeError(f"phase serve ({label}) failed: "
                           + "; ".join(failures))
    return launches, vps, vps_mem


def write_train_set(root: Path, volumes: int = TRAIN_VOLUMES) -> None:
    """Seeded synthetic CT set of ``volumes`` int16 HU volumes with a
    bright ellipsoid labelled 1 inside a body labelled 2 (2 is not an
    active label)."""
    import numpy as np
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import save_nifti
    rng = np.random.default_rng(SEED + 6)
    (root / "img").mkdir()
    (root / "msk").mkdir()
    for k in range(volumes):
        shape = (144 + 8 * (k % 3), 136 + 8 * (k % 2), 12 + k % 4)
        axes = [np.linspace(-1, 1, n) for n in shape]
        zz, yy, xx = np.meshgrid(*axes, indexing="ij")
        c = rng.uniform(-0.3, 0.3, 3)
        r = rng.uniform(0.25, 0.45)
        organ = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                 + ((xx - c[2]) / 2) ** 2) < r * r
        body = (zz ** 2 + yy ** 2) < 0.8
        hu = rng.normal(-800.0, 60.0, shape)
        hu[body] = rng.normal(40.0, 80.0, int(body.sum()))
        hu[organ] = rng.normal(300.0, 80.0, int(organ.sum()))
        mask = np.where(organ, 1, np.where(body, 2, 0))
        save_nifti(str(root / "img" / f"case{k:02d}.nii.gz"),
                   np.clip(hu, -1024, 3071).astype(np.int16))
        save_nifti(str(root / "msk" / f"case{k:02d}.nii.gz"),
                   mask.astype(np.int16))


def train_hparams(root: Path, **model) -> Namespace:
    """The flagship training config (the JAX package's
    ``tools/bench_train_step.py`` ``_base_conf``: ``flagship_conf`` with
    ``use_checkpoint`` and dropout 0.1/0.1, AdamW 5e-4 / 0.1, labels
    [0, 1]; ``model`` overrides its model fields) and a loader over
    ``root``."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import flagship_conf
    conf = dataclasses.asdict(flagship_conf(**{
        "use_checkpoint": True, "attn_drop": DROP_RATE,
        "proj_drop": DROP_RATE, **model}))
    conf.update(
        seed=SEED, lr_downstream=5e-4, weight_decay_downstream=0.1,
        active_labels_downstream=[0, 1], include_background=True,
        max_epochs_downstream=0, seg_input_size=[128, 128, 8],
        roi_size=[128, 128, 8], image_dir_downstream=str(root / "img"),
        mask_dir_downstream=str(root / "msk"), image_dict_key="image",
        mask_dict_key="mask", num_selected_data_downstream=-1,
        split_ratio=0.75, batch_size_downstream=TRAIN_BATCH,
        num_samples_downstream=2, num_workers=2, random_orientation=False,
        resize_content=False)
    return Namespace(**conf)


class _Quiet:
    def info(self, *args, **kwargs):
        pass


def run_trainer(hp, kernels: bool, pair: bool = False, fused: bool = True,
                validate: bool = False):
    """``SegmentationTrainer.train()`` on the card (block pairs as one
    call if ``pair``, the unfused blocks unless ``fused``, with the
    validation loader if ``validate``); returns the trainer, the
    launches of the run and its wall time."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import get_fit_loader_downstream
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        import SegmentationTrainer
    train_loader, val_loader = get_fit_loader_downstream(hp)
    tr = SegmentationTrainer(hp, SwinUnetR, train_loader,
                             val_loader if validate else None, _Quiet())
    tr.model.set_kernels(kernels).set_pair_kernel(pair)
    tr.model.set_fused_block(fused)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    return tr, read_counters(), time.perf_counter() - t0


def profile_steps(tr, hp, steps: int = 2, loaders=None):
    """Device time of ``steps`` training steps by kernel bucket
    (``torch.profiler``), and the device's idle share over them; the
    batches from ``loaders(hp)`` (default: the downstream fit loaders).
    Returns (busy ms per step, idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import get_fit_loader_downstream
    batches = []
    for batch in (loaders or get_fit_loader_downstream)(hp)[0]:
        batches.append(batch)
        if len(batches) == steps:
            break
    tr.train_step(batches[0])          # warm-up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            tr.train_step(batch)
        torch.cuda.synchronize()
    return print_profile(prof, steps, "kernel steps", "step")


# Trace event categories that are device work: kernels, copies and
# fills.  A user annotation's GPU span (``gpu_user_annotation``, e.g. the
# optimizer step's) covers device time but is not work of its own.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def device_work(evt) -> bool:
    """Whether a ``torch.profiler`` event is a kernel, a copy or a fill
    on the card (not a user annotation's span)."""
    import torch
    if evt.device_type != torch.autograd.DeviceType.CUDA or \
            getattr(evt, "is_user_annotation", False):
        return False
    kind = getattr(evt, "activity_type", None)
    return kind is None or str(kind).lower() in DEVICE_WORK


def busy_and_span(spans) -> tuple:
    """(busy, span) of device intervals ``[(start, end), ...]``: the
    length of their union and from the first start to the last end."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in spans) - spans[0][0]


def print_profile(prof, steps: int, what: str, unit: str):
    """Device time of a ``torch.profiler`` window of ``steps`` repeats by
    kernel bucket, the busiest kernels, and the device's idle share, over
    kernels, copies and fills only (:func:`device_work`); returns (busy
    ms per repeat, idle share)."""
    buckets = (("B1 fused_swin_block_kernel", ("fused_swin_block_kernel",)),
               ("B5 fused_swin_pair_kernel", ("fused_swin_pair_kernel",)),
               ("B4 fused_block_bwd_kernel + bwd_reduce_kernel",
                ("fused_block_bwd_kernel", "bwd_reduce_kernel")),
               ("B2 conv3x3 kernel", ("conv3x3",)),
               ("convolutions (cuDNN, fwd + bwd)",
                ("conv", "cudnn", "dgrad", "wgrad", "fprop", "implicit")),
               ("GEMMs (cuBLAS)", ("gemm", "cutlass", "xmma", "cublas")),
               ("optimizer (AdamW)", ("adam", "multi_tensor")),
               ("memcpy/memset", ("memcpy", "memset")),
               ("reductions", ("reduce",)),
               ("elementwise, copies, gathers", ("",)))
    sums = {name: 0.0 for name, _ in buckets}
    by_kernel, spans = {}, []
    for evt in prof.events():
        if not device_work(evt):
            continue
        us = evt.time_range.elapsed_us()
        spans.append((evt.time_range.start, evt.time_range.end))
        by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + us
        low = evt.name.lower()
        for name, keys in buckets:
            if any(k in low for k in keys):
                sums[name] += us
                break
    if not spans:
        print("  profiler: no device events recorded")
        return None, None
    busy, window = busy_and_span(spans)
    print(f"  profile of {steps} {what} (torch.profiler): device busy "
          f"{busy / 1e3 / steps:.3f} ms per {unit} of a "
          f"{window / 1e3 / steps:.3f} ms span, idle share "
          f"{1 - busy / window:.4f}")
    for name, _ in buckets:
        print(f"    {name}: {sums[name] / 1e3 / steps:.3f} ms per {unit}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    for name, us in top:
        print(f"      {us / 1e3 / steps:8.3f} ms  {name[:110]}")
    return busy / 1e3 / steps, 1 - busy / window


# (step median ms, device busy ms per step, idle share) of each profiled
# phase_train run, by phase name.
TRAIN_PROFILE = {}


def phase_train(card: str, pair: bool = False, two_launch=None,
                fp32: bool = False, layout=None):
    """``SegmentationTrainer.train()`` at the flagship training config:
    kernels vs plain versions on the same seeds and crops; with ``pair``
    each block pair runs as one call (B5), beside ``two_launch``, the
    losses and median step ms of the run without it; with ``fp32`` the
    trunk is fp32 (B1 and B4 read and write fp32 activations) and the run
    is two steps, not profiled; with ``layout`` = (``unetr_res_block``,
    ``per_step``) that decoder layout with a Swin output layer, three
    steps.  Returns the kernels' launches, their losses, and the median
    step ms with kernels and with plain versions."""
    import numpy as np
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import partition
    name = "train-pair" if pair else "train-fp32" if fp32 else \
        f"layouts-train-{layout[0]}-swin" if layout else "train"
    print(f"phase {name}: SegmentationTrainer.train(), flagship, "
          f"{'block pairs, ' if pair else ''}"
          f"{'fp32' if fp32 else 'bf16'} trunk, dropout {DROP_RATE}/"
          f"{DROP_RATE}, batch {TRAIN_BATCH} of 128x128x8")
    per_step = {"B5": 6, "B1": 6, "B4": 12} if pair else \
        layout[1] if layout else {"B1": 12, "B4": 12}
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # 3 volumes: 2 train volumes x 2 crops = 2 steps of batch 2; 4: 3.
        write_train_set(root, 3 if fp32 else 4 if layout
                        else TRAIN_VOLUMES)
        hp = train_hparams(root, compute_dtype="float32") if fp32 else \
            train_hparams(root, unetr_res_block=layout[0]) if layout else \
            train_hparams(root)
        plain, plain_launches, _ = run_trainer(hp, False, pair)
        tr, launches, wall = run_trainer(hp, True, pair)
        steps = len(tr.losses)
        print(f"  kernels: {steps} steps in {wall:.3f} s, launches {launches}")
        print(f"  plain versions: launches {plain_launches}")
        want = expect(per_step, steps)
        if steps < (2 if fp32 else 3 if layout else 5):
            failures.append(f"only {steps} training steps")
        if launches != want:
            failures.append(f"launches {launches}, expected {want} "
                            f"({per_step} per step)")
        if any(plain_launches.values()):
            failures.append(f"plain run launched kernels: {plain_launches}")
        if len(plain.losses) != steps:
            failures.append(f"plain run took {len(plain.losses)} steps")
        for i, (lk, lp) in enumerate(zip(tr.losses, plain.losses)):
            rel = abs(lk - lp) / max(abs(lp), 1e-12)
            line = (f"  step {i}: loss {lk:.6f} (kernels) vs {lp:.6f} "
                    f"(plain), rel {rel:.3g} (tol {TRAIN_LOSS_RTOL})")
            if two_launch is not None:
                line += f"; two launches per pair {two_launch[0][i]:.6f}"
            print(line)
            if not (np.isfinite(lk) and rel <= TRAIN_LOSS_RTOL):
                failures.append(f"step {i} loss {lk} vs {lp}")
        labels = partition.downstream_labels(tr.model_conf)
        n_train = 0
        for pname, p in tr.model.named_parameters():
            if partition.label_of(pname) not in labels:
                continue
            n_train += 1
            gr = p.grad
            if gr is None or not bool(gr.isfinite().all()) or \
                    not float(gr.abs().sum()) > 0:
                failures.append(f"trainable {pname}: gradient "
                                f"{'missing' if gr is None else 'bad'}")
        n_out = sum(1 for n, _ in tr.model.named_parameters()
                    if n.startswith("prompt_tokens.out"))
        if layout and n_out != 2:
            failures.append(f"{n_out} output-layer prompt tokens, not 2")
        print(f"  {n_train} trainable tensors ({n_out} of them the output "
              "layer's prompt tokens), each with a finite non-zero gradient"
              if not failures else f"  failures: {failures}")
        k_ms = float(np.median(tr.step_ms))
        p_ms = float(np.median(plain.step_ms))
        line = (f"  median step ms: kernels {k_ms:.3f}, plain {p_ms:.3f} "
                f"(host clock around each step, ending in its loss read) on "
                f"{card}")
        if two_launch is not None:
            line += f"; two launches per pair {two_launch[1]:.3f}"
        print(line)
        print(f"  steps ms kernels {[round(v, 3) for v in tr.step_ms]}; "
              f"plain {[round(v, 3) for v in plain.step_ms]}")
        if failures:
            raise RuntimeError(f"phase {name} failed: " + "; ".join(failures))
        del plain
        if not fp32:
            TRAIN_PROFILE[name] = (k_ms, *profile_steps(tr, hp))
    return launches, list(tr.losses), k_ms, p_ms


CLI_TEST_SHAPE = (320, 320, 24)
CLI_TEST_VOLUMES = 2
CLI_MIN_AGREEMENT = 0.999


def write_cli_set(root: Path) -> None:
    """Seeded synthetic NIfTI for the CLI: 3 downstream volumes (a bright
    organ labelled 5 inside a body labelled 3, which is not active) and
    two 320x320x24 int16 test volumes with masks."""
    import numpy as np
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import save_nifti
    rng = np.random.default_rng(SEED + 10)
    shapes = {"train": [(144 + 8 * k, 136 + 8 * (k % 2), 12 + k)
                        for k in range(3)],
              "test": [CLI_TEST_SHAPE] * CLI_TEST_VOLUMES}
    for split, dims in shapes.items():
        (root / f"{split}_img").mkdir()
        (root / f"{split}_msk").mkdir()
        for k, shape in enumerate(dims):
            zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in shape),
                                     indexing="ij")
            c = rng.uniform(-0.3, 0.3, 3)
            r = rng.uniform(0.25, 0.45)
            organ = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                     + ((xx - c[2]) / 2) ** 2) < r * r
            body = (zz ** 2 + yy ** 2) < 0.8
            hu = rng.normal(-800.0, 60.0, shape)
            hu[body] = rng.normal(40.0, 80.0, int(body.sum()))
            hu[organ] = rng.normal(300.0, 80.0, int(organ.sum()))
            mask = np.where(organ, 5, np.where(body, 3, 0))
            name = f"case{k:02d}.nii.gz"
            save_nifti(str(root / f"{split}_img" / name),
                       np.clip(hu, -1024, 3071).astype(np.int16))
            save_nifti(str(root / f"{split}_msk" / name),
                       mask.astype(np.int16))


def cli_config(root: Path, **over) -> str:
    """A copy of ``configurations/example_configs.yml`` (found by the
    port's config lookup) with the data directories of ``root``, one
    epoch after epoch 0 (``max_epochs_downstream: 1``; the YAML wins over
    the command line, so this is how the run is cut) and ``over``.
    Written as JSON, which YAML reads."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import load_conf
    conf = load_conf("example_configs.yml")
    conf.update(image_dir_downstream=str(root / "train_img"),
                mask_dir_downstream=str(root / "train_msk"),
                image_dir_test=str(root / "test_img"),
                mask_dir_test=str(root / "test_msk"),
                max_epochs_downstream=1, **over)
    path = root / f"cli_{len(list(root.glob('cli_*.yml')))}.yml"
    path.write_text(json.dumps(conf))
    return str(path)


def cli_args(configs: str, mode: str, run: str, *more: str) -> list:
    return ["--mode", mode, "--training-mode", "downstream", "--configs",
            configs, "--use-encoder-prompting", "--use-decoder-prompting",
            "--run-name", run, *more]


def cli_run(mode: str, argv: list):
    """``main.main`` on the card with the CLI's config for ``argv``;
    returns the trainer, its launches and wall seconds."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import get_full_configs
    hp = get_full_configs(cli_main.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    tr = cli_main.main(mode, hp)
    torch.cuda.synchronize()
    return tr, read_counters(), time.perf_counter() - t0


def phase_b4_device_memory(gen_seed: int = SEED + 11):
    """B4's device-memory form at the example config's four training
    calls of M 256, N 320 at C 192 (the 16x16x2 stages under the reference
    padding: enc2 with 16 heads, dec0 with 4; no shift and shift), fp32
    trunk, batch 2, dropout: against the plain version, twice with the
    same bits, timed beside it."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinTransformerBlock
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import PARAM_KEYS, Dropout
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block_bwd import (block_backward, block_backward_reference,
                                 launch_info)
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    print("phase b4-device-memory: B4 at M 256 / C 192 (reference "
          f"padding), fp32, batch {TRAIN_BATCH}, dropout {DROP_RATE}/"
          f"{DROP_RATE}, vs the plain version")
    failures, errs = [], []
    res = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound()}
    names = ("x", "bias", "ext_k", "ext_v", *PARAM_KEYS)
    g = torch.Generator().manual_seed(gen_seed)
    for name, heads in (("enc2", 16), ("dec0", 4)):
        for k, shift in enumerate(((0, 0, 0), (4, 4, 2))):
            blk = init_weights(SwinTransformerBlock(
                192, (8, 8, 4), 64, heads, 1, 64, shift_size=shift,
                pad_mode="reference", dtype=torch.float32,
                attn_drop=DROP_RATE, proj_drop=DROP_RATE), g).cuda()
            x = torch.randn((TRAIN_BATCH, 16, 16, 2, 192), generator=g).cuda()
            tok = (0.5 * torch.randn((64, 192), generator=g)).cuda()
            drop = Dropout((2000 + 2 * k, 2001 + 2 * k), DROP_RATE, DROP_RATE)
            with torch.no_grad():
                x_win, ops, labels, _ = blk.windows(x, tok)
            dout = torch.randn(x_win.shape, generator=g).cuda()
            tag = block_tag(name, 192, heads, (16, 16, 2), x_win, ops, labels)
            info = launch_info(x_win, ops, labels, drop)
            ref = block_backward_reference(x_win, dout, ops, labels, drop)
            big = block_backward.big_launches
            got = block_backward(x_win, dout, ops, labels, drop)
            again = block_backward(x_win, dout, ops, labels, drop)
            torch.cuda.synchronize()
            print(f"  B4 {tag}; launch {info}")
            if not info["big"] or block_backward.big_launches != big + 2:
                failures.append(f"B4 {tag}: not the device-memory form "
                                f"({info}, {block_backward.big_launches - big}"
                                " of 2 launches)")
            flat = lambda r: (r[0], *r[1])  # noqa: E731
            for gname, a, b, want in zip(names, flat(got), flat(again),
                                         flat(ref)):
                if want is None:
                    continue
                if not torch.equal(a, b):
                    failures.append(f"B4 {tag} d{gname}: two runs differ")
                errs.append(check_close(f"  d{gname}", a, want, failures,
                                        GRAD_TOL, 1e-6))
            t_k = cuda_ms(lambda: block_backward(x_win, dout, ops, labels,
                                                 drop))
            t_p = cuda_ms(lambda: block_backward_reference(
                x_win, dout, ops, labels, drop), 3)
            res["bound"].add(*block_bwd_work(x_win, ops, labels))
            res["ms"] += t_k
            res["plain_ms"] += t_p
            print(f"    kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    if failures:
        raise RuntimeError("phase b4-device-memory failed: "
                           + "; ".join(failures))
    res["max_abs_err"] = max(errs)
    return res


def kernels_only(model) -> bool:
    return all(m.use_kernels for m in model.modules()
               if hasattr(m, "use_kernels"))


def test_forwards(tr, blend: str) -> int:
    """Model forwards of ``tr.test()`` over its test volumes: chunks of
    10 windows (``none``) or the stitcher's batches (``gaussian``)."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel \
        import window_starts
    roi = tuple(tr.hparams.roi_size)
    n = window_starts(CLI_TEST_SHAPE, roi, None)[1].shape[0]
    per = -(-n // 10) if blend == "none" else (1 if n <= 32 else -(-n // 16))
    return CLI_TEST_VOLUMES * per, CLI_TEST_VOLUMES * n


def phase_cli(card: str):
    """The downstream workflow through the training CLI (``main.main``)
    and the serving CLI at ``example_configs.yml``'s full width (hidden
    48/96/192/384, roi 128x128x8, 64+64 prompt tokens, fp32 trunk,
    ``pad_mode: reference``, dropout 0.1/0.1, ``use_checkpoint``): fit
    epochs 0-1 saving ``0001.ckpt``, fit resumed from it (epoch 1), test
    from it per window and Gaussian-stitched, and ``infer --ckpt`` of one
    test volume."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config, infer
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import load_nifti
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        .transforms import load_served
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block_bwd import block_backward
    from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel \
        import window_starts
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        .common import adamw_leaves, load_adamw_leaves
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import initialization
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .checkpoint import load_checkpoint, save_checkpoint, tree_leaves
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .torch_import import to_flax_variables
    print("phase cli: main --mode fit|test --training-mode downstream and "
          "infer --ckpt, example_configs.yml (fp32 trunk, pad_mode "
          "reference, 64+64 prompt tokens, dropout 0.1/0.1)")
    failures, out = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_cli_set(root)
        config.DEFAULT_ROOT_LOG_DIR = root / "logs"   # the runs' logs
        cfg = cli_config(root)
        ckpt_dir = root / "prompt_tokens"
        ckpt = ckpt_dir / "0001.ckpt"

        # 1. fit, epochs 0-1, saving after epoch 0.
        fit, launches, wall = cli_run("fit", cli_args(
            cfg, "fit", "cli-fit", "--save-ckpt-prompt-tokens",
            "--save-ckpt-prompt-tokens-path", str(ckpt_dir)))
        big = block_backward.big_launches
        steps = len(fit.losses)
        val_steps = 2 * len(fit.val_loader)
        want = expect({"B1": 12, "B4": 12}, steps)
        want["B1"] += 12 * val_steps
        want["B2"] = 3 * val_steps
        print(f"  fit: {steps} steps + {val_steps} validation steps in "
              f"{wall:.3f} s, launches {launches} ({big} B4 in the "
              f"device-memory form); saved "
              f"{sorted(p.name for p in ckpt_dir.iterdir())}")
        if launches != want or big != 4 * steps:
            failures.append(f"fit launches {launches}, {big} B4 in the "
                            f"device-memory form, expected {want} and "
                            f"{4 * steps} (12 B1 + 12 B4, 4 of them in that "
                            "form, per step, 12 B1 + 3 B2 per validation "
                            "step)")
        if not ckpt.exists() or steps < 2:
            failures.append(f"fit: {steps} steps, checkpoint "
                            f"{ckpt.exists()}")
        out["fit_launches"] = launches

        # 2. fit resumed from the file: first the restored state, then
        # main.main on the same config.
        resume_args = cli_args(cfg, "fit", "cli-resume",
                               "--load-ckpt-prompt-tokens",
                               "--load-ckpt-prompt-tokens-path", str(ckpt))
        hp = config.get_full_configs(
            cli_main.build_parser().parse_args(resume_args))
        probe = initialization.select_trainer(hp, SwinUnetR, None, None,
                                              _Quiet(), None)
        t0 = time.perf_counter()
        start = probe.prepare_fit()
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
        saved = load_checkpoint(ckpt)
        got = tree_leaves(to_flax_variables(probe.model))
        ref = tree_leaves(saved["model_state_dict"])
        same_model = len(got) == len(ref) and all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(got, ref))
        got = adamw_leaves(probe.optimizer, probe.model)
        ref = saved["optimizer_state_dict"]["__flat_leaves__"]
        same_opt = len(got) == len(ref) and all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(got, ref))
        print(f"  resume: start epoch {start}; model state bit-identical to "
              f"the file {same_model} ({len(ref)} optimizer leaves, "
              f"identical {same_opt}); trainer build + restore "
              f"{load_ms:.3f} ms")
        if start != 1 or not same_model or not same_opt:
            failures.append(f"resume: start {start}, model {same_model}, "
                            f"optimizer {same_opt}")
        t0 = time.perf_counter()
        path = save_checkpoint(root / "timed.ckpt", 1,
                               to_flax_variables(probe.model),
                               adamw_leaves(probe.optimizer, probe.model),
                               {"epoch": 1})
        save_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = load_checkpoint(path)
        probe._restore_model(back)
        load_adamw_leaves(probe.optimizer, probe.model,
                          back["optimizer_state_dict"])
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        print(f"  checkpoint of {path.stat().st_size} bytes: save "
              f"{save_ms:.3f} ms, load + restore {restore_ms:.3f} ms (host "
              f"clock, model on the card) on {card}")
        del probe
        resumed, launches, wall = cli_run("fit", resume_args)
        rbig = block_backward.big_launches
        rsteps = len(resumed.losses)
        rval = len(resumed.val_loader)
        want = expect({"B1": 12, "B4": 12}, rsteps)
        want["B1"] += 12 * rval
        want["B2"] = 3 * rval
        print(f"  resumed fit: {rsteps} steps + {rval} validation steps "
              f"in {wall:.3f} s, launches {launches} ({rbig} B4 in the "
              "device-memory form)")
        if launches != want or rbig != 4 * rsteps or \
                resumed.start_epoch != 1:
            failures.append(f"resumed fit launches {launches}, {rbig} B4 in "
                            f"the device-memory form, expected {want} and "
                            f"{4 * rsteps}, start {resumed.start_epoch}")
        losses = fit.losses + resumed.losses
        if not all(np.isfinite(losses)):
            failures.append(f"non-finite losses {losses}")
        step_ms = float(np.median(fit.step_ms + resumed.step_ms))
        print(f"  losses {[round(v, 5) for v in losses]}")
        print(f"  fit step ms median {step_ms:.3f} over "
              f"{len(losses)} steps (host clock around each step, ending in "
              f"its loss read) on {card}")
        out.update(resume_launches=launches, big_launches=big + rbig,
                   step_ms=step_ms, save_ms=save_ms, load_ms=restore_ms)

        # 3-4. test from the file, both protocols; the per-window one
        # again through the plain versions.
        test_launches = {}
        preds = {}
        for blend in ("none", "gaussian"):
            bcfg = cli_config(root, test_blending=blend)
            tr, launches, wall = cli_run("test", cli_args(
                bcfg, "test", f"cli-test-{blend}",
                "--load-ckpt-prompt-tokens", "--load-ckpt-prompt-tokens-path",
                str(ckpt_dir)))
            forwards, windows = test_forwards(tr, blend)
            want = expect({"B1": 12, "B2": 3}, forwards)
            log = (Path(tr.hparams.log_dir) / "log.txt").read_text()
            lines = [ln.split("Message: ")[-1] for ln in log.splitlines()
                     if "+/-" in ln]
            print(f"  test {blend}: {windows} windows in {wall:.3f} s "
                  f"({windows / wall:.3f} windows/s, whole main.main call "
                  f"incl. checkpoint and volume loads) on {card}; "
                  f"launches {launches}; {lines}")
            print(f"    per volume {tr.metric_vals}")
            if launches != want or not kernels_only(tr.model):
                failures.append(f"test {blend}: launches {launches}, "
                                f"expected {want}")
            if len(lines) != 2:
                failures.append(f"test {blend}: +/- lines {lines}")
            out[f"test_{blend}_wps"] = windows / wall
            test_launches = {k: test_launches.get(k, 0) + v
                             for k, v in launches.items()}
            # The labels of the test's protocol, again on the kernels.
            volumes = tr._test_windows if blend == "none" else \
                tr._test_gaussian
            preds[blend] = {name: pred.cpu().numpy()
                            for name, _, pred in volumes()}
            if blend == "none":
                tr.model.set_kernels(False)
                reset_counters()
                plain_preds = {name: pred.cpu().numpy()
                               for name, _, pred in volumes()}
                plain = read_counters()
                agree = min(float((plain_preds[k] == v).mean())
                            for k, v in preds["none"].items())
                print(f"    per-window argmax vs the plain path on the same "
                      f"windows: {agree:.6f} (min {CLI_MIN_AGREEMENT}); "
                      f"plain launches {plain}")
                if any(plain.values()) or not agree >= CLI_MIN_AGREEMENT:
                    failures.append(f"test none vs plain: agreement {agree}"
                                    f", plain launches {plain}")
            del tr
        out["test_launches"] = test_launches

        # 5. infer --ckpt of the first test volume.
        src = root / "test_img" / "case00.nii.gz"
        dst = root / "case00_seg.nii.gz"
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        infer.main(["--configs", cfg, "--ckpt", str(ckpt), "--input",
                    str(src), "--output", str(dst), "--coverage", "crop",
                    "--use-encoder-prompting", "--use-decoder-prompting"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        labels = load_nifti(str(dst))[0]
        crop = window_starts(labels.shape, tuple(resumed.hparams.roi_size),
                             None)[0]
        gauss = preds["gaussian"]["case00.nii"]
        agree = float((labels[crop] == gauss).mean()) \
            if labels[crop].shape == gauss.shape else 0.0
        want = expect({"B1": 12, "B2": 3}, test_forwards(
            resumed, "gaussian")[0] // CLI_TEST_VOLUMES)
        print(f"  infer --ckpt: {wall:.3f} s, launches {launches}; labels "
              f"vs the Gaussian test's argmax {agree:.6f} (min "
              f"{CLI_MIN_AGREEMENT}); foreground share "
              f"{float((labels > 0).mean()):.4f}")
        if launches != want:
            failures.append(f"infer launches {launches}, expected {want}")
        if not agree >= CLI_MIN_AGREEMENT:
            failures.append(f"infer vs test agreement {agree}")
        out["infer_launches"] = launches
        # The same checkpoint and volume served with the intensities
        # windowed on the host, as the test loader windows them (infer
        # windows the raw upload on the device by default).
        conf = config.load_conf(cfg, use_encoder_prompting=True,
                                use_decoder_prompting=True)
        runner = infer.make_runner(conf, infer.load_model(conf, ckpt),
                                   stride=0.5, device_windowing=False,
                                   coverage="crop")
        host = infer.predict_device(runner, tuple(conf["roi_size"]),
                                    load_served(str(src), False))[0]
        host = host.cpu().numpy()
        host_agree = float((host == gauss).mean()) \
            if host.shape == gauss.shape else 0.0
        print(f"  infer with host windowing (device_windowing=False): labels "
              f"vs the Gaussian test's argmax {host_agree:.6f}; vs infer "
              f"--ckpt's {float((host == labels[crop]).mean()):.6f}")
        out["host_windowing_agreement"] = host_agree
    if failures:
        raise RuntimeError("phase cli failed: " + "; ".join(failures))
    return out


# Phase layouts: the flagship widths in the other decoder layouts.  A
# Swin output layer (unetr_res_block simple/full with unetr_up_block swin)
# adds one SwinUpBlock at 128x128x8: 2 B1 (C 48, 4 heads, M 256, N 320,
# 512 windows per image) and 1 B2 (48 + 48 -> 48) per forward; the
# "@out" counts are those launches (OUT_SHAPES), of the totals beside them.
OUTPUT_LAYER = ("out", 48, 4, (128, 128, 8))
LAYOUT_FORWARD = {"B1": 14, "B2": 4, "B1@out": 2, "B2@out": 1}
UNETR_FORWARD = {"B1": 6}
# The output layer's pair shifts the depth axis (128x128x8 > window 8x8x4
# on every axis), which ``pair_plan`` leaves to two block calls.
LAYOUT_PAIR = {"B5": 6, "B1": 2, "B2": 4, "B1@out": 2, "B2@out": 1}
# Unfused: the output layer's two blocks run B6 (C <= 128).
LAYOUT_UNFUSED = {"B6": 10, "B8": 4, "B2": 4, "B6@out": 2, "B2@out": 1}
LAYOUT_TRAIN = {"B1": 14, "B4": 14, "B1@out": 2, "B4@out": 2}


def phase_layout_kernels(gen_seed: int = SEED + 12):
    """B1, B6 and B2 at the Swin output layer's shapes, 27 windows (B1 and
    B6 no-shift and shift, the shift on every axis, depth included; their
    plain versions one image at a time), and B4 there at the training
    batch with dropout."""
    import torch
    import torch.nn.functional as F
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .conv_fused import (conv3x3_fused_pair, conv_pair_reference,
                            kernel_weight, tile_info)
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import (PARAM_KEYS, Dropout, block_reference,
                             fused_swin_block, launch_info)
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import fused_block_bwd as fbb
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import window_attention as wa
    name, c, heads, dims = OUTPUT_LAYER
    print("phase layouts-kernels: B1, B6 and B2 at the Swin output layer's "
          f"shapes (C {c}, {heads} heads, {'x'.join(map(str, dims))}, "
          f"{BATCH} windows; bf16), B4 there at batch {TRAIN_BATCH} with "
          f"dropout {DROP_RATE}/{DROP_RATE}")
    failures = []
    g = torch.Generator().manual_seed(gen_seed)
    b1 = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "errs": [],
          "launch": []}
    b4 = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "errs": [],
          "launch": []}
    b6 = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "errs": [],
          "launch": []}
    names = ("x", "bias", "ext_k", "ext_v", *PARAM_KEYS)
    for j, shift in enumerate(((0, 0, 0), (4, 4, 2))):
        blk = make_block(c, heads, shift, g, DROP_RATE)
        x = torch.randn((BATCH, *dims, c), generator=g).to(
            "cuda", torch.bfloat16)
        tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
        # B4 at the training batch (1024 windows), dropout on; before the
        # inference-mode B1 calls, whose operands the block caches.
        xt = x[:TRAIN_BATCH].contiguous()
        drop = Dropout((3000 + 2 * j, 3001 + 2 * j), DROP_RATE, DROP_RATE)
        with torch.no_grad():
            xt_win, ops_t, labels_t, _ = blk.windows(xt, tok)
        dout = torch.randn(xt_win.shape, generator=g).to(
            "cuda", torch.bfloat16)
        ref_dx, ref_g = fbb.block_backward_reference(xt_win, dout, ops_t,
                                                     labels_t, drop)
        dx, got_g = fbb.block_backward(xt_win, dout, ops_t, labels_t, drop)
        torch.cuda.synchronize()
        tag = block_tag(name, c, heads, dims, xt_win, ops_t, labels_t)
        info = fbb.launch_info(xt_win, ops_t, labels_t, drop)
        b4["launch"].append(info)
        print(f"  B4 {tag}; launch {info}")
        for gname, got, want in zip(names, (dx, *got_g), (ref_dx, *ref_g)):
            if want is not None:
                b4["errs"].append(check_close(f"  d{gname}", got, want,
                                              failures, GRAD_TOL, 1e-6))
        t_bk = cuda_ms(lambda: fbb.block_backward(xt_win, dout, ops_t,
                                                  labels_t, drop))
        t_bp = cuda_ms(lambda: fbb.block_backward_reference(
            xt_win, dout, ops_t, labels_t, drop), 2)
        b4["bound"].add(*block_bwd_work(xt_win, ops_t, labels_t))
        b4["ms"] += t_bk
        b4["plain_ms"] += t_bp
        print(f"    B4 kernel {t_bk:.4f} ms, plain {t_bp:.4f} ms")
        with torch.inference_mode():
            x_win, ops, labels, _ = blk.windows(x, tok)

            def plain():
                return torch.cat([block_reference(x_win[i:i + 1], ops,
                                                  labels)
                                  for i in range(BATCH)])
            ref = plain()
            out = fused_swin_block(x_win, ops, labels)
            torch.cuda.synchronize()
            tag = block_tag(name, c, heads, dims, x_win, ops, labels)
            b1["errs"].append(check_close(f"B1 {tag}", out, ref, failures))
            t_k = cuda_ms(lambda: fused_swin_block(x_win, ops, labels))
            t_p = cuda_ms(plain, 2)
            del ref, out
        info = launch_info(x_win, ops, labels)
        b1["launch"].append(info)
        b1["bound"].add(*block_work(x_win, ops, labels))
        b1["ms"] += t_k
        b1["plain_ms"] += t_p
        print(f"    B1 kernel {t_k:.4f} ms, plain {t_p:.4f} ms; launch {info}")
        # B6 as the unfused block calls it: the content rows and the prompt
        # rows apart, the bias as its factor tables.
        blk.fused_block = False
        at = blk.attn
        ws = tuple(lin.weight.t() for lin in (at.to_q, at.to_k, at.to_v))
        scale = (c // heads) ** -0.5
        with torch.inference_mode():
            x_win, ops, labels, _ = blk.windows(x, tok)
            y = blk.attn_input(x_win, tok)
            m, n = x_win.shape[2], y.shape[2]
            yc, yp = y[:, :, :m].contiguous(), y[0, 0, m:].contiguous()
            wqkv = at.kernel_weight()

            def b6_kernel():
                return wa.fused_window_attention_packed_qkv_prompts(
                    yc, yp, *ws, ops.bias, labels, scale, heads, wqkv=wqkv,
                    factors=ops.factors)

            def b6_plain():
                return torch.cat([
                    wa.fused_window_attention_packed_qkv_reference(
                        y[i:i + 1], *ws, m, ops.bias, labels, scale, heads)
                    for i in range(BATCH)])
            ref = b6_plain()
            out = b6_kernel()
            torch.cuda.synchronize()
            bp = BATCH * x_win.shape[1]
            tag = (f"{name} C{c} h{heads} BP{bp} M{m} N{n} "
                   f"{'shift' if labels is not None else 'noshift'}")
            b6["errs"].append(check_close(f"B6 {tag}", out, ref, failures))
            del ref, out
            t_k = cuda_ms(b6_kernel)
            t_p = cuda_ms(b6_plain, 2)
        info = wa.launch_info(bp, m, n, c, heads, True, factors=ops.factors,
                              hoisted=True)
        b6["launch"].append(info)
        b6["bound"].add(*attention_work(bp, m, n, c, heads, labels, True,
                                        ops.factors))
        b6["ms"] += t_k
        b6["plain_ms"] += t_p
        print(f"    B6 kernel {t_k:.4f} ms, plain {t_p:.4f} ms; launch {info}")
    # B2: the output layer's conv, 48 + 48 -> 48 over 128x128x8.
    ca = cb = co = c
    cin = ca + cb
    xa = torch.randn((BATCH, *dims, ca), generator=g).to("cuda",
                                                         torch.bfloat16)
    xb = torch.randn((BATCH, *dims, cb), generator=g).to("cuda",
                                                         torch.bfloat16)
    w = (torch.randn((co, cin, 3, 3, 3), generator=g)
         * (27 * cin) ** -0.5).cuda()
    bias = (0.1 * torch.randn(co, generator=g)).cuda()
    scale = (0.5 + torch.rand(cin, generator=g)).cuda()
    shift = (1.0 + torch.randn(cin, generator=g)).cuda()
    w27 = kernel_weight(w)
    with torch.inference_mode():
        ref = conv_pair_reference(xa, xb, w, bias, scale, shift)
        out = conv3x3_fused_pair(xa, xb, w, bias, scale, shift, w27=w27)
        torch.cuda.synchronize()
        tag = f"B2 {name} {ca}+{cb}->{co} @{'x'.join(map(str, dims))}"
        b2_err = check_close(tag, out, ref, failures)
        del ref, out
        t_k = cuda_ms(lambda: conv3x3_fused_pair(xa, xb, w, bias, scale,
                                                 shift, w27=w27))
        t_p = cuda_ms(lambda: conv_pair_reference(xa, xb, w, bias, scale,
                                                  shift), 3)
        xc = torch.cat([xa, xb], -1).permute(0, 4, 1, 2, 3)
        wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        t_l = cuda_ms(lambda: F.conv3d(xc, wb, bb, padding=1))
    tile = tile_info((BATCH, *dims), co)
    vox = BATCH * dims[0] * dims[1] * dims[2]
    b2_bound = Bound()
    b2_bound.add(2 * vox * co * 27 * cin,
                 vox * cin * 2 + 27 * cin * co * 2 + cin * 8 + co * 4
                 + vox * co * 2)
    print(f"    B2 kernel {t_k:.4f} ms, plain {t_p:.4f} ms, cuDNN conv3d "
          f"without the prologue {t_l:.4f} ms, bound {b2_bound.ms:.4f} "
          f"({b2_bound.by}); tile {tile}")
    print(f"  output layer per forward: B1 {b1['ms']:.4f} ms (plain "
          f"{b1['plain_ms']:.4f}, bound {b1['bound'].ms:.4f} "
          f"({b1['bound'].by})), B6 on the unfused path {b6['ms']:.4f} ms "
          f"(plain {b6['plain_ms']:.4f}, bound {b6['bound'].ms:.4f} "
          f"({b6['bound'].by})), B2 {t_k:.4f} ms; per training step B4 "
          f"{b4['ms']:.4f} ms (plain {b4['plain_ms']:.4f}, bound "
          f"{b4['bound'].ms:.4f} ({b4['bound'].by}))")
    if failures:
        raise RuntimeError("phase layouts-kernels failed: "
                           + "; ".join(failures))
    for r in (b1, b4, b6):
        r["max_abs_err"] = max(r.pop("errs"))
    b2 = {"ms": t_k, "plain_ms": t_p, "bound": b2_bound, "library_ms": t_l,
          "max_abs_err": b2_err, "tile": tile}
    return b1, b2, b4, b6


def layout_model(res: str, up: str, seed: int):
    """The flagship config in decoder layout (``res``, ``up``), seeded
    random weights, on the card, in eval mode."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import flagship_conf
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    model = SwinUnetR(flagship_conf(unetr_res_block=res, unetr_up_block=up))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.cuda().eval()


def profile_forward(model, x, repeats: int = 2) -> None:
    """Device time of ``repeats`` forwards of ``model`` on ``x`` by kernel
    bucket (``torch.profiler``), and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(x)                       # warm-up outside the window
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                model(x)
            torch.cuda.synchronize()
    print_profile(prof, repeats, "27-window forwards", "forward")


def phase_layout_stitch(model, card: str):
    """The per-window stitcher (``BucketedInference(mode="per_window")``)
    on the served volume: equal to the argmax of the model's forward on
    the same 27 windows, and its labels against the plain forward's logits
    there under the limits of the note on ``NEAR_TIE``; then
    ``infer.watch_directory`` with ``max_polls`` on a directory of two
    volumes, against ``serve_volumes`` of the same files."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import load_nifti, save_nifti
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        .transforms import load_served
    from medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
        import make_runner, resolve_io, serve_volumes, watch_directory
    from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel \
        import window_starts
    conf = {"roi_size": [128, 128, 8]}
    roi = tuple(conf["roi_size"])
    failures = []
    print("phase layouts-stitch: per-window argmax of the served volume "
          "(stride 0.75, crop), kernels vs plain; infer --watch of two "
          "volumes vs serve_volumes")
    with tempfile.TemporaryDirectory() as tmp:
        inbox = Path(tmp) / "in"
        inbox.mkdir()
        for k, seed in enumerate((SEED + 4, SEED + 14)):
            save_nifti(str(inbox / f"ct_{k}.nii.gz"), serve_volume(seed))
        decoded = load_served(str(inbox / "ct_0.nii.gz"), True)
        slices, _, _ = window_starts(decoded.shape[:3], roi, 0.75)
        cropped = np.ascontiguousarray(decoded[slices])
        runner = make_runner(conf, model, stride=0.75, coverage="crop",
                             mode="per_window")
        with torch.inference_mode():
            reset_counters()
            preds = runner(cropped)
            torch.cuda.synchronize()
            pw_launches = launches = read_counters()
            t_ms = cuda_ms(lambda: runner(cropped), 3)
            x = ct_windows()
            direct = model(x).argmax(-1)
            model.set_kernels(False)
            plain = torch.cat([model(x[i:i + PLAIN_CHUNK])
                               for i in range(0, BATCH, PLAIN_CHUNK)])
            model.set_kernels(True)
        agree = float((preds == plain.argmax(-1)).float().mean())
        same = torch.equal(preds, direct)
        print(f"  per window: {tuple(preds.shape)} labels, launches "
              f"{launches}, {t_ms:.4f} ms per volume (CUDA events) on "
              f"{card}; equal to the argmax of the model's forward on the "
              f"same 27 windows {same}; agreement with the plain forward's "
              f"argmax {agree:.6f}")
        failures += [f"per window vs plain: {f}" for f in flip_failures(
            preds != plain.argmax(-1), plain)]
        if tuple(preds.shape) != (BATCH, *roi) or \
                launches != expect(LAYOUT_FORWARD) or not same:
            failures.append(f"per window: shape {tuple(preds.shape)}, "
                            f"launches {launches}, equal to the forward's "
                            f"argmax {same}")
        out_dir, ref_dir = Path(tmp) / "out", Path(tmp) / "ref"
        reset_counters()
        t0 = time.perf_counter()
        done = watch_directory(conf, model, inbox, out_dir, interval=0.0,
                               min_age=0.0, max_polls=2, stride=0.75,
                               coverage="crop")
        wall = time.perf_counter() - t0
        launches = read_counters()
        ref = serve_volumes(conf, model, resolve_io([str(inbox)],
                                                    str(ref_dir)),
                            stride=0.75, coverage="crop")
        equal = [np.array_equal(load_nifti(str(out_dir / n))[0],
                                load_nifti(str(ref_dir / n))[0])
                 for n in ("ct_0_seg.nii.gz", "ct_1_seg.nii.gz")]
        print(f"  watch: {done} (done, failed) over 2 polls in {wall:.3f} s, "
              f"launches {launches}; labels equal to serve_volumes' {equal}")
        if done != (2, 0) or ref != (2, 0) or not all(equal) or \
                launches != expect(LAYOUT_FORWARD, 2):
            failures.append(f"watch {done}, serve {ref}, equal {equal}, "
                            f"launches {launches}")
    if failures:
        raise RuntimeError("phase layouts-stitch failed: "
                           + "; ".join(failures))
    return {"per_window_launches": pw_launches, "per_window_ms": t_ms,
            "watch_launches": launches}


def phase_layouts(card: str):
    """The flagship widths (depth 3, hidden 48/96/192/384, window 8x8x4,
    64 + 64 prompt tokens, bf16 trunk, ``pad_mode: aligned``) in the other
    decoder layouts: ``full``/``swin`` (skip blocks and bottleneck
    ``UnetrBasicBlock``s, a Swin output layer with its two prompt tokens)
    through its kernels at the output layer's shapes, a 27-window forward
    on each block path, the served volume, the per-window stitcher and
    ``infer --watch``, and three prompt-tuning steps; ``none``/``unetr``,
    ``simple``/``unetr`` and ``simple``/``swin`` through one forward each."""
    t0 = time.perf_counter()
    out = {"forward": {}}
    out["b1"], out["b2"], out["b4"], out["b6"] = phase_layout_kernels()
    model = layout_model("full", "swin", SEED + 13)
    # The seeded layout models leave 3-20% of voxels within the kernels'
    # noise of a tie (the flagship 0.2%), on noise and on CT windows
    # alike: as for the fp32 example model, their forwards' argmax
    # agreement is printed, the logits carry the limits of the note on
    # NEAR_TIE, and the served labels (stitched) the 0.999 gate.  Each
    # forward's launches (phase_model gates them to these counts) go to
    # out["forward"] under the path's name.
    x = ct_windows()
    _, out["forward"]["full-swin-noise"] = phase_model(
        model, LAYOUT_FORWARD, name="full-swin-noise", gate_argmax=False)
    out["fwd_ms"], out["forward"]["full-swin"] = phase_model(
        model, LAYOUT_FORWARD, name="full-swin", gate_argmax=False, x=x)
    profile_forward(model, x)
    out["serve"], out["vps"], out["vps_mem"] = phase_serve(
        model, card, LAYOUT_FORWARD, name="full-swin")
    out["stitch"] = phase_layout_stitch(model, card)
    out["pair_ms"], out["forward"]["full-swin-pair"] = phase_model(
        model, LAYOUT_PAIR, "pair", name="full-swin", gate_argmax=False, x=x)
    out["unfused_ms"], out["forward"]["full-swin-unfused"] = phase_model(
        model, LAYOUT_UNFUSED, "unfused", name="full-swin",
        gate_argmax=False, x=x)
    del model
    for k, (res, up, per) in enumerate((("none", "unetr", UNETR_FORWARD),
                                        ("simple", "unetr", UNETR_FORWARD),
                                        ("simple", "swin", LAYOUT_FORWARD))):
        model = layout_model(res, up, SEED + 15 + k)
        out[f"{res}-{up}_ms"], out["forward"][f"{res}-{up}"] = phase_model(
            model, per, name=f"{res}-{up}", gate_argmax=False, x=x)
        del model
    (out["train"], out["losses"], out["step_ms"],
     out["plain_step_ms"]) = phase_train(card, layout=("full", LAYOUT_TRAIN))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase layouts: {out['seconds']:.1f} s; full/swin forward "
          f"{out['fwd_ms']:.4f} ms (pairs {out['pair_ms']:.4f}, unfused "
          f"{out['unfused_ms']:.4f}), none/unetr {out['none-unetr_ms']:.4f}, "
          f"simple/unetr {out['simple-unetr_ms']:.4f}, simple/swin "
          f"{out['simple-swin_ms']:.4f} ms (CUDA events); served vol/s "
          f"from disk {out['vps']:.4f}, in memory {out['vps_mem']:.4f}; "
          f"train step median {out['step_ms']:.3f} ms (plain "
          f"{out['plain_step_ms']:.3f}) on {card}")
    return out


# The phase-2 students' crops (example_configs.yml) and their block
# geometries at patch 2, window 8x8x4, pad_mode aligned: (name, C, heads,
# spatial dims).  The 24x24x2 stage pad-folds its depth axis (M 128, N
# 193); 12x12x2, 20x20x2 and 10x10x2 pad H/W and depth materially (M 256).
STUDENT_CROPS = ((96, 96, 8), (80, 80, 8))
STUDENT_GEOMETRIES = tuple(
    (f"s{h}-{part}", c, heads, dims)
    for h, (s0, s1, s2) in ((96, ((48, 48, 4), (24, 24, 2), (12, 12, 2))),
                            (80, ((40, 40, 4), (20, 20, 2), (10, 10, 2))))
    for part, c, heads, dims in (
        ("enc0", 48, 4, s0), ("enc1", 96, 8, s1), ("enc2", 192, 16, s2),
        ("dec0", 192, 4, s2), ("dec1", 96, 4, s1), ("dec2", 48, 4, s0)))
# The students' decoder pair convs (eval mode: validation).
STUDENT_CONVS = tuple(
    (f"s{h}-{part}", ca, cb, co, dims)
    for h, grids in ((96, ((12, 12, 2), (24, 24, 2), (48, 48, 4))),
                     (80, ((10, 10, 2), (20, 20, 2), (40, 40, 4))))
    for (part, ca, cb, co), dims in zip(
        (("dec0", 384, 192, 192), ("dec1", 192, 96, 96),
         ("dec2", 96, 48, 48)), grids))
# Launches per phase-2 step: 3 forwards (2 students, the teacher) of 12
# B1; the backward of the students' trainable blocks (every block in the
# _all modes, the 6 decoder blocks in the _decoder ones); per validation
# step 3 eval forwards of 12 B1 + 3 B2.
PHASE2_STEP = {"B1": 36, "B4": 24}
PHASE2_DECODER_STEP = {"B1": 36, "B4": 12}
PHASE2_VAL = {"B1": 36, "B2": 9}
PHASE2_VOLUMES = 3   # split 0.8: 2 train x 4 crops = 4 steps, 1 val: 2


def write_pretrain_set(root: Path, volumes: int, seed: int) -> None:
    """Seeded synthetic CT set for phase 2: int16 HU volumes with masks
    labelled 0-5 (a body 2, two organs 1 and 3, a bone 5 and a small
    structure 4, which is not an active label)."""
    import numpy as np
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import save_nifti
    rng = np.random.default_rng(seed)
    (root / "img").mkdir()
    (root / "msk").mkdir()
    for k in range(volumes):
        shape = (144 + 8 * (k % 3), 136 + 8 * (k % 2), 12 + k % 4)
        zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in shape),
                                 indexing="ij")
        mask = np.where((zz ** 2 + yy ** 2) < 0.8, 2, 0)
        hu = rng.normal(-800.0, 60.0, shape)
        hu[mask == 2] = rng.normal(40.0, 80.0, int((mask == 2).sum()))
        for label, mean in ((1, 300.0), (3, 120.0), (5, 900.0), (4, 60.0)):
            c = rng.uniform(-0.4, 0.4, 3)
            r = rng.uniform(0.12, 0.3)
            blob = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                    + ((xx - c[2]) / 2) ** 2) < r * r
            mask[blob] = label
            hu[blob] = rng.normal(mean, 50.0, int(blob.sum()))
        save_nifti(str(root / "img" / f"case{k:02d}.nii.gz"),
                   np.clip(hu, -1024, 3071).astype(np.int16))
        save_nifti(str(root / "msk" / f"case{k:02d}.nii.gz"),
                   mask.astype(np.int16))


def pretrain_config(root: Path, **over) -> str:
    """``configurations/example_configs.yml`` with the flagship model
    (bf16 trunk, ``pad_mode: aligned``; its widths, window, prompts and
    dropout are the example's), the data of ``root``, and epoch 0 only
    (``max_epochs_students_teacher: 0``: the YAML wins over the command
    line), and ``over``.  The phase-2 section as published otherwise."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import load_conf
    conf = load_conf("example_configs.yml")
    conf.update(compute_dtype="bfloat16", pad_mode="aligned",
                image_dir_pretrain=str(root / "img"),
                image_dir_supervised=str(root / "img"),
                mask_dir_supervised=str(root / "msk"),
                max_epochs_students_teacher=0, **over)
    path = root / "pretrain.yml"
    path.write_text(json.dumps(conf))
    return str(path)


def pretrain_args(configs: str, mode: str, run: str, *more: str) -> list:
    return ["--mode", "fit", "--training-mode", mode, "--configs", configs,
            "--use-encoder-prompting", "--use-decoder-prompting",
            "--run-name", run, *more]


# Biases whose every path to the loss passes a normalization on batch
# statistics, which removes a per-channel constant: their true gradient is
# 0.  Phase 2: the patch embedding's conv, the bottleneck conv, and the
# MLP and LN2 biases of the last block of each up block but the last.
# Phase 1: the patch embedding's conv and each reconstruction conv before
# its instance norm.
def bn_cancelled(depth: int, phase1: bool = False) -> set:
    if phase1:
        return {"input_layer.0.bias"} | {
            f"extra_heads.reconstruction.{4 * i}.bias"
            for i in range(depth + 1)}
    names = {"input_layer.0.bias", "bottleneck.bias"}
    for j in range(depth - 1):
        blk = f"decoder_blocks.{j}.swin_layer.swin_blocks.1"
        names |= {f"{blk}.mlp.bias", f"{blk}.mlp_norm.bias"}
    return names


def check_gradients(tr, failures: list) -> int:
    """Every trainable gradient finite, and non-zero but where the true
    gradient is 0 (:func:`bn_cancelled`); returns the count checked."""
    zero_ok = bn_cancelled(tr.model_conf.depth_unet,
                           tr.model_conf.training_mode == PHASE1)
    n = 0
    for name, p in tr.model.named_parameters():
        if not p.requires_grad:
            continue
        n += 1
        gr = p.grad
        if gr is None or not bool(gr.isfinite().all()) or (
                name not in zero_ok and not float(gr.abs().sum()) > 0):
            failures.append(f"trainable {name}: gradient "
                            f"{'missing' if gr is None else 'bad'}")
    return n


def run_fit(hp, kernels: bool):
    """``main.main("fit", hp)`` on the card (kernels) or the same trainer
    with the plain versions (``setup_fitting`` + ``train()``, which is
    what ``main.main`` runs); returns the trainer, its launches and wall
    seconds."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import initialization
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    if kernels:
        tr = cli_main.main("fit", hp)
    else:
        tr = initialization.setup_fitting(hp, "cuda")
        tr.model.set_kernels(False)
        if hasattr(tr, "teacher"):
            tr.teacher.set_kernels(False)
        tr.train()
    torch.cuda.synchronize()
    return tr, read_counters(), time.perf_counter() - t0


def loss_device_ms(tr, batch) -> float:
    """Device ms of the clustered-prototype loss, forward and backward,
    at one step's shapes (the students' and the teacher's fp32 latents
    of the flagship width, the batch's coordinates and fresh jitters)."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.losses \
        import clustered_prototype_loss, draw_jitters
    conf = tr.hparams
    c0 = tr.model_conf.hidden_channels[0]
    g = torch.Generator().manual_seed(SEED + 14)
    b = conf.batch_size_students_teacher
    emb_s = [torch.randn((b, *crop, c0), generator=g).cuda().requires_grad_()
             for crop in conf.crop_size_students]
    emb_t = torch.randn((b, *conf.roi_size, c0), generator=g).cuda()
    coords = [torch.from_numpy(batch[f"coord_st_{i}"]).cuda()
              for i in range(len(emb_s))]
    coord = torch.from_numpy(batch["coord"]).cuda()
    jitters = draw_jitters(len(emb_s), float(conf.reduction_factor), g)

    def step():
        loss = clustered_prototype_loss(
            emb_s, emb_t, coords, coord, jitters,
            reduction_factor=float(conf.reduction_factor),
            k_means_iterations=int(conf.k_means_iterations),
            fwhm=float(conf.fwhm))
        loss.backward()

    return cuda_ms(step, 5)


def step_flops(tr) -> int:
    """Products of one training step of ``tr`` (a trainer on the plain
    versions: a kernel launch is not a torch op the counter sees) on its
    first batch, forward and backward: ``FlopCounterMode`` with grad on
    (``utils/flops.py::counted_flops`` is the no-grad form).  Prints
    them."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    batch = next(iter(tr.train_loader))
    with counter:
        tr.train_step(batch)
    flops = int(counter.get_total_flops())
    print(f"  one plain training step: {flops / 1e9:.3f} GFLOP of products "
          "(FlopCounterMode, forward and backward)")
    return flops


def phase_students_teacher(card: str):
    """Phase-2 students-teacher training through ``main --mode fit
    --training-mode ...`` at the flagship model with the example config's
    phase-2 section (roi 128x128x8, students 96x96x8 and 80x80x8, tau
    0.99, reduction 4, fwhm 128, 3 k-means iterations, batch 2, 4 crops
    per volume, 5 pretrain classes), on seeded synthetic volumes:
    ``supervised_learning_all`` for 4 steps + 2 validation steps with the
    kernels and with the plain versions from the same seeds (losses,
    launches, gradients, the epoch-0 checkpoint and a resume from it bit
    for bit, the teacher's EMA after one step), a profile of 2 steps, and
    ``self_supervised_learning_decoder`` for 2 steps (the encoder
    unchanged, 12 B4 per step)."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import get_fit_loader_supervised_learning
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR, partition
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        .common import grouped_adamw_leaves
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import initialization
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .checkpoint import load_checkpoint, tree_leaves
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .torch_import import to_flax_variables
    print("phase students-teacher: main --mode fit --training-mode "
          "supervised_learning_all / self_supervised_learning_decoder, "
          "flagship model (bf16, pad_mode aligned, 64+64 prompt tokens, "
          "dropout 0.1/0.1), example_configs.yml phase 2 (students 96x96x8 "
          "and 80x80x8, batch 2)")
    failures, out = [], {}

    def same(a, b) -> bool:
        a, b = tree_leaves(a), tree_leaves(b)
        return len(a) == len(b) and all(
            np.asarray(x).dtype == np.asarray(y).dtype
            and np.array_equal(x, y) for x, y in zip(a, b))

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        config.DEFAULT_ROOT_LOG_DIR = root / "logs"
        write_pretrain_set(root, PHASE2_VOLUMES, SEED + 15)
        cfg = pretrain_config(root)
        ckpt_dir = root / "backbone"
        argv = pretrain_args(cfg, "supervised_learning_all", "st-all",
                             "--save-ckpt-backbone",
                             "--save-ckpt-backbone-path", str(ckpt_dir))
        hp = config.get_full_configs(cli_main.build_parser().parse_args(argv))
        plain, plain_launches, _ = run_fit(hp, False)
        tr, launches, wall = run_fit(hp, True)
        steps, val_steps = len(tr.losses), len(tr.val_losses)
        want = expect(PHASE2_STEP, steps)
        for k, v in PHASE2_VAL.items():
            want[k] += v * val_steps
        print(f"  kernels: {steps} steps + {val_steps} validation steps in "
              f"{wall:.3f} s, launches {launches}")
        print(f"  plain versions: launches {plain_launches}")
        if steps != 4 or val_steps != 2:
            failures.append(f"{steps} steps and {val_steps} validation "
                            "steps, not 4 and 2")
        if launches != want:
            failures.append(f"launches {launches}, expected {want} "
                            f"({PHASE2_STEP} per step, {PHASE2_VAL} per "
                            "validation step)")
        if any(plain_launches.values()):
            failures.append(f"plain run launched kernels: {plain_launches}")
        for i, (lk, lp) in enumerate(zip(tr.losses + tr.val_losses,
                                         plain.losses + plain.val_losses)):
            kind = "step" if i < steps else "validation step"
            for key in ("prt", "seg", "tot"):
                rel = abs(lk[key] - lp[key]) / max(abs(lp[key]), 1e-12)
                if not (np.isfinite(lk[key]) and rel <= TRAIN_LOSS_RTOL):
                    failures.append(f"{kind} {i} {key} {lk[key]} vs "
                                    f"{lp[key]}")
            print(f"  {kind} {i}: " + ", ".join(
                f"{k} {lk[k]:.6f} vs {lp[k]:.6f}" for k in lk)
                + f" (kernels vs plain, tol {TRAIN_LOSS_RTOL} relative)")
        n_grad = check_gradients(tr, failures)
        print(f"  {n_grad} trainable tensors with finite gradients, non-zero "
              f"but for the {len(bn_cancelled(3))} biases a batch-statistics "
              "BatchNorm removes")
        k_ms = float(np.median(tr.step_ms))
        p_ms = float(np.median(plain.step_ms))
        print(f"  median step ms: kernels {k_ms:.3f}, plain {p_ms:.3f} (host "
              f"clock around each step, ending in its loss read) on {card}")
        print(f"  steps ms kernels {[round(v, 3) for v in tr.step_ms]}; "
              f"plain {[round(v, 3) for v in plain.step_ms]}")
        out["step_flops"] = step_flops(plain)
        del plain

        # The epoch-0 checkpoint, and a resume from it.
        ckpt = ckpt_dir / "0001.ckpt"
        saved = load_checkpoint(ckpt)
        if "teacher_state_dict" not in saved:
            failures.append("the checkpoint has no teacher_state_dict")
        resume = config.get_full_configs(cli_main.build_parser().parse_args(
            pretrain_args(cfg, "supervised_learning_all", "st-resume",
                          "--load-ckpt-backbone",
                          "--load-ckpt-backbone-path", str(ckpt))))
        probe = initialization.select_trainer(resume, SwinUnetR, None, None,
                                              _Quiet(), None)
        start = probe.prepare_fit()
        restored = {
            "student": same(to_flax_variables(probe.model),
                            saved["model_state_dict"]),
            "teacher": same(to_flax_variables(probe.teacher),
                            saved.get("teacher_state_dict", {})),
            "optimizer": same(grouped_adamw_leaves(
                probe.optimizer, probe.model, probe.step_count),
                saved["optimizer_state_dict"]["__flat_leaves__"]),
            "step": probe.step_count == steps == int(
                saved["scheduler_state_dict"]["step"])}
        print(f"  resume from {ckpt.name}: start epoch {start}; bit for bit "
              f"{restored}")
        if start != 1 or not all(restored.values()):
            failures.append(f"resume: start {start}, {restored}")

        # The EMA: the teacher after one step from host copies.
        batch = next(iter(get_fit_loader_supervised_learning(hp)[0]))
        tau = float(hp.tau)
        t0 = [p.detach().double().cpu() for p in probe.teacher.parameters()]
        s0 = [p.detach().double().cpu() for p in probe.model.parameters()]
        probe.model.train()
        probe.teacher.train()
        probe.train_step(batch)
        worst = 0.0
        for t, a, b in zip(probe.teacher.parameters(), t0, s0):
            want_t = tau * a + (1.0 - tau) * b
            scale = tau * a.abs() + (1.0 - tau) * b.abs()
            err = (t.detach().double().cpu() - want_t).abs()
            worst = max(worst, float((err / scale.clamp_min(1e-30)).max()))
        print(f"  EMA: teacher after one step vs tau*t0 + (1-tau)*s0 (host "
              f"fp64): worst error {worst:.3g} of |tau*t0| + |(1-tau)*s0| "
              "(limit 2^-22)")
        if not worst <= 2.0 ** -22:
            failures.append(f"EMA error {worst}")
        del probe

        tr.model.train()        # validation left both models in eval mode
        tr.teacher.train()
        profile_steps(tr, hp, loaders=get_fit_loader_supervised_learning)
        print(f"  (profile of supervised_learning_all steps on {card})")
        out["loss_ms"] = loss_device_ms(tr, batch)
        print(f"  clustered-prototype loss, forward + backward: "
              f"{out['loss_ms']:.4f} device ms per step (CUDA events) on "
              f"{card}")
        out.update(launches=launches, step_ms=k_ms, plain_step_ms=p_ms)
        del tr

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        config.DEFAULT_ROOT_LOG_DIR = root / "logs"
        write_pretrain_set(root, 2, SEED + 16)    # 1 train, 1 val volume
        cfg = pretrain_config(root)
        hp = config.get_full_configs(cli_main.build_parser().parse_args(
            pretrain_args(cfg, "self_supervised_learning_decoder", "st-dec")))
        tr, launches, wall = run_fit(hp, True)
        steps, val_steps = len(tr.losses), len(tr.val_losses)
        want = expect(PHASE2_DECODER_STEP, steps)
        for k, v in PHASE2_VAL.items():
            want[k] += v * val_steps
        print(f"  self_supervised_learning_decoder: {steps} steps + "
              f"{val_steps} validation steps in {wall:.3f} s, launches "
              f"{launches}; losses {[round(v['tot'], 5) for v in tr.losses]}")
        if steps != 2 or launches != want:
            failures.append(f"decoder mode: {steps} steps, launches "
                            f"{launches}, expected {want}")
        fresh = initialization.select_trainer(hp, SwinUnetR, None, None,
                                              _Quiet(), None)
        enc = partition.encoder_labels(tr.model_conf, True)
        kept = moved = 0
        for (name, p), q in zip(tr.model.named_parameters(),
                                fresh.model.parameters()):
            if partition.label_of(name) in enc:
                kept += 1
                if not torch.equal(p, q):
                    failures.append(f"decoder mode moved the frozen {name}")
            elif p.requires_grad:
                moved += int(not torch.equal(p, q))
        check_gradients(tr, failures)
        print(f"  {kept} encoder tensors bit for bit their initial values; "
              f"{moved} decoder tensors moved")
        if not moved:
            failures.append("decoder mode moved no decoder tensor")
        out["decoder_launches"] = launches
        del tr, fresh
    if failures:
        raise RuntimeError("phase students-teacher failed: "
                           + "; ".join(failures))
    return out


# Phase 1 (multi-view encoder pretraining).  The encoder's 3 stages of a
# 128x128x8 roi (window 8x8x4, 64 encoder prompt tokens); per view 6
# block calls.  MV_BATCH is the reference trainer's batch (2 volumes x 7
# crops); the port's loader, as the JAX package's, batches crops, so the
# example config's ``batch_size_multi_view: 2`` steps on 2 crops.
PHASE1 = "self_supervised_learning_encoder"
MV_GEOMETRIES = (("enc0", 48, 4, (64, 64, 4)), ("enc1", 96, 8, (32, 32, 2)),
                 ("enc2", 192, 16, (16, 16, 2)))
MV_BATCH = 14
# Launches per phase-1 step: 2 views x 6 encoder blocks, forward and
# backward; with mutual learning a third view; on the block pairs 3 B5
# per view, their backward a B1 recompute and 2 B4 per pair.
MV_STEP = {"B1": 12, "B4": 12}
MV_VAL = {"B1": 12}
MV_MUTUAL_STEP = {"B1": 18, "B4": 18}
MV_PAIR_STEP = {"B5": 6, "B1": 6, "B4": 12}
MV_VOLUMES = 3       # split 0.8: 2 train x 7 crops = 7 steps of 2, 1 val: 3
MV14_VOLUMES = 6     # batch 14: 4 train volumes = 2 steps, 2 val: 1


def mv_block(c, heads, shift, gen, pad_mode, dtype):
    """A phase-1 encoder block (seeded random weights, dropout on)."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinTransformerBlock
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import init_weights
    blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                               shift_size=shift, pad_mode=pad_mode,
                               dtype=dtype, attn_drop=DROP_RATE,
                               proj_drop=DROP_RATE)
    return init_weights(blk, gen).cuda()


def phase_multi_view_blocks(gen_seed: int = SEED + 17):
    """B1 with dropout and B4 against their plain versions at the 12 block
    calls of a phase-1 step at batch 14 (each geometry once per view, on
    its own input), at the flagship (bf16, ``pad_mode: aligned``: the
    depth-2 stages pad-folded) and the example config (fp32, ``pad_mode:
    reference``: M 256 everywhere, B4's device-memory form at C 192); B4
    twice with the same bits; then B5 with dropout at the flagship's 6
    pair calls (3 encoder pairs per view) against ``pair_reference``.
    Prints each call's ms, plain ms, error, and B1/B4 cluster and form."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import (PARAM_KEYS, Dropout, block_reference,
                             fused_swin_block)
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import launch_info as fwd_launch_info
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block_bwd import (block_backward, block_backward_reference,
                                 launch_info)
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_pair import fused_swin_pair, pair_reference
    print(f"phase multi-view-blocks: B1 with dropout {DROP_RATE}/{DROP_RATE} "
          f"and B4 vs their plain versions at the 12 block calls of a "
          f"phase-1 step, batch {MV_BATCH}, flagship (bf16, aligned) and "
          "example (fp32, reference); B5 at the flagship's 6 pair calls")
    failures, out = [], {}
    names = ("x", "bias", "ext_k", "ext_v", *PARAM_KEYS)
    g = torch.Generator().manual_seed(gen_seed)
    seed = 3000
    for cfg, pad_mode, dtype in (("flagship", "aligned", torch.bfloat16),
                                 ("example", "reference", torch.float32)):
        fwd = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "errs": []}
        bwd = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "errs": [],
               "big_calls": 0}
        for name, c, heads, dims in MV_GEOMETRIES:
            for shift in ((0, 0, 0), (4, 4, 2)):
                blk = mv_block(c, heads, shift, g, pad_mode, dtype)
                tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
                for view in ("i", "j"):
                    x = torch.randn((MV_BATCH, *dims, c), generator=g).to(
                        "cuda", dtype)
                    drop = Dropout((seed, seed + 1), DROP_RATE, DROP_RATE)
                    seed += 2
                    with torch.no_grad():
                        x_win, ops, labels, _ = blk.windows(x, tok)
                    dout = torch.randn(x_win.shape, generator=g).to(
                        "cuda", dtype)
                    tag = (f"{cfg} view {view} "
                           + block_tag(name, c, heads, dims, x_win, ops,
                                       labels))
                    with torch.inference_mode():
                        ref = block_reference(x_win, ops, labels, drop)
                        got = fused_swin_block(x_win, ops, labels, drop)
                        torch.cuda.synchronize()
                        fwd["errs"].append(check_close(f"B1 {tag}", got, ref,
                                                       failures))
                        t_k = cuda_ms(lambda: fused_swin_block(
                            x_win, ops, labels, drop))
                        t_p = cuda_ms(lambda: block_reference(
                            x_win, ops, labels, drop), 3)
                    del ref, got
                    fwd["bound"].add(*block_work(x_win, ops, labels))
                    fwd["ms"] += t_k
                    fwd["plain_ms"] += t_p
                    ref_dx, ref_g = block_backward_reference(
                        x_win, dout, ops, labels, drop)
                    dx, got_g = block_backward(x_win, dout, ops, labels, drop)
                    dx2, got_g2 = block_backward(x_win, dout, ops, labels,
                                                 drop)
                    torch.cuda.synchronize()
                    info = launch_info(x_win, ops, labels, drop)
                    bwd["big_calls"] += int(info["big"])
                    print(f"    B1 launch {fwd_launch_info(x_win, ops)}; "
                          f"B4 launch {info}")
                    for gname, a, b, want in zip(
                            names, (dx, *got_g), (dx2, *got_g2),
                            (ref_dx, *ref_g)):
                        if want is None:
                            continue
                        if not torch.equal(a, b):
                            failures.append(f"B4 {tag} d{gname}: two runs "
                                            "differ")
                        bwd["errs"].append(check_close(
                            f"  d{gname}", a, want, failures, GRAD_TOL,
                            1e-6))
                    del ref_dx, ref_g, dx, got_g, dx2, got_g2
                    t_bk = cuda_ms(lambda: block_backward(
                        x_win, dout, ops, labels, drop))
                    t_bp = cuda_ms(lambda: block_backward_reference(
                        x_win, dout, ops, labels, drop), 3)
                    bwd["bound"].add(*block_bwd_work(x_win, ops, labels))
                    bwd["ms"] += t_bk
                    bwd["plain_ms"] += t_bp
                    print(f"    B1 kernel {t_k:.4f} ms, plain {t_p:.4f} ms; "
                          f"B4 kernel {t_bk:.4f} ms, plain {t_bp:.4f} ms")
                    torch.cuda.empty_cache()
        want_big = 4 if pad_mode == "reference" else 0
        if bwd["big_calls"] != want_big:
            failures.append(f"{cfg}: {bwd['big_calls']} B4 calls in the "
                            f"device-memory form, expected {want_big}")
        for m in (fwd, bwd):
            m["max_abs_err"] = max(m.pop("errs"))
        print(f"  {cfg}: per step (12 calls) B1 {fwd['ms']:.4f} ms (plain "
              f"{fwd['plain_ms']:.4f}, bound {fwd['bound'].ms:.4f}), B4 "
              f"{bwd['ms']:.4f} ms (plain {bwd['plain_ms']:.4f}, bound "
              f"{bwd['bound'].ms:.4f}; {bwd['big_calls']} calls in the "
              "device-memory form)")
        out[cfg] = {"B1": fwd, "B4": bwd}

    pair = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "errs": []}
    for name, c, heads, dims in MV_GEOMETRIES:
        blocks = make_pair(c, heads, g, DROP_RATE)
        toks = tuple((0.5 * torch.randn((64, c), generator=g)).cuda()
                     for _ in range(2))
        for view in ("i", "j"):
            x = torch.randn((MV_BATCH, *dims, c), generator=g).to(
                "cuda", torch.bfloat16)
            d0 = Dropout((seed, seed + 1), DROP_RATE, DROP_RATE)
            d1 = Dropout((seed + 2, seed + 3), DROP_RATE, DROP_RATE)
            seed += 4
            with torch.inference_mode():
                x_win, ops0, ops1, labels, plan, _ = blocks.pair_windows(
                    x, toks)
                ref = pair_reference(x_win, ops0, ops1, labels, plan, d0, d1)
                got = fused_swin_pair(x_win, ops0, ops1, labels, plan, d0, d1)
                torch.cuda.synchronize()
                pair["errs"].append(check_close(
                    f"B5 view {view} {name} C{c} h{heads} "
                    f"BP{x_win.shape[0] * x_win.shape[1]} "
                    f"M{x_win.shape[2]}", got, ref, failures))
                t_k = cuda_ms(lambda: fused_swin_pair(
                    x_win, ops0, ops1, labels, plan, d0, d1))
                t_p = cuda_ms(lambda: pair_reference(
                    x_win, ops0, ops1, labels, plan, d0, d1), 3)
            pair["bound"].add(*pair_work(x_win, ops0, ops1, labels))
            pair["ms"] += t_k
            pair["plain_ms"] += t_p
            print(f"    B5 kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
    pair["max_abs_err"] = max(pair.pop("errs"))
    out["B5"] = pair
    print(f"  B5 per step (6 pair calls): {pair['ms']:.4f} ms (plain "
          f"{pair['plain_ms']:.4f}, bound {pair['bound'].ms:.4f})")
    if failures:
        raise RuntimeError("phase multi-view-blocks failed: "
                           + "; ".join(failures))
    return out


def multi_view_config(root: Path, name: str, **over) -> str:
    """``configurations/example_configs.yml`` with the flagship model
    (bf16 trunk, ``pad_mode: aligned``; its widths, window, prompts,
    dropout and ``use_checkpoint`` are the example's), the pretrain data
    of ``root``, epoch 0 only (``max_epochs_multi_view: 0``; the YAML wins
    over the command line), and ``over``.  The multi-view section as
    published otherwise."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import load_conf
    conf = load_conf("example_configs.yml")
    conf.update(compute_dtype="bfloat16", pad_mode="aligned",
                image_dir_pretrain=str(root / "img"),
                image_dir_supervised=str(root / "img"),
                mask_dir_supervised=str(root / "msk"),
                max_epochs_multi_view=0, max_epochs_students_teacher=0,
                **over)
    path = root / f"{name}.yml"
    path.write_text(json.dumps(conf))
    return str(path)


def mv_args(configs: str, run: str, *more: str) -> list:
    return ["--mode", "fit", "--training-mode", PHASE1, "--configs",
            configs, "--use-encoder-prompting", "--run-name", run, *more]


def loss_gate(kind: str, got: dict, want: dict, failures: list) -> str:
    """``got`` within TRAIN_LOSS_RTOL of ``want`` for every loss; returns
    the printed comparison."""
    import numpy as np
    for key in want:
        rel = abs(got[key] - want[key]) / max(abs(want[key]), 1e-12)
        if not (np.isfinite(got[key]) and rel <= TRAIN_LOSS_RTOL):
            failures.append(f"{kind} {key} {got[key]} vs {want[key]}")
    return ", ".join(f"{k} {got[k]:.6f} vs {want[k]:.6f}" for k in want)


def fit_gates(tr, plain, launches, plain_launches, per_step, steps,
              val_steps, failures: list) -> None:
    """A phase-1 fit run against its plain twin: the step counts, exact
    launches, no launch in the plain run, each step's losses."""
    got = (len(tr.losses), len(tr.val_losses))
    if got != (steps, val_steps):
        failures.append(f"{got} steps and validation steps, not "
                        f"{(steps, val_steps)}")
    want = expect(per_step, len(tr.losses))
    for k, v in MV_VAL.items():
        want[k] += v * len(tr.val_losses)
    print(f"  launches {launches} (expected {per_step} per step, {MV_VAL} "
          f"per validation step); plain run {plain_launches}")
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")
    if any(plain_launches.values()):
        failures.append(f"plain run launched kernels: {plain_launches}")
    for i, (lk, lp) in enumerate(zip(tr.losses + tr.val_losses,
                                     plain.losses + plain.val_losses)):
        kind = "step" if i < len(tr.losses) else "validation step"
        print(f"  {kind} {i}: " + loss_gate(f"{kind} {i}", lk, lp, failures)
              + f" (kernels vs plain, tol {TRAIN_LOSS_RTOL} relative)")


def phase_multi_view(card: str):
    """Phase-1 multi-view pretraining through ``main --mode fit
    --training-mode self_supervised_learning_encoder
    --use-encoder-prompting`` at the flagship model with the example
    config's multi-view section (roi 128x128x8, masking 2x2x2 at 0.2,
    coding dim 512, rec/rot/con at 0.2/0.5/0.3, lr 5e-4, wd 0.1, warmup
    100, t_total 4000, 7 crops per volume, batch 2) on seeded synthetic
    volumes, with the kernels and with the plain versions from the same
    seeds: losses, launches, gradients, the epoch-0 checkpoint resumed
    bit for bit, a profile of 2 steps; one step on the block pairs (B5)
    against the run's first; the same run at batch 14 (the reference's 2
    volumes x 7 crops) with a profile; then one phase-2
    ``self_supervised_learning_all`` step from the phase-1 checkpoint
    (the hand-off: encoder tensors the checkpoint's, the teacher the
    student)."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import get_fit_loader_self_supervised_learning as ssl_loaders
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        .common import grouped_adamw_leaves
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import initialization
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .checkpoint import load_checkpoint, tree_leaves
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .torch_import import to_flax_variables
    print("phase multi-view: main --mode fit --training-mode "
          f"{PHASE1} --use-encoder-prompting, flagship model (bf16, "
          "pad_mode aligned, 64 encoder prompt tokens, dropout 0.1/0.1), "
          "example_configs.yml multi-view section (7 crops per volume, "
          "batch 2)")
    failures, out = [], {}

    def same(a, b) -> bool:
        a, b = tree_leaves(a), tree_leaves(b)
        return len(a) == len(b) and all(
            np.asarray(x).dtype == np.asarray(y).dtype
            and np.array_equal(x, y) for x, y in zip(a, b))

    def hparams(argv):
        return config.get_full_configs(cli_main.build_parser().parse_args(
            argv))

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        config.DEFAULT_ROOT_LOG_DIR = root / "logs"
        write_pretrain_set(root, MV_VOLUMES, SEED + 18)
        cfg = multi_view_config(root, "multi_view")
        ckpt_dir = root / "backbone"
        hp = hparams(mv_args(cfg, "mv", "--save-ckpt-backbone",
                             "--save-ckpt-backbone-path", str(ckpt_dir)))
        plain, plain_launches, _ = run_fit(hp, False)
        tr, launches, wall = run_fit(hp, True)
        print(f"  kernels: {len(tr.losses)} steps + {len(tr.val_losses)} "
              f"validation steps in {wall:.3f} s")
        fit_gates(tr, plain, launches, plain_launches, MV_STEP, 7, 3,
                  failures)
        n_grad = check_gradients(tr, failures)
        print(f"  {n_grad} trainable tensors with finite gradients, non-zero "
              f"but for the {len(bn_cancelled(3, True))} biases a "
              "normalization on batch statistics removes")
        k_ms = float(np.median(tr.step_ms))
        p_ms = float(np.median(plain.step_ms))
        print(f"  median step ms: kernels {k_ms:.3f}, plain {p_ms:.3f} (host "
              f"clock around each step, ending in its loss read) on {card}")
        print(f"  steps ms kernels {[round(v, 3) for v in tr.step_ms]}; "
              f"plain {[round(v, 3) for v in plain.step_ms]}")
        first = tr.losses[0]
        out["step_flops"] = step_flops(plain)
        del plain

        # The epoch-0 checkpoint, and a resume from it.
        ckpt = ckpt_dir / "0001.ckpt"
        saved = load_checkpoint(ckpt)
        probe = initialization.select_trainer(
            hparams(mv_args(cfg, "mv-resume", "--load-ckpt-backbone",
                            "--load-ckpt-backbone-path", str(ckpt))),
            SwinUnetR, None, None, _Quiet(), None)
        start = probe.prepare_fit()
        restored = {
            "model": same(to_flax_variables(probe.model),
                          saved["model_state_dict"]),
            "optimizer": same(grouped_adamw_leaves(
                probe.optimizer, probe.model, probe.step_count),
                saved["optimizer_state_dict"]["__flat_leaves__"]),
            "step": probe.step_count == len(tr.losses) == int(
                saved["scheduler_state_dict"]["step"]),
            "no teacher": "teacher_state_dict" not in saved}
        print(f"  resume from {ckpt.name}: start epoch {start}; bit for bit "
              f"{restored}")
        if start != 1 or not all(restored.values()):
            failures.append(f"resume: start {start}, {restored}")
        del probe

        tr.model.train()        # validation left the model in eval mode
        profile_steps(tr, hp, loaders=ssl_loaders)
        print(f"  (profile of phase-1 steps at batch 2 on {card})")
        out.update(launches=launches, step_ms=k_ms, plain_step_ms=p_ms)
        del tr

        # One step on the block pairs, from the run's initial state, draws
        # and first batch: against the two-launch run's first step.
        pair_tr = initialization.select_trainer(hp, SwinUnetR, None, None,
                                                _Quiet(), None)
        pair_tr.prepare_fit()
        pair_tr.model.train().set_pair_kernel(True)
        batch = next(iter(ssl_loaders(hp)[0]))
        torch.cuda.synchronize()
        reset_counters()
        parts = {k: float(v) for k, v in pair_tr.train_step(batch).items()}
        out["pair_launches"] = read_counters()
        print(f"  block pairs, one step: launches {out['pair_launches']} "
              f"(expected {MV_PAIR_STEP}); "
              + loss_gate("pair step", parts, first, failures)
              + " (block pairs vs the two-launch run's first step)")
        if out["pair_launches"] != expect(MV_PAIR_STEP):
            failures.append(f"pair step launches {out['pair_launches']}")
        del pair_tr

        # Phase 2 from the phase-1 checkpoint (backbone-only merge).
        cfg2 = multi_view_config(root, "phase2")
        hp2 = hparams(pretrain_args(cfg2, "self_supervised_learning_all",
                                    "mv-to-p2", "--load-ckpt-backbone",
                                    "--load-ckpt-backbone-path", str(ckpt)))
        st = initialization.select_trainer(hp2, SwinUnetR, None, None,
                                           _Quiet(), None)
        st.prepare_fit()
        student = to_flax_variables(st.model)["params"]
        taken, differ = 0, []

        def walk(a, b, path=""):
            nonlocal taken
            for k, v in a.items():
                if k not in b:
                    continue
                if isinstance(v, dict):
                    walk(v, b[k], f"{path}/{k}")
                else:
                    taken += 1
                    if not np.array_equal(v, b[k]):
                        differ.append(f"{path}/{k}")

        walk(saved["model_state_dict"]["params"], student)
        teacher_same = all(torch.equal(a, b) for a, b in zip(
            st.teacher.state_dict().values(), st.model.state_dict().values()))
        st.model.train()
        st.teacher.train()
        batch2 = next(iter(ssl_loaders(hp2)[0]))
        torch.cuda.synchronize()
        reset_counters()
        parts2, _ = st.train_step(batch2)
        parts2 = {k: float(v) for k, v in parts2.items()}
        out["phase2_launches"] = read_counters()
        print(f"  phase 2 from {ckpt.name}: {taken} student leaves taken from "
              f"the checkpoint ({len(differ)} differ), teacher == student "
              f"{teacher_same}; one self_supervised_learning_all step: "
              f"launches {out['phase2_launches']} (expected {PHASE2_STEP}), "
              f"losses {parts2}")
        if differ or taken < 50 or not teacher_same:
            failures.append(f"hand-off: {taken} leaves, differ {differ[:3]}, "
                            f"teacher == student {teacher_same}")
        if out["phase2_launches"] != expect(PHASE2_STEP) or not all(
                np.isfinite(list(parts2.values()))):
            failures.append(f"hand-off step: {out['phase2_launches']}, "
                            f"{parts2}")
        del st

    # The reference's batch: 2 volumes x 7 crops per step.
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        config.DEFAULT_ROOT_LOG_DIR = root / "logs"
        write_pretrain_set(root, MV14_VOLUMES, SEED + 19)
        cfg = multi_view_config(root, "multi_view_14",
                                batch_size_multi_view=MV_BATCH)
        hp = hparams(mv_args(cfg, "mv14"))
        plain, plain_launches, _ = run_fit(hp, False)
        tr, launches, wall = run_fit(hp, True)
        print(f"  batch {MV_BATCH}: {len(tr.losses)} steps + "
              f"{len(tr.val_losses)} validation steps in {wall:.3f} s")
        fit_gates(tr, plain, launches, plain_launches, MV_STEP, 2, 1,
                  failures)
        check_gradients(tr, failures)
        out["b14_step_ms"] = float(np.median(tr.step_ms))
        out["b14_plain_step_ms"] = float(np.median(plain.step_ms))
        print(f"  batch {MV_BATCH} median step ms: kernels "
              f"{out['b14_step_ms']:.3f}, plain "
              f"{out['b14_plain_step_ms']:.3f} on {card}")
        out["b14_launches"] = launches
        del plain
        tr.model.train()
        profile_steps(tr, hp, loaders=ssl_loaders)
        print(f"  (profile of phase-1 steps at batch {MV_BATCH} on {card})")
        del tr
    if failures:
        raise RuntimeError("phase multi-view failed: " + "; ".join(failures))
    return out


def phase_multi_view_mutual(card: str):
    """Mutual learning at the flagship model and roi: one step at each
    axis swap, forced.  Swap 0 (H-W) trains: 18 B1 + 18 B4, its losses
    against the plain versions; swaps 1 and 2 bring the reconstruction
    back at 128x128x16 and 128x16x128, which the JAX step cannot
    broadcast against the roi: the step must raise ``ValueError`` before
    any launch."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import get_fit_loader_self_supervised_learning as ssl_loaders
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import initialization
    print("phase multi-view-mutual: use_mutual_learning at the flagship "
          "model and roi, one step per axis swap")
    failures, out = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        config.DEFAULT_ROOT_LOG_DIR = root / "logs"
        write_pretrain_set(root, 2, SEED + 20)
        cfg = multi_view_config(root, "mutual", use_mutual_learning=True)
        hp = config.get_full_configs(cli_main.build_parser().parse_args(
            mv_args(cfg, "mv-mutual")))
        batch = next(iter(ssl_loaders(hp)[0]))
        trainers = {}
        for kernels in (True, False):
            tr = initialization.select_trainer(hp, SwinUnetR, None, None,
                                               _Quiet(), None)
            tr.prepare_fit()
            tr.model.train().set_kernels(kernels)
            trainers[kernels] = tr
        draws = trainers[True].draw_views(batch["image"].shape[0])
        for choice in (1, 2):
            torch.cuda.synchronize()
            reset_counters()
            try:
                trainers[True].train_step(batch, draws._replace(
                    permute=choice))
                failures.append(f"swap {choice} did not raise")
            except ValueError as err:
                print(f"  swap {choice}: ValueError: {err}")
            got = read_counters()
            if any(got.values()) or trainers[True].step_count:
                failures.append(f"swap {choice}: launches {got}, step "
                                f"{trainers[True].step_count}")
        parts = {}
        for kernels, tr in trainers.items():
            torch.cuda.synchronize()
            reset_counters()
            parts[kernels] = {k: float(v) for k, v in tr.train_step(
                batch, draws._replace(permute=0)).items()}
            torch.cuda.synchronize()
            if kernels:
                out["launches"] = read_counters()
        print(f"  swap 0: launches {out['launches']} (expected "
              f"{MV_MUTUAL_STEP}); "
              + loss_gate("mutual step", parts[True], parts[False], failures)
              + f" (kernels vs plain, tol {TRAIN_LOSS_RTOL} relative)")
        if out["launches"] != expect(MV_MUTUAL_STEP):
            failures.append(f"mutual launches {out['launches']}")
        check_gradients(trainers[True], failures)
    if failures:
        raise RuntimeError("phase multi-view-mutual failed: "
                           + "; ".join(failures))
    return out


# ------------------------------------------------ training, unfused blocks
# The unfused flagship model in training: with attention dropout off, per
# step 8 B6 + 4 B8 (forwards; their backward is the JAX package's fp32
# recompute in plain torch and launches nothing); with it on, the JAX XLA
# attention and no kernel; per eval forward 8 B6 + 4 B8 + 3 B2.
UNFUSED_STEP = {"B6": 8, "B8": 4}
UNFUSED_VAL = {"B6": 8, "B8": 4, "B2": 3}
# Phase 2 validates the 2 students and the teacher; phase 1 the encoder
# on 2 views.
UNFUSED_PHASE2_VAL = {"B6": 24, "B8": 12, "B2": 9}
UNFUSED_PHASE1_VAL = {"B6": 8, "B8": 4}
# The Functions' backward (fp32 recompute) against torch autograd of the
# plain version at fp32, TF32 off: float reassociation only.
ATTN_GRAD_TOL = 2.0 ** -10
DROP_SHARE_TOL = 0.005
# One step's gradients with use_checkpoint on against off, same seeds.
REMAT_TOL = 2.0 ** -10


def phase_unfused_grads(gen_seed: int = SEED + 19):
    """The autograd Functions of B6 and B8 at the 12 unfused block calls
    of a flagship downstream training step at batch 2 (64+64 prompt
    tokens, shifted and unshifted), called as the unfused block calls
    them (B6 with the prompt rows apart, the bias as its factor tables),
    and of B7 at one C 96 call: the forward with autograd bit for bit the
    serving call's, and within KERNEL_TOL of the bf16 plain version on
    the same inputs; every gradient (y or q/k/v, the prompt rows, the
    weights, the dense bias) within ATTN_GRAD_TOL of its largest
    magnitude of torch autograd through the plain version at fp32 (the
    bf16 activations widened to fp32 for both); the backward (the
    recompute, at the call's bf16 activations) timed with CUDA events
    beside autograd's backward through the bf16 plain version, and the
    forward kernel timed beside the bf16 plain version and its bound at
    these shapes.  The unshifted B7/B8 calls are also timed as one
    ``scaled_dot_product_attention`` call, as in phase B6-B8."""
    import torch
    import torch.nn.functional as F
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        .window_attention import linear
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import window_attention as wa
    print("phase unfused-grads: B6/B7/B8 autograd Functions (kernel forward, "
          "fp32 recompute backward) vs autograd of the plain versions, the "
          "12 flagship training calls at batch 2")
    failures = []
    res = {k: {"max_rel_err": 0.0, "bwd_ms": 0.0, "plain_bwd_ms": 0.0,
               "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound": Bound(), "calls": 0, "library_ms": 0.0,
               "ms_unshifted": 0.0, "unshifted_calls": 0}
           for k in ("B6", "B7", "B8")}
    g = torch.Generator().manual_seed(gen_seed)

    def grads(fn, inputs, gout, keep=False):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        got = torch.autograd.grad(out, leaves, gout.to(out.dtype),
                                  retain_graph=keep)
        return out, leaves, got

    def run(key, tag, fn, plain, inputs, names, work, library=None):
        r = res[key]
        with torch.inference_mode():
            served = fn(*inputs, None)
            torch.cuda.synchronize()
            r["max_abs_err"] = max(r["max_abs_err"], check_close(
                f"{key} {tag} forward", served,
                plain(*inputs, torch.bfloat16), failures))
            t_fwd = cuda_ms(lambda: fn(*inputs, None))
            t_plain_fwd = cuda_ms(lambda: plain(*inputs, torch.bfloat16), 3)
            t_lib = None if library is None else cuda_ms(library)
        trained = fn(*[t.detach().clone().requires_grad_() for t in inputs],
                     None)
        if not torch.equal(trained.detach(), served):
            failures.append(f"{key} {tag}: the forward with autograd is not "
                            "the serving call's")
        gout = torch.randn(served.shape, generator=g).cuda()
        wide = [t.detach().float() for t in inputs]
        _, _, got = grads(lambda *t: fn(*t, None), wide, gout)
        _, _, want = grads(lambda *t: plain(*t, torch.float32), wide, gout)
        worst = 0.0
        for name, a, b in zip(names, got, want):
            big = b.abs().max().item()
            rel = (a - b).abs().max().item() / big if big else float("inf")
            worst = max(worst, rel)
            if not (bool(a.isfinite().all()) and rel <= ATTN_GRAD_TOL):
                failures.append(f"{key} {tag} d{name}: rel err {rel}")
        out, leaves, _ = grads(lambda *t: fn(*t, None), inputs, gout, True)
        gk = gout.to(out.dtype)
        t_bwd = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, gk, retain_graph=True), 5)
        pout, pleaves, _ = grads(lambda *t: plain(*t, torch.bfloat16),
                                 inputs, gout, True)
        gp = gout.to(pout.dtype)
        t_plain = cuda_ms(lambda: torch.autograd.grad(
            pout, pleaves, gp, retain_graph=True), 3)
        del out, leaves, pout, pleaves
        r["bound"].add(*work)
        print(f"  {key} {tag}: gradients {', '.join(names)} max rel err "
              f"{worst:.3g} (tol {ATTN_GRAD_TOL:.3g}); backward {t_bwd:.4f} "
              f"ms (plain autograd {t_plain:.4f} ms); forward {t_fwd:.4f} ms "
              f"(plain {t_plain_fwd:.4f} ms"
              + ("" if t_lib is None else
                 f", scaled_dot_product_attention {t_lib:.4f} ms") + ")")
        if t_lib is not None:
            r["library_ms"] += t_lib
            r["ms_unshifted"] += t_fwd
            r["unshifted_calls"] += 1
        r["max_rel_err"] = max(r["max_rel_err"], worst)
        r["ms"] += t_fwd
        r["plain_ms"] += t_plain_fwd
        r["bwd_ms"] += t_bwd
        r["plain_bwd_ms"] += t_plain
        r["calls"] += 1

    b7_done = False
    for name, c, heads, dims in BLOCK_GEOMETRIES:
        for shift in ((0, 0, 0), (4, 4, 2)):
            blk = make_block(c, heads, shift, g)
            blk.fused_block = False
            x = torch.randn((TRAIN_BATCH, *dims, c), generator=g).to(
                "cuda", torch.bfloat16)
            tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
            at = blk.attn
            scale = (c // heads) ** -0.5
            with torch.inference_mode():
                x_win, ops, labels, _ = blk.windows(x, tok)
                y = blk.attn_input(x_win, tok)
            # Autograd saves y, the bias and the labels: normal tensors.
            y = y.clone()
            bias, tables = ops.bias.clone(), ops.factors
            labels = None if labels is None else labels.clone()
            b, pw, n = y.shape[:3]
            m = x_win.shape[2]
            tag = (f"{name} C{c} h{heads} BP{b * pw} M{m} N{n} "
                   f"{'shift' if labels is not None else 'noshift'}")
            ws = [lin.weight.detach().t().clone()
                  for lin in (at.to_q, at.to_k, at.to_v)]
            wqkv = at.kernel_weight()
            if c <= 128:
                def b6(yc, yp, wq, wk, wv, bias, _dt):
                    return wa.fused_window_attention_packed_qkv_prompts(
                        yc, yp, wq, wk, wv, bias, labels, scale, heads,
                        wqkv=wqkv, factors=tables)

                def b6_plain(yc, yp, wq, wk, wv, bias, dt):
                    full = torch.cat([yc, yp.expand(b, pw, -1, c)], 2)
                    return wa.fused_window_attention_packed_qkv_reference(
                        full, wq, wk, wv, m, bias, labels, scale, heads, dt)

                run("B6", tag, b6, b6_plain,
                    [y[:, :, :m].contiguous(), y[0, 0, m:].contiguous(),
                     *ws, bias], ("y", "y_prompt", "wq", "wk", "wv", "bias"),
                    attention_work(b * pw, m, n, c, heads, labels, True,
                                   tables))
            work = attention_work(b * pw, m, n, c, heads, labels, False,
                                  tables)
            with torch.no_grad():
                q = linear(y[:, :, :m], at.to_q).contiguous()
                k = linear(y, at.to_k).contiguous()
                v = linear(y, at.to_v).contiguous()
            lib = None
            if labels is None:
                sp = lambda t: t.view(b * pw, t.shape[2], heads, -1) \
                    .transpose(1, 2)  # noqa: E731
                qs, ks, vs = sp(q), sp(k), sp(v)
                bias16 = bias.to(torch.bfloat16)[None]
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qs, ks, vs, attn_mask=bias16, scale=scale)

            def attn_plain(q, k, v, bias, dt):
                return wa.fused_window_attention_packed_reference(
                    q, k, v, bias, labels, scale, heads, dt)

            if c == 96 and not b7_done:
                b7_done = True

                def b7(q, k, v, bias, _dt):
                    return wa.fused_window_attention_packed(
                        q, k, v, bias, labels, scale, heads, factors=tables)

                run("B7", tag, b7, attn_plain, [q, k, v, bias],
                    ("q", "k", "v", "bias"), work, lib)
            if c > 128:
                def b8(q, k, v, bias, _dt):
                    hs = lambda t: t.view(b, pw, t.shape[2], heads, -1)  # noqa
                    return wa.fused_window_attention(
                        hs(q), hs(k), hs(v), bias, labels, scale,
                        factors=tables).reshape(b, pw, m, c)

                run("B8", tag, b8, attn_plain, [q, k, v, bias],
                    ("q", "k", "v", "bias"), work, lib)
    if failures:
        raise RuntimeError("phase unfused-grads failed: "
                           + "; ".join(failures))
    for key, r in res.items():
        print(f"  {key}: {r['calls']} calls, forward {r['ms']:.4f} ms per "
              f"step (plain {r['plain_ms']:.4f}, bound "
              f"{r['bound'].ms:.4f} ({r['bound'].by})), backward "
              f"{r['bwd_ms']:.4f} ms (plain autograd "
              f"{r['plain_bwd_ms']:.4f}), max rel gradient error "
              f"{r['max_rel_err']:.3g}, forward max_abs_err "
              f"{r['max_abs_err']:.4g}"
              + (f"; {r['unshifted_calls']} unshifted calls "
                 f"{r['ms_unshifted']:.4f} ms vs scaled_dot_product_attention "
                 f"{r['library_ms']:.4f} ms" if r["unshifted_calls"] else ""))
    return res


def _unfused_gates(tr, plain, launches, plain_launches, per_step, per_val,
                   n_val, failures, name):
    """A downstream unfused run against its plain twin: exact launches
    (``per_step`` per training step, ``per_val`` per validation forward,
    ``n_val`` of them per epoch), no launch in the plain run, each step's
    loss within TRAIN_LOSS_RTOL, every trainable gradient finite and
    non-zero."""
    import numpy as np
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import partition
    steps = len(tr.losses)
    want = expect(per_step, steps)
    for k, v in per_val.items():
        want[k] += v * n_val
    print(f"  {name}: {steps} steps + {n_val} validation forwards, launches "
          f"{launches} (expected {per_step} per step, {per_val} per "
          f"validation forward); plain run {plain_launches}")
    if steps < 5:
        failures.append(f"{name}: only {steps} training steps")
    if launches != want:
        failures.append(f"{name}: launches {launches}, expected {want}")
    if any(plain_launches.values()):
        failures.append(f"{name}: plain run launched {plain_launches}")
    for i, (lk, lp) in enumerate(zip(tr.losses, plain.losses)):
        rel = abs(lk - lp) / max(abs(lp), 1e-12)
        print(f"    step {i}: loss {lk:.6f} (kernels) vs {lp:.6f} (plain), "
              f"rel {rel:.3g} (tol {TRAIN_LOSS_RTOL})")
        if not (np.isfinite(lk) and rel <= TRAIN_LOSS_RTOL):
            failures.append(f"{name} step {i} loss {lk} vs {lp}")
    labels = partition.downstream_labels(tr.model_conf)
    n = 0
    for pname, p in tr.model.named_parameters():
        if partition.label_of(pname) not in labels:
            continue
        n += 1
        gr = p.grad
        if gr is None or not bool(gr.isfinite().all()) or \
                not float(gr.abs().sum()) > 0:
            failures.append(f"{name} trainable {pname}: gradient "
                            f"{'missing' if gr is None else 'bad'}")
    print(f"    {n} trainable tensors, each with a finite non-zero "
          "gradient" if not failures else f"    failures: {failures}")


def phase_train_unfused(card: str):
    """``SegmentationTrainer.train()`` at the flagship training config
    through the unfused blocks (``set_fused_block(False)``), with a
    validation loader, kernels against plain versions from the same
    seeds, in two arms: (a) attention dropout 0, projection dropout 0.1,
    ``use_checkpoint`` off (the recompute would launch each forward
    kernel again): 8 B6 + 4 B8 per step; the unfused step's loss at
    dropout 0/0 against the fused step's from the same weights and batch;
    (b) dropout 0.1/0.1 and ``use_checkpoint`` as published: no B6/B8 in
    training steps (the JAX XLA attention), the share of dropped
    attention probabilities of one step, one step's gradients with
    ``use_checkpoint`` against the same step without it.  Both arms: 8
    B6 + 4 B8 + 3 B2 per validation forward, step median, device busy
    and idle share over 2 profiled steps, beside the fused step's."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import get_fit_loader_downstream
    from medical_image_segmentation_with_visual_prompts_tpu_torch.losses \
        import dice_focal_loss
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import window_attention as wam
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        import SegmentationTrainer
    print(f"phase train-unfused: SegmentationTrainer.train(), flagship, "
          f"unfused blocks, bf16 trunk, batch {TRAIN_BATCH} of 128x128x8")
    failures, out = [], {}

    def trainer(hp, fused: bool):
        tr = SegmentationTrainer(hp, SwinUnetR, None, None, _Quiet())
        tr.model.set_fused_block(fused)
        tr.configure_optimizers()
        tr.model.train()
        return tr

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_train_set(root)
        arms = (("a", "attention dropout 0, projection dropout "
                 f"{DROP_RATE}, use_checkpoint off",
                 {"attn_drop": 0.0, "use_checkpoint": False}, UNFUSED_STEP),
                ("b", f"dropout {DROP_RATE}/{DROP_RATE}, use_checkpoint on "
                 "(as published)", {}, {}))
        for arm, what, model, per_step in arms:
            print(f"  arm ({arm}): {what}")
            hp = train_hparams(root, **model)
            n_val = len(get_fit_loader_downstream(hp)[1])
            plain, plain_launches, _ = run_trainer(hp, False, fused=False,
                                                   validate=True)
            tr, launches, wall = run_trainer(hp, True, fused=False,
                                             validate=True)
            _unfused_gates(tr, plain, launches, plain_launches, per_step,
                           UNFUSED_VAL, n_val, failures, f"arm ({arm})")
            k_ms = float(np.median(tr.step_ms))
            p_ms = float(np.median(plain.step_ms))
            print(f"    median step ms: kernels {k_ms:.3f}, plain {p_ms:.3f} "
                  f"(host clock around each step, ending in its loss read) "
                  f"on {card}; steps ms {[round(v, 3) for v in tr.step_ms]}")
            del plain
            batch = next(iter(get_fit_loader_downstream(hp)[0]))
            tr.model.train()             # validation left it in eval mode
            if arm == "b":
                # The share of dropped attention probabilities in one step.
                counts = [0, 0]
                inner = wam.dropout

                def recording(x, rate, seed):
                    y = inner(x, rate, seed)
                    if x.dim() == 5:
                        counts[0] += int((y == 0).sum())
                        counts[1] += y.numel()
                    return y

                wam.dropout = recording
                try:
                    tr.train_step(batch)
                finally:
                    wam.dropout = inner
                share = counts[0] / max(counts[1], 1)
                print(f"    dropped attention probabilities in one step: "
                      f"{counts[0]} of {counts[1]} = {share:.6f} (rate "
                      f"{DROP_RATE}, tol {DROP_SHARE_TOL})")
                if not abs(share - DROP_RATE) <= DROP_SHARE_TOL:
                    failures.append(f"dropped share {share}")
                out["drop_share"] = share
                # use_checkpoint on vs off: one step's gradients.
                ck = trainer(hp, False)
                image, seg_true = ck._batch(batch)
                state = ck.model.dropout_generator.get_state()
                grads = []
                for on in (True, False):
                    for blk in ck.model.modules():
                        if hasattr(blk, "use_checkpoint"):
                            blk.use_checkpoint = on
                    ck.model.dropout_generator.set_state(state)
                    ck.model.zero_grad(set_to_none=True)
                    dice_focal_loss(ck.model(image), seg_true, gamma=4.0,
                                    include_background=True).backward()
                    grads.append({n: p.grad.clone() for n, p in
                                  ck.model.named_parameters()
                                  if p.grad is not None})
                worst = 0.0
                for n_, gon in grads[0].items():
                    goff = grads[1][n_]
                    big = goff.abs().max().item()
                    rel = (gon - goff).abs().max().item() / big if big \
                        else float((gon - goff).abs().max().item() > 0)
                    worst = max(worst, rel)
                    if not (bool(gon.isfinite().all()) and rel <= REMAT_TOL):
                        failures.append(f"use_checkpoint {n_}: rel {rel}")
                print(f"    use_checkpoint on vs off, one step from the same "
                      f"generator state: {len(grads[0])} gradients, max rel "
                      f"err {worst:.3g} (tol {REMAT_TOL:.3g})")
                out["remat_rel_err"] = worst
                del ck
            else:
                # Dropout 0/0: the unfused step's loss vs the fused step's.
                hp0 = train_hparams(root, attn_drop=0.0, proj_drop=0.0,
                                    use_checkpoint=False)
                lf = float(trainer(hp0, True).train_step(batch)[0])
                lu = float(trainer(hp0, False).train_step(batch)[0])
                rel = abs(lu - lf) / max(abs(lf), 1e-12)
                print(f"    dropout 0/0, same weights and batch: unfused "
                      f"step loss {lu:.6f} vs fused {lf:.6f}, rel {rel:.3g} "
                      f"(tol {TRAIN_LOSS_RTOL})")
                if not rel <= TRAIN_LOSS_RTOL:
                    failures.append(f"unfused loss {lu} vs fused {lf}")
            busy, idle = profile_steps(tr, hp)
            fused = TRAIN_PROFILE.get("train", (None, None, None))
            print(f"    arm ({arm}): step median {k_ms:.3f} ms, device busy "
                  f"{busy:.3f} ms per step, idle share {idle:.4f}; fused "
                  f"step (phase train) {fused[0]:.3f} ms, busy "
                  f"{fused[1]:.3f}, idle {fused[2]:.4f} on {card}")
            out[arm] = {"launches": launches, "step_ms": k_ms,
                        "plain_step_ms": p_ms, "busy_ms": busy,
                        "idle": idle, "wall_s": wall}
            del tr
    if failures:
        raise RuntimeError("phase train-unfused failed: "
                           + "; ".join(failures))
    return out


def phase_pretrain_unfused(card: str):
    """With ``MIVP_NO_FUSED_BLOCK=1`` (read when each model is built): one
    epoch of ``main --mode fit`` in ``self_supervised_learning_all``
    (the example config's phase-2 section) and in
    ``self_supervised_learning_encoder`` (its multi-view section, 2 crops
    per volume) at the flagship model on seeded volumes, kernels against
    plain versions: the example's dropout 0.1/0.1 puts every training
    step on the JAX XLA attention (no kernel); each validation step runs
    the unfused kernels (phase 2: 3 model forwards, 24 B6 + 12 B8 + 9 B2;
    phase 1: the encoder on 2 views, 8 B6 + 4 B8); launches exact, losses
    finite and within TRAIN_LOSS_RTOL of the plain run's."""
    import numpy as np
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    print("phase pretrain-unfused: MIVP_NO_FUSED_BLOCK=1, main --mode fit "
          "self_supervised_learning_all and self_supervised_learning_encoder"
          ", flagship model, example_configs.yml sections")
    failures, out = [], {}
    before = os.environ.get("MIVP_NO_FUSED_BLOCK")
    os.environ["MIVP_NO_FUSED_BLOCK"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            config.DEFAULT_ROOT_LOG_DIR = root / "logs"
            write_pretrain_set(root, PHASE2_VOLUMES, SEED + 20)
            runs = (("self_supervised_learning_all", pretrain_args(
                        pretrain_config(root), "self_supervised_learning_all",
                        "pu-all"), UNFUSED_PHASE2_VAL),
                    (PHASE1, mv_args(multi_view_config(
                        root, "mv_unfused", num_samples_multi_view=2),
                        "pu-enc"), UNFUSED_PHASE1_VAL))
            for mode, argv, per_val in runs:
                hp = config.get_full_configs(
                    cli_main.build_parser().parse_args(argv))
                plain, plain_launches, _ = run_fit(hp, False)
                tr, launches, wall = run_fit(hp, True)
                steps, n_val = len(tr.losses), len(tr.val_losses)
                want = expect({}, steps)
                for k, v in per_val.items():
                    want[k] += v * n_val
                fused = {b.fused_block for b in tr.model.modules()
                         if hasattr(b, "fused_block")}
                print(f"  {mode}: {steps} steps + {n_val} validation steps "
                      f"in {wall:.3f} s, launches {launches} (expected none "
                      f"per step, {per_val} per validation step); plain "
                      f"{plain_launches}; blocks fused: {fused}")
                if fused != {False} or steps < 2 or n_val < 1:
                    failures.append(f"{mode}: fused {fused}, {steps} steps, "
                                    f"{n_val} validation steps")
                if launches != want:
                    failures.append(f"{mode}: launches {launches}, expected "
                                    f"{want}")
                if any(plain_launches.values()):
                    failures.append(f"{mode}: plain run launched "
                                    f"{plain_launches}")
                for i, (lk, lp) in enumerate(zip(
                        tr.losses + tr.val_losses,
                        plain.losses + plain.val_losses)):
                    kind = "step" if i < steps else "validation step"
                    print(f"    {kind} {i}: " + loss_gate(
                        f"{mode} {kind} {i}", lk, lp, failures)
                        + f" (kernels vs plain, tol {TRAIN_LOSS_RTOL})")
                k_ms = float(np.median(tr.step_ms))
                print(f"    median step ms {k_ms:.3f} (plain "
                      f"{float(np.median(plain.step_ms)):.3f}) on {card}")
                out[mode] = {"launches": launches, "step_ms": k_ms}
                del tr, plain
    finally:
        if before is None:
            os.environ.pop("MIVP_NO_FUSED_BLOCK", None)
        else:
            os.environ["MIVP_NO_FUSED_BLOCK"] = before
    if failures:
        raise RuntimeError("phase pretrain-unfused failed: "
                           + "; ".join(failures))
    return out


def read_png(path: Path):
    """This script's own decoder of an 8-bit grey, non-interlaced PNG
    whose rows are unfiltered (what the port writes): ``[H, W]`` uint8."""
    import numpy as np
    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: no PNG signature")
    pos, header, idat = 8, None, b""
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color, _, _, interlace = header
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    if (depth, color, interlace) != (8, 0, 0) or rows[:, 0].any():
        raise ValueError(f"{path}: not unfiltered 8-bit grey")
    return rows[:, 1:]


def phase_view(card: str):
    """``view: true`` in each trainer, one epoch into a temporary
    ``MIVP_VIEW_DIR``: ``SegmentationTrainer.train()`` at the flagship
    training config, ``main --mode fit`` in ``supervised_learning_all``
    and in ``self_supervised_learning_encoder`` (2 crops per volume) at
    the example config's sections; every 5th step writes a panel.  Prints
    the PNGs' names and count; each decodes with :func:`read_png` to its
    panel's shape (rows of 4 slices of 128x128)."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        config
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    print("phase view: view: true in the three trainers, one epoch each")
    failures, names = [], []
    before = os.environ.get("MIVP_VIEW_DIR")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            views = root / "views"
            os.environ["MIVP_VIEW_DIR"] = str(views)
            config.DEFAULT_ROOT_LOG_DIR = root / "logs"
            (root / "down").mkdir()
            write_train_set(root / "down", 3)
            hp = train_hparams(root / "down")
            hp.view = True
            tr, _, _ = run_trainer(hp, True)
            rows = {"seg_new": 2, "rec": 2}
            (root / "pre").mkdir()
            write_pretrain_set(root / "pre", PHASE2_VOLUMES, SEED + 21)
            for argv in (pretrain_args(pretrain_config(root / "pre",
                                                       view=True),
                                       "supervised_learning_all", "view-st"),
                         mv_args(multi_view_config(
                             root / "pre", "mv_view", view=True,
                             num_samples_multi_view=2), "view-mv")):
                tr = cli_main.main("fit", config.get_full_configs(
                    cli_main.build_parser().parse_args(argv)))
                if hasattr(tr, "n_students"):
                    rows["prt"] = 2 * (1 + tr.n_students)
            for sub, n_rows in sorted(rows.items()):
                pngs = sorted((views / sub).glob("*.png"))
                if not pngs:
                    failures.append(f"no PNG under {sub}/")
                for png in pngs:
                    shape = read_png(png).shape
                    names.append(f"{sub}/{png.name}")
                    print(f"  {sub}/{png.name}: {shape[0]}x{shape[1]}")
                    if shape != (n_rows * 128, 4 * 128):
                        failures.append(f"{png.name}: shape {shape}")
    finally:
        if before is None:
            os.environ.pop("MIVP_VIEW_DIR", None)
        else:
            os.environ["MIVP_VIEW_DIR"] = before
    print(f"  {len(names)} PNGs")
    if failures:
        raise RuntimeError("phase view failed: " + "; ".join(failures))
    return names


def phase_convert(card: str):
    """The two checkpoint converter CLIs on the flagship's seeded weights:
    its msgpack checkpoint through ``utils.torch_export`` to a
    reference-named ``.pt`` and back through ``utils.torch_import`` gives
    the variables bit for bit; the ``.pt`` loads through
    ``load_reference_checkpoint`` into a new model strictly, with the
    state dict bit for bit."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import load_reference_checkpoint, torch_export, torch_import
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .checkpoint import load_checkpoint, save_checkpoint, tree_leaves
    print("phase convert: torch_export and torch_import CLIs, flagship "
          "weights")
    failures = []
    model = flagship_model()
    conf = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(model.conf).items()}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        yml = root / "flagship.yml"
        yml.write_text(json.dumps(conf))
        want = torch_import.to_flax_variables(model)
        save_checkpoint(root / "flagship.ckpt", 0, want)
        t0 = time.perf_counter()
        torch_export.main([str(root / "flagship.ckpt"),
                           str(root / "flagship.pt"), "--configs", str(yml)])
        t1 = time.perf_counter()
        torch_import.main([str(root / "flagship.pt"), str(root / "back.ckpt"),
                           "--configs", str(yml), "--strict"])
        t2 = time.perf_counter()
        back = load_checkpoint(root / "back.ckpt")["model_state_dict"]
        a, b = tree_leaves(want), tree_leaves(back)
        same = len(a) == len(b) and all(
            x.dtype == np.asarray(y).dtype and np.array_equal(x, y)
            for x, y in zip(a, b))
        sd = load_reference_checkpoint(root / "flagship.pt")
        other = SwinUnetR(model.conf)
        other.load_state_dict(sd, strict=True)
        own = model.state_dict()
        equal = all(torch.equal(t.cpu(), own[k].cpu())
                    for k, t in other.state_dict().items())
    print(f"  export {t1 - t0:.3f} s ({len(sd)} tensors), import "
          f"{t2 - t1:.3f} s; variables back bit for bit: {same} ({len(a)} "
          f"leaves); the .pt loaded strictly, state dict equal: {equal}")
    if not (same and equal):
        failures.append(f"round trip {same}, .pt load {equal}")
    if failures:
        raise RuntimeError("phase convert failed: " + "; ".join(failures))
    return {"leaves": len(a), "tensors": len(sd)}


DP_BATCH = 4        # the global batch of the data-parallel phases
DP_STEPS = 3        # 6 train volumes x 2 crops / DP_BATCH
DP_RANK_TIMEOUT = 900
# dp-nccl: a process group of one rank against no group, same seeds and
# crops: the same arithmetic (a one-rank group takes the one-process
# moments and means; DDP's all-reduce over one rank is a copy), so the
# losses and prompt tokens agree to float noise at most.
DP_NCCL_RTOL = 1e-6


def _close(got, ref, tol: float, floor: float = 1e-6):
    """(max abs error, its limit: ``tol`` of ``max(floor, max|ref|)``)."""
    import torch
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item() if torch.isfinite(got).all() \
        else float("inf")
    return err, tol * max(floor, ref.abs().max().item())


def phase_dp_kernels(gen_seed: int = SEED + 21):
    """B1, B5 and B4 as one rank of a data-parallel batch runs them: with
    dropout 0.1/0.1 at the 6 flagship training geometries (no-shift and
    shift) at the global batch DP_BATCH, each on samples [2:] (rank 1 of
    2) with ``win_base`` = the global index of its first window, against
    rows [2:] of the whole call bit for bit (B4: its dx; its operand
    gradients as the two ranks' sum, within GRAD_TOL) and against its
    plain version at the same base (KERNEL_TOL; GRAD_TOL for B4, run
    twice with the same bits); samples [:2] at base 0 (rank 0) bit for
    bit rows [:2] of the whole call.  Timed at rank 1's call."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import (PARAM_KEYS, Dropout, block_reference,
                             fused_swin_block)
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block_bwd import block_backward, block_backward_reference
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_pair import fused_swin_pair, pair_reference
    print(f"phase dp-kernels: B1, B5 and B4 with dropout {DROP_RATE}/"
          f"{DROP_RATE} on one rank's rows of a batch of {DP_BATCH} at its "
          "window base, vs rows of the whole call and vs plain at the base")
    failures = []
    res = {k: {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "errs": []}
           for k in ("B1", "B4", "B5")}
    names = ("x", "bias", "ext_k", "ext_v", *PARAM_KEYS)
    half = DP_BATCH // 2
    g = torch.Generator().manual_seed(gen_seed)

    def same(tag, got, want):
        if not torch.equal(got, want):
            failures.append(f"{tag}: {int((got != want).sum())} elements "
                            "differ from the whole call's rows")

    for i, (name, c, heads, dims) in enumerate(BLOCK_GEOMETRIES):
        for j, shift in enumerate(((0, 0, 0), (4, 4, 2))):
            blk = make_block(c, heads, shift, g, DROP_RATE)
            x = torch.randn((DP_BATCH, *dims, c), generator=g).to(
                "cuda", torch.bfloat16)
            tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
            drop = Dropout((3000 + 2 * (2 * i + j), 3001 + 2 * (2 * i + j)),
                           DROP_RATE, DROP_RATE)
            with torch.no_grad():
                x_win, ops, labels, _ = blk.windows(x, tok)
            base = half * x_win.shape[1]
            at = drop.at(base)
            head = x_win[:half].contiguous()
            tail = x_win[half:].contiguous()
            dout = torch.randn(x_win.shape, generator=g).to(
                "cuda", torch.bfloat16)
            d0, d1 = dout[:half].contiguous(), dout[half:].contiguous()
            tag = block_tag(name, c, heads, dims, x_win, ops, labels)
            with torch.inference_mode():
                whole = fused_swin_block(x_win, ops, labels, drop)
                same(f"B1 {tag} rank 0", fused_swin_block(
                    head, ops, labels, drop), whole[:half])
                out = fused_swin_block(tail, ops, labels, at)
                same(f"B1 {tag} rank 1", out, whole[half:])
                ref = block_reference(tail, ops, labels, at)
                torch.cuda.synchronize()
                res["B1"]["errs"].append(check_close(
                    f"B1 {tag} base {base}", out, ref, failures))
                t_k = cuda_ms(lambda: fused_swin_block(tail, ops, labels, at))
                t_p = cuda_ms(lambda: block_reference(tail, ops, labels, at),
                              3)
            res["B1"]["bound"].add(*block_work(tail, ops, labels))
            res["B1"]["ms"] += t_k
            res["B1"]["plain_ms"] += t_p
            dx, g_all = block_backward(x_win, dout, ops, labels, drop)
            dx0, g_0 = block_backward(head, d0, ops, labels, drop)
            dx1, g_1 = block_backward(tail, d1, ops, labels, at)
            dx1b, g_1b = block_backward(tail, d1, ops, labels, at)
            rdx, r_1 = block_backward_reference(tail, d1, ops, labels, at)
            torch.cuda.synchronize()
            same(f"B4 {tag} rank 0 dx", dx0, dx[:half])
            same(f"B4 {tag} rank 1 dx", dx1, dx[half:])
            errs = []
            for gname, got, again, want, other, full in zip(
                    names, (dx1, *g_1), (dx1b, *g_1b), (rdx, *r_1),
                    (None, *g_0), (None, *g_all)):
                if want is None:
                    continue
                if not torch.equal(got, again):
                    failures.append(f"B4 {tag} d{gname}: two runs differ")
                err, limit = _close(got, want, GRAD_TOL)
                errs.append(err)
                if not err <= limit:
                    failures.append(f"B4 {tag} d{gname}: {err} > {limit}")
                if other is not None:
                    err, limit = _close(got + other, full, GRAD_TOL)
                    if not err <= limit:
                        failures.append(f"B4 {tag} d{gname} summed over "
                                        f"the ranks: {err} > {limit}")
            res["B4"]["errs"] += errs
            t_bk = cuda_ms(lambda: block_backward(tail, d1, ops, labels, at))
            t_bp = cuda_ms(lambda: block_backward_reference(
                tail, d1, ops, labels, at), 3)
            res["B4"]["bound"].add(*block_bwd_work(tail, ops, labels))
            res["B4"]["ms"] += t_bk
            res["B4"]["plain_ms"] += t_bp
            print(f"  {tag}: B1 {t_k:.4f} ms (plain {t_p:.4f}); B4 "
                  f"{t_bk:.4f} ms (plain {t_bp:.4f}), max gradient error "
                  f"{max(errs):.4g}")
    for i, (name, c, heads, dims) in enumerate(BLOCK_GEOMETRIES):
        pair = make_pair(c, heads, g, DROP_RATE)
        x = torch.randn((DP_BATCH, *dims, c), generator=g).to(
            "cuda", torch.bfloat16)
        toks = tuple((0.5 * torch.randn((64, c), generator=g)).cuda()
                     for _ in range(2))
        d0 = Dropout((4000 + 4 * i, 4001 + 4 * i), DROP_RATE, DROP_RATE)
        d1 = Dropout((4002 + 4 * i, 4003 + 4 * i), DROP_RATE, DROP_RATE)
        with torch.inference_mode():
            x_win, ops0, ops1, labels, plan, _ = pair.pair_windows(x, toks)
            base = half * x_win.shape[1]
            a0, a1 = d0.at(base), d1.at(base)
            head = x_win[:half].contiguous()
            tail = x_win[half:].contiguous()
            tag = (f"{name} C{c} h{heads} {'x'.join(map(str, dims))} "
                   f"BP{tail.shape[0] * tail.shape[1]} M{x_win.shape[2]}")
            whole = fused_swin_pair(x_win, ops0, ops1, labels, plan, d0, d1)
            same(f"B5 {tag} rank 0", fused_swin_pair(
                head, ops0, ops1, labels, plan, d0, d1), whole[:half])
            out = fused_swin_pair(tail, ops0, ops1, labels, plan, a0, a1)
            same(f"B5 {tag} rank 1", out, whole[half:])
            ref = pair_reference(tail, ops0, ops1, labels, plan, a0, a1)
            torch.cuda.synchronize()
            res["B5"]["errs"].append(check_close(
                f"B5 {tag} base {base}", out, ref, failures))
            t_k = cuda_ms(lambda: fused_swin_pair(tail, ops0, ops1, labels,
                                                  plan, a0, a1))
            t_p = cuda_ms(lambda: pair_reference(tail, ops0, ops1, labels,
                                                 plan, a0, a1), 3)
        res["B5"]["bound"].add(*pair_work(tail, ops0, ops1, labels))
        res["B5"]["ms"] += t_k
        res["B5"]["plain_ms"] += t_p
        print(f"    B5 {t_k:.4f} ms (plain {t_p:.4f})")
    if failures:
        raise RuntimeError("phase dp-kernels failed: " + "; ".join(failures))
    for key, r in res.items():
        r["max_abs_err"] = max(r.pop("errs"))
        print(f"  {key} at rank 1's calls: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, bound {r['bound'].ms:.4f} "
              f"({r['bound'].by}), max_abs_err {r['max_abs_err']:.6g})")
    return res


def dp_hparams(root: Path, name: str, **over) -> Namespace:
    """The flagship training config over ``root`` as ``main.main`` takes
    it (downstream mode, logs under ``root/name``), a Gaussian test over
    the same volumes, and ``over``."""
    hp = train_hparams(root)
    hp.__dict__.update(
        training_mode="downstream", backbone="swin_unetr", run_name=name,
        log_dir=str(root / name / "log"),
        summary_dir=str(root / name / "summary"),
        image_dir_test=str(root / "img"), mask_dir_test=str(root / "msk"),
        test_blending="gaussian", **over)
    return hp


def _tokens(model) -> dict:
    return {n: p.detach().float().cpu().clone()
            for n, p in model.named_parameters() if "prompt_tokens" in n}


def _token_err(got: dict, want: dict) -> float:
    """Largest token difference over the largest token magnitude."""
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    return err / max(float(v.abs().max()) for v in want.values())


def phase_dp_nccl(card: str):
    """A real NCCL process group of one rank, started by ``main.main``
    from the config's ``distributed: true, num_processes: 1, process_id:
    0`` (``mesh_data: -1``, the whole world: DDP, the loss and metric
    all-reduces): the downstream fit at the flagship training config
    (batch 2, 6 steps, dropout 0.1/0.1, 2 validation forwards) and a
    Gaussian ``test()`` against the same without a process group (both
    on cuDNN's deterministic algorithms); losses and prompt tokens within
    DP_NCCL_RTOL, metrics equal, launches equal."""
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    print("phase dp-nccl: main.main over an NCCL process group of one rank "
          "vs no process group (flagship training config, then Gaussian "
          "test)")
    failures, runs = [], {}
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    os.environ["MIVP_TENSORBOARD"] = "0"
    # Both arms on cuDNN's deterministic algorithms: the comparison is of
    # the two paths' arithmetic, not of atomics' summation order.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            write_train_set(root)
            for name, over in (("single", {}), ("nccl", dict(
                    mesh_data=-1, distributed=True,
                    coordinator_address=f"localhost:{port}",
                    num_processes=1, process_id=0))):
                hp = dp_hparams(root, name, **over)
                torch.cuda.synchronize()
                reset_counters()
                fit = cli_main.main("fit", hp)
                torch.cuda.synchronize()
                fit_launches = read_counters()
                if name == "nccl" and not (
                        dist.is_initialized()
                        and dist.get_backend() == "nccl"
                        and dist.get_world_size() == 1
                        and fit.ddp is not fit.model):
                    failures.append("no NCCL process group or no DDP")
                hp.load_ckpt_prompt_tokens = False
                reset_counters()
                tst = cli_main.main("test", hp)
                torch.cuda.synchronize()
                runs[name] = {"losses": list(fit.losses),
                              "step_ms": float(np.median(fit.step_ms)),
                              "tokens": _tokens(fit.model),
                              "metrics": tst.metric_vals,
                              "launches": fit_launches,
                              "test_launches": read_counters()}
                del fit, tst
    finally:
        torch.backends.cudnn.deterministic = deterministic
        os.environ.pop("MIVP_TENSORBOARD", None)
        if dist.is_initialized():
            dist.destroy_process_group()
    one, nccl = runs["single"], runs["nccl"]
    if len(one["losses"]) != 6 or len(nccl["losses"]) != 6:
        failures.append(f"steps {len(one['losses'])} / {len(nccl['losses'])}")
    for i, (a, b) in enumerate(zip(nccl["losses"], one["losses"])):
        rel = abs(a - b) / max(abs(b), 1e-12)
        print(f"  step {i}: loss {a:.8f} (NCCL group) vs {b:.8f} (none), "
              f"rel {rel:.3g}")
        if not rel <= DP_NCCL_RTOL:
            failures.append(f"step {i} loss {a} vs {b}")
    terr = _token_err(nccl["tokens"], one["tokens"])
    print(f"  prompt tokens: max difference {terr:.3g} of the largest")
    if not terr <= DP_NCCL_RTOL:
        failures.append(f"prompt tokens differ by {terr}")
    if nccl["metrics"] != one["metrics"]:
        failures.append(f"test metrics {nccl['metrics']} vs {one['metrics']}")
    print(f"  test IoU {nccl['metrics']['iou']} (equal: "
          f"{nccl['metrics'] == one['metrics']})")
    # 6 steps of 12 B1 + 12 B4, 2 validation forwards of 12 B1 + 3 B2.
    if nccl["launches"] != one["launches"] or nccl["launches"] != \
            expect({"B1": 6 * 12 + 2 * 12, "B2": 2 * 3, "B4": 6 * 12}):
        failures.append(f"fit launches {nccl['launches']} vs "
                        f"{one['launches']}")
    if nccl["test_launches"] != one["test_launches"]:
        failures.append(f"test launches {nccl['test_launches']} vs "
                        f"{one['test_launches']}")
    print(f"  fit step median: NCCL group {nccl['step_ms']:.3f} ms, no group "
          f"{one['step_ms']:.3f} ms (host clock, on {card})")
    if failures:
        raise RuntimeError("phase dp-nccl failed: " + "; ".join(failures))
    return {"launches": nccl["launches"], "test_launches":
            nccl["test_launches"], "step_ms": nccl["step_ms"],
            "single_step_ms": one["step_ms"]}


def dp_serve_conf(mesh: bool) -> dict:
    return {"roi_size": [128, 128, 8], **({"mesh_data": 2} if mesh else {})}


def dp_serve(conf: dict, out: Path, tag: str):
    """The flagship model (seeded) serving :func:`serve_volume` at stride
    0.75 through ``infer.make_runner`` (in memory: the stitched
    probabilities, timed) and ``infer.serve_volumes`` (from disk, to
    ``out/seg_<tag>.nii.gz``); returns (probabilities, labels, launches of
    the in-memory forward, in-memory ms)."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import save_nifti
    from medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
        import make_runner, serve_volumes
    from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel \
        import window_starts
    model = flagship_model()
    vol = serve_volume()
    runner = make_runner(conf, model, stride=0.75, coverage="crop")
    slices = window_starts(vol.shape, (128, 128, 8), runner.stride)[0]
    crop = np.ascontiguousarray(vol[slices][..., None])
    with torch.inference_mode():
        runner(crop)
        torch.cuda.synchronize()
        reset_counters()
        probs = runner(crop)
        torch.cuda.synchronize()
        launches = read_counters()
        ms = 1e3 * min(_wall(lambda: runner(crop)) for _ in range(3))
    src = out / "ct.nii.gz"
    if not src.exists():
        save_nifti(str(src), vol)
    done = serve_volumes(conf, model, [(src, out / f"seg_{tag}.nii.gz")],
                         stride=0.75, coverage="crop")
    if done != (1, 0):
        raise RuntimeError(f"serve_volumes: {done}")
    return probs.cpu(), probs.argmax(-1).cpu(), launches, ms


def _wall(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def dp_rank_main(rank: int, port: int, root: Path) -> int:
    """One rank of phase ``dp-two-ranks``: a gloo group of two processes
    over CUDA tensors on the one card, started here; the downstream fit
    at ``mesh_data: 2`` (global batch DP_BATCH) and the DP serving."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import get_fit_loader_downstream
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        import SegmentationTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    hp = train_hparams(root)
    hp.batch_size_downstream, hp.mesh_data = DP_BATCH, 2
    train_loader, _ = get_fit_loader_downstream(hp)
    tr = SegmentationTrainer(hp, SwinUnetR, train_loader, None, _Quiet())
    torch.cuda.synchronize()
    reset_counters()
    tr.train()
    torch.cuda.synchronize()
    launches = read_counters()
    probs, labels, serve_launches, serve_ms = dp_serve(
        dp_serve_conf(True), root, f"rank{rank}")
    if rank == 0:
        torch.save({"tokens": _tokens(tr.model), "probs": probs,
                    "labels": labels}, root / "rank0.pt")
    (root / f"rank{rank}.json").write_text(json.dumps({
        "losses": tr.losses, "step_ms": tr.step_ms, "launches": launches,
        "serve_launches": serve_launches, "serve_ms": serve_ms,
        "backend": dist.get_backend(), "world": dist.get_world_size()}))
    dist.destroy_process_group()
    return 0


def phase_dp_two_ranks(card: str):
    """Two processes on the one card, a gloo group over CUDA tensors
    (NCCL takes one rank per device): the downstream fit at mesh_data: 2,
    global batch DP_BATCH (2 rows per rank), dropout 0.1/0.1, DP_STEPS
    steps, against the one-process fit of the same global batches (loss
    within TRAIN_LOSS_RTOL per step, prompt tokens within GRAD_TOL of the
    largest), each rank's launches exact; then DP serving of the
    320x320x24 volume (each rank 14 of the 28-window chunk, the logits
    gathered) against one-process serving (labels >= 0.999, stitched
    probabilities within KERNEL_TOL), rank 0 alone writing the labels.
    Two ranks on one card share it: their times measure no scaling."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import load_nifti
    print(f"phase dp-two-ranks: mesh_data 2 over a gloo group of two "
          f"processes on one card, downstream fit at global batch "
          f"{DP_BATCH}, then serving")
    if dist.is_initialized():
        raise RuntimeError("phase dp-two-ranks: a process group is open")
    import socket
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_train_set(root)
        hp = train_hparams(root)
        hp.batch_size_downstream = DP_BATCH
        one, _, _ = run_trainer(hp, True)
        one_probs, one_labels, _, one_serve_ms = dp_serve(
            dp_serve_conf(False), root, "single")
        sock = socket.socket()
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
        sock.close()
        env = {k: v for k, v in os.environ.items() if k not in (
            "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dp-rank",
             str(r), "--dp-port", str(port), "--dp-root", str(root)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DP_RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"phase dp-two-ranks: rank {r} exited "
                                   f"{p.returncode}:\n{log[-3000:]}")
        ranks = [json.loads((root / f"rank{r}.json").read_text())
                 for r in range(2)]
        got = torch.load(root / "rank0.pt")
        written = sorted(q.name for q in root.glob("seg_*.nii.gz"))
        vols = {q: load_nifti(str(root / q))[0] for q in written}
    want = expect({"B1": 12, "B4": 12}, DP_STEPS)
    for r, res in enumerate(ranks):
        print(f"  rank {r} ({res['backend']}, world {res['world']}): "
              f"launches {res['launches']}; serving launches "
              f"{res['serve_launches']}")
        if res["launches"] != want:
            failures.append(f"rank {r} launches {res['launches']}, "
                            f"expected {want}")
        if res["serve_launches"] != expect({"B1": 12, "B2": 3}):
            failures.append(f"rank {r} serving launches "
                            f"{res['serve_launches']}")
        if res["losses"] != ranks[0]["losses"]:
            failures.append(f"rank {r} logged other losses")
    if len(one.losses) != DP_STEPS:
        failures.append(f"one process took {len(one.losses)} steps")
    for i, (a, b) in enumerate(zip(ranks[0]["losses"], one.losses)):
        rel = abs(a - b) / max(abs(b), 1e-12)
        print(f"  step {i}: loss {a:.6f} (two ranks) vs {b:.6f} (one "
              f"process), rel {rel:.3g} (tol {TRAIN_LOSS_RTOL})")
        if not (np.isfinite(a) and rel <= TRAIN_LOSS_RTOL):
            failures.append(f"step {i} loss {a} vs {b}")
    terr = _token_err(got["tokens"], _tokens(one.model))
    print(f"  prompt tokens: max difference {terr:.4g} of the largest "
          f"(tol {GRAD_TOL})")
    if not terr <= GRAD_TOL:
        failures.append(f"prompt tokens differ by {terr}")
    perr = float((got["probs"] - one_probs).abs().max())
    agree = float((got["labels"] == one_labels).float().mean())
    print(f"  serving: probabilities max difference {perr:.4g} (tol "
          f"{KERNEL_TOL}), labels agree {agree:.6f} (min "
          f"{SERVE_MIN_LABEL_AGREEMENT}); label files written: {written}")
    if not perr <= KERNEL_TOL:
        failures.append(f"served probabilities differ by {perr}")
    if not agree >= SERVE_MIN_LABEL_AGREEMENT:
        failures.append(f"served labels agree {agree}")
    if written != ["seg_rank0.nii.gz", "seg_single.nii.gz"]:
        failures.append(f"label files {written}")
    else:
        vol_agree = float((vols["seg_rank0.nii.gz"]
                           == vols["seg_single.nii.gz"]).mean())
        print(f"  written label volumes agree {vol_agree:.6f}")
        if vols["seg_rank0.nii.gz"].shape != (320, 320, 24) or \
                not vol_agree >= SERVE_MIN_LABEL_AGREEMENT:
            failures.append(f"written labels agree {vol_agree}")
    step_ms = [float(np.median(r["step_ms"])) for r in ranks]
    print(f"  two ranks sharing one card (no scaling measured): step median "
          f"{step_ms} ms vs one process {float(np.median(one.step_ms)):.3f} "
          f"ms at batch {DP_BATCH}; in-memory serve "
          f"{[round(r['serve_ms'], 3) for r in ranks]} ms vs "
          f"{one_serve_ms:.3f} ms, on {card}")
    if failures:
        raise RuntimeError("phase dp-two-ranks failed: " + "; ".join(failures))
    return {"launches": [r["launches"] for r in ranks],
            "serve_launches": [r["serve_launches"] for r in ranks],
            "step_ms": step_ms}


NATIVE_ROUNDS = 3    # alternating (native, numpy) rounds of from-disk serving
NATIVE_REPEATS = 10  # volumes per round and arm
TRACE_VOLUMES = 10   # split 0.75: 7 train volumes x 2 crops = 7 steps
TRACE_STEPS = (2, 6)  # the trainers' StepProfiler window (both included)
WINDOW_ULPS = 1          # native windowing vs numpy: at most 1 fp32 ulp


def phase_native_serve(model, card: str):
    """The native data-path library (``data/native.py``): built from
    ``native/miseg_native.cpp``, its four entries against numpy on the
    seeded 320x320x24 volume (gunzip and decode bytes identical, windowing
    within 1 fp32 ulp, the 27 windows' gather identical); the ``.nii.gz``
    served from disk through ``serve_volumes`` with the native decoder
    (12 B1 + 3 B2 per forward) and with the numpy one, labels equal to
    each other and to the in-memory ``predict_device`` run; vol/s of the
    two decoders in alternating repeated arms.  Returns launches, the
    arms' vol/s and the build seconds."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import load_nifti, native, save_nifti
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        .transforms import load_served, scale_intensity_range
    from medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
        import make_runner, predict_device, serve_volumes
    from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel \
        import window_starts
    print("phase native-serve: the native data library against numpy, and "
          "the 320x320x24 int16 volume served from disk with each decoder")
    failures = []
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    print(f"  native library {lib.name} ready in {build_s:.3f} s (g++ "
          f"{' '.join(native.CXXFLAGS)} {' '.join(native.LDFLAGS)})")
    vol = serve_volume()
    roi = (128, 128, 8)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "ct.nii.gz"
        save_nifti(str(src), vol)
        packed = src.read_bytes()
        raw = native.gunzip(packed)
        same_gz = raw.tobytes() == zlib.decompress(packed,
                                                   16 + zlib.MAX_WBITS)
        f32 = vol.astype(np.float32)
        same_i16 = np.array_equal(native.decode_f32(
            vol.tobytes(order="F"), 4, vol.shape, 1.0, 0.0), f32)
        same_f32 = np.array_equal(native.decode_f32(
            f32.tobytes(order="F"), 16, vol.shape, 1.0, 0.0), f32)
        win = scale_intensity_range(f32)
        plain_win = scale_intensity_range(f32, native=False)
        ulps = int(np.abs(win.view(np.int32) - plain_win.view(np.int32))
                   .max())
        slices, starts, _ = window_starts(vol.shape, roi, 0.75)
        crop = np.ascontiguousarray(win[slices])[..., None]
        windows = native.extract_windows(crop, starts, roi)
        same_win = len(starts) == BATCH and np.array_equal(windows, np.stack(
            [crop[a:a + roi[0], b:b + roi[1], c:c + roi[2]]
             for a, b, c in starts]))
        print(f"  gunzip bytes identical {same_gz}; decode identical: int16 "
              f"{same_i16}, float32 {same_f32}; windowing vs numpy at most "
              f"{ulps} ulp (limit {WINDOW_ULPS}); {len(starts)} windows' gather "
              f"identical {same_win}")
        if not (same_gz and same_i16 and same_f32 and same_win):
            failures.append("a native entry differs from numpy")
        if ulps > WINDOW_ULPS:
            failures.append(f"windowing {ulps} ulp from numpy")

        conf = {"roi_size": list(roi)}
        set_mode(model, "fused").set_kernels(True)
        runner = make_runner(conf, model, chunk=None, stride=0.75,
                             device_windowing=True, coverage="crop")
        labels = {}
        for native_dec in (True, False):
            dst = Path(tmp) / f"seg_{native_dec}.nii.gz"
            if serve_volumes(conf, None, [(src, dst)], runner=runner,
                             native=native_dec) != (1, 0):
                raise RuntimeError("phase native-serve failed: serve")
            labels[native_dec] = load_nifti(str(dst))[0]
        decoded = load_served(str(src), True)
        pred, sl = predict_device(runner, roi, decoded)
        mem = np.zeros(vol.shape, np.int16)
        mem[sl] = pred.cpu().numpy()
        same = {"numpy decoder": np.array_equal(labels[True], labels[False]),
                "in memory": np.array_equal(labels[True], mem)}
        print(f"  native-decoder labels equal to: {same}; foreground share "
              f"{float((mem > 0).mean()):.4f}")
        if not all(same.values()):
            failures.append(f"labels differ: {same}")

        rates = {True: [], False: []}
        launches = None
        for r in range(NATIVE_ROUNDS):
            for native_dec in ((True, False) if r % 2 == 0
                               else (False, True)):
                pairs = [(src, Path(tmp) / f"r{r}_{native_dec}_{i}.nii.gz")
                         for i in range(NATIVE_REPEATS)]
                torch.cuda.synchronize()
                reset_counters()
                t0 = time.perf_counter()
                done = serve_volumes(conf, None, pairs, runner=runner,
                                     native=native_dec)
                dt = time.perf_counter() - t0
                got = read_counters()
                if done != (NATIVE_REPEATS, 0):
                    raise RuntimeError(f"phase native-serve failed: {done}")
                want = expect({"B1": 12, "B2": 3}, NATIVE_REPEATS)
                if got != want:
                    failures.append(f"launches {got}, expected {want}")
                if native_dec and launches is None:
                    launches = got
                rates[native_dec].append(NATIVE_REPEATS / dt)
    for native_dec, name in ((True, "native"), (False, "numpy")):
        v = rates[native_dec]
        print(f"  from disk, {name} decoder: vol/s {[round(x, 4) for x in v]}"
              f" (median {np.median(v):.4f}, spread {min(v):.4f}-"
              f"{max(v):.4f}) on {card}")
    print(f"  launches per {NATIVE_REPEATS} served volumes: {launches}")
    if failures:
        raise RuntimeError("phase native-serve failed: " + "; ".join(failures))
    return {"launches": launches, "native_vps": rates[True],
            "numpy_vps": rates[False], "build_s": build_s}


def phase_segment_volume(model, card: str):
    """``infer.segment_volume`` on the 320x320x24 volume windowed on the
    host (stride 0.75, 27 windows, one forward): labels equal to
    ``predict_device``'s argmax on the same input and runner settings,
    12 B1 + 3 B2."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        .transforms import scale_intensity_range
    from medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
        import make_runner, predict_device, segment_volume
    print("phase segment-volume: infer.segment_volume of the host-windowed "
          "320x320x24 volume, flagship model, fused blocks")
    roi = (128, 128, 8)
    conf = {"roi_size": list(roi)}
    vol = scale_intensity_range(serve_volume().astype(np.float32))[..., None]
    set_mode(model, "fused").set_kernels(True)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    labels = segment_volume(conf, model, vol, stride=0.75)
    dt = time.perf_counter() - t0
    launches = read_counters()
    runner = make_runner(conf, model, stride=0.75, device_windowing=False,
                         coverage="crop")
    pred, sl = predict_device(runner, roi, vol)
    want = np.zeros(vol.shape[:3], np.int16)
    want[sl] = pred.cpu().numpy()
    print(f"  labels {labels.shape} {labels.dtype} in {dt:.4f} s on {card}; "
          f"equal to predict_device's {np.array_equal(labels, want)}; "
          f"launches {launches}")
    failures = []
    if not np.array_equal(labels, want):
        failures.append("labels differ from predict_device's")
    if launches != expect({"B1": 12, "B2": 3}):
        failures.append(f"launches {launches}")
    if failures:
        raise RuntimeError("phase segment-volume failed: "
                           + "; ".join(failures))
    return launches


def trace_counts(path: Path):
    """Kernel events by name part, and (busy us, span us) over the device
    work (kernels, copies, fills) of a Chrome trace."""
    trace = json.loads(path.read_text())
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK]
    counts = {key: sum(1 for e in events if e.get("cat") == "kernel"
                       and key in e["name"])
              for key in ("fused_swin_block_kernel", "fused_block_bwd_kernel",
                          "bwd_reduce_kernel")}
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events]
    return counts, busy_and_span(spans) if spans else (0.0, 0.0)


def phase_profile_trace(card: str):
    """``main.main`` fits the flagship training config (batch 2, dropout
    0.1/0.1) for 7 steps with ``profile_dir`` set: the trainer's
    ``StepProfiler`` writes one Chrome trace of global steps 2-6, whose
    B1 and B4 kernel events equal the launch counters over those steps
    (5 x 12 each); the trace's busy share over kernels, copies and fills.
    """
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch import \
        main as cli_main
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        .common import StepProfiler
    print("phase profile-trace: main.main fit with profile_dir, flagship "
          f"training config, {TRACE_VOLUMES} volumes")
    os.environ["MIVP_TENSORBOARD"] = "0"
    window = {}
    begin, end = StepProfiler.step_begin, StepProfiler.step_end

    def step_begin(self, step):
        if step == self.trace_start:
            window["start"] = read_counters()
        begin(self, step)

    def step_end(self, step):
        end(self, step)
        if step == self.trace_stop:
            window["stop"] = read_counters()

    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_train_set(root, TRACE_VOLUMES)
        hp = dp_hparams(root, "fit", profile_dir=str(root / "profile"))
        StepProfiler.step_begin, StepProfiler.step_end = step_begin, step_end
        try:
            torch.cuda.synchronize()
            reset_counters()
            tr = cli_main.main("fit", hp)
            torch.cuda.synchronize()
        finally:
            StepProfiler.step_begin, StepProfiler.step_end = begin, end
        launches = read_counters()
        steps = len(tr.losses)
        traces = sorted((root / "profile").iterdir())
        print(f"  {steps} steps, launches {launches}; trace files "
              f"{[p.name for p in traces]} "
              f"({sum(p.stat().st_size for p in traces)} bytes)")
        if (tr.profiler.trace_start, tr.profiler.trace_stop) != TRACE_STEPS \
                or steps < TRACE_STEPS[1] + 1 or len(traces) != 1:
            raise RuntimeError(f"phase profile-trace failed: {steps} steps, "
                               f"{len(traces)} trace files")
        counts, (busy, span) = trace_counts(traces[0])
    n = TRACE_STEPS[1] - TRACE_STEPS[0] + 1
    delta = {k: window["stop"][k] - window["start"][k] for k in ("B1", "B4")}
    print(f"  trace of steps {TRACE_STEPS[0]}-{TRACE_STEPS[1]}: kernel events "
          f"{counts}; launch counters over the same steps {delta}")
    print(f"  trace device work (kernels, copies, fills): busy "
          f"{busy / 1e3 / n:.3f} ms per step of a {span / 1e3 / n:.3f} ms "
          f"span, busy share {busy / max(span, 1e-9):.4f} on {card}")
    want = {"B1": 12 * n, "B4": 12 * n}
    got = {"B1": counts["fused_swin_block_kernel"],
           "B4": counts["fused_block_bwd_kernel"]}
    if not (got == delta == want):
        failures.append(f"trace events {got}, launch counters {delta}, "
                        f"expected {want}")
    if counts["bwd_reduce_kernel"] != want["B4"]:
        failures.append(f"{counts['bwd_reduce_kernel']} B4 reductions in "
                        f"the trace, expected {want['B4']}")
    if failures:
        raise RuntimeError("phase profile-trace failed: "
                           + "; ".join(failures))
    return {"launches": launches, "trace_events": got,
            "busy_share": busy / span, "busy_ms": busy / 1e3 / n}


def phase_flops(card: str, serve_vps_mem: float, phase2: dict,
                phase1: dict):
    """Model FLOPs per flagship window (``utils/flops.py``) beside the JAX
    package's 24.43 GFLOP cost analysis, the card's peak, and the shares
    of it that the in-memory serving rate and the phase-2 / phase-1 steps
    reach (their plain steps' products over their kernel step medians).
    """
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import flagship_conf
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        .flops import chip_peak_tflops, forward_flops
    print("phase flops: FLOP counts and shares of the card's peak")
    count = forward_flops(flagship_conf(), 1, roi=(128, 128, 8))
    peak = chip_peak_tflops() * 1e12
    print(f"  flagship, one 128x128x8 window: model {count.model / 1e9:.3f} "
          f"GFLOP (as the port executes it {count.port / 1e9:.3f}, the JAX "
          f"forward's products {count.jax / 1e9:.3f}); the JAX package's XLA "
          "cost analysis 24.43 (bench.py)")
    print(f"  {torch.cuda.get_device_name(0)}: dense bf16 peak "
          f"{peak / 1e12:.1f} TFLOP/s ({card})")
    serve = count.model * BATCH * serve_vps_mem / peak
    print(f"  in-memory serving: {count.model / 1e9:.3f} GFLOP x {BATCH} "
          f"windows x {serve_vps_mem:.4f} vol/s = {serve:.6f} of the peak "
          f"(MFU) on {card}")
    out = {"model_gflop": count.model / 1e9, "port_gflop": count.port / 1e9,
           "jax_gflop": count.jax / 1e9, "peak_tflops": peak / 1e12,
           "serve_mfu": serve}
    for name, r in (("phase-2 (supervised_learning_all)", phase2),
                    ("phase-1 (batch 2)", phase1)):
        share = r["step_flops"] / (r["step_ms"] / 1e3) / peak
        print(f"  {name} step: {r['step_flops'] / 1e9:.3f} GFLOP of products "
              f"(plain step) in a {r['step_ms']:.3f} ms median kernel step = "
              f"{share:.6f} of the peak on {card}")
        out[name.split()[0]] = share
    return out


def kernel_entry(name, source, replaces, launches, by_path, m, **extra):
    bound = m["bound"]
    return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
            "replaces": f"{JAX_PKG}/{replaces}", "launches": launches,
            "launches_by_path": by_path, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": bound.ms,
            "bound_by": bound.by, "library_ms": m.get("library_ms"), **extra}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if "--dp-rank" in sys.argv:          # one rank of phase dp-two-ranks
        arg = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return dp_rank_main(int(arg["--dp-rank"]), int(arg["--dp-port"]),
                            Path(arg["--dp-root"]))
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import kernels
    from medical_image_segmentation_with_visual_prompts_tpu_torch.utils \
        import trace as tracer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    tracer.enable()
    lib = kernels.library()
    built = tracer.collect()
    tracer.disable()
    build_ms = [s["host_ms"] for s in built["spans"]
                if s["name"] == "kernels.build"]
    print(f"kernels ready in {time.perf_counter() - start:.2f} s "
          f"(kernels.build {build_ms} ms, kernels.builds "
          f"{built['counters'].get('kernels.builds')}): {lib._name}")

    def clock(phase):
        print(f"[{time.perf_counter() - start:.1f} s] {phase}")

    b1 = phase_blocks()
    clock("B1 done")
    b2, b3 = phase_convs()
    clock("B2, B3 done")
    attn = phase_attention()
    clock("B6-B8 done")
    b1_train, b4 = phase_blocks_train()
    clock("blocks-train done")
    b5, b5_train = phase_pair()
    clock("B5 done")
    model = flagship_model()
    fused = {"B1": 12, "B2": 3}
    fwd_ms, _ = phase_model(model, fused)
    serve_launches, vps, vps_mem = phase_serve(model, card, fused)
    clock("model, serve done")
    nat = phase_native_serve(model, card)
    seg_launches = phase_segment_volume(model, card)
    clock("native-serve, segment-volume done")
    ufwd_ms, _ = phase_model(model, UNFUSED_LAUNCHES, "unfused")
    unfused_launches, uvps, uvps_mem = phase_serve(
        model, card, UNFUSED_LAUNCHES, "unfused")
    clock("model-unfused, serve-unfused done")
    pair = {"B5": 6, "B2": 3}
    pfwd_ms, _ = phase_model(model, pair, "pair")
    pair_launches, pvps, pvps_mem = phase_serve(model, card, pair, "pair")
    clock("model-pair, serve-pair done")
    del model
    train_launches, losses, step_ms, _ = phase_train(card)
    clock("train done")
    tpair_launches, _, pstep_ms, _ = phase_train(card, True,
                                                 (losses, step_ms))
    clock("train-pair done")
    trace = phase_profile_trace(card)
    clock("profile-trace done")
    model = example_model()
    # Seeded random weights without prompts leave this model's two logits
    # close on many voxels of the noise batch (narrower margins than the
    # flagship's), so its agreement there is printed and the served CT
    # volume's labels carry the 0.999 gate.
    f32_fwd_ms, _ = phase_model(model, fused, name="fp32", gate_argmax=False)
    f32_launches, fvps, fvps_mem = phase_serve(model, card, fused,
                                               name="fp32")
    del model
    clock("model-fp32, serve-fp32 done")
    tf32_launches, _, _, _ = phase_train(card, fp32=True)
    clock("train-fp32 done")
    b4_big = phase_b4_device_memory()
    cli = phase_cli(card)
    clock("b4-device-memory, cli done")
    lay = phase_layouts(card)
    clock("layouts done")
    b1_st, b4_st = phase_blocks_train(SEED + 13, STUDENT_GEOMETRIES,
                                      "students-blocks")
    b2_st, _ = phase_convs(SEED + 14, STUDENT_CONVS, TRAIN_BATCH,
                           one_input=False)
    st = phase_students_teacher(card)
    clock("students-blocks, students-teacher done")
    mvb = phase_multi_view_blocks()
    clock("multi-view-blocks done")
    mv = phase_multi_view(card)
    mvm = phase_multi_view_mutual(card)
    clock("multi-view, multi-view-mutual done")
    fl = phase_flops(card, vps_mem, st, mv)
    ugrad = phase_unfused_grads()
    clock("unfused-grads done")
    tu = phase_train_unfused(card)
    clock("train-unfused done")
    pu = phase_pretrain_unfused(card)
    clock("pretrain-unfused done")
    views = phase_view(card)
    conv = phase_convert(card)
    clock("view, convert done")
    dpk = phase_dp_kernels()
    clock("dp-kernels done")
    dpn = phase_dp_nccl(card)
    clock("dp-nccl done")
    dpt = phase_dp_two_ranks(card)
    clock("dp-two-ranks done")

    print("serve-path times are per 27-window flagship forward, train-path "
          "times per training step of batch 2 (sums over the path's calls), "
          "CUDA events, on " + card)
    print(f"B1 on the serve path: {b1['ms']:.4f} ms (plain "
          f"{b1['plain_ms']:.4f}, bound {b1['bound'].ms:.4f} "
          f"({b1['bound'].by}), max_abs_err {b1['max_abs_err']:.6g})")
    print(f"fused vs unfused blocks: forward {fwd_ms:.4f} vs {ufwd_ms:.4f} "
          f"ms; B1 {b1['ms']:.4f} ms vs B6 + B8 "
          f"{attn['B6']['ms'] + attn['B8']['ms']:.4f} ms per forward; served "
          f"vol/s from disk {vps:.4f} vs {uvps:.4f}, in memory "
          f"{vps_mem:.4f} vs {uvps_mem:.4f}")
    print(f"block pairs (B5) vs fused blocks (B1): forward {pfwd_ms:.4f} vs "
          f"{fwd_ms:.4f} ms; B5 {b5['ms']:.4f} ms vs B1 + gather + B1 + "
          f"gather {b5['two_launch_ms']:.4f} ms per forward "
          f"({b5['differing']} of {b5['elements']} elements differ); served "
          f"vol/s from disk {pvps:.4f} vs {vps:.4f}, in memory "
          f"{pvps_mem:.4f} vs {vps_mem:.4f}; train step median "
          f"{pstep_ms:.3f} vs {step_ms:.3f} ms")
    print(f"fp32 trunk (example_configs.yml, pad_mode reference): forward "
          f"{f32_fwd_ms:.4f} ms; served vol/s from disk {fvps:.4f}, in "
          f"memory {fvps_mem:.4f}")
    print(f"B4 device-memory form (4 M 256 / C 192 fp32 calls per cli-fit "
          f"step): {b4_big['ms']:.4f} ms (plain {b4_big['plain_ms']:.4f}, "
          f"bound {b4_big['bound'].ms:.4f} ({b4_big['bound'].by}), "
          f"max_abs_err {b4_big['max_abs_err']:.6g})")
    print(f"B4 at the 12 flagship training calls (bf16, batch 2): "
          f"shared-memory form {b4['ms']:.4f} ms, device-memory form forced "
          f"{b4['big_ms']:.4f} ms")
    print(f"cli (example_configs.yml through main --mode fit|test): fit step "
          f"median {cli['step_ms']:.3f} ms; test windows/s per window "
          f"{cli['test_none_wps']:.3f}, Gaussian "
          f"{cli['test_gaussian_wps']:.3f}; checkpoint save "
          f"{cli['save_ms']:.3f} ms, load {cli['load_ms']:.3f} ms")
    print(f"layouts (full/swin, flagship widths): forward {lay['fwd_ms']:.4f}"
          f" ms (flagship none/swin {fwd_ms:.4f}); served vol/s from disk "
          f"{lay['vps']:.4f}, in memory {lay['vps_mem']:.4f}; train step "
          f"median {lay['step_ms']:.3f} ms; output layer B1 "
          f"{lay['b1']['ms']:.4f} ms, B2 {lay['b2']['ms']:.4f} ms per forward")
    print(f"B2: {b2['ms']:.4f} ms per forward vs cuDNN conv3d without the "
          f"prologue {b2['cudnn_ms']:.4f}; B3 no prologue "
          f"{b3['no_prologue_ms']:.4f} vs cuDNN {b3['library_ms']:.4f} ms")
    print(f"students-teacher (supervised_learning_all, flagship model, "
          f"example phase 2): step median {st['step_ms']:.3f} ms (plain "
          f"{st['plain_step_ms']:.3f}); at the students' 24 block calls (both "
          f"crops, batch 2) B1 {b1_st['ms']:.4f} ms (plain "
          f"{b1_st['plain_ms']:.4f}), B4 {b4_st['ms']:.4f} ms (plain "
          f"{b4_st['plain_ms']:.4f}); B2 at their 6 decoder convs "
          f"{b2_st['ms']:.4f} ms (cuDNN without the prologue "
          f"{b2_st['cudnn_ms']:.4f}); prototype loss {st['loss_ms']:.4f} ms")
    print(f"multi-view (phase 1, flagship model, example multi-view "
          f"section): step median {mv['step_ms']:.3f} ms at batch 2 (plain "
          f"{mv['plain_step_ms']:.3f}), {mv['b14_step_ms']:.3f} ms at batch "
          f"{MV_BATCH} (plain {mv['b14_plain_step_ms']:.3f}); at the 12 "
          f"block calls of a batch-{MV_BATCH} step B1 "
          f"{mvb['flagship']['B1']['ms']:.4f} ms (plain "
          f"{mvb['flagship']['B1']['plain_ms']:.4f}), B4 "
          f"{mvb['flagship']['B4']['ms']:.4f} ms (plain "
          f"{mvb['flagship']['B4']['plain_ms']:.4f}); fp32 reference "
          f"padding B1 {mvb['example']['B1']['ms']:.4f} ms, B4 "
          f"{mvb['example']['B4']['ms']:.4f} ms; B5 at its 6 pair calls "
          f"{mvb['B5']['ms']:.4f} ms")

    fused_train = TRAIN_PROFILE["train"]
    print(f"unfused training (flagship, batch {TRAIN_BATCH}): arm (a) "
          f"attention dropout 0: step median {tu['a']['step_ms']:.3f} ms, "
          f"busy {tu['a']['busy_ms']:.3f} ms, idle {tu['a']['idle']:.4f}; "
          f"arm (b) dropout {DROP_RATE}/{DROP_RATE} + use_checkpoint: "
          f"{tu['b']['step_ms']:.3f} ms, busy {tu['b']['busy_ms']:.3f} ms, "
          f"idle {tu['b']['idle']:.4f}; fused step {fused_train[0]:.3f} ms, "
          f"busy {fused_train[1]:.3f} ms, idle {fused_train[2]:.4f}; B6/B8 "
          f"recompute backward {ugrad['B6']['bwd_ms']:.4f} + "
          f"{ugrad['B8']['bwd_ms']:.4f} ms per step (plain autograd "
          f"{ugrad['B6']['plain_bwd_ms']:.4f} + "
          f"{ugrad['B8']['plain_bwd_ms']:.4f}); dropped attention share "
          f"{tu['drop_share']:.6f}; pretraining unfused step medians "
          f"{pu['self_supervised_learning_all']['step_ms']:.3f} (phase 2) / "
          f"{pu[PHASE1]['step_ms']:.3f} ms (phase 1); {len(views)} view "
          f"PNGs; converters round-tripped {conv['leaves']} leaves")

    print(f"data parallel: B1/B4/B5 at rank 1's calls (batch {DP_BATCH}) "
          f"{dpk['B1']['ms']:.4f} / {dpk['B4']['ms']:.4f} / "
          f"{dpk['B5']['ms']:.4f} ms; one NCCL rank step median "
          f"{dpn['step_ms']:.3f} ms vs no group {dpn['single_step_ms']:.3f}; "
          f"two gloo ranks on one card (no scaling) "
          f"{[round(v, 3) for v in dpt['step_ms']]} ms per step")

    print(f"native data library: from-disk vol/s native decoder median "
          f"{np.median(nat['native_vps']):.4f} vs numpy "
          f"{np.median(nat['numpy_vps']):.4f}; profile trace of steps 2-6: "
          f"B1/B4 events {trace['trace_events']}, busy share "
          f"{trace['busy_share']:.4f}; flagship model "
          f"{fl['model_gflop']:.3f} GFLOP per window, serving MFU "
          f"{fl['serve_mfu']:.6f}, phase-2 step {fl['phase-2']:.6f}, phase-1 "
          f"step {fl['phase-1']:.6f} of {fl['peak_tflops']:.1f} TFLOP/s")

    def paths(key):
        return {"serve": serve_launches[key],
                "native-serve": nat["launches"][key],
                "segment-volume": seg_launches[key],
                "profile-trace": trace["launches"][key],
                "serve_unfused": unfused_launches[key],
                "train": train_launches[key],
                "serve_pair": pair_launches[key],
                "train_pair": tpair_launches[key],
                "serve_fp32": f32_launches[key],
                "train_fp32": tf32_launches[key],
                "cli-fit": cli["fit_launches"][key]
                + cli["resume_launches"][key],
                "cli-test": cli["test_launches"][key],
                "cli-infer": cli["infer_launches"][key],
                "layouts-serve": lay["serve"][key],
                "layouts-train": lay["train"][key],
                "layouts-per-window": lay["stitch"]["per_window_launches"][
                    key],
                "layouts-watch": lay["stitch"]["watch_launches"][key],
                "students-teacher-fit": st["launches"][key],
                "students-teacher-decoder": st["decoder_launches"][key],
                "multi-view-fit": mv["launches"][key],
                "multi-view-fit-b14": mv["b14_launches"][key],
                "multi-view-pair": mv["pair_launches"][key],
                "multi-view-mutual": mvm["launches"][key],
                "multi-view-to-phase2": mv["phase2_launches"][key],
                "train-unfused": tu["a"]["launches"][key],
                "train-unfused-dropout": tu["b"]["launches"][key],
                "pretrain-unfused-ssl-all": pu[
                    "self_supervised_learning_all"]["launches"][key],
                "pretrain-unfused-ssl-encoder": pu[PHASE1]["launches"][key],
                "dp-nccl-fit": dpn["launches"][key],
                "dp-nccl-test": dpn["test_launches"][key],
                **{f"dp-two-ranks-fit-rank{r}": got[key]
                   for r, got in enumerate(dpt["launches"])},
                **{f"dp-two-ranks-serve-rank{r}": got[key]
                   for r, got in enumerate(dpt["serve_launches"])},
                **{f"layouts-forward-{path}": got[key]
                   for path, got in lay["forward"].items()}}

    def output_layer(m, launches, path, **extra):
        return {"calls": "the Swin output layer's, per 27-window forward "
                "(B4: per training step of batch 2)", "launches": launches,
                "launches_path": path,
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound"].ms, "bound_by": m["bound"].by,
                "max_abs_err": m["max_abs_err"], **extra}

    def students(m, key, **extra):
        return {"calls": "the 2 students' (96x96x8, 80x80x8) 24 block calls "
                "of a phase-2 step (B2: their 6 eval decoder convs), batch 2",
                "launches": st["launches"][key],
                "launches_path": "students-teacher-fit",
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound"].ms, "bound_by": m["bound"].by,
                "max_abs_err": m["max_abs_err"], **extra}

    def multi_view(m, key, path, calls, **extra):
        return {"calls": calls, "launches": path_launches(path, key),
                "launches_path": path, "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound"].ms,
                "bound_by": m["bound"].by, "max_abs_err": m["max_abs_err"],
                "library_ms": None, **extra}

    def path_launches(path, key):
        return {"multi-view-fit-b14": mv["b14_launches"],
                "multi-view-pair": mv["pair_launches"]}[path][key]

    def mv_blocks(key, **extra):
        calls = (f"the 12 block calls of a phase-1 step at batch {MV_BATCH} "
                 "(2 views x 3 encoder stages x no-shift/shift), flagship "
                 "(bf16, pad_mode aligned)")
        ex = mvb["example"][key]
        return multi_view(mvb["flagship"][key], key, "multi-view-fit-b14",
                          calls, example_fp32_reference={
                              "ms": ex["ms"], "plain_ms": ex["plain_ms"],
                              "bound_ms": ex["bound"].ms,
                              "bound_by": ex["bound"].by,
                              "max_abs_err": ex["max_abs_err"],
                              **({"device_memory_calls": ex["big_calls"]}
                                 if key == "B4" else {})}, **extra)

    def backward(key):
        r = ugrad[key]
        return {"calls": f"{r['calls']} training calls at batch "
                f"{TRAIN_BATCH} (phase unfused-grads)",
                "route": "plain torch: the JAX package's fp32 recompute "
                "(its custom VJP is XLA, not a kernel)",
                "ms": r["bwd_ms"], "plain_autograd_ms": r["plain_bwd_ms"],
                "max_rel_grad_err": r["max_rel_err"]}

    def train_unfused(key):
        r = ugrad[key]
        lib = ({"library_ms": r["library_ms"],
                "ms_unshifted": r["ms_unshifted"],
                "library_scope": "scaled_dot_product_attention of the "
                f"{r['unshifted_calls']} unshifted calls only (the shifted "
                "calls' multiplicative mask has none)"}
               if r["unshifted_calls"] else
               {"library_ms": None, "library_null_reason": no_library})
        return {"calls": f"the {r['calls']} calls of a training step at "
                f"batch {TRAIN_BATCH} (forward)",
                "launches": tu["a"]["launches"][key],
                "launches_path": "train-unfused",
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"].ms,
                "bound_by": r["bound"].by, **lib,
                "step_ms": tu["a"]["step_ms"], "busy_ms": tu["a"]["busy_ms"],
                "idle_share": tu["a"]["idle"]}

    no_library = ("no single PyTorch call: the in-kernel projections (B6) "
                  "and the multiplicative mask (shifted calls)")

    def data_parallel(key, calls):
        m = dpk[key]
        return {"calls": f"{calls}, rank 1 of 2 of a batch of {DP_BATCH} "
                "(samples [2:]) at its window base, dropout 0.1/0.1 (phase "
                "dp-kernels)", "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound"].ms, "bound_by": m["bound"].by,
                "max_abs_err": m["max_abs_err"], "library_ms": None,
                "launches": {f"rank{r}": got[key]
                             for r, got in enumerate(dpt["launches"])},
                "launches_path": "dp-two-ranks-fit"}
    print(json.dumps({"kernels": [
        kernel_entry("fused_swin_block", "fused_block.cu",
                     "ops/fused_block.py:554", train_launches["B1"],
                     paths("B1"), b1_train)
        | {"serve": {"launches": serve_launches["B1"], "ms": b1["ms"],
                     "plain_ms": b1["plain_ms"],
                     "bound_ms": b1["bound"].ms,
                     "bound_by": b1["bound"].by,
                     "max_abs_err": b1["max_abs_err"]},
           "output_layer": output_layer(
               lay["b1"], lay["serve"]["B1@out"], "layouts-serve",
               library_ms=None,
               cluster=[i["cluster"] for i in lay["b1"]["launch"]]),
           "students": students(b1_st, "B1", library_ms=None),
           "multi_view": mv_blocks("B1"),
           "data_parallel": data_parallel("B1", "the 12 block calls")},
        kernel_entry("conv3x3_fused_pair", "conv3x3_pair.cu",
                     "ops/conv_pallas.py:270", serve_launches["B2"],
                     paths("B2"), b2,
                     library_null_reason="no single PyTorch call: the BN + "
                     "LeakyReLU prologue on two inputs",
                     cudnn_conv3d_ms=b2["cudnn_ms"],
                     cudnn_scope="conv3d of the concat without the "
                     "prologue (less work than B2)", tiles=b2["tiles"],
                     output_layer=output_layer(
                         lay["b2"], lay["serve"]["B2@out"], "layouts-serve",
                         library_ms=lay["b2"]["library_ms"],
                         tile=lay["b2"]["tile"]),
                     students=students(b2_st, "B2", library_ms=None,
                                       cudnn_conv3d_ms=b2_st["cudnn_ms"],
                                       tiles=b2_st["tiles"])),
        kernel_entry("conv3x3_fused", "conv3x3_pair.cu",
                     "ops/conv_pallas.py:41", 0, paths("B3"), b3,
                     no_prologue_ms=b3["no_prologue_ms"],
                     library_scope="cuDNN conv3d of the no-prologue call "
                     "only; no model calls B3"),
        kernel_entry("fused_block_bwd", "fused_block_bwd.cu",
                     "ops/fused_block_bwd.py:158", train_launches["B4"],
                     paths("B4"), b4,
                     library_null_reason="no single PyTorch call computes "
                     "a Swin block's backward")
        | {"device_memory_form": {
            "calls": "the 4 M 256 / C 192 calls of a cli-fit step",
            "launches": cli["big_launches"],
            "ms": b4_big["ms"], "plain_ms": b4_big["plain_ms"],
            "bound_ms": b4_big["bound"].ms, "bound_by": b4_big["bound"].by,
            "max_abs_err": b4_big["max_abs_err"],
            "train_ms_forced": b4["big_ms"],
            "train_ms_forced_scope": "the train path's 12 calls (the "
            "entry's ms) in this form"},
           "output_layer": output_layer(
               lay["b4"], lay["train"]["B4@out"], "layouts-train",
               library_ms=None,
               cluster=[i["cluster"] for i in lay["b4"]["launch"]]),
           "students": students(b4_st, "B4", library_ms=None,
                                device_memory_form_ms=b4_st["big_ms"]),
           "multi_view": mv_blocks("B4"),
           "data_parallel": data_parallel("B4", "the 12 block calls")},
        kernel_entry("fused_swin_pair", "fused_pair.cu",
                     "ops/fused_block.py:592", pair_launches["B5"],
                     paths("B5"), b5,
                     library_null_reason="no single PyTorch call computes "
                     "a Swin block pair",
                     two_launch_ms=b5["two_launch_ms"],
                     differing_vs_two_launches=b5["differing"],
                     elements_compared=b5["elements"])
        | {"train": {"launches": tpair_launches["B5"],
                     "ms": b5_train["ms"], "plain_ms": b5_train["plain_ms"],
                     "bound_ms": b5_train["bound"].ms,
                     "bound_by": b5_train["bound"].by},
           "multi_view": multi_view(
               mvb["B5"], "B5", "multi-view-pair",
               f"the 6 pair calls of a phase-1 step at batch {MV_BATCH} (2 "
               "views x 3 encoder pairs), flagship, dropout; launches from "
               "the batch-2 pair step"),
           "data_parallel": data_parallel("B5", "the 6 pair calls")},
        kernel_entry("window_attention_packed_qkv", "window_attention.cu",
                     "ops/window_attention_pallas.py:388",
                     unfused_launches["B6"], paths("B6"),
                     attn["B6"] | {"library_ms": None},
                     library_null_reason=no_library,
                     backward=backward("B6"),
                     train_unfused=train_unfused("B6"),
                     output_layer=output_layer(
                         lay["b6"], lay["forward"]["full-swin-unfused"][
                             "B6@out"], "layouts-forward-full-swin-unfused",
                         library_ms=None,
                         threads=[i["threads"] for i in lay["b6"]["launch"]])),
        kernel_entry("window_attention_packed", "window_attention.cu",
                     "ops/window_attention_pallas.py:195", 0, paths("B7"),
                     attn["B7"], ms_unshifted=attn["B7"]["ms_unshifted"],
                     backward=backward("B7"),
                     library_scope="scaled_dot_product_attention of the "
                     "unshifted calls only (the shifted calls' "
                     "multiplicative mask has none); no model calls B7"),
        kernel_entry("window_attention", "window_attention.cu",
                     "ops/window_attention_pallas.py:39",
                     unfused_launches["B8"], paths("B8"), attn["B8"],
                     ms_unshifted=attn["B8"]["ms_unshifted"],
                     backward=backward("B8"),
                     train_unfused=train_unfused("B8"),
                     library_scope="scaled_dot_product_attention of the "
                     "unshifted calls only"),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
