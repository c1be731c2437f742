#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (first use) and drives
the port's two paths:

* serving: B1 (fused Swin block) and B2 (pair-input decoder conv) against
  their plain PyTorch versions at every shape the flagship serving path
  gives them, the flagship model (seeded random weights, bf16 trunk) on a
  27-window batch with and without the kernels, then a seeded
  320x320x24 int16 CT volume served through ``infer.make_runner`` /
  ``infer.serve_volumes`` (stride 0.75, 27 windows);
* training: B1 with counter-hash dropout and B4 (the block backward)
  against their plain versions at the six flagship block geometries at
  batch 2, then ``train.SegmentationTrainer.train()`` on a seeded
  synthetic NIfTI set at the flagship training config (dropout 0.1/0.1,
  ``use_checkpoint``, AdamW 5e-4 / 0.1, DiceFocal gamma 4, batch 2 of
  128x128x8 crops), once with the kernels and once with the plain
  versions, and a ``torch.profiler`` breakdown of two kernel steps.

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
import subprocess
import sys
import tempfile
import time
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
# version keeps fp32, and sums across windows with fp32 atomics in a
# run-dependent order (~1e-6 relative between runs).
GRAD_TOL = 2.0 ** -5
# Flagship logits, kernels vs plain versions on the same weights: the
# bf16 rounding differences above pass through 12 blocks and 4 convs.
MODEL_MIN_ARGMAX_AGREEMENT = 0.999
SERVE_MIN_LABEL_AGREEMENT = 0.999
SERVE_REPEATS = 10
# Trainer, kernels vs plain versions from the same weights, crops and
# dropout seeds: per-step loss within 2% relative.  Each step's loss is a
# mean over 2x128x128x8 voxels; the kernels' bf16 rounding of P (forward
# and backward) and the atomics' order move the gradients by ~1% (GRAD_TOL
# above) and so the AdamW updates of the following steps.
TRAIN_LOSS_RTOL = 2e-2
TRAIN_VOLUMES = 8   # 6 train volumes x 2 crops = 6 steps of batch 2
DROP_RATE = 0.1
# Peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit):
# bf16 tensor-core FLOP/s and HBM bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

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
        t_ops = 1e3 * flops / PEAK_BF16_FLOPS
        t_bytes = 1e3 * nbytes / PEAK_BYTES
        self.ms += max(t_ops, t_bytes)
        self.ops_ms += t_ops
        self.bytes_ms += t_bytes

    @property
    def by(self) -> str:
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"


def block_work(x_win, ops, labels):
    """(flops, bytes) of one B1 call: five C x C products per row and the
    two attention products over N keys; bf16 x in and out, bf16 weights
    and extra K/V rows, the fp32 bias and vectors, int32 labels."""
    b, p, m, c = x_win.shape
    bp, n, h, e = b * p, m + ops.n_ext, ops.num_heads, ops.n_ext
    flops = bp * (10 * m * c * c + 4 * m * n * c)
    nbytes = (2 * bp * m * c * 2 + 5 * c * c * 2 + 2 * e * c * 2
              + h * m * n * 4 + 6 * c * 4
              + (0 if labels is None else labels.numel() * 4))
    return flops, nbytes


def block_bwd_work(x_win, ops, labels):
    """(flops, bytes) of one B4 call: the forward's products once more
    (recompute) and twice for the gradients; reads x, dout and the
    forward's inputs, writes dx (bf16) and the fp32 operand gradients."""
    b, p, m, c = x_win.shape
    bp, n, h, e = b * p, m + ops.n_ext, ops.num_heads, ops.n_ext
    fwd_flops, fwd_bytes = block_work(x_win, ops, labels)
    nbytes = fwd_bytes + bp * m * c * 2 + (5 * c * c * 4 + 6 * c * 4
                                           + h * m * n * 4 + 2 * e * c * 4)
    return 3 * fwd_flops, nbytes


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
        .fused_block import block_reference, fused_swin_block
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
            print(f"    kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
            ms += t_k
            plain_ms += t_p
    if failures:
        raise RuntimeError("phase B1 failed: " + "; ".join(failures))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound": bound}


def phase_convs(gen_seed: int = SEED + 1):
    """B2 at the 3 decoder pair-conv shapes."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .conv_fused import (conv3x3_fused_pair, conv_pair_reference,
                            kernel_weight)
    print("phase B2: pair conv vs conv_pair_reference (bf16)")
    failures, errs = [], []
    ms = plain_ms = 0.0
    bound = Bound()
    g = torch.Generator().manual_seed(gen_seed)
    for name, ca, cb, co, dims in CONV_SHAPES:
        cin = ca + cb
        xa = torch.randn((BATCH, *dims, ca), generator=g).to(
            "cuda", torch.bfloat16)
        xb = torch.randn((BATCH, *dims, cb), generator=g).to(
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
        vox = BATCH * dims[0] * dims[1] * dims[2]
        # bf16 inputs, bf16 27-tap weight, fp32 scale/shift/bias, bf16 out.
        bound.add(2 * vox * co * 27 * cin,
                  vox * cin * 2 + 27 * cin * co * 2 + cin * 8 + co * 4
                  + vox * co * 2)
        print(f"    kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        ms += t_k
        plain_ms += t_p
    if failures:
        raise RuntimeError("phase B2 failed: " + "; ".join(failures))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound": bound}


def phase_blocks_train(gen_seed: int = SEED + 5):
    """B1 with dropout and B4 at the 6 flagship geometries, no-shift and
    shift, at the training batch's window counts: the 12 block calls of
    one training step."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import (PARAM_KEYS, Dropout, block_reference,
                             fused_swin_block)
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block_bwd import block_backward, block_backward_reference
    print(f"phase blocks-train: B1 with dropout {DROP_RATE}/{DROP_RATE} and "
          f"B4 vs their plain versions (bf16, batch {TRAIN_BATCH})")
    failures, fwd_errs, bwd_errs = [], [], []
    fwd = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound()}
    bwd = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound()}
    names = ("x", "bias", "ext_k", "ext_v", *PARAM_KEYS)
    g = torch.Generator().manual_seed(gen_seed)
    for i, (name, c, heads, dims) in enumerate(BLOCK_GEOMETRIES):
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
            torch.cuda.synchronize()
            print(f"  B4 {tag}")
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
            print(f"    B1 kernel {t_k:.4f} ms, plain {t_p:.4f} ms; "
                  f"B4 kernel {t_bk:.4f} ms, plain {t_bp:.4f} ms")
    if failures:
        raise RuntimeError("phase blocks-train failed: " + "; ".join(failures))
    fwd["max_abs_err"] = max(fwd_errs)
    bwd["max_abs_err"] = max(bwd_errs)
    return fwd, bwd


def counters():
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .conv_fused import conv3x3_fused_pair
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block import fused_swin_block
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        .fused_block_bwd import block_backward
    return {"B1": fused_swin_block, "B2": conv3x3_fused_pair,
            "B4": block_backward}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


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


def phase_model(model):
    """Flagship forward on a 27-window batch: kernels vs plain versions."""
    import torch
    print("phase model: flagship SwinUnetR, bf16 trunk, [27, 128, 128, 8, 1]")
    g = torch.Generator().manual_seed(SEED + 3)
    x = torch.rand((BATCH, 128, 128, 8, 1), generator=g).cuda()
    with torch.inference_mode():
        y_plain = model.set_kernels(False)(x)
        model.set_kernels(True)
        reset_counters()
        y = model(x)
        torch.cuda.synchronize()
    got = read_counters()
    print(f"  launches per forward: {got}")
    failures = []
    if got != {"B1": 12, "B2": 3, "B4": 0}:
        failures.append(f"expected 12 B1, 3 B2 and 0 B4 launches, got {got}")
    if tuple(y.shape) != (BATCH, 128, 128, 8, 2) or \
            not torch.isfinite(y).all():
        failures.append(f"bad logits: shape {tuple(y.shape)}, finite "
                        f"{bool(torch.isfinite(y).all())}")
    diff = (y - y_plain).abs()
    agree = (y.argmax(-1) == y_plain.argmax(-1)).float().mean().item()
    dp = (torch.softmax(y, -1) - torch.softmax(y_plain, -1)).abs()
    print(f"  logits vs plain: max_abs {diff.max().item():.6g}, mean_abs "
          f"{diff.mean().item():.6g}, max |logit| "
          f"{y_plain.abs().max().item():.4g}; probs max_abs "
          f"{dp.max().item():.6g}; argmax agreement {agree:.6f} "
          f"(min {MODEL_MIN_ARGMAX_AGREEMENT})")
    if not agree >= MODEL_MIN_ARGMAX_AGREEMENT:
        failures.append(f"argmax agreement {agree} < "
                        f"{MODEL_MIN_ARGMAX_AGREEMENT}")
    if failures:
        raise RuntimeError("phase model failed: " + "; ".join(failures))


def phase_serve(model, card: str):
    """Serve a seeded 320x320x24 int16 volume; kernels vs plain labels."""
    import numpy as np
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import load_nifti, save_nifti
    from medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
        import make_runner, serve_volumes
    print("phase serve: 320x320x24 int16 CT, stride 0.75, coverage crop")
    rng = np.random.default_rng(SEED + 4)
    hu = rng.normal(40.0, 300.0, size=(320, 320, 24))
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in (320, 320, 24)),
                             indexing="ij")
    hu += 800.0 * ((zz ** 2 + yy ** 2 + (xx / 2) ** 2) < 0.3)
    vol = np.clip(hu, -1024, 3071).astype(np.int16)
    conf = {"roi_size": [128, 128, 8]}
    runner = make_runner(conf, model, chunk=None, stride=0.75,
                         device_windowing=True, coverage="crop")
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "ct.nii.gz"
        save_nifti(str(src), vol)
        model.set_kernels(False)
        plain_dst = Path(tmp) / "plain_seg.nii.gz"
        if serve_volumes(conf, None, [(src, plain_dst)], runner=runner) != \
                (1, 0):
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
        if done != (SERVE_REPEATS, 0):
            raise RuntimeError(f"phase serve failed: served {done}")
        plain = load_nifti(str(plain_dst))[0]
        labels = [load_nifti(str(d))[0] for _, d in pairs]
    vps = SERVE_REPEATS / dt
    agree = min(float((lab == plain).mean()) for lab in labels)
    print(f"  served {SERVE_REPEATS} volumes in {dt:.4f} s: {vps:.4f} vol/s "
          f"on {card} (from disk, pipelined host IO)")
    print(f"  launches during the served run: {launches}")
    print(f"  label agreement vs plain path: {agree:.6f} "
          f"(min {SERVE_MIN_LABEL_AGREEMENT}); foreground share "
          f"{float((plain > 0).mean()):.4f}")
    failures = []
    want = {"B1": 12 * SERVE_REPEATS, "B2": 3 * SERVE_REPEATS, "B4": 0}
    if launches != want:
        failures.append(f"launches {launches}, expected {want}")
    if not agree >= SERVE_MIN_LABEL_AGREEMENT:
        failures.append(f"label agreement {agree}")
    if labels[0].shape != (320, 320, 24):
        failures.append(f"label volume shape {labels[0].shape}")
    if failures:
        raise RuntimeError("phase serve failed: " + "; ".join(failures))
    return launches, vps


def write_train_set(root: Path) -> None:
    """Seeded synthetic CT set: int16 HU volumes with a bright ellipsoid
    labelled 1 inside a body labelled 2 (2 is not an active label)."""
    import numpy as np
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import save_nifti
    rng = np.random.default_rng(SEED + 6)
    (root / "img").mkdir()
    (root / "msk").mkdir()
    for k in range(TRAIN_VOLUMES):
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


def train_hparams(root: Path) -> Namespace:
    """The flagship training config (the JAX package's
    ``tools/bench_train_step.py`` ``_base_conf``: ``flagship_conf`` with
    ``use_checkpoint`` and dropout 0.1/0.1, AdamW 5e-4 / 0.1, labels
    [0, 1]) and a loader over ``root``."""
    from medical_image_segmentation_with_visual_prompts_tpu_torch.config \
        import flagship_conf
    conf = dataclasses.asdict(flagship_conf(
        use_checkpoint=True, attn_drop=DROP_RATE, proj_drop=DROP_RATE))
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


def run_trainer(hp, kernels: bool):
    """``SegmentationTrainer.train()`` on the card; returns the trainer,
    the launches of the run and its wall time."""
    import torch
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import get_fit_loader_downstream
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import SwinUnetR
    from medical_image_segmentation_with_visual_prompts_tpu_torch.train \
        import SegmentationTrainer
    train_loader, _ = get_fit_loader_downstream(hp)
    tr = SegmentationTrainer(hp, SwinUnetR, train_loader, None, _Quiet())
    tr.model.set_kernels(kernels)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    return tr, read_counters(), time.perf_counter() - t0


def profile_steps(tr, hp, steps: int = 2) -> None:
    """Device time of ``steps`` training steps by kernel bucket
    (``torch.profiler``), and the device's idle share over them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from medical_image_segmentation_with_visual_prompts_tpu_torch.data \
        import get_fit_loader_downstream
    batches = []
    for batch in get_fit_loader_downstream(hp)[0]:
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
    buckets = (("B1 fused_swin_block_kernel", ("fused_swin_block_kernel",)),
               ("B4 fused_block_bwd_kernel", ("fused_block_bwd_kernel",)),
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
        if evt.device_type != torch.autograd.DeviceType.CUDA:
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
        return
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    print(f"  profile of {steps} kernel steps (torch.profiler): device busy "
          f"{busy / 1e3 / steps:.3f} ms per step of a "
          f"{window / 1e3 / steps:.3f} ms span, idle share "
          f"{1 - busy / window:.4f}")
    for name, _ in buckets:
        print(f"    {name}: {sums[name] / 1e3 / steps:.3f} ms per step")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    for name, us in top:
        print(f"      {us / 1e3 / steps:8.3f} ms  {name[:110]}")


def phase_train(card: str):
    """``SegmentationTrainer.train()`` at the flagship training config:
    kernels vs plain versions on the same seeds and crops."""
    import numpy as np
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import partition
    print("phase train: SegmentationTrainer.train(), flagship, dropout "
          f"{DROP_RATE}/{DROP_RATE}, batch {TRAIN_BATCH} of 128x128x8")
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_train_set(root)
        hp = train_hparams(root)
        plain, plain_launches, _ = run_trainer(hp, kernels=False)
        tr, launches, wall = run_trainer(hp, kernels=True)
        steps = len(tr.losses)
        print(f"  kernels: {steps} steps in {wall:.3f} s, launches {launches}")
        print(f"  plain versions: launches {plain_launches}")
        want = {"B1": 12 * steps, "B2": 0, "B4": 12 * steps}
        if steps < 5:
            failures.append(f"only {steps} training steps")
        if launches != want:
            failures.append(f"launches {launches}, expected {want} (12 B1 "
                            "and 12 B4 per step)")
        if any(plain_launches.values()):
            failures.append(f"plain run launched kernels: {plain_launches}")
        if len(plain.losses) != steps:
            failures.append(f"plain run took {len(plain.losses)} steps")
        for i, (lk, lp) in enumerate(zip(tr.losses, plain.losses)):
            rel = abs(lk - lp) / max(abs(lp), 1e-12)
            print(f"  step {i}: loss {lk:.6f} (kernels) vs {lp:.6f} (plain), "
                  f"rel {rel:.3g} (tol {TRAIN_LOSS_RTOL})")
            if not (np.isfinite(lk) and rel <= TRAIN_LOSS_RTOL):
                failures.append(f"step {i} loss {lk} vs {lp}")
        labels = partition.downstream_labels(tr.model_conf)
        n_train = 0
        for name, p in tr.model.named_parameters():
            if partition.label_of(name) not in labels:
                continue
            n_train += 1
            gr = p.grad
            if gr is None or not bool(gr.isfinite().all()) or \
                    not float(gr.abs().sum()) > 0:
                failures.append(f"trainable {name}: gradient "
                                f"{'missing' if gr is None else 'bad'}")
        print(f"  {n_train} trainable tensors, each with a finite non-zero "
              "gradient" if not failures else f"  failures: {failures}")
        k_ms = float(np.median(tr.step_ms))
        p_ms = float(np.median(plain.step_ms))
        print(f"  median step ms: kernels {k_ms:.3f}, plain {p_ms:.3f} "
              f"(host clock around each step, ending in its loss read) on "
              f"{card}")
        print(f"  steps ms kernels {[round(v, 3) for v in tr.step_ms]}; "
              f"plain {[round(v, 3) for v in plain.step_ms]}")
        if failures:
            raise RuntimeError("phase train failed: " + "; ".join(failures))
        del plain
        profile_steps(tr, hp)
    return launches, k_ms, p_ms


def kernel_entry(name, source, replaces, launches, by_path, m):
    bound = m["bound"]
    return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
            "replaces": f"{JAX_PKG}/{replaces}", "launches": launches,
            "launches_by_path": by_path, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": bound.ms,
            "bound_by": bound.by, "library_ms": None}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from medical_image_segmentation_with_visual_prompts_tpu_torch.ops \
        import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = kernels.library()
    print(f"kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc build {kernels.build_seconds} s): {lib._name}")

    b1 = phase_blocks()
    b2 = phase_convs()
    b1_train, b4 = phase_blocks_train()
    model = flagship_model()
    phase_model(model)
    serve_launches, _ = phase_serve(model, card)
    del model
    train_launches, _, _ = phase_train(card)

    print("serve-path times are per 27-window flagship forward, train-path "
          "times per training step of batch 2 (sums over the path's calls), "
          "CUDA events, on " + card)
    print(f"B1 on the serve path: {b1['ms']:.4f} ms (plain "
          f"{b1['plain_ms']:.4f}, bound {b1['bound'].ms:.4f} "
          f"({b1['bound'].by}), max_abs_err {b1['max_abs_err']:.6g})")

    def paths(key):
        return {"serve": serve_launches[key], "train": train_launches[key]}

    print(json.dumps({"kernels": [
        kernel_entry("fused_swin_block", "fused_block.cu",
                     "ops/fused_block.py:554", train_launches["B1"],
                     paths("B1"), b1_train)
        | {"serve": {"launches": serve_launches["B1"], "ms": b1["ms"],
                     "plain_ms": b1["plain_ms"],
                     "bound_ms": b1["bound"].ms,
                     "bound_by": b1["bound"].by,
                     "max_abs_err": b1["max_abs_err"]}},
        kernel_entry("conv3x3_fused_pair", "conv3x3_pair.cu",
                     "ops/conv_pallas.py:270", serve_launches["B2"],
                     paths("B2"), b2),
        kernel_entry("fused_block_bwd", "fused_block_bwd.cu",
                     "ops/fused_block_bwd.py:158", train_launches["B4"],
                     paths("B4"), b4),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
