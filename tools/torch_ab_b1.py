#!/usr/bin/env python3
"""A/B of the port's kernels between checkouts: the fused Swin block (B1),
the window attention kernels (B6/B7/B8), the block backward (B4) or the
decoder conv (B2/B3).

Run on a machine with one CUDA card, from the repository root::

    python3 tools/torch_ab_b1.py [--quick] PARENT_DIR . . PARENT_DIR
    python3 tools/torch_ab_b1.py --kernel b2 [--sweep] PARENT_DIR . . PARENT_DIR
    python3 tools/torch_ab_b1.py --kernel b6 [--quick] [--sweep] \
        PARENT_DIR . . PARENT_DIR
    python3 tools/torch_ab_b1.py --kernel b6 --probe . [PROBE_INDEX ...]
    python3 tools/torch_ab_b1.py --probe . [PROBE_INDEX ...]
    python3 tools/torch_ab_b1.py --kernel b4 [--quick] [--sweep] \
        PARENT_DIR . . PARENT_DIR
    python3 tools/torch_ab_b1.py --kernel b4 --probe . [PROBE_INDEX ...]
    python3 tools/torch_ab_b1.py --kernel dp PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout holding the PyTorch port; each
runs in its own process, in the order given (alternate them: A B B A).
Each process builds that checkout's kernels and times each call with
CUDA events on the same seeded inputs.

* ``--kernel b1`` (default): B1 at the 12 flagship serving geometries
  (27 windows; no dropout, as serving calls it).  Outputs of every run
  are compared bit for bit with the first run's.  Each launch's cluster
  size, CTAs, threads, CTAs per SM, registers, spill bytes and shared
  bytes per CTA (``fused_block.launch_info``; for a checkout without it,
  one CTA per window, registers and spills in the ``ptxas`` lines).
  ``ptxas -v`` (unless ``--quick``) of
  ``fused_block.cu`` (and ``window_attention.cu``, ``fused_pair.cu`` and
  the fp32 and dropout units, which share its device code, where the
  checkout has them).
* ``--probe ROOT [I ...]``: B1 of one checkout at the same geometries,
  built once per entry of ``PROBES`` (or the entries I;
  ``csrc/fused_block_common.cuh``'s ``MIVP_B1_SKIP`` and ``MIVP_B1_KS``):
  the time of the body with attention, q|k|v, the row phase's products,
  LN1, the bias build or P.V compiled out, and of each cluster size.
  Outputs are not compared.
* ``--kernel b6``: B6 (C <= 128) or B8 (C 192) and B7 on pre-projected q/k/v
  at the same 12 geometries through the unfused block (27 windows), called
  as the checkout's unfused block calls them (with the bias's factor tables
  and, for B6, the content rows and the prompt rows that every window shares
  apart, where the checkout has ``window_attention.launch_info``; else with
  the ``[H, M, N]`` bias). Outputs are compared bit for bit with the first
  run's; each call prints its ms, its launch shape (``launch_info``, or the
  one-CTA-per-(window, head) shape of its ``Smem`` layout) and, on the
  unshifted B7/B8 calls, one ``scaled_dot_product_attention`` of the same
  function.  Only ``window_attention.cu`` is built, alone, for each
  checkout.  ``--sweep`` also times the same call with the ``[H, M, N]``
  bias, and B6 on the whole windows (the prompt rows projected in every
  window).  ``--kernel b6 --probe ROOT [I ...]`` times the calls with the
  parts of ``B6_PROBES`` compiled out (``MIVP_B6_SKIP``).
* ``--kernel b4``: B4 (the block backward) at the 12 calls of one
  training step (the 6 flagship geometries, no-shift and shift, batch 2,
  dropout 0.1/0.1, 64 prompt tokens): ms per call and the sum per step,
  each gradient's error against ``block_backward_reference`` (relative
  to its largest magnitude; the bound is 2^-5), whether each run's
  outputs are bit-identical to its own second run and to run 0's, and
  each launch's shape (``fused_block_bwd.launch_info``; for a checkout
  without it, the one-CTA-per-window shape from its ``BSmem`` layout).
  ``ptxas -v`` of ``fused_block_bwd.cu`` unless ``--quick``.  Times are
  CUDA events around 10 calls (host work included) and, per kernel the
  call launches, device time from ``torch.profiler`` over 5 calls.
  ``--sweep`` also times every cluster size and thread count that fits
  (``block_backward(..., cluster, threads)``, device ms).  ``--kernel b4
  --probe ROOT [I ...]`` times B4 built with the parts of ``B4_PROBES``
  compiled out (``MIVP_B4_SKIP``).
* ``--kernel b2``: B2 at the 3 flagship decoder convs and B3 at 48->48 on
  64x64x4 with and without its BN + LeakyReLU prologue (27 windows), each
  held to its plain version (the kernels of two checkouts sum in other
  orders, so their outputs are not compared bit for bit), beside one
  cuDNN ``conv3d`` of the same shapes without the prologue (bf16,
  channels-last); where the checkout reports it, each launch's tile,
  registers, spills and CTAs per SM.  ``--sweep`` also times every tile
  the checkout's kernel offers.  ``ptxas -v`` of ``conv3x3_pair.cu``.
* ``--kernel dp``: the kernels whose dropout counters take a window base
  (B1, B5, B4), called as a checkout without the base calls them (the
  base is 0), at the flagship training shapes at batch 4 (the 12 block
  calls, dropout 0.1/0.1; B5 at the 6 pair calls): ms per call (CUDA
  events, 10 calls) and their sums per kernel, and every output compared
  bit for bit with run 0's.

Imports torch and the port only.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = "medical_image_segmentation_with_visual_prompts_tpu_torch"
NVCC = shutil.which("nvcc") or os.path.join(
    os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")

CHILD_B1 = r'''
import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinTransformerBlock
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import kernels
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops.fused_block \
    import fused_swin_block
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights
GEOMETRIES = (("enc0", 48, 4, (64, 64, 4)), ("enc1", 96, 8, (32, 32, 2)),
              ("enc2", 192, 16, (16, 16, 2)), ("dec0", 192, 4, (16, 16, 2)),
              ("dec1", 96, 4, (32, 32, 2)), ("dec2", 48, 4, (64, 64, 4)))
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block as fb


def parent_smem(m, c, n, dh):
    """Shared bytes per CTA of the one-CTA-per-window B1 (checkouts from
    before ``fused_block.launch_info``): its BlockSmem layout."""
    a16 = lambda v: (v + 15) // 16 * 16  # noqa: E731
    dhk, npad, mp = a16(dh), a16(n), (m + 31) // 32 * 32
    q = a16(mp * (c + 8) * 2)
    k = a16(q + mp * (dhk + 8) * 2)
    vt = a16(k + npad * (dhk + 8) * 2)
    lab = a16(vt + dhk * (npad + 8) * 2)
    attn_end = a16(lab + npad * 4)
    return max(attn_end, a16(mp * (c + 4) * 4)) + a16(mp * (c + 8) * 2)


def launch_info(x_win, ops, labels, heads):
    if hasattr(fb, "launch_info"):
        return fb.launch_info(x_win, ops, labels)
    b, pw, m, c = x_win.shape
    return {"cluster": 1, "ctas": b * pw, "threads": (m + 31) // 32 * 32,
            "ctas_per_sm": kernels.ctas_per_sm(
                "mivp_fused_swin_block", m, c, heads, ops.n_ext, False),
            "registers": "ptxas above", "spill_bytes": "ptxas above",
            "smem": parent_smem(m, c, m + ops.n_ext, c // heads)}


if len(sys.argv) > 2:   # a probe's library: B1's entry only
    import ctypes
    probe = ctypes.CDLL(sys.argv[2])
    probe.mivp_fused_swin_block.argtypes = \
        kernels.SIGNATURES["mivp_fused_swin_block"]
    probe.mivp_fused_swin_block.restype = ctypes.c_int
    probe.mivp_error_string.argtypes = [ctypes.c_int]
    probe.mivp_error_string.restype = ctypes.c_char_p
    kernels._lib = probe
t0 = time.perf_counter()
kernels.library()
build_s = time.perf_counter() - t0
g = torch.Generator().manual_seed(0)
outs, times, info = {}, {}, {}
for name, c, heads, dims in GEOMETRIES:
    for shift in ((0, 0, 0), (4, 4, 2)):
        blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                                   shift_size=shift, pad_mode="aligned",
                                   dtype=torch.bfloat16)
        blk = init_weights(blk, g).cuda()
        x = torch.randn((27, *dims, c), generator=g).to("cuda", torch.bfloat16)
        tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
        tag = f"{name} {'shift' if any(shift) else 'noshift'}"
        with torch.inference_mode():
            x_win, ops, labels, _ = blk.windows(x, tok)
            out = fused_swin_block(x_win, ops, labels)
            torch.cuda.synchronize()
            outs[tag] = out.view(torch.int16).cpu().numpy()
            for _ in range(2):
                fused_swin_block(x_win, ops, labels)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fused_swin_block(x_win, ops, labels)
            end.record()
            torch.cuda.synchronize()
        times[tag] = start.elapsed_time(end) / 10
        info[tag] = launch_info(x_win, ops, labels, heads)
np.savez(sys.argv[1], **outs)
print(json.dumps({"build_s": build_s, "ms": times, "info": info}))
'''

CHILD_B6 = r'''
import ctypes, json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import torch.nn.functional as F
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinTransformerBlock
from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
    .window_attention import linear
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import kernels
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    window_attention as wa
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights
GEOMETRIES = (("enc0", 48, 4, (64, 64, 4)), ("enc1", 96, 8, (32, 32, 2)),
              ("enc2", 192, 16, (16, 16, 2)), ("dec0", 192, 4, (16, 16, 2)),
              ("dec1", 96, 4, (32, 32, 2)), ("dec2", 48, 4, (64, 64, 4)))
# Checkouts with launch_info take the bias as its factor tables and B6
# the content rows and the shared prompt rows apart, as the unfused blocks
# call them; older ones the [H, M, N] bias and the whole windows.
NEW = hasattr(wa, "launch_info")


def parent_info(bp, m, n, c, heads, proj):
    # The one-CTA-per-(window, head) launch of checkouts without
    # launch_info: 256 threads, its Smem layout, at most 2 CTAs per SM
    # (launch bounds).
    a16 = lambda v: (v + 15) // 16 * 16  # noqa: E731
    dhk, npad, mp = a16(c // heads), a16(n), (m + 31) // 32 * 32
    yrows = (n + 31) // 32 * 32 if proj else 0
    q = a16(yrows * (c + 8) * 2)
    k = a16(q + mp * (dhk + 8) * 2)
    vt = a16(k + npad * (dhk + 8) * 2)
    lab = a16(vt + dhk * (npad + 8) * 2)
    smem = a16(lab + npad * 4)
    return {"cluster": 1, "ctas": bp * heads, "threads": 256,
            "ctas_per_sm": min(2, 228 * 1024 // (smem + 1024)),
            "smem": smem}


def event_ms(fn, iters=10):
    for _ in range(2):
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


if sys.argv[2] != "-":   # a probe's library: the attention entry only
    probe = ctypes.CDLL(sys.argv[2])
    probe.mivp_window_attention.argtypes = \
        kernels.SIGNATURES["mivp_window_attention"]
    probe.mivp_window_attention.restype = ctypes.c_int
    kernels._lib = probe
sweep = sys.argv[3] == "1"
t0 = time.perf_counter()
kernels.library()
build_s = time.perf_counter() - t0
g = torch.Generator().manual_seed(0)
outs, times, info, sdpa, swept = {}, {}, {}, {}, {}
for name, c, heads, dims in GEOMETRIES:
    for shift in ((0, 0, 0), (4, 4, 2)):
        blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                                   shift_size=shift, pad_mode="aligned",
                                   dtype=torch.bfloat16)
        blk = init_weights(blk, g).cuda()
        blk.fused_block = False
        x = torch.randn((27, *dims, c), generator=g).to("cuda", torch.bfloat16)
        tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
        at, scale = blk.attn, (c // heads) ** -0.5
        with torch.inference_mode():
            x_win, ops, labels, _ = blk.windows(x, tok)
            bias = getattr(ops, "bias", ops)
            tables = getattr(ops, "factors", None)
            y = blk.attn_input(x_win, tok)
            b, pw, m = x_win.shape[:3]
            n, bp = y.shape[2], b * pw
            q = linear(y[:, :, :m], at.to_q).contiguous()
            k = linear(y, at.to_k).contiguous()
            v = linear(y, at.to_v).contiguous()
            kw = {"factors": tables} if NEW else {}
            calls = {"B7": lambda: wa.fused_window_attention_packed(
                q, k, v, bias, labels, scale, heads, **kw)}
            if c <= 128:
                ws = tuple(lin.weight.t() for lin in (at.to_q, at.to_k,
                                                      at.to_v))
                wqkv = at.kernel_weight()
                if NEW:   # the content rows and the prompt rows apart
                    yc = y[:, :, :m].contiguous()
                    yp = y[0, 0, m:].contiguous()
                    calls["B6"] = lambda: \
                        wa.fused_window_attention_packed_qkv_prompts(
                            yc, yp, *ws, bias, labels, scale, heads,
                            wqkv=wqkv, **kw)
                else:
                    calls["B6"] = lambda: wa.fused_window_attention_packed_qkv(
                        y, *ws, m, bias, labels, scale, heads, wqkv=wqkv)
            else:
                hs = lambda t: t.view(b, pw, t.shape[2], heads, -1)
                calls["B8"] = lambda: wa.fused_window_attention(
                    hs(q), hs(k), hs(v), bias, labels, scale, **kw)
            for key, fn in calls.items():
                tag = f"{key} {name} {'shift' if any(shift) else 'noshift'}"
                out = fn()
                torch.cuda.synchronize()
                outs[tag] = out.view(torch.int16).cpu().numpy()
                times[tag] = event_ms(fn)
                proj = key == "B6"
                if NEW:
                    info[tag] = wa.launch_info(
                        bp, m, n, c, heads, proj, factors=tables,
                        hoisted=proj)
                else:
                    info[tag] = parent_info(bp, m, n, c, heads, proj)
                if labels is None and not proj:
                    sp = lambda t: t.view(bp, t.shape[2], heads, -1) \
                        .transpose(1, 2)  # noqa: E731
                    qs, ks, vs = sp(q), sp(k), sp(v)
                    b16 = bias.to(torch.bfloat16)[None]
                    sdpa[tag] = event_ms(lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=b16, scale=scale))
                if sweep and NEW:
                    # The same call with the [H, M, N] bias (and B6 with
                    # the prompt rows projected in every window).
                    row = {"as called": times[tag]}
                    if proj:
                        row["dense bias"] = event_ms(lambda: wa
                            .fused_window_attention_packed_qkv_prompts(
                                yc, yp, *ws, bias, labels, scale, heads,
                                wqkv=wqkv))
                        row["prompt rows per window"] = event_ms(
                            lambda: wa.fused_window_attention_packed_qkv(
                                y, *ws, m, bias, labels, scale, heads,
                                wqkv=wqkv, factors=tables))
                    else:
                        row["dense bias"] = event_ms(
                            lambda: wa.fused_window_attention_packed(
                                q, k, v, bias, labels, scale, heads))
                    swept[tag] = row
np.savez(sys.argv[1], **outs)
print(json.dumps({"build_s": build_s, "ms": times, "info": info,
                  "sdpa_ms": sdpa, "sweep": swept}))
'''

CHILD_B4 = r'''
import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    SwinTransformerBlock
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import kernels
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block_bwd as fbb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops.fused_block \
    import Dropout
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights
torch.backends.cuda.matmul.allow_tf32 = False
GEOMETRIES = (("enc0", 48, 4, (64, 64, 4)), ("enc1", 96, 8, (32, 32, 2)),
              ("enc2", 192, 16, (16, 16, 2)), ("dec0", 192, 4, (16, 16, 2)),
              ("dec1", 96, 4, (32, 32, 2)), ("dec2", 48, 4, (64, 64, 4)))
NAMES = ("x", "bias", "ext_k", "ext_v", "ln1_scale", "ln1_bias", "wq", "wk",
         "wv", "wproj", "bproj", "ln2_scale", "ln2_bias", "wmlp", "bmlp")


def parent_info(x_win, ops):
    # The one-CTA-per-window B4 (checkouts without launch_info): its
    # BSmem layout at MP = M rounded up to 32 threads.
    a16 = lambda v: (v + 15) // 16 * 16  # noqa: E731
    b, pw, m, c = x_win.shape
    n, dh = m + ops.n_ext, c // ops.num_heads
    mp, dhk, npad = (m + 31) // 32 * 32, a16(dh), a16(n)
    nk = max(npad, mp)
    qs, ds = dhk + 8, dhk + 4
    k = a16(mp * qs * 2)
    v = a16(k + nk * qs * 2)
    do = a16(v + nk * qs * 2)
    dq = a16(do + mp * qs * 2)
    dk = a16(dq + mp * qs * 2)
    dv = a16(dk + nk * ds * 4)
    lab = a16(dv + nk * ds * 4)
    scr = a16(lab + npad * 4)
    total = a16(scr + (mp // 32) * 2 * 16 * 72 * 2)
    return {"cluster": 1, "ctas": b * pw, "threads": mp, "smem": total}


def device_ms(run, calls=5):
    """Device time per call of each kernel ``run`` launches
    (torch.profiler): the host's share of the event time is not in it."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    kernel_us = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and \
                "bwd" in evt.name:
            key = "reduce" if "reduce" in evt.name else "main"
            kernel_us[key] = kernel_us.get(key, 0.0) + \
                evt.time_range.elapsed_us()
    return {k: v / (1e3 * calls) for k, v in kernel_us.items()}


probe_lib = sys.argv[2] if len(sys.argv) > 2 and sys.argv[2] != "-" else None
sweep = len(sys.argv) > 3 and sys.argv[3] == "1"
if probe_lib:
    import ctypes
    probe = ctypes.CDLL(probe_lib)
    for name in ("mivp_fused_block_bwd",):
        fn = getattr(probe, name)
        fn.argtypes = kernels.SIGNATURES[name]
        fn.restype = ctypes.c_int
    probe.mivp_error_string.argtypes = [ctypes.c_int]
    probe.mivp_error_string.restype = ctypes.c_char_p
    kernels._lib = probe
t0 = time.perf_counter()
kernels.library()
build_s = time.perf_counter() - t0
g = torch.Generator().manual_seed(0)
outs, times, info, errs, same, device, swept = {}, {}, {}, {}, {}, {}, {}
for i, (name, c, heads, dims) in enumerate(GEOMETRIES):
    for j, shift in enumerate(((0, 0, 0), (4, 4, 2))):
        blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                                   shift_size=shift, pad_mode="aligned",
                                   dtype=torch.bfloat16, attn_drop=0.1,
                                   proj_drop=0.1)
        blk = init_weights(blk, g).cuda()
        x = torch.randn((2, *dims, c), generator=g).to("cuda", torch.bfloat16)
        tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
        drop = Dropout((1000 + 2 * (2 * i + j), 1001 + 2 * (2 * i + j)),
                       0.1, 0.1)
        with torch.no_grad():
            x_win, ops, labels, _ = blk.windows(x, tok)
        dout = torch.randn(x_win.shape, generator=g).to("cuda", torch.bfloat16)
        tag = f"{name} {'shift' if any(shift) else 'noshift'}"
        run = lambda: fbb.block_backward(x_win, dout, ops, labels, drop)  # noqa
        got = run()
        again = run()
        torch.cuda.synchronize()
        flat = [t for t in (got[0], *got[1]) if t is not None]
        flat2 = [t for t in (again[0], *again[1]) if t is not None]
        same[tag] = all(torch.equal(a, b) for a, b in zip(flat, flat2))
        outs[tag] = np.concatenate([t.float().flatten().cpu().numpy()
                                    for t in flat])
        if not probe_lib:
            ref = fbb.block_backward_reference(x_win, dout, ops, labels, drop)
            errs[tag] = {}
            for gname, gt, rt in zip(NAMES, (got[0], *got[1]),
                                     (ref[0], *ref[1])):
                if rt is None:
                    continue
                gt, rt = gt.float(), rt.float()
                errs[tag][gname] = ((gt - rt).abs().max().item()
                                    / max(rt.abs().max().item(), 1e-6))
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            run()
        end.record()
        torch.cuda.synchronize()
        times[tag] = start.elapsed_time(end) / 10
        device[tag] = device_ms(run)
        # Every cluster size and thread count that fits, forced.
        for ks in (1, 2, 4, 8) if sweep else ():
            for t in (256, 512):
                try:
                    fbb.launch_info(x_win, ops, labels, drop, ks, t)
                except (ValueError, RuntimeError):
                    continue
                swept.setdefault(tag, {})[f"{ks}x{t}"] = sum(device_ms(
                    lambda: fbb.block_backward(x_win, dout, ops, labels,
                                               drop, ks, t)).values())
        info[tag] = fbb.launch_info(x_win, ops, labels, drop) \
            if hasattr(fbb, "launch_info") else parent_info(x_win, ops)
np.savez(sys.argv[1], **outs)
print(json.dumps({"build_s": build_s, "ms": times, "info": info,
                  "errs": errs, "repeat_identical": same,
                  "device_ms": device, "sweep": swept}))
'''


CHILD_DP = r'''
import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from medical_image_segmentation_with_visual_prompts_tpu_torch.models import \
    ConsecutiveSwinBlocks, SwinTransformerBlock
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import kernels
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    fused_block_bwd as fbb
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops.fused_block \
    import Dropout, fused_swin_block
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops.fused_pair \
    import fused_swin_pair
from medical_image_segmentation_with_visual_prompts_tpu_torch.utils import \
    init_weights
torch.backends.cuda.matmul.allow_tf32 = False
GEOMETRIES = (("enc0", 48, 4, (64, 64, 4)), ("enc1", 96, 8, (32, 32, 2)),
              ("enc2", 192, 16, (16, 16, 2)), ("dec0", 192, 4, (16, 16, 2)),
              ("dec1", 96, 4, (32, 32, 2)), ("dec2", 48, 4, (64, 64, 4)))
BATCH = 4


def event_ms(fn, iters=10):
    for _ in range(2):
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


def flat(*ts):
    return np.concatenate([t.float().flatten().cpu().numpy() for t in ts
                           if t is not None])


t0 = time.perf_counter()
kernels.library()
build_s = time.perf_counter() - t0
g = torch.Generator().manual_seed(0)
outs, times = {}, {}
for i, (name, c, heads, dims) in enumerate(GEOMETRIES):
    for j, shift in enumerate(((0, 0, 0), (4, 4, 2))):
        blk = SwinTransformerBlock(c, (8, 8, 4), 64, heads, 1, 64,
                                   shift_size=shift, pad_mode="aligned",
                                   dtype=torch.bfloat16, attn_drop=0.1,
                                   proj_drop=0.1)
        blk = init_weights(blk, g).cuda()
        x = torch.randn((BATCH, *dims, c), generator=g).to("cuda",
                                                          torch.bfloat16)
        tok = (0.5 * torch.randn((64, c), generator=g)).cuda()
        drop = Dropout((1000 + 2 * (2 * i + j), 1001 + 2 * (2 * i + j)),
                       0.1, 0.1)
        with torch.no_grad():
            x_win, ops, labels, _ = blk.windows(x, tok)
        dout = torch.randn(x_win.shape, generator=g).to("cuda",
                                                        torch.bfloat16)
        tag = f"{name} {'shift' if any(shift) else 'noshift'}"
        with torch.inference_mode():
            fwd = lambda: fused_swin_block(x_win, ops, labels, drop)  # noqa
            outs[f"B1 {tag}"] = flat(fwd())
            times[f"B1 {tag}"] = event_ms(fwd)
        bwd = lambda: fbb.block_backward(x_win, dout, ops, labels, drop)  # noqa
        dx, grads = bwd()
        outs[f"B4 {tag}"] = flat(dx, *grads)
        times[f"B4 {tag}"] = event_ms(bwd)
for i, (name, c, heads, dims) in enumerate(GEOMETRIES):
    pair = ConsecutiveSwinBlocks(c, heads, 64, 1, 64, (8, 8, 4), down=False,
                                 pad_mode="aligned", dtype=torch.bfloat16,
                                 attn_drop=0.1, proj_drop=0.1)
    pair = init_weights(pair, g).cuda()
    pair.pair_kernel = True
    x = torch.randn((BATCH, *dims, c), generator=g).to("cuda", torch.bfloat16)
    toks = tuple((0.5 * torch.randn((64, c), generator=g)).cuda()
                 for _ in range(2))
    d0 = Dropout((2000 + 4 * i, 2001 + 4 * i), 0.1, 0.1)
    d1 = Dropout((2002 + 4 * i, 2003 + 4 * i), 0.1, 0.1)
    with torch.inference_mode():
        x_win, ops0, ops1, labels, plan, _ = pair.pair_windows(x, toks)
        run = lambda: fused_swin_pair(x_win, ops0, ops1, labels, plan,  # noqa
                                      d0, d1)
        outs[f"B5 {name}"] = flat(run())
        times[f"B5 {name}"] = event_ms(run)
np.savez(sys.argv[1], **outs)
print(json.dumps({"build_s": build_s, "ms": times}))
'''


CHILD_B2 = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
import torch.nn.functional as F
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import kernels
from medical_image_segmentation_with_visual_prompts_tpu_torch.ops import \
    conv_fused as cf
torch.backends.cudnn.allow_tf32 = False
SHAPES = (("dec0", 384, 192, 192, (16, 16, 2)),
          ("dec1", 192, 96, 96, (32, 32, 2)),
          ("dec2", 96, 48, 48, (64, 64, 4)),
          ("B3 prologue", 48, 0, 48, (64, 64, 4)),
          ("B3 no prologue", 48, 0, 48, (64, 64, 4)))
sweep = sys.argv[2] == "1"


def ms(fn, iters=20):
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


t0 = time.perf_counter()
kernels.library()
build_s = time.perf_counter() - t0
g = torch.Generator().manual_seed(0)
res = {}
for name, ca, cb, co, dims in SHAPES:
    cin = ca + cb
    xa = torch.randn((27, *dims, ca), generator=g).to("cuda", torch.bfloat16)
    xb = torch.randn((27, *dims, cb), generator=g).to("cuda", torch.bfloat16) \
        if cb else None
    w = (torch.randn((co, cin, 3, 3, 3), generator=g)
         * (27 * cin) ** -0.5).cuda()
    bias = (0.1 * torch.randn(co, generator=g)).cuda()
    scale = (0.5 + torch.rand(cin, generator=g)).cuda()
    shift = (1.0 + torch.randn(cin, generator=g)).cuda()
    w27 = cf.kernel_weight(w)
    if name == "B3 no prologue":
        args = (None, None, False)
    elif cb:
        args = None
    else:
        args = (scale, shift, True)
    with torch.inference_mode():
        if args is None:
            run = lambda: cf.conv3x3_fused_pair(xa, xb, w, bias, scale,
                                                shift, w27=w27)
            ref = cf.conv_pair_reference(xa, xb, w, bias, scale, shift)
        else:
            run = lambda: cf.conv3x3_fused(xa, w, bias, *args, w27=w27)
            ref = cf.conv_reference(xa, w, bias, *args)
        out = run()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        big = ref.float().abs().max().item()
        t = ms(run)
        x = xa if xb is None else torch.cat([xa, xb], -1)
        xc = x.permute(0, 4, 1, 2, 3)
        wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        t_lib = ms(lambda: F.conv3d(xc, wb, bb, padding=1))
    row = {"ms": t, "cudnn_ms": t_lib, "max_abs_err": err, "max_ref": big}
    if hasattr(cf, "tile_info"):
        row["tile"] = cf.tile_info((27, *dims), co)
        if sweep:
            row["sweep"] = {}
            for rpw in (32, 64):
                for bn in (16, 32, 48):
                    if co % bn:
                        continue
                    tile = (rpw, bn)
                    with torch.inference_mode():
                        fn = lambda: cf._launch(
                            xa, xb, w27, bias, *(args or (scale, shift,
                                                          True)),
                            "conv3x3", torch.bfloat16, tile)
                        try:
                            t_tile = ms(fn)
                        except RuntimeError as e:
                            t_tile = str(e)
                    row["sweep"][f"{rpw}x{bn}"] = {
                        "ms": t_tile, **cf.tile_info((27, *dims), co, tile)}
    res[name] = row
print(json.dumps({"build_s": build_s, "res": res}))
'''


def ptxas(root: Path, names) -> None:
    """Registers, shared memory and spills of each kernel instantiation
    of the checkout's sources ``names`` (``nvcc -Xptxas -v``, all
    compiled at once)."""
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for name in names:
            src = root / PKG / "csrc" / name
            if src.exists():
                runs.append((name, subprocess.Popen(
                    [NVCC, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-Xptxas", "-v", "-c", str(src),
                     "-o", f"{tmp}/{name}.o"], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)))
        for name, proc in runs:
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{err}")
            print(f"  {name}:")
            kernel = None
            for line in err.splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]
                elif ("registers" in line or "spill" in line) and kernel:
                    print(f"    {kernel}: {line.split(':', 1)[-1].strip()}")


def main_b2(roots, sweep: bool) -> int:
    """B2/B3 in each checkout: ms per call beside cuDNN, error vs plain."""
    for i, root in enumerate(roots):
        out = subprocess.run([sys.executable, "-c", CHILD_B2, "-",
                              str(int(sweep))], cwd=root, capture_output=True,
                             text=True)
        if out.returncode:
            print(out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        convs = [r for k, r in res["res"].items() if k.startswith("dec")]
        b2 = sum(r["ms"] for r in convs)
        lib = sum(r["cudnn_ms"] for r in convs)
        print(f"run {i}: {root}: build {res['build_s']:.1f} s, B2 sum "
              f"{b2:.4f} ms per 27-window forward (cuDNN conv3d without the "
              f"prologue {lib:.4f})")
        for name, r in res["res"].items():
            line = (f"  {name}: {r['ms']:.4f} ms, cuDNN {r['cudnn_ms']:.4f} "
                    f"ms, max_abs_err {r['max_abs_err']:.4g} of "
                    f"{r['max_ref']:.4g}")
            if "tile" in r:
                line += f"; tile {r['tile']}"
            print(line)
            for tile, t in r.get("sweep", {}).items():
                print(f"    tile {tile}: {t}")
            if not r["max_abs_err"] <= 2.0 ** -6 * max(1.0, r["max_ref"]):
                print(f"  {name}: error above 2^-6 of the largest output")
                return 1
    return 0


# B1 design probes (fused_block_common.cuh, MIVP_B1_SKIP / MIVP_B1_KS):
# parts of the body compiled out, or a fixed cluster size.
PROBES = (("as built", {}),
          ("no attention", {"MIVP_B1_SKIP": 1}),
          ("no q|k|v", {"MIVP_B1_SKIP": 2}),
          ("no row phase", {"MIVP_B1_SKIP": 4}),
          ("no LN1", {"MIVP_B1_SKIP": 8}),
          ("no bias build", {"MIVP_B1_SKIP": 16}),
          ("no P.V", {"MIVP_B1_SKIP": 64}),
          ("no bias build, no P.V", {"MIVP_B1_SKIP": 80}),
          *((f"{ks} CTAs per window where valid", {"MIVP_B1_KS": ks})
            for ks in (1, 2, 4, 8)))


# B4 design probes (fused_block_bwd.cu, MIVP_B4_SKIP): parts compiled
# out.  The bits name the same parts in the one-CTA form and the cluster
# form: 1 the bias gradient's cross-window sum, 2 the weight-gradient
# products, 4 the row-reducing attention products (dV, dK), 8 the
# recompute (phases A and B); the cluster form only: 16 the reduction
# kernel, 32 LN1, 64 the row phase, 128 the query-major pass, 256 phase F.
B4_PROBES = (("as built", {}),
             ("no dbias sum", {"MIVP_B4_SKIP": 1}),
             ("no weight-gradient products", {"MIVP_B4_SKIP": 2}),
             ("no dV/dK products", {"MIVP_B4_SKIP": 4}),
             ("no recompute", {"MIVP_B4_SKIP": 8}),
             ("no reduction kernel", {"MIVP_B4_SKIP": 16}),
             ("no LN1", {"MIVP_B4_SKIP": 32}),
             ("no row phase", {"MIVP_B4_SKIP": 64}),
             ("no query-major pass (dQ, dS)", {"MIVP_B4_SKIP": 128}),
             ("no phase F (dY, LN1 backward)", {"MIVP_B4_SKIP": 256}))


def main_probe_b4(root: Path, only=None) -> int:
    """Time B4 at the 12 training calls with each probe of B4_PROBES
    compiled in (outputs are garbage and not compared)."""
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xcompiler", "-fPIC"]
    csrc = root / PKG / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        chosen = [(i, B4_PROBES[i]) for i in (only or range(len(B4_PROBES)))]
        procs = [subprocess.Popen(
            [NVCC, *arch, "-c", str(csrc / unit), "-o", f"{tmp}/{unit}.o"],
            stderr=subprocess.PIPE, text=True)
            for unit in ("fused_block.cu", "fused_block_f32.cu")]
        units = [u for u in ("fused_block_bwd.cu", "fused_block_bwd_512.cu")
                 if (csrc / u).exists()]
        for i, (_, defs) in chosen:
            flags = [f"-D{k}={v}" for k, v in defs.items()]
            for unit in units:
                procs.append(subprocess.Popen(
                    [NVCC, *arch, *flags, "-c", str(csrc / unit), "-o",
                     f"{tmp}/p{i}_{unit}.o"], stderr=subprocess.PIPE,
                    text=True))
        for proc in procs:
            _, err = proc.communicate()   # a full stderr pipe would block
            if proc.returncode:
                print(err, file=sys.stderr)
                return 1
        for i, (name, _) in chosen:
            lib = f"{tmp}/p{i}.so"
            subprocess.run([NVCC, *arch[:2], "-shared", "-o", lib,
                            *(f"{tmp}/p{i}_{u}.o" for u in units),
                            f"{tmp}/fused_block.cu.o",
                            f"{tmp}/fused_block_f32.cu.o"], check=True)
            out = subprocess.run([sys.executable, "-c", CHILD_B4,
                                  f"{tmp}/p{i}.npz", lib], cwd=root,
                                 capture_output=True, text=True)
            if out.returncode:
                print(out.stderr, file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            dev = {k: sum(v.values()) for k, v in res["device_ms"].items()}
            print(f"probe {name}: B4 sum {sum(res['ms'].values()):.4f} ms "
                  f"per training step (device {sum(dev.values()):.4f})")
            for k, v in res["ms"].items():
                print(f"  {k}: {v:.4f} ms, device {res['device_ms'][k]}")
    return 0


def main_b4(roots, sweep: bool) -> int:
    """B4 in each checkout: ms per call and per step, each gradient's
    error against the plain version, bit identity between runs; with
    ``sweep``, device ms at every cluster size and thread count."""
    import numpy as np
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(roots):
            dump = f"{tmp}/run{i}.npz"
            out = subprocess.run([sys.executable, "-c", CHILD_B4, dump, "-",
                                  str(int(sweep))],
                                 cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stderr, file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            outs = dict(np.load(dump))
            if first is None:
                first = outs
            differ = sum(int((outs[k] != first[k]).sum()) for k in first)
            total = sum(v.size for v in first.values())
            worst = max(max(e.values()) for e in res["errs"].values())
            dev = {k: sum(v.values()) for k, v in res["device_ms"].items()}
            print(f"run {i}: {root}: build {res['build_s']:.1f} s, B4 sum "
                  f"{sum(res['ms'].values()):.4f} ms per training step "
                  f"(device {sum(dev.values()):.4f}); "
                  f"largest gradient error {worst:.4g} of its max (bound "
                  f"{2.0 ** -5:.4g}); {differ} of {total} output elements "
                  "differ from run 0")
            for k, v in res["ms"].items():
                e = res["errs"][k]
                print(f"  {k}: {v:.4f} ms, device {res['device_ms'][k]}; "
                      f"repeat bit-identical {res['repeat_identical'][k]}; "
                      f"{res['info'][k]}")
                print("    errors " + ", ".join(
                    f"{n} {x:.3g}" for n, x in e.items()))
                if k in res.get("sweep", {}):
                    print("    device ms by CTAs per window x threads: "
                          + ", ".join(f"{c} {v:.4f}" for c, v in
                                      res["sweep"][k].items()))
                if max(e.values()) > 2.0 ** -5:
                    print(f"  {k}: a gradient error above 2^-5")
                    return 1
    return 0


def main_dp(roots) -> int:
    """B1, B5 and B4 with dropout at batch 4 in each checkout: ms per call
    and per kernel, every output bit for bit against run 0's."""
    import numpy as np
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(roots):
            dump = f"{tmp}/run{i}.npz"
            out = subprocess.run([sys.executable, "-c", CHILD_DP, dump],
                                 cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stderr, file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            outs = dict(np.load(dump))
            if first is None:
                first = outs
            sums = {}
            for k, v in res["ms"].items():
                sums[k.split()[0]] = sums.get(k.split()[0], 0.0) + v
            line = ", ".join(
                f"{kern} {sums[kern]:.4f} ms ("
                f"{sum(int((outs[k] != first[k]).sum()) for k in first if k.startswith(kern))}"
                f" of {sum(first[k].size for k in first if k.startswith(kern))}"
                " elements differ from run 0)" for kern in sorted(sums))
            print(f"run {i}: {root}: build {res['build_s']:.1f} s; {line}")
            for k, v in res["ms"].items():
                print(f"  {k}: {v:.4f} ms")
    return 0


# B6/B7/B8 design probes (window_attention.cu, MIVP_B6_SKIP): parts
# compiled out.
B6_PROBES = (("as built", {}),
             ("no bias", {"MIVP_B6_SKIP": 1}),
             ("no staging of y or q/k/v", {"MIVP_B6_SKIP": 2}),
             ("no projection", {"MIVP_B6_SKIP": 4}),
             ("no attention", {"MIVP_B6_SKIP": 8}),
             ("no P.V", {"MIVP_B6_SKIP": 16}),
             ("registers for 2 CTAs per SM", {"MIVP_B6_MINB": 2}),
             ("32-key softmax steps", {"MIVP_B6_CHUNK": 32}))


def attention_libs(roots, tmp, defs=None):
    """``window_attention.cu`` of each root (or of ``roots[0]`` once per
    entry of ``defs``) built alone into a shared library, all at once:
    the children load the attention entry from it, not the whole kernel
    library.  Returns the libraries' paths."""
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xcompiler", "-fPIC", "-shared"]
    jobs = [(root, {}) for root in roots] if defs is None else \
        [(roots[0], d) for d in defs]
    libs, procs = [], []
    for i, (root, d) in enumerate(jobs):
        lib = f"{tmp}/attn{i}.so"
        libs.append(lib)
        procs.append(subprocess.Popen(
            [NVCC, *arch, *(f"-D{k}={v}" for k, v in d.items()), "-o", lib,
             str(root / PKG / "csrc" / "window_attention.cu")],
            stderr=subprocess.PIPE, text=True))
    for proc in procs:
        _, err = proc.communicate()   # reads stderr: a full pipe would block
        if proc.returncode:
            raise RuntimeError(err)
    return libs


def run_b6(root, lib, dump, sweep=False):
    out = subprocess.run([sys.executable, "-c", CHILD_B6, dump, lib,
                          str(int(sweep))], cwd=root, capture_output=True,
                         text=True)
    if out.returncode:
        print(out.stderr, file=sys.stderr)
        return None
    return json.loads(out.stdout.strip().splitlines()[-1])


def print_b6(res) -> None:
    per = {"B6": 0.0, "B7": 0.0, "B8": 0.0}
    for k, v in res["ms"].items():
        per[k.split()[0]] += v
    print(f"  B6 {per['B6']:.4f} + B8 {per['B8']:.4f} = "
          f"{per['B6'] + per['B8']:.4f} ms per 27-window unfused forward "
          f"(B7 on B6's calls {per['B7']:.4f})")
    for k, v in res["ms"].items():
        line = f"  {k}: {v:.4f} ms; {res['info'][k]}"
        if k in res["sdpa_ms"]:
            line += f"; scaled_dot_product_attention {res['sdpa_ms'][k]:.4f}"
        print(line)
        for opt, t in res["sweep"].get(k, {}).items():
            print(f"    {opt}: {t if isinstance(t, str) else f'{t:.4f}'}")


def main_b6(roots, sweep: bool) -> int:
    """B6/B7/B8 in each checkout at the 12 unfused calls: ms per call
    beside scaled_dot_product_attention (unshifted B7/B8), the launch
    shape, bit identity with run 0; with ``sweep``, the dense-bias form
    and B6 on the whole windows."""
    import numpy as np
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        libs = attention_libs(list(dict.fromkeys(roots)), tmp)
        lib_of = dict(zip(dict.fromkeys(roots), libs))
        for i, root in enumerate(roots):
            dump = f"{tmp}/run{i}.npz"
            res = run_b6(root, lib_of[root], dump, sweep)
            if res is None:
                return 1
            outs = dict(np.load(dump))
            if first is None:
                first = outs
            differ = {k: int((outs[k] != first[k]).sum()) for k in first}
            print(f"run {i}: {root}: {sum(differ.values())} of "
                  f"{sum(v.size for v in first.values())} output elements "
                  f"differ from run 0 "
                  f"({ {k: d for k, d in differ.items() if d} or 'none'})")
            print_b6(res)
    return 0


def main_probe_b6(root: Path, only=None) -> int:
    """Time B6/B7/B8 at the 12 unfused calls with each probe of
    B6_PROBES compiled in (outputs are garbage and not compared)."""
    chosen = [(i, B6_PROBES[i]) for i in (only or range(len(B6_PROBES)))]
    with tempfile.TemporaryDirectory() as tmp:
        libs = attention_libs([root], tmp, [d for _, (_, d) in chosen])
        for lib, (i, (name, _)) in zip(libs, chosen):
            res = run_b6(root, lib, f"{tmp}/p{i}.npz")
            if res is None:
                return 1
            print(f"probe {name}:")
            print_b6(res)
    return 0


def main_probe(root: Path, only=None) -> int:
    """Time B1 at the 12 serving geometries with each probe of PROBES
    compiled in (outputs are garbage and not compared): where the time
    goes inside the block body, and each cluster size's time."""
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        chosen = [(i, PROBES[i]) for i in (only or range(len(PROBES)))]
        for i, (_, defs) in chosen:
            flags = [f"-D{k}={v}" for k, v in defs.items()]
            for unit in ("fused_block.cu", "fused_block_f32.cu"):
                procs.append(subprocess.Popen(
                    [NVCC, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     *flags, "-c", str(root / PKG / "csrc" / unit), "-o",
                     f"{tmp}/p{i}_{unit}.o"], stderr=subprocess.PIPE,
                    text=True))
        for proc in procs:
            _, err = proc.communicate()   # a full stderr pipe would block
            if proc.returncode:
                print(err, file=sys.stderr)
                return 1
        for i, (name, _) in chosen:
            lib = f"{tmp}/p{i}.so"
            subprocess.run([NVCC, *arch, "-shared", "-o", lib,
                            f"{tmp}/p{i}_fused_block.cu.o",
                            f"{tmp}/p{i}_fused_block_f32.cu.o"], check=True)
            out = subprocess.run([sys.executable, "-c", CHILD_B1,
                                  f"{tmp}/p{i}.npz", lib], cwd=root,
                                 capture_output=True, text=True)
            if out.returncode:
                print(out.stderr, file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            print(f"probe {name}: B1 sum {sum(res['ms'].values()):.4f} ms")
            for k, v in res["ms"].items():
                print(f"  {k}: {v:.4f} ms, cluster "
                      f"{res['info'][k]['cluster']}, CTAs per SM "
                      f"{res['info'][k]['ctas_per_sm']}")
    return 0


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv) -> int:
    import numpy as np
    kernel, sweep, quick = "b1", False, False
    while argv and argv[0].startswith("--"):
        if argv[0] == "--kernel":
            kernel, argv = argv[1], argv[2:]
        elif argv[0] == "--sweep":
            sweep, argv = True, argv[1:]
        elif argv[0] == "--quick":
            quick, argv = True, argv[1:]
        elif argv[0] == "--probe":
            print(f"card: {card_line()}")
            probe = {"b4": main_probe_b4, "b6": main_probe_b6}.get(
                kernel, main_probe)
            return probe(Path(argv[1]).resolve(), [int(a) for a in argv[2:]])
        else:
            break
    roots = [Path(a).resolve() for a in argv]
    if not roots or kernel not in ("b1", "b2", "b4", "b6", "dp"):
        print(__doc__, file=sys.stderr)
        return 2
    print(f"card: {card_line()}")
    if kernel == "dp":
        return main_dp(roots)
    b4_units = ("fused_block_bwd.cu", "fused_block_bwd_512.cu")
    names = ("conv3x3_pair.cu",) if kernel == "b2" else \
        b4_units if kernel == "b4" else (
        "window_attention.cu",) if kernel == "b6" else (
        "fused_block.cu", "fused_block_f32.cu", "window_attention.cu",
        "fused_pair.cu", "fused_pair_drop.cu", "fused_pair_f32.cu",
        "fused_pair_f32_drop.cu")
    for root in dict.fromkeys(roots if not quick else ()):
        print(f"ptxas -v, {root}:")
        ptxas(root, names)
    if kernel == "b2":
        return main_b2(roots, sweep)
    if kernel == "b4":
        return main_b4(roots, sweep)
    if kernel == "b6":
        return main_b6(roots, sweep)
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(roots):
            dump = f"{tmp}/run{i}.npz"
            out = subprocess.run([sys.executable, "-c", CHILD_B1, dump],
                                 cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stderr, file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            outs = dict(np.load(dump))
            if first is None:
                first = outs
            differ = sum(int((outs[k] != first[k]).sum()) for k in first)
            total = sum(v.size for v in first.values())
            print(f"run {i}: {root}: build {res['build_s']:.1f} s, "
                  f"{kernel.upper()} sum {sum(res['ms'].values()):.4f} ms "
                  f"per 27-window forward; "
                  f"{differ} of {total} output elements differ from run 0")
            for k, v in res["ms"].items():
                print(f"  {k}: {v:.4f} ms; {res['info'][k]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
