#!/usr/bin/env python3
"""A/B of the port's fused Swin block kernel (B1) between checkouts.

Run on a machine with one CUDA card, from the repository root::

    python3 tools/torch_ab_b1.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout holding the PyTorch port; each
runs in its own process, in the order given (alternate them: A B B A).
Each process builds that checkout's kernels, runs B1 at the 12 flagship
serving geometries (27 windows; no dropout, as serving calls it) on the
same seeded blocks and inputs, and times each call with CUDA events.
Outputs of every run are compared bit for bit with the first run's.
``ptxas -v`` register counts of each checkout's ``fused_block.cu`` (and
``window_attention.cu`` and ``fused_pair.cu``, which share its device
code, where the checkout has them) are printed first.  Imports torch and the port only.
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

CHILD = r'''
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
t0 = time.perf_counter()
kernels.library()
build_s = time.perf_counter() - t0
g = torch.Generator().manual_seed(0)
outs, times = {}, {}
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
np.savez(sys.argv[1], **outs)
print(json.dumps({"build_s": build_s, "ms": times}))
'''


def ptxas(root: Path) -> None:
    """Registers, shared memory and spills of each kernel instantiation
    of the checkout's attention sources (``nvcc -Xptxas -v``)."""
    for name in ("fused_block.cu", "window_attention.cu", "fused_pair.cu"):
        src = root / PKG / "csrc" / name
        if not src.exists():
            continue
        print(f"  {name}:")
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run(
                [NVCC, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-Xptxas", "-v", "-c", str(src),
                 "-o", f"{tmp}/k.o"], capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{out.stderr}")
        kernel = None
        for line in out.stderr.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif ("registers" in line or "spill" in line) and kernel:
                print(f"    {kernel}: {line.split(':', 1)[-1].strip()}")


def main(argv) -> int:
    import numpy as np
    roots = [Path(a).resolve() for a in argv]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    for root in dict.fromkeys(roots):
        print(f"ptxas -v, {root}:")
        ptxas(root)
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(roots):
            dump = f"{tmp}/run{i}.npz"
            out = subprocess.run([sys.executable, "-c", CHILD, dump],
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
            print(f"run {i}: {root}: build {res['build_s']:.1f} s, B1 sum "
                  f"{sum(res['ms'].values()):.4f} ms per 27-window forward; "
                  f"{differ} of {total} output elements differ from run 0")
            print("  " + ", ".join(f"{k} {v:.4f}" for k, v in
                                   res["ms"].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
