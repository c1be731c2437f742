"""Faults planted in the MedSAM program underneath a run of
``medsam_ct512x64_box32``, for the checks that ``correct`` comes out
false (``tests/test_portbench_medsam.py`` on the CPU; this file's
command on the card).  Each ``plant(name)`` patches the program and
returns the function that undoes it.

* ``relpos_zeroed``: the image encoder's rel-pos tables read as zeros;
* ``pad_masked``: the windowed blocks mask the padded tokens out of the
  keys (MedSAM attends over them);
* ``global_windowed``: the global blocks attend in the windows of the
  windowed blocks (their tables' central rows);
* ``box_shifted``: the box moved by one patch (16 pixels of the 1024^2
  image) along x.

    python3 benchmark/faults_medsam.py --fault NAME --seeds 1,2,3 [--out FILE]

prints, per seed, a run of ``CELL`` for ``SECONDS`` seconds: its compared
numbers and ``correct`` as one JSON line (``calibrate.py``'s lines).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

FAULTS = ("relpos_zeroed", "pad_masked", "global_windowed", "box_shifted")
CELL = "medsam_ct512x64_box32"
SECONDS = 2.0


def _patch(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def plant(name: str):
    from medical_image_segmentation_with_visual_prompts_tpu_torch.models \
        import sam
    from medical_image_segmentation_with_visual_prompts_tpu_torch.parallel \
        import sam_slices
    if name == "relpos_zeroed":
        real = sam.Attention.rel_table

        def zeroed(self, table, size):
            return torch.zeros_like(real(self, table, size))
        return _patch(sam.Attention, "rel_table", zeroed)
    if name == "pad_masked":
        real = sam.Block.forward

        def masked(self, x):
            ws = self.window_size
            if ws == 0:
                return real(self, x)
            shortcut = x
            x = self.norm1(x)
            hw = x.shape[1:3]
            xw, pad_hw = sam.window_partition(x, ws)
            valid, _ = sam.window_partition(torch.ones_like(x[..., :1]), ws)
            attn = self.attn
            n, _, _, c = xw.shape
            q, k, v = attn.qkv(xw).view(n, ws * ws, 3, attn.num_heads,
                                        -1).permute(2, 0, 3, 1, 4).unbind(0)
            rel_h, rel_w = attn.rel_terms(q, ws, ws)
            bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
                n, attn.num_heads, ws * ws, ws * ws).masked_fill(
                valid.reshape(n, 1, 1, ws * ws) == 0, float("-inf"))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            o = attn.proj(o.transpose(1, 2).reshape(n, ws, ws, c))
            x = shortcut + sam.window_unpartition(o, ws, pad_hw, hw)
            return x + self.mlp(self.norm2(x))
        return _patch(sam.Block, "forward", masked)
    if name == "global_windowed":
        real = sam.ImageEncoderViT.forward

        def windowed(self, x):
            ws = max(b.window_size for b in self.blocks)
            glob = [b for b in self.blocks if b.window_size == 0]
            for b in glob:
                b.window_size = ws
            try:
                return real(self, x)
            finally:
                for b in glob:
                    b.window_size = 0
        return _patch(sam.ImageEncoderViT, "forward", windowed)
    if name == "box_shifted":
        real = sam_slices.SamSlices.box_image

        def shifted(self, box, hw):
            step = float(self.conf.patch_size)
            shift = torch.tensor([step, 0.0, step, 0.0])
            return real(self, box, hw) + shift.to(self.device)
        return _patch(sam_slices.SamSlices, "box_image", shifted)
    raise KeyError(f"no fault {name!r}")


def main(argv=None) -> int:
    from benchmark import common
    p = argparse.ArgumentParser()
    p.add_argument("--fault", required=True, choices=FAULTS)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    manifest = common.load_manifest(ROOT)
    common.set_cache_dirs()
    common.require_cuda(1)
    undo = plant(args.fault)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            cell = common.load_cell(manifest, CELL, seed, SECONDS,
                                    False, ROOT)
            t0 = time.perf_counter()
            o = common.driver(cell).run(cell)
            line = json.dumps({
                "workload": cell.name, "seed": seed, "kind": args.fault,
                "correct": o.correct, "detail": o.detail,
                "checks": {k: v for k, (v, _) in o.checks.items()},
                "metrics": o.metrics,
                "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            common.free_memory()
    finally:
        undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
