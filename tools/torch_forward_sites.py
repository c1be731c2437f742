#!/usr/bin/env python3
"""Where the device time of one serving forward goes, by call site.

Runs the port's flagship model (seeded random weights, bf16 trunk, eval)
on :data:`WINDOWS` random 128x128x8 windows on the card and profiles one
forward after a warm-up.  Each call site of the decoder's tail is
wrapped in a ``record_function`` range, where the checkout has it:

* ``site.upblock_resize`` / ``site.upblock_upsample``: the up blocks'
  einsum upsample, or the upsample kernel's wrapper;
* ``site.final_resize`` / ``site.final_upsample``: the final x2 upsample
  (the latter with the head as its epilogue);
* ``site.head``: ``SwinUnetR._head``; ``site.b2``: the pair conv;
  ``site.blocks``: the Swin block pairs; ``site.conv3d``: the patch
  embedding and bottleneck convs.

Each kernel is charged to the outermost site above the op that launched
it.  Prints, per site, the kernels' device ms by name and count, then
the ``cudaStreamSynchronize`` calls under the forward (count, host ms,
site), and the forward's CUDA-event ms over :data:`REPEATS` forwards.
``--root DIR`` runs the package of another checkout (a parent unpacked
with ``git archive``)::

    python3 tools/torch_forward_sites.py [--root DIR] [--out FILE]
"""

import argparse
import collections
import contextlib
import functools
import importlib
import json
import sys
from pathlib import Path

PKG = "medical_image_segmentation_with_visual_prompts_tpu_torch"
WINDOWS = 128   # the flagship serving cell's window batch
REPEATS = 5     # timed forwards after the warm-up
# (module, attribute, site) of every wrapped call site.
SITES = [("models.unet_blocks", "upsample_trilinear", "site.upblock_resize"),
         ("models.unet_blocks", "upsample", "site.upblock_upsample"),
         ("models.unet_blocks", "upsample_reference",
          "site.upblock_upsample"),
         ("models.unet_blocks", "conv3x3_fused_pair", "site.b2"),
         ("models.swin_unetr", "upsample_trilinear", "site.final_resize"),
         ("models.swin_unetr", "upsample", "site.final_upsample"),
         ("models.swin_unetr", "conv3d", "site.conv3d")]


def labelled(fn, name):
    import torch

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.autograd.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def wrap_sites():
    for mod, attr, site in SITES:
        module = importlib.import_module(f"{PKG}.{mod}")
        if hasattr(module, attr):
            setattr(module, attr, labelled(getattr(module, attr), site))
    swin = importlib.import_module(f"{PKG}.models.swin_unetr")
    swin.SwinUnetR._head = labelled(swin.SwinUnetR._head, "site.head")
    block = importlib.import_module(f"{PKG}.models.swin_block")
    block.ConsecutiveSwinBlocks.forward = labelled(
        block.ConsecutiveSwinBlocks.forward, "site.blocks")


def site_of(evt) -> str:
    """The outermost site above ``evt`` (``_head``'s conv is the head's)."""
    site = "other"
    while evt is not None:
        if evt.name.startswith("site."):
            site = evt.name
        evt = evt.cpu_parent
    return site


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    config = importlib.import_module(f"{PKG}.config")
    models = importlib.import_module(f"{PKG}.models")
    utils = importlib.import_module(f"{PKG}.utils")
    wrap_sites()
    model = models.SwinUnetR(config.flagship_conf())
    utils.init_weights(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.rand((WINDOWS, 128, 128, 8, 1),
                   generator=torch.Generator().manual_seed(1)).cuda()
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEATS):
            model(x)
        end.record()
        torch.cuda.synchronize()
        fwd_ms = start.elapsed_time(end) / REPEATS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    by_site = collections.defaultdict(lambda: collections.defaultdict(
        lambda: [0, 0.0]))
    syncs = collections.defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        for k in getattr(evt, "kernels", []):
            cell = by_site[site_of(evt)][k.name]
            cell[0] += 1
            cell[1] += k.duration / 1e3
        if evt.name == "cudaStreamSynchronize":
            cell = syncs[site_of(evt)]
            cell[0] += 1
            cell[1] += evt.cpu_time_total / 1e3
    if not by_site:
        print("no kernel attributed to an op; by name:")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=15))
    table = {site: {name: {"launches": n, "ms": round(ms, 4)}
                    for name, (n, ms) in sorted(kern.items(),
                                                key=lambda kv: -kv[1][1])}
             for site, kern in sorted(by_site.items())}
    print(f"card {torch.cuda.get_device_name(0)}; {WINDOWS} windows; "
          f"forward {fwd_ms:.3f} ms (CUDA events, mean of {REPEATS})")
    for site, kern in table.items():
        total = sum(v["ms"] for v in kern.values())
        launches = sum(v["launches"] for v in kern.values())
        print(f"{site}: {total:.3f} device ms, {launches} kernels")
        for name, v in list(kern.items())[:8]:
            print(f"    {v['ms']:9.3f} ms {v['launches']:5d}x  {name[:110]}")
    print("cudaStreamSynchronize under the forward: "
          + json.dumps({s: {"calls": n, "host_ms": round(ms, 3)}
                        for s, (n, ms) in syncs.items()}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"windows": WINDOWS, "forward_ms": fwd_ms, "sites": table,
             "syncs": {s: v for s, v in syncs.items()}}, indent=1))
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
