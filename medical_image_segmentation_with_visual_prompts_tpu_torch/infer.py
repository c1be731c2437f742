"""Volume inference CLI: segment NIfTI volumes with the PyTorch port.

Counterpart of the JAX package's ``infer.py``: loads a checkpoint (a
reference-schema ``.pt``, as ``mivp-export-checkpoint`` writes it, or a
msgpack checkpoint that either package's trainer writes), runs
Gaussian-stitched sliding-window inference on the device and writes the
label volume back as NIfTI.  Worker processes decode the next volumes
and encode the previous ones, and a writer thread downloads each label
crop, while the device runs the current volume.  The upload is the raw
(typically int16 HU) volume, windowed on the device; the argmax is taken
on the device too.

:func:`segment_volume` is the Python API of one preprocessed volume in
memory (the JAX package's ``segment_volume``).

``--watch`` polls one input directory and serves each new volume as it
arrives, with the model, the runner and the IO workers kept warm across
polls (:func:`watch_directory`).

``model_family: medsam`` in the YAML serves MedSAM (SAM ViT-B,
``models/sam.py``) slice by slice with a box prompt
(``parallel/sam_slices.py``): ``--ckpt`` is a ``.pt``/``.pth`` state
dict under segment_anything's names (MedSAM's ``medsam_vit_b.pth``) and
``--box x0 y0 x1 y1 z0 z1`` the box, in voxels, prompting every input
(slices ``z0 <= z < z1``; x along a slice's columns, axis 1); the
Swin-UNETR serving flags (:data:`SWIN_ONLY_FLAGS`) are refused.  The
family is read once, when the model is built; each volume then takes
its family's path.

``mesh_data`` (and ``distributed``) in the YAML serve data parallel, one
process per device (``torchrun --nproc-per-node N``): each window chunk
is split over the ranks and its logits gathered, so every rank stitches
the same volume (``parallel/sliding_window.py``); rank 0 alone writes the
label volumes and reports, and in watch mode decides which volumes are
new.

Usage:
  python -m medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
    --configs example_configs.yml --ckpt model.pt \
    --use-encoder-prompting --use-decoder-prompting \
    --input case.nii.gz --output case_seg.nii.gz
  ... --input incoming/ --output labels/ --watch --watch-interval 5
  python -m medical_image_segmentation_with_visual_prompts_tpu_torch.infer \
    --configs medsam_vit_b.yml --ckpt medsam_vit_b.pth \
    --input case.nii.gz --output case_seg.nii.gz --box 120 96 300 260 20 52
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
import time
from argparse import ArgumentParser
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig, SamConfig, load_conf, model_family
from .data import load_served, write_labels
from .data import native as native_lib
from .models import SwinUnetR
from .models.sam import Sam
from .parallel import (BucketedInference, maybe_initialize_distributed,
                       window_starts)
from .parallel.mesh import mesh_of
from .parallel.sam_slices import SamSlices
from .utils import load_reference_checkpoint, trace
from .utils.checkpoint import load_checkpoint, restore_like
from .utils.device import resolve_device
from .utils.torch_import import load_flax_variables, to_flax_variables

# Worker processes for the host IO of serving (NIfTI decode and encode).
# In threads this work slowed the main thread's GIL-releasing torch calls
# (~1750 per forward) by half again; in processes it leaves the GIL alone.
# Decoding and encoding a CT volume takes about twice as long as the
# card's forward of it: four workers keep up, two did not.
IO_WORKERS = 4
_io_pool: Optional[ProcessPoolExecutor] = None


def device_scale_intensity(a_min: float = -1000.0, a_max: float = 1000.0,
                           b_min: float = 0.0, b_max: float = 1.0,
                           clip: bool = True):
    """On-device CT intensity windowing (``ScaleIntensityRanged``) of a raw
    upload, in fp32: ``(x - a_min) * (b_max - b_min)/(a_max - a_min) +
    b_min``, clipped to [b_min, b_max]."""
    scale = float(np.float32((b_max - b_min) / (a_max - a_min)))

    def fn(x: torch.Tensor) -> torch.Tensor:
        v = (x.float() - float(np.float32(a_min))) * scale \
            + float(np.float32(b_min))
        if clip:
            v = torch.clamp(v, float(np.float32(b_min)),
                            float(np.float32(b_max)))
        return v

    return fn


Runner = Union[BucketedInference, SamSlices]


def predict_device(runner: Runner, roi, volume: np.ndarray,
                   box: Optional[Sequence[int]] = None):
    """One volume's labels on the device: the label crop (uint8 device
    tensor) and the crop slices within the volume.  A Swin-UNETR runner
    stitches its windows and takes the argmax (``roi``: its window); a
    MedSAM runner (:class:`SamSlices`) segments the slices of ``box``
    ``(x0, y0, x1, y1, z0, z1)`` and returns the whole label volume.  One
    unit of the tracer (``serve.volume``)."""
    with trace.unit("serve.volume", runner.device):
        return _predict(runner, roi, volume, box)


def _predict(runner: Runner, roi, volume: np.ndarray, box=None):
    if isinstance(runner, SamSlices):
        if box is None:
            raise TypeError("a MedSAM runner needs a box")
        with torch.inference_mode():
            return runner(volume, box), tuple(slice(0, d)
                                              for d in volume.shape[:3])
    if box is not None:
        raise TypeError("a box prompts a MedSAM runner, and only it")
    if runner.coverage == "pad":
        slices = tuple(slice(0, d) for d in volume.shape[:3])
        cropped = np.ascontiguousarray(volume)
    else:
        slices, _, _ = window_starts(volume.shape[:3], roi, runner.stride)
        with trace.span("serve.crop"):
            cropped = np.ascontiguousarray(
                volume[slices[0], slices[1], slices[2]])
    with torch.inference_mode():
        probs = runner(cropped)
        with trace.span("serve.argmax"):
            dtype = torch.uint8 if probs.shape[-1] <= 256 else torch.int16
            return torch.argmax(probs, dim=-1).to(dtype), slices


def segment_volume(conf, model: SwinUnetR, volume: np.ndarray,
                   chunk: Optional[int] = None, stride=None) -> np.ndarray:
    """The Python API of the JAX package's ``segment_volume``: a
    preprocessed (host-windowed) ``[H, W, D, 1]`` volume -> ``[H, W, D]``
    int16 labels, on the device ``model`` is on.  Gaussian-stitched
    bucketed windows (:class:`BucketedInference`) over the stride-aligned
    centre crop, as the JAX function's runner crops; voxels outside the
    crop stay background 0.  ``mesh_data`` in ``conf`` (a mapping or a
    namespace) splits the window chunks over the data group."""
    conf = conf if isinstance(conf, dict) else vars(conf)
    roi = tuple(conf["roi_size"])
    runner = make_runner(conf, model, chunk, stride=stride,
                         device_windowing=False, coverage="crop")
    crop, slices = predict_device(runner, roi, volume)
    labels = np.zeros(volume.shape[:3], np.int16)
    labels[slices] = crop.cpu().numpy()
    return labels


def resolve_io(inputs: List[str], output: str) -> List[Tuple[Path, Path]]:
    """Expand --input files/directories into (src, dst) pairs."""
    srcs: List[Path] = []
    for item in inputs:
        p = Path(item)
        if p.is_dir():
            srcs.extend(sorted(q for q in p.iterdir()
                               if q.name.endswith((".nii", ".nii.gz"))))
        else:
            srcs.append(p)
    if not srcs:
        raise FileNotFoundError(f"no NIfTI volumes under {inputs}")
    out = Path(output)
    if out.suffix in (".nii", ".gz"):
        if len(srcs) == 1:
            return [(srcs[0], out)]
        raise ValueError(
            f"multiple inputs ({len(srcs)}) require a directory --output, "
            f"got file-like path {out}")
    out.mkdir(parents=True, exist_ok=True)
    pairs = []
    for s in srcs:
        stem = s.name
        for suf in (".nii.gz", ".nii"):
            if stem.endswith(suf):
                stem = stem[: -len(suf)]
                break
        pairs.append((s, out / f"{stem}_seg.nii.gz"))
    return pairs


def make_runner(conf: dict, model: Union[SwinUnetR, Sam],
                chunk: Optional[int] = None, stride=None,
                device_windowing: bool = True, coverage: str = "pad",
                mode: str = "gaussian") -> Runner:
    """Serving runner around ``model`` (already on its device; put in
    eval mode here).  A :class:`Sam` model gets a :class:`SamSlices`
    runner, which windows its uploads on the device to the model's
    ``hu_window`` and takes none of the other arguments.

    ``device_windowing``: volumes are uploaded raw and windowed on the
    device (pad value -1000 HU, air); otherwise they arrive windowed on
    the host (pad value 0).  ``coverage="pad"`` segments every voxel;
    ``"crop"`` reproduces the reference's center-crop grid.  ``mode``:
    the stitcher's (``BucketedInference``); serving stitches.
    ``mesh_data`` in ``conf``: the chunks are split over the data group.
    """
    model.eval()
    device = next(model.parameters()).device
    if isinstance(model, Sam):
        return SamSlices(model, device_scale_intensity(*model.conf.hu_window),
                         device)

    def apply_fn(batch: torch.Tensor) -> torch.Tensor:
        return model(batch)

    return BucketedInference(
        apply_fn, tuple(conf["roi_size"]), chunk,
        model.conf.output_channels_downstream, stride=stride,
        preprocess=device_scale_intensity() if device_windowing else None,
        coverage=coverage, pad_value=-1000.0 if device_windowing else 0.0,
        device=device, mode=mode, group=mesh_of(conf))


def io_pool() -> ProcessPoolExecutor:
    """The worker processes that decode and encode served volumes, started
    (spawned) on first use and kept for the life of the process."""
    global _io_pool
    if _io_pool is None:
        _io_pool = ProcessPoolExecutor(
            IO_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return _io_pool


def serve_volumes(conf: dict, model: Optional[Union[SwinUnetR, Sam]],
                  pairs: List[Tuple[Path, Path]], chunk: Optional[int] = None,
                  runner: Optional[Runner] = None, stride=None,
                  device_windowing: bool = True,
                  coverage: str = "pad",
                  native: bool = True,
                  box: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """Segment a batch of volumes with pipelined host IO.  Per-volume
    load, inference or write failures are reported and counted.  Returns
    ``(n_done, n_failed)``.  ``native``: the workers decode with the
    native library (``data/native.py``, built here before they start),
    else with numpy.  ``box``: the box that prompts every volume of a
    MedSAM runner.

    The IO workers are spawned processes, which import the caller's main
    module: a script that calls this runs its work under
    ``if __name__ == "__main__":``."""
    roi = tuple(conf["roi_size"]) if "roi_size" in conf else None
    if runner is None:
        runner = make_runner(conf, model, chunk, stride=stride,
                             device_windowing=device_windowing,
                             coverage=coverage)
    if native:
        native_lib.library()
    pool = io_pool()
    raw_feed = runner.preprocess is not None
    # Data parallel: every rank serves every volume; rank 0 writes.
    writes = runner.group is None or runner.group.is_main
    to_write: "queue.Queue" = queue.Queue(maxsize=2)
    write_failures: List[Path] = []

    def report(dst, src_name, write):
        try:
            print(f"{src_name} -> {dst} (labels: {write.result()})")
        except Exception as e:              # count it, keep serving
            print(f"FAILED write {dst}: {e}")
            write_failures.append(dst)

    def writer():
        # Downloads each label crop (waiting for the device) and hands it
        # to a worker to embed and encode; reports the writes in order.
        written = deque()
        while True:
            item = to_write.get()
            if item is None:
                break
            dst, src_name, pred_dev, slices, shape, volume_unit = item
            try:
                with trace.span("serve.download", parent=volume_unit):
                    crop = pred_dev.cpu().numpy()
                written.append((dst, src_name, pool.submit(
                    write_labels, str(dst), crop, slices, shape)))
            except Exception as e:
                print(f"FAILED write {dst}: {e}")
                write_failures.append(dst)
            while written and written[0][2].done():
                report(*written.popleft())
        while written:
            report(*written.popleft())

    # Decodes run ahead of the device by up to IO_WORKERS + 1 volumes.
    todo = iter(pairs)
    decoding = deque()

    def decode_ahead():
        while len(decoding) <= IO_WORKERS:
            sd = next(todo, None)
            if sd is None:
                return
            decoding.append((*sd, pool.submit(load_served, str(sd[0]),
                                              raw_feed, native)))

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    n_done = n_failed = 0
    t0 = time.perf_counter()
    decode_ahead()
    while decoding:
        src, dst, decoded = decoding.popleft()
        decode_ahead()
        try:
            vol = decoded.result()
        except Exception as e:              # surface per-volume failures
            print(f"FAILED {src}: {e}")
            n_failed += 1
            continue
        try:
            with trace.unit("serve.volume", runner.device) as volume_unit:
                pred_dev, slices = _predict(runner, roi, vol, box)
        except Exception as e:  # e.g. volume smaller than the roi
            print(f"FAILED inference {src}: {e}")
            n_failed += 1
            continue
        if writes:
            to_write.put((dst, src.name, pred_dev, slices, vol.shape[:3],
                          volume_unit))
        n_done += 1
    to_write.put(None)
    wt.join()
    n_done -= len(write_failures)
    n_failed += len(write_failures)
    dt = time.perf_counter() - t0
    if n_done and writes:
        print(f"{n_done} volumes in {dt:.2f}s ({n_done / dt:.2f} vol/s, "
              f"{runner.n_buckets} buckets)")
    return n_done, n_failed


def watch_directory(conf: dict, model: SwinUnetR, src: Path, out: Path,
                    chunk: Optional[int] = None, interval: float = 5.0,
                    min_age: float = 1.0, max_polls: Optional[int] = None,
                    stride=None, device_windowing: bool = True,
                    coverage: str = "pad",
                    box: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """Watch mode: poll ``src`` for new NIfTI volumes and segment them as
    they arrive, with one runner (and the IO worker processes) kept warm
    across polls.

    A volume is taken once its mtime is at least ``min_age`` seconds old
    (a half-written upload is left alone) and is never retried: a failure
    is counted once.  A volume whose ``*_seg`` output exists is taken as
    served (an idempotent restart).  ``max_polls`` bounds the loop (tests);
    ``None`` runs until interrupted.  Returns the cumulative ``(n_done,
    n_failed)``.
    """
    out.mkdir(parents=True, exist_ok=True)
    runner = make_runner(conf, model, chunk, stride=stride,
                         device_windowing=device_windowing,
                         coverage=coverage)
    seen = set()
    n_done = n_failed = polls = 0
    print(f"watching {src} -> {out} (every {interval:.1f}s)")
    while max_polls is None or polls < max_polls:
        if polls:
            time.sleep(interval)
        polls += 1
        now = time.time()
        fresh = []
        for p in sorted(src.iterdir()):
            if not p.name.endswith((".nii", ".nii.gz")) or p in seen:
                continue
            try:
                if now - p.stat().st_mtime < min_age:
                    continue                 # possibly still uploading
            except FileNotFoundError:
                continue                     # vanished between scans
            (_, dst), = resolve_io([str(p)], str(out))
            seen.add(p)
            if dst.exists():
                continue                     # served by an earlier run
            fresh.append((p, dst))
        group = runner.group
        if group is not None and group.group is not None:
            import torch.distributed as dist
            shared = [fresh]    # rank 0's view of the directory
            dist.broadcast_object_list(shared, src=0, group=group.group)
            fresh = shared[0]
        if fresh:
            d, f = serve_volumes(conf, model, fresh, runner=runner, box=box)
            n_done += d
            n_failed += f
    return n_done, n_failed


def build_model(conf: dict, state_dict=None, device="cuda"
                ) -> Union[SwinUnetR, Sam]:
    """The serving model of ``conf``'s ``model_family``: the downstream
    Swin-UNETR, loaded (strictly) from a reference-schema state dict, or
    MedSAM's :class:`Sam`, from a state dict under segment_anything's
    names; on ``device`` (the card unless ``"cpu"`` is asked for; raises
    without CUDA), in eval mode."""
    device = resolve_device(device)
    if model_family(conf) == "medsam":
        mesh = int(conf.get("mesh_data", 0) or 0)
        dist = torch.distributed
        if mesh > 1 or (mesh == -1 and dist.is_available()
                        and dist.is_initialized()
                        and dist.get_world_size() > 1):
            raise ValueError(f"mesh_data {mesh}: MedSAM serves a study on "
                             "one card; data-parallel MedSAM serving is not "
                             "supported")
        model = Sam(SamConfig.from_mapping(conf))
    else:
        model = SwinUnetR(ModelConfig.from_mapping(
            {**conf, "training_mode": "downstream"}))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def load_model(conf: dict, ckpt, device="cuda") -> Union[SwinUnetR, Sam]:
    """:func:`build_model` with the weights of ``ckpt``: a ``.pt`` (by its
    suffix) in the reference schema, else a msgpack checkpoint whose
    ``model_state_dict`` holds the full model state.  MedSAM: a
    ``.pt``/``.pth`` state dict under segment_anything's names."""
    if model_family(conf) == "medsam":
        if Path(ckpt).suffix not in (".pt", ".pth"):
            raise ValueError(f"MedSAM loads a .pt/.pth state dict, got "
                             f"{ckpt}")
        return build_model(conf, torch.load(ckpt, map_location="cpu",
                                            weights_only=True), device)
    if Path(ckpt).suffix == ".pt":
        return build_model(conf, load_reference_checkpoint(ckpt), device)
    model = build_model(conf, device=device)
    load_flax_variables(model, restore_like(
        to_flax_variables(model), load_checkpoint(ckpt)["model_state_dict"]))
    return model


SWIN_ONLY_FLAGS = ("use_encoder_prompting", "use_decoder_prompting", "chunk",
                   "stride_factor", "coverage", "host_windowing")


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--configs", default="example_configs.yml")
    parser.add_argument("--ckpt", required=True,
                        help="reference-schema .pt (mivp-export-checkpoint) "
                             "or a trainer's msgpack checkpoint; MedSAM: a "
                             ".pt/.pth state dict")
    parser.add_argument("--input", required=True, nargs="+",
                        help="NIfTI file(s) or director(ies)")
    parser.add_argument("--output", required=True,
                        help="output file (single input) or directory")
    parser.add_argument("--use-encoder-prompting", action="store_true")
    parser.add_argument("--use-decoder-prompting", action="store_true")
    parser.add_argument("--chunk", type=int, default=None,
                        help="window batch per forward; default: the whole "
                             "grid when <= 32 windows, else 16")
    parser.add_argument("--stride-factor", type=float, default=0.5,
                        help="sliding-window stride as a fraction of the "
                             "roi (0.5 = reference parity)")
    parser.add_argument("--coverage", choices=["pad", "crop"], default="pad")
    parser.add_argument("--host-windowing", action="store_true",
                        help="window intensities on the host and upload "
                             "float32, instead of the raw int16 upload")
    parser.add_argument("--watch", action="store_true",
                        help="poll the --input directory and segment new "
                             "volumes as they arrive (model stays warm)")
    parser.add_argument("--watch-interval", type=float, default=5.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; fails without a "
                             "card unless --device cpu)")
    parser.add_argument("--box", type=int, nargs=6, default=None,
                        metavar=("X0", "Y0", "X1", "Y1", "Z0", "Z1"),
                        help="MedSAM: the box prompting every input, in "
                             "voxels (slices Z0 <= z < Z1; x along a "
                             "slice's columns)")
    args = parser.parse_args(argv)
    if args.watch and (len(args.input) != 1
                       or not Path(args.input[0]).is_dir()):
        raise SystemExit("--watch requires a single --input directory")
    conf = load_conf(args.configs, **vars(args))
    if (model_family(conf) == "medsam") != (args.box is not None):
        raise SystemExit("--box prompts a MedSAM config (model_family: "
                         "medsam), and such a config needs one")
    if model_family(conf) == "medsam":
        swin_only = [f"--{d.replace('_', '-')}" for d in SWIN_ONLY_FLAGS
                     if getattr(args, d) != parser.get_default(d)]
        if swin_only:
            raise SystemExit(f"{' '.join(swin_only)}: Swin-UNETR serving "
                             "only; a MedSAM config takes none of them")
    device = resolve_device(args.device)
    maybe_initialize_distributed(conf, device)
    mesh_of(conf)            # mesh_data against the world, before any read
    model = load_model(conf, args.ckpt, device)
    if args.watch:
        watch_directory(conf, model, Path(args.input[0]), Path(args.output),
                        chunk=args.chunk, interval=args.watch_interval,
                        stride=args.stride_factor,
                        device_windowing=not args.host_windowing,
                        coverage=args.coverage, box=args.box)
        return
    pairs = resolve_io(args.input, args.output)
    n_done, n_failed = serve_volumes(
        conf, model, pairs, chunk=args.chunk, stride=args.stride_factor,
        device_windowing=not args.host_windowing, coverage=args.coverage,
        box=args.box)
    if n_failed or not n_done:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
