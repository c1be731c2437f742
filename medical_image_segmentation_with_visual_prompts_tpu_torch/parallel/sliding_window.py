"""Sliding-window inference on the device.

Counterpart of the JAX package's ``parallel/sliding_window.py``, in its
two modes:

* ``gaussian``: windows are cut from the device-resident volume, run
  through the model in chunks, turned into softmax probabilities,
  weighted by a separable Gaussian importance map (sigma = roi/8, floor
  1e-4), overlap-added into a volume and divided by the precomputed
  blend weights;
* ``per_window``: each window's argmax prediction, unstitched (the
  reference's evaluation protocol).
  The stitch is a plain slice-add per window -- the JAX coset
decomposition exists to avoid TPU scatters.  The window grid, bucket
and pad-coverage helpers are the same numpy functions.

With a data group (``group``, ``parallel/mesh.py``; the JAX ``mesh``),
each chunk is rounded up to a multiple of the world size, its windows
are split over the ranks (``ceil(n / world)`` each, the last padded with
zero windows), and the logits are gathered, so that every rank stitches
the same volume.

A call's steps are spans of ``utils/trace.py`` (``serve.pad``,
``serve.upload``, ``serve.preprocess``, ``serve.blend_weights``, per
chunk ``serve.gather``, ``serve.forward`` and ``serve.stitch``, then
``serve.divide``), with the counters ``serve.windows`` and
``serve.forwards``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import trace
from ..utils.device import resolve_device


def resolve_stride(window: Sequence[int], stride=None) -> Tuple[int, ...]:
    """None -> roi/2; a float f -> ``max(1, round(w*f))`` per axis; a
    sequence -> per-axis strides.  Strides must lie in [1, window]."""
    if stride is None:
        s = tuple(w // 2 for w in window)
    elif isinstance(stride, (int, float)):
        if stride <= 0:
            raise ValueError(f"stride factor must be positive, got {stride}")
        s = tuple(max(1, int(round(w * float(stride)))) for w in window)
    else:
        s = tuple(int(v) for v in stride)
    if len(s) != len(tuple(window)):
        raise ValueError(f"stride {s} rank != window {tuple(window)}")
    if any(si > wi or si < 1 for si, wi in zip(s, window)):
        raise ValueError(f"stride {s} must be in [1, window] {tuple(window)}")
    return s


def window_starts(image_size: Sequence[int], window: Sequence[int],
                  stride=None):
    """Center-crop slices, ``[N, 3]`` window starts (i-major), grid shape."""
    stride = resolve_stride(window, stride)
    slices, axes = [], []
    for i in range(3):
        adj = (image_size[i] - window[i]) // stride[i] * stride[i] + window[i]
        begin = (image_size[i] - adj) // 2
        slices.append(slice(begin, begin + adj))
        axes.append(np.arange(0, adj - window[i] + 1, stride[i]))
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return (tuple(slices), grid.astype(np.int32),
            tuple(len(a) for a in axes))


def bucket_shape(cropped: Sequence[int], window: Sequence[int]
                 ) -> Tuple[int, ...]:
    """Cropped shape rounded up to window multiples."""
    return tuple(int(-(-c // w) * w) for c, w in zip(cropped, window))


def cover_shape(dims: Sequence[int], window: Sequence[int], stride=None
                ) -> Tuple[int, ...]:
    """Smallest stride-grid extent ``(n-1)*s + w >= dims`` per axis."""
    stride = resolve_stride(window, stride)
    return tuple(int(max(w, -(-max(d - w, 0) // s) * s + w))
                 for d, w, s in zip(dims, window, stride))


def bucketed_starts(cropped: Sequence[int], window: Sequence[int],
                    stride=None):
    """Window grid over the bucket shape plus the mask of the windows
    that lie inside ``cropped`` (the others get zero blend weight)."""
    bucket = bucket_shape(cropped, window)
    _, starts, grid_shape = window_starts(bucket, window, stride)
    valid = np.all(starts + np.asarray(window, np.int32)
                   <= np.asarray(cropped, np.int32), axis=1)
    return starts, valid, grid_shape


def gaussian_importance(window: Sequence[int], sigma_scale: float = 0.125
                        ) -> np.ndarray:
    """Separable Gaussian importance map over a window, floored at 1e-4."""
    maps = []
    for w in window:
        x = np.arange(w, dtype=np.float32) - (w - 1) / 2.0
        sigma = max(w * sigma_scale, 1e-3)
        maps.append(np.exp(-0.5 * (x / sigma) ** 2))
    g = np.einsum("i,j,k->ijk", *maps).astype(np.float32)
    return np.maximum(g, 1e-4)


def gaussian_weight_acc(starts, valid, window, out_spatial) -> np.ndarray:
    """Stitched blend-weight volume ``[*out_spatial, 1]`` of the valid
    windows (``valid``: a leading count or a 0/1 vector)."""
    g = gaussian_importance(window)
    starts = np.asarray(starts)
    vmask = (np.arange(starts.shape[0]) < int(valid)) if np.ndim(valid) == 0 \
        else np.asarray(valid) > 0
    acc = np.zeros((*out_spatial, 1), np.float32)
    wh, ww, wd = window
    for s, v in zip(starts, vmask):
        if v:
            acc[s[0]:s[0] + wh, s[1]:s[1] + ww, s[2]:s[2] + wd, 0] += g
    return acc


class BucketedInference:
    """Sliding-window inference with shape bucketing.

    ``apply_fn`` maps a window batch ``[n, *window, C_in]`` to logits
    ``[n, *window, classes]``.  ``coverage="crop"``: callers pre-crop to
    the stride grid (the reference's semantics); ``"pad"``: the volume is
    padded up to the stride-grid cover with ``pad_value`` and every voxel
    is segmented.  ``chunk=None`` runs the whole grid in one batch when
    it has at most 32 windows, else batches of 16.  ``preprocess`` runs
    on the device on the uploaded volume (e.g. intensity windowing of a
    raw int16 payload).  ``mode="per_window"`` returns the argmax of each
    valid window instead of the stitched probabilities.
    """

    def __init__(self, apply_fn: Callable, window: Sequence[int],
                 chunk: Optional[int] = None, num_classes: int = 2,
                 stride=None, preprocess: Optional[Callable] = None,
                 coverage: str = "crop", pad_value: float = 0.0,
                 device=None, mode: str = "gaussian", group=None):
        if coverage not in ("crop", "pad"):
            raise ValueError(f"coverage must be crop|pad, got {coverage}")
        if mode not in ("gaussian", "per_window"):
            raise ValueError(f"mode must be gaussian|per_window, got {mode}")
        self.mode = mode
        self.group = group
        self.apply_fn = apply_fn
        self.window = tuple(window)
        self.chunk = chunk
        self.num_classes = num_classes
        self.stride = resolve_stride(window, stride)
        self.preprocess = preprocess
        self.coverage = coverage
        self.pad_value = pad_value
        self.device = resolve_device(device)
        self.gauss = torch.from_numpy(gaussian_importance(self.window))[
            ..., None].to(self.device)
        self._waccs = OrderedDict()   # (bucket, dims) -> blend weights
        self._waccs_max = 16
        self._buckets = set()

    @property
    def n_buckets(self) -> int:
        """Distinct bucket shapes served so far."""
        return len(self._buckets)

    def resolve_chunk(self, n_windows: int) -> int:
        """The window batch: ``chunk``, else the whole grid when it has
        at most 32 windows, else 16; rounded up to a multiple of the data
        group's world size."""
        chunk = int(self.chunk) if self.chunk is not None else \
            n_windows if n_windows <= 32 else 16
        world = 1 if self.group is None else self.group.world
        return -(-chunk // world) * world

    def _logits(self, vol: torch.Tensor, part) -> torch.Tensor:
        """The logits of the windows at ``part`` (starts): here, or this
        rank's share of them gathered from every rank."""
        wh, ww, wd = self.window
        group = self.group
        if group is None or not group.splits:
            with trace.span("serve.gather"):
                batch = torch.stack(
                    [vol[s[0]:s[0] + wh, s[1]:s[1] + ww, s[2]:s[2] + wd]
                     for s in part])
            with trace.span("serve.forward"):
                return self.apply_fn(batch)
        per = -(-len(part) // group.world)
        mine = part[group.rank * per:(group.rank + 1) * per]
        with trace.span("serve.gather"):
            batch = vol.new_zeros((per, wh, ww, wd, vol.shape[-1]))
            for i, s in enumerate(mine):
                batch[i] = vol[s[0]:s[0] + wh, s[1]:s[1] + ww, s[2]:s[2] + wd]
        with trace.span("serve.forward"):
            return group.gather(self.apply_fn(batch))[:len(part)]

    def plan(self, dims: Sequence[int]):
        """(bucket shape, starts [N, 3], validity [N]) for a volume."""
        if self.coverage == "pad":
            bucket = cover_shape(dims, self.window, self.stride)
            _, starts, _ = window_starts(bucket, self.window, self.stride)
            valid = np.ones((starts.shape[0],), bool)
        else:
            bucket = bucket_shape(dims, self.window)
            starts, valid, _ = bucketed_starts(dims, self.window, self.stride)
        return bucket, starts, valid

    def _weights(self, bucket, dims, starts, valid) -> torch.Tensor:
        key = (bucket, tuple(dims))
        if key in self._waccs:
            self._waccs.move_to_end(key)
        else:
            self._waccs[key] = torch.from_numpy(gaussian_weight_acc(
                starts, valid.astype(np.int32), self.window, bucket)).to(
                    self.device)
            while len(self._waccs) > self._waccs_max:
                self._waccs.popitem(last=False)
        return self._waccs[key]

    def __call__(self, cropped) -> torch.Tensor:
        """cropped: ``[H', W', D', C]`` numpy volume (already center-
        cropped for ``coverage="crop"``).  ``gaussian``: stitched class
        probabilities ``[H', W', D', classes]`` (fp32); ``per_window``:
        the argmax labels ``[N, *window]`` (int64) of the valid windows,
        in the order of ``plan(dims)[1][valid]``.  On the device."""
        dims = tuple(cropped.shape[:3])
        bucket, starts, valid = self.plan(dims)
        self._buckets.add(bucket)
        with trace.span("serve.pad"):
            pads = [(0, b - d) for b, d in zip(bucket, dims)] + [(0, 0)]
            vol = np.pad(np.asarray(cropped), pads,
                         constant_values=np.asarray(
                             self.pad_value, np.asarray(cropped).dtype))
        with trace.span("serve.upload"):
            vol = torch.from_numpy(vol).to(self.device, non_blocking=True)
        if self.preprocess is not None:
            with trace.span("serve.preprocess"):
                vol = self.preprocess(vol)
        per_window = self.mode == "per_window"
        if not per_window:
            with trace.span("serve.blend_weights"):
                wacc = self._weights(bucket, dims, starts, valid)
            acc = torch.zeros((*bucket, self.num_classes),
                              dtype=torch.float32, device=self.device)
        starts = starts[valid]
        trace.count("serve.windows", len(starts))
        preds = []
        wh, ww, wd = self.window
        chunk = self.resolve_chunk(len(starts))
        for c0 in range(0, len(starts), chunk):
            part = starts[c0:c0 + chunk]
            logits = self._logits(vol, part)
            trace.count("serve.forwards")
            if per_window:
                preds.append(torch.argmax(logits, dim=-1))
                continue
            with trace.span("serve.stitch"):
                probs = torch.softmax(logits.float(), dim=-1) * self.gauss
                for s, p in zip(part, probs):
                    acc[s[0]:s[0] + wh, s[1]:s[1] + ww, s[2]:s[2] + wd] += p
        if per_window:
            return torch.cat(preds)
        with trace.span("serve.divide"):
            probs = acc / torch.clamp(wacc, min=1e-8)
        return probs[:dims[0], :dims[1], :dims[2]]
