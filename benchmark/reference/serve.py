"""Plain reference of Gaussian-stitched sliding-window segmentation of one
raw CT volume.

* Intensity windowing of the raw int16 HU values: ``(x + 1000) / 2000``
  clipped to [0, 1]; pad voxels are -1000 HU (air), windowed to 0.
* ``coverage="crop"``: the centre crop of the volume that the stride grid
  covers (``adj = (dim - w) // s * s + w`` per axis), padded up to window
  multiples; windows at stride ``s`` over that, those wholly inside the
  crop taking part.  ``coverage="pad"``: the volume padded at the high
  end up to the smallest stride-grid cover ``(n - 1) * s + w >= dim``;
  every window takes part.
* Each window's softmax probabilities are weighted by a separable
  Gaussian (sigma ``w / 8``, floored at 1e-4), summed into the volume,
  divided by the summed weights, and cropped back.

Returns the stitched class probabilities of the crop (fp32) and the crop
slices within the volume.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def strides(window: Sequence[int], factor: float) -> Tuple[int, ...]:
    return tuple(max(1, int(round(w * float(factor)))) for w in window)


def grid_starts(size: Sequence[int], window, stride):
    """Centre-crop slices and the ``[N, 3]`` window starts (i-major)."""
    slices, axes = [], []
    for n, w, s in zip(size, window, stride):
        adj = (n - w) // s * s + w
        lo = (n - adj) // 2
        slices.append(slice(lo, lo + adj))
        axes.append(np.arange(0, adj - w + 1, s))
    starts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return tuple(slices), starts


def gaussian(window: Sequence[int]) -> np.ndarray:
    maps = []
    for w in window:
        x = np.arange(w, dtype=np.float64) - (w - 1) / 2.0
        maps.append(np.exp(-0.5 * (x / max(w * 0.125, 1e-3)) ** 2))
    g = maps[0][:, None, None] * maps[1][None, :, None] * maps[2][None, None]
    return np.maximum(g, 1e-4).astype(np.float32)


def plan(shape: Sequence[int], window, factor: float, coverage: str):
    """(crop slices, padded extent, starts of the windows that take
    part)."""
    stride = strides(window, factor)
    dims = tuple(shape)
    if coverage == "pad":
        ext = tuple(max(w, -(-max(d - w, 0) // s) * s + w)
                    for d, w, s in zip(dims, window, stride))
        _, starts = grid_starts(ext, window, stride)
        return tuple(slice(0, d) for d in dims), ext, starts
    slices, _ = grid_starts(dims, window, stride)
    crop = tuple(sl.stop - sl.start for sl in slices)
    ext = tuple(-(-c // w) * w for c, w in zip(crop, window))
    _, starts = grid_starts(ext, window, stride)
    inside = np.all(starts + np.asarray(window) <= np.asarray(crop), axis=1)
    return slices, ext, starts[inside]


@torch.no_grad()
def stitched_probs(model, volume: np.ndarray, window, factor: float,
                   coverage: str, device, chunk: int = 8) -> tuple:
    """``model`` maps ``[n, *window, 1]`` fp32 windows to logits."""
    slices, ext, starts = plan(volume.shape[:3], window, factor, coverage)
    crop = volume[slices]
    dims = crop.shape[:3]
    raw = np.full(ext, -1000.0, np.float32)
    raw[:dims[0], :dims[1], :dims[2]] = crop.reshape(dims)
    vol = torch.as_tensor(raw, device=device)
    vol = ((vol + 1000.0) / 2000.0).clamp(0.0, 1.0)
    g = torch.as_tensor(gaussian(window), device=device)
    acc = None
    wsum = torch.zeros(ext, device=device)
    wh, ww, wd = window
    for c0 in range(0, len(starts), chunk):
        part = starts[c0:c0 + chunk]
        batch = torch.stack([vol[a:a + wh, b:b + ww, c:c + wd]
                             for a, b, c in part])[..., None]
        probs = torch.softmax(model(batch).float(), -1)
        if acc is None:
            acc = torch.zeros((*ext, probs.shape[-1]), device=device)
        for (a, b, c), p in zip(part, probs):
            acc[a:a + wh, b:b + ww, c:c + wd] += p * g[..., None]
            wsum[a:a + wh, b:b + ww, c:c + wd] += g
    out = acc / wsum.clamp_min(1e-8)[..., None]
    return out[:dims[0], :dims[1], :dims[2]], slices
