"""Host-side volume IO and the downstream training transforms.

Counterpart of the part of the JAX package's ``data/transforms.py`` that
serving uses: RAS reorientation from the NIfTI affine (MONAI
``Orientationd(axcodes="RAS")``), the raw-dtype loader whose int16
payload is uploaded and windowed on the device, and host-side intensity
windowing (``ScaleIntensityRanged(-1000..1000 -> 0..1, clip)``).
Outputs are channels-last ``[H, W, D, C]`` numpy arrays.

:func:`load_served` and :func:`write_labels` are the two ends of a served
volume; they import numpy only, so that serving can run them in worker
processes.

The training side (:func:`transform_downstream_fit`: optional random
orientation and resize, random spatial crops, symmetric pad) draws from
an explicit ``np.random.Generator`` in the JAX package's order, so one
seed gives the JAX loader's crops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .nifti import load_nifti, save_nifti


def scale_intensity_range(x: np.ndarray, a_min: float = -1000.0,
                          a_max: float = 1000.0, b_min: float = 0.0,
                          b_max: float = 1.0, clip: bool = True) -> np.ndarray:
    x = (np.asarray(x, np.float32) - a_min) / (a_max - a_min)
    x = x * (b_max - b_min) + b_min
    return np.clip(x, b_min, b_max) if clip else x


def orient_ras(data: np.ndarray, affine: np.ndarray) -> np.ndarray:
    """Permute and flip the three spatial axes of ``[H, W, D(, C)]`` so
    that the affine's rotation is closest to a positive diagonal; a
    degenerate affine leaves the volume as it is."""
    r = affine[:3, :3]
    world_axis = np.argmax(np.abs(r), axis=0)     # voxel axis -> world axis
    if len(set(world_axis.tolist())) != 3:
        return data
    perm = [int(np.where(world_axis == k)[0][0]) for k in range(3)]
    out = np.transpose(data, perm + list(range(3, data.ndim)))
    flips = tuple(k for k in range(3) if r[k, perm[k]] < 0)
    return np.ascontiguousarray(np.flip(out, flips) if flips else out)


def load_image_raw(path, ensure_channel: bool = True) -> np.ndarray:
    """RAS-oriented volume in its stored dtype (int16 for typical CT)."""
    data, affine = load_nifti(path)
    data = orient_ras(data, affine)
    if ensure_channel and data.ndim == 3:
        data = data[..., None]
    return np.ascontiguousarray(data)


def load_image(path, ensure_channel: bool = True) -> np.ndarray:
    return load_image_raw(path, ensure_channel).astype(np.float32)


def load_served(path, raw: bool) -> np.ndarray:
    """A volume as serving uploads it: in its stored dtype, to be windowed
    on the device (``raw``), or windowed here."""
    return load_image_raw(path) if raw else \
        scale_intensity_range(load_image(path))


def write_labels(path, crop: np.ndarray, slices, shape) -> List[int]:
    """Embed a label crop at ``slices`` of an int16 volume of ``shape``
    (the rest is background 0), write it as NIfTI, and return the label
    values present."""
    labels = np.zeros(shape, np.int16)
    labels[slices] = crop
    save_nifti(path, labels)
    return [int(v) for v in np.unique(labels)]


def resize(x: np.ndarray, out_size: Sequence[int],
           mode: str = "trilinear") -> np.ndarray:
    """Separable trilinear / nearest resize of ``[H, W, D, C]``."""
    from ..ops.resize import interp_matrix
    x = x.astype(np.float32)
    for ax in range(3):
        in_s, out_s = x.shape[ax], out_size[ax]
        if in_s == out_s:
            continue
        if mode == "nearest":
            idx = np.floor((np.arange(out_s) + 0.5) * in_s / out_s).astype(int)
            x = np.take(x, np.clip(idx, 0, in_s - 1), axis=ax)
        else:
            m = interp_matrix(in_s, out_s, align_corners=False)
            x = np.moveaxis(np.tensordot(m, np.moveaxis(x, ax, 0),
                                         axes=(1, 0)), 0, ax)
    return x


def rotate90(x: np.ndarray, k: int, spatial_axes: Tuple[int, int]
             ) -> np.ndarray:
    return np.ascontiguousarray(np.rot90(x, k=k, axes=spatial_axes))


def spatial_pad(x: np.ndarray, size: Sequence[int],
                value: float = 0.0) -> np.ndarray:
    """Symmetric pad of the spatial dims up to ``size`` (SpatialPadd)."""
    pads = []
    for ax in range(3):
        extra = max(size[ax] - x.shape[ax], 0)
        pads.append((extra // 2, extra - extra // 2))
    pads.append((0, 0))
    if any(p != (0, 0) for p in pads):
        x = np.pad(x, pads, constant_values=value)
    return x


def rand_spatial_crop(x: np.ndarray, roi: Sequence[int],
                      rng: np.random.Generator,
                      start: Optional[Sequence[int]] = None
                      ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Random crop of fixed size; returns (crop, start).  With ``start``
    given, the same crop (clamped to the volume)."""
    starts = []
    for ax in range(3):
        max_start = max(x.shape[ax] - roi[ax], 0)
        if start is not None:
            s = min(start[ax], max_start)
        else:
            s = int(rng.integers(0, max_start + 1)) if max_start > 0 else 0
        starts.append(s)
    crop = x[starts[0]: starts[0] + roi[0], starts[1]: starts[1] + roi[1],
             starts[2]: starts[2] + roi[2]]
    return crop, tuple(starts)


def transform_downstream_fit(item: Dict, conf,
                             rng: np.random.Generator) -> List[Dict]:
    """``num_samples_downstream`` random (image, mask) crops of one
    volume pair at ``seg_input_size``."""
    sample = {"image": scale_intensity_range(load_image(item["image"])),
              "mask": load_image(item["mask"])}
    if getattr(conf, "random_orientation", False):
        plane = [(0, 1), (0, 2), (1, 2)][int(rng.integers(0, 3))]
        for k in ("image", "mask"):
            sample[k] = rotate90(sample[k], 1, plane)
    if getattr(conf, "resize_content", False):
        sample["image"] = resize(sample["image"], conf.resize_spatial_size,
                                 "trilinear")
        sample["mask"] = resize(sample["mask"], conf.resize_spatial_size,
                                "nearest")
    out = []
    for _ in range(conf.num_samples_downstream):
        img_c, start = rand_spatial_crop(sample["image"],
                                         conf.seg_input_size, rng)
        msk_c, _ = rand_spatial_crop(sample["mask"], conf.seg_input_size,
                                     rng, start=start)
        out.append({"image": spatial_pad(img_c, conf.seg_input_size),
                    "mask": spatial_pad(msk_c, conf.seg_input_size),
                    "name": item["name"]})
    return out
