"""Host-side volume IO and the training transforms.

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
seed gives the JAX loader's crops; :func:`transform_downstream_test`
gives the test loader whole volumes.

The pretrain side (:func:`transform_pretrain_fit`, phase 2) adds the
centred coordinate grids, the students' views and the random intensity
chain (bias field, std shift, contrast, scale, histogram shift; coarse
dropout and coarse shuffle per student), with the same draws in the same
order as the JAX package's: each student's copy is taken before the
augmentations, and its crop to ``crop_size_students[i]`` last.  numpy
only.
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


def get_coord_grid(shape: Sequence[int]) -> np.ndarray:
    """Centred voxel coordinate grid ``[H, W, D, 3]`` (float32)."""
    h, w, d = shape[:3]
    grid = np.stack(np.meshgrid(np.arange(h), np.arange(w), np.arange(d),
                                indexing="ij"), axis=-1).astype(np.float32)
    grid -= np.array([(h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0],
                     dtype=np.float32)
    return grid


def rand_bias_field(x: np.ndarray, rng: np.random.Generator,
                    degree: int = 3, coeff_range=(0.0, 0.1)) -> np.ndarray:
    """Multiplicative smooth polynomial bias field (MONAI RandBiasFieldd)."""
    h, w, d = x.shape[:3]
    coords = [np.linspace(-1, 1, s, dtype=np.float32) for s in (h, w, d)]
    field = np.zeros((h, w, d), dtype=np.float32)
    for i in range(degree + 1):
        for j in range(degree + 1 - i):
            for k in range(degree + 1 - i - j):
                c = rng.uniform(*coeff_range)
                field += c * np.multiply.outer(
                    np.multiply.outer(coords[0] ** i, coords[1] ** j),
                    coords[2] ** k)
    return x * np.exp(field)[..., None]


def rand_std_shift(x: np.ndarray, rng: np.random.Generator,
                   factors=(0.0, 0.1)) -> np.ndarray:
    factor = rng.uniform(factors[0], factors[1])
    return x + factor * float(np.std(x))


def rand_adjust_contrast(x: np.ndarray, rng: np.random.Generator,
                         gamma=(0.5, 4.5)) -> np.ndarray:
    g = rng.uniform(gamma[0], gamma[1])
    mn, mx = float(x.min()), float(x.max())
    span = mx - mn + 1e-7
    return ((x - mn) / span) ** g * span + mn


def rand_scale_intensity(x: np.ndarray, rng: np.random.Generator,
                         factors: float = -2.0) -> np.ndarray:
    lo, hi = (factors, abs(factors)) if np.isscalar(factors) else factors
    f = rng.uniform(min(lo, hi), max(lo, hi))
    return x * (1.0 + f)


def rand_histogram_shift(x: np.ndarray, rng: np.random.Generator,
                         num_control_points=(8, 12)) -> np.ndarray:
    n = int(rng.integers(num_control_points[0], num_control_points[1] + 1))
    mn, mx = float(x.min()), float(x.max())
    if mx - mn < 1e-7:
        return x
    ref = np.linspace(mn, mx, n)
    target = np.sort(rng.uniform(mn, mx, n))
    target[0], target[-1] = mn, mx
    return np.interp(x, ref, target).astype(np.float32)


def _holes(x: np.ndarray, rng: np.random.Generator, holes: int,
           spatial_size: int, max_holes: Optional[int],
           max_spatial_size: Optional[int]):
    """The random boxes of MONAI's coarse transforms, as slices."""
    n = holes if max_holes is None else int(rng.integers(holes, max_holes + 1))
    for _ in range(n):
        size = [spatial_size if max_spatial_size is None
                else int(rng.integers(spatial_size, max_spatial_size + 1))
                for _ in range(3)]
        start = [int(rng.integers(0, max(x.shape[ax] - size[ax], 0) + 1))
                 for ax in range(3)]
        yield tuple(slice(start[ax], start[ax] + size[ax]) for ax in range(3))


def rand_coarse_dropout(x: np.ndarray, rng: np.random.Generator,
                        holes: int, spatial_size: int,
                        max_holes: Optional[int] = None,
                        max_spatial_size: Optional[int] = None,
                        dropout_holes: bool = True,
                        fill: float = 0.0) -> np.ndarray:
    """MONAI RandCoarseDropoutd: ``fill`` inside the holes
    (``dropout_holes``), or only the holes kept and ``fill`` elsewhere."""
    out = x.copy() if dropout_holes else np.full_like(x, fill)
    for sl in _holes(x, rng, holes, spatial_size, max_holes,
                     max_spatial_size):
        out[sl] = fill if dropout_holes else x[sl]
    return out


def rand_coarse_shuffle(x: np.ndarray, rng: np.random.Generator,
                        holes: int, spatial_size: int,
                        max_holes: Optional[int] = None,
                        max_spatial_size: Optional[int] = None) -> np.ndarray:
    """MONAI RandCoarseShuffled: the voxels of each hole permuted."""
    out = x.copy()
    for sl in _holes(x, rng, holes, spatial_size, max_holes,
                     max_spatial_size):
        block = out[sl]
        flat = block.reshape(-1, block.shape[-1])
        out[sl] = flat[rng.permutation(flat.shape[0])].reshape(block.shape)
    return out


def _basic_intensity_augs(x: np.ndarray, rng: np.random.Generator,
                          prob: float, std_shift_factors) -> np.ndarray:
    """The shared random-intensity chain, each step with ``prob``."""
    if rng.uniform() < prob:
        x = rand_bias_field(x, rng)
    if rng.uniform() < prob:
        x = rand_std_shift(x, rng, std_shift_factors)
    if rng.uniform() < prob:
        x = rand_adjust_contrast(x, rng)
    if rng.uniform() < prob:
        x = rand_scale_intensity(x, rng, -2.0)
    if rng.uniform() < prob:
        x = rand_histogram_shift(x, rng)
    return x


def _random_orientation(sample: Dict[str, np.ndarray], keys,
                        rng: np.random.Generator) -> None:
    """One of three 90-degree rotations, uniformly, of every key."""
    plane = [(0, 1), (0, 2), (1, 2)][int(rng.integers(0, 3))]
    for k in keys:
        sample[k] = rotate90(sample[k], 1, plane)


def transform_downstream_fit(item: Dict, conf,
                             rng: np.random.Generator) -> List[Dict]:
    """``num_samples_downstream`` random (image, mask) crops of one
    volume pair at ``seg_input_size``."""
    sample = {"image": scale_intensity_range(load_image(item["image"])),
              "mask": load_image(item["mask"])}
    if getattr(conf, "random_orientation", False):
        _random_orientation(sample, ("image", "mask"), rng)
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


def transform_downstream_test(item: Dict, conf) -> Dict:
    """The whole RAS volume pair, intensities windowed, no crop."""
    return {"image": scale_intensity_range(load_image(item["image"])),
            "mask": load_image(item["mask"]), "name": item["name"]}


_PHASE2 = ("self_supervised_learning_decoder", "self_supervised_learning_all",
           "supervised_learning_decoder", "supervised_learning_all")


def _student_view(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A student's image augmentations: one of {identity, coarse dropout
    inside holes, only holes kept, coarse shuffle} with weights (0.7, 0.1,
    0.1, 0.1), then the intensity chain at 0.1."""
    choice = rng.choice(4, p=(0.7, 0.1, 0.1, 0.1))
    if choice == 1:
        x = rand_coarse_dropout(x, rng, holes=1, spatial_size=4, max_holes=3,
                                max_spatial_size=16, dropout_holes=True)
    elif choice == 2:
        x = rand_coarse_dropout(x, rng, holes=5, spatial_size=32,
                                max_spatial_size=48, dropout_holes=False)
    elif choice == 3:
        x = rand_coarse_shuffle(x, rng, holes=1, spatial_size=4, max_holes=3,
                                max_spatial_size=16)
    return _basic_intensity_augs(x, rng, prob=0.1,
                                 std_shift_factors=(0.0, 0.2))


def transform_pretrain_fit(item: Dict, conf,
                           rng: np.random.Generator) -> List[Dict]:
    """Phase-2 samples of one volume: ``num_samples_students_teacher``
    teacher crops at ``roi_size`` (``image``, ``coord`` with the prototype
    loss, ``mask`` in the supervised modes), and per student ``i`` the
    same keys ``<key>_st_<i>`` cut from the teacher crop at
    ``crop_size_students[i]``."""
    from .datasets import num_samples_of
    mode = conf.training_mode
    load_mask = mode in ("supervised_learning_decoder",
                         "supervised_learning_all")
    students_view = mode in _PHASE2 and conf.use_prototype_assignment
    sample = {"image": scale_intensity_range(load_image(item["image"]))}
    if load_mask:
        sample["mask"] = load_image(item["mask"])
    if getattr(conf, "resize_content", False):
        sample["image"] = resize(sample["image"], conf.resize_spatial_size,
                                 "trilinear")
        if load_mask:
            sample["mask"] = resize(sample["mask"], conf.resize_spatial_size,
                                    "nearest")
    if students_view:
        sample["coord"] = get_coord_grid(sample["image"].shape)
    keys = [k for k in ("image", "mask", "coord") if k in sample]
    if getattr(conf, "random_orientation", False):
        _random_orientation(sample, keys, rng)
    random_transforms = getattr(conf, "random_transforms", False)
    num_students = len(conf.crop_size_students) if students_view else 0
    out = []
    for _ in range(num_samples_of(conf)):
        img_c, start = rand_spatial_crop(sample["image"], conf.roi_size, rng)
        crops = {"image": spatial_pad(img_c, conf.roi_size)}
        for k in keys[1:]:
            c, _ = rand_spatial_crop(sample[k], conf.roi_size, rng,
                                     start=start)
            crops[k] = spatial_pad(c, conf.roi_size)
        # Each student's copy of the teacher crop, before the augmentations.
        students = {f"{k}_st_{i}": crops[k].copy()
                    for i in range(num_students) for k in keys}
        if random_transforms:
            crops["image"] = _basic_intensity_augs(
                crops["image"], rng, prob=0.05, std_shift_factors=(0.0, 0.1))
            for i in range(num_students):
                students[f"image_st_{i}"] = _student_view(
                    students[f"image_st_{i}"], rng)
        # Each student's crop last; its first key picks the start.
        for i in range(num_students):
            size = conf.crop_size_students[i]
            st_start = None
            for k in keys:
                key = f"{k}_st_{i}"
                c, st_start = rand_spatial_crop(students[key], size, rng,
                                                start=st_start)
                students[key] = spatial_pad(c, size)
        out.append({**crops, **students, "name": item["name"]})
    return out
