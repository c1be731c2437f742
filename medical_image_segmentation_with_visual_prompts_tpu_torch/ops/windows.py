"""Dilated window partition and the shifted-window label tables.

Counterpart of the JAX package's ``ops/windows.py`` (and
``models/swin_block.py::content_indices`` / ``fold_geometry``).  The
reference factors each padded axis as ``(h p1)`` with ``h`` the window
size as the SLOW factor, so a "window" holds the voxels at stride
``dim / window`` (a dilated grid, not a contiguous Swin block); masks,
windows and checkpoints all depend on it.  The tables are numpy
constants of the static geometry, cached per geometry.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def window_partition(x: torch.Tensor, window_size: Sequence[int]
                     ) -> torch.Tensor:
    """``[B, H, W, D, C] -> [B, P, N, C]`` with dilated windows."""
    b, h, w, d, c = x.shape
    wh, ww, wd = window_size
    p1, p2, p3 = h // wh, w // ww, d // wd
    x = x.reshape(b, wh, p1, ww, p2, wd, p3, c)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, p1 * p2 * p3, wh * ww * wd, c)


def window_reverse(x: torch.Tensor, window_size: Sequence[int],
                   shape_x: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`window_partition`: ``[B, P, N, C] -> [B, H, W, D, C]``."""
    b, c = x.shape[0], x.shape[-1]
    wh, ww, wd = window_size
    hp, wp, dp = shape_x
    p1, p2, p3 = hp // wh, wp // ww, dp // wd
    x = x.reshape(b, p1, p2, p3, wh, ww, wd, c)
    x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, hp, wp, dp, c)


def _window_partition_np(m: np.ndarray, window_size) -> np.ndarray:
    h, w, d = m.shape
    wh, ww, wd = window_size
    p1, p2, p3 = h // wh, w // ww, d // wd
    m = m.reshape(wh, p1, ww, p2, wd, p3).transpose(1, 3, 5, 0, 2, 4)
    return m.reshape(p1 * p2 * p3, wh * ww * wd)


def _gather_np(grid, window_size, shift) -> np.ndarray:
    """Voxel of each (window, token) slot of the shifted partition."""
    src = np.roll(np.arange(int(np.prod(grid))).reshape(grid),
                  tuple(-s for s in shift), axis=(0, 1, 2))
    return _window_partition_np(src, window_size).reshape(-1)


def _device_tensors(*arrays, device):
    # Outside inference mode, so that autograd may save them later.
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device) for a in arrays)


@lru_cache(maxsize=None)
def gather_indices(grid: Tuple[int, int, int],
                   window_size: Tuple[int, int, int],
                   shift: Tuple[int, int, int], device: torch.device):
    """``(idx, inv)`` int64 permutations of the ``H*W*D`` voxels of
    ``grid``: ``x.index_select(1, idx)`` of a ``[B, H*W*D, C]`` tensor is
    ``window_partition(torch.roll(x, -shift))`` flattened to
    ``[B, P*N, C]``, and ``index_select(1, inv)`` undoes it (one gather
    each way instead of a roll and a permute copy)."""
    idx = _gather_np(grid, window_size, shift)
    return _device_tensors(idx, np.argsort(idx), device=device)


class PairPlan(NamedTuple):
    """Where block 2 of a (no-shift, shift) pair finds its rows in block
    1's unshifted windows (one image; every image of a batch alike).

    ``src [P]`` int32: the one source window of each shifted window;
    ``tok [P, M]`` int32: the source token that lands at each token;
    ``index``/``inverse`` ``[P*M]`` int64: the same map as flat rows
    (``src * M + tok``) and its inverse, for ``index_select``."""

    src: torch.Tensor
    tok: torch.Tensor
    index: torch.Tensor
    inverse: torch.Tensor


@lru_cache(maxsize=None)
def pair_plan(grid: Tuple[int, int, int], window_size: Tuple[int, int, int],
              shift: Tuple[int, int, int], device: torch.device
              ) -> Optional[PairPlan]:
    """The shift between the blocks of a pair as a window map plus an
    in-window token map: :func:`gather_indices` of ``shift`` composed
    with the inverse of :func:`gather_indices` of no shift.  In the
    dilated partition (voxel ``t*p + w`` of an axis is token ``t`` of
    window ``w``) a roll by ``s = q*p + r`` sends window ``w`` to ``(w +
    r) mod p`` and rolls its tokens, so each shifted window draws from one
    source window; None when one does not, and for a depth shift, which
    the JAX package's pair kernel does not take either
    (``windows.py::kernel_shift_plan``), so that the pair runs on exactly
    the geometries where the JAX package's does."""
    if shift[2]:
        return None
    m = int(np.prod(window_size))
    slot = np.empty(int(np.prod(grid)), np.int64)
    slot[_gather_np(grid, window_size, (0, 0, 0))] = np.arange(slot.size)
    flat = slot[_gather_np(grid, window_size, shift)].reshape(-1, m)
    src = flat[:, 0] // m
    if (flat // m != src[:, None]).any():
        return None
    return PairPlan(*_device_tensors(
        src.astype(np.int32), (flat % m).astype(np.int32), flat.reshape(-1),
        np.argsort(flat.reshape(-1)), device=device))


@lru_cache(maxsize=None)
def get_attn_labels(shape_x: Tuple[int, int, int],
                    window_size: Tuple[int, int, int],
                    shift_size: Tuple[int, int, int],
                    paddings: Tuple[int, ...]) -> np.ndarray:
    """Per-window shift-region labels ``[P, N]`` int32.

    Equal labels may attend.  The reference labels 27 shift regions with
    its literal slices (shift 0 gives ``slice(-ws, -0)`` = empty and
    ``slice(-0, None)`` = the whole axis) and, when padded, relabels the
    non-padded interior 100 so pads only see pads.
    """
    image_mask = np.zeros(shape_x, dtype=np.float32)
    slices = [(slice(0, -ws), slice(-ws, -ss), slice(-ss, None))
              for ws, ss in zip(window_size, shift_size)]
    cnt = 0
    for hs in slices[0]:
        for ws_ in slices[1]:
            for ds in slices[2]:
                image_mask[hs, ws_, ds] = cnt
                cnt += 1
    if any(p > 0 for p in paddings):
        image_mask[paddings[0]: shape_x[0] - paddings[1],
                   paddings[2]: shape_x[1] - paddings[3],
                   paddings[4]: shape_x[2] - paddings[5]] = 100
    return _window_partition_np(image_mask, window_size).astype(np.int32)


@lru_cache(maxsize=None)
def get_attn_mask(shape_x: Tuple[int, int, int],
                  window_size: Tuple[int, int, int],
                  shift_size: Tuple[int, int, int],
                  paddings: Tuple[int, ...]) -> np.ndarray:
    """Multiplicative 0/1 mask ``[P, N, N]`` float32: 1 where the
    :func:`get_attn_labels` region labels are equal (may attend).  The
    kernels take the labels; this is the plain side's form of them."""
    labels = get_attn_labels(shape_x, window_size, shift_size, paddings)
    return (labels[:, :, None] == labels[:, None, :]).astype(np.float32)


def compute_paddings(shape_x: Sequence[int], window_size: Sequence[int],
                     mode: str = "reference") -> Tuple[int, ...]:
    """Applied (lo, hi) padding per axis up to window multiples.

    ``reference``: when any axis is misaligned every axis is padded by
    ``ws - dim % ws`` split (ceil, floor) -- the reference computes
    (floor, ceil) but ``F.pad`` of the reversed tuple swaps them.
    ``aligned``: only misaligned axes are padded, split (floor, ceil).
    """
    if mode == "reference" and not any(
            s % ws for s, ws in zip(shape_x, window_size)):
        return (0,) * 6
    pads = []
    for s, ws in zip(shape_x, window_size):
        rem = s % ws
        if mode != "reference" and rem == 0:
            pads.extend([0, 0])
        elif mode == "reference":
            total = ws - rem
            pads.extend([math.ceil(total / 2), math.floor(total / 2)])
        else:
            total = (ws - rem) % ws
            pads.extend([math.floor(total / 2), math.ceil(total / 2)])
    return tuple(pads)


def unpad_paddings(paddings: Sequence[int], mode: str) -> Tuple[int, ...]:
    """(lo, hi) the reference uses for its un-pad crop and the interior
    relabel: the un-swapped (floor, ceil) under ``reference`` (odd totals
    shift each block output by one voxel), the applied values otherwise."""
    if mode != "reference":
        return tuple(paddings)
    return (paddings[1], paddings[0], paddings[3], paddings[2],
            paddings[5], paddings[4])


def content_indices(dims, window_size, paddings, fold_axes) -> np.ndarray:
    """Flat full-window indices of the content tokens under pad folding."""
    keep = []
    for i in range(3):
        if i in fold_axes:
            lo = paddings[2 * i]
            keep.append(np.arange(lo, lo + dims[i]))
        else:
            keep.append(np.arange(window_size[i]))
    grid = np.zeros(tuple(window_size), dtype=bool)
    grid[np.ix_(keep[0], keep[1], keep[2])] = True
    return np.where(grid.reshape(-1))[0]


def fold_geometry(dims, window_size, fold_axes, paddings):
    """(content window ``wc``, effective paddings) under pad folding:
    folded axes use the feature extent as window and are never padded."""
    wc = tuple(dims[i] if i in fold_axes else window_size[i]
               for i in range(3))
    pads_eff = tuple(0 if (i // 2) in fold_axes else paddings[i]
                     for i in range(6))
    return wc, pads_eff
