"""PNG dumps of the trainers' ``view`` outputs.

Counterpart of the JAX package's ``utils/visualization.py``, function for
function (``view_reconstruction``, ``view_prototype``,
``view_prototype_students_teacher``, ``view_segmentation``): per-slice
grey panels resized to 128x128, concatenated horizontally per row and
vertically across rows, clipped to [0, 255] and written as 8-bit grey
PNGs to ``<root>/{rec,prt,seg_new}/`` under the same file names.  The
root is ``MIVP_VIEW_DIR`` (read at each call), else ``~/image_outputs``.
Batch element 0 is drawn, as the JAX module draws it.

The JAX module resizes with PIL (``F`` mode); this one computes the same
two resizes in numpy (:func:`resize`): bicubic (a = -0.5, support widened
by the downscale factor, per-pixel normalised coefficients, a horizontal
pass then a vertical one, each summed in float64 and stored as float32)
and nearest neighbour (source pixel ``floor((i + 0.5) * in / out)``).
It writes the PNGs with its own encoder (:func:`write_png`: ``zlib``,
``struct`` and CRC-32 from the standard library), so it needs no PIL and
always writes its files.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

PANEL = 128            # side of each resized slice
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def out_root() -> Path:
    """Where the panels go: ``MIVP_VIEW_DIR``, else ``~/image_outputs``."""
    return Path(os.environ.get("MIVP_VIEW_DIR", "~/image_outputs"))


# ----------------------------------------------------------------- resize
def _bicubic(x: np.ndarray) -> np.ndarray:
    """The cubic convolution kernel with a = -0.5 (support 2)."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Per output pixel: the first source index and the normalised
    weights of its taps (``[out, taps]``, zero past the pixel's last
    tap)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.float64)
    inv = 1.0 / filterscale
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        w = _bicubic((np.arange(lo, hi) - center + 0.5) * inv)
        total = w.sum()
        if total != 0.0:
            w = w / total
        first[i] = lo
        weights[i, :hi - lo] = w
    return first, weights


def _cubic_pass(img: np.ndarray, out_size: int) -> np.ndarray:
    """Resample the last axis of float32 ``img`` to ``out_size``: each
    output a float64 sum over its taps in order, stored as float32."""
    in_size = img.shape[-1]
    first, weights = _coeffs(in_size, out_size)
    src = img.astype(np.float64)
    acc = np.zeros(img.shape[:-1] + (out_size,), np.float64)
    for t in range(weights.shape[1]):
        idx = np.minimum(first + t, in_size - 1)
        acc += src[..., idx] * weights[:, t]
    return acc.astype(np.float32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel: the running position ``(i +
    0.5) * in / out``, accumulated in float64, truncated."""
    step = float(np.float32(in_size)) / out_size
    pos = step * 0.5
    idx = np.empty(out_size, np.int64)
    for i in range(out_size):
        idx[i] = min(int(pos), in_size - 1)
        pos += step
    return idx


def resize(arr: np.ndarray, nearest: bool, size: int = PANEL) -> np.ndarray:
    """``[H, W]`` -> float32 ``[size, size]``: nearest neighbour or
    bicubic, as PIL resizes an ``F`` image."""
    img = np.asarray(arr, np.float32)
    h, w = img.shape
    if (h, w) == (size, size):
        return img.copy()
    if nearest:
        return img[_nearest_index(h, size)][:, _nearest_index(w, size)]
    if w != size:
        img = _cubic_pass(img, size)
    if h != size:
        img = _cubic_pass(img.T, size).T
    return np.ascontiguousarray(img)


# -------------------------------------------------------------------- PNG
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> Path:
    """Write uint8 ``[H, W]`` as an 8-bit grey PNG (no filtering)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], 1)
    data = (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    path = Path(path)
    path.write_bytes(data)
    return path


# ------------------------------------------------------------------ views
def _first(x) -> np.ndarray:
    """Batch element 0 of an array or tensor, as numpy (floating tensors
    as float32)."""
    if hasattr(x, "detach"):
        t = x[0].detach()
        if t.is_floating_point():
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(x)[0]


def _save(panel: np.ndarray, subdir: str, fname: str) -> Path:
    save_dir = (out_root() / subdir).expanduser()
    save_dir.mkdir(exist_ok=True, parents=True)
    return write_png(save_dir / fname,
                     np.clip(panel, 0, 255).astype(np.uint8))


def _slices(vol: np.ndarray, n_slices: int, scale: float,
            nearest: bool) -> np.ndarray:
    """``[H, W, D]`` volume -> horizontal strip of ``n_slices`` panels."""
    st = max(vol.shape[2] // n_slices, 1)
    return np.concatenate(
        [resize((vol[:, :, i * st] * scale).astype(np.float32), nearest)
         for i in range(n_slices)], axis=1)


def view_reconstruction(name, n_slices, epoch, step, ori_img=None,
                        rec_img=None) -> Path:
    """ori/rec: ``[B, H, W, D, C]`` channels-last (the input views and
    their reconstructions); rows: channel 0 of each, element 0."""
    ori = _first(ori_img)[..., 0]
    rec = _first(rec_img)[..., 0]
    panel = np.concatenate([_slices(ori, n_slices, 255.0, False),
                            _slices(rec, n_slices, 255.0, False)], axis=0)
    return _save(panel, "rec", f"epoch{epoch}_step{step}_{name[0]}_rec.png")


def view_prototype(name, n_slices, epoch, step, c, prt1=None,
                   prt2=None) -> Path:
    """prt: ``[B, H, W, D, C]``; rows: channel 0 of each, nearest, scaled
    by ``255 // c``."""
    scale = 255 // c
    rows = [_slices(_first(p)[..., 0], n_slices, scale, True)
            for p in (prt1, prt2)]
    return _save(np.concatenate(rows, axis=0), "prt",
                 f"epoch{epoch}_step{step}_{name}_prt.png")


def view_prototype_students_teacher(name, n_slices, epoch, step, chs,
                                    prt_tch=None, img_tch=None,
                                    prt_sts=None, img_sts=None) -> Path:
    """Teacher, then each student: the image's channel 0 (bicubic, x255)
    over the argmax of its latent map (nearest, x ``255 // chs``)."""

    def block(img, prt):
        lab = np.argmax(_first(prt), axis=-1)
        return np.concatenate(
            [_slices(_first(img)[..., 0], n_slices, 255.0, False),
             _slices(lab.astype(np.float32), n_slices, 255 // chs, True)],
            axis=0)

    rows = [block(img_tch, prt_tch)]
    for img, prt in zip(img_sts or [], prt_sts or []):
        rows.append(block(img, prt))
    return _save(np.concatenate(rows, axis=0), "prt",
                 f"epoch{epoch}_step{step}_{name[0]}_prt.png")


def view_segmentation(name, n_slices, epoch, step, seg_pred=None,
                      seg_target=None, img=None, n_classes=None) -> Path:
    """Channels-last logits and labels, element 0: the argmax, the
    target and (if given) the image's channel 0, nearest, scaled by
    ``255 // n_classes``."""
    scale = 255 // n_classes
    pred = np.argmax(_first(seg_pred), axis=-1).astype(np.float32)
    tgt = _first(seg_target)[..., 0].astype(np.float32)
    rows = [_slices(pred, n_slices, scale, True),
            _slices(tgt, n_slices, scale, True)]
    if img is not None:
        rows.append(_slices(_first(img)[..., 0], n_slices, scale, True))
    nm = name if isinstance(name, str) else name[0]
    return _save(np.concatenate(rows, axis=0), "seg_new",
                 f"epoch{epoch}_step{step}_{nm}_seg.png")
