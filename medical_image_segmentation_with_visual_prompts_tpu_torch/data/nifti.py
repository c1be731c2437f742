"""NIfTI-1 reader and writer (.nii / .nii.gz).

Counterpart of the JAX package's ``data/nifti.py`` (same header subset,
affines, scaling and output layout).  Scalar 3D/4D volumes, sform/qform
affines and scl_slope/scl_inter scaling, which is what CT and MR
segmentation datasets use.  :func:`load_nifti` takes the native library
(``data/native.py``) where the JAX reader does: its gunzip for
``.nii.gz``, and its one-pass decode for 3D little-endian float32
payloads; ``native=False`` is the plain version, gzip and numpy only.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_HEADER = 348
_VOX_OFFSET = 352
# gzip level of written volumes.  Serving writes one label volume per
# request, on the writer thread; on label maps zlib's level 9 (gzip's
# default) spends several times as long as level 1 searching its match
# chains, and up to seconds on noisy ones, to save a few tens of kB.
_GZIP_LEVEL = 1


def _header(raw: bytes) -> dict:
    if len(raw) < _HEADER:
        raise ValueError("Not a NIfTI-1 file: header too short")
    for endian in "<>":
        if struct.unpack_from(endian + "i", raw, 0)[0] == _HEADER:
            break
    else:
        raise ValueError("Not a NIfTI-1 file: bad sizeof_hdr")

    def read(fmt, offset):
        return struct.unpack_from(endian + fmt, raw, offset)

    quat = read("6f", 256)
    return {
        "endian": endian, "dim": read("8h", 40), "datatype": read("h", 70)[0],
        "pixdim": read("8f", 76), "vox_offset": read("f", 108)[0],
        "scl": read("2f", 112), "qform_code": read("h", 252)[0],
        "sform_code": read("h", 254)[0], "quat": quat[:3],
        "qoffset": quat[3:], "srows": (read("4f", 280), read("4f", 296),
                                       read("4f", 312)),
        "magic": bytes(raw[344:348]),
    }


def _qform(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quat"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    rot = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    pix = hdr["pixdim"]
    qfac = -1.0 if pix[0] < 0 else 1.0
    affine = np.eye(4)
    affine[:3, :3] = rot * np.array([pix[1], pix[2], qfac * pix[3]])
    affine[:3, 3] = hdr["qoffset"]
    return affine


def _affine(hdr: dict) -> np.ndarray:
    if hdr["sform_code"] > 0:
        affine = np.eye(4)
        affine[:3] = hdr["srows"]
        return affine
    if hdr["qform_code"] > 0:
        return _qform(hdr)
    pix = hdr["pixdim"]
    return np.diag([pix[1] or 1.0, pix[2] or 1.0, pix[3] or 1.0, 1.0])


def load_nifti(path, native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Read a volume: ``(data, affine)``, data C-contiguous with the
    header's spatial shape (trailing singleton axes squeezed), affine the
    4x4 voxel-to-world transform.  Integer payloads keep their dtype
    unless the header scales them.  ``native``: the native library's
    gunzip and float32 decode (module docstring), else numpy's."""
    from . import native as lib
    path = Path(path)
    raw = path.read_bytes()
    if path.name.endswith(".gz"):
        raw = lib.gunzip(raw) if native else gzip.decompress(raw)
    hdr = _header(raw)
    shape = tuple(int(s) for s in hdr["dim"][1:1 + hdr["dim"][0]])
    if hdr["datatype"] not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype {hdr['datatype']}")
    dtype = np.dtype(_DTYPES[hdr["datatype"]]).newbyteorder(hdr["endian"])
    offset = int(hdr["vox_offset"]) if hdr["magic"].startswith(b"n+1") \
        else 0
    offset = offset or _VOX_OFFSET
    count = int(np.prod(shape))
    slope, inter = hdr["scl"]
    if native and len(shape) == 3 and hdr["endian"] == "<" \
            and hdr["datatype"] == 16:
        payload = raw[offset: offset + count * dtype.itemsize]
        return lib.decode_f32(payload, 16, shape, slope or 1.0,
                              inter), _affine(hdr)
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=offset).reshape(shape, order="F")
    if slope not in (0.0, 1.0) or inter != 0.0:
        data = data.astype(np.float32) * (slope or 1.0) + inter
    while data.ndim > 3 and data.shape[-1] == 1:
        data = data[..., 0]
    return np.ascontiguousarray(data), _affine(hdr)


def save_nifti(path, data: np.ndarray,
               affine: Optional[np.ndarray] = None) -> Path:
    """Write a single-file NIfTI-1 (gzip-compressed when the name ends
    in ``.gz``); dtypes NIfTI lacks are stored as float32."""
    path = Path(path)
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    affine = np.eye(4) if affine is None else affine
    hdr = bytearray(_HEADER)
    struct.pack_into("<i", hdr, 0, _HEADER)
    struct.pack_into("<8h", hdr, 40, data.ndim, *data.shape,
                     *[1] * (7 - data.ndim))
    struct.pack_into("<2h", hdr, 70, _CODES[data.dtype],
                     data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, 1.0, 1.0, 1.0, 1.0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, float(_VOX_OFFSET))
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)
    struct.pack_into("<2h", hdr, 252, 0, 1)        # qform 0, sform 1
    for i in range(3):
        struct.pack_into("<4f", hdr, 280 + 16 * i, *affine[i])
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * (_VOX_OFFSET - _HEADER) + \
        data.tobytes(order="F")
    if path.name.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=_GZIP_LEVEL) as f:
            f.write(payload)
    else:
        path.write_bytes(payload)
    return path
