"""ctypes bindings of the repository's native data-path library.

Counterpart of the JAX package's ``data/native.py``, with its four
entries, argument order and results: ``gunzip`` (a whole ``.gz``
buffer), ``decode_f32`` (a NIfTI payload to a C-order float32 volume with
``scl_slope``/``scl_inter``), ``scale_intensity`` (in-place intensity
windowing) and ``extract_windows`` (a sliding-window gather).

The library is built on first use from the repository's own
``native/miseg_native.cpp`` with ``g++`` and the flags of
``native/Makefile`` into ``build/native/``, named by a hash of the
source, the flags and what ``-march=native`` means on this host (such
code runs only on the CPUs it was built for), under a file lock and with a write-then-
rename, so that processes reaching it at once (pytest-xdist workers,
serving's IO worker processes) build it once.  The committed
``native/libmiseg_native.so`` is never loaded: it was built elsewhere
with ``-march=native``.  A failed build raises with the compiler's
output; nothing falls back to numpy.  Callers that want the numpy
version ask for it (``native=False`` in ``data/nifti.py`` and
``data/transforms.py``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "miseg_native.cpp"
_BUILD = _ROOT / "build" / "native"
# native/Makefile's CXXFLAGS and LDFLAGS.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lz")

# Bytes per voxel of the NIfTI datatypes miseg_decode_f32 decodes.
ITEMSIZE = {2: 1, 4: 2, 8: 4, 16: 4, 64: 8, 256: 1, 512: 2, 768: 4}

_LL = ctypes.c_longlong
_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _target_signature() -> str:
    """What ``-march=native`` resolves to on this host: the compiler's
    target options (empty if there is no compiler; the build then
    raises)."""
    try:
        return subprocess.run([_compiler(), "-march=native", "-Q",
                               "--help=target"], capture_output=True,
                              text=True).stdout
    except OSError:
        return ""


def library_path() -> Path:
    h = hashlib.sha256()
    for part in (SOURCE.read_bytes(), " ".join(CXXFLAGS + LDFLAGS).encode(),
                 _target_signature().encode()):
        h.update(part)
    return _BUILD / f"libmiseg_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this host's build exists; returns its
    path.  Raises ``RuntimeError`` with the compiler's output."""
    lib = library_path()
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():                 # built while we waited
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(), *CXXFLAGS, str(SOURCE), "-o", str(tmp),
               *LDFLAGS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}: "
                               f"{e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.miseg_gunzip.restype = _LL
            lib.miseg_gunzip.argtypes = [ctypes.c_void_p, _LL,
                                         ctypes.c_void_p, _LL]
            lib.miseg_decode_f32.restype = ctypes.c_int
            lib.miseg_decode_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_LL),
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            lib.miseg_scale_intensity.restype = None
            lib.miseg_scale_intensity.argtypes = [
                ctypes.c_void_p, _LL, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_int]
            lib.miseg_extract_windows.restype = None
            lib.miseg_extract_windows.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_LL), ctypes.POINTER(_LL),
                _LL, ctypes.POINTER(_LL), ctypes.c_void_p]
            _lib = lib
        return _lib


def _bytes_view(buf) -> np.ndarray:
    """A contiguous uint8 view of a bytes-like object or an ndarray (the
    caller keeps it alive across the library call)."""
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    return np.frombuffer(buf, dtype=np.uint8)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def gunzip(data: bytes, expected_size: Optional[int] = None) -> np.ndarray:
    """Inflate a gzip buffer into a uint8 ndarray (one allocation, sized
    by the gzip ISIZE trailer, exact below 4 GB; grown on its wrap)."""
    if len(data) < 18:
        raise ValueError(f"gunzip: {len(data)} bytes is no gzip stream")
    lib = library()
    src = _bytes_view(data)
    isize = int.from_bytes(src[-4:].tobytes(), "little")
    cap = expected_size or isize or max(src.size * 4, 1 << 20)
    for _ in range(4):
        out = np.empty(cap, dtype=np.uint8)
        n = lib.miseg_gunzip(_ptr(src), src.size, _ptr(out), cap)
        if n < 0:
            raise ValueError("gunzip: corrupt gzip stream")
        if n <= cap:
            return out[:n]
        cap *= 4
    raise ValueError("gunzip: output does not fit")


def decode_f32(payload, dtype_code: int, shape, slope: float,
               inter: float) -> np.ndarray:
    """NIfTI Fortran-order payload (bytes or uint8 ndarray) of datatype
    ``dtype_code`` -> C-order float32 ``[H, W, D]``, ``v * slope +
    inter`` (slope 0 taken as 1)."""
    h, w, d = (int(s) for s in shape)
    if dtype_code not in ITEMSIZE:
        raise ValueError(f"decode_f32: unsupported NIfTI datatype "
                         f"{dtype_code}")
    src = _bytes_view(payload)
    if src.size < h * w * d * ITEMSIZE[dtype_code]:
        raise ValueError(f"decode_f32: {src.size} payload bytes for a "
                         f"{h}x{w}x{d} volume of datatype {dtype_code}")
    out = np.empty((h, w, d), dtype=np.float32)
    library().miseg_decode_f32(_ptr(src), int(dtype_code), (_LL * 3)(h, w, d),
                               float(slope), float(inter), _ptr(out))
    return out


def scale_intensity(data: np.ndarray, a_min: float, a_max: float,
                    b_min: float, b_max: float, clip: bool) -> bool:
    """In-place windowing of a C-contiguous float32 array:
    ``(x - a_min) * ((b_max - b_min) / (a_max - a_min)) + b_min``,
    clipped to [b_min, b_max] if ``clip``.  Returns True, as the JAX
    binding does when its library ran."""
    if data.dtype != np.float32 or not data.flags["C_CONTIGUOUS"]:
        raise ValueError("scale_intensity: needs a C-contiguous float32 "
                         f"array, got {data.dtype}")
    library().miseg_scale_intensity(_ptr(data), data.size, a_min, a_max,
                                    b_min, b_max, int(clip))
    return True


def extract_windows(vol: np.ndarray, starts: np.ndarray,
                    window) -> np.ndarray:
    """``[H, W, D, C]`` + ``[N, 3]`` window origins ->
    ``[N, wh, ww, wd, C]`` float32."""
    vol = np.ascontiguousarray(vol, dtype=np.float32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    wh, ww, wd = (int(x) for x in window)
    n = starts.shape[0]
    hi = starts + np.array([wh, ww, wd])
    if n and (starts.min() < 0 or (hi > np.array(vol.shape[:3])).any()):
        raise ValueError("extract_windows: a window leaves the volume")
    out = np.empty((n, wh, ww, wd, vol.shape[3]), dtype=np.float32)
    library().miseg_extract_windows(
        _ptr(vol), (_LL * 4)(*[int(s) for s in vol.shape]),
        starts.ctypes.data_as(ctypes.POINTER(_LL)), n,
        (_LL * 3)(wh, ww, wd), _ptr(out))
    return out
