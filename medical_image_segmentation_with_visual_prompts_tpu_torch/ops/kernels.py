"""Build and load the port's CUDA kernels.

On first use every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one process per source and all at once, and the objects
are linked into one shared library with a plain C interface under
``build/kernels/`` at the repository root, named by a hash of the
sources, headers and flags, and loaded with ``ctypes``.  Every pointer
and the stream cross as ``c_void_p``; every C entry returns its
``cudaError_t``, and :func:`check` raises when it is not 0.

Nothing here runs at import time: the CPU test suite imports every
module of the port but never reaches ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils import trace

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# Dropout arguments: seed_a, seed_p, threshold_a, threshold_p, scale_a,
# scale_p (ops/fused_block.py::Dropout.kernel_args), then drop_cols and
# the counters' first window (Dropout.win_base).
_SEEDS = [_U] * 4 + [_F, _F]
_DROP = _SEEDS + [_I, _U]
# C signatures of the entries in csrc/ (restype: cudaError_t as int).
SIGNATURES = {
    # x, out, wqkv, ext_kv, pe_tab, pe_coord, labels, ln1_s, ln1_b, wproj,
    # bproj, ln2_s, ln2_b, wmlp, bmlp, info, bp, m, c, heads, dh, n_ext,
    # p_windows, ph, pw, pd, fold, scale, pe_scale, dropout, x is fp32,
    # stream
    "mivp_fused_swin_block": [_P] * 16 + [_I] * 11 + [_F, _F] + _DROP
    + [_I, _P],
    # x, out, src, tok, labels, ops0[12], ops1[12] (host pointer arrays),
    # info, bp, m, c, heads, dh, n_ext, p_windows, ph, pw, pd, fold,
    # scale, pe_scale, block 1's and block 2's seeds and rates, drop_cols,
    # win_base, x is fp32, stream
    "mivp_fused_swin_pair": [_P] * 8 + [_I] * 11 + [_F, _F] + _SEEDS * 2
    + [_I, _U, _I, _P],
    # x, dout, dx, operands (host pointer array, ops/fused_block_bwd.py::
    # _OPERANDS), labels, per-window and per-CTA partials, out, the
    # device-memory form's y and dqkv, info, big, bp, m, c, heads, dh,
    # n_ext, p_windows, ph, pw, pd, fold, ks, hs, qs, threads, scale,
    # pe_scale, dropout, x is fp32, stream
    "mivp_fused_block_bwd": [_P] * 11 + [_I] * 16 + [_F, _F] + _DROP
    + [_I, _P],
    # xa, xb, w, bias, scale, shift, out, b, h, w, d, ca, cb, co, affine,
    # leaky, out is fp32, rows per warp, bn, stream
    "mivp_conv3x3": [_P] * 7 + [_I] * 12 + [_P],
    # b, h, w, d, co, rows per warp, bn, out: int[7]
    "mivp_conv3x3_info": [_I] * 7 + [_P],
    # y, y_prompt, wqkv, prompt_kv, q, k, v, bias, pe_tab, pe_coord,
    # labels, out, info, bp, m, n, c, heads, p_windows, mode, ph, pw, pd,
    # tabw, scale, pe_scale, activations are fp32, stream
    "mivp_window_attention": [_P] * 13 + [_I] * 11 + [_F, _F, _I, _P],
    # x, out, b, h, w, d, c, resized h, w, d, out h, w, d, align_corners,
    # x is fp32, stream
    "mivp_upsample": [_P] * 2 + [_I] * 13 + [_P],
    # x, scale, shift, head weights, bias, out, b, h, w, d, c, resized h,
    # w, d, out h, w, d, align_corners, classes, out's classes, x is fp32,
    # the head is bf16, stream
    "mivp_upsample_head": [_P] * 6 + [_I] * 16 + [_P],
    # qkv, table_h, table_w, out, b, h, w, heads, form, stream
    "mivp_sam_attention": [_P] * 4 + [_I] * 5 + [_P],
    # b, h, w, heads, form, out: int[7]
    "mivp_sam_attention_info": [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libmivp_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every compiler process; raise with the failures' output."""
    errors = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{out}\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build() -> Path:
    """Compile the kernels unless a library for these sources exists
    (tracer unit ``kernels.build``; counter ``kernels.builds``: 0 or 1)."""
    with trace.unit("kernels.build"):
        lib = library_path()
        built = not lib.exists()
        if built:
            _compile(lib)
        trace.count("kernels.builds", int(built))
        return lib


def _compile(lib: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link
    into ``lib``."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    compiles, objs = [], []
    for src in _sources():
        obj = _BUILD / f"{tag}.{src.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    _run(compiles)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *(str(o) for o in objs)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))])
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mivp_error_string.argtypes = [_I]
            lib.mivp_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().mivp_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: cudaError {err} ({msg})")


INFO_KEYS = ("cluster", "ctas", "threads", "ctas_per_sm", "registers",
             "spill_bytes", "smem")


def info_array():
    """The int[7] a block, pair, block-backward or attention entry fills
    when asked only to size its launch (``csrc/fused_block_common.cuh::
    launch_clustered``)."""
    return (ctypes.c_int * len(INFO_KEYS))()


def info_dict(info) -> dict:
    return dict(zip(INFO_KEYS, (int(v) for v in info)))


def ptr(t) -> int:
    """Device pointer of a tensor (``None`` -> NULL)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
