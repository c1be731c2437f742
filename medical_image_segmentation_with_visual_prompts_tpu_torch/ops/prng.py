"""Counter-based dropout bits, shared by the CUDA kernels and PyTorch.

Counterpart of the JAX package's ``ops/prng.py``.  A dropout mask is a
pure function of (seed, element index): the murmur3 finalizer over the
uint32 counter ``idx * 0x9E3779B9 + seed``.  The forward kernel, the
backward kernel and the plain versions regenerate the same masks with no
mask tensor in device memory, bit for bit the masks of the JAX package.

PyTorch has no uint32 arithmetic, so the hash runs in int64 and keeps
the low 32 bits after every multiply and add (``& 0xFFFFFFFF``).  A
product of two 32-bit values can overflow int64, so each multiply splits
the constant into 16-bit halves (:func:`_mul32`).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PHI = 0x9E3779B9
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit ``c``:
    ``x * c_lo + ((x * c_hi) << 16)`` keeps every product below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash_u32(seed, idx: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over (seed, idx): uint32 values in int64."""
    x = idx.to(torch.int64) & _MASK32
    x = (_mul32(x, _PHI) + (int(seed) & _MASK32)) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """Drop when the hash's low 24 bits fall below this."""
    return int(round(rate * float(1 << 24)))


def keep_scale(rate: float) -> float:
    """Inverted-dropout scale ``1 / float32(1 - rate)``, rounded to fp32."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def keep_mask(seed, idx: torch.Tensor, rate: float,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverted-dropout keep mask: ``1/(1-rate)`` where kept, else 0.

    ``idx`` holds globally unique element counters (taken mod 2^32).
    """
    bits = hash_u32(seed, idx) & 0xFFFFFF
    keep = bits >= keep_threshold(rate)
    return keep.to(dtype) * torch.tensor(keep_scale(rate), dtype=dtype)
