"""Where the port's entry points run: the CUDA card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    A CUDA device without a usable card raises: the port never moves to
    the CPU on its own.  Pass ``device="cpu"`` to run there (the plain
    versions of the kernels).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default -- pass device='cpu' (or --device cpu) to run on the "
            "CPU")
    return dev
