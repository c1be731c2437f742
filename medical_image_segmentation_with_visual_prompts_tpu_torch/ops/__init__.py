"""Tensor ops of the port: window geometry, resizing, and the CUDA
kernels with their plain PyTorch versions (fused Swin block and its
backward, window attention, the decoder convs).  Kernels build on first
use (``ops/kernels.py``)."""
