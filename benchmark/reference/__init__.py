"""Plain PyTorch reference of the measured program, for the check of
``correct``.

A frozen, self-contained copy of the arithmetic of the promptable
Swin-UNETR (downstream and phase-1 modes), its losses, its counter-based
dropout hash, its view operations, AdamW and the Gaussian sliding-window
stitch, written in plain ``torch`` operations in float32.  It imports
nothing of the program and nothing of JAX.  It takes the benchmark's
inputs (weights, volumes, crops, draws, dropout seeds) and works out
again everything the program derives from them: bias tables, pad-fold
columns, shift labels, window grids, Gaussian weights.

:class:`model.Arith` selects the precision of every product: ``fp32``
(the reference) or ``fp8`` (the control: each operand of every matmul
and convolution rounded to float8 e4m3 with a per-tensor scale).
"""
