"""Model forward time per training step (ms): CUDA events at the model's
forward entry and exit, summed over the step's forwards, averaged over
the steps of the traced run's unprofiled pass."""

import numpy as np


def read(ctx):
    vals = ctx.get("forward_ms")
    return float(np.mean(vals)) if vals else None
