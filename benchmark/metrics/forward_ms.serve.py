"""Model forward time per served volume (ms): CUDA events at the model's
forward entry and exit, summed over the volume's forwards, averaged over
the volumes of the traced run's unprofiled pass (at the cell's
load; under concurrent clients a forward shares the card)."""

import numpy as np


def read(ctx):
    vals = ctx.get("forward_ms")
    return float(np.mean(vals)) if vals else None
