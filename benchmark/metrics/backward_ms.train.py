"""Device time from the end of a step's last forward to the optimizer's
step (ms): the losses, autograd through the blocks (B4) and the rest of
the backward. CUDA events at the model's forward exit and at the
optimizer's step-pre hook, averaged over the steps of the traced run's
unprofiled pass."""

import numpy as np


def read(ctx):
    vals = [v for v in ctx.get("backward_ms") or [] if v is not None]
    return float(np.mean(vals)) if vals else None
