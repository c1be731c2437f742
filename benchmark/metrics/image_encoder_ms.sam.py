"""MedSAM's image encoder time per served study (ms): CUDA events at the
encoder's forward entry and exit, summed over the study's slice batches,
averaged over the studies of the traced run's unprofiled pass (at the
cell's load)."""

import numpy as np


def read(ctx):
    vals = ctx.get("image_encoder_ms")
    return float(np.mean(vals)) if vals else None
