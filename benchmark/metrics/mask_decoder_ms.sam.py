"""MedSAM's prompt encoder and mask decoder time per served study (ms):
CUDA events at the prompt encoder's forward entry and the mask
decoder's exit (all the study's boxes in one call), averaged over the
studies of the traced run's unprofiled pass."""

import numpy as np


def read(ctx):
    vals = ctx.get("mask_decoder_ms")
    return float(np.mean(vals)) if vals else None
