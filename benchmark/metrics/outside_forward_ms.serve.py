"""Time per served volume outside the model's forwards (ms): the
unprofiled pass's seconds per volume, at the cell's load, minus the
forwards' device time per volume (``forward_ms.serve``): the padding,
upload, windowing, window gather, stitch, divide, argmax and download,
and the card's idle time between them."""

import numpy as np


def read(ctx):
    fwd = ctx.get("forward_ms")
    if not fwd or not ctx.get("units") or not ctx.get("plain_window_s"):
        return None
    return 1e3 * ctx["plain_window_s"] / ctx["units"] - float(np.mean(fwd))
