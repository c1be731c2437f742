"""Model FLOPs utilisation of serving (%): the frozen model count of each
volume's forwards (``benchmark/arith.py``) times the volumes of the
traced run's unprofiled pass, over that pass's seconds times the card's
published dense bf16 peak."""


def read(ctx):
    peak = ctx.get("peak_tflops")
    if not peak or not ctx.get("has_device"):
        return None
    flops = ctx["model_flops_per_unit"] * ctx["units"]
    return 100.0 * flops / (ctx["plain_window_s"] * peak * 1e12)
