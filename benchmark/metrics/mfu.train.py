"""Model FLOPs utilisation of training (%): the frozen model count of a
step (the forward and the backward that its trained set needs,
``benchmark/arith.py``) times the steps of the traced run's unprofiled
pass, over that pass's seconds times the card's published dense bf16
peak."""


def read(ctx):
    peak = ctx.get("peak_tflops")
    if not peak or not ctx.get("has_device"):
        return None
    flops = ctx["model_flops_per_unit"] * ctx["units"]
    return 100.0 * flops / (ctx["plain_window_s"] * peak * 1e12)
