"""Share of the time (%) in which the device ran no kernel, copy or
fill: one minus the device's busy time in the CUDA-only profiled pass
over the time that the same number of units took unprofiled, back to
back (the profiler slows the host, so its own window is not the
divisor)."""


def read(ctx):
    if not ctx.get("has_device") or not ctx.get("plain_window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["plain_window_s"])
