"""Device kernels per served volume: kernel events in the profiler's
trace of the traced run's CUDA-only pass, per volume (copies and fills
not counted)."""


def read(ctx):
    if not ctx.get("kernels") or not ctx.get("units"):
        return None
    return len(ctx["kernels"]) / ctx["units"]
