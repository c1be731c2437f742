"""B4 (the fused Swin block backward, ``csrc/fused_block_bwd.cu``: its
block kernel and its fixed-order reduction) against its roofline (%):
the least time of its model-level work in the steps of the traced run's
CUDA-only pass (``benchmark/arith.py``) over the summed time of the
kernels named ``KERNEL`` in the trace."""

KERNEL = ("fused_block_bwd_kernel", "bwd_reduce_kernel")


def read(ctx):
    from benchmark import arith, common
    secs = common.kernel_seconds(ctx, KERNEL)
    if not secs or not ctx.get("peak_tflops"):
        return None
    bound = arith.bound_seconds(ctx["b4_work_per_unit"], ctx["peak_tflops"],
                                ctx["peak_tbytes"]) * ctx["units"]
    return 100.0 * bound / secs
