"""B1 (the fused Swin block forward, ``csrc/fused_block.cu``) against
its roofline (%): the least time of its model-level work in the volumes
of the traced run's CUDA-only pass (per call the larger of FLOPs over
the bf16 peak and bytes over the memory rate, ``benchmark/arith.py``)
over the summed time of the kernels named ``KERNEL`` in the trace."""

KERNEL = ("fused_swin_block_kernel",)


def read(ctx):
    from benchmark import arith, common
    secs = common.kernel_seconds(ctx, KERNEL)
    if not secs or not ctx.get("peak_tflops"):
        return None
    bound = arith.bound_seconds(ctx["b1_work_per_unit"], ctx["peak_tflops"],
                                ctx["peak_tbytes"]) * ctx["units"]
    return 100.0 * bound / secs
