"""MedSAM's image-encoder attention core against its roofline (%): the
least time of the work of a study's attention calls (12 blocks per
encoder forward; per call the larger of FLOPs of ``q k^T``, ``p v`` and
the two ``q . R`` products over the bf16 peak, and bytes of q, k, v, the
output and the two tables over the memory rate; ``benchmark/
arith_medsam.py``) over the time between CUDA events after each block's
``qkv`` projection and before its ``proj``, summed over the studies of
the traced run's unprofiled pass."""


def read(ctx):
    from benchmark import arith
    ms = ctx.get("attn_ms")
    if not ms or not sum(ms) or not ctx.get("peak_tflops"):
        return None
    bound = arith.bound_seconds(ctx["attn_work_per_unit"], ctx["peak_tflops"],
                                ctx["peak_tbytes"]) * len(ms)
    return 100.0 * bound / (1e-3 * sum(ms))
