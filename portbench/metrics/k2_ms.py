"""Kernel K2's device time a step: the profiler's time of every launch of
the fused QCQP backward kernel (``qcqp_bwd_kernel*``) in the traced window,
over the steps traced."""

from portbench.metrics.glue_ms import K2_TAG


def is_k2(name: str) -> bool:
    return K2_TAG in name


def read(ctx):
    s = ctx.trace.device_s(is_k2)
    return 1e3 * s / ctx.steps if s > 0 and ctx.steps else None
