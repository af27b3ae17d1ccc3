"""Kernel K4's device time a step: the profiler's time of every launch of
the fused QP-family backward kernel in the traced window, over the steps
traced."""

TAG = "coord_bwd_kernel"


def is_k4(name: str) -> bool:
    return TAG in name


def read(ctx):
    s = ctx.trace.device_s(is_k4)
    return 1e3 * s / ctx.steps if s > 0 and ctx.steps else None
