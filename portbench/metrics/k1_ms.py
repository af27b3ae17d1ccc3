"""Kernel K1's device time a step: the profiler's time of every launch of
the forward ADMM kernel in the traced window, over the steps traced."""

TAG = "admm_kernel"


def is_k1(name: str) -> bool:
    return TAG in name


def read(ctx):
    s = ctx.trace.device_s(is_k1)
    return 1e3 * s / ctx.steps if s > 0 and ctx.steps else None
