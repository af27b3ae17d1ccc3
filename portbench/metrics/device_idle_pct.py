"""The card's idle share of the traced window, in %: one minus the union of
the intervals in which a kernel, copy or fill ran, over the window's
length. Overlapping intervals count once, so it never reads below 0.

Where the host paces the step, the profiler slows the host path and this
share overstates the idle of an untraced run; a host-path change is read
first in ``replay_host_ms`` and ``problems_per_s``, which are untraced."""


def read(ctx):
    w = ctx.trace.window_s
    if w <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / w)
