"""Staging's host path: the mean host time of one call of the staged step
(its input copies, the graph's replay and the output clones), from the
benchmark's own host clock around each call, in the untraced window run
right before the traced one (the profiler slows the host path)."""


def read(ctx):
    d = ctx.untraced.dispatch
    return 1e3 * sum(d) / len(d) if d else None
