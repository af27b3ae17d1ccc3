"""K4's share of its roofline, in %: the frozen ``k4_bound_ms`` of one
step's batch of non-negative QPs (no bound vectors, no dual slots) over
``k4_ms``."""

from portbench import roofline
from portbench.metrics import k4_ms


def read(ctx):
    ms = k4_ms.read(ctx)
    if ms is None:
        return None
    cfg = ctx.config
    bound, _, _, _ = roofline.k4_bound_ms(cfg["batch"], cfg["n"], 0, 0)
    return 100.0 * bound / ms
