"""K2's share of its roofline, in %: the frozen ``k2_bound_ms`` of one
step's K2 launch over ``k2_ms``. The launch's QCQPs and their strictly
active contacts are the plain reference's (its ``active`` mask of each
pool slot: (B, nc), B the QCQPs a step's K2 takes), and the bound is the
mean over the slots, which the steps take in turn."""

from portbench import roofline
from portbench.metrics import k2_ms


def read(ctx):
    ms = k2_ms.read(ctx)
    masks = [info["active"] for info in ctx.reference.values() if "active" in info]
    if ms is None or not masks:
        return None
    n = ctx.config["n"]
    bounds = [roofline.k2_bound_ms(a.shape[0], n, a.shape[1], a)[0] for a in masks]
    return 100.0 * (sum(bounds) / len(bounds)) / ms
