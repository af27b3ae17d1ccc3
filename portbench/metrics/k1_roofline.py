"""K1's share of its roofline, in %: the frozen ``k1_bound_ms`` of one
step's batch over ``k1_ms``. The iterations, factorisations and power
iterations it counts are the configuration's fixed ones (``k1_counts``),
not the program's."""

import torch

from portbench import roofline
from portbench.metrics import k1_ms


def read(ctx):
    ms = k1_ms.read(ctx)
    if ms is None:
        return None
    cfg = ctx.config
    B, n, nc = cfg["batch"], cfg["n"], cfg.get("contacts", 0)
    counts = cfg["k1_counts"]
    iters = torch.full((B,), float(counts["iterations_per_problem"]), dtype=torch.float64)
    factors = torch.full((B,), float(counts["factorisations_per_problem"]), dtype=torch.float64)
    bound, _, _, _ = roofline.k1_bound_ms(B, n, nc, iters, factors, counts["power_iters"])
    return 100.0 * bound / ms
