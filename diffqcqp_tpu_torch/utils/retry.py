"""Batch-level retry (port of utils/retry.py): re-solve with warm starts
until everything converges.

``SolveStats`` carries the per-problem convergence signal, so the recovery
policy is expressible: warm-start another batched solve from the previous
iterate with a larger budget, keep the already-converged results frozen,
repeat. A fixed number of rounds, each one batched solve (on the card, one
launch of K1 a round for dense float32 problems); converged problems
re-enter every round but stay frozen (``torch.where``), and their
iterations are not counted again.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import SolverConfig
from ..solvers.admm import SolveStats

__all__ = ["solve_resumed"]


def solve_resumed(
    solve_with_stats: Callable,
    *args,
    config: SolverConfig,
    rounds: int = 3,
    growth: int = 4,
    warm_start=None,
    **kwargs,
):
    """Run ``solve_with_stats(*args, warm_start, config=..., **kwargs)`` up
    to ``rounds`` times, multiplying max_iter by ``growth`` each round and
    warm-starting from the previous solution. Returns (l, SolveStats) with
    per-problem totals (iterations summed over the rounds each problem
    actually ran). Works with any ``solve_*_with_stats``; ``kwargs`` go to
    every call (``device=...``):

        l, st = solve_resumed(solve_qcqp_with_stats, P, q, l_n, mu,
                              config=cfg, rounds=3)
    """
    l, stats = solve_with_stats(*args, warm_start, config=config, **kwargs)
    total_iters = stats.iterations
    max_iter = config.max_iter
    for _ in range(rounds - 1):
        max_iter *= growth
        cfg = config.replace(max_iter=int(max_iter))
        l_new, st = solve_with_stats(*args, l, config=cfg, **kwargs)
        unconv = ~stats.converged
        l = torch.where(unconv[:, None] if l.ndim == 2 else unconv, l_new, l)
        total_iters = total_iters + torch.where(unconv, st.iterations, 0)
        stats = SolveStats(
            iterations=total_iters,
            res_prim=torch.where(unconv, st.res_prim, stats.res_prim),
            res_dual=torch.where(unconv, st.res_dual, stats.res_dual),
            rho=torch.where(unconv, st.rho, stats.rho),
            converged=stats.converged | st.converged,
            stalled=torch.where(unconv, st.stalled, stats.stalled),
        )
    return l, stats
