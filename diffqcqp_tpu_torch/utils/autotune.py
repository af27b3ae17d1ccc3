"""Compaction autotuning (port of utils/autotune.py), priced at the card's
tile.

The JAX package's ``tune_compact_iters`` turns one representative solve's
``SolveStats.iterations`` into a two-phase compaction boundary K for its
TPU kernel, whose lane tiles of ``tile_b`` problems each run until their
slowest problem converges. Its cost model, in tile-iterations:

    single-phase:   sum over natural-order tiles of tile-max iterations
    two-phase at K: sum_t min(tile_max_t, K)                (phase 1)
                    + boundary_iters * n_tiles              (the boundary)
                    + n_survivor_tiles * max remaining      (phase 2)

with K searched over the distinct iteration counts and returned only if
its modelled saving clears ``min_saving_frac`` of the single-phase cost.

The port evaluates that same model at the tile the card runs: K1 launches
one block per problem (``kernels/admm_cuda.py``), so a tile is one problem.
At a tile of one the single-phase cost is the sum of the iterations, and
every K costs at least that plus its boundary, so the function returns 0
for every input; ``SolverConfig.compact_iters`` is ignored on the card
anyway (``config.py``). ``tile_b`` and ``n`` are accepted for the JAX
signature and ignored.
"""

from __future__ import annotations

__all__ = ["tune_compact_iters"]


def tune_compact_iters(
    iterations,
    *,
    tile_b: int = 512,
    n: int | None = None,
    boundary_iters: float = 8.0,
    min_saving_frac: float = 0.1,
    max_iter: int | None = None,
) -> int:
    """Pick ``SolverConfig.compact_iters`` from measured per-problem
    iteration counts, by the JAX package's cost model at the card's tile of
    one problem: always 0, compaction never worth its boundary (see the
    module docstring)."""
    del iterations, tile_b, n, boundary_iters, min_saving_frac, max_iter
    return 0
