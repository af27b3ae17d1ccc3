"""Per-problem solve diagnostics.

Only ``SolveStats`` is ported so far; the eager spectral / Newton-Schulz
engine of ``diffqcqp_tpu/solvers/admm.py`` comes with ROADMAP Queue 1,
item 3. The forward solve runs through the fused kernel
(``kernels/admm_cuda.py``) and its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SolveStats"]


class SolveStats(NamedTuple):
    """Per-problem solve diagnostics, as in the JAX package."""

    iterations: torch.Tensor   # (B,) int32
    res_prim: torch.Tensor     # (B,) last primal residual
    res_dual: torch.Tensor     # (B,) last dual residual
    rho: torch.Tensor          # (B,) the penalty the recorded residuals were
                               # computed with (not the post-update carry)
    converged: torch.Tensor    # (B,) bool
    stalled: torch.Tensor      # (B,) bool: converged only via the
                               # machine-precision stall floor (stall_tol)
