"""Batched dense linear algebra (port of ops/linalg.py, in part).

Only ``spd_cholesky_solve`` so far: the SPD solve of the generic KKT
adjoint route (``diff/kkt.py::_solve_direct``) off the QR kernel. The
spectral factorisation, the Newton-Schulz inverses and the power iteration
of the JAX module are not ported yet (ROADMAP Queue 1, item 2).
"""

from __future__ import annotations

import torch

__all__ = ["spd_cholesky_solve"]


def spd_cholesky_solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD multi-right-hand-side solve: A (B, m, m), rhs (B, m, k) ->
    (B, m, k). One batched Cholesky factor A = L L^T, then the two triangular
    solves L y = rhs and L^T x = y over all k columns."""
    L = torch.linalg.cholesky(A)
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)
