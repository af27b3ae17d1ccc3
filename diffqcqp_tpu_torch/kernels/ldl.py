"""Plain batched versions of the zero-diagonal LDL^T helpers (port of
kernels/ldl.py).

The fused kernels factor P + diag(shift) by left-looking Cholesky, convert
the factor to a unit-lower Lh with its diagonal stored as ZERO plus a plane
dinv = 1 / L_jj^2, and solve in 2n + 1 steps:

    Lh y = rhs      n steps   acc <- acc - Lh[:, i] * acc[i]   (i >= start)
    w = y * dinv    1 step
    Lh^T x = w      n steps   acc <- acc - Lh[i, :] * acc[i]   (i descending)

Because the stored diagonal is zero, row i of the accumulator is final when
its turn comes, so each step is one broadcast multiply-add. The CUDA
counterparts are the ``__device__`` helpers in ``kernels/csrc/ldl.cuh``:
in registers at one warp (K2 and K6 at n <= 32, K4's free block at nf <=
32), or block-wide with register tiles (K2 and K6 above one warp, K4's free
block at nf > 32): a right-looking factor and one pair of sweeps for all
right-hand sides, both giving each entry these operations in this order. These functions repeat that arithmetic on whole
batches, in any dtype, and are what the CPU path and the tests run.

Layout: ``L``/``Lh`` are (B, n, n) with ``L[:, r, j]`` = row r, column j.
"""

from __future__ import annotations

import torch

__all__ = ["TINY", "chol_factor", "chol_to_unit", "ldl_solve"]

# floor of the pivot before the reciprocal square root (the kernel's
# ``tiny``); keeps 1 / L_jj <= 1e15 finite in float32
TINY = 1e-30


def chol_factor(P: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Standard lower Cholesky factor of P + diag(shift), by left-looking
    columns with the kernel's pivot floor: column j is
    s = P[:, j] + shift_j e_j - sum_{k<j} L[:, k] L[j, k], then
    s / sqrt(max(s_j, TINY)) on rows >= j. ``shift`` is (B,), one shift
    for every row (K1's rho + mu), or (B, n), one per row (K2's 2 gamma,
    K4's am)."""
    B, n, _ = P.shape
    L = torch.zeros_like(P)
    rows = torch.arange(n, device=P.device)
    for j in range(n):
        s = P[:, :, j].clone()
        s[:, j] = s[:, j] + (shift[:, j] if shift.ndim == 2 else shift)
        for k in range(j):
            s = s - L[:, :, k] * L[:, j, k : k + 1]
        d = torch.clamp_min(s[:, j : j + 1], TINY)
        col = s * (1.0 / torch.sqrt(d))
        L[:, :, j] = torch.where(rows >= j, col, torch.zeros_like(col))
    return L


def chol_to_unit(L: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Lh, dinv) from a standard Cholesky factor: Lh[:, :, j] =
    L[:, :, j] / L_jj strictly below the diagonal (zero on and above it),
    dinv[:, j] = 1 / L_jj^2."""
    n = L.shape[-1]
    rj = 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)              # (B, n)
    strict = torch.tril(torch.ones(n, n, dtype=torch.bool, device=L.device), -1)
    Lh = torch.where(strict, L * rj[:, None, :], torch.zeros_like(L))
    return Lh, rj * rj


def ldl_solve(
    Lh: torch.Tensor, dinv: torch.Tensor, rhs: torch.Tensor, start: int = 0
) -> torch.Tensor:
    """x = (L L^T)^{-1} rhs from the converted factor. Rows of ``rhs``
    below ``start`` must be zero: the forward sweep skips them."""
    n = Lh.shape[-1]
    acc = rhs
    for i in range(start, n):
        acc = acc - Lh[:, :, i] * acc[:, i : i + 1]
    acc = acc * dinv
    for i in reversed(range(n)):
        acc = acc - Lh[:, i, :] * acc[:, i : i + 1]
    return acc
