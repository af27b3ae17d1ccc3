"""Ruiz equilibration (port of ops/equilibrate.py).

``ruiz_diag`` computes a positive diagonal d with diag(d) P diag(d) having
near-unit inf-norm rows; the API solves the rescaled problem and maps the
solution back (l = d * l_eq). For the friction cone both coordinates of a
contact share one scale (``isotropize``) so a disk stays a disk, and the
radius becomes radius / d_i.
"""

from __future__ import annotations

import torch

__all__ = ["ruiz_diag", "scale_problem", "contact_scale", "isotropize"]


def ruiz_diag(P: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Equilibration diagonal d (B, N) > 0. P (B, N, N) dense or (B, N)
    diagonal.

    Rows whose inf-norm sits at or below sqrt(dtype tiny) keep their current
    scale (an absolute threshold: actual zeros or denormal noise), so d
    never overflows on a zero row.
    """
    thr = torch.finfo(P.dtype).tiny ** 0.5
    if P.ndim == 2:
        a = P.abs()
        return torch.where(
            a > thr, 1.0 / torch.sqrt(torch.clamp_min(a, thr)), torch.ones_like(a)
        )
    d = torch.ones(P.shape[:2], dtype=P.dtype, device=P.device)
    for _ in range(iters):
        Pd = P * d[:, :, None] * d[:, None, :]
        norms = Pd.abs().amax(dim=-1)
        d = torch.where(norms > thr, d / torch.sqrt(torch.clamp_min(norms, thr)), d)
    return d


def scale_problem(
    P: torch.Tensor, q: torch.Tensor, d: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, q) -> (D P D, D q)."""
    if P.ndim == 2:
        return P * d * d, q * d
    return P * d[:, :, None] * d[:, None, :], q * d


def contact_scale(d: torch.Tensor) -> torch.Tensor:
    """Per-contact isotropic scale (B, nc): geometric mean of the two
    coordinate scales of d (B, 2nc)."""
    B, n = d.shape
    pairs = d.reshape(B, n // 2, 2)
    return torch.sqrt(pairs[..., 0] * pairs[..., 1])


def isotropize(d: torch.Tensor) -> torch.Tensor:
    """Replace each contact's two scales by their geometric mean; (B, 2nc)."""
    return torch.repeat_interleave(contact_scale(d), 2, dim=-1)
