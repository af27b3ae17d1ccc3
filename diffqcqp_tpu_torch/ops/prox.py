"""Batched proximal projections (port of ops/prox.py).

Each function works over a batch ``x: (..., N)``. The disk projection uses
the reference coordinate order: contact i owns coordinates (2i, 2i+1). These
are also the plain versions of the projections inside the fused ADMM kernel
(``kernels/csrc/admm.cu``), which computes the disk norm with the same
``a*a + b*b`` expression.
"""

from __future__ import annotations

import torch

__all__ = ["prox_nonneg", "prox_box", "prox_signed_box", "prox_disk"]


def prox_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Project onto the non-negative orthant: max(x, 0)."""
    return torch.clamp_min(x, 0.0)


def prox_box(x: torch.Tensor, l_min: torch.Tensor, l_max: torch.Tensor) -> torch.Tensor:
    """Project onto [l_min, l_max]: max first, then min (the upper clamp
    wins when l_min > l_max, as in the reference)."""
    return torch.minimum(torch.maximum(x, l_min), l_max)


def prox_signed_box(
    x: torch.Tensor, l_min: torch.Tensor, l_max: torch.Tensor, v_sign: torch.Tensor
) -> torch.Tensor:
    """Box clamp, then the sign constraint sign(v) * l <= 0.
    ``v_sign`` is already the element-wise sign of v."""
    y = prox_box(x, l_min, l_max)
    return v_sign * torch.clamp_max(v_sign * y, 0.0)


def prox_disk(x: torch.Tensor, radius: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Per-contact projection onto disks of radii ``radius`` (..., nc).

    A contact vector whose 2-norm exceeds its radius is rescaled onto the
    circle, otherwise left as it is. ``eps`` floors the norm in the division
    (a zero vector only exceeds a negative radius; it then maps to 0). A
    trailing coordinate past 2*nc (odd N) is unconstrained and passes
    through.
    """
    nc = radius.shape[-1]
    a = x[..., 0 : 2 * nc : 2]
    b = x[..., 1 : 2 * nc : 2]
    norm = torch.sqrt(a * a + b * b)
    scale = torch.where(
        norm > radius, radius / torch.clamp_min(norm, eps), torch.ones_like(norm)
    )
    pts = torch.stack([a * scale, b * scale], dim=-1).flatten(-2)
    if x.shape[-1] > 2 * nc:
        pts = torch.cat([pts, x[..., 2 * nc :]], dim=-1)
    return pts
