"""Implicit differentiation of the friction-cone QCQP's KKT conditions (port
of the QCQP part of diff/kkt.py).

    min 1/2 l^T P l + q^T l   s.t.  ||l_(i)|| <= r_i = mu_i l_n_i

Contact i owns coordinates (2i, 2i+1). ``qcqp_vjp`` solves the transposed
differentiated-KKT system for an upstream cotangent g, in the unknowns
(dgamma (nc), dl (2nc)), squared-slack form s_i = ||l_(i)||^2 - r_i^2:

    [[diag(s) + I_inact,  C^T],   (dgamma, dl) = (0, g)
     [B^T,                D  ]]

with C (n, nc) column i = 2 l_(i) on the strictly active contacts, B^T =
C diag(gamma), D = P + blockdiag(2 gamma_i I_2).

Two routes, as in the JAX package:

  * dense P and no ``duals``: the fused backward K2
    (``kernels/qcqp_bwd_cuda.py``), dual recovery plus the Schur-complement
    solve in one launch on a CUDA tensor, its plain version on a CPU tensor;
  * ``duals`` given: the assembled (nc + n) system solved by
    ``torch.linalg.solve`` (the JAX generic path's counterpart). It is not on
    the main path: the tests and ``chip_smoke.py`` use it as a referee that
    does not share K2's Schur arithmetic.

Not ported yet (ROADMAP): the diagonal-P closed form (the port's forward
takes dense P only) and ``_qcqp_schur_vjp`` (the JAX generic path above
nc + n = 88, which needs ``ops/linalg.py``'s Newton-Schulz inverse); the
assembled branch here solves any size directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SolverConfig
from ..kernels.qcqp_bwd_cuda import qcqp_kkt_bwd_fused_cuda

__all__ = [
    "QCQPDuals",
    "QCQPVJP",
    "qcqp_dual",
    "qcqp_strict_active",
    "qcqp_vjp",
    "qcqp_radius_factors",
]


class QCQPDuals(NamedTuple):
    gamma: torch.Tensor      # (B, nc) standard multipliers, zeros at inactive
    active: torch.Tensor     # (B, nc) bool


class QCQPVJP(NamedTuple):
    dl: torch.Tensor         # (B, 2nc)
    dgamma: torch.Tensor     # (B, nc)
    gamma: torch.Tensor      # (B, nc)


def _pl_plus_q(P: torch.Tensor, l: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.sum(P * l[:, None, :], dim=-1) + q


def qcqp_dual(
    P: torch.Tensor, q: torch.Tensor, radius: torch.Tensor, l: torch.Tensor,
    cfg: SolverConfig, eps=None, r_min=None,
) -> QCQPDuals:
    """Per-contact dual recovery: active iff r - ||l_(i)|| <= eps and
    r >= r_min; gamma_i = max(-(C^T(Pl+q))_i, 0) / (4 ||l_(i)||^2), the
    diagonal normal-equations solve (C's columns are disjoint per contact),
    projected onto gamma >= 0 as in the JAX package. ``eps`` / ``r_min``
    (scalars or broadcastable tensors) default to ``cfg.eps``."""
    B = l.shape[0]
    nc = radius.shape[-1]
    pts = l.reshape(B, nc, 2)
    e = cfg.eps if eps is None else eps
    rm = cfg.eps if r_min is None else r_min
    active = (radius - torch.linalg.vector_norm(pts, dim=-1) <= e) & (radius >= rm)
    plq = _pl_plus_q(P, l, q).reshape(B, nc, 2)
    num = -2.0 * torch.sum(pts * plq, dim=-1)
    den = 4.0 * torch.sum(pts * pts, dim=-1)
    gamma = torch.where(
        active,
        torch.clamp_min(num, 0.0) / torch.clamp_min(den, torch.finfo(l.dtype).tiny),
        torch.zeros_like(num),
    )
    return QCQPDuals(gamma=gamma, active=active)


def qcqp_strict_active(
    l: torch.Tensor, radius: torch.Tensor, gamma: torch.Tensor, cfg: SolverConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Squared slacks s and the strict-complementarity mask: s > -s_tol,
    r > act_eps and gamma > act_eps, s_tol = max(act_eps, 8 eps_mach
    (||l_(i)||^2 + r^2)) in l's dtype."""
    B = l.shape[0]
    nc = radius.shape[-1]
    pts = l.reshape(B, nc, 2)
    sq = torch.sum(pts * pts, dim=-1)
    s = sq - radius * radius
    s_tol = torch.clamp_min(8.0 * torch.finfo(l.dtype).eps * (sq + radius * radius), cfg.act_eps)
    active = (s > -s_tol) & (radius > cfg.act_eps) & (gamma > cfg.act_eps)
    return s, active


def _qcqp_kkt_blocks(P, l, gamma, am, nc: int, n: int):
    """Blocks of the transposed system S^T = [[diag(sigma), C^T], [B^T, D]]:
    C^T (B, nc, n), B^T = C diag(gamma am) (B, n, nc), D (B, n, n)."""
    contact_of = torch.arange(n, device=l.device) // 2
    sel_T = (torch.arange(nc, device=l.device)[:, None] == contact_of[None, :]).to(l.dtype)
    Ct = 2.0 * l[:, None, :] * sel_T * am[:, :, None]
    Bt = 2.0 * l[:, :, None] * sel_T.T * (gamma * am)[:, None, :]
    D = P + torch.diag_embed(2.0 * torch.repeat_interleave(gamma, 2, dim=-1))
    return Ct, Bt, D


def _qcqp_assembled_vjp(P, radius, l, g, duals: QCQPDuals, cfg: SolverConfig) -> QCQPVJP:
    """S^T x = [0; g] assembled and solved by ``torch.linalg.solve``."""
    B, n = l.shape
    nc = n // 2
    s, active = qcqp_strict_active(l, radius, duals.gamma, cfg)
    am = active.to(l.dtype)
    Ct, Bt, D = _qcqp_kkt_blocks(P, l, duals.gamma, am, nc, n)
    top = torch.cat([torch.diag_embed(s * am + (1.0 - am)), Ct], dim=-1)
    ST = torch.cat([top, torch.cat([Bt, D], dim=-1)], dim=-2)
    rhs = torch.cat([torch.zeros(B, nc, dtype=l.dtype, device=l.device), g], dim=-1)
    x = torch.linalg.solve(ST, rhs[..., None])[..., 0]
    return QCQPVJP(dl=x[:, nc:], dgamma=x[:, :nc] * am, gamma=duals.gamma)


def qcqp_vjp(
    P: torch.Tensor,
    q: torch.Tensor,
    radius: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    cfg: SolverConfig,
    duals: Optional[QCQPDuals] = None,
) -> QCQPVJP:
    """Adjoint of the QCQP solution map: (dl, dgamma, gamma) for the
    cotangent g. P (B, n, n) dense; q, l, g (B, n); radius (B, nc).

    Without ``duals``: K2 (``qcqp_kkt_bwd_fused_cuda``), which recovers the
    duals itself. On a CUDA tensor it runs in float32 whatever the dtype
    (cast back on return), with float32's 8-ulp slack floor; on a CPU tensor
    its plain version runs in l's dtype, with that dtype's floor (the JAX
    generic path's at float64). With ``duals``: the assembled system."""
    if P.ndim != 3:
        raise NotImplementedError(
            "diagonal P: the closed-form QCQP adjoint is not ported yet "
            "(the port's forward takes dense P only; diag_embed it)"
        )
    if duals is not None:
        return _qcqp_assembled_vjp(P, radius, l, g, duals, cfg)
    work = torch.float32 if l.device.type == "cuda" else l.dtype
    dgamma, dl, gamma = qcqp_kkt_bwd_fused_cuda(
        *(x.to(work).contiguous() for x in (P, q, l, g, radius)),
        cfg.eps, cfg.act_eps, 8.0 * torch.finfo(work).eps,
    )
    return QCQPVJP(dl=dl.to(l.dtype), dgamma=dgamma.to(l.dtype), gamma=gamma.to(l.dtype))


def qcqp_radius_factors(
    l_n: torch.Tensor, mu: torch.Tensor, gamma: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain-rule diagonals as vectors: e1 = 2 gamma l_n^2 mu (the grad_mu
    factor), e2 = 2 gamma l_n mu^2 (the grad_l_n factor)."""
    e1 = 2.0 * gamma * l_n * l_n * mu
    e2 = 2.0 * gamma * l_n * mu * mu
    return e1, e2
