"""Solution verification: KKT residuals with least-squares dual recovery
(port of verify.py).

For all four problem classes, per problem:

    stationarity        ||P l + q + J(l)^T gamma||_inf
    primal feasibility  max_j  max(c_j(l), 0)
    complementarity     max_j |gamma_j * c_j(l)|
    dual feasibility    max_j  max(-gamma_j, 0)

The multipliers are recovered by least squares on the masked active-
constraint Jacobian through ``ops.linalg.refine_solve`` (the reference's
``iterative_refinement``): the constraint Jacobians of these classes have
disjoint per-constraint support, so the normal matrix is diagonal and the
refinement converges in a couple of steps.

Intended use: float64 verification of (possibly float32, on-card) solutions.
Everything is computed on ``device`` (the card by default, raising without
CUDA; ``device="cpu"`` for the plain path), in ``dtype`` (float64 by
default; the card computes float64 itself). This is a diagnostic path, not
the autodiff path: the adjoints in ``diff/kkt.py`` recover their duals in
closed form or inside the fused kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .api import _device
from .diff.kkt import _pl_plus_q
from .ops.linalg import refine_solve
from .utils.shapes import _as_tensor, canon_problem

__all__ = [
    "KKTResiduals",
    "stationarity_bound",
    "check_qp",
    "check_box_qp",
    "check_signed_box_qp",
    "check_qcqp",
]


class KKTResiduals(NamedTuple):
    """Per-problem KKT residuals (each (B,), >= 0, ~0 at an exact solution)
    plus the recovered multipliers."""

    stationarity: torch.Tensor     # ||Pl + q + J^T gamma||_inf
    primal: torch.Tensor           # max constraint violation
    complementarity: torch.Tensor  # max |gamma_j c_j(l)|
    dual: torch.Tensor             # max(-gamma_j, 0) (multiplier sign violation)
    gamma: torch.Tensor            # (B, m) recovered multipliers (0 at inactive)


def _finish(plq, Jt, gamma, c, act) -> KKTResiduals:
    gamma = gamma * act
    stat = torch.amax(torch.abs(plq + (Jt @ gamma[..., None])[..., 0]), dim=-1)
    prim = torch.amax(torch.clamp_min(c, 0.0), dim=-1)
    comp = torch.amax(torch.abs(gamma * c), dim=-1)
    dual = torch.amax(torch.clamp_min(-gamma, 0.0), dim=-1)
    return KKTResiduals(stat, prim, comp, dual, gamma)


def _solution(l, q: torch.Tensor, dtype) -> tuple[torch.Tensor, float]:
    """l in q's batched layout and ``dtype`` on q's device, and the machine
    epsilon of the dtype l was solved in."""
    l_ = _as_tensor(l)
    solve_eps = torch.finfo(l_.dtype).eps
    l_ = l_.reshape(q.shape) if l_.numel() == q.numel() else l_
    return l_.to(device=q.device, dtype=dtype), solve_eps


def _as(x, like: torch.Tensor) -> torch.Tensor:
    """x (array or tensor) in ``like``'s dtype and on its device."""
    return torch.as_tensor(_as_tensor(x), dtype=like.dtype, device=like.device)


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    """An auxiliary vector (bounds, v) broadcast to l's shape, dtype and device."""
    return _as(x, like).broadcast_to(like.shape)


def _prep(P, q, l, tol_act: Optional[float], dtype, device):
    c = canon_problem(P, q, device=_device(device))
    P_, q_ = c.P.to(dtype), c.q.to(dtype)
    l_, solve_eps = _solution(l, q_, dtype)
    if tol_act is None:
        # activity at the SOLUTION's precision: a float32 solve leaves binding
        # constraints ~eps_f32 off the boundary, which a tolerance at the
        # float64 verification dtype would classify inactive
        tol_act = 100.0 * solve_eps
    return P_, q_, l_, tol_act


def stationarity_bound(
    P, q, l, stats, *, alpha: float = 1.5, mu_prox: float = 1e-7, dtype=torch.float64,
    device="cuda",
) -> torch.Tensor:
    """Per-problem upper bound on the returned iterate's stationarity
    residual, from ``SolveStats`` alone: what the stopping rule controls.

    From the engine's identities (the JAX package's ``verify.py`` derives
    them), with rp = res_prim, rd = res_dual:

        ||P l2 + q + J' gamma||_inf
          <= (||P||_inf / alpha) * (rp + |1-alpha| * rd/rho)
             + (1 - 1/alpha) * rho * rp  +  rd / alpha
             + 2 * mu_prox * (||l2||_inf + rp + rd/rho)

    plus a floor of 64 eps (eps of the solution's dtype) times ((||P||_inf
    + rho + mu_prox) max(||l||_inf, 1) + ||q||_inf) for the solve's and the
    residual's rounding. Returns (B,) in ``dtype`` on ``device``.
    """
    c = canon_problem(P, q, device=_device(device))
    P_, q_ = c.P.to(dtype), c.q.to(dtype)
    l_, solve_eps = _solution(l, q_, dtype)
    rp, rd = _as(stats.res_prim, q_), _as(stats.res_dual, q_)
    rho = torch.clamp_min(_as(stats.rho, q_), torch.finfo(dtype).tiny)
    if P_.ndim == 2:
        normP = torch.amax(torch.abs(P_), dim=-1)
    else:
        normP = torch.amax(torch.sum(torch.abs(P_), dim=-1), dim=-1)
    lmax = torch.amax(torch.abs(l_), dim=-1)
    qmax = torch.amax(torch.abs(q_), dim=-1)
    delta = rd / rho
    a = float(alpha)
    bound = (
        (normP / a) * (rp + abs(1.0 - a) * delta)
        + (1.0 - 1.0 / a) * rho * rp
        + rd / a
        + 2.0 * mu_prox * (lmax + rp + delta)
    )
    floor = 64.0 * solve_eps * ((normP + rho + mu_prox) * torch.clamp_min(lmax, 1.0) + qmax)
    return bound + floor


def check_qp(
    P, q, l, *, tol_act: Optional[float] = None, mu_ir: float = 1e-12, iters: int = 5,
    dtype=torch.float64, device="cuda",
) -> KKTResiduals:
    """KKT residuals of a non-negative QP solution (c_i = -l_i <= 0)."""
    P_, q_, l_, tol = _prep(P, q, l, tol_act, dtype, device)
    n = q_.shape[-1]
    plq = _pl_plus_q(P_, l_, q_)
    scale = torch.clamp_min(torch.amax(torch.abs(l_), dim=-1, keepdim=True), 1.0)
    act = (-l_ >= -tol * scale).to(dtype)
    Jt = -torch.eye(n, dtype=dtype, device=q_.device) * act[:, None, :]
    gamma = refine_solve(Jt, -plq, mu_ir=mu_ir, iters=iters)
    return _finish(plq, Jt, gamma, -l_, act)


def check_box_qp(
    P, q, l_min, l_max, l, *, tol_act: Optional[float] = None, mu_ir: float = 1e-12,
    iters: int = 5, dtype=torch.float64, device="cuda",
) -> KKTResiduals:
    """KKT residuals of a box-QP solution (c = [l_min - l, l - l_max])."""
    P_, q_, l_, tol = _prep(P, q, l, tol_act, dtype, device)
    n = q_.shape[-1]
    lo, hi = _vec(l_min, l_), _vec(l_max, l_)
    plq = _pl_plus_q(P_, l_, q_)
    cons = torch.cat([lo - l_, l_ - hi], dim=-1)
    scale = torch.clamp_min(torch.amax(torch.abs(l_), dim=-1, keepdim=True), 1.0)
    act = (cons >= -tol * scale).to(dtype)
    eye = torch.eye(n, dtype=dtype, device=q_.device)
    Jt = torch.cat([-eye * act[:, None, :n], eye * act[:, None, n:]], dim=-1)
    gamma = refine_solve(Jt, -plq, mu_ir=mu_ir, iters=iters)
    return _finish(plq, Jt, gamma, cons, act)


def check_signed_box_qp(
    P, q, l_min, l_max, v, l, *, tol_act: Optional[float] = None, mu_ir: float = 1e-12,
    iters: int = 5, dtype=torch.float64, device="cuda",
) -> KKTResiduals:
    """KKT residuals of a signed-box solution (c = [l_min - l, l - l_max,
    sign(v) * l])."""
    P_, q_, l_, tol = _prep(P, q, l, tol_act, dtype, device)
    n = q_.shape[-1]
    lo, hi, vs = _vec(l_min, l_), _vec(l_max, l_), torch.sign(_vec(v, l_))
    plq = _pl_plus_q(P_, l_, q_)
    cons = torch.cat([lo - l_, l_ - hi, vs * l_], dim=-1)
    scale = torch.clamp_min(torch.amax(torch.abs(l_), dim=-1, keepdim=True), 1.0)
    act = (cons >= -tol * scale).to(dtype)
    # a zero-sign slot (v == 0) is no constraint at all
    act = torch.cat([act[:, : 2 * n], act[:, 2 * n :] * torch.abs(vs)], dim=-1)
    eye = torch.eye(n, dtype=dtype, device=q_.device)
    Jt = torch.cat([-eye * act[:, None, :n], eye * act[:, None, n : 2 * n],
                    eye * (vs[:, None, :] * act[:, None, 2 * n :])], dim=-1)
    gamma = refine_solve(Jt, -plq, mu_ir=mu_ir, iters=iters)
    return _finish(plq, Jt, gamma, cons, act)


def check_qcqp(
    P, q, l_n, mu, l, *, tol_act: Optional[float] = None, mu_ir: float = 1e-12,
    iters: int = 5, dtype=torch.float64, device="cuda",
) -> KKTResiduals:
    """KKT residuals of a friction-cone QCQP solution, squared-slack form
    (c_i = ||l_(i)||^2 - r_i^2 <= 0 with r = l_n * mu)."""
    P_, q_, l_, tol = _prep(P, q, l, tol_act, dtype, device)
    B, n = l_.shape
    nc = n // 2
    r = (_as(l_n, q_) * _as(mu, q_)).reshape(B, nc)
    plq = _pl_plus_q(P_, l_, q_)
    pts = l_.reshape(B, nc, 2)
    sq = torch.sum(pts * pts, dim=-1)
    cons = sq - r * r
    scale = torch.clamp_min(sq + r * r, 1.0)
    # a cone is degenerate (a point: multiplier undefined) only when r^2 is
    # below the solution dtype's noise at the contact's own scale
    act = ((cons >= -tol * scale) & (r * r > tol * (sq + r * r))).to(dtype)
    coord_contact = (torch.arange(nc, device=q_.device)[None, :]
                     == (torch.arange(n, device=q_.device) // 2)[:, None]).to(dtype)   # (n, nc)
    Jt = 2.0 * l_[:, :, None] * coord_contact[None] * act[:, None, :]
    gamma = refine_solve(Jt, -plq, mu_ir=mu_ir, iters=iters)
    return _finish(plq, Jt, gamma, cons, act)
