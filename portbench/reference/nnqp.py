"""Plain reference of the non-negative QP and its gradients.

    min_l 1/2 l'Pl + q'l   subject to   l >= 0,

the problem class of ``QPFn2`` in quentinll/diffqcqp. Written from that
statement alone in plain torch: it imports nothing of the package under
test and takes none of its state.

The forward solve is textbook ADMM on the split l = z, z >= 0, with a fixed
penalty per problem (P's mean eigenvalue), then a primal-dual active-set
polish: the free coordinates F solve P_FF l_F = -q_F, the others are 0, and
a coordinate changes side while its value (free) or its multiplier (P l +
q, active) is negative. The result is exact to float64 rounding wherever
the active set is strict. The gradients of a loss L(l) follow by implicit
differentiation: u_F = P_FF^-1 dL/dl_F, u = 0 elsewhere, dL/dq = -u and
dL/dP = -(u l' + l u') / 2 (the solver sees P's symmetric part).

``precision="tf32"`` is the control of the benchmark's comparison, as in
``reference/qcqp.py``.
"""

from __future__ import annotations

import torch

from portbench.reference.qcqp import _Arith, _sym

__all__ = ["Solution", "solve", "gradients", "residuals"]

ADMM_ITERS = 400    # the polish needs only the active set from them
POLISH_ROUNDS = 8


class Solution:
    """A block of reference solutions: l (B, N), the multipliers P l + q
    (B, N), zero on the free coordinates, and the active mask (B, N)."""

    def __init__(self, P, q, l, lam, active, ar):
        self.P, self.q, self.l, self.lam, self.active, self._ar = P, q, l, lam, active, ar


def _masked(P, active):
    """P with the active coordinates' rows and columns replaced by the identity's."""
    free = (~active).to(P.dtype)
    M = P * free[:, :, None] * free[:, None, :]
    return M + torch.diag_embed(active.to(P.dtype))


def solve(P, q, precision: str = "float64") -> Solution:
    """Reference solutions of a block of problems (P (B, N, N), q (B, N)) at
    ``precision``; inputs of any float dtype and device."""
    ar = _Arith(precision)
    P = _sym(P.to(ar.dtype))
    q = q.to(ar.dtype)
    n = q.shape[-1]
    rho = torch.diagonal(P, dim1=-2, dim2=-1).mean(-1)     # P's mean eigenvalue
    eye = torch.eye(n, dtype=ar.dtype, device=q.device)
    M = torch.linalg.inv(ar.r(P + rho[:, None, None] * eye))
    z = torch.zeros_like(q)
    u = torch.zeros_like(q)
    for _ in range(ADMM_ITERS):
        l = ar.mv(M, rho[:, None] * (z - u) - q)
        z = (l + u).clamp_min(0)
        u = u + l - z
    active = z + u <= 0
    for _ in range(POLISH_ROUNDS):
        l = ar.solve(_masked(P, active), torch.where(active, torch.zeros_like(q), -q))
        lam = torch.where(active, ar.mv(P, l) + q, torch.zeros_like(q))
        flip = torch.where(active, lam < 0, l < 0)
        if not flip.any():
            break
        active = active ^ flip
    return Solution(P, q, l, lam, active, ar)


def gradients(sol: Solution, dl: torch.Tensor):
    """(dL/dP, dL/dq) of a loss whose gradient at the solution is ``dl`` (B, N)."""
    ar = sol._ar
    rhs = torch.where(sol.active, torch.zeros_like(sol.l), dl.to(ar.dtype))
    u = ar.solve(_masked(sol.P, sol.active), rhs)
    l = sol.l
    dP = -0.5 * (u[:, :, None] * l[:, None, :] + l[:, :, None] * u[:, None, :])
    return dP, -u


def residuals(sol: Solution):
    """Per-problem worst KKT residual of a solution, relative to its scale:
    stationarity on the free coordinates, feasibility, and the multipliers'
    sign on the active ones."""
    P, q, l, active = sol.P, sol.q, sol.l, sol.active
    g = torch.matmul(P, l[..., None])[..., 0] + q
    stat = torch.where(active, torch.zeros_like(g), g).abs().amax(-1)
    feas = (-l).clamp_min(0).amax(-1)
    sign = torch.where(active, (-g).clamp_min(0), torch.zeros_like(g)).amax(-1)
    scale = q.abs().amax(-1).clamp_min(1.0)
    return torch.maximum(torch.maximum(stat / scale, feas), sign / scale)
