"""Plain reference of the friction-cone QCQP and its gradients.

    min_l 1/2 l'Pl + q'l   subject to   ||l_(i)||_2 <= r_i = mu_i * l_n_i,

contact i being the coordinates (2i, 2i + 1), the problem class of
``QCQPFn2`` in quentinll/diffqcqp (Le Lidec et al., "Differentiable
simulation for physical system identification"). Written from that
statement alone in plain torch: it imports nothing of the package under
test and takes none of its state.

The forward solve is textbook ADMM on the split l = z, z in the product of
disks, with a fixed penalty per problem (P's mean eigenvalue), then Newton
polish on the KKT system of the active contacts, so that the result is
exact to float64 rounding wherever the active set is strict. The gradients
of a loss L(l) follow by implicit differentiation of the same KKT system. With multipliers lam_i of (||l_i||^2 - r_i^2) / 2:

    F(l, lam) = [P l + q + sum_i lam_i E_i l ;  (||l_i||^2 - r_i^2) / 2, i active] = 0

    J = [[P + Lam, C], [C', 0]],   C[:, i] = E_i l.

The adjoint [u; v] = J^-1 [dL/dl; 0] gives dL/dq = -u, dL/dP =
-(u l' + l u') / 2 (the solver sees P's symmetric part), dL/dr_i = v_i r_i,
so dL/dl_n = dL/dr * mu and dL/dmu = dL/dr * l_n. An inactive contact's row
and column are the identity, so its v_i is 0.

``precision="tf32"`` is the control of the benchmark's comparison: the same
steps in float32 with every operand of a product or solve rounded to TF32's
10-bit mantissa, which is what a tensor-core TF32 product does to them.
"""

from __future__ import annotations

import torch

__all__ = ["Solution", "solve", "gradients", "round_tf32"]

ADMM_ITERS = 400    # the polish needs only the active set from them
NEWTON_STEPS = 4


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest-even at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _Arith:
    """Products and solves at one precision: float64, or float32 with TF32 operands."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision is 'float64' or 'tf32', got {precision!r}")
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.tf32 = precision == "tf32"

    def r(self, x):
        return round_tf32(x) if self.tf32 else x

    def mv(self, A, x):
        return torch.matmul(self.r(A), self.r(x)[..., None])[..., 0]

    def solve(self, A, b):
        return torch.linalg.solve(self.r(A), self.r(b))


class Solution:
    """A block of reference solutions: l (B, N), multipliers lam (B, nc),
    the active mask (B, nc), and the KKT Jacobian's pieces kept for the
    adjoint."""

    def __init__(self, P, q, r, l, lam, active, ar):
        self.P, self.q, self.r, self.l = P, q, r, l
        self.lam, self.active, self._ar = lam, active, ar

    def kkt_matrix(self):
        return _kkt_matrix(self.P, self.l, self.lam, self.active)


def _sym(P):
    return 0.5 * (P + P.transpose(-1, -2))


def _project(x, r):
    """Each contact of x (B, N) onto its disk of radius r (B, nc)."""
    B, n = x.shape
    pts = x.reshape(B, n // 2, 2)
    norm = pts.norm(dim=-1)
    tiny = torch.finfo(x.dtype).tiny
    scale = torch.where(norm > r, r / norm.clamp_min(tiny), torch.ones_like(norm))
    return (pts * scale[..., None]).reshape(B, n), norm > r


def _kkt_matrix(P, l, lam, active):
    B, n = l.shape
    nc = n // 2
    eye_c = torch.arange(n, device=l.device) // 2
    sel = (eye_c[:, None] == torch.arange(nc, device=l.device)[None, :]).to(l.dtype)   # (n, nc)
    C = l[:, :, None] * sel[None] * active[:, None, :].to(l.dtype)                 # (B, n, nc)
    H = P + torch.diag_embed(lam.repeat_interleave(2, dim=-1))
    D = torch.diag_embed((~active).to(l.dtype))
    top = torch.cat([H, C], dim=-1)
    bot = torch.cat([C.transpose(-1, -2), D], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _multipliers(P, q, l, active, ar):
    """lam_i from stationarity on contact i: (P l + q)_i + lam_i l_i = 0."""
    B, n = l.shape
    g = (ar.mv(P, l) + q).reshape(B, n // 2, 2)
    pts = l.reshape(B, n // 2, 2)
    sq = (pts * pts).sum(-1)
    lam = -(g * pts).sum(-1) / sq.clamp_min(torch.finfo(l.dtype).tiny)
    return torch.where(active, lam, torch.zeros_like(lam))


def solve(P, q, l_n, mu, precision: str = "float64") -> Solution:
    """Reference solutions of a block of problems (P (B, N, N), q (B, N),
    l_n, mu (B, nc)) at ``precision``; inputs of any float dtype and device."""
    ar = _Arith(precision)
    P = _sym(P.to(ar.dtype))
    q, r = q.to(ar.dtype), (l_n.to(ar.dtype) * mu.to(ar.dtype))
    B, n = q.shape
    rho = torch.diagonal(P, dim1=-2, dim2=-1).mean(-1)     # P's mean eigenvalue
    eye = torch.eye(n, dtype=ar.dtype, device=q.device)
    M = torch.linalg.inv(ar.r(P + rho[:, None, None] * eye))
    z = torch.zeros_like(q)
    u = torch.zeros_like(q)
    for _ in range(ADMM_ITERS):
        l = ar.mv(M, rho[:, None] * (z - u) - q)
        z, _ = _project(l + u, r)
        u = u + l - z
    _, active = _project(z + u, r)
    l = z
    for _ in range(NEWTON_STEPS):
        lam = _multipliers(P, q, l, active, ar)
        F1 = ar.mv(P, l) + q + lam.repeat_interleave(2, dim=-1) * l
        pts = l.reshape(B, n // 2, 2)
        F2 = torch.where(active, 0.5 * ((pts * pts).sum(-1) - r * r), torch.zeros_like(r))
        step = ar.solve(_kkt_matrix(P, l, lam, active), -torch.cat([F1, F2], dim=-1))
        l = l + step[:, :n]
    lam = _multipliers(P, q, l, active, ar)
    return Solution(P, q, r, l, lam, active, ar)


def gradients(sol: Solution, dl: torch.Tensor, l_n, mu):
    """(dL/dP, dL/dq, dL/dl_n, dL/dmu) of a loss whose gradient at the
    solution is ``dl`` (B, N)."""
    ar = sol._ar
    B, n = sol.l.shape
    rhs = torch.cat([dl.to(ar.dtype), torch.zeros_like(sol.r)], dim=-1)
    w = ar.solve(sol.kkt_matrix(), rhs)
    u, v = w[:, :n], w[:, n:]
    l = sol.l
    dP = -0.5 * (u[:, :, None] * l[:, None, :] + l[:, :, None] * u[:, None, :])
    dr = torch.where(sol.active, v * sol.r, torch.zeros_like(v))
    return dP, -u, dr * mu.to(ar.dtype), dr * l_n.to(ar.dtype)


def residuals(sol: Solution):
    """Per-problem worst KKT residual of a solution, relative to its scale:
    stationarity, feasibility and the multipliers' sign on active contacts."""
    P, q, l, r, lam, active = sol.P, sol.q, sol.l, sol.r, sol.lam, sol.active
    B, n = l.shape
    g = torch.matmul(P, l[..., None])[..., 0] + q
    stat = (g + lam.repeat_interleave(2, dim=-1) * l).abs().amax(-1)
    pts = l.reshape(B, n // 2, 2)
    feas = (pts.norm(dim=-1) - r).clamp_min(0).amax(-1)
    sign = (-lam).clamp_min(0).amax(-1)
    scale = g.abs().amax(-1).clamp_min(1.0)
    return torch.maximum(torch.maximum(stat / scale, feas), sign / scale)
