"""Full parameter Jacobians of the solution maps: one KKT solve, n
right-hand sides (port of diff/jacobian.py).

The adjoint map g -> (dl, dgamma) is linear through one fixed matrix, the
transposed differentiated-KKT system S^T of ``diff/kkt.py``. Each function
here assembles S^T once, solves it against the n-column identity cotangent
block in one batched multi-right-hand-side solve (one factorisation for all
n columns), and reads every parameter Jacobian off the solution with the
chain-rule factors the VJPs use:

    dl_i/dq_j      = -DL[i, j]
    dl_i/dP_jk     = -(DL[i, j] l_k + l_j DL[i, k]) / 2      (symmetrised,
                      as ``api._grad_P``)
    dl_i/dl_min_j  = -gamma_lo_j * DG_lo[i, j]               (box family)
    dl_i/dl_max_j  = +gamma_hi_j * DG_hi[i, j]
    dl_i/dl_n_c    =  E2_c * DG[i, c]                        (QCQP)
    dl_i/dmu_c     =  E1_c * DG[i, c]

with DL[i, :] = dl(e_i), DG[i, :] = dgamma(e_i) the adjoint solutions for
the basis cotangents. A sensitivity-analysis surface, not the training path:
the solves are ``spd_cholesky_solve`` (SPD systems) and ``ops.linalg.solve``
(an LU, saddle systems), as the JAX package's run in XLA outside any Pallas
kernel; under a CUDA graph capture both record their device-side forms;
when ``l`` is not given the forward is the port's ``solve_*`` (on the card,
K1 for dense float32 problems within its bound).

Inputs take every ``canon_problem`` layout (dense or diagonal P; a diagonal
P goes through the same dense assembly) and ``device`` (the card by default,
raising without CUDA; ``device="cpu"`` for the plain path). Outputs are in
the flat canonical layout: a leading batch axis iff the input had one,
Jacobian rows indexed by the output coordinate l_i.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..api import _device, solve_box_qp, solve_qcqp, solve_qp, solve_signed_box_qp
from ..config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig
from ..ops.linalg import solve, spd_cholesky_solve
from ..utils.shapes import canon_like, canon_problem
from . import kkt

__all__ = [
    "QPJacobian",
    "BoxJacobian",
    "QCQPJacobian",
    "qp_jacobian",
    "box_qp_jacobian",
    "signed_box_qp_jacobian",
    "qcqp_jacobian",
]


def _solve_multi(A: torch.Tensor, rhs: torch.Tensor, spd: bool = False) -> torch.Tensor:
    """Batched multi-right-hand-side solve, A (B, m, m), rhs (B, m, k) ->
    (B, m, k): one Cholesky (SPD) or one LU for all k columns."""
    if spd:
        return spd_cholesky_solve(A, rhs)
    return solve(A, rhs)


def _dl_dP(dl_dq: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """(B, n, n, n): dl_i/dP_jk = (dl_dq[i, j] l_k + l_j dl_dq[i, k]) / 2."""
    return 0.5 * (dl_dq[..., :, :, None] * l[..., None, None, :]
                  + l[..., None, :, None] * dl_dq[..., :, None, :])


def _restore(batched: bool, *arrays):
    out = tuple(None if a is None else (a if batched else a[0]) for a in arrays)
    return out if len(out) > 1 else out[0]


# --------------------------------------------------------------------------
# Non-negative QP
# --------------------------------------------------------------------------

class QPJacobian(NamedTuple):
    dl_dq: torch.Tensor              # (B, n, n)  [i, j] = dl_i / dq_j
    dl_dP: Optional[torch.Tensor]    # (B, n, n, n) or None


def qp_jacobian(
    P, q, *, l=None, config: Optional[SolverConfig] = None, include_dP: bool = False,
    device="cuda",
) -> QPJacobian:
    """Full sensitivity of the non-negative-QP solution l(P, q): K = fm P fm
    + I_active is SPD, so dl/dq = -fm K^{-1} fm through one Cholesky with n
    right-hand sides. ``l``: an already computed solution in q's layout
    (solved here by ``solve_qp`` when omitted); ``include_dP`` also
    materialises the (B, n, n, n) ``dl_dP``."""
    cfg = config if config is not None else QP_DEFAULTS
    c = canon_problem(P, q, device=_device(device))
    if l is None:
        l = solve_qp(P, q, config=cfg, device=device)
    lc = canon_like(l, c, "l", width=c.q.shape[-1])
    n = lc.shape[-1]
    gamma = kkt.qp_dual(c.P, c.q, lc, cfg)
    fm = (~(gamma < -cfg.act_eps)).to(lc.dtype)
    eye = torch.eye(n, dtype=lc.dtype, device=lc.device)
    K = kkt._as_dense(c.P) * fm[:, :, None] * fm[:, None, :] + eye * (1.0 - fm)[:, None, :]
    Kinv = _solve_multi(K, eye.expand(K.shape), spd=True)
    dl_dq = -Kinv * fm[:, :, None] * fm[:, None, :]
    dl_dP = _dl_dP(dl_dq, lc) if include_dP else None
    return QPJacobian(*_restore(c.batched, dl_dq, dl_dP))


# --------------------------------------------------------------------------
# Box QP / signed box QP (shared saddle-system core)
# --------------------------------------------------------------------------

class BoxJacobian(NamedTuple):
    dl_dq: torch.Tensor              # (B, n, n)
    dl_dl_min: torch.Tensor          # (B, n, n)
    dl_dl_max: torch.Tensor          # (B, n, n)
    dl_dP: Optional[torch.Tensor]    # (B, n, n, n) or None


def _coord_jacobian(ST, am, cn: int, n: int):
    """Solve S^T X = [0; I_n] once: (DL, DG) with DL (B, n, n) rows dl(e_i)
    and DG (B, n, cn) rows dgamma(e_i), masked."""
    Bsz = ST.shape[0]
    eye = torch.eye(n, dtype=ST.dtype, device=ST.device).expand(Bsz, n, n)
    rhs = torch.cat([torch.zeros(Bsz, cn, n, dtype=ST.dtype, device=ST.device), eye], dim=-2)
    X = _solve_multi(ST, rhs)                   # (B, cn + n, n)
    DL = X[:, cn:, :].mT                        # [i, j] = dl(e_i)_j
    DG = X[:, :cn, :].mT * am[:, None, :]
    return DL, DG


def _box_family(c, duals, act, J, Jt, lc, include_dP, n):
    """The box family's Jacobians from its duals, strict mask and selectors."""
    am = act.to(lc.dtype)
    cn = am.shape[-1]
    Bt = J * (duals.gamma * am)[:, None, :]
    eye_inact = torch.eye(cn, dtype=lc.dtype, device=lc.device) * (1.0 - am)[:, None, :]
    ST = torch.cat([torch.cat([eye_inact, Jt], dim=-1),
                    torch.cat([Bt, kkt._as_dense(c.P)], dim=-1)], dim=-2)
    DL, DG = _coord_jacobian(ST, am, cn, n)
    g_lo, g_hi = duals.gamma[:, :n], duals.gamma[:, n : 2 * n]
    dl_dq = -DL
    dl_dl_min = -g_lo[:, None, :] * DG[:, :, :n]
    dl_dl_max = g_hi[:, None, :] * DG[:, :, n : 2 * n]
    dl_dP = _dl_dP(dl_dq, lc) if include_dP else None
    return BoxJacobian(*_restore(c.batched, dl_dq, dl_dl_min, dl_dl_max, dl_dP))


def box_qp_jacobian(
    P, q, l_min, l_max, *, l=None, config: Optional[SolverConfig] = None,
    include_dP: bool = False, device="cuda",
) -> BoxJacobian:
    """Full sensitivity of the box-QP solution l(P, q, l_min, l_max): one
    LU of the (3n x 3n) transposed saddle system (``kkt.box_vjp``'s) against
    n right-hand sides."""
    cfg = config if config is not None else QP_DEFAULTS
    c = canon_problem(P, q, device=_device(device))
    n = c.q.shape[-1]
    lo = canon_like(l_min, c, "l_min", width=n)
    hi = canon_like(l_max, c, "l_max", width=n)
    if l is None:
        l = solve_box_qp(P, q, l_min, l_max, config=cfg, device=device)
    lc = canon_like(l, c, "l", width=n)
    duals = kkt.box_dual(c.P, c.q, lo, hi, lc, cfg)
    act = torch.cat([duals.act_lo, duals.act_hi], dim=-1) & (duals.gamma > cfg.act_eps)
    J = kkt._box_selector(act[:, :n], act[:, n:], lc.dtype)
    Jt = kkt._box_selector_T(act[:, :n], act[:, n:], lc.dtype)
    return _box_family(c, duals, act, J, Jt, lc, include_dP, n)


def signed_box_qp_jacobian(
    P, q, l_min, l_max, v, *, l=None, config: Optional[SolverConfig] = None,
    include_dP: bool = False, device="cuda",
) -> BoxJacobian:
    """Full sensitivity of the signed-box-QP solution: the box core with the
    3n-slot signed selector; v enters only through sign(v), so there is no
    dl_dv block."""
    cfg = config if config is not None else QP_DEFAULTS
    c = canon_problem(P, q, device=_device(device))
    n = c.q.shape[-1]
    lo = canon_like(l_min, c, "l_min", width=n)
    hi = canon_like(l_max, c, "l_max", width=n)
    vv = canon_like(v, c, "v", width=n)
    if l is None:
        l = solve_signed_box_qp(P, q, l_min, l_max, v, config=cfg, device=device)
    lc = canon_like(l, c, "l", width=n)
    duals = kkt.signed_box_dual(c.P, c.q, lo, hi, vv, lc, cfg)
    act = torch.cat([duals.act_lo, duals.act_hi, duals.act_sg], dim=-1) & (
        duals.gamma > cfg.act_eps)
    blocks = (act[:, :n], act[:, n : 2 * n], act[:, 2 * n :], torch.sign(vv))
    J, Jt = kkt._signed_selector(*blocks), kkt._signed_selector_T(*blocks)
    return _box_family(c, duals, act, J, Jt, lc, include_dP, n)


# --------------------------------------------------------------------------
# Friction-cone QCQP
# --------------------------------------------------------------------------

class QCQPJacobian(NamedTuple):
    dl_dq: torch.Tensor              # (B, n, n)
    dl_dl_n: torch.Tensor            # (B, n, nc)
    dl_dmu: torch.Tensor             # (B, n, nc)
    dl_dP: Optional[torch.Tensor]    # (B, n, n, n) or None


def qcqp_jacobian(
    P, q, l_n, mu, *, l=None, config: Optional[SolverConfig] = None,
    include_dP: bool = False, device="cuda",
) -> QCQPJacobian:
    """Full sensitivity of the friction-cone-QCQP solution l(P, q, l_n, mu),
    by the Schur complement (``kkt._qcqp_schur_vjp``'s): one Cholesky of D =
    P + blockdiag(2 gamma_i I_2) for n + nc right-hand sides, then one nc x
    nc system with n right-hand sides; the radius chain rule through E1 /
    E2."""
    cfg = config if config is not None else QCQP_DEFAULTS
    c = canon_problem(P, q, device=_device(device))
    n = c.q.shape[-1]
    nc = n // 2
    ln = canon_like(l_n, c, "l_n", width=nc)
    m = canon_like(mu, c, "mu", width=nc)
    if l is None:
        l = solve_qcqp(P, q, l_n, mu, config=cfg, device=device)
    lc = canon_like(l, c, "l", width=n)
    dtype = lc.dtype
    radius = ln * m
    duals = kkt.qcqp_dual(c.P, c.q, radius, lc, cfg)
    s, active = kkt.qcqp_strict_active(lc, radius, duals.gamma, cfg)
    am = active.to(dtype)
    Ct, Bt, D = kkt._qcqp_kkt_blocks(c.P, lc, duals.gamma, am, nc, n)
    sigma = s * am + (1.0 - am)
    # D^{-1} against [I_n | B^T] in one Cholesky (n + nc columns)
    eye = torch.eye(n, dtype=dtype, device=lc.device).expand(lc.shape[0], n, n)
    X = _solve_multi(D, torch.cat([eye, Bt], dim=-1), spd=True)
    Y, W = X[..., :n], X[..., n:]               # D^{-1}, D^{-1} B^T
    M = torch.diag_embed(sigma) - Ct @ W
    DG_cols = _solve_multi(M, -(Ct @ Y)) * am[:, :, None]
    DL = (Y - W @ DG_cols).mT                   # [i, j] = dl(e_i)_j
    DG = DG_cols.mT                             # [i, c] = dgamma(e_i)_c
    e1, e2 = kkt.qcqp_radius_factors(ln, m, duals.gamma)
    dl_dq = -DL
    dl_dP = _dl_dP(dl_dq, lc) if include_dP else None
    return QCQPJacobian(*_restore(c.batched, dl_dq, e2[:, None, :] * DG, e1[:, None, :] * DG,
                                  dl_dP))
