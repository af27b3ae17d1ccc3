"""Implicit differentiation of the KKT conditions (port of diff/kkt.py): dual
recovery and the adjoint (VJP) solves of the four problem classes.

Sign conventions as in the JAX package: stationarity P l + q + J^T gamma = 0
with gamma >= 0 the standard multipliers of constraints c(l) <= 0, except
the plain QP's recovery, which returns the reference's NEGATED multiplier
gamma = -(Pl+q) (its activity test is gamma < -act_eps).

The QP family (non-negative, box, signed box): every constraint touches one
coordinate, so the differentiated KKT system decouples. Two routes, as in
the JAX package, chosen by ``_use_fused_kernel``:

  * the fused backward K4 (``kernels/coord_bwd_cuda.py``), dual recovery
    plus the masked SPD solve in one launch on a CUDA tensor, its plain
    version on a CPU tensor: dense float32 P within K4's bound (n <= 168)
    and no duals given, or ``backend='pallas'``;
  * the generic route otherwise (float64, ``backend='xla'``, past K4's
    bound, or ``box_vjp(..., duals=)``): the assembled fixed-shape system,
    solved by ``_solve_direct``: K = fm P fm + diag(am) for the QP (SPD),
    and S^T x = [0; g] with S^T = [[I_inact, J^T], [J diag(gamma am), P]]
    over all 2n or 3n slots for the box kinds (``_qp_assembled_vjp``,
    ``_signed_box_assembled_vjp``). Where two slots of one coordinate are
    strictly active (a signed box with l_min = 0 and v < 0, whose sign
    constraint repeats the lower bound) it is singular, and K4 splits the
    residual at minimal norm instead, as the JAX kernel does.

The friction-cone QCQP:

    min 1/2 l^T P l + q^T l   s.t.  ||l_(i)|| <= r_i = mu_i l_n_i

Contact i owns coordinates (2i, 2i+1). ``qcqp_vjp`` solves the transposed
differentiated-KKT system for an upstream cotangent g, in the unknowns
(dgamma (nc), dl (2nc)), squared-slack form s_i = ||l_(i)||^2 - r_i^2:

    [[diag(s) + I_inact,  C^T],   (dgamma, dl) = (0, g)
     [B^T,                D  ]]

with C (n, nc) column i = 2 l_(i) on the strictly active contacts, B^T =
C diag(gamma), D = P + blockdiag(2 gamma_i I_2).

Two routes, as in the JAX package, chosen by ``_use_fused_kernel``:

  * the fused backward K2 (``kernels/qcqp_bwd_cuda.py``), dual recovery
    plus the Schur-complement solve in one launch on a CUDA tensor, its
    plain version on a CPU tensor: dense float32 P within K2's bound (n <=
    150) and no duals given, or ``backend='pallas'``;
  * the generic route otherwise, with the duals given or recovered by
    ``qcqp_dual``: up to nc + n = 88 the assembled system through
    ``_solve_direct``; above it ``_qcqp_schur_vjp``, the Schur complement:
    kernel K6 (``qcqp_kkt_bwd_cuda``) in float32 within its bound (n <=
    150), the Newton-Schulz inverse of D (``_spd_inverse_f32``) in float32
    past it, a Cholesky of D in float64.

``_solve_direct`` is the generic route's solve: kernel K5
(``kernels/qr_solve_cuda.py``, batched Householder QR) for a float32 CUDA
system of m <= 88 or wherever ``cfg.backend == 'pallas'``; else, for an SPD
system, the Newton-Schulz inverse in float32 and a batched Cholesky in any
other dtype; else ``torch.linalg.solve``.

The fused kernels' bounds are the card's own (their shared memory and
launch plans), not the JAX package's n <= 64, which is the TPU's VMEM.

Under a CUDA graph capture (``utils/staging.py``) every route records as it
runs: the fused kernels, K5 and K6, and the generic route's other solves,
whose host reads have device-side forms there (``ops/linalg.py``: the
Newton-Schulz loop a WHILE node, the Cholesky and the LU their ``_ex``
forms).

Diagonal P (B, n), as in the JAX package, launches no kernel: without duals
every class's adjoint is closed form, elementwise (``_diag_coord_adjoint``
for the QP family; for the QCQP a diagonal D and a diagonal Schur
complement). With the duals given (``box_vjp(duals=)``, ``qcqp_vjp(duals=)``)
it takes the generic route on ``_as_dense(P)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SolverConfig
from ..kernels import coord_bwd_cuda, qcqp_bwd_cuda
from ..kernels.coord_bwd_cuda import (
    KIND_BOX,
    KIND_QP,
    KIND_SIGNED_BOX,
    coord_kkt_bwd_fused_cuda,
)
from ..kernels.qcqp_bwd_cuda import qcqp_kkt_bwd_cuda, qcqp_kkt_bwd_fused_cuda
from ..kernels.qr_solve_cuda import qr_solve_cuda
from ..ops.linalg import newton_schulz_inverse_adaptive, solve, spd_cholesky_solve

__all__ = [
    "qp_dual",
    "qp_vjp",
    "BoxDuals",
    "BoxVJP",
    "box_dual",
    "box_vjp",
    "SignedBoxDuals",
    "SignedBoxVJP",
    "signed_box_dual",
    "signed_box_vjp",
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


def _as_dense(P: torch.Tensor) -> torch.Tensor:
    """A diagonal-P batch (B, n) as dense (B, n, n) for KKT assembly; dense P
    as it is."""
    return torch.diag_embed(P) if P.ndim == 2 else P


def _pl_plus_q(P: torch.Tensor, l: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if P.ndim == 2:
        return P * l + q
    return torch.sum(P * l[:, None, :], dim=-1) + q


def _diag_coord_adjoint(P: torch.Tensor, g: torch.Tensor, coeffs: list):
    """Closed-form KKT adjoint for diagonal P with coordinate-wise
    constraints (QP, box, signed box): a strictly active coordinate pins
    dl_i = 0, a free one solves P_i dl_i = g_i, and an active row splits its
    residual g_i at minimal norm across its slots' coefficients.

    ``coeffs``: per constraint block, the B-block coefficient (B, n), already
    zero at slots that are not strictly active. Returns (dl, [dgamma per
    block])."""
    am = torch.clamp_max(sum((c != 0).to(g.dtype) for c in coeffs), 1.0)
    dl = (1.0 - am) * g / torch.where(P > 0, P, torch.ones_like(P)) * (P > 0)
    resid = g * am
    den = torch.clamp_min(sum(c * c for c in coeffs), torch.finfo(g.dtype).tiny)
    return dl, [c * resid / den for c in coeffs]


def _kernel_args(*xs: Optional[torch.Tensor]):
    """The fused kernels' inputs, contiguous float32; None stays None. The
    kernels compute in float32 whatever the caller's dtype, as the JAX
    package's kernel path does: 'auto' sends them float32 only, and
    ``backend='pallas'`` on other inputs gets float32 arithmetic, cast back
    by ``_kernel_out``."""
    return tuple(None if x is None else x.to(torch.float32).contiguous() for x in xs)


def _kernel_out(dtype: torch.dtype, *outs: torch.Tensor) -> tuple:
    """A fused kernel's outputs in the caller's dtype."""
    return tuple(x.to(dtype) for x in outs)


def _use_fused_kernel(P: torch.Tensor, l: torch.Tensor, cfg: SolverConfig, fits) -> bool:
    """Backward dispatch, the counterpart of the JAX package's
    ``kkt.py::_use_fused_kernel``, decided from shapes, dtype and config
    alone: ``backend='pallas'`` takes the fused kernel (K2 or K4, whose
    ``fits(n)`` is passed); 'auto' takes it iff P is dense, l is float32
    and the kernel launches at this n on a Hopper card (K2: n <= 150, K4:
    n <= 168); anything else takes the generic route. Like the forward rule
    it does not depend on the device: a CPU tensor runs the kernel's plain
    version where a CUDA tensor would launch it."""
    if P.ndim != 3:
        return False
    if cfg.backend == "pallas":
        return True
    return cfg.backend == "auto" and l.dtype == torch.float32 and fits(l.shape[-1])


def _spd_inverse_f32(A: torch.Tensor) -> torch.Tensor:
    """Newton-Schulz inverse of a batch of float32 SPD systems (port of the
    JAX package's ``_spd_inverse_f32``): from X0 = I / ||A||_inf (the max
    absolute row sum, a rigorous bound on lambda_max: an underestimate makes
    NS diverge) with the measured stopping rule of
    ``newton_schulz_inverse_adaptive`` (at most 30 cubic steps)."""
    n = A.shape[-1]
    hi = torch.clamp_min(torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1),
                         torch.finfo(A.dtype).tiny)
    x0 = (1.0 / hi)[:, None, None] * torch.eye(n, dtype=A.dtype, device=A.device)
    return newton_schulz_inverse_adaptive(A, x0)


# The largest assembled system the automatic dispatch sends to K5, and the
# nc + n above which qcqp_vjp(duals=) takes the Schur route: the JAX
# package's bound (its QR kernel's VMEM working set at the 128-lane tile),
# kept so that both packages take the same route at every shape. The card
# holds more (K5's [A | b] fits a block's shared memory up to m ~ 240); a
# move of the bound waits for card timings of both routes.
QR_MAX_M = 88


def _solve_direct(
    A: torch.Tensor, rhs: torch.Tensor, cfg: SolverConfig, spd: bool = False
) -> torch.Tensor:
    """Solve A x = rhs batched; A (B, m, m), rhs (B, m) (port of
    ``_solve_direct``; a CUDA tensor plays the TPU's part):

      * ``cfg.backend == 'pallas'``: kernel K5 (``qr_solve_cuda``) at any m,
        in float32 and cast back: on a CUDA tensor the kernel, which raises
        where a block's shared memory cannot hold m (as the JAX package's
        explicit ``pallas`` fails loudly); on a CPU tensor its plain version
        (the JAX package runs the kernel in interpret mode off the TPU);
      * a float32 CUDA tensor with ``backend='auto'`` and m <= ``QR_MAX_M``:
        K5;
      * anything else: when ``spd`` (A symmetric positive definite) the
        Newton-Schulz inverse (``_spd_inverse_f32``) in float32 and
        ``spd_cholesky_solve`` in any other dtype, as the JAX package; else
        ``ops.linalg.solve`` (``torch.linalg.solve``, the JAX package's
        ``jnp.linalg.solve``).
    """
    use_kernel = cfg.backend == "pallas" or (
        cfg.backend == "auto"
        and A.device.type == "cuda"
        and rhs.dtype == torch.float32
        and A.shape[-1] <= QR_MAX_M
    )
    if use_kernel:
        f32 = torch.float32
        return qr_solve_cuda(A.to(f32).contiguous(), rhs.to(f32).contiguous()).to(rhs.dtype)
    if spd:
        if rhs.dtype == torch.float32:
            return (_spd_inverse_f32(A) @ rhs[..., None])[..., 0]
        return spd_cholesky_solve(A, rhs[..., None])[..., 0]
    return solve(A, rhs[..., None])[..., 0]


# --------------------------------------------------------------------------
# Non-negative QP:  min 1/2 l^T P l + q^T l  s.t.  l >= 0
# --------------------------------------------------------------------------

def qp_dual(
    P: torch.Tensor, q: torch.Tensor, l: torch.Tensor, cfg: SolverConfig, eps=None
) -> torch.Tensor:
    """Dual recovery, reference convention: gamma = -(Pl+q), zeroed where
    l > eps (so gamma <= 0 at active constraints). ``eps`` (a scalar or a
    broadcastable tensor) overrides ``cfg.eps``."""
    e = cfg.eps if eps is None else eps
    return torch.where(l > e, torch.zeros_like(l), -_pl_plus_q(P, l, q))


def _qp_kkt_system(P, q, l, g, cfg: SolverConfig):
    """(K, g fm, fm) with K = fm P fm + diag(am), am = gamma < -act_eps:
    symmetric positive definite, its active rows decoupled unit rows."""
    am = (qp_dual(P, q, l, cfg) < -cfg.act_eps).to(l.dtype)
    fm = 1.0 - am
    K = P * fm[:, :, None] * fm[:, None, :] + torch.diag_embed(am)
    return K, g * fm, fm


def _qp_assembled_vjp(P, q, l, g, cfg: SolverConfig) -> torch.Tensor:
    """K x = g fm assembled and solved by ``_solve_direct`` (K SPD); dl =
    x fm: the JAX package's generic QP route."""
    K, rhs, fm = _qp_kkt_system(P, q, l, g, cfg)
    return _solve_direct(K, rhs, cfg, spd=True) * fm


def qp_vjp(
    P: torch.Tensor, q: torch.Tensor, l: torch.Tensor, g: torch.Tensor, cfg: SolverConfig
) -> torch.Tensor:
    """Adjoint dl of the QP solution map (zeros on the strictly active set):
    for diagonal P the closed form (``_diag_coord_adjoint``); K4
    (``coord_kkt_bwd_fused_cuda``) where ``_use_fused_kernel`` says so; else
    the assembled SPD system (``_qp_assembled_vjp``)."""
    if P.ndim == 2:
        am = (qp_dual(P, q, l, cfg) < -cfg.act_eps).to(l.dtype)
        return _diag_coord_adjoint(P, g, [am])[0]
    if not _use_fused_kernel(P, l, cfg, coord_bwd_cuda.fits):
        return _qp_assembled_vjp(P, q, l, g, cfg)
    (dl,) = coord_kkt_bwd_fused_cuda(
        *_kernel_args(P, q, l, g, None, None, None), KIND_QP, cfg.eps, cfg.act_eps,
    )
    return dl.to(l.dtype)


# --------------------------------------------------------------------------
# Box QP:  min 1/2 l^T P l + q^T l  s.t.  l_min <= l <= l_max
# --------------------------------------------------------------------------

class BoxDuals(NamedTuple):
    gamma: torch.Tensor      # (B, 2n): [gamma_lo | gamma_hi], zeros at inactive slots
    act_lo: torch.Tensor     # (B, n) bool
    act_hi: torch.Tensor     # (B, n) bool


class BoxVJP(NamedTuple):
    dl: torch.Tensor         # (B, n)
    dgamma: torch.Tensor     # (B, 2n)
    gamma: torch.Tensor      # (B, 2n)


def _box_activity(l, l_min, l_max, eps):
    """Lower active iff l - l_min <= eps, upper iff l - l_max >= -eps."""
    return (l - l_min) <= eps, (l - l_max) >= -eps


def _box_selector(act_lo: torch.Tensor, act_hi: torch.Tensor, dtype) -> torch.Tensor:
    """Masked signed selector J (B, n, 2n): column i = -e_i if lower slot i
    is active, column n + i = +e_i if upper slot i is, zero otherwise."""
    eye = torch.eye(act_lo.shape[-1], dtype=dtype, device=act_lo.device)
    return torch.cat(
        [-eye * act_lo.to(dtype)[:, None, :], eye * act_hi.to(dtype)[:, None, :]], dim=-1
    )


def _box_selector_T(act_lo: torch.Tensor, act_hi: torch.Tensor, dtype) -> torch.Tensor:
    """J^T (B, 2n, n), assembled directly (the masks on the row side)."""
    eye = torch.eye(act_lo.shape[-1], dtype=dtype, device=act_lo.device)
    return torch.cat(
        [-eye * act_lo.to(dtype)[:, :, None], eye * act_hi.to(dtype)[:, :, None]], dim=-2
    )


def box_dual(P, q, l_min, l_max, l, cfg: SolverConfig, eps=None) -> BoxDuals:
    """Minimal-norm least-squares duals of J gamma = -(Pl+q), closed form per
    coordinate (J's rows touch disjoint columns, so J J^T is diagonal):
    gamma_slot = coef * rhs / max(#active, 1). ``eps`` overrides ``cfg.eps``."""
    act_lo, act_hi = _box_activity(l, l_min, l_max, cfg.eps if eps is None else eps)
    rhs = -_pl_plus_q(P, l, q)
    alo, ahi = act_lo.to(l.dtype), act_hi.to(l.dtype)
    denom = torch.clamp_min(alo + ahi, 1.0)
    gamma = torch.cat([-alo * rhs / denom, ahi * rhs / denom], dim=-1)
    return BoxDuals(gamma=gamma, act_lo=act_lo, act_hi=act_hi)


def _selector_kkt_system(P, g, J, Jt, gamma, am):
    """(S^T, [0; g]) with S^T = [[I_inact, J^T], [J diag(gamma am), P]]."""
    B, m = am.shape
    top = torch.cat([torch.diag_embed(1.0 - am), Jt], dim=-1)
    bot = torch.cat([J * (gamma * am)[:, None, :], P], dim=-1)
    rhs = torch.cat([torch.zeros(B, m, dtype=g.dtype, device=g.device), g], dim=-1)
    return torch.cat([top, bot], dim=-2), rhs


def _box_kkt_system(P, l, g, duals: BoxDuals, cfg: SolverConfig):
    """(S^T, rhs, am) of the box QP's adjoint; am the (B, 2n) strict mask."""
    n = l.shape[-1]
    act = torch.cat([duals.act_lo, duals.act_hi], dim=-1) & (duals.gamma > cfg.act_eps)
    am = act.to(l.dtype)
    J = _box_selector(act[:, :n], act[:, n:], l.dtype)
    Jt = _box_selector_T(act[:, :n], act[:, n:], l.dtype)
    return (*_selector_kkt_system(P, g, J, Jt, duals.gamma, am), am)


def box_vjp(
    P: torch.Tensor,
    q: torch.Tensor,
    l_min: torch.Tensor,
    l_max: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    cfg: SolverConfig,
    duals: Optional[BoxDuals] = None,
) -> BoxVJP:
    """Adjoint of the box-QP solution map: (dl, dgamma, gamma) for the
    cotangent g. Without ``duals``: for diagonal P the closed form
    (``_diag_coord_adjoint``), else, where ``_use_fused_kernel`` says so, K4,
    which recovers the duals itself. Otherwise the assembled system of the
    given duals (or of ``box_dual``'s), solved by ``_solve_direct``."""
    if duals is None and P.ndim == 2:
        d = box_dual(P, q, l_min, l_max, l, cfg)
        n = l.shape[-1]
        g_lo, g_hi = d.gamma[:, :n], d.gamma[:, n:]
        am_lo = (d.act_lo & (g_lo > cfg.act_eps)).to(l.dtype)
        am_hi = (d.act_hi & (g_hi > cfg.act_eps)).to(l.dtype)
        dl, dg = _diag_coord_adjoint(P, g, [-g_lo * am_lo, g_hi * am_hi])
        return BoxVJP(dl=dl, dgamma=torch.cat(dg, dim=-1), gamma=d.gamma)
    if duals is None and _use_fused_kernel(P, l, cfg, coord_bwd_cuda.fits):
        out = coord_kkt_bwd_fused_cuda(
            *_kernel_args(P, q, l, g, l_min, l_max, None), KIND_BOX, cfg.eps, cfg.act_eps,
        )
        return BoxVJP(*_kernel_out(l.dtype, *out))
    if duals is None:
        duals = box_dual(P, q, l_min, l_max, l, cfg)
    ST, rhs, am = _box_kkt_system(_as_dense(P), l, g, duals, cfg)
    x = _solve_direct(ST, rhs, cfg)
    m = am.shape[-1]
    return BoxVJP(dl=x[:, m:], dgamma=x[:, :m] * am, gamma=duals.gamma)


# --------------------------------------------------------------------------
# Signed box QP: the box plus sign(v) * l <= 0
# --------------------------------------------------------------------------

class SignedBoxDuals(NamedTuple):
    gamma: torch.Tensor      # (B, 3n): [lo | hi | sign]
    act_lo: torch.Tensor
    act_hi: torch.Tensor
    act_sg: torch.Tensor


class SignedBoxVJP(NamedTuple):
    dl: torch.Tensor
    dgamma: torch.Tensor     # (B, 3n)
    gamma: torch.Tensor      # (B, 3n)


def _signed_selector(act_lo, act_hi, act_sg, v_sign) -> torch.Tensor:
    """J (B, n, 3n): the box selector plus third block column i = v_i e_i
    when the sign constraint i is active."""
    dtype = v_sign.dtype
    eye = torch.eye(act_lo.shape[-1], dtype=dtype, device=v_sign.device)
    return torch.cat([
        -eye * act_lo.to(dtype)[:, None, :],
        eye * act_hi.to(dtype)[:, None, :],
        eye * (act_sg.to(dtype) * v_sign)[:, None, :],
    ], dim=-1)


def _signed_selector_T(act_lo, act_hi, act_sg, v_sign) -> torch.Tensor:
    """J^T (B, 3n, n), assembled directly (the masks on the row side)."""
    dtype = v_sign.dtype
    eye = torch.eye(act_lo.shape[-1], dtype=dtype, device=v_sign.device)
    return torch.cat([
        -eye * act_lo.to(dtype)[:, :, None],
        eye * act_hi.to(dtype)[:, :, None],
        eye * (act_sg.to(dtype) * v_sign)[:, :, None],
    ], dim=-2)


def signed_box_dual(P, q, l_min, l_max, v, l, cfg: SolverConfig, eps=None) -> SignedBoxDuals:
    """3n-dual recovery: the sign constraint is active iff sign(v) l >= -eps.
    J's row i touches columns (i, n + i, 2n + i) with entries (-1, +1, v_i),
    v_i in {-1, 0, +1}, so the minimal-norm dual is closed form per
    coordinate. ``eps`` overrides ``cfg.eps``."""
    e = cfg.eps if eps is None else eps
    v_sign = torch.sign(v)
    act_lo, act_hi = _box_activity(l, l_min, l_max, e)
    act_sg = v_sign * l >= -e
    rhs = -_pl_plus_q(P, l, q)
    alo, ahi, asg = (a.to(l.dtype) for a in (act_lo, act_hi, act_sg))
    denom = torch.clamp_min(alo + ahi + asg * v_sign * v_sign, 1.0)
    gamma = torch.cat([-alo * rhs / denom, ahi * rhs / denom, asg * v_sign * rhs / denom], dim=-1)
    return SignedBoxDuals(gamma, act_lo, act_hi, act_sg)


def _signed_box_kkt_system(P, q, l_min, l_max, v, l, g, cfg: SolverConfig):
    """(S^T, rhs, am, gamma) of the signed-box QP's adjoint; am (B, 3n)."""
    n = l.shape[-1]
    duals = signed_box_dual(P, q, l_min, l_max, v, l, cfg)
    act = torch.cat([duals.act_lo, duals.act_hi, duals.act_sg], dim=-1) & (
        duals.gamma > cfg.act_eps
    )
    am = act.to(l.dtype)
    blocks = (act[:, :n], act[:, n : 2 * n], act[:, 2 * n :], torch.sign(v))
    J, Jt = _signed_selector(*blocks), _signed_selector_T(*blocks)
    return (*_selector_kkt_system(P, g, J, Jt, duals.gamma, am), am, duals.gamma)


def _signed_box_assembled_vjp(P, q, l_min, l_max, v, l, g, cfg: SolverConfig) -> SignedBoxVJP:
    """S^T x = [0; g] assembled and solved by ``_solve_direct``: the JAX
    package's generic signed-box route."""
    ST, rhs, am, gamma = _signed_box_kkt_system(P, q, l_min, l_max, v, l, g, cfg)
    x = _solve_direct(ST, rhs, cfg)
    m = am.shape[-1]
    return SignedBoxVJP(dl=x[:, m:], dgamma=x[:, :m] * am, gamma=gamma)


def signed_box_vjp(
    P: torch.Tensor,
    q: torch.Tensor,
    l_min: torch.Tensor,
    l_max: torch.Tensor,
    v: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    cfg: SolverConfig,
) -> SignedBoxVJP:
    """Adjoint of the signed-box solution map, the sign constraint's dual
    included: for diagonal P the closed form (``_diag_coord_adjoint``); K4
    where ``_use_fused_kernel`` says so; else the assembled system
    (``_signed_box_assembled_vjp``). v enters only through sign(v)."""
    if P.ndim == 2:
        d = signed_box_dual(P, q, l_min, l_max, v, l, cfg)
        n = l.shape[-1]
        g_lo, g_hi, g_sg = d.gamma[:, :n], d.gamma[:, n : 2 * n], d.gamma[:, 2 * n :]
        am_lo, am_hi, am_sg = ((a & (x > cfg.act_eps)).to(l.dtype) for a, x in
                               ((d.act_lo, g_lo), (d.act_hi, g_hi), (d.act_sg, g_sg)))
        dl, dg = _diag_coord_adjoint(
            P, g, [-g_lo * am_lo, g_hi * am_hi, torch.sign(v) * g_sg * am_sg])
        return SignedBoxVJP(dl=dl, dgamma=torch.cat(dg, dim=-1), gamma=d.gamma)
    if not _use_fused_kernel(P, l, cfg, coord_bwd_cuda.fits):
        return _signed_box_assembled_vjp(P, q, l_min, l_max, v, l, g, cfg)
    out = coord_kkt_bwd_fused_cuda(
        *_kernel_args(P, q, l, g, l_min, l_max, torch.sign(v)),
        KIND_SIGNED_BOX, cfg.eps, cfg.act_eps,
    )
    return SignedBoxVJP(*_kernel_out(l.dtype, *out))


# --------------------------------------------------------------------------
# Friction-cone QCQP
# --------------------------------------------------------------------------

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
    D = _as_dense(P) + torch.diag_embed(2.0 * torch.repeat_interleave(gamma, 2, dim=-1))
    return Ct, Bt, D


def _qcqp_kkt_system(P, l, g, gamma, s, am):
    """(S^T, [0; g]) of the QCQP's transposed system, assembled:
    S^T = [[diag(s am + (1 - am)), C^T], [B^T, D]] from the raw duals gamma,
    the squared slacks s and the strict mask am (0 / 1 in l's dtype)."""
    B, n = l.shape
    nc = n // 2
    Ct, Bt, D = _qcqp_kkt_blocks(P, l, gamma, am, nc, n)
    top = torch.cat([torch.diag_embed(s * am + (1.0 - am)), Ct], dim=-1)
    ST = torch.cat([top, torch.cat([Bt, D], dim=-1)], dim=-2)
    rhs = torch.cat([torch.zeros(B, nc, dtype=l.dtype, device=l.device), g], dim=-1)
    return ST, rhs


def _qcqp_assembled_vjp(P, l, g, gamma, s, am, cfg: SolverConfig) -> QCQPVJP:
    """S^T x = [0; g] assembled and solved by ``_solve_direct``."""
    nc = l.shape[-1] // 2
    x = _solve_direct(*_qcqp_kkt_system(P, l, g, gamma, s, am), cfg)
    return QCQPVJP(dl=x[:, nc:], dgamma=x[:, :nc] * am, gamma=gamma)


def _qcqp_schur_vjp(P, l, g, s, am, gamma) -> QCQPVJP:
    """Schur-complement form of the transposed system (port of
    ``_qcqp_schur_vjp``): eliminating dl,

        (Sigma - C^T D^{-1} B^T) dgamma = -C^T D^{-1} g,   dl = D^{-1} (g - B^T dgamma),

    with D = P + blockdiag(2 gamma_i I_2) SPD: one factor of D, nc + 1
    solves and an nc x nc system, never the (nc + n)^3 solve. In float32
    within K6's bound (n <= 150): kernel K6 (``qcqp_kkt_bwd_cuda``; its
    plain version on a CPU tensor). Otherwise the JAX package's route: D^{-1}
    by its Newton-Schulz inverse (``_spd_inverse_f32``) in float32 or a
    batched Cholesky in any other dtype, and an LU (``ops.linalg.solve``) of
    the nc x nc system."""
    n = l.shape[-1]
    if l.dtype == torch.float32 and qcqp_bwd_cuda.fits(n):
        dgamma, dl = qcqp_kkt_bwd_cuda(*_kernel_args(_as_dense(P), l, g, gamma, s, am))
        return QCQPVJP(dl=dl, dgamma=dgamma, gamma=gamma)
    Ct, Bt, D = _qcqp_kkt_blocks(P, l, gamma, am, n // 2, n)
    rhs = torch.cat([g[..., None], Bt], dim=-1)
    X = _spd_inverse_f32(D) @ rhs if l.dtype == torch.float32 else spd_cholesky_solve(D, rhs)
    y, W = X[..., 0], X[..., 1:]                # D^{-1} g, D^{-1} B^T
    M = torch.diag_embed(s * am + (1.0 - am)) - Ct @ W
    dgamma = solve(M, -(Ct @ y[..., None]))[..., 0] * am
    return QCQPVJP(dl=y - (W @ dgamma[..., None])[..., 0], dgamma=dgamma, gamma=gamma)


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
    cotangent g. P (B, n, n) dense or (B, n) diagonal; q, l, g (B, n);
    radius (B, nc).

    Without ``duals``: for diagonal P the closed form (``_qcqp_diag_vjp``);
    else, where ``_use_fused_kernel`` says so, K2
    (``qcqp_kkt_bwd_fused_cuda``), which recovers the duals itself, with
    the 8-ulp slack floor of l's dtype. Otherwise the generic route, with
    the given duals or ``qcqp_dual``'s: above nc + n = ``QR_MAX_M`` the
    Schur complement (``_qcqp_schur_vjp``), else the assembled (nc + n)
    system through ``_solve_direct`` (K5 on a float32 CUDA tensor)."""
    if duals is None and P.ndim == 2:
        return _qcqp_diag_vjp(P, q, radius, l, g, cfg)
    if duals is None and _use_fused_kernel(P, l, cfg, qcqp_bwd_cuda.fits):
        dgamma, dl, gamma = _kernel_out(l.dtype, *qcqp_kkt_bwd_fused_cuda(
            *_kernel_args(P, q, l, g, radius), cfg.eps, cfg.act_eps,
            8.0 * torch.finfo(torch.float32).eps,
        ))
        return QCQPVJP(dl=dl, dgamma=dgamma, gamma=gamma)
    if duals is None:
        duals = qcqp_dual(P, q, radius, l, cfg)
    n = l.shape[-1]
    nc = n // 2
    s, active = qcqp_strict_active(l, radius, duals.gamma, cfg)
    am = active.to(l.dtype)
    if nc + n > QR_MAX_M:
        return _qcqp_schur_vjp(P, l, g, s, am, duals.gamma)
    return _qcqp_assembled_vjp(P, l, g, duals.gamma, s, am, cfg)


def _qcqp_diag_vjp(P, q, radius, l, g, cfg: SolverConfig) -> QCQPVJP:
    """The QCQP's adjoint for diagonal P, closed form: D = diag(P) + 2 gamma
    is diagonal and C's columns are disjoint per contact, so the Schur
    complement M = sigma - C^T D^{-1} B^T is diagonal too. Divisions by D
    and M are guarded at the dtype's smallest normal number."""
    B, n = l.shape
    nc = n // 2
    duals = qcqp_dual(P, q, radius, l, cfg)
    s, active = qcqp_strict_active(l, radius, duals.gamma, cfg)
    am = active.to(l.dtype)
    tiny = torch.finfo(l.dtype).tiny
    d = P + 2.0 * torch.repeat_interleave(duals.gamma, 2, dim=-1)
    d = torch.where(d.abs() > tiny, d, torch.full_like(d, tiny))
    wg = g / d
    pts = l.reshape(B, nc, 2)
    ctd_c = 4.0 * torch.sum(pts * pts * (1.0 / d).reshape(B, nc, 2), dim=-1)  # (C^T D^-1 C)_cc
    M = s * am + (1.0 - am) - ctd_c * duals.gamma * am
    y = -2.0 * am * torch.sum(pts * wg.reshape(B, nc, 2), dim=-1)
    dgamma = am * y / torch.where(M.abs() > tiny, M, torch.full_like(M, tiny))
    dl = wg - (2.0 * l / d) * torch.repeat_interleave(duals.gamma * am * dgamma, 2, dim=-1)
    return QCQPVJP(dl=dl, dgamma=dgamma, gamma=duals.gamma)


def qcqp_radius_factors(
    l_n: torch.Tensor, mu: torch.Tensor, gamma: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain-rule diagonals as vectors: e1 = 2 gamma l_n^2 mu (the grad_mu
    factor), e2 = 2 gamma l_n mu^2 (the grad_l_n factor)."""
    e1 = 2.0 * gamma * l_n * l_n * mu
    e2 = 2.0 * gamma * l_n * mu * mu
    return e1, e2
