"""Dual recovery and the raw KKT-derivative solves of the four problem classes
(port of duals.py).

  * ``recover_*_duals``: the multipliers of an already solved problem, in the
    standard convention (constraints c(l) <= 0, P l + q + J^T gamma = 0,
    gamma >= 0); negate ``recover_qp_duals`` for the reference's
    ``dualFromPrimalQP``. Activity thresholds are scale-aware by default
    (``act_floor``), as a float32 solution needs; ``act_floor=0`` keeps the
    reference's absolute ``cfg.eps``. The QCQP's multipliers are in the
    squared-slack convention c_i = ||l_(i)||^2 - r_i^2.
  * ``*_derivatives``: the transposed differentiated-KKT solve against a
    cotangent grad_l (the reference's ``solveDerivatives*``), unpacked per
    constraint block, through ``diff/kkt.py``'s adjoints and their dispatch:
    the fused kernels K4 (QP family) and K2 (QCQP) for float32 within their
    bounds, the generic route otherwise. Gradients assemble
    from them as grad_P = -dl l^T, grad_q = -dl, grad_l_min = -gamma_lo
    dgamma_lo, grad_l_max = gamma_hi dgamma_hi, grad_l_n = e2 dgamma,
    grad_mu = e1 dgamma.

All take the JAX package's layouts and ``device``: the card by default
(raising without CUDA), ``device="cpu"`` for the plain path. Everything runs
in the input dtype on either device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .api import _device
from .config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig
from .diff import kkt
from .utils.shapes import Canon, canon_like, canon_problem

__all__ = [
    "recover_qp_duals",
    "recover_box_qp_duals",
    "recover_signed_box_qp_duals",
    "recover_qcqp_duals",
    "qp_derivatives",
    "box_qp_derivatives",
    "signed_box_qp_derivatives",
    "qcqp_derivatives",
    "BoxDualRecovery",
    "SignedBoxDualRecovery",
    "BoxQPDerivatives",
    "SignedBoxQPDerivatives",
    "QCQPDerivatives",
]


def _canon(P, q, base, config, device) -> tuple[Canon, SolverConfig]:
    cfg = config if config is not None else base
    return canon_problem(P, q, device=_device(device)), cfg


def _vecs(c: Canon, width: int, **xs) -> list[torch.Tensor]:
    """Auxiliary vectors in the problem's batched layout, in keyword order."""
    return [canon_like(x, c, name, width=width) for name, x in xs.items()]


def _act_eps(l: torch.Tensor, cfg: SolverConfig, act_floor: float):
    """Per-problem activity threshold max(cfg.eps, act_floor * eps_mach *
    max(1, ||l||_inf)) as a (B, 1) tensor (it broadcasts into every activity
    test); ``act_floor`` <= 0 gives the reference's absolute ``cfg.eps``."""
    if act_floor <= 0.0:
        return cfg.eps
    scale = torch.clamp_min(l.abs().amax(dim=-1, keepdim=True), 1.0)
    return torch.clamp_min(act_floor * torch.finfo(l.dtype).eps * scale, cfg.eps)


# --------------------------------------------------------------------------
# dual recovery
# --------------------------------------------------------------------------

def recover_qp_duals(
    P, q, l, *, config: Optional[SolverConfig] = None, act_floor: float = 100.0,
    device="cuda",
) -> torch.Tensor:
    """Multipliers gamma >= 0 of min 1/2 l'Pl + q'l s.t. l >= 0 at the
    solution l: gamma_i = (Pl+q)_i at active slots, 0 elsewhere."""
    c, cfg = _canon(P, q, QP_DEFAULTS, config, device)
    (l_,) = _vecs(c, c.q.shape[-1], l=l)
    return c.restore(-kkt.qp_dual(c.P, c.q, l_, cfg, eps=_act_eps(l_, cfg, act_floor)))


class BoxDualRecovery(NamedTuple):
    gamma_lo: torch.Tensor   # (..., n) multipliers of l_min - l <= 0
    gamma_hi: torch.Tensor   # (..., n) multipliers of l - l_max <= 0


def recover_box_qp_duals(
    P, q, l_min, l_max, l, *, config: Optional[SolverConfig] = None,
    act_floor: float = 100.0, device="cuda",
) -> BoxDualRecovery:
    """Box-QP multipliers at the solution l: the minimal-norm least-squares
    duals on the active selector rows, closed form per coordinate."""
    c, cfg = _canon(P, q, QP_DEFAULTS, config, device)
    n = c.q.shape[-1]
    lo, hi, l_ = _vecs(c, n, l_min=l_min, l_max=l_max, l=l)
    d = kkt.box_dual(c.P, c.q, lo, hi, l_, cfg, eps=_act_eps(l_, cfg, act_floor))
    return BoxDualRecovery(*(c.restore(x) for x in d.gamma.split(n, dim=-1)))


class SignedBoxDualRecovery(NamedTuple):
    gamma_lo: torch.Tensor    # (..., n)
    gamma_hi: torch.Tensor    # (..., n)
    gamma_sign: torch.Tensor  # (..., n) multipliers of sign(v) * l <= 0


def recover_signed_box_qp_duals(
    P, q, l_min, l_max, v, l, *, config: Optional[SolverConfig] = None,
    act_floor: float = 100.0, device="cuda",
) -> SignedBoxDualRecovery:
    """Signed-box multipliers (lower, upper and sign blocks) at the
    solution l."""
    c, cfg = _canon(P, q, QP_DEFAULTS, config, device)
    n = c.q.shape[-1]
    lo, hi, vv, l_ = _vecs(c, n, l_min=l_min, l_max=l_max, v=v, l=l)
    d = kkt.signed_box_dual(c.P, c.q, lo, hi, vv, l_, cfg, eps=_act_eps(l_, cfg, act_floor))
    return SignedBoxDualRecovery(*(c.restore(x) for x in d.gamma.split(n, dim=-1)))


def recover_qcqp_duals(
    P, q, l_n, mu, l, *, config: Optional[SolverConfig] = None,
    act_floor: float = 100.0, device="cuda",
) -> torch.Tensor:
    """Per-contact cone multipliers gamma >= 0 at the QCQP solution l
    (squared-slack form: the norm-form multiplier of ||l_(i)|| <= r_i is
    2 r_i gamma_i).

    With ``act_floor`` > 0 the slack test is floored at
    act_floor * eps_mach * (r + ||l_(i)||) per contact and the degenerate-
    cone gate at eps_mach * ||l_(i)|| (both at least ``cfg.eps``), which a
    float32 solution needs; ``act_floor=0`` keeps the reference's absolute
    ``cfg.eps`` gates."""
    c, cfg = _canon(P, q, QCQP_DEFAULTS, config, device)
    n = c.q.shape[-1]
    (l_,) = _vecs(c, n, l=l)
    ln, m = _vecs(c, n // 2, l_n=l_n, mu=mu)
    radius = ln * m
    eps = r_min = None
    if act_floor > 0.0:
        B = l_.shape[0]
        norms = torch.linalg.vector_norm(l_.reshape(B, n // 2, 2), dim=-1)
        mach = torch.finfo(l_.dtype).eps
        eps = torch.clamp_min(act_floor * mach * (radius + norms), cfg.eps)
        r_min = torch.clamp_min(mach * norms, cfg.eps)
    d = kkt.qcqp_dual(c.P, c.q, radius, l_, cfg, eps=eps, r_min=r_min)
    return c.restore(d.gamma)


# --------------------------------------------------------------------------
# raw KKT-derivative solves (the reference's solveDerivatives* surface)
# --------------------------------------------------------------------------

def qp_derivatives(
    P, q, l, grad_l, *, config: Optional[SolverConfig] = None, device="cuda",
) -> torch.Tensor:
    """dl of the transposed differentiated-KKT system against grad_l: zeros
    on the strictly active set, P_FF^{-1} grad_l on the free set."""
    c, cfg = _canon(P, q, QP_DEFAULTS, config, device)
    l_, g = _vecs(c, c.q.shape[-1], l=l, grad_l=grad_l)
    return c.restore(kkt.qp_vjp(c.P, c.q, l_, g, cfg))


class BoxQPDerivatives(NamedTuple):
    dl: torch.Tensor         # (..., n)
    dgamma_lo: torch.Tensor  # (..., n) zeros at slots not strictly active
    dgamma_hi: torch.Tensor  # (..., n)
    gamma_lo: torch.Tensor   # (..., n) the multipliers used in the system
    gamma_hi: torch.Tensor   # (..., n)


def box_qp_derivatives(
    P, q, l_min, l_max, l, grad_l, *, config: Optional[SolverConfig] = None,
    device="cuda",
) -> BoxQPDerivatives:
    """(dl, dgamma, gamma) of the box-QP KKT adjoint, unpacked per block."""
    c, cfg = _canon(P, q, QP_DEFAULTS, config, device)
    n = c.q.shape[-1]
    lo, hi, l_, g = _vecs(c, n, l_min=l_min, l_max=l_max, l=l, grad_l=grad_l)
    r = kkt.box_vjp(c.P, c.q, lo, hi, l_, g, cfg)
    return BoxQPDerivatives(c.restore(r.dl), *(
        c.restore(x) for x in (*r.dgamma.split(n, dim=-1), *r.gamma.split(n, dim=-1))))


class SignedBoxQPDerivatives(NamedTuple):
    dl: torch.Tensor
    dgamma_lo: torch.Tensor
    dgamma_hi: torch.Tensor
    dgamma_sign: torch.Tensor
    gamma_lo: torch.Tensor
    gamma_hi: torch.Tensor
    gamma_sign: torch.Tensor


def signed_box_qp_derivatives(
    P, q, l_min, l_max, v, l, grad_l, *, config: Optional[SolverConfig] = None,
    device="cuda",
) -> SignedBoxQPDerivatives:
    """The signed-box KKT adjoint, the sign-constraint block included,
    unpacked per block."""
    c, cfg = _canon(P, q, QP_DEFAULTS, config, device)
    n = c.q.shape[-1]
    lo, hi, vv, l_, g = _vecs(c, n, l_min=l_min, l_max=l_max, v=v, l=l, grad_l=grad_l)
    r = kkt.signed_box_vjp(c.P, c.q, lo, hi, vv, l_, g, cfg)
    return SignedBoxQPDerivatives(c.restore(r.dl), *(
        c.restore(x) for x in (*r.dgamma.split(n, dim=-1), *r.gamma.split(n, dim=-1))))


class QCQPDerivatives(NamedTuple):
    dl: torch.Tensor      # (..., 2nc)
    dgamma: torch.Tensor  # (..., nc) zeros at inactive contacts
    gamma: torch.Tensor   # (..., nc)
    e1: torch.Tensor      # (..., nc) 2 gamma l_n^2 mu: grad_mu = e1 * dgamma
    e2: torch.Tensor      # (..., nc) 2 gamma l_n mu^2: grad_l_n = e2 * dgamma


def qcqp_derivatives(
    P, q, l_n, mu, l, grad_l, *, config: Optional[SolverConfig] = None,
    device="cuda",
) -> QCQPDerivatives:
    """(dl, dgamma, gamma, e1, e2) of the QCQP KKT adjoint against grad_l;
    the radius mu * l_n is formed here."""
    c, cfg = _canon(P, q, QCQP_DEFAULTS, config, device)
    n = c.q.shape[-1]
    l_, g = _vecs(c, n, l=l, grad_l=grad_l)
    ln, m = _vecs(c, n // 2, l_n=l_n, mu=mu)
    r = kkt.qcqp_vjp(c.P, c.q, ln * m, l_, g, cfg)
    e1, e2 = kkt.qcqp_radius_factors(ln, m, r.gamma)
    return QCQPDerivatives(*(c.restore(x) for x in (r.dl, r.dgamma, r.gamma, e1, e2)))
