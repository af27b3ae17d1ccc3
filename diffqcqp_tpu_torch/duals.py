"""Dual recovery and the raw KKT-derivative solve of the friction-cone QCQP
(port of the QCQP part of duals.py).

  * ``recover_qcqp_duals``: the per-contact cone multipliers gamma >= 0 of an
    already solved problem (the reference's ``dualFromPrimalQCQP``), in the
    squared-slack convention c_i = ||l_(i)||^2 - r_i^2, with scale-aware
    activity floors by default (``act_floor``).
  * ``qcqp_derivatives``: (dl, dgamma, gamma, e1, e2) of the transposed
    differentiated-KKT solve against a cotangent grad_l (the reference's
    ``solveDerivativesQCQP``), through ``diff/kkt.py::qcqp_vjp``, i.e. the
    fused kernel K2 on the card. Gradients assemble from it as
    grad_q = -dl, grad_l_n = e2 * dgamma, grad_mu = e1 * dgamma.

Both take the JAX package's layouts and ``device``: the card by default
(raising without CUDA), ``device="cpu"`` for the plain path. The recovery
runs in the input dtype on either device; the derivative solve on the card
runs K2 in float32 and casts back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .api import _device
from .config import QCQP_DEFAULTS, SolverConfig
from .diff import kkt
from .utils.shapes import canon_like, canon_problem

__all__ = ["recover_qcqp_duals", "qcqp_derivatives", "QCQPDerivatives"]


def _canon(P, q, l, l_n, mu, config, device):
    cfg = config if config is not None else QCQP_DEFAULTS
    c = canon_problem(P, q, device=_device(device))
    n = c.q.shape[-1]
    l_ = canon_like(l, c, "l", width=n)
    ln = canon_like(l_n, c, "l_n", width=n // 2)
    m = canon_like(mu, c, "mu", width=n // 2)
    return c, l_, ln, m, cfg


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
    c, l_, ln, m, cfg = _canon(P, q, l, l_n, mu, config, device)
    radius = ln * m
    eps = r_min = None
    if act_floor > 0.0:
        B, n = l_.shape
        norms = torch.linalg.vector_norm(l_.reshape(B, n // 2, 2), dim=-1)
        mach = torch.finfo(l_.dtype).eps
        eps = torch.clamp_min(act_floor * mach * (radius + norms), cfg.eps)
        r_min = torch.clamp_min(mach * norms, cfg.eps)
    d = kkt.qcqp_dual(c.P, c.q, radius, l_, cfg, eps=eps, r_min=r_min)
    return c.restore(d.gamma)


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
    c, l_, ln, m, cfg = _canon(P, q, l, l_n, mu, config, device)
    g = canon_like(grad_l, c, "grad_l", width=l_.shape[-1])
    r = kkt.qcqp_vjp(c.P, c.q, ln * m, l_, g, cfg)
    e1, e2 = kkt.qcqp_radius_factors(ln, m, r.gamma)
    return QCQPDerivatives(*(c.restore(x) for x in (r.dl, r.dgamma, r.gamma, e1, e2)))
