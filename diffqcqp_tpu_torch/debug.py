"""Per-iteration solve traces (port of debug.py).

``trace_*`` run the engine body of the production solves (the
``make_admm_step`` closure that ``admm_solve`` drives) for exactly ``iters``
steps, whatever ``cond`` says, and record per-iteration histories:

    tr = trace_qp(P, q, iters=60)
    tr.res_dual      # (iters, B) dual-residual trajectory
    tr.res_prim      # (iters, B)
    tr.rho           # (iters, B) penalty iteration k ran with
    tr.active        # (iters, B) bool: problem still iterating
    tr.l2            # (B, N) final iterate (== the engine's at that count)

The same fields, alignment, equilibration and ``accel`` handling as the JAX
package's ``debug.py``. A trace always runs the eager engine (never the
kernel K1), on ``device`` (the card by default, raising without CUDA;
``device="cpu"`` for the plain path), in the inputs' dtype; converged
problems freeze exactly as in production, and the O(iters * B) history
suits moderate batch sizes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .api import _device, _equilibrate
from .config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig
from .kernels.admm_cuda import PROX_BOX, PROX_DISK, PROX_NONNEG, PROX_SIGNED_BOX, prox_fn
from .solvers.admm import make_admm_step
from .utils.shapes import canon_like, canon_problem

__all__ = ["SolveTrace", "trace_qp", "trace_box_qp", "trace_signed_box_qp", "trace_qcqp"]


class SolveTrace(NamedTuple):
    res_prim: torch.Tensor    # (iters, B) residuals AFTER iteration k
    res_dual: torch.Tensor    # (iters, B)
    rho: torch.Tensor         # (iters, B) penalty iteration k RAN WITH (it
                              # gives res_dual[k] = rho[k] * ||l2[k] - l2[k-1]||_inf)
    active: torch.Tensor      # (iters, B) bool: still iterating at this step
    l2: torch.Tensor          # (B, N) final iterate after ``iters`` steps (with
                              # cfg.accel the PLAIN iterate, as admm_solve
                              # returns, not the extrapolated restart point)
    converged: torch.Tensor   # (B,) bool at the end of the trace
    iterations: torch.Tensor  # (B,) int32 per-problem iterations actually run


def _trace(P, q, ws, prox, cfg, iters, d, qcqp_stopping=False, damp_both=True) -> SolveTrace:
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    _, body, s = make_admm_step(P, q, ws, prox, cfg, qcqp_stopping, damp_both)
    rec = []
    for _ in range(iters):
        rec.append((s.res_prim, s.res_dual, s.rho, ~s.converged))   # the state BEFORE the step
        s = body(s)
    res_prim, res_dual, rho, active = (torch.stack(x) for x in zip(*rec))
    l2 = s.l2_plain if cfg.accel else s.l2
    # residuals shifted so row k holds those AFTER iteration k; rho and
    # active stay pre-step (rho[k] and res_*[k] are the aligned pair)
    return SolveTrace(
        res_prim=torch.cat([res_prim[1:], s.res_prim[None]]),
        res_dual=torch.cat([res_dual[1:], s.res_dual[None]]),
        rho=rho,
        active=active,
        l2=l2 * d if d is not None else l2,
        converged=s.converged,
        iterations=s.iters,
    )


def _problem(P, q, warm_start, config, base, iters, device):
    """(cfg, canon, ws) of a trace: ``max_iter = iters`` as in the JAX
    package, the problem canonicalised on ``device``."""
    cfg = (config or base).replace(max_iter=iters)
    c = canon_problem(P, q, device=_device(device))
    ws = (torch.zeros_like(c.q) if warm_start is None
          else canon_like(warm_start, c, "warm_start", width=c.q.shape[-1]))
    return cfg, c, ws


def trace_qp(
    P, q, warm_start=None, *, iters: int = 100, config: Optional[SolverConfig] = None,
    device="cuda",
) -> SolveTrace:
    """Trace a non-negative QP solve for exactly ``iters`` engine steps."""
    cfg, c, ws = _problem(P, q, warm_start, config, QP_DEFAULTS, iters, device)
    # the preprocessing of api._qp: residuals and rho are the equilibrated
    # problem's, as the production stopping test sees them; l2 is mapped back
    P_, q_, ws, d = _equilibrate(c.P, c.q, ws, cfg)
    return _trace(P_, q_, ws, prox_fn(PROX_NONNEG, ()), cfg, iters, d)


def trace_box_qp(
    P, q, l_min, l_max, warm_start=None, *, iters: int = 100,
    config: Optional[SolverConfig] = None, device="cuda",
) -> SolveTrace:
    """Trace a box QP solve for exactly ``iters`` engine steps."""
    cfg, c, ws = _problem(P, q, warm_start, config, QP_DEFAULTS, iters, device)
    n = c.q.shape[-1]
    lo, hi = canon_like(l_min, c, "l_min", width=n), canon_like(l_max, c, "l_max", width=n)
    P_, q_, ws, d = _equilibrate(c.P, c.q, ws, cfg)
    if d is not None:
        lo, hi = lo / d, hi / d
    return _trace(P_, q_, ws, prox_fn(PROX_BOX, (lo, hi)), cfg, iters, d)


def trace_signed_box_qp(
    P, q, l_min, l_max, v, warm_start=None, *, iters: int = 100,
    config: Optional[SolverConfig] = None, device="cuda",
) -> SolveTrace:
    """Trace a signed-box QP solve for exactly ``iters`` engine steps."""
    cfg, c, ws = _problem(P, q, warm_start, config, QP_DEFAULTS, iters, device)
    n = c.q.shape[-1]
    lo, hi = canon_like(l_min, c, "l_min", width=n), canon_like(l_max, c, "l_max", width=n)
    vs = torch.sign(canon_like(v, c, "v", width=n))
    # sign(v * l) is invariant under the positive rescaling
    P_, q_, ws, d = _equilibrate(c.P, c.q, ws, cfg)
    if d is not None:
        lo, hi = lo / d, hi / d
    return _trace(P_, q_, ws, prox_fn(PROX_SIGNED_BOX, (lo, hi, vs)), cfg, iters, d)


def trace_qcqp(
    P, q, l_n, mu, warm_start=None, *, iters: int = 100,
    config: Optional[SolverConfig] = None, device="cuda",
) -> SolveTrace:
    """Trace a friction-cone QCQP solve (reference rho semantics:
    damp_both_taus=False, the combined stopping rule)."""
    cfg, c, ws = _problem(P, q, warm_start, config, QCQP_DEFAULTS, iters, device)
    nc = c.q.shape[-1] // 2
    radius = canon_like(l_n, c, "l_n", width=nc) * canon_like(mu, c, "mu", width=nc)
    # a per-contact isotropic scale, as api._qcqp (a disk stays a disk)
    P_, q_, ws, d = _equilibrate(c.P, c.q, ws, cfg, isotropic=True)
    if d is not None:
        radius = radius / d[:, ::2]
    return _trace(P_, q_, ws, prox_fn(PROX_DISK, (radius,)), cfg, iters, d,
                  qcqp_stopping=True, damp_both=False)
