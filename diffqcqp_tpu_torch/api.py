"""Public solver API of the port: the differentiable friction-cone QCQP.

``solve_qcqp`` / ``solve_qcqp_with_stats`` take the JAX package's signature
plus ``device``. They run on the card by default (``device="cuda"``): the
forward goes through the fused ADMM kernel K1 (``kernels/csrc/admm.cu``) and
the backward through the fused KKT adjoint K2 (``kernels/csrc/qcqp_bwd.cu``),
both in float32, as the JAX kernel path computes in float32, with the
results cast back to the input dtype. ``device="cpu"`` runs the kernels'
plain PyTorch versions in the input dtype. Without CUDA the default raises;
it never runs on the CPU by itself.

Gradients flow to P, q, l_n and mu through a ``torch.autograd.Function``
(the JAX package's ``jax.custom_vjp``): it saves the caller's P, q, l_n, mu
(before equilibration) and the mapped-back solution l, and its backward is
``diff/kkt.py::qcqp_vjp`` plus the radius chain rule. The warm start gets a
zero gradient. The backward is not itself differentiable.

The QP-family entry points, Jacobians, ``verify``, ``parallel`` and
``models`` are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from .config import QCQP_DEFAULTS, SolverConfig, check_supported
from .diff.kkt import qcqp_radius_factors, qcqp_vjp
from .kernels.admm_cuda import PROX_DISK, admm_solve_cuda
from .ops.equilibrate import isotropize, ruiz_diag, scale_problem
from .solvers.admm import SolveStats
from .utils.shapes import canon_like, canon_problem

__all__ = ["solve_qcqp", "solve_qcqp_with_stats"]


def _build_cfg(
    base: SolverConfig,
    config: Optional[SolverConfig],
    eps: Optional[float],
    mu_prox: Optional[float],
    max_iter: Optional[int],
    adaptive_rho: Optional[bool],
    axis_name: Optional[str],
) -> SolverConfig:
    cfg = config if config is not None else base
    over = {}
    if eps is not None:
        over["eps"] = eps
    if mu_prox is not None:
        over["mu_prox"] = mu_prox
    if max_iter is not None:
        over["max_iter"] = int(max_iter)
    if adaptive_rho is not None:
        over["adaptive_rho"] = adaptive_rho
    if axis_name is not None:
        over["axis_name"] = axis_name
    cfg = cfg.replace(**over) if over else cfg
    check_supported(cfg)
    return cfg


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the solver runs on the card by default; "
            "pass device='cpu' for the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _forward_disk(P, q, ws, radius, cfg: SolverConfig):
    """K1 with the disk prox and the QCQP stopping rule; float32 on CUDA."""
    if q.device.type == "cuda":
        dtype = q.dtype
        f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
        l, st = admm_solve_cuda(
            f32(P), f32(q), f32(ws), PROX_DISK, (f32(radius),), cfg,
            qcqp_stopping=True, damp_both=False,
        )
        return l.to(dtype), SolveStats(
            st.iterations, st.res_prim.to(dtype), st.res_dual.to(dtype),
            st.rho.to(dtype), st.converged, st.stalled,
        )
    return admm_solve_cuda(
        P.contiguous(), q.contiguous(), ws.contiguous(), PROX_DISK,
        (radius.contiguous(),), cfg, qcqp_stopping=True, damp_both=False,
    )


def _qcqp(P, q, l_n, mu, ws, cfg: SolverConfig):
    radius = l_n * mu
    d = None
    if cfg.equilibrate:
        # both coordinates of a contact share one scale, so a disk stays a disk
        d = isotropize(ruiz_diag(P, cfg.ruiz_iters))
        P, q = scale_problem(P, q, d)
        ws = ws / d
        radius = radius / d[:, ::2]
    l, stats = _forward_disk(P, q, ws, radius, cfg)
    return (l * d if d is not None else l), stats


def _grad_P(dl: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Symmetrised grad_P = -(dl l^T + l dl^T) / 2, the exact VJP of a solver
    that sees only the symmetric part of P."""
    return -0.5 * (dl[:, :, None] * l[:, None, :] + l[:, :, None] * dl[:, None, :])


def _qcqp_grads(P, q, l_n, mu, l, g, cfg: SolverConfig):
    """(grad P, grad q, grad l_n, grad mu) of <g, l> at the solution l."""
    r = qcqp_vjp(P, q, l_n * mu, l, g, cfg)
    e1, e2 = qcqp_radius_factors(l_n, mu, r.gamma)
    return _grad_P(r.dl, l), -r.dl, e2 * r.dgamma, e1 * r.dgamma


class _QCQP(torch.autograd.Function):
    """``_qcqp`` with the KKT adjoint as its backward; outputs (l, *stats)."""

    @staticmethod
    def forward(ctx, P, q, l_n, mu, ws, cfg):
        l, stats = _qcqp(P, q, l_n, mu, ws, cfg)
        ctx.save_for_backward(P, q, l_n, mu, l)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(*stats)
        return (l, *stats)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, *_):
        P, q, l_n, mu, l = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = _qcqp_grads(P, q, l_n, mu, l, g, ctx.cfg)
        return (
            *(x if want else None for x, want in zip(grads, need)),
            torch.zeros_like(l) if need[4] else None,
            None,
        )


def _stats_restore(stats: SolveStats, batched: bool) -> SolveStats:
    if batched:
        return stats
    return SolveStats(*(x[0] for x in stats))


def solve_qcqp(
    P, q, l_n, mu, warm_start=None, *, eps=None, mu_prox=None, max_iter=None,
    adaptive_rho=None, config=None, axis_name=None, device="cuda",
) -> torch.Tensor:
    """Solve the friction-cone QCQP: min 1/2 l'Pl + q'l subject to
    ||l_(i)||_2 <= mu_i * l_n_i for each 2-D contact block i.

    l is 2*nc long; l_n and mu are nc long. Layouts as in ``utils/shapes``.
    """
    l, _ = solve_qcqp_with_stats(
        P, q, l_n, mu, warm_start, eps=eps, mu_prox=mu_prox,
        max_iter=max_iter, adaptive_rho=adaptive_rho, config=config,
        axis_name=axis_name, device=device,
    )
    return l


def solve_qcqp_with_stats(
    P, q, l_n, mu, warm_start=None, *, eps=None, mu_prox=None, max_iter=None,
    adaptive_rho=None, config=None, axis_name=None, device="cuda",
):
    """``solve_qcqp`` plus per-problem ``SolveStats``."""
    cfg = _build_cfg(QCQP_DEFAULTS, config, eps, mu_prox, max_iter, adaptive_rho, axis_name)
    dev = _device(device)
    c = canon_problem(P, q, device=dev)
    if c.P.ndim != 3:
        raise NotImplementedError(
            "diagonal P on the QCQP forward path: the fused kernel takes dense "
            "(B, N, N) P (diag_embed it), as the JAX kernel path does"
        )
    n = c.q.shape[-1]
    ln = canon_like(l_n, c, "l_n", width=n // 2)
    m = canon_like(mu, c, "mu", width=n // 2)
    ws = (
        torch.zeros_like(c.q)
        if warm_start is None
        else canon_like(warm_start, c, "warm_start", width=n)
    )
    l, *stats = _QCQP.apply(c.P, c.q, ln, m, ws, cfg)
    return c.restore(l), _stats_restore(SolveStats(*stats), c.batched)
