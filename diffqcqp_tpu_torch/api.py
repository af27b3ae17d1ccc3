"""Public solver API of the port: the four differentiable problem classes.

``solve_qp``, ``solve_box_qp``, ``solve_signed_box_qp`` and ``solve_qcqp``,
each with its ``*_with_stats`` form, take the JAX package's signatures plus
``device``. They run on the card by default (``device="cuda"``);
``device="cpu"`` runs the same routes with each kernel's plain PyTorch
version in its place. Without CUDA the default raises; it never runs on the
CPU by itself.

The forward takes one of two engines, decided from shapes, dtype and config
before anything launches (``_use_kernel``, reported by ``which_backend``):
the fused ADMM kernel K1 (``kernels/csrc/admm.cu``, 'pallas') for dense
float32 problems within K1's launch bound (n <= 169 on a Hopper card), else
the eager engine (``solvers/admm.py``, 'xla') in the input dtype: float64,
``backend='xla'``, ``accel`` and the sizes past K1. The backward takes the
class's fused adjoint, K4 (``kernels/csrc/coord_bwd.cu``) for the QP family
or K2 (``kernels/csrc/qcqp_bwd.cu``) for the QCQP, for dense float32 problems
within the kernel's bound, else the generic route of ``diff/kkt.py``
(``kkt._use_fused_kernel``). Under 'auto' nothing is cast: a float64 caller
gets float64 arithmetic throughout. ``backend='pallas'`` runs the kernels in
float32 whatever the inputs' dtype and casts their results back, as the JAX
package's kernel path does.

Gradients flow through one ``torch.autograd.Function``, ``_Solve`` (the JAX
package's ``jax.custom_vjp``s): it saves the caller's inputs (before
equilibration) and the mapped-back solution l, and its backward is a second
Function, ``_SolveAdjoint``: the class's adjoint in ``diff/kkt.py`` with the
JAX package's gradient assembly:
grad_P = -(dl l^T + l dl^T) / 2, grad_q = -dl, grad_l_min = -gamma_lo
dgamma_lo, grad_l_max = gamma_hi dgamma_hi, and the radius chain rule for
l_n and mu (for a diagonal P, grad_P = -dl * l). The warm start and the
signed box's v get zero gradients. The backward is not itself
differentiable: a second derivative raises.

Both Functions compose with ``torch.func`` (``vmap``, ``grad``, ``vjp``,
``jacrev`` and their nestings): their vmap rules fold the vmapped groups
into the problem batch, so a vmapped solve, or ``jacrev``'s n basis
cotangents, launch each kernel once over the folded batch, in the flat
batch's order. Forward mode (``jvp``, ``jacfwd``) raises, as ``jax.jvp`` of
the JAX package's ``custom_vjp`` does.

The layers of a solve are spans of ``utils/tracing.py``: ``solve.canon``
(the canonical problem, its parameters and warm start), ``solve.equilibrate``
(Ruiz and the map of the bounds or radii), ``solve.k1`` or ``solve.engine``
(the forward, with K1's casts), ``solve.map_back``; in the backward
``adjoint.vjp`` (the adjoint's arguments, K4 or K2 or the generic route) and
``adjoint.grads`` (``_grad_P``, -dl, the bound and radius gradients). A
staged step's capture records them as its graph's layout.

A diagonal P (B, N), as in the JAX package, launches no kernel: the eager
engine solves it and its adjoints are closed form (``diff/kkt.py``);
``which_backend`` names 'xla' for it, and ``backend='pallas'`` raises on it,
since K1 takes dense P only.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from .config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig, check_supported
from .diff.kkt import box_vjp, qcqp_radius_factors, qcqp_vjp, qp_vjp, signed_box_vjp
from .kernels import admm_cuda
from .kernels.glue_cuda import grad_p_cuda
from .kernels.admm_cuda import (
    PROX_BOX,
    PROX_DISK,
    PROX_NONNEG,
    PROX_SIGNED_BOX,
    admm_solve_cuda,
    prox_fn,
)
from .ops.equilibrate import isotropize, ruiz_diag, scale_problem
from .solvers.admm import SolveStats, admm_solve, capture_reason
from .utils.shapes import Canon, canon_like, canon_problem, fold_vmapped, unfold_vmapped
from .utils.tracing import span

__all__ = [
    "solve_qp",
    "solve_qp_with_stats",
    "solve_box_qp",
    "solve_box_qp_with_stats",
    "solve_signed_box_qp",
    "solve_signed_box_qp_with_stats",
    "solve_qcqp",
    "solve_qcqp_with_stats",
    "which_backend",
]


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
    if cfg.accel and (cfg.adaptive_rho or cfg.alpha_relax != 1.0):
        # permitted, as in the JAX package, but measured harmful there:
        # momentum and the adaptive schedule harvest the same slack
        warnings.warn(
            "SolverConfig.accel combined with adaptive_rho=True or alpha_relax != 1.0 "
            "is measured harmful (momentum and the adaptive schedule harvest the same "
            "slack; tails blow up). Use accel only with alpha_relax=1.0, "
            "adaptive_rho=False.",
            stacklevel=3,
        )
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


# --------------------------------------------------------------------------
# Forward: Ruiz equilibration around K1 or the eager engine
# --------------------------------------------------------------------------

def _use_kernel(P: torch.Tensor, q: torch.Tensor, cfg: SolverConfig) -> bool:
    """Forward dispatch, the counterpart of the JAX package's
    ``api.py::_use_pallas``: K1 (its plain version on a CPU tensor) iff
    ``_engine_reason`` finds no reason to take the eager engine."""
    return _engine_reason(P, q, cfg) is None


def _engine_reason(P: torch.Tensor, q: torch.Tensor, cfg: SolverConfig) -> Optional[str]:
    """The forward dispatch's rules, decided from shapes, dtype and config
    alone (never from a kernel's error): None where the solve takes K1, else
    why it takes the eager engine, in words (the capture guard's message):

      * ``backend='pallas'``: K1, in float32 whatever the inputs' dtype, as
        the JAX package's kernel path (``_forward`` casts the result back);
        with ``accel`` it raises ``ValueError``, as in the JAX package;
      * ``backend='xla'``: the eager engine;
      * ``backend='auto'``: K1 iff P is dense, q is float32, no
        ``axis_name``, no ``accel``, and K1 launches at this n on a Hopper
        card (``admm_cuda.fits``: its shared memory within the 232,448 bytes
        a block may opt into and its block within its launch bound, n <=
        169). That is the card kernel's own bound, not the JAX package's
        N <= 112, which is the TPU's VMEM ceiling; and unlike the JAX rule it
        does not depend on the device, so a CPU tensor takes the same route
        with K1's plain version.
    """
    if cfg.backend == "pallas":
        if cfg.accel:
            raise ValueError(
                "SolverConfig.accel is not supported by the pallas backend; "
                "use backend='xla' (or 'auto', which avoids the kernel)."
            )
        return None
    if cfg.backend != "auto":
        return f"backend={cfg.backend!r}"
    if cfg.axis_name is not None:
        return f"axis_name={cfg.axis_name!r} (the lockstep mode)"
    if cfg.accel:
        return "accel"
    if P.ndim != 3:
        return "a diagonal P"
    if q.dtype != torch.float32:
        return f"{q.dtype} inputs"
    if not admm_cuda.fits(q.shape[-1]):
        return f"n = {q.shape[-1]}, past K1's launch bound"
    return None


def which_backend(P, q, config: Optional[SolverConfig] = None) -> str:
    """Which forward engine a solve of these inputs takes: 'pallas' (the
    fused kernel K1, the JAX package's name for its kernel path) or 'xla'
    (the eager engine). See ``_use_kernel``; e.g. a dense float32 batch at
    N = 170 is past K1's shared memory and takes the engine:

        >>> which_backend(P, q)          # 'pallas' or 'xla'
    """
    cfg = config if config is not None else QP_DEFAULTS
    c = canon_problem(P, q)
    return "pallas" if _use_kernel(c.P, c.q, cfg) else "xla"


def capturable(P, q, cfg: SolverConfig) -> bool:
    """Whether a solve of the canonical (P, q) with ``cfg``, forward and
    backward, can be recorded in a CUDA graph (``utils/staging.py``): K1,
    or the engine where ``solvers/admm.py::capture_reason`` names nothing
    (every adjoint route records): every mode, the lockstep one unless the
    mesh bound to its axis names a reason (shards on more than one card in
    one process, NCCL across ranks, a gloo group; an axis bound later is
    checked at the capture). Decided from shapes, dtype, config and that binding."""
    return _engine_reason(P, q, cfg) is None or capture_reason(cfg) is None


def _forward(P, q, ws, prox_kind, prox_args, cfg: SolverConfig, qcqp_stopping, damp_both):
    """The solve with the given prox and stopping rule, by K1 or the eager
    engine (``_engine_reason``), on q's device, returned in q's dtype. K1
    computes in float32 ('auto' sends it float32 only; ``backend='pallas'``
    casts other inputs, as the JAX package's kernel path does). Under a
    CUDA graph capture both record; the engine raises the guard's error
    (``utils/staging.py``) where its lockstep axis's mesh cannot record
    (``solvers/admm.py::capture_reason``)."""
    reason = _engine_reason(P, q, cfg)
    if reason is None:
        with span("solve.k1"):
            c = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
            l, st = admm_solve_cuda(
                c(P), c(q), c(ws), prox_kind, tuple(map(c, prox_args)), cfg,
                qcqp_stopping=qcqp_stopping, damp_both=damp_both,
            )
            dt = q.dtype
            return l.to(dt), st._replace(res_prim=st.res_prim.to(dt),
                                         res_dual=st.res_dual.to(dt), rho=st.rho.to(dt))
    with span("solve.engine"):
        return admm_solve(P, q, ws, prox_fn(prox_kind, prox_args), cfg,
                          qcqp_stopping=qcqp_stopping, damp_both_taus=damp_both)


def _equilibrate(P, q, ws, cfg: SolverConfig, isotropic: bool = False):
    """(P, q, ws, d) of the Ruiz-rescaled problem, solved for l_eq = l / d;
    d is None when ``cfg.equilibrate`` is off. ``isotropic`` gives both
    coordinates of a contact one scale, so a disk stays a disk."""
    if not cfg.equilibrate:
        return P, q, ws, None
    d = ruiz_diag(P, cfg.ruiz_iters)
    if isotropic:
        d = isotropize(d)
    P, q = scale_problem(P, q, d)
    return P, q, ws / d, d


def _map_back(out, d):
    with span("solve.map_back"):
        l, stats = out
        return (l * d if d is not None else l), stats


def _qp(P, q, ws, cfg: SolverConfig):
    # d > 0 preserves l >= 0
    with span("solve.equilibrate"):
        P, q, ws, d = _equilibrate(P, q, ws, cfg)
    return _map_back(_forward(P, q, ws, PROX_NONNEG, (), cfg, False, True), d)


def _box_qp(P, q, l_min, l_max, ws, cfg: SolverConfig):
    with span("solve.equilibrate"):
        P, q, ws, d = _equilibrate(P, q, ws, cfg)
        if d is not None:
            l_min, l_max = l_min / d, l_max / d
    return _map_back(_forward(P, q, ws, PROX_BOX, (l_min, l_max), cfg, False, True), d)


def _signed_box_qp(P, q, l_min, l_max, v, ws, cfg: SolverConfig):
    # sign(v * l) is invariant under the positive rescaling
    with span("solve.equilibrate"):
        P, q, ws, d = _equilibrate(P, q, ws, cfg)
        if d is not None:
            l_min, l_max = l_min / d, l_max / d
        prox_args = (l_min, l_max, torch.sign(v))
    return _map_back(_forward(P, q, ws, PROX_SIGNED_BOX, prox_args, cfg, False, True), d)


def _qcqp(P, q, l_n, mu, ws, cfg: SolverConfig):
    with span("solve.equilibrate"):
        radius = l_n * mu
        P, q, ws, d = _equilibrate(P, q, ws, cfg, isotropic=True)
        if d is not None:
            radius = radius / d[:, ::2]
    return _map_back(_forward(P, q, ws, PROX_DISK, (radius,), cfg, True, False), d)


# --------------------------------------------------------------------------
# Backward: each class's gradients of <g, l> at the solution l
# --------------------------------------------------------------------------

def _grad_P(dl: torch.Tensor, l: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Symmetrised grad_P = -(dl l^T + l dl^T) / 2, the exact VJP of a solver
    that sees only the symmetric part of P (one pass on the card,
    ``kernels/glue_cuda.py::grad_p_cuda``); for a diagonal P its diagonal,
    -dl * l."""
    if P.ndim == 2:
        return -dl * l
    return grad_p_cuda(dl, l)


def _bound_grads(r, n: int):
    """(grad l_min, grad l_max) = (-gamma_lo dgamma_lo, gamma_hi dgamma_hi)."""
    return (
        -r.gamma[:, :n] * r.dgamma[:, :n],
        r.gamma[:, n : 2 * n] * r.dgamma[:, n : 2 * n],
    )


def _qp_grads(P, q, l, g, cfg: SolverConfig):
    with span("adjoint.vjp"):
        dl = qp_vjp(P, q, l, g, cfg)
    with span("adjoint.grads"):
        return _grad_P(dl, l, P), -dl


def _box_qp_grads(P, q, l_min, l_max, l, g, cfg: SolverConfig):
    with span("adjoint.vjp"):
        r = box_vjp(P, q, l_min, l_max, l, g, cfg)
    with span("adjoint.grads"):
        return (_grad_P(r.dl, l, P), -r.dl, *_bound_grads(r, l.shape[-1]))


def _signed_box_qp_grads(P, q, l_min, l_max, v, l, g, cfg: SolverConfig):
    with span("adjoint.vjp"):
        r = signed_box_vjp(P, q, l_min, l_max, v, l, g, cfg)
    # v enters only through sign(v): zero gradient almost everywhere
    with span("adjoint.grads"):
        return (_grad_P(r.dl, l, P), -r.dl, *_bound_grads(r, l.shape[-1]), torch.zeros_like(v))


def _qcqp_grads(P, q, l_n, mu, l, g, cfg: SolverConfig):
    with span("adjoint.vjp"):
        r = qcqp_vjp(P, q, l_n * mu, l, g, cfg)
    with span("adjoint.grads"):
        e1, e2 = qcqp_radius_factors(l_n, mu, r.gamma)
        return _grad_P(r.dl, l, P), -r.dl, e2 * r.dgamma, e1 * r.dgamma


# per class: (forward, gradients); the inputs are (P, q, *params, ws)
_CLASSES = {
    "qp": (_qp, _qp_grads),
    "box_qp": (_box_qp, _box_qp_grads),
    "signed_box_qp": (_signed_box_qp, _signed_box_qp_grads),
    "qcqp": (_qcqp, _qcqp_grads),
}


# the text of ``once_differentiable``'s error, so a second derivative fails
# alike under ``torch.autograd`` and ``torch.func``
_TWICE = "trying to differentiate twice a function that was marked with @once_differentiable"


def _vmapped(fn, info, in_dims, kind, cfg, xs):
    """A vmap rule of ``_Solve`` / ``_SolveAdjoint``: one ``fn.apply`` over
    the G vmapped groups folded into the problem batch (so each kernel
    launches once), split back into (G, B, ...) outputs."""
    if cfg.axis_name is not None:
        raise ValueError(
            "torch.func.vmap of a lockstep solve (axis_name) is not supported; "
            "fold the groups into the batch of the sharded call instead"
        )
    out = fn.apply(kind, cfg, *fold_vmapped(info.batch_size, in_dims[2:], xs))
    return unfold_vmapped(info.batch_size, out), (0,) * len(out)


class _Solve(torch.autograd.Function):
    """One class's solve with its KKT adjoint as the backward:
    ``_Solve.apply(kind, cfg, P, q, *params, ws)`` -> (l, *stats).

    It composes with ``torch.func``: the vmap rule folds the vmapped groups
    into the batch; the backward is ``_SolveAdjoint``, a Function of its own,
    because under ``torch.func`` a backward receives functorch-wrapped
    tensors, which the kernels' wrappers cannot read (only a Function's
    forward sees plain ones). Forward mode (``jvp``) is not defined and
    raises, as ``jax.jvp`` of the JAX package's ``custom_vjp`` does."""

    @staticmethod
    def forward(kind, cfg, *xs):
        l, stats = _CLASSES[kind][0](*xs, cfg)
        return (l, *stats)

    @staticmethod
    def setup_context(ctx, inputs, output):
        kind, cfg, *xs = inputs
        ctx.save_for_backward(*xs[:-1], output[0])
        ctx.kind, ctx.cfg = kind, cfg
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        *xs, l = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        grads = _SolveAdjoint.apply(ctx.kind, ctx.cfg, g, *xs, l)
        return (
            None, None,
            *(x if want else None for x, want in zip(grads, need)),
            torch.zeros_like(l) if need[-1] else None,
        )

    @staticmethod
    def vmap(info, in_dims, kind, cfg, *xs):
        return _vmapped(_Solve, info, in_dims, kind, cfg, xs)


class _SolveAdjoint(torch.autograd.Function):
    """The gradients of <g, l> at the solution l, one per input of the
    solve but the warm start: ``_SolveAdjoint.apply(kind, cfg, g, P, q,
    *params, l)``. Its vmap rule folds the vmapped cotangents (and any
    batched problem) into the batch, so ``jacrev``'s n basis cotangents are
    one K2 or K4 launch over n*B problems. Not differentiable: its backward
    raises, as the JAX kernel path (a ``pallas_call`` has no JVP rule)."""

    @staticmethod
    def forward(kind, cfg, g, *xs):
        *xs, l = xs
        return tuple(_CLASSES[kind][1](*xs, l, g, cfg))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *_):
        raise RuntimeError(_TWICE)

    @staticmethod
    def vmap(info, in_dims, kind, cfg, *xs):
        return _vmapped(_SolveAdjoint, info, in_dims, kind, cfg, xs)


# --------------------------------------------------------------------------
# Public wrappers
# --------------------------------------------------------------------------

def _problem(P, q, device) -> Canon:
    """The canonical batched problem on ``device``."""
    return canon_problem(P, q, device=_device(device))


def _warm_start(c: Canon, warm_start) -> torch.Tensor:
    if warm_start is None:
        return torch.zeros_like(c.q)
    return canon_like(warm_start, c, "warm_start", width=c.q.shape[-1])


def _solve(kind: str, cfg: SolverConfig, c: Canon, params, ws):
    l, *stats = _Solve.apply(kind, cfg, c.P, c.q, *params, ws)
    stats = SolveStats(*stats)
    return c.restore(l), (stats if c.batched else SolveStats(*(x[0] for x in stats)))


def solve_qp(
    P, q, warm_start=None, *, eps=None, mu_prox=None, max_iter=None,
    adaptive_rho=None, config=None, axis_name=None, device="cuda",
) -> torch.Tensor:
    """Solve min 1/2 l'Pl + q'l subject to l >= 0, batched and
    differentiable in (P, q). Layouts as in ``utils/shapes``; l comes back in
    the layout of q."""
    l, _ = solve_qp_with_stats(
        P, q, warm_start, eps=eps, mu_prox=mu_prox, max_iter=max_iter,
        adaptive_rho=adaptive_rho, config=config, axis_name=axis_name, device=device,
    )
    return l


def solve_qp_with_stats(
    P, q, warm_start=None, *, eps=None, mu_prox=None, max_iter=None,
    adaptive_rho=None, config=None, axis_name=None, device="cuda",
):
    """``solve_qp`` plus per-problem ``SolveStats``."""
    cfg = _build_cfg(QP_DEFAULTS, config, eps, mu_prox, max_iter, adaptive_rho, axis_name)
    with span("solve.canon"):
        c = _problem(P, q, device)
        ws = _warm_start(c, warm_start)
    return _solve("qp", cfg, c, (), ws)


def solve_box_qp(
    P, q, l_min, l_max, warm_start=None, *, eps=None, mu_prox=None,
    max_iter=None, adaptive_rho=None, config=None, axis_name=None, device="cuda",
) -> torch.Tensor:
    """Solve min 1/2 l'Pl + q'l subject to l_min <= l <= l_max;
    differentiable in (P, q, l_min, l_max)."""
    l, _ = solve_box_qp_with_stats(
        P, q, l_min, l_max, warm_start, eps=eps, mu_prox=mu_prox, max_iter=max_iter,
        adaptive_rho=adaptive_rho, config=config, axis_name=axis_name, device=device,
    )
    return l


def solve_box_qp_with_stats(
    P, q, l_min, l_max, warm_start=None, *, eps=None, mu_prox=None,
    max_iter=None, adaptive_rho=None, config=None, axis_name=None, device="cuda",
):
    """``solve_box_qp`` plus per-problem ``SolveStats``."""
    cfg = _build_cfg(QP_DEFAULTS, config, eps, mu_prox, max_iter, adaptive_rho, axis_name)
    with span("solve.canon"):
        c = _problem(P, q, device)
        n = c.q.shape[-1]
        bounds = (canon_like(l_min, c, "l_min", width=n), canon_like(l_max, c, "l_max", width=n))
        ws = _warm_start(c, warm_start)
    return _solve("box_qp", cfg, c, bounds, ws)


def solve_signed_box_qp(
    P, q, l_min, l_max, v, warm_start=None, *, eps=None, mu_prox=None,
    max_iter=None, adaptive_rho=None, config=None, axis_name=None, device="cuda",
) -> torch.Tensor:
    """The box QP with the added sign constraint sign(v) * l <= 0;
    differentiable in (P, q, l_min, l_max), with a zero gradient for v (it
    enters only through its sign)."""
    l, _ = solve_signed_box_qp_with_stats(
        P, q, l_min, l_max, v, warm_start, eps=eps, mu_prox=mu_prox,
        max_iter=max_iter, adaptive_rho=adaptive_rho, config=config,
        axis_name=axis_name, device=device,
    )
    return l


def solve_signed_box_qp_with_stats(
    P, q, l_min, l_max, v, warm_start=None, *, eps=None, mu_prox=None,
    max_iter=None, adaptive_rho=None, config=None, axis_name=None, device="cuda",
):
    """``solve_signed_box_qp`` plus per-problem ``SolveStats``."""
    cfg = _build_cfg(QP_DEFAULTS, config, eps, mu_prox, max_iter, adaptive_rho, axis_name)
    with span("solve.canon"):
        c = _problem(P, q, device)
        n = c.q.shape[-1]
        params = tuple(canon_like(x, c, name, width=n)
                       for x, name in ((l_min, "l_min"), (l_max, "l_max"), (v, "v")))
        ws = _warm_start(c, warm_start)
    return _solve("signed_box_qp", cfg, c, params, ws)


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
    with span("solve.canon"):
        c = _problem(P, q, device)
        nc = c.q.shape[-1] // 2
        params = (canon_like(l_n, c, "l_n", width=nc), canon_like(mu, c, "mu", width=nc))
        ws = _warm_start(c, warm_start)
    return _solve("qcqp", cfg, c, params, ws)
