"""The batched ADMM engine (port of solvers/admm.py), and ``SolveStats``.

One generic proximal over-relaxed adaptive-rho ADMM over a whole batch,
parameterised by a prox callable and a stopping-rule flag: the engine the
public solves take wherever the fused kernel K1 (``kernels/admm_cuda.py``)
does not apply (float64, ``backend='xla'``, ``accel``, and sizes past K1's
shared memory; ``api.py::_use_kernel``). Eager PyTorch on the inputs'
device and in their dtype:

  * every step is a batched matrix-vector product or an element-wise op over
    (B, N) tensors; each problem carries its own (rho, tau, counters) and
    converges on its own iteration, converged problems are frozen by
    masking, and the loop runs until every problem converged or
    ``max_iter``, through ``utils/control.py::while_loop`` (the JAX
    package's ``lax.while_loop``): a Python loop that reads its predicate
    on the host once an iteration, or inside a CUDA graph capture a WHILE
    node decided on the card. The body reads nothing on the host: the
    iteration counter and the done flag are 0-d device tensors, and the
    inverse mode's recompute goes through ``control.cond`` (``lax.cond``);
  * the linear solve has two modes (``SolverConfig.linsolve``): the SPECTRAL
    handle (one eigh, every rho change free; on the card the Jacobi kernel
    E1, ``ops/linalg.py::factorize``) and, for dense N > 48 or
    ``linsolve='chol'``, an explicit inverse of P + (rho + mu) I,
    Newton-Schulz in float32 and Cholesky in float64, recomputed for the
    batch whenever some problem's rho changed (with ``rho_sync`` those land
    on shared iterations).

Per iteration (Solver.cpp:79-121):

    l      = (P + (rho+mu_prox) I)^{-1} (rho*l2 - u - q_prox)
    q_prox = q - mu_prox * l
    r      = alpha*l + (1-alpha)*l2
    l2'    = prox(r + u/rho)
    u     += rho * (r - l2')
    res_dual = rho * ||l2' - l2||_inf,  res_prim = ||l2' - r||_inf
    stop: res_dual < eps (QP family), and res_prim < eps + eps_rel ||l||_2
          (QCQP, or any class with primal_check), each with its stall floor
    adaptive rho per problem, gated by rho_sync or the cpt counter

``cfg.accel`` adds fast-ADMM momentum with a per-problem restart. With
``cfg.axis_name`` set (the lockstep mode of ``parallel/sharding.py``) the
body computes only its own done flag, and ``admm_solve`` hands its loop
(``cond``, ``body``, initial state) to the coordinator bound to that axis by
``lockstep_axis``: the coordinator runs one loop over every shard's state,
the done flag the MIN over the shards (the JAX package's ``lax.pmin``), so
every shard runs the same number of iterations, and hands back the final
state.

Under a CUDA graph capture (``utils/staging.py``) the engine records itself,
in both linear-solve modes and in the lockstep mode, except where the
coordinator names a reason (``capture_reason``: shards on more than one
card in one process, NCCL across ranks, a gloo process group). There it raises the guard's
error before it records anything.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterator, NamedTuple, Optional

import torch

from ..config import SolverConfig
from ..utils import control
from ..utils.staging import capture_error
from ..ops.linalg import (
    Factorization,
    chol_inverse_shifted,
    factorize,
    linf_norm,
    ns_inverse_shifted,
    power_iteration,
    solve_shifted,
)

__all__ = ["ADMMState", "SolveStats", "admm_solve", "capture_reason", "lockstep_axis",
           "make_admm_step"]

# axis name -> the coordinator of the sharded call running over it
_axes: dict[str, Any] = {}
_axes_lock = threading.Lock()


@contextlib.contextmanager
def lockstep_axis(axis_name: str, coordinator) -> Iterator[None]:
    """Bind ``axis_name`` to ``coordinator`` for the duration of the block:
    every ``admm_solve`` run with ``cfg.axis_name == axis_name`` hands its
    loop to ``coordinator.loop(cond, body, state)``, which steps it together
    with the other shards of the axis, every state's ``all_done`` the AND
    of every shard's after each step, and returns this shard's last state;
    ``coordinator.capture_reason()`` says why the loop cannot be recorded in
    a CUDA graph, or None (``parallel/sharding.py::Lockstep`` is one). One
    binding a name at a time, as one ``shard_map`` binds its axis."""
    with _axes_lock:
        if axis_name in _axes:
            raise RuntimeError(f"axis name {axis_name!r} is already bound by a running "
                               "sharded call")
        _axes[axis_name] = coordinator
    try:
        yield
    finally:
        with _axes_lock:
            del _axes[axis_name]


def _coordinator(axis_name: str):
    with _axes_lock:
        coordinator = _axes.get(axis_name)
    if coordinator is None:
        raise NameError(
            f"unbound axis name {axis_name!r}: SolverConfig.axis_name is set but no sharded "
            "call binds it (run lockstep solves through parallel.solve_*_sharded(..., "
            "lockstep=True), or inside parallel.lockstep(mesh))"
        )
    return coordinator


class SolveStats(NamedTuple):
    """Per-problem solve diagnostics, as in the JAX package."""

    iterations: torch.Tensor   # (B,) int32
    res_prim: torch.Tensor     # (B,) last primal residual
    res_dual: torch.Tensor     # (B,) last dual residual
    rho: torch.Tensor          # (B,) the penalty the recorded residuals were
                               # computed with (not the post-update carry)
    converged: torch.Tensor    # (B,) bool
    stalled: torch.Tensor      # (B,) bool: converged only via the
                               # machine-precision stall floor (stall_tol)


class ADMMState(NamedTuple):
    it: torch.Tensor           # () int32: global iteration counter
    l: torch.Tensor            # (B, N) primal iterate
    l2: torch.Tensor           # (B, N) constraint-satisfying iterate (the output)
    u: torch.Tensor            # (B, N) scaled dual iterate
    q_prox: torch.Tensor       # (B, N) proximal recentred linear term
    rho: torch.Tensor          # (B,)
    tau_inc: torch.Tensor      # (B,)
    tau_dec: torch.Tensor      # (B,)
    rho_up: torch.Tensor       # (B,) int32: last rho direction (+1/-1/0)
    cpt: torch.Tensor          # (B,) int32: trigger counter (Solver.cpp:93)
    converged: torch.Tensor    # (B,) bool
    stalled: torch.Tensor      # (B,) bool
    iters: torch.Tensor        # (B,) int32: iterations each problem ran
    res_prim: torch.Tensor     # (B,)
    res_dual: torch.Tensor     # (B,)
    rho_res: torch.Tensor      # (B,) the rho the recorded residuals were
                               # computed with (frozen with them)
    all_done: torch.Tensor     # () bool: every problem converged (lockstep: every
                               # shard's, after the coordinator's step)
    fact_inv: Optional[torch.Tensor]   # (B, N, N) inverse of P + (rho+mu) I in
                                       # the inverse mode, None otherwise
    l2_plain: Optional[torch.Tensor]   # accel: the un-extrapolated l2 (the
                                       # solution candidate); None without
    u_plain: Optional[torch.Tensor]    # accel: the un-extrapolated dual
    acc_a: Optional[torch.Tensor]      # accel: Nesterov a_k (B,)
    acc_c: Optional[torch.Tensor]      # accel: previous combined residual (B,)


def _use_chol(P: torch.Tensor, cfg: SolverConfig) -> bool:
    """linsolve dispatch: the explicit-inverse mode for dense P with
    ``linsolve='chol'``, or 'auto' above N = 48, where the spectral mode's
    one eigh dominates a whole solve."""
    if P.ndim != 3:
        return False
    if cfg.linsolve == "chol":
        return True
    return cfg.linsolve == "auto" and P.shape[-1] > 48


def capture_reason(cfg: SolverConfig) -> Optional[str]:
    """Why a solve with ``cfg`` cannot be recorded in a CUDA graph, or None
    where it can: every mode records (the spectral one through the Jacobi
    kernel E1), the lockstep mode where the coordinator bound to its axis
    names no reason (it refuses shards on more than one card in one
    process, NCCL across ranks and a gloo process group); an unbound axis names none here
    (``make_admm_step`` raises ``NameError`` for it)."""
    if cfg.axis_name is None:
        return None
    with _axes_lock:
        coordinator = _axes.get(cfg.axis_name)
    return None if coordinator is None else coordinator.capture_reason()


def _make_inverse_fn(P: torch.Tensor, dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """shift (B,) -> inv(P + shift I): Newton-Schulz in float32 (matrix
    products only), batched Cholesky otherwise."""
    if dtype == torch.float32:
        return lambda shift: ns_inverse_shifted(P, shift)
    return lambda shift: chol_inverse_shifted(P, shift)


def _initial_state(
    fact: Optional[Factorization],
    P: torch.Tensor,
    q: torch.Tensor,
    warm_start: torch.Tensor,
    cfg: SolverConfig,
    inv_fn=None,
    lmax: Optional[torch.Tensor] = None,
) -> ADMMState:
    B, _ = q.shape
    dtype, dev = q.dtype, q.device
    use_chol = fact is None
    if lmax is not None:
        L = lmax
    elif use_chol or cfg.lmax_method == "power":
        L = power_iteration(P, cfg.power_iters)
    else:
        L = fact.lmax
    L = torch.clamp_min(L, cfg.mu_prox)                    # guard degenerate P = 0
    ratio = L / cfg.mu_prox
    rho = torch.sqrt(cfg.mu_prox * L) * ratio**0.4 * cfg.rho0_scale   # Solver.cpp:72
    tau = ratio**0.15                                               # Solver.cpp:73
    zeros = torch.zeros_like(q)
    ws = warm_start.to(dtype)
    if cfg.warm_start_dual:
        # u* = -(P l* + q) at any fixed point: the dual warm start from the primal one
        u0 = -(P * ws + q) if P.ndim == 2 else -(torch.sum(P * ws[:, None, :], dim=-1) + q)
    else:
        u0 = zeros
    i32 = dict(dtype=torch.int32, device=dev)
    return ADMMState(
        it=torch.zeros((), dtype=torch.int32, device=dev),
        l=zeros,
        l2=ws,
        u=u0,
        q_prox=q,
        rho=rho,
        tau_inc=tau,
        tau_dec=tau,
        rho_up=torch.zeros(B, **i32),
        cpt=torch.zeros(B, **i32),
        converged=torch.zeros(B, dtype=torch.bool, device=dev),
        stalled=torch.zeros(B, dtype=torch.bool, device=dev),
        iters=torch.zeros(B, **i32),
        res_prim=torch.full((B,), float("inf"), dtype=dtype, device=dev),
        res_dual=torch.full((B,), float("inf"), dtype=dtype, device=dev),
        rho_res=rho,
        all_done=torch.zeros((), dtype=torch.bool, device=dev),
        fact_inv=inv_fn(rho + cfg.mu_prox) if use_chol else None,
        l2_plain=ws if cfg.accel else None,
        u_plain=u0 if cfg.accel else None,
        acc_a=torch.ones(B, dtype=dtype, device=dev) if cfg.accel else None,
        acc_c=torch.full((B,), float("inf"), dtype=dtype, device=dev) if cfg.accel else None,
    )


def admm_solve(
    P: torch.Tensor,
    q: torch.Tensor,
    warm_start: torch.Tensor,
    prox: Callable[[torch.Tensor], torch.Tensor],
    cfg: SolverConfig,
    qcqp_stopping: bool = False,
    damp_both_taus: bool = True,
) -> tuple[torch.Tensor, SolveStats]:
    """Run the batched ADMM to convergence.

    Args:
      P: (B, N, N) dense SPD or (B, N) diagonal quadratic term.
      q: (B, N) linear term.
      warm_start: (B, N) initial l2 iterate (zeros: the reference trajectory).
      prox: projection onto the constraint set, applied over (B, N).
      cfg: solver configuration.
      qcqp_stopping: the QCQP combined primal+dual rule (Solver.cpp:548)
        instead of the QP family's dual-only rule (Solver.cpp:88).
      damp_both_taus: the QP family damps both taus on a direction flip
        (Solver.cpp:95-96); the QCQP only the fired branch's (:554-556).

    Returns:
      (l2, SolveStats) with l2 the per-problem solution (B, N).
    """
    cond, body, s = make_admm_step(P, q, warm_start, prox, cfg, qcqp_stopping, damp_both_taus)
    if cfg.axis_name is None:
        s = control.while_loop(cond, body, s)
    else:
        # lockstep: the axis's coordinator steps this loop with every shard's
        s = _coordinator(cfg.axis_name).loop(cond, body, s)
    stats = SolveStats(
        iterations=s.iters, res_prim=s.res_prim, res_dual=s.res_dual,
        rho=s.rho_res, converged=s.converged, stalled=s.stalled,
    )
    # accel: the carried l2 is the extrapolated restart point; the solution
    # is the plain iterate (the same for converged problems)
    return (s.l2_plain if cfg.accel else s.l2), stats


def make_admm_step(
    P: torch.Tensor,
    q: torch.Tensor,
    warm_start: torch.Tensor,
    prox: Callable[[torch.Tensor], torch.Tensor],
    cfg: SolverConfig,
    qcqp_stopping: bool = False,
    damp_both_taus: bool = True,
) -> tuple[Callable, Callable, ADMMState]:
    """(cond, body, initial_state) of the ADMM loop, for callers that drive
    the iteration themselves; ``admm_solve`` runs ``body`` while ``cond``
    (a 0-d bool tensor). With ``cfg.axis_name`` set it raises ``NameError``
    unless a sharded call binds that axis (``lockstep_axis``); ``body``
    then still computes this shard's own done flag. Under a CUDA graph
    capture it raises the guard's error where ``capture_reason`` names
    one. In the inverse mode ``body`` recomputes ``fact_inv`` in place: a
    state and the states after it share that matrix."""
    if control.capturing():
        reason = capture_reason(cfg)
        if reason is not None:
            raise capture_error("the eager ADMM engine (solvers/admm.py)", reason)
    if cfg.axis_name is not None:
        _coordinator(cfg.axis_name)
    use_chol = _use_chol(P, cfg)
    dtype = q.dtype
    if use_chol:
        fact = None
        lmax_est = torch.clamp_min(power_iteration(P, cfg.power_iters), cfg.mu_prox)
        inv_fn = _make_inverse_fn(P, dtype)
    else:
        fact = factorize(P)
        lmax_est, inv_fn = None, None
    state0 = _initial_state(fact, P, q, warm_start, cfg, inv_fn=inv_fn, lmax=lmax_est)
    floor = cfg.stall_tol * torch.finfo(dtype).eps
    alpha, mu_prox, damp = cfg.alpha_relax, cfg.mu_prox, cfg.tau_damping

    def cond(s: ADMMState) -> torch.Tensor:
        return (s.it < cfg.max_iter) & ~s.all_done

    def body(s: ADMMState) -> ADMMState:
        active = ~s.converged
        rho_c = s.rho[:, None]

        rhs = rho_c * s.l2 - s.u - s.q_prox
        if use_chol:
            l = (s.fact_inv @ rhs[..., None])[..., 0]
        else:
            l = solve_shifted(fact, rhs, s.rho + mu_prox)
        q_prox = q - mu_prox * l
        r = alpha * l + (1.0 - alpha) * s.l2
        l2 = prox(r + s.u / rho_c)
        u = s.u + rho_c * (r - l2)
        delta = linf_norm(l2 - s.l2)
        res_dual = s.rho * delta
        res_prim = linf_norm(l2 - r)

        eps_ok = res_dual < cfg.eps
        if cfg.stall_tol > 0.0:
            # the iterate cannot move below the dtype's fixed-point noise floor
            noise = floor * torch.clamp_min(linf_norm(l2), 1.0)
            dual_ok = eps_ok | (delta <= noise)
        else:
            dual_ok = eps_ok
        if qcqp_stopping or cfg.primal_check:
            prim_eps = res_prim < cfg.eps + cfg.eps_rel * torch.linalg.vector_norm(l, dim=-1)
            prim_ok = prim_eps | (res_prim <= noise) if cfg.stall_tol > 0.0 else prim_eps
            newly = prim_ok & dual_ok
            certified = eps_ok & prim_eps
        else:
            newly = dual_ok
            certified = eps_ok

        # adaptive rho (Solver.cpp:91-120) for problems still active that did
        # not just converge (the reference breaks before the update)
        fact_inv = s.fact_inv
        if cfg.adaptive_rho:
            adapt = active & ~newly
            inc = adapt & (res_prim > cfg.mu_thresh * res_dual)
            dec = adapt & ~inc & (res_dual > cfg.mu_thresh * res_prim)
            fire = inc | dec
            if cfg.rho_sync:
                # batch-synchronous: every rho change on a shared iteration;
                # it = 0 excluded (rho0 was applied that very iteration)
                apply = fire & ((s.it % cfg.rho_update_period == 0) & (s.it > 0))
            else:
                apply = fire & (s.cpt % cfg.rho_update_period == 0)
            app_inc, app_dec = apply & inc, apply & dec
            flip_inc = app_inc & (s.rho_up == -1)
            flip_dec = app_dec & (s.rho_up == 1)
            damped_inc = 1.0 + damp * (s.tau_inc - 1.0)
            damped_dec = 1.0 + damp * (s.tau_dec - 1.0)
            if damp_both_taus:
                damp_mask = flip_inc | flip_dec
                tau_inc = torch.where(damp_mask, damped_inc, s.tau_inc)
                tau_dec = torch.where(damp_mask, damped_dec, s.tau_dec)
            else:
                tau_inc = torch.where(flip_inc, damped_inc, s.tau_inc)
                tau_dec = torch.where(flip_dec, damped_dec, s.tau_dec)
            rho = torch.where(app_inc, s.rho * tau_inc,
                              torch.where(app_dec, s.rho / tau_dec, s.rho))
            rho_up = torch.where(app_inc, 1, torch.where(app_dec, -1, s.rho_up)).to(torch.int32)
            cpt = s.cpt + fire.to(torch.int32)
            if use_chol:
                # the inverse is a pure function of (P, rho): recomputing it
                # for the whole batch leaves the unchanged problems' as it was.
                # It is recomputed into the carried matrix, so both branches
                # return that one tensor and neither copies it
                fact_inv = control.cond((app_inc | app_dec).any(),
                                        lambda: s.fact_inv.copy_(inv_fn(rho + mu_prox)),
                                        lambda: s.fact_inv)
        else:
            tau_inc, tau_dec, rho, rho_up, cpt = s.tau_inc, s.tau_dec, s.rho, s.rho_up, s.cpt

        m = active[:, None]
        if cfg.accel:
            # fast-ADMM momentum with a per-problem restart: the carried
            # (l2, u) become the extrapolated point the next iteration starts
            # from; l2_plain / u_plain keep the solution candidates. Momentum
            # resets where the combined residual fails to shrink by accel_eta.
            c_new = s.rho * (torch.sum((l2 - r) ** 2, dim=-1) + torch.sum((l2 - s.l2) ** 2, dim=-1))
            restart = c_new > cfg.accel_eta * s.acc_c
            a_new = torch.where(restart, torch.ones_like(s.acc_a),
                                0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * s.acc_a**2)))
            # newly converged problems freeze at the plain iterate
            beta = torch.where(restart | newly, torch.zeros_like(a_new),
                               (s.acc_a - 1.0) / a_new)[:, None]
            l2_c = l2 + beta * (l2 - s.l2_plain)
            u_c = u + beta * (u - s.u_plain)
            acc_a = torch.where(active, a_new, s.acc_a)
            acc_c = torch.where(active, torch.where(restart, s.acc_c / cfg.accel_eta, c_new),
                                s.acc_c)
            l2_plain = torch.where(m, l2, s.l2_plain)
            u_plain = torch.where(m, u, s.u_plain)
        else:
            l2_c, u_c = l2, u
            acc_a, acc_c, l2_plain, u_plain = s.acc_a, s.acc_c, s.l2_plain, s.u_plain
        converged = s.converged | (active & newly)
        return ADMMState(
            it=s.it + 1,
            l=torch.where(m, l, s.l),
            l2=torch.where(m, l2_c, s.l2),
            u=torch.where(m, u_c, s.u),
            q_prox=torch.where(m, q_prox, s.q_prox),
            rho=rho, tau_inc=tau_inc, tau_dec=tau_dec, rho_up=rho_up, cpt=cpt,
            converged=converged,
            # eps-certified vs noise-floor stall
            stalled=s.stalled | (active & newly & ~certified),
            iters=s.iters + active.to(torch.int32),
            res_prim=torch.where(active, res_prim, s.res_prim),
            res_dual=torch.where(active, res_dual, s.res_dual),
            # the rho these residuals were computed with, before this update
            rho_res=torch.where(active, s.rho, s.rho_res),
            all_done=converged.all(),
            fact_inv=fact_inv,
            l2_plain=l2_plain, u_plain=u_plain, acc_a=acc_a, acc_c=acc_c,
        )

    return cond, body, state0
