"""Differentiable rigid-contact simulation (port of models/contact_sim.py):
B independent point masses sliding on a horizontal plane under gravity and
external pushes, each step's contact impulses from the solvers, gradients
flowing through both solves into the physical parameters (mass, friction
coefficient).

Per step (explicit velocity-level time stepping, dt fixed):

  1. free velocity   v* = v + dt * (f_ext / m + g_vec)
  2. normal impulse  a diagonal-P non-negative QP per body, P = 1/m (the
                     Delassus operator of one point contact), q = v*_z,
                     with a dummy second coordinate (q = 1, so l = 0);
  3. friction        a diagonal-P 2-D friction-cone QCQP per body,
                     P = 1/m, q = v*_xy, radius mu l_n;
  4. integrate       v' = v* + (l_t, l_n) / m; x' = x + dt v', z clamped at 0.

A diagonal P launches no kernel (the eager engine and the closed-form
adjoints, as in the JAX package). ``simulate`` rolls the step with a Python
loop (the JAX package's ``lax.scan``), carrying each step's impulses as the
next step's primal and dual warm start, and reads nothing on the host, so
that a CUDA graph can hold the whole rollout (unrolled, as ``lax.scan`` is,
each solve's loop a WHILE node: ``utils/control.py``);
``make_system_id_step`` wraps the rollout in an Adam step over (log-mass,
logit-mu), staged on the card as the JAX package jits it. Every solve runs
on ``device`` (the card by default, raising without CUDA; ``device="cpu"``
for the plain path). ``params_from_numpy`` carries the JAX package's
``ContactParams`` / ``ContactState`` into the port's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..api import solve_qcqp_with_stats, solve_qp_with_stats
from ..config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig
from ..utils.shapes import fields_from_numpy
from ..utils.staging import staged

__all__ = [
    "QP_CFG",
    "QCQP_CFG",
    "ContactState",
    "ContactParams",
    "params_from_numpy",
    "simulate",
    "trajectory_loss",
    "make_system_id_step",
]

QP_CFG = QP_DEFAULTS.replace(eps=1e-7, max_iter=200)
QCQP_CFG = QCQP_DEFAULTS.replace(eps=1e-7, max_iter=200)


class ContactState(NamedTuple):
    x: torch.Tensor      # (B, 3) position (z is the height above the plane)
    v: torch.Tensor      # (B, 3) velocity


class ContactParams(NamedTuple):
    mass: torch.Tensor   # (B,) strictly positive
    mu: torch.Tensor     # (B,) friction coefficient in (0, 1]


def params_from_numpy(p, device="cuda", dtype: Optional[torch.dtype] = None):
    """The JAX package's ``ContactParams`` or ``ContactState`` (or a named
    tuple of arrays with the same fields) as the port's, each field a tensor
    on ``device`` (in ``dtype``, default: the arrays')."""
    return fields_from_numpy(ContactParams if hasattr(p, "mass") else ContactState, p,
                             device, dtype)


def _step(params: ContactParams, state: ContactState, f_ext: torch.Tensor, dt: float,
          qp_cfg: SolverConfig, qcqp_cfg: SolverConfig, impulses=None, device="cuda"):
    """One step: (new state, this step's impulses (l_n (B,), l_t (B, 2)),
    the two solves' batch-mean iterations). ``impulses``, the previous
    step's, warm-start both solves, primal and dual (``warm_start_dual``:
    primal-only warm starts do not cut ADMM iterations)."""
    m = params.mass
    B = m.shape[0]
    g = torch.zeros(3, dtype=state.v.dtype, device=state.v.device)
    g[2:].fill_(-9.81)      # a fill on the device: no copy from the host
    v_free = state.v + dt * (f_ext / m[:, None] + g)
    # contact activity: near the plane and approaching it
    touching = (state.x[:, 2] <= 1e-3) & (v_free[:, 2] <= 0.0)

    ws_n = ws_t = None
    if impulses is not None:
        prev_n, prev_t = impulses
        ws_n = torch.stack([prev_n, torch.zeros_like(prev_n)], dim=-1)
        ws_t = prev_t
        qp_cfg = qp_cfg.replace(warm_start_dual=True)
        qcqp_cfg = qcqp_cfg.replace(warm_start_dual=True)

    # normal impulse: P = 1/m, q = v*_z where touching (else q > 0, so l = 0);
    # the dummy second coordinate (q = 1, l = 0) keeps q two wide
    P = (1.0 / m)[:, None].expand(B, 2)
    q_z = torch.where(touching, v_free[:, 2], torch.ones_like(v_free[:, 2]))
    q_n = torch.stack([q_z, torch.ones_like(q_z)], dim=-1)
    l_n_full, st_n = solve_qp_with_stats(P, q_n, ws_n, config=qp_cfg, device=device)
    l_n = l_n_full[:, 0]

    # friction impulse: one 2-D cone per body, radius mu l_n; the minimiser of
    # 1/2 l^2/m + l.v is -m v clipped to the cone
    l_t, st_t = solve_qcqp_with_stats(P, v_free[:, :2], l_n[:, None], params.mu[:, None], ws_t,
                                      config=qcqp_cfg, device=device)

    v_new = v_free + torch.cat([l_t, l_n[:, None]], dim=-1) / m[:, None]
    x_new = state.x + dt * v_new
    # out of place (an in-place write would break autograd through the
    # rollout); torch.maximum splits a tie's gradient as jnp.maximum does
    z = x_new[:, 2:]
    x_new = torch.cat([x_new[:, :2], torch.maximum(z, torch.zeros_like(z))], dim=-1)
    iters = (st_n.iterations.float().mean(), st_t.iterations.float().mean())
    return ContactState(x=x_new, v=v_new), (l_n, l_t), iters


def simulate(
    params: ContactParams,
    state0: ContactState,
    f_ext: torch.Tensor,                 # (T, B, 3)
    dt: float = 0.01,
    qp_cfg: SolverConfig = QP_CFG,
    qcqp_cfg: SolverConfig = QCQP_CFG,
    warm_start: bool = True,
    return_stats: bool = False,
    device="cuda",
):
    """Roll T steps: (final state, the trajectory of states, each field (T,
    B, 3)), plus, with ``return_stats``, {'qp_iters': (T,), 'qcqp_iters':
    (T,)} of per-step batch-mean solver iterations. ``warm_start`` carries
    each step's impulses into the next step's solves (primal and dual);
    the solutions are eps-converged either way, so warm and cold
    trajectories agree to solver tolerance."""
    B = state0.x.shape[0]
    zeros = state0.x.new_zeros
    imp = (zeros(B), zeros(B, 2))
    state, xs, vs, its = state0, [], [], []
    for f in f_ext:
        state, imp, iters = _step(params, state, f, dt, qp_cfg, qcqp_cfg,
                                  impulses=imp if warm_start else None, device=device)
        xs.append(state.x)
        vs.append(state.v)
        its.append(iters)
    traj = ContactState(x=torch.stack(xs), v=torch.stack(vs))
    if return_stats:
        qp_it, qc_it = (torch.stack(x) for x in zip(*its))
        return state, traj, {"qp_iters": qp_it, "qcqp_iters": qc_it}
    return state, traj


def trajectory_loss(params: ContactParams, state0: ContactState, f_ext: torch.Tensor,
                    target_x: torch.Tensor, dt: float = 0.01, device="cuda") -> torch.Tensor:
    """Mean squared error between the simulated and the observed positions
    (T, B, 3): gradients flow through every solve of every step."""
    _, traj = simulate(params, state0, f_ext, dt, device=device)
    return torch.mean((traj.x - target_x) ** 2)


def make_system_id_step(raw: dict, state0: ContactState, f_ext: torch.Tensor,
                        target_x: torch.Tensor, dt: float = 0.01,
                        learning_rate: float = 1e-2, device="cuda"):
    """An Adam step over the raw parameters ``raw`` = {'log_mass': (B,),
    'logit_mu': (B,)}, leaf tensors that require grad and are updated in
    place by ``torch.optim.Adam(learning_rate)`` (optax.adam's defaults).
    Returns (step, raw_to_params); ``step()`` returns the loss before the
    update (detached). On the card the step is staged as one CUDA graph
    (``utils.staged``, the JAX package's ``jax.jit``: a few eager steps,
    then replays) over ``Adam(capturable=True)``, whose state stays on the
    device; on the CPU it runs eagerly over a plain Adam."""
    on_card = torch.device(device).type == "cuda"
    optimizer = torch.optim.Adam(list(raw.values()), lr=learning_rate, capturable=on_card)

    def raw_to_params(r: dict) -> ContactParams:
        return ContactParams(mass=torch.exp(r["log_mass"]), mu=torch.sigmoid(r["logit_mu"]))

    def train(x0, v0, f, target):
        optimizer.zero_grad(set_to_none=True)
        loss = trajectory_loss(raw_to_params(raw), ContactState(x0, v0), f, target, dt,
                               device=device)
        loss.backward()
        optimizer.step()
        return loss.detach()

    run = staged(train) if on_card else train

    def step() -> torch.Tensor:
        return run(state0.x, state0.v, f_ext, target_x)

    step.staged = run if on_card else None      # the Staged object, or None on the CPU
    return step, raw_to_params
