"""Differentiable-physics system identification (the reference's paper use
case) on the port: recover per-body mass and friction coefficient from
observed sliding trajectories, by gradient descent through the QP/QCQP
contact solves of every simulation step. The twin of
examples/contact_system_id.py (torch.optim.Adam in place of optax.adam).

Run: python examples_torch/contact_system_id.py       # on the card
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from diffqcqp_tpu_torch.models.contact_sim import (
    ContactParams,
    ContactState,
    make_system_id_step,
    simulate,
)


def main(device="cuda", steps=201, B=16, T=60):
    """Run ``steps`` Adam steps; returns the losses."""
    DT = 0.01
    rng = np.random.default_rng(0)
    t = lambda x: torch.tensor(x, device=device)  # noqa: E731
    true = ContactParams(mass=t(rng.uniform(0.7, 1.4, B)), mu=t(rng.uniform(0.15, 0.8, B)))
    state0 = ContactState(
        x=torch.zeros((B, 3), dtype=torch.float64, device=device),
        v=t(np.c_[rng.uniform(0.5, 2.0, B), rng.uniform(-1, 1, B), np.zeros(B)]),
    )
    f_ext = t(rng.normal(0, 0.3, (T, B, 3)).clip(-1, 1))

    _, traj = simulate(true, state0, f_ext, dt=DT, device=device)
    target = traj.x
    print(f"observed {T} steps of {B} bodies")

    raw = {"log_mass": torch.zeros(B, dtype=torch.float64, device=device, requires_grad=True),
           "logit_mu": torch.zeros(B, dtype=torch.float64, device=device, requires_grad=True)}
    step, raw_to_params = make_system_id_step(raw, state0, f_ext, target, DT,
                                              learning_rate=5e-2, device=device)
    losses = []
    for k in range(steps):
        losses.append(float(step()))
        if k % 50 == 0:
            with torch.no_grad():
                est = raw_to_params(raw)
                mu_err = float((est.mu - true.mu).abs().median())
                m_err = float((est.mass - true.mass).abs().median())
            print(f"step {k:4d}  loss {losses[-1]:.3e}  "
                  f"median |mu err| {mu_err:.3f}  median |mass err| {m_err:.3f}")
    with torch.no_grad():
        est = raw_to_params(raw)
    print("true mu   :", np.round(true.mu[:6].cpu().numpy(), 3))
    print("learned mu:", np.round(est.mu[:6].cpu().numpy(), 3))
    return losses


if __name__ == "__main__":
    main()
