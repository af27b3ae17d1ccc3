"""Contact-force multipliers and their sensitivities, on the card.

A physics user mid-simulation wants the friction-cone multipliers gamma
(which contacts slide on their cone boundary, and how hard) and the raw KKT
sensitivities (dgamma, dl against a chosen cotangent), in working precision
on the solver's device. The twin of examples/contact_multipliers.py:
float32 problems (forward K1, backward K2 on the card).

Run: python examples_torch/contact_multipliers.py     # on the card
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import diffqcqp_tpu_torch as dqt


def main(device="cuda"):
    """Returns (sliding contacts, max |autograd - derivatives surface|)."""
    # friction QCQPs like one simulator step's, 4 contacts a problem
    B, NC = 64, 4
    N = 2 * NC
    rng = np.random.default_rng(0)
    S = (rng.standard_normal((B, N, N)) / np.sqrt(N)).astype(np.float32)
    t = lambda x: torch.tensor(x, device=device)  # noqa: E731
    P = t(S @ S.transpose(0, 2, 1) + 0.1 * np.eye(N, dtype=np.float32))
    q = t((rng.standard_normal((B, N)) * 0.5).astype(np.float32))
    l_n = t((rng.random((B, NC)) * 0.5 + 0.05).astype(np.float32))
    mu = t((rng.random((B, NC)) * 0.5 + 0.05).astype(np.float32))

    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400)
    l, stats = dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg, device=device)
    assert bool(stats.converged.all())

    # multipliers: gamma_i > 0 <=> contact i slides on its cone boundary
    gamma = dqt.recover_qcqp_duals(P, q, l_n, mu, l, config=cfg, device=device)
    sliding = gamma > 1e-6
    print(f"sliding contacts: {int(sliding.sum())} / {sliding.numel()} "
          f"(max gamma {float(gamma.max()):.3f})")
    # a sliding contact sits on its cone boundary
    norms = l.reshape(B, NC, 2).norm(dim=-1)
    radii = l_n * mu
    on_boundary = (norms - radii).abs() <= 1e-5 * radii.clamp_min(1.0)
    assert bool(on_boundary[sliding].all()), "sliding contact off its cone boundary"

    # raw KKT sensitivities against a cotangent (d sum(l) / d inputs)
    d = dqt.qcqp_derivatives(P, q, l_n, mu, l, torch.ones_like(l), config=cfg, device=device)
    grad_l_n, grad_mu = d.e2 * d.dgamma, d.e1 * d.dgamma     # the reference's assembly
    print(f"max |d sum(l) / d l_n| = {float(grad_l_n.abs().max()):.4f}, "
          f"max |d sum(l) / d mu| = {float(grad_mu.abs().max()):.4f}")

    # the same numbers as autograd through the solver (the derivatives
    # surface is the backward's machinery, exported)
    ln_, mu_ = l_n.clone().requires_grad_(), mu.clone().requires_grad_()
    gl = torch.autograd.grad(dqt.solve_qcqp(P, q, ln_, mu_, config=cfg, device=device).sum(),
                             (ln_, mu_))
    err = max(float((gl[0] - grad_l_n).abs().max()), float((gl[1] - grad_mu).abs().max()))
    assert err <= 1e-6, err
    print("derivatives surface == autograd through the solver: OK")
    return int(sliding.sum()), err


if __name__ == "__main__":
    main()
