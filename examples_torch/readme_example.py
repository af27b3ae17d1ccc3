"""The reference README's training example (README.md:29-56) on the port.

10 independent N=8 diagonal-P non-negative QPs; torch.optim.Adam optimises
q so that the QP solutions match target forces. P uses the diagonal form
(no kernel: the eager engine and the closed-form adjoint), batched in one
solve a step. The twin of examples/readme_example.py.

Run: python examples_torch/readme_example.py          # on the card
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import diffqcqp_tpu_torch as dqt


def main(device="cuda", steps=501):
    """Train q for ``steps`` Adam steps; returns (first loss, last loss,
    the final SolveStats)."""
    B, N = 10, 8
    rng = np.random.default_rng(0)
    P_diag = torch.tensor(rng.random((B, N)) + 0.5, device=device)       # (B, N) diagonal P
    # all-free initialisation (q < 0: every coordinate strictly positive): a
    # coordinate pinned at l=0 has a zero gradient and would never revive
    q = torch.tensor(-np.abs(rng.standard_normal((B, N))) - 0.1, device=device,
                     requires_grad=True)
    target = dqt.solve_qp(P_diag, torch.tensor(-np.abs(rng.standard_normal((B, N))) - 0.1,
                                               device=device), eps=1e-9, device=device)
    opt = torch.optim.Adam([q], lr=5e-2)
    losses = []
    for k in range(steps):
        opt.zero_grad()
        l = dqt.solve_qp(P_diag, q, eps=1e-9, max_iter=2000, device=device)
        loss = torch.mean((l - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if k % 100 == 0:
            print(f"step {k:4d}  loss {losses[-1]:.3e}")
    with torch.no_grad():
        l, stats = dqt.solve_qp_with_stats(P_diag, q, eps=1e-9, max_iter=2000, device=device)
    print(f"final: all converged={bool(stats.converged.all())}, "
          f"mean iters={float(stats.iterations.float().mean()):.1f}, "
          f"max |l - target|={float((l - target).abs().max()):.2e}")
    return losses[0], losses[-1], stats


if __name__ == "__main__":
    main()
