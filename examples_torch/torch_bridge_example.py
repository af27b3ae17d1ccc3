"""The reference's autograd.Function API (qcqp.py) on the port.

Existing diffqcqp users change one import:
    from qcqp import QCQPFn2                                  # reference
    from diffqcqp_tpu_torch.torch_autograd import QCQPFn2     # the port

The twin of examples/torch_bridge_example.py: learn the friction
coefficients mu that reproduce target forces, float64.

Run: python examples_torch/torch_bridge_example.py    # on the card
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from diffqcqp_tpu_torch import torch_autograd
from diffqcqp_tpu_torch.torch_autograd import QCQPFn2


def main(device="cuda", steps=301):
    """Run ``steps`` Adam steps; returns (first loss, last loss, the median
    learned / initial mu ratio; the target's is 0.8)."""
    torch_autograd.set_backend("cuda" if torch.device(device).type == "cuda" else "cpu")
    torch.manual_seed(0)
    B, NC = 32, 4
    N = 2 * NC
    rng = np.random.default_rng(0)
    S = rng.standard_normal((B, N, N))
    t = lambda x: torch.tensor(x, dtype=torch.float64, device=device)  # noqa: E731
    P = t(S @ S.transpose(0, 2, 1) + 0.1 * np.eye(N))
    q = t(rng.standard_normal((B, N)))
    l_n = t(rng.random((B, NC)) * 0.5 + 0.1)
    mu = t(rng.random((B, NC)) * 0.5 + 0.1).requires_grad_()
    ws = torch.zeros((B, N), dtype=torch.float64, device=device)

    mu0 = mu.detach().clone()
    target = QCQPFn2.apply(P, q, l_n, mu0 * 0.8, ws, 1e-10, 2000).detach()

    opt = torch.optim.Adam([mu], lr=2e-2)
    losses = []
    for k in range(steps):
        opt.zero_grad()
        l = QCQPFn2.apply(P, q, l_n, mu, ws, 1e-10, 2000)
        loss = ((l - target) ** 2).mean()
        loss.backward()
        opt.step()
        with torch.no_grad():
            mu.clamp_(0.01, 1.0)
        losses.append(float(loss.detach()))
        if k % 75 == 0:
            print(f"step {k:4d}  loss {losses[-1]:.3e}")
    ratio = float((mu.detach() / mu0).median())
    print(f"median learned/initial mu ratio (target 0.8): {ratio:.3f}")
    return losses[0], losses[-1], ratio


if __name__ == "__main__":
    main()
