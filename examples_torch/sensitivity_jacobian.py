"""Full-Jacobian sensitivity API on the port: dl/dq and the friction
parameters' Jacobians.

``dqt.qcqp_jacobian`` assembles the KKT system once and solves all n
right-hand sides together (diff/jacobian.py), where autograd through the
solver needs one backward pass per output coordinate. The twin of
examples/sensitivity_jacobian.py: the assembled Jacobian against
``torch.autograd.functional.jacobian`` over the solver.

Run: python examples_torch/sensitivity_jacobian.py    # on the card
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import diffqcqp_tpu_torch as dqt


def main(device="cuda"):
    """Returns max |autograd - assembled| of dl/dq."""
    rng = np.random.default_rng(0)
    B, nc = 4, 3          # four 3-contact problems, float64
    n = 2 * nc
    S = rng.standard_normal((B, n, n)) / np.sqrt(n)
    t = lambda x: torch.tensor(x, device=device)  # noqa: E731
    P = t(S @ S.transpose(0, 2, 1) + 0.5 * np.eye(n))
    q = t(rng.standard_normal((B, n)) * 0.5)
    l_n = t(rng.random((B, nc)) * 0.5 + 0.05)    # normal forces
    mu = t(rng.random((B, nc)) * 0.5 + 0.05)     # friction coefficients

    # ---- QCQP: tangential friction forces and their full sensitivities
    jac = dqt.qcqp_jacobian(P, q, l_n, mu, device=device)
    print("dl_dq   ", tuple(jac.dl_dq.shape))     # (B, n, n)
    print("dl_dl_n ", tuple(jac.dl_dl_n.shape))   # (B, n, nc)
    print("dl_dmu  ", tuple(jac.dl_dmu.shape))    # (B, n, nc)

    # uncertainty propagation: Sigma_l = J_mu Sigma_mu J_mu^T
    sigma_mu = 0.05 ** 2 * torch.eye(nc, dtype=P.dtype, device=device)
    sigma_l = torch.einsum("bic,cd,bjd->bij", jac.dl_dmu, sigma_mu, jac.dl_dmu)
    print("force std from mu uncertainty:",
          float(torch.sqrt(torch.diagonal(sigma_l, dim1=1, dim2=2)).max()))

    # ---- consistency: one assembled system == autograd row by row
    J_ad = torch.autograd.functional.jacobian(
        lambda q_: dqt.solve_qcqp(P, q_, l_n, mu, device=device), q)
    # (B, n, B, n) over the batched solver: the problems are independent,
    # so take the block diagonal -> (B, n, n)
    J_ad = torch.diagonal(J_ad, dim1=0, dim2=2).permute(2, 0, 1)
    err = float((J_ad - jac.dl_dq).abs().max())
    print("max |autograd - assembled| :", err)
    tol = 1e-10 if J_ad.dtype == torch.float64 else 1e-5
    assert err < tol, (err, tol)

    # ---- QP: dl/dq of the non-negative QP
    qp_jac = dqt.qp_jacobian(P, q, device=device)
    print("qp dl_dq", tuple(qp_jac.dl_dq.shape))
    print("ok")
    return err


if __name__ == "__main__":
    main()
