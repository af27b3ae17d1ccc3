"""Plain reference of one Adam step of system identification through the
QP and the friction-cone QCQP (``run_benchmarks.py`` config 4).

A job's parameters are S (N, N), q (N), log_l_n and logit_mu (nc); its
problems are

    P = S S' + reg I,   l_qp = argmin 1/2 l'Pl + q'l  s.t.  l >= 0,
    l_qc = argmin 1/2 l'Pl + q'l  s.t.  ||l_(i)|| <= exp(log_l_n_i) sigmoid(logit_mu_i),

and the loss over the B jobs of a step is mean((l_qp - t)^2) +
mean((l_qc - t)^2), each mean over all B N entries. Written from that
statement alone in plain torch: l through ``reference/nnqp.py`` and
``reference/qcqp.py``, the four gradients by the chain rule through their
``gradients`` (dL/dS = (dP + dP') S, dL/dlog_l_n = dL/dl_n l_n,
dL/dlogit_mu = dL/dmu mu (1 - mu)), then Adam's update (Kingma and Ba,
as ``torch.optim.Adam`` states it: t' = t + 1, m' = b1 m + (1 - b1) g,
v' = b2 v + (1 - b2) g^2, update = -lr (m' / (1 - b1^t')) / (sqrt(v' /
(1 - b2^t')) + eps)). It imports nothing of the package under test.

Departures from config 4: none in the law, the sizes or the settings. The
step starts from a given Adam state (the moments and the step count of a
pool slot) where config 4's loop carries its own; the reference solves
to float64 rounding (ADMM then a polish on the active set) where the
program solves to eps = 1e-7 in float32; and the ``tf32`` control runs
the maps and the two references in float32 with TF32 operands, and Adam in
float32.
"""

from __future__ import annotations

import torch

import portbench.reference.nnqp as nnqp
import portbench.reference.qcqp as qcqp
from portbench.reference.qcqp import _Arith

__all__ = ["Step", "maps", "step"]


class Step:
    """A block of reference steps: ``l`` (2B, N: the QPs' rows, then the
    QCQPs'), ``grads`` and ``updates`` (S, q, log_l_n, logit_mu each), the
    two ``Solution``s and the loss."""

    def __init__(self, l, grads, updates, sol_qp, sol_qc, loss):
        self.l, self.grads, self.updates = l, grads, updates
        self.sol_qp, self.sol_qc, self.loss = sol_qp, sol_qc, loss


def maps(S, q, log_l_n, logit_mu, reg, ar: _Arith):
    """(P, q, l_n, mu): P = S S' + reg I, exp and the logistic sigmoid."""
    n = S.shape[-1]
    P = torch.matmul(ar.r(S), ar.r(S).transpose(-1, -2))
    P = P + reg * torch.eye(n, dtype=S.dtype, device=S.device)
    return P, q, torch.exp(log_l_n), 1.0 / (1.0 + torch.exp(-logit_mu))


def step(params, target, exp_avg, exp_avg_sq, t, *, reg, lr, betas, eps,
         precision: str = "float64") -> Step:
    """One reference step of a block of jobs. ``params``, ``exp_avg`` and
    ``exp_avg_sq`` are (S, q, log_l_n, logit_mu)-ordered tuples of (B, ...)
    tensors, ``t`` the step count before the step (a number or 0-d tensor);
    inputs of any float dtype and device."""
    ar = _Arith(precision)
    S, q, log_l_n, logit_mu = (x.to(ar.dtype) for x in params)
    target = target.to(ar.dtype)
    P, q, l_n, mu = maps(S, q, log_l_n, logit_mu, reg, ar)
    sol_qp = nnqp.solve(P, q, precision=precision)
    sol_qc = qcqp.solve(P, q, l_n, mu, precision=precision)
    count = target.numel()
    loss = ((sol_qp.l - target) ** 2).sum() / count + ((sol_qc.l - target) ** 2).sum() / count
    dP_qp, dq_qp = nnqp.gradients(sol_qp, 2.0 * (sol_qp.l - target) / count)
    dP_qc, dq_qc, dl_n, dmu = qcqp.gradients(sol_qc, 2.0 * (sol_qc.l - target) / count, l_n, mu)
    dP = dP_qp + dP_qc
    dS = torch.matmul(ar.r(dP + dP.transpose(-1, -2)), ar.r(S))
    grads = (dS, dq_qp + dq_qc, dl_n * l_n, dmu * mu * (1.0 - mu))
    b1, b2 = betas
    t1 = float(t) + 1.0
    updates = []
    for g, m, v in zip(grads, exp_avg, exp_avg_sq):
        m = b1 * m.to(ar.dtype) + (1.0 - b1) * g
        v = b2 * v.to(ar.dtype) + (1.0 - b2) * g * g
        updates.append(-lr * (m / (1.0 - b1 ** t1)) / (torch.sqrt(v / (1.0 - b2 ** t1)) + eps))
    return Step(torch.cat([sol_qp.l, sol_qc.l]), grads, tuple(updates), sol_qp, sol_qc, loss)
