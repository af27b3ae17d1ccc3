"""The reference's autograd binding ``QCQPFn2`` over the port's solver.

``QCQPFn2.apply(P, q, l_n, mu, warm_start, eps, max_iter, mu_prox=1e-7)``
keeps the reference's signature and layouts: vectors are (B, N, 1) columns
there, and (B, N) is accepted too. It delegates to ``solve_qcqp``, whose
autograd Function carries the gradients (forward K1, backward K2 on the
card), with no JAX and no numpy round trip; results come back on the
caller's device and in the caller's dtype.

``set_backend`` picks where the solve runs: ``'cuda'`` (the default; raises
without CUDA) or ``'cpu'`` (the plain PyTorch path in the input dtype).
The QP-family bindings (``QPFn2``, ``BoxQPFn2``, ``SignedBoxQPFn2``) come with
the QP-family solvers (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from .api import _device, solve_qcqp

__all__ = ["QCQPFn2", "set_backend"]

_BACKEND = "cuda"


def set_backend(name: str) -> None:
    """Run the bindings on ``'cuda'`` (the default) or ``'cpu'``."""
    global _BACKEND
    if name not in ("cuda", "cpu"):
        raise ValueError(f"backend must be 'cuda' or 'cpu', got {name!r}")
    _BACKEND = name


class QCQPFn2:
    """Friction-cone QCQP, reference signature:
    ``QCQPFn2.apply(P, q, l_n, mu, warm_start, eps, max_iter, mu_prox=1e-7)``.
    l_n and mu are (B, nc, 1) or (B, nc); the radius mu * l_n is formed
    inside."""

    @staticmethod
    def apply(P, q, l_n, mu, warm_start, eps, max_iter, mu_prox=1e-7) -> torch.Tensor:
        dev = _device(_BACKEND)
        l = solve_qcqp(
            *(x.to(dev) for x in (P, q, l_n, mu, warm_start)),
            eps=float(eps), max_iter=int(max_iter), mu_prox=float(mu_prox), device=dev,
        )
        return l.to(device=q.device, dtype=q.dtype)
