"""The reference's autograd bindings over the port's solvers: ``QPFn2``,
``BoxQPFn2``, ``SignedBoxQPFn2`` and ``QCQPFn2``.

Each keeps the reference's ``apply`` signature and layouts: vectors are
(B, N, 1) columns there, and (B, N) is accepted too. ``apply`` delegates to
the matching entry point (``solve_qp``, ``solve_box_qp``,
``solve_signed_box_qp``, ``solve_qcqp``), whose autograd Function carries the
gradients (forward K1, backward K4 or K2 on the card), with no JAX and no
numpy round trip; results come back on the caller's device and in the
caller's dtype. As in the JAX package's bindings, the box backward works and
the signed box's differentiates the sign constraint too (the reference's do
neither), and grad_P is the symmetrised -(dl l^T + l dl^T) / 2.

``set_backend`` picks where the solve runs: ``'cuda'`` (the default; raises
without CUDA) or ``'cpu'`` (the plain PyTorch path in the input dtype).
"""

from __future__ import annotations

import torch

from .api import _device, solve_box_qp, solve_qcqp, solve_qp, solve_signed_box_qp

__all__ = ["QPFn2", "BoxQPFn2", "SignedBoxQPFn2", "QCQPFn2", "set_backend"]

_BACKEND = "cuda"


def set_backend(name: str) -> None:
    """Run the bindings on ``'cuda'`` (the default) or ``'cpu'``."""
    global _BACKEND
    if name not in ("cuda", "cpu"):
        raise ValueError(f"backend must be 'cuda' or 'cpu', got {name!r}")
    _BACKEND = name


def _apply(solve, tensors, like, eps, max_iter, mu_prox) -> torch.Tensor:
    dev = _device(_BACKEND)
    l = solve(
        *(x.to(dev) for x in tensors),
        eps=float(eps), max_iter=int(max_iter), mu_prox=float(mu_prox), device=dev,
    )
    return l.to(device=like.device, dtype=like.dtype)


class QPFn2:
    """Non-negative QP, reference signature:
    ``QPFn2.apply(P, q, warm_start, eps, max_iter, mu_prox=1e-7)``."""

    @staticmethod
    def apply(P, q, warm_start, eps, max_iter, mu_prox=1e-7) -> torch.Tensor:
        return _apply(solve_qp, (P, q, warm_start), q, eps, max_iter, mu_prox)


class BoxQPFn2:
    """Box QP, reference signature: ``BoxQPFn2.apply(P, q, l_min, l_max,
    warm_start, eps, max_iter, mu_prox=1e-7)``."""

    @staticmethod
    def apply(P, q, l_min, l_max, warm_start, eps, max_iter, mu_prox=1e-7) -> torch.Tensor:
        return _apply(solve_box_qp, (P, q, l_min, l_max, warm_start), q, eps, max_iter, mu_prox)


class SignedBoxQPFn2:
    """Signed-box QP, reference signature: ``SignedBoxQPFn2.apply(P, q,
    l_min, l_max, v, warm_start, eps, max_iter, mu_prox=1e-7)``."""

    @staticmethod
    def apply(P, q, l_min, l_max, v, warm_start, eps, max_iter, mu_prox=1e-7) -> torch.Tensor:
        return _apply(solve_signed_box_qp, (P, q, l_min, l_max, v, warm_start), q,
                      eps, max_iter, mu_prox)


class QCQPFn2:
    """Friction-cone QCQP, reference signature:
    ``QCQPFn2.apply(P, q, l_n, mu, warm_start, eps, max_iter, mu_prox=1e-7)``.
    l_n and mu are (B, nc, 1) or (B, nc); the radius mu * l_n is formed
    inside."""

    @staticmethod
    def apply(P, q, l_n, mu, warm_start, eps, max_iter, mu_prox=1e-7) -> torch.Tensor:
        return _apply(solve_qcqp, (P, q, l_n, mu, warm_start), q, eps, max_iter, mu_prox)
