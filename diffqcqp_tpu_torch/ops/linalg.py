"""Batched dense linear algebra for the ADMM engine and the adjoint solves
(port of ops/linalg.py).

The engine's two linear-solve modes (``solvers/admm.py``):

  * the SPECTRAL handle: one batched symmetric eigendecomposition P = V
    diag(lam) V^T up front (``factorize``), after which
    (P + c I)^{-1} x = V ((V^T x) / (lam + c)) for any shift c
    (``solve_shifted``), so every adaptive-rho change is free;
  * the explicit INVERSE of P + (rho + mu) I, refactored only when rho
    changes: Newton-Schulz in float32 (``ns_inverse_shifted``, matrix
    products only, with a measured stopping rule), batched Cholesky in
    float64 (``chol_inverse_shifted``).

A diagonal P (B, N) takes the element-wise path of ``factorize`` /
``solve_shifted`` / ``power_iteration``, as in the JAX package.

Under a CUDA graph capture (``utils/staging.py``) nothing here reads the
device on the host: the Newton-Schulz loop runs through
``utils/control.py::while_loop`` (a WHILE node); ``factorize`` takes the
hand-written Jacobi kernel E1 (``kernels/eigh_cuda.py``) on the card,
eagerly and under a capture alike, since ``torch.linalg.eigh`` checks its
info on the host; the factorizations go through ``cholesky`` and
``solve``, which take the forms without the host's check (``cholesky``
under a capture, ``solve`` on the card eagerly too, so that a staged step
gives the eager step's bits) and give NaN where a factor failed, as the
JAX package's do. On CPU tensors ``factorize`` keeps ``torch.linalg.eigh``
(LAPACK), the counterpart of the JAX package's ``jnp.linalg.eigh`` there.

Every matrix product here is a full float32 (or float64) product: the port
never turns TF32 on, because the Newton-Schulz inverses and the solves lose
~1e-2 of relative accuracy at TF32's ~1e-3 rounding (the JAX package pins
``Precision.HIGHEST`` on every solve-path product for the same reason).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.eigh_cuda import eigh_cuda
from ..utils import control
from ..utils.shapes import fold_vmapped, unfold_vmapped

__all__ = [
    "Factorization",
    "cholesky",
    "factorize",
    "solve",
    "solve_shifted",
    "chol_inverse_shifted",
    "spd_cholesky_solve",
    "newton_schulz_inverse",
    "newton_schulz_inverse_adaptive",
    "ns_inverse_shifted",
    "power_iteration",
    "linf_norm",
    "refine_solve",
]


class Factorization(NamedTuple):
    """Spectral handle on a batch of SPD matrices: eigvals (B, N) and
    eigvecs (B, N, N) for dense P, or diag (B, N) (eigvals == diag, eigvecs
    None) for diagonal P."""

    eigvals: torch.Tensor
    eigvecs: Optional[torch.Tensor]
    diag: Optional[torch.Tensor]

    @property
    def lmax(self) -> torch.Tensor:
        """Exact largest eigenvalue per problem, (B,)."""
        return torch.amax(self.eigvals, dim=-1)


def _captured(x: torch.Tensor) -> bool:
    return control.capturing() and x.is_cuda


def _nan_where_failed(x: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    return torch.where((info == 0).reshape(info.shape + (1,) * (x.ndim - info.ndim)), x,
                       torch.full_like(x, float("nan")))


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cholesky(A)``; under a CUDA graph capture
    ``cholesky_ex`` (the same factor, no check on the host), NaN for a
    matrix that is not positive definite."""
    if not _captured(A):
        return torch.linalg.cholesky(A)
    return _nan_where_failed(*torch.linalg.cholesky_ex(A))


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve(A, B)`` (an LU) on CPU tensors. On the card
    ``solve_ex`` with PyTorch's linear algebra library set to cuSOLVER for
    the call (its batched LU is cuBLAS's getrf: the default heuristic's
    MAGMA LU synchronises with the host, which a capture refuses), eagerly
    and under a CUDA graph capture alike, so that a staged step gives the
    eager step's bits; NaN for a singular matrix, no check on the host."""
    if not A.is_cuda:
        return torch.linalg.solve(A, B)
    return _solve_cusolver(A, B)


# The library is a process-wide setting: a solve holds this lock while it
# has cuSOLVER set, so that solves on other threads (autograd runs a
# backward thread a card) neither run with the setting restored under them
# nor save cuSOLVER as the setting to restore.
_LIBRARY_LOCK = threading.Lock()


def _solve_cusolver(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    with _LIBRARY_LOCK:
        prev = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            return _nan_where_failed(*torch.linalg.solve_ex(A, B, check_errors=False))
        finally:
            torch.backends.cuda.preferred_linalg_library(prev)


def factorize(P: torch.Tensor) -> Factorization:
    """P (B, N, N) -> eigendecomposition; (B, N) -> the diagonal path. A
    dense P on the card goes to E1 (``eigh_cuda``: no read on the host, so
    it records under a capture; a failed build or launch raises), on the
    CPU to ``torch.linalg.eigh``."""
    if P.ndim == 2:
        return Factorization(eigvals=P, eigvecs=None, diag=P)
    eigvals, eigvecs = eigh_cuda(P) if P.is_cuda else torch.linalg.eigh(P)
    return Factorization(eigvals=eigvals, eigvecs=eigvecs, diag=None)


def solve_shifted(fact: Factorization, rhs: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Solve (P + shift I) x = rhs for a batch; shift (B,), rhs (B, N)."""
    denom = fact.eigvals + shift[:, None]
    if fact.diag is not None:
        return rhs / denom
    V = fact.eigvecs
    coeff = (V.mT @ rhs[..., None])[..., 0]
    return (V @ (coeff / denom)[..., None])[..., 0]


def chol_inverse_shifted(P: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of P + shift I by batched Cholesky: P (B, N, N) SPD,
    shift (B,) -> (B, N, N). inv(M) = inv(L)^T inv(L), inv(L) by one batched
    triangular solve against I (the reference forms the same explicit
    inverse, Solver.cpp:76)."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    L = cholesky(P + shift[:, None, None] * eye)
    inv_L = torch.linalg.solve_triangular(L, eye.expand(P.shape), upper=False)
    return inv_L.mT @ inv_L


def spd_cholesky_solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD multi-right-hand-side solve: A (B, m, m), rhs (B, m, k) ->
    (B, m, k). One batched Cholesky factor A = L L^T, then the two triangular
    solves L y = rhs and L^T x = y over all k columns."""
    L = cholesky(A)
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def newton_schulz_inverse(
    M: torch.Tensor, iters: int = 14, x0: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Explicit inverse of a batch of SPD matrices by ``iters`` quadratic
    Newton-Schulz steps X <- X (2I - M X). The default start X0 = M /
    (||M||_1 ||M||_inf) guarantees ||I - M X0||_2 < 1."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    if x0 is None:
        norm1 = torch.amax(torch.sum(torch.abs(M), dim=-2), dim=-1)
        norminf = torch.amax(torch.sum(torch.abs(M), dim=-1), dim=-1)
        x0 = M / torch.clamp_min(norm1 * norminf, torch.finfo(M.dtype).tiny)[:, None, None]
    X = x0
    for _ in range(iters):
        X = X @ (2.0 * eye - M @ X)
    return X


def _ns_adaptive(M: torch.Tensor, x0: torch.Tensor, tol: Optional[float], max_iters: int):
    """The cubic Newton-Schulz loop with the measured stopping rule (see
    ``newton_schulz_inverse_adaptive``), through ``control.while_loop`` as
    the JAX package's ``lax.while_loop``: the residual stays on the device
    and is compared with ``tol`` in float64, as a host float would be."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    if tol is None:
        tol = float(np.cbrt(torch.finfo(M.dtype).eps) * 0.9)

    def cond(s):
        k, _, resid = s
        return (k < max_iters) & (resid.to(torch.float64) > tol)

    def body(s):
        k, X, _ = s
        R = eye - M @ X
        X = X @ (eye + R + R @ R)
        r1 = torch.amax(torch.sum(torch.abs(R), dim=-2))
        rinf = torch.amax(torch.sum(torch.abs(R), dim=-1))
        return k + 1, X, torch.sqrt(r1 * rinf)

    # the carried residual belongs to the iterate the just-applied update
    # contracted from, so exiting at resid <= tol leaves X at ~resid^3
    k0 = torch.zeros((), dtype=torch.int32, device=M.device)
    inf = torch.full((), float("inf"), dtype=M.dtype, device=M.device)
    return control.while_loop(cond, body, (k0, x0, inf))[1]


class _NSAdaptive(torch.autograd.Function):
    """The converged result is the inverse, so the backward is the exact
    implicit derivative d(M^{-1}) = -M^{-1} dM M^{-1}: M_bar = -X^T dX X^T
    (two products); x0 gets no gradient. Under ``torch.func.vmap`` the rule
    folds the vmapped groups into the batch, so the loop runs once, to the
    worst residual over all groups, as JAX's batched ``while_loop`` does;
    the backward is plain torch and batches by itself."""

    @staticmethod
    def forward(M, x0, tol, max_iters):
        return _ns_adaptive(M, x0, tol, max_iters)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, dX):
        (X,) = ctx.saved_tensors
        return -(X.mT @ dX @ X.mT), None, None, None

    @staticmethod
    def vmap(info, in_dims, M, x0, tol, max_iters):
        X = _NSAdaptive.apply(*fold_vmapped(info.batch_size, in_dims[:2], (M, x0)),
                              tol, max_iters)
        return unfold_vmapped(info.batch_size, (X,))[0], 0


def newton_schulz_inverse_adaptive(
    M: torch.Tensor, x0: torch.Tensor, tol: Optional[float] = None, max_iters: int = 30
) -> torch.Tensor:
    """Newton-Schulz with a measured stopping rule, in its cubic form
    X <- X (I + R + R^2), R = I - M X (error e -> e^3 per step).

    Each step computes R anyway, so the loop stops once the rigorous
    spectral bound sqrt(||R||_1 ||R||_inf) of the batch's worst problem
    falls below ``tol`` (default 0.9 eps^(1/3) of M's dtype: 4.4e-3 in
    float32, 5.5e-6 in float64); ``max_iters`` breaks residual stalls.
    Differentiable: the backward is the implicit derivative of the inverse
    (``_NSAdaptive``), not the unrolled loop."""
    return _NSAdaptive.apply(M, x0, tol, max_iters)


def ns_inverse_shifted(
    P: torch.Tensor, shift: torch.Tensor, iters: Optional[int] = None
) -> torch.Tensor:
    """inv(P + shift I) for SPD P by Newton-Schulz from X0 = 2 / (lo + hi) I,
    lo = shift <= lambda_min(M) (P is PSD) and hi = ||M||_inf >= lambda_max(M)
    (the max absolute row sum, a rigorous bound: an underestimated lambda_max
    makes NS diverge), with the measured stopping rule
    (``newton_schulz_inverse_adaptive``); ``iters`` forces a fixed count of
    quadratic steps (``newton_schulz_inverse``)."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    M = P + shift[:, None, None] * eye
    hi = torch.amax(torch.sum(torch.abs(M), dim=-1), dim=-1)
    x0 = (2.0 / (shift + hi))[:, None, None] * eye
    if iters is not None:
        return newton_schulz_inverse(M, iters=iters, x0=x0)
    return newton_schulz_inverse_adaptive(M, x0)


def power_iteration(P: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-count power iteration estimating lambda_max per problem, as the
    reference (Solver.cpp:46-59): start from the constant unit vector, run
    ``iters`` normalise-after-multiply steps, return the Rayleigh quotient.
    P (B, N, N) dense or (B, N) diagonal (then the exact max). Returns (B,)."""
    if P.ndim == 2:
        return torch.amax(P, dim=-1)
    n = P.shape[-1]
    v = torch.full(P.shape[:-1], 1.0 / np.sqrt(n), dtype=P.dtype, device=P.device)
    tiny = torch.finfo(P.dtype).tiny
    for _ in range(iters):
        av = (P @ v[..., None])[..., 0]
        v = av / torch.clamp_min(torch.linalg.vector_norm(av, dim=-1, keepdim=True), tiny)
    av = (P @ v[..., None])[..., 0]
    return torch.sum(v * av, dim=-1)


def linf_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-problem infinity norm over the trailing axis."""
    return torch.amax(torch.abs(x), dim=-1)


def refine_solve(A: torch.Tensor, b: torch.Tensor, mu_ir: float, iters: int) -> torch.Tensor:
    """Solve A x = b for possibly singular A by regularised normal equations,
    the batched analogue of the reference's ``iterative_refinement``
    (Solver.cpp:15-44): G = A^T A + mu_ir I factored once, then ``iters``
    steps of x <- mu_ir G^{-1} x + G^{-1} A^T b. Its contraction factor is
    mu_ir / (sigma_min(A)^2 + mu_ir), so it suits well-scaled systems only
    (the KKT adjoints use a direct solve). A (B, M, K), b (B, M) -> (B, K)."""
    G = A.mT @ A + mu_ir * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    L = torch.linalg.cholesky(G)
    Ab = (A.mT @ b[..., None])[..., 0]

    def chol_solve(y):
        return torch.cholesky_solve(y[..., None], L)[..., 0]

    base = chol_solve(Ab)
    x = base
    for _ in range(iters):
        x = mu_ir * chol_solve(x) + base
    return x
