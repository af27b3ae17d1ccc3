"""The port's ``ops/linalg.py`` against the JAX package's, function by
function, on the same numpy inputs (b = 4 problems, n = 6), in float64 and
float32.

Bars: float64 atol 1e-10 (the inverses, with at most ~1e2 condition here)
and 1e-12 (power iteration, norms, spectral solves); float32 atol 2e-5 of
each result's scale. Both sides run the same algorithm; they differ only in
LAPACK / BLAS summation order and, for the adaptive Newton-Schulz loop, in
where its measured stopping rule lands, which moves the result by less
than the loop's own tolerance cubed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffqcqp_tpu.diff import kkt as jkkt
from diffqcqp_tpu.ops import linalg as J
from diffqcqp_tpu_torch.diff import kkt as tkkt
from diffqcqp_tpu_torch.ops import linalg as T

DTYPES = [np.float64, np.float32]
IDS = ["f64", "f32"]


def _spd(seed, b=4, n=6, dtype=np.float64):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((b, n, n))
    P = S @ S.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    shift = rng.random(b) + 0.05
    rhs = rng.standard_normal((b, n))
    return P.astype(dtype), shift.astype(dtype), rhs.astype(dtype)


def _close(got, want, dtype, bar64=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype == dtype
    bar = bar64 if dtype == np.float64 else 2e-5
    np.testing.assert_allclose(got, want, atol=bar * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_factorize_and_solve_shifted(dtype):
    P, shift, rhs = _spd(0, dtype=dtype)
    fj, ft = J.factorize(jnp.asarray(P)), T.factorize(torch.from_numpy(P))
    _close(ft.lmax, fj.lmax, dtype, 1e-12)
    _close(T.solve_shifted(ft, torch.from_numpy(rhs), torch.from_numpy(shift)),
           J.solve_shifted(fj, jnp.asarray(rhs), jnp.asarray(shift)), dtype)
    # the diagonal path
    d = np.diagonal(P, axis1=1, axis2=2).copy()
    fj, ft = J.factorize(jnp.asarray(d)), T.factorize(torch.from_numpy(d))
    assert ft.eigvecs is None and ft.diag is not None
    _close(T.solve_shifted(ft, torch.from_numpy(rhs), torch.from_numpy(shift)),
           J.solve_shifted(fj, jnp.asarray(rhs), jnp.asarray(shift)), dtype, 1e-12)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_chol_inverse_shifted(dtype):
    P, shift, _ = _spd(1, dtype=dtype)
    _close(T.chol_inverse_shifted(torch.from_numpy(P), torch.from_numpy(shift)),
           J.chol_inverse_shifted(jnp.asarray(P), jnp.asarray(shift)), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_newton_schulz_inverse_fixed_count(dtype):
    P, shift, _ = _spd(2, dtype=dtype)
    M = P + shift[:, None, None] * np.eye(P.shape[-1], dtype=dtype)
    _close(T.newton_schulz_inverse(torch.from_numpy(M), iters=20),
           J.newton_schulz_inverse(jnp.asarray(M), iters=20), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_ns_inverse_shifted_adaptive_and_fixed(dtype):
    P, shift, _ = _spd(3, dtype=dtype)
    Pt, st = torch.from_numpy(P), torch.from_numpy(shift)
    _close(T.ns_inverse_shifted(Pt, st), J.ns_inverse_shifted(jnp.asarray(P), jnp.asarray(shift)),
           dtype)
    _close(T.ns_inverse_shifted(Pt, st, iters=12),
           J.ns_inverse_shifted(jnp.asarray(P), jnp.asarray(shift), iters=12), dtype)
    M = P.astype(np.float64) + shift.astype(np.float64)[:, None, None] * np.eye(P.shape[-1])
    _close(T.ns_inverse_shifted(Pt, st).double().numpy(), np.linalg.inv(M), np.float64,
           1e-10 if dtype == np.float64 else 2e-5)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_newton_schulz_adaptive_vjp_matches_jax(dtype):
    """The custom VJP (a torch.autograd.Function): the gradient of
    <W, inv(M)> for M, against jax.grad through the JAX custom_vjp."""
    P, shift, _ = _spd(4, dtype=dtype)
    n = P.shape[-1]
    M = P + shift[:, None, None] * np.eye(n, dtype=dtype)
    W = np.random.default_rng(5).standard_normal(M.shape).astype(dtype)
    x0 = (1.0 / np.abs(M).sum(-1).max(-1))[:, None, None] * np.eye(n, dtype=dtype)

    def fj(m):
        return jnp.sum(jnp.asarray(W) * J.newton_schulz_inverse_adaptive(m, jnp.asarray(x0)))

    gj = jax.grad(fj)(jnp.asarray(M))
    Mt = torch.from_numpy(M).requires_grad_()
    (torch.from_numpy(W) * T.newton_schulz_inverse_adaptive(Mt, torch.from_numpy(x0))).sum().backward()
    _close(Mt.grad, gj, dtype, 1e-9)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_power_iteration_and_linf_norm(dtype):
    P, _, rhs = _spd(6, dtype=dtype)
    _close(T.power_iteration(torch.from_numpy(P), 10), J.power_iteration(jnp.asarray(P), 10),
           dtype, 1e-12)
    d = np.diagonal(P, axis1=1, axis2=2).copy()
    _close(T.power_iteration(torch.from_numpy(d), 10), J.power_iteration(jnp.asarray(d), 10),
           dtype, 1e-12)
    _close(T.linf_norm(torch.from_numpy(rhs)), J.linf_norm(jnp.asarray(rhs)), dtype, 0.0)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_refine_solve(dtype):
    """A well-scaled rectangular system (the selector regime it is kept
    for) with one zero row, which decouples."""
    rng = np.random.default_rng(7)
    A = (rng.standard_normal((4, 7, 5)) + 2.0 * np.eye(7, 5)).astype(dtype)
    A[:, 3] = 0.0
    b = rng.standard_normal((4, 7)).astype(dtype)
    _close(T.refine_solve(torch.from_numpy(A), torch.from_numpy(b), 1e-7, 10),
           J.refine_solve(jnp.asarray(A), jnp.asarray(b), 1e-7, 10), dtype)


def test_spd_inverse_f32_matches_jax():
    """diff/kkt.py::_spd_inverse_f32: the masked adjoint's SPD system
    (unit rows on the active set) inverted by Newton-Schulz from I/||A||_inf."""
    P, _, _ = _spd(8, n=9, dtype=np.float32)
    am = (np.random.default_rng(9).random((4, 9)) < 0.4).astype(np.float32)
    fm = 1.0 - am
    K = (P * fm[:, :, None] * fm[:, None, :] + am[:, :, None] * np.eye(9)).astype(np.float32)
    got = tkkt._spd_inverse_f32(torch.from_numpy(K))
    _close(got, jkkt._spd_inverse_f32(jnp.asarray(K)), np.float32)
    _close(got.double().numpy(), np.linalg.inv(K.astype(np.float64)), np.float64, 2e-5)


def test_card_solve_holds_its_library_setting_across_threads(monkeypatch):
    """ops/linalg.py::_solve_cusolver, the card's LU, sets PyTorch's
    process-wide linear algebra library for its call: two threads' solves
    (autograd runs a backward thread a card) each run with cuSOLVER set and
    leave the setting as they found it. The setting and ``solve_ex`` are
    stand-ins here (a CPU build cannot select cuSOLVER); ``solve_ex`` sleeps
    so that the threads' calls would overlap without the lock."""
    import threading
    import time

    lib, seen = ["default"], []

    def preferred(backend=None):
        if backend is not None:
            lib[0] = backend
        return lib[0]

    def solve_ex(A, B, check_errors=True):
        seen.append(lib[0])
        time.sleep(0.05)
        seen.append(lib[0])
        return torch.linalg.solve(A, B), torch.zeros(A.shape[:-2], dtype=torch.int32)

    monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library", preferred)
    monkeypatch.setattr(torch.linalg, "solve_ex", solve_ex)
    P, _, rhs = _spd(10)
    A, b = torch.from_numpy(P), torch.from_numpy(rhs)[..., None]
    out = [None, None]

    def run(i):
        out[i] = T._solve_cusolver(A, b)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == ["cusolver"] * 4
    assert lib[0] == "default"
    for x in out:
        _close(x[..., 0], np.linalg.solve(P, rhs[..., None])[..., 0], np.float64)
