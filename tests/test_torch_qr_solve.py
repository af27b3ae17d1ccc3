"""Kernel K5's plain version and the generic solve route of the port against
the JAX package.

  * ``qr_solve_plain`` against ``qr_solve_pallas(interpret=True)`` in float32
    at (b, m) = (4, 5), (3, 8), (9, 6), atol and rtol 5e-5 (the bars of
    tests/test_qr_kernel.py, which holds the JAX kernel against LAPACK);
    the unsymmetric saddle system of that file, relative error below 1e-4
    against a float64 solve; in float64 against ``np.linalg.solve`` to 1e-10.
  * A masked system with unit inactive rows and columns and one degenerate
    slot whose row, column and right-hand side are zero: at that step the
    column is zero from the diagonal down, so beta = 0 and the diagonal
    takes its 1e-30 floor; the slot solves to exactly 0 and the rest to the
    reduced system's solution, in the plain version and the JAX kernel alike.
  * ``diff/kkt.py::_solve_direct`` against the JAX one on the same numpy
    systems: SPD (a masked QP matrix) and general (a saddle system), in
    float64 (1e-10; the port's batched Cholesky / LU against JAX's) and in
    float32 with ``backend='pallas'`` (the port's plain K5 against the JAX
    kernel in interpret mode, per problem 1e-4 max(1, |x_b|_inf), the
    saddle test's bar: the saddle system here has condition ~5e3, where
    float32 rounding alone puts either side ~3e-5 of scale off the float64
    solve); its routes on CPU tensors.
  * ``ops/linalg.py::spd_cholesky_solve`` against the JAX one (float64,
    1e-12), and K5's wrapper: its CPU dispatch and its input checks.

Interpret mode runs the unrolled JAX kernel op by op, so every system held
against it has m <= 9 (tests/test_qr_kernel.py explains why).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu.diff.kkt as K
from diffqcqp_tpu.config import SolverConfig as JaxConfig
from diffqcqp_tpu.kernels.qr_solve_pallas import qr_solve_pallas
from diffqcqp_tpu.ops.linalg import spd_cholesky_solve as j_spd_cholesky_solve
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.diff import kkt as TK
from diffqcqp_tpu_torch.kernels import _build
from diffqcqp_tpu_torch.kernels import qr_solve_cuda as tk
from diffqcqp_tpu_torch.ops.linalg import spd_cholesky_solve

T = torch.from_numpy


def _jax_kernel(A, b):
    return np.asarray(qr_solve_pallas(jnp.asarray(A), jnp.asarray(b), interpret=True))


def _general(rng, b, m):
    A = rng.standard_normal((b, m, m)) + 2.0 * np.eye(m)
    return A, rng.standard_normal((b, m))


def _saddle(rng, b, n, nc):
    """tests/test_qr_kernel.py's unsymmetric saddle system (n + nc)."""
    m = n + nc
    P = rng.standard_normal((b, n, n))
    P = P @ P.transpose(0, 2, 1) + 0.5 * np.eye(n)
    S = np.zeros((b, m, m))
    S[:, :nc, :nc] = np.eye(nc) * rng.random((b, 1, 1))
    S[:, nc:, nc:] = P
    C = rng.standard_normal((b, n, nc))
    S[:, nc:, :nc] = C
    S[:, :nc, nc:] = 0.3 * C.transpose(0, 2, 1)
    return S, rng.standard_normal((b, m))


def _masked_spd(rng, b, n):
    """K = fm P fm + diag(am) of the QP's generic route, ~40 % of the
    coordinates strictly active."""
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    am = (rng.random((b, n)) < 0.4).astype(np.float64)
    fm = 1.0 - am
    Km = P * fm[:, :, None] * fm[:, None, :] + am[:, :, None] * np.eye(n)
    return Km, rng.standard_normal((b, n)) * fm


def _f64_solve(A, b):
    return np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]


@pytest.mark.parametrize("b,m", [(4, 5), (3, 8), (9, 6)])
def test_plain_matches_jax_kernel_f32(b, m):
    A, rhs = (x.astype(np.float32) for x in _general(np.random.default_rng(m), b, m))
    x = tk.qr_solve_plain(T(A), T(rhs))
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), _jax_kernel(A, rhs), atol=5e-5, rtol=5e-5)


def test_plain_unsymmetric_saddle_f32():
    S, rhs = (x.astype(np.float32) for x in _saddle(np.random.default_rng(1), 4, 6, 3))
    x = tk.qr_solve_plain(T(S), T(rhs)).numpy()
    ref = _f64_solve(S, rhs)
    assert np.max(np.abs(x - ref) / np.maximum(1.0, np.abs(ref))) < 1e-4


@pytest.mark.parametrize("m", [5, 12, 30])
def test_plain_f64_matches_numpy(m):
    A, rhs = _general(np.random.default_rng(100 + m), 3, m)
    x = tk.qr_solve_plain(T(A), T(rhs))
    assert x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), _f64_solve(A, rhs), atol=1e-10, rtol=0)


def test_masked_system_with_a_zero_column_takes_beta_zero():
    rng = np.random.default_rng(7)
    b, m = 3, 8
    A, rhs = _general(rng, b, m)
    unit, zero = [1, 6], 4              # unit inactive slots, one degenerate slot
    for k in unit:
        A[:, k, :] = 0.0
        A[:, :, k] = 0.0
        A[:, k, k] = 1.0
        rhs[:, k] = 0.0
    A[:, zero, :] = 0.0
    A[:, :, zero] = 0.0
    rhs[:, zero] = 0.0
    keep = [i for i in range(m) if i != zero]
    ref = np.zeros((b, m))
    ref[:, keep] = _f64_solve(A[:, keep][:, :, keep], rhs[:, keep])

    x64 = tk.qr_solve_plain(T(A), T(rhs)).numpy()
    np.testing.assert_allclose(x64, ref, atol=1e-10, rtol=0)
    A32, rhs32 = A.astype(np.float32), rhs.astype(np.float32)
    x32 = tk.qr_solve_plain(T(A32), T(rhs32)).numpy()
    xj = _jax_kernel(A32, rhs32)
    for x in (x32, xj):
        assert np.all(x[:, zero] == 0.0) and np.all(x[:, unit] == 0.0)
    np.testing.assert_allclose(x32, xj, atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(x32, ref, atol=5e-5, rtol=5e-5)


SYSTEMS = {"spd": lambda rng: _masked_spd(rng, 4, 9), "general": lambda rng: _saddle(rng, 4, 6, 3)}


@pytest.mark.parametrize("kind", list(SYSTEMS))
def test_solve_direct_matches_jax_f64(kind):
    A, rhs = SYSTEMS[kind](np.random.default_rng(11))
    cfg = JaxConfig(backend="xla")
    want = np.asarray(K._solve_direct(jnp.asarray(A), jnp.asarray(rhs), cfg, spd=kind == "spd"))
    tcfg = dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))
    got = TK._solve_direct(T(A), T(rhs), tcfg, spd=kind == "spd")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)


@pytest.mark.parametrize("kind", list(SYSTEMS))
def test_solve_direct_pallas_f32_matches_jax_kernel(kind):
    A, rhs = (x.astype(np.float32) for x in SYSTEMS[kind](np.random.default_rng(12)))
    cfg = JaxConfig(backend="pallas")
    want = np.asarray(K._solve_direct(jnp.asarray(A), jnp.asarray(rhs), cfg, spd=kind == "spd"))
    tcfg = dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))
    got = TK._solve_direct(T(A), T(rhs), tcfg, spd=kind == "spd")
    assert got.dtype == torch.float32
    scale = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
    assert np.all(np.abs(got.numpy() - want) <= 1e-4 * scale)


def test_solve_direct_routes_on_cpu():
    """On a CPU tensor only backend='pallas' takes K5 (its plain version, in
    float32, cast back); 'auto' takes, for an SPD system, the Newton-Schulz
    inverse in float32 and the Cholesky in float64, as the JAX package, and
    the LU otherwise."""
    A, rhs = _masked_spd(np.random.default_rng(13), 3, 7)
    auto, pallas = dqt.SolverConfig(), dqt.SolverConfig(backend="pallas")
    for dtype in (torch.float64, torch.float32):
        At, bt = T(A).to(dtype), T(rhs).to(dtype)
        want = ((TK._spd_inverse_f32(At) @ bt[..., None])[..., 0] if dtype == torch.float32
                else spd_cholesky_solve(At, bt[..., None])[..., 0])
        assert torch.equal(TK._solve_direct(At, bt, auto, spd=True), want)
        assert torch.equal(TK._solve_direct(At, bt, auto),
                           torch.linalg.solve(At, bt[..., None])[..., 0])
        x = TK._solve_direct(At, bt, pallas, spd=True)
        assert x.dtype == dtype
        assert torch.equal(x, tk.qr_solve_plain(At.float(), bt.float()).to(dtype))


def test_spd_cholesky_solve_matches_jax_f64():
    rng = np.random.default_rng(14)
    A, _ = _masked_spd(rng, 3, 10)
    rhs = rng.standard_normal((3, 10, 4))
    got = spd_cholesky_solve(T(A), T(rhs)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_spd_cholesky_solve(jnp.asarray(A), jnp.asarray(rhs))),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", A, got), rhs, atol=1e-10, rtol=0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    A, rhs = (T(x.astype(np.float32)) for x in _general(np.random.default_rng(15), 4, 6))
    before = tk.qr_solve_cuda.launches
    assert torch.equal(tk.qr_solve_cuda(A, rhs), tk.qr_solve_plain(A, rhs))
    assert tk.qr_solve_cuda.launches == before


@pytest.mark.parametrize("bad", ["not_square", "b_shape", "empty", "mixed_dtype", "int_dtype"])
def test_wrapper_checks_its_inputs(bad):
    A, b = torch.eye(5).expand(2, 5, 5).contiguous(), torch.ones(2, 5)
    err = ValueError
    if bad == "not_square":
        A = A[:, :, :4]
    elif bad == "b_shape":
        b = b[:, :4]
    elif bad == "empty":
        A, b = A[:, :0, :0], b[:, :0]
    elif bad == "mixed_dtype":
        b, err = b.double(), TypeError
    else:
        A, b, err = A.int(), b.int(), TypeError
    with pytest.raises(err):
        tk.qr_solve_cuda(A, b)


def test_smem_bytes_bounds():
    # ~32 KB at the route's bound m = 88; [A | b] stops fitting the 227 KB a
    # Hopper block may use a little above m = 240
    assert 31 * 1024 < tk.smem_bytes(88) < 32 * 1024
    assert tk.smem_bytes(239) <= 232448 < tk.smem_bytes(242)


def test_build_sources_are_the_csrc_files():
    assert sorted(_build.SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
