"""The slice end to end: the port's ``solve_qcqp_with_stats(device="cpu")``
against the JAX package's ``solve_qcqp_with_stats`` on its kernel path
(``backend="pallas"``, interpret mode on the CPU), at N=24 with bench.py's
generator and configuration, plus the entry point's guards.

Bars: atol 2e-5 on l and iterations within 1 per problem, the JAX suite's
kernel tolerances. Inputs are float32 on both sides (bench.py's P comes out
float64 under NumPy 2 promotion; the JAX kernel path computes in float32
whatever it is given, while the port sends float64 to its eager engine).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
import diffqcqp_tpu_torch as dqt
from bench import _build_problems

B, NC = 16, 12
BENCH_CFG = dq.QCQP_DEFAULTS.replace(
    eps=1e-7, max_iter=400, rho0_scale=2.0, power_iters=10, rho_update_period=24,
)


def _port_cfg(cfg):
    return dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def problems():
    return tuple(x.astype(np.float32) for x in _build_problems(B, NC, np.float32, seed=0))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "equilibrate"])
def solved(request, problems):
    cfg = BENCH_CFG.replace(equilibrate=request.param)
    lj, sj = dq.solve_qcqp_with_stats(
        *map(jnp.asarray, problems), config=cfg.replace(backend="pallas")
    )
    lt, st = dqt.solve_qcqp_with_stats(*problems, config=_port_cfg(cfg), device="cpu")
    return cfg, (np.asarray(lj), sj), (lt, st)


def test_slice_matches_jax_kernel_path(solved):
    _, (lj, sj), (lt, st) = solved
    assert lt.dtype == torch.float32 and lt.shape == (B, 2 * NC)
    np.testing.assert_allclose(lt.numpy(), lj, atol=2e-5, rtol=0)
    it_j, it_t = np.asarray(sj.iterations), st.iterations.numpy()
    assert int(np.abs(it_t - it_j).max()) <= 1, (it_j, it_t)
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
    assert st.converged.all()


def test_slice_solution_is_feasible(solved, problems):
    _, _, (lt, _) = solved
    _, _, l_n, mu = problems
    norms = np.linalg.norm(lt.numpy().reshape(B, NC, 2), axis=-1)
    assert np.all(norms <= l_n * mu * (1 + 1e-5) + 1e-7)


def test_slice_stats_are_finite_and_typed(solved):
    _, _, (_, st) = solved
    assert st.iterations.dtype == torch.int32
    assert st.converged.dtype == torch.bool and st.stalled.dtype == torch.bool
    for x in (st.res_prim, st.res_dual, st.rho):
        assert x.dtype == torch.float32 and torch.isfinite(x).all()


@pytest.mark.parametrize("layout", ["unbatched", "column"])
def test_slice_layouts(problems, layout):
    """Unbatched (N,) and (B, N, 1) column inputs give the batched solution
    in the caller's layout."""
    P, q, l_n, mu = problems
    cfg = _port_cfg(BENCH_CFG)
    l_ref, _ = dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg, device="cpu")
    if layout == "unbatched":
        l, st = dqt.solve_qcqp_with_stats(P[3], q[3], l_n[3], mu[3], config=cfg,
                                          device="cpu")
        assert l.shape == (2 * NC,) and st.iterations.ndim == 0
        torch.testing.assert_close(l, l_ref[3], atol=1e-6, rtol=0)
    else:
        l = dqt.solve_qcqp(P, q[:, :, None], l_n[:, :, None], mu[:, :, None],
                           config=cfg, device="cpu")
        assert l.shape == (B, 2 * NC, 1)
        torch.testing.assert_close(l[:, :, 0], l_ref, atol=1e-6, rtol=0)


def test_float64_input_runs_in_float64_on_cpu(problems):
    P, q, l_n, mu = (x.astype(np.float64) for x in problems)
    cfg = _port_cfg(BENCH_CFG.replace(eps=1e-10, max_iter=2000))
    l, st = dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg, device="cpu")
    assert l.dtype == torch.float64 and st.converged.all()
    assert not st.stalled.any()


def test_default_device_raises_without_cuda(problems, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dqt.solve_qcqp(*problems)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dqt.solve_qcqp_with_stats(*problems, device="cuda")


@pytest.mark.parametrize("which", ["P", "q", "l_n", "mu"])
def test_requires_grad_gives_gradients(problems, which):
    """One input requiring a gradient gets a finite one of its shape, and
    only it; under torch.no_grad() the same call just solves."""
    args = [torch.from_numpy(x.copy()) for x in problems]
    i = ["P", "q", "l_n", "mu"].index(which)
    args[i].requires_grad_(True)
    cfg = _port_cfg(BENCH_CFG)
    l = dqt.solve_qcqp(*args, config=cfg, device="cpu")
    assert l.requires_grad
    (l * l).sum().backward()
    g = args[i].grad
    assert g is not None and g.shape == args[i].shape and torch.isfinite(g).all()
    assert all(a.grad is None for j, a in enumerate(args) if j != i)
    with torch.no_grad():
        l0 = dqt.solve_qcqp(*args, config=cfg, device="cpu")
    assert not l0.requires_grad and torch.equal(l0, l.detach())


def test_diagonal_P_raises():
    """A diagonal P is solved by the eager engine; only the kernel path,
    backend='pallas', refuses it (K1 takes dense P, as the JAX kernel path)."""
    args = (np.ones((2, 4)), np.ones((2, 4)), np.ones((2, 2)), np.ones((2, 2)))
    with pytest.raises(ValueError, match=r"P must be \(B, n, n\)"):
        dqt.solve_qcqp(*args, config=dqt.QCQP_DEFAULTS.replace(backend="pallas"), device="cpu")
    l = dqt.solve_qcqp(*args, device="cpu")
    assert l.shape == (2, 4) and bool(torch.isfinite(l).all())


def test_zero_radius_gives_zero_force(problems):
    P, q, l_n, mu = problems
    l_n = l_n.copy()
    l_n[:, 0] = 0.0
    l = dqt.solve_qcqp(P, q, l_n, mu, config=_port_cfg(BENCH_CFG), device="cpu")
    assert torch.all(l[:, :2] == 0.0)
