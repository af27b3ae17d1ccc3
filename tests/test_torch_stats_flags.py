"""The port's twins of tests/test_stats_flags.py (its 8 tests) and of
tests/test_accel.py::test_accel_warns_when_stacked_on_adaptive_schedule, on
the CPU, on the same inputs (the ``rng`` and ``spd`` fixtures, seed 0):
``SolveStats.converged``, ``stalled``, ``iterations``, ``res_*`` and ``rho``
of the eager engine (``backend='xla'``) and of K1's plain version
(``backend='pallas'``), which the staged step carries bit for bit on the
card. Each twin runs the JAX solve on the same inputs and holds the port's
stats to it (``_hold``), and keeps the JAX test's own expectations as
further asserts:

  * float64: ``converged``, ``stalled`` and ``iterations`` equal, ``rho``
    within rtol 1e-12, ``res_*`` within 1e-13 (the residuals sit near
    eps = 1e-10; they agree to ~3e-15);
  * float32: ``converged`` and ``stalled`` equal, ``iterations`` equal or,
    where the JAX test runs to float32's noise floor at an unreachable eps,
    within 1 (the engine's float32 parity rule, tests/test_torch_engine.py),
    ``rho`` within rtol 1e-6, ``res_*`` within 2e-6 (float32's rounding of
    residuals of O(1e-4)). Where XLA's order of operations rounds a float32
    residual to exactly 0.0 (so JAX certifies the problem at an eps of 1e-13
    or 1e-30), the port's order leaves it at float32's noise floor: those
    problems are named by the JAX residual being 0.0 and left out of the
    flag comparison, and each such problem is checked to be one.

The rho_sync=False schedule is also held against ``tests/np_reference.py``,
the NumPy transcription of the reference solver, as in the JAX tests.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
import diffqcqp_tpu_torch as dqt
from tests import np_reference

CPU = dict(device="cpu")


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _jax(solve, *xs, dtype=np.float64, **kw):
    """The JAX package's ``solve`` (``dq.solve_qp_with_stats`` ...) on the
    same inputs, in ``dtype``."""
    return solve(*(jnp.asarray(np.asarray(x, dtype)) for x in xs), **kw)


def _hold(st, sj, iters_within=0, skip=None, values=True):
    """The port's ``SolveStats`` ``st`` against the JAX package's ``sj`` at
    the bars of the module's docstring (by st's dtype); ``skip`` masks the
    problems whose JAX residual rounded to exactly 0.0 out of the flags and
    iterations; ``values=False`` holds those alone."""
    f64 = st.rho.dtype == torch.float64
    keep = np.ones(st.converged.shape, bool) if skip is None else ~skip
    for name in ("converged", "stalled"):
        np.testing.assert_array_equal(getattr(st, name).numpy()[keep],
                                      np.asarray(getattr(sj, name))[keep], err_msg=name)
    di = np.abs(st.iterations.numpy() - np.asarray(sj.iterations))[keep]
    assert int(di.max(initial=0)) <= iters_within, di
    if not values:
        return
    np.testing.assert_allclose(st.rho.numpy(), np.asarray(sj.rho), rtol=1e-12 if f64 else 1e-6)
    for name in ("res_prim", "res_dual"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                   rtol=0, atol=1e-13 if f64 else 2e-6, err_msg=name)


def _rows(stats, mask):
    """The problems ``mask`` selects of either package's ``SolveStats``."""
    return type(stats)(*(f[torch.from_numpy(mask)] if torch.is_tensor(f) else np.asarray(f)[mask]
                         for f in stats))


def _exact_zero(sj):
    """The problems whose JAX float32 residual rounded to exactly 0.0."""
    return (np.asarray(sj.res_prim) == 0.0) | (np.asarray(sj.res_dual) == 0.0)


def test_stalled_false_when_eps_certified(rng, spd):
    P, q = spd(rng, 8, 8), rng.standard_normal((8, 8))
    kw = dict(eps=1e-10, max_iter=5000)
    _, st = dqt.solve_qp_with_stats(_t(P), _t(q), config=dqt.SolverConfig(**kw), **CPU)
    _, sj = _jax(dq.solve_qp_with_stats, P, q, config=dq.SolverConfig(**kw))
    _hold(st, sj)
    assert bool(st.converged.all())
    assert not bool(st.stalled.any())


def test_stalled_true_f32_unreachable_eps(rng, spd):
    Pn, qn = spd(rng, 8, 8), rng.standard_normal((8, 8))
    P, q = _t(Pn, torch.float32), _t(qn, torch.float32)
    kw = dict(eps=1e-13, max_iter=8000, backend="xla")
    l, st = dqt.solve_qp_with_stats(P, q, config=dqt.SolverConfig(**kw), **CPU)
    lj, sj = _jax(dq.solve_qp_with_stats, Pn, qn, dtype=np.float32, config=dq.SolverConfig(**kw))
    _hold(st, sj, iters_within=1)
    np.testing.assert_allclose(l.numpy(), np.asarray(lj), atol=1e-5)
    assert bool(st.converged.all())
    assert bool(st.stalled.any())
    # the stall still delivered a correct solution at float32 accuracy
    l64 = dqt.solve_qp(P.double(), q.double(), config=dqt.SolverConfig(eps=1e-11, max_iter=20000),
                       **CPU)
    np.testing.assert_allclose(l.numpy(), l64.numpy(), atol=1e-4)


def test_stall_tol_zero_disables(rng, spd):
    Pn, qn = spd(rng, 8, 8), rng.standard_normal((8, 8))
    P, q = _t(Pn, torch.float32), _t(qn, torch.float32)
    kw = dict(eps=1e-13, max_iter=500, backend="xla", stall_tol=0.0)
    _, st = dqt.solve_qp_with_stats(P, q, config=dqt.SolverConfig(**kw), **CPU)
    _, sj = _jax(dq.solve_qp_with_stats, Pn, qn, dtype=np.float32, config=dq.SolverConfig(**kw))
    # JAX certifies the problems whose float32 residual XLA rounds to 0.0
    # (two of eight here) and stops them early; from there the batch-wide
    # penalty schedule (rho_sync) sees other active problems on each side,
    # so the others' rho and residuals part too, while all of them run to
    # max_iter unconverged on both sides. Up to the first such stop every
    # stat agrees.
    zero = _exact_zero(sj)
    assert np.array_equal(zero, np.asarray(sj.converged)) and not zero.all()
    assert not bool(st.converged[torch.from_numpy(zero)].any())
    _hold(_rows(st, ~zero), _rows(sj, ~zero), values=False)
    first = int(np.asarray(sj.iterations)[zero].min()) - 1
    kw["max_iter"] = first
    _, st_first = dqt.solve_qp_with_stats(P, q, config=dqt.SolverConfig(**kw), **CPU)
    _, sj_first = _jax(dq.solve_qp_with_stats, Pn, qn, dtype=np.float32,
                       config=dq.SolverConfig(**kw))
    _hold(st_first, sj_first)
    assert int(st_first.iterations.min()) == first
    # without the stall test an unreachable float32 eps spins to max_iter
    assert not bool(st.converged.all())
    assert not bool(st.stalled.any())
    assert int(st.iterations.max()) == 500


def test_primal_stall_floor_zero_solution(rng, spd):
    """With primal_check on, a problem whose solution is nearly zero
    (eps_rel ||l*|| below float32's primal noise floor) and an eps below
    float32's floor still terminates through the primal-side noise floor,
    flagged stalled unless both residuals met eps, in the engine and in
    K1's plain version."""
    b, n = 8, 8
    Pn = spd(rng, b, n)
    qn = np.asarray(rng.random((b, n)) + 0.5, np.float32)
    qn[:, 0] = -2e-4
    P, q = _t(Pn, torch.float32), _t(qn, torch.float32)
    for backend in ("xla", "pallas"):
        kw = dict(eps=1e-12, max_iter=600, backend=backend)
        cfg = dqt.SolverConfig(**kw)
        l, st = dqt.solve_qp_with_stats(P, q, config=cfg, **CPU)
        lj, sj = _jax(dq.solve_qp_with_stats, Pn, qn, dtype=np.float32,
                      config=dq.SolverConfig(**kw))
        _hold(st, sj)
        np.testing.assert_allclose(l.numpy(), np.asarray(lj), atol=1e-6)
        assert bool(st.converged.all()), backend
        assert int(st.iterations.max()) < 600, backend
        certified = (st.res_dual < cfg.eps) & (st.res_prim < cfg.eps)
        assert bool((st.stalled | certified).all()), backend
        l64 = dqt.solve_qp(P.double(), q.double(),
                           config=dqt.SolverConfig(eps=1e-11, max_iter=20000, backend="xla"), **CPU)
        np.testing.assert_allclose(l.numpy(), l64.numpy(), atol=1e-5)


def test_rho_sync_false_matches_reference_schedule(rng, spd):
    """rho_sync=False with power-iteration L reproduces the reference's
    per-problem staggered throttle: per-problem iterations and solutions
    equal to the NumPy transcription of the reference solver."""
    b, n = 6, 8
    P = np.array(spd(rng, b, n))
    q = rng.standard_normal((b, n))
    kw = dict(eps=1e-10, max_iter=4000, lmax_method="power", power_iters=10, rho_sync=False,
              stall_tol=0.0, backend="xla")
    l, st = dqt.solve_qp_with_stats(_t(P), _t(q), config=dqt.SolverConfig(**kw), **CPU)
    _, sj = _jax(dq.solve_qp_with_stats, P, q, config=dq.SolverConfig(**kw))
    _hold(st, sj)
    for i in range(b):
        l_ref, iters_ref, _, _ = np_reference.solve_qp(P[i], q[i], eps=1e-10, max_iter=4000)
        np.testing.assert_allclose(l.numpy()[i], l_ref, atol=1e-9)
        assert int(st.iterations[i]) == iters_ref, (int(st.iterations[i]), iters_ref)


def test_rho_sync_false_qcqp_matches_reference_schedule(rng, spd):
    b, nc = 4, 4
    n = 2 * nc
    P = np.array(spd(rng, b, n))
    q = rng.standard_normal((b, n))
    l_n = rng.random((b, nc)) * 0.5 + 0.05
    mu = rng.random((b, nc)) * 0.5 + 0.05
    kw = dict(eps=1e-9, max_iter=20000, lmax_method="power", rho_sync=False, stall_tol=0.0,
              backend="xla")
    l, st = dqt.solve_qcqp_with_stats(_t(P), _t(q), _t(l_n), _t(mu),
                                      config=dqt.QCQP_DEFAULTS.replace(**kw), **CPU)
    _, sj = _jax(dq.solve_qcqp_with_stats, P, q, l_n, mu, config=dq.QCQP_DEFAULTS.replace(**kw))
    _hold(st, sj)
    for i in range(b):
        l_ref, iters_ref, _, _ = np_reference.solve_qcqp(P[i], q[i], l_n[i], mu[i], eps=1e-9,
                                                         max_iter=20000)
        np.testing.assert_allclose(l.numpy()[i], l_ref, atol=1e-8)
        assert int(st.iterations[i]) == iters_ref


def test_equilibrate_degenerate_zero_matrix(rng, spd):
    """An all-zero P must not NaN-poison the equilibrated path (ruiz_diag
    keeps scale 1 on zero rows), and the other problems solve as without
    equilibration."""
    b, n = 4, 6
    P = np.array(spd(rng, b, n))
    P[0] = 0.0
    q = rng.standard_normal((b, n))
    kw = dict(eps=1e-10, max_iter=2000, equilibrate=True)
    cfg = dqt.SolverConfig(**kw)
    l, st = dqt.solve_qp_with_stats(_t(P), _t(q), config=cfg, **CPU)
    lj, sj = _jax(dq.solve_qp_with_stats, P, q, config=dq.SolverConfig(**kw))
    # the zero-P problem is unbounded below (q has negative entries): both
    # sides run it to max_iter unconverged, on iterates that rounding steers
    zero_p = np.arange(b) == 0
    _hold(_rows(st, zero_p), _rows(sj, zero_p), values=False)
    _hold(_rows(st, ~zero_p), _rows(sj, ~zero_p))
    assert int(st.iterations[0]) == 2000 and not bool(st.converged[0])
    np.testing.assert_allclose(l.numpy()[1:], np.asarray(lj)[1:], atol=1e-12)
    assert bool(torch.isfinite(l).all())
    l_plain = dqt.solve_qp(_t(P[1:]), _t(q[1:]), config=cfg.replace(equilibrate=False), **CPU)
    np.testing.assert_allclose(l.numpy()[1:], l_plain.numpy(), atol=1e-6)


def test_rho_residual_consistent_capped_pallas(rng, spd):
    """K1's capped-rho contract (its plain version here): with the max_iter
    cap on a rho-update iteration, SolveStats.rho is the penalty the
    recorded residuals used."""
    Pn, qn = spd(rng, 20, 8), rng.standard_normal((20, 8))
    P, q = _t(Pn, torch.float32), _t(qn, torch.float32)
    kw = dict(eps=1e-30, stall_tol=0.0, rho_update_period=24, backend="pallas",
              lmax_method="power")
    _, s25 = dqt.solve_qp_with_stats(P, q, config=dqt.SolverConfig(max_iter=25, **kw), **CPU)
    _, s24 = dqt.solve_qp_with_stats(P, q, config=dqt.SolverConfig(max_iter=24, **kw), **CPU)
    _, sj = _jax(dq.solve_qp_with_stats, Pn, qn, dtype=np.float32,
                 config=dq.SolverConfig(max_iter=25, **kw))
    # one problem's float32 dual residual rounds to 0.0 in the JAX kernel at
    # iteration 24, which certifies it even at eps = 1e-30
    zero = _exact_zero(sj)
    assert np.array_equal(zero, np.asarray(sj.converged)) and zero.sum() <= 1
    assert not bool(s25.converged.any())
    _hold(s25, sj, skip=zero)
    np.testing.assert_allclose(s25.rho.numpy(), s24.rho.numpy(), rtol=1e-6)
    assert bool(torch.isfinite(s25.res_dual).all())


def test_accel_warns_when_stacked_on_adaptive_schedule(rng, spd):
    """accel with adaptive_rho (or alpha_relax != 1) is measured harmful:
    the API warns, and does not raise."""
    Pn, qn = spd(rng, 4, 6), rng.standard_normal((4, 6))
    P, q = _t(Pn), _t(qn)
    bad = dqt.QP_DEFAULTS.replace(accel=True, backend="xla")  # adaptive_rho on
    jbad = dq.QP_DEFAULTS.replace(accel=True, backend="xla")
    with pytest.warns(UserWarning, match="measured harmful"):
        l, st = dqt.solve_qp_with_stats(P, q, config=bad, max_iter=50, **CPU)
    with pytest.warns(UserWarning, match="measured-harmful"):
        lj, sj = _jax(dq.solve_qp_with_stats, Pn, qn, config=jbad, max_iter=50)
    _hold(st, sj)
    np.testing.assert_allclose(l.numpy(), np.asarray(lj), atol=1e-12)
    good = bad.replace(adaptive_rho=False, alpha_relax=1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        l, st = dqt.solve_qp_with_stats(P, q, config=good, max_iter=50, **CPU)
        lj, sj = _jax(dq.solve_qp_with_stats, Pn, qn,
                      config=jbad.replace(adaptive_rho=False, alpha_relax=1.0), max_iter=50)
    _hold(st, sj)
    np.testing.assert_allclose(l.numpy(), np.asarray(lj), atol=1e-12)
