"""The port's solve traces (``diffqcqp_tpu_torch/debug.py``) against the JAX
package's (``diffqcqp_tpu/debug.py``) on the same numpy problems, float64,
and against the port's own production solve.

Bars: every ``SolveTrace`` field against the JAX trace at atol 1e-10 (l2,
the residual histories, rho), ``iterations``, ``active`` and ``converged``
equal; the trace's l2 and iterations equal the port's ``backend='xla'``
solve capped at the same count, bit for bit (the JAX file's atol 0).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
from diffqcqp_tpu import debug as jdebug
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch import debug

CFG = dqt.SolverConfig(eps=1e-10, max_iter=2000, backend="xla")
QCFG = dqt.QCQP_DEFAULTS.replace(eps=1e-9, backend="xla")
CLASSES = ("qp", "box_qp", "signed_box_qp", "qcqp")


def _spd(rng, b, n):
    s = rng.standard_normal((b, n, n))
    return s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n)


def _problem(kind, rng, b, n, spread=0.0):
    """(P, q, *params) of a class, numpy float64; ``spread`` scales P's
    coordinates by exp(linspace(-spread, spread)) (what equilibration undoes)."""
    P = _spd(rng, b, n)
    scales = np.exp(np.linspace(-spread, spread, n))
    P = P * scales[None, :, None] * scales[None, None, :]
    q = rng.standard_normal((b, n)) * scales[None, :]
    if kind == "qp":
        return (P, q)
    if kind == "qcqp":
        nc = n // 2
        return (P, q, rng.random((b, nc)) * 0.5 + 0.05, rng.random((b, nc)) * 0.5 + 0.05)
    lo, hi = -(rng.random((b, n)) * 0.4 + 0.05), rng.random((b, n)) * 0.4 + 0.05
    return (P, q, lo, hi) + ((rng.standard_normal((b, n)),) if kind == "signed_box_qp" else ())


def _jax_cfg(cfg):
    return dq.SolverConfig(**dataclasses.asdict(cfg))


def _both(kind, xs, iters, cfg):
    jt = getattr(jdebug, f"trace_{kind}")(*map(jnp.asarray, xs), iters=iters, config=_jax_cfg(cfg))
    tt = getattr(debug, f"trace_{kind}")(*map(torch.from_numpy, xs), iters=iters, config=cfg,
                                         device="cpu")
    return jt, tt


@pytest.mark.parametrize("equilibrate", [False, True], ids=["plain", "equilibrate"])
@pytest.mark.parametrize("kind", CLASSES)
def test_trace_matches_jax(kind, equilibrate):
    rng = np.random.default_rng(3)
    xs = _problem(kind, rng, 6, 8, spread=1.5 if equilibrate else 0.0)
    cfg = (QCFG if kind == "qcqp" else CFG).replace(equilibrate=equilibrate)
    iters = 150
    jt, tt = _both(kind, xs, iters, cfg)
    for f in ("l2", "res_prim", "res_dual", "rho"):
        a, b = getattr(tt, f).numpy(), np.asarray(getattr(jt, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=1e-10, rtol=0, err_msg=f)
    for f in ("active", "converged", "iterations"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    assert tt.res_dual.shape == (iters, 6)
    # the trace is the production engine's run at that count
    l, st = getattr(dqt, f"solve_{kind}_with_stats")(*map(torch.from_numpy, xs),
                                                       config=cfg.replace(max_iter=iters),
                                                       device="cpu")
    assert torch.equal(tt.l2, l) and torch.equal(tt.iterations, st.iterations)


def test_trace_matches_production_solve():
    rng = np.random.default_rng(0)
    P, q = _problem("qp", rng, 8, 8)
    tr = debug.trace_qp(P, q, iters=400, config=CFG, device="cpu")
    l_ref, st = dqt.solve_qp_with_stats(P, q, config=CFG.replace(max_iter=400), device="cpu")
    assert torch.equal(tr.l2, l_ref)
    assert torch.equal(tr.iterations, st.iterations)
    assert bool(tr.converged.all())


def test_trace_histories_describe_convergence():
    rng = np.random.default_rng(1)
    P, q = _problem("qp", rng, 6, 8)
    K = 300
    tr = debug.trace_qp(P, q, iters=K, config=CFG, device="cpu")
    rd, act, its = tr.res_dual.numpy(), tr.active.numpy(), tr.iterations.numpy()
    for i in range(6):
        # the dual residual at each problem's final active step certifies eps
        assert rd[its[i] - 1, i] < CFG.eps or not tr.converged[i]
        # active flags count the iterations exactly
        assert act[:, i].sum() == its[i]
    # rho history: positive throughout, frozen after convergence
    rho = tr.rho.numpy()
    assert np.all(rho > 0)
    for i in range(6):
        k = its[i]
        if k < K:
            assert np.all(rho[k:, i] == rho[k, i])


def test_trace_qcqp_feasibility_over_time():
    rng = np.random.default_rng(2)
    xs = _problem("qcqp", rng, 4, 6)
    tr = debug.trace_qcqp(*xs, iters=2000, config=QCFG, device="cpu")
    assert bool(tr.converged.all())
    assert bool((tr.res_dual[-1] <= 1e-9).all())


def test_trace_accel_returns_the_plain_iterate():
    """cfg.accel: l2 is the plain iterate (the solve's answer), not the
    extrapolated restart point the engine carries, as in the JAX package."""
    rng = np.random.default_rng(4)
    xs = _problem("qp", rng, 6, 8)
    cfg = CFG.replace(accel=True, alpha_relax=1.0, adaptive_rho=False)
    jt, tt = _both("qp", xs, 200, cfg)
    np.testing.assert_allclose(tt.l2.numpy(), np.asarray(jt.l2), atol=1e-10, rtol=0)
    np.testing.assert_array_equal(tt.iterations.numpy(), np.asarray(jt.iterations))
    l, _ = dqt.solve_qp_with_stats(*xs, config=cfg.replace(max_iter=200), device="cpu")
    assert torch.equal(tt.l2, l)


def test_trace_on_the_card_by_default():
    """The default device is the card; without CUDA the trace raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        debug.trace_qp(np.eye(2)[None], np.ones((1, 2)), iters=3)
    with pytest.raises(ValueError, match="iters"):
        debug.trace_qp(np.eye(2)[None], np.ones((1, 2)), iters=0, device="cpu")
