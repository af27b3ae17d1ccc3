"""The port's eager ADMM engine (``solvers/admm.py::admm_solve``) against the
JAX package's XLA engine (``diffqcqp_tpu/solvers/admm.py::admm_solve``) on
the same numpy problems (b = 20, n = 8, tests/test_torch_admm.py's
generator), for the four prox kinds and the engine's branches.

Bars, per the engine's two precisions:

  * float64 at eps = 1e-10: atol 1e-10 on l, iterations within 1 per
    problem, equal ``converged`` and ``stalled``; spectral (``linsolve``
    'auto' at n = 8) and, with ``linsolve='chol'``, the Cholesky inverse;
  * float32 at eps = 1e-5, where the problems certify on eps before the
    float32 noise floor: atol 2e-5 on l, iterations within 1, equal
    ``converged``, in both linsolve modes (the spectral handle, and
    ``linsolve='chol'`` forced at n = 8, the Newton-Schulz inverse).

Branches: ``accel`` (with alpha_relax = 1, adaptive_rho off, as the JAX
package's tests run it), ``rho_sync=False`` (the per-problem cpt gate),
``warm_start_dual`` from a converged primal, ``max_iter=2`` (``rho_res``
against the JAX ``rho``, the capped problems' recorded penalty), and a
diagonal P.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffqcqp_tpu.config import QCQP_DEFAULTS, SolverConfig
from diffqcqp_tpu.ops import prox as jp
from diffqcqp_tpu.solvers.admm import admm_solve as j_solve
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.ops import prox as tp
from diffqcqp_tpu_torch.solvers.admm import admm_solve as t_solve, make_admm_step

QP = SolverConfig(max_iter=3000)
QCQP = QCQP_DEFAULTS.replace(max_iter=3000)
EPS = {np.float64: 1e-10, np.float32: 1e-5}
KINDS = ["nonneg", "box", "signed_box", "disk"]


def _problems(seed, b, n, dtype):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((b, n, n))
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = rng.standard_normal((b, n))
    lo = -(rng.random((b, n)) * 0.5 + 0.2)
    hi = rng.random((b, n)) * 0.5 + 0.2
    vs = np.sign(rng.standard_normal((b, n)))
    radius = rng.random((b, n // 2)) * 0.5 + 0.05
    args = {"nonneg": (), "box": (lo, hi), "signed_box": (lo, hi, vs), "disk": (radius,)}
    cast = lambda x: x.astype(dtype)  # noqa: E731
    return cast(P), cast(q), {k: tuple(map(cast, v)) for k, v in args.items()}


def _prox(mod, kind, args):
    return {
        "nonneg": mod.prox_nonneg,
        "box": lambda x: mod.prox_box(x, *args),
        "signed_box": lambda x: mod.prox_signed_box(x, *args),
        "disk": lambda x: mod.prox_disk(x, *args),
    }[kind]


def _run_both(kind, P, q, ws, pa, cfg):
    qstop = kind == "disk"
    lj, sj = j_solve(jnp.asarray(P), jnp.asarray(q), jnp.asarray(ws),
                     _prox(jp, kind, tuple(map(jnp.asarray, pa))), cfg,
                     qcqp_stopping=qstop, damp_both_taus=not qstop)
    tcfg = dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))
    lt, st = t_solve(torch.from_numpy(P), torch.from_numpy(q), torch.from_numpy(ws),
                     _prox(tp, kind, tuple(map(torch.from_numpy, pa))), tcfg,
                     qcqp_stopping=qstop, damp_both_taus=not qstop)
    return (np.asarray(lj), sj), (lt.numpy(), st)


def _assert_parity(out_j, out_t, dtype, stalled=True):
    (lj, sj), (lt, st) = out_j, out_t
    assert lt.dtype == dtype
    np.testing.assert_allclose(lt, lj, atol=1e-10 if dtype == np.float64 else 2e-5, rtol=0)
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
    if stalled:
        np.testing.assert_array_equal(st.stalled.numpy(), np.asarray(sj.stalled))
    assert int(np.abs(st.iterations.numpy() - np.asarray(sj.iterations)).max()) <= 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype, linsolve", [(np.float64, "auto"), (np.float64, "chol"),
                                             (np.float32, "auto"), (np.float32, "chol")],
                         ids=["f64-spectral", "f64-chol", "f32-spectral", "f32-ns"])
def test_engine_matches_jax(kind, dtype, linsolve):
    P, q, pa = _problems(0, 20, 8, dtype)
    cfg = (QCQP if kind == "disk" else QP).replace(eps=EPS[dtype], linsolve=linsolve)
    out_j, out_t = _run_both(kind, P, q, np.zeros_like(q), pa[kind], cfg)
    _assert_parity(out_j, out_t, dtype, stalled=dtype == np.float64)
    assert out_t[1].converged.all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_engine_accel_matches_jax(dtype):
    P, q, pa = _problems(1, 20, 8, dtype)
    cfg = QCQP.replace(eps=EPS[dtype], accel=True, alpha_relax=1.0, adaptive_rho=False)
    out_j, out_t = _run_both("disk", P, q, np.zeros_like(q), pa["disk"], cfg)
    _assert_parity(out_j, out_t, dtype, stalled=dtype == np.float64)


def test_engine_staggered_schedule_matches_jax():
    """rho_sync=False: the per-problem cpt % period gate."""
    P, q, pa = _problems(2, 20, 8, np.float64)
    out_j, out_t = _run_both("box", P, q, np.zeros_like(q), pa["box"],
                             QP.replace(eps=1e-10, rho_sync=False))
    _assert_parity(out_j, out_t, np.float64)


def test_engine_warm_start_dual_matches_jax():
    P, q, pa = _problems(3, 20, 8, np.float64)
    cfg = QP.replace(eps=1e-10)
    (l0, _), (_, cold) = _run_both("nonneg", P, q, np.zeros_like(q), (), cfg)
    out_j, out_t = _run_both("nonneg", P, q, l0, (), cfg.replace(warm_start_dual=True))
    _assert_parity(out_j, out_t, np.float64)
    assert float(out_t[1].iterations.double().mean()) < 0.5 * float(cold.iterations.double().mean())


def test_engine_max_iter_cap_matches_jax():
    """Capped at 2 iterations: nothing converged, and the recorded rho is
    the one the residuals were computed with (rho_res), as in the JAX
    engine."""
    P, q, pa = _problems(4, 20, 8, np.float64)
    out_j, out_t = _run_both("disk", P, q, np.zeros_like(q), pa["disk"],
                             QCQP.replace(eps=1e-10, max_iter=2))
    _assert_parity(out_j, out_t, np.float64)
    st, sj = out_t[1], out_j[1]
    assert not st.converged.any() and torch.all(st.iterations == 2)
    np.testing.assert_allclose(st.rho.numpy(), np.asarray(sj.rho), rtol=1e-12)
    np.testing.assert_allclose(st.res_prim.numpy(), np.asarray(sj.res_prim), rtol=1e-9)


def test_engine_diagonal_p_matches_jax():
    P, q, _ = _problems(5, 20, 8, np.float64)
    d = np.ascontiguousarray(np.diagonal(P, axis1=1, axis2=2))
    out_j, out_t = _run_both("nonneg", d, q, np.zeros_like(q), (), QP.replace(eps=1e-10))
    _assert_parity(out_j, out_t, np.float64)
    np.testing.assert_allclose(out_t[0], np.maximum(0.0, -q / d), atol=1e-9)


def test_make_admm_step_drives_the_same_loop():
    P, q, pa = _problems(6, 6, 8, np.float64)
    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-10)
    args = (torch.from_numpy(P), torch.from_numpy(q), torch.zeros(6, 8, dtype=torch.float64),
            _prox(tp, "disk", tuple(map(torch.from_numpy, pa["disk"]))), cfg, True, False)
    cond, body, s = make_admm_step(*args)
    while cond(s):
        s = body(s)
    l, st = t_solve(*args)
    assert torch.equal(s.l2, l) and torch.equal(s.iters, st.iterations)
    with pytest.raises(NameError, match="unbound axis name 'b'"):
        make_admm_step(*args[:4], cfg.replace(axis_name="b"), True, False)
