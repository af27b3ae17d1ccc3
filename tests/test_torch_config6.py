"""Config 6 as a slice: the JAX package's large-N QP (benchmarks/
run_benchmarks.py config 6: ``_spd``'s P, q ~ N(0, 1), the schedule
``QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho_update_period=24)``, and
its step, the value and gradient of sum(solve_qp(P, q)^2) for P and q)
through the port's ``solve_qp`` and ``torch.autograd`` against
``jax.value_and_grad`` through the JAX package's ``solve_qp``, on the same
numpy problems (``_spd``'s recipe, seed 6) cut to B=4 at config 6's N=96
and to B=16, N=40.

  * float32: the port runs K1's and K4's plain versions (its dispatch takes
    the kernels to N = 169 and 168; counted here), the JAX package its XLA
    engine and generic adjoint route (``backend='xla'``, what it takes on
    the CPU). Two algorithms, so tests/test_torch_qp_grad.py's float32 bar:
    the loss and each gradient within 5e-4 max(1, |.|_inf) of the JAX
    package's; l within 1e-4 (phase 3's bar in chip_smoke.py); every
    problem converged.
  * float64 at eps=1e-10 (max_iter=5000): both sides run the eager engine
    and the generic route (no kernel's plain version), so the loss, l and
    gradients within 1e-8 max(1, |.|_inf).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.kernels import admm_cuda, coord_bwd_cuda

CONFIG6 = dq.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho_update_period=24)
SIZES = {"b4_n96": (4, 96), "b16_n40": (16, 40)}
CASES = [(size, dtype) for size in SIZES for dtype in ("f32", "f64")]


def _spd_problems(b, n, seed=6):
    """run_benchmarks.py::_spd in float32, then q ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)).astype(np.float32) / np.sqrt(n)
    P = s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32)
    return P, rng.standard_normal((b, n)).astype(np.float32)


@pytest.mark.parametrize("size,dtype", CASES, ids=[f"{s}-{d}" for s, d in CASES])
def test_config6_step_matches_jax(size, dtype, monkeypatch):
    P, q = (x.astype(np.float32 if dtype == "f32" else np.float64) for x in _spd_problems(*SIZES[size]))
    cfg = CONFIG6.replace(backend="xla")
    if dtype == "f64":
        cfg = cfg.replace(eps=1e-10, max_iter=5000)

    def loss_j(P, q):
        return jnp.sum(dq.solve_qp(P, q, config=cfg) ** 2)

    v_j, (gP_j, gq_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(jnp.asarray(P), jnp.asarray(q))
    l_j, st_j = dq.solve_qp_with_stats(jnp.asarray(P), jnp.asarray(q), config=cfg)

    calls = {"K1": 0, "K4": 0}
    for name, mod, attr in (("K1", admm_cuda, "admm_solve_plain"),
                            ("K4", coord_bwd_cuda, "coord_kkt_bwd_fused_plain")):
        def counted(*a, _fn=getattr(mod, attr), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, attr, counted)
    tcfg = dqt.SolverConfig.from_dict(dataclasses.asdict(cfg.replace(backend="auto")))
    Pt, qt = (torch.from_numpy(x).requires_grad_() for x in (P, q))
    l_t, st_t = dqt.solve_qp_with_stats(Pt, qt, config=tcfg, device="cpu")
    v_t = (l_t * l_t).sum()
    gP_t, gq_t = torch.autograd.grad(v_t, (Pt, qt))

    assert calls == ({"K1": 1, "K4": 1} if dtype == "f32" else {"K1": 0, "K4": 0})
    assert bool(st_t.converged.all()) and bool(np.all(st_j.converged))
    bar, bar_l = (5e-4, 1e-4) if dtype == "f32" else (1e-8, 1e-8)
    for got, want, name in ((v_t, v_j, "loss"), (gP_t, gP_j, "grad P"), (gq_t, gq_j, "grad q")):
        want = np.asarray(want)
        assert got.dtype == Pt.dtype and tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, err_msg=name,
                                   atol=bar * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(l_t.detach().numpy(), np.asarray(l_j), rtol=0,
                               atol=bar_l * max(1.0, float(np.abs(np.asarray(l_j)).max())))
    assert 0 < int((l_t == 0).sum()) < l_t.numel()       # strictly active and free coordinates
