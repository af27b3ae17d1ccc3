"""The port's dispatch between its kernels and the eager engine / generic
adjoint, and the public steps on the routes it picks.

  * ``api._use_kernel`` (forward) and ``kkt._use_fused_kernel`` (backward,
    with K2's and K4's ``fits``) at N = 24, 168, 170, float32 / float64 and
    each backend: the rule is the card kernels' own bounds (K1 n <= 169, K4
    n <= 168, K2 n <= 150), float32 only, and never depends on the device.
  * The routes those rules name, seen through the plain versions that the
    CPU runs in each kernel's place: a float64 solve runs no kernel's plain
    version; a float32 QP at N = 170 (past K1 and K4) runs the engine and the
    generic route; a float32 QCQP at N = 152 (past K2, within K1) runs K1's
    plain version and the Schur route's Newton-Schulz branch, not K6.
  * Float64 public steps (``solve_qcqp``, ``solve_qp`` with ``device="cpu"``)
    and their gradients against the JAX package's ``backend='xla'`` float64:
    atol 1e-9 on l and 1e-8 max(1, |grad|_inf) on the gradients (both run the
    same engine and generic adjoint).
  * ``backend='xla'`` and ``accel`` through the public steps against the JAX
    package on the same problems: float32 at atol 2e-5 (l) and 1e-4 max(1,
    |grad|_inf) (gradients), float64 at 1e-9 / 1e-8.
  * ``backend='pallas'`` on float64 inputs: the kernels (their plain
    versions here) compute in float32, as the JAX package's kernel path does,
    and the results come back in float64, at those float32 bars from the
    float32 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch import api
from diffqcqp_tpu_torch.diff import kkt
from diffqcqp_tpu_torch.kernels import admm_cuda, coord_bwd_cuda, qcqp_bwd_cuda

SIZES = [24, 168, 170]
BACKENDS = ["auto", "pallas", "xla"]
DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_forward_rule(n, dtype, backend):
    P, q = torch.zeros(1, n, n, dtype=DTYPES[dtype]), torch.zeros(1, n, dtype=DTYPES[dtype])
    cfg = dqt.SolverConfig(backend=backend)
    want = {"pallas": True, "xla": False,
            "auto": dtype == "f32" and n <= 169}[backend]
    assert api._use_kernel(P, q, cfg) is want
    assert dqt.which_backend(P, q, cfg) == ("pallas" if want else "xla")
    # accel: never the kernel under 'auto'; an explicit 'pallas' refuses it
    acc = cfg.replace(accel=True)
    if backend == "pallas":
        with pytest.raises(ValueError, match="accel"):
            api._use_kernel(P, q, acc)
    else:
        assert api._use_kernel(P, q, acc) is False
    # a diagonal P never takes the kernel under 'auto'
    assert api._use_kernel(q.clone(), q, cfg.replace(backend="auto")) is False


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_backward_rule(n, dtype, backend):
    P, l = torch.zeros(1, n, n, dtype=DTYPES[dtype]), torch.zeros(1, n, dtype=DTYPES[dtype])
    cfg = dqt.SolverConfig(backend=backend)
    auto = dtype == "f32"
    for fits, bound in ((qcqp_bwd_cuda.fits, 150), (coord_bwd_cuda.fits, 168)):
        want = {"pallas": True, "xla": False, "auto": auto and n <= bound}[backend]
        assert kkt._use_fused_kernel(P, l, cfg, fits) is want
        assert kkt._use_fused_kernel(l, l, cfg, fits) is False        # diagonal P


def test_kernel_bounds_are_the_card_launch_bounds():
    """The rule's bounds are where each kernel stops fitting a Hopper block:
    K1's and K4's shared memory past the 232,448-byte opt-in, K2's plan."""
    assert admm_cuda.smem_bytes(169) <= 232448 < admm_cuda.smem_bytes(170)
    assert coord_bwd_cuda.smem_bytes(168) <= 232448 < coord_bwd_cuda.smem_bytes(169)
    assert qcqp_bwd_cuda.fits(150) and not qcqp_bwd_cuda.fits(152)
    with pytest.raises(ValueError):
        qcqp_bwd_cuda.launch_plan(152)


class _Spy:
    """Counts the calls of the plain versions (and the engine), which run on
    the CPU in each kernel's place, through the module attributes the
    wrappers look up."""

    TARGETS = {
        "K1": (admm_cuda, "admm_solve_plain"),
        "K2": (qcqp_bwd_cuda, "qcqp_kkt_bwd_fused_plain"),
        "K4": (coord_bwd_cuda, "coord_kkt_bwd_fused_plain"),
        "K6": (qcqp_bwd_cuda, "qcqp_kkt_bwd_plain"),
        "engine": (api, "admm_solve"),
        "ns": (kkt, "_spd_inverse_f32"),
    }

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.TARGETS, 0)
        self.dtypes = set()
        for name, (mod, attr) in self.TARGETS.items():
            monkeypatch.setattr(mod, attr, self._wrap(name, getattr(mod, attr)))

    def _wrap(self, name, fn):
        def f(*a, **k):
            self.calls[name] += 1
            self.dtypes.add(a[0].dtype)
            return fn(*a, **k)
        return f

    def ran(self):
        return {k for k, v in self.calls.items() if v}


def _spd(seed, b, n):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    return rng, S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)


def _qcqp_problem(seed, b, nc):
    rng, P = _spd(seed, b, 2 * nc)
    q = rng.standard_normal((b, 2 * nc)) * 0.5
    return P, q, rng.random((b, nc)) * 0.5 + 0.05, rng.random((b, nc)) * 0.5 + 0.05


def _grads(solve, xs, cfg, w):
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    l = solve(*leaves, config=cfg, device="cpu")
    grads = torch.autograd.grad((l * l).sum() + (torch.from_numpy(w) * l).sum(), leaves)
    return l.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(solve, xs, cfg, w):
    def f(*a):
        l = solve(*a, config=cfg)
        return jnp.sum(l * l) + jnp.sum(jnp.asarray(w) * l), l

    (_, l), g = jax.value_and_grad(f, argnums=tuple(range(len(xs))), has_aux=True)(
        *map(jnp.asarray, xs))
    return np.asarray(l), [np.asarray(x) for x in g]


def _port(cfg):
    return dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))


def _close(port, ref, atol_l, rel_g):
    (lt, gt), (lj, gj) = port, ref
    np.testing.assert_allclose(lt, lj, atol=atol_l, rtol=0)
    for a, b in zip(gt, gj):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=rel_g * max(1.0, float(np.abs(b).max())), rtol=0)


def test_float64_steps_run_no_kernel_and_match_jax_xla(monkeypatch):
    """Fault 2 of the dispatch: a float64 solve stays in float64 through the
    engine and the generic adjoint (no plain version of K1, K2 or K4 runs in
    their place), QCQP and QP, against JAX backend='xla' float64."""
    spy = _Spy(monkeypatch)
    P, q, l_n, mu = _qcqp_problem(0, 6, 4)
    w = np.random.default_rng(1).standard_normal(q.shape)
    jcfg = dq.QCQP_DEFAULTS.replace(eps=1e-10, max_iter=3000, backend="xla")
    port = _grads(dqt.solve_qcqp, (P, q, l_n, mu), _port(jcfg.replace(backend="auto")), w)
    assert spy.ran() == {"engine"} and port[0].dtype == np.float64
    _close(port, _jax_grads(dq.solve_qcqp, (P, q, l_n, mu), jcfg, w), 1e-9, 1e-8)

    spy.calls = dict.fromkeys(spy.calls, 0)
    jcfg = dq.QP_DEFAULTS.replace(eps=1e-10, max_iter=3000, backend="xla")
    port = _grads(dqt.solve_qp, (P, q), _port(jcfg.replace(backend="auto")), w)
    assert spy.ran() == {"engine"}
    _close(port, _jax_grads(dq.solve_qp, (P, q), jcfg, w), 1e-9, 1e-8)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_backend_xla_steps_match_jax(dtype, monkeypatch):
    """backend='xla' through the public QCQP and box-QP steps: the engine and
    the generic adjoint on both sides."""
    spy = _Spy(monkeypatch)
    P, q, l_n, mu = (x.astype(dtype) for x in _qcqp_problem(2, 6, 4))
    w = np.random.default_rng(3).standard_normal(q.shape).astype(dtype)
    eps = 1e-10 if dtype == np.float64 else 1e-6
    bars = (1e-9, 1e-8) if dtype == np.float64 else (2e-5, 1e-4)
    jcfg = dq.QCQP_DEFAULTS.replace(eps=eps, max_iter=3000, backend="xla")
    _close(_grads(dqt.solve_qcqp, (P, q, l_n, mu), _port(jcfg), w),
           _jax_grads(dq.solve_qcqp, (P, q, l_n, mu), jcfg, w), *bars)
    lo, hi = -(l_n * 2.0), l_n * 2.0
    lo, hi = np.concatenate([lo, lo], -1), np.concatenate([hi, hi], -1)
    jcfg = dq.QP_DEFAULTS.replace(eps=eps, max_iter=3000, backend="xla")
    _close(_grads(dqt.solve_box_qp, (P, q, lo, hi), _port(jcfg), w),
           _jax_grads(dq.solve_box_qp, (P, q, lo, hi), jcfg, w), *bars)
    assert spy.ran() == {"engine"} if dtype == np.float64 else spy.ran() <= {"engine", "ns"}
    assert spy.calls["engine"] == 2


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_accel_steps_match_jax(dtype):
    """accel (momentum with restarts) through the public QCQP step, as the
    JAX package's tests run it (alpha_relax = 1, adaptive_rho off)."""
    P, q, l_n, mu = (x.astype(dtype) for x in _qcqp_problem(4, 6, 4))
    w = np.random.default_rng(5).standard_normal(q.shape).astype(dtype)
    eps = 1e-10 if dtype == np.float64 else 1e-6
    jcfg = dq.QCQP_DEFAULTS.replace(eps=eps, max_iter=5000, accel=True, alpha_relax=1.0,
                                    adaptive_rho=False)
    assert dqt.which_backend(P, q, _port(jcfg)) == "xla"
    _close(_grads(dqt.solve_qcqp, (P, q, l_n, mu), _port(jcfg), w),
           _jax_grads(dq.solve_qcqp, (P, q, l_n, mu), jcfg, w),
           *((1e-9, 1e-8) if dtype == np.float64 else (2e-5, 1e-4)))


def test_qp_past_k1_and_k4_runs_the_engine_and_generic_route(monkeypatch):
    """Fault 1 of the dispatch: a float32 QP at N = 170 is past K1's and K4's
    shared memory. It solves through the engine (Newton-Schulz inverse) and
    differentiates through the assembled SPD system (Newton-Schulz again),
    with no kernel's plain version; against the JAX package, whose CPU
    dispatch takes the same engine and route."""
    spy = _Spy(monkeypatch)
    rng, P = _spd(6, 2, 170)
    P = P.astype(np.float32)
    q = rng.standard_normal((2, 170)).astype(np.float32)
    w = rng.standard_normal((2, 170)).astype(np.float32)
    jcfg = dq.QP_DEFAULTS.replace(eps=1e-6, max_iter=3000)
    port = _grads(dqt.solve_qp, (P, q), _port(jcfg), w)
    assert spy.ran() == {"engine", "ns"}
    _close(port, _jax_grads(dq.solve_qp, (P, q), jcfg, w), 2e-5, 1e-4)


def test_qcqp_past_k2_runs_k1_and_the_schur_route(monkeypatch):
    """A float32 QCQP at N = 152: within K1 (its plain version runs), past K2
    and K6 (n <= 150), so the backward recovers the duals and takes the
    Schur route's Newton-Schulz branch. Gradients against the port's own
    float64 step (engine, Cholesky Schur route) on the same problems, at
    1e-3 of each gradient's scale (two float32 forwards of different
    algorithms sit ~1e-5 apart in l)."""
    spy = _Spy(monkeypatch)
    P, q, l_n, mu = _qcqp_problem(7, 2, 76)
    w = np.random.default_rng(8).standard_normal(q.shape)
    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-6, max_iter=3000)
    l32, g32 = _grads(dqt.solve_qcqp, tuple(x.astype(np.float32) for x in (P, q, l_n, mu)), cfg,
                      w.astype(np.float32))
    assert spy.ran() == {"K1", "ns"}
    l64, g64 = _grads(dqt.solve_qcqp, (P, q, l_n, mu), cfg.replace(eps=1e-10), w)
    np.testing.assert_allclose(l32, l64, atol=1e-4, rtol=0)
    for a, b in zip(g32, g64):
        np.testing.assert_allclose(a, b, atol=1e-3 * max(1.0, float(np.abs(b).max())), rtol=0)


@pytest.mark.parametrize("cls", ["qcqp", "qp"])
def test_pallas_backend_runs_float64_inputs_in_float32(cls, monkeypatch):
    """``backend='pallas'`` with float64 inputs: K1 and the class's fused
    backward (K2 or K4) run in float32, as the JAX package's kernel path
    does, and l and the gradients come back in float64, within the float32
    bars (2e-5 on l, 1e-4 of scale on the gradients) of the float32 step."""
    spy = _Spy(monkeypatch)
    P, q, l_n, mu = _qcqp_problem(9, 6, 4)
    xs = (P, q, l_n, mu) if cls == "qcqp" else (P, q)
    solve = dqt.solve_qcqp if cls == "qcqp" else dqt.solve_qp
    cfg = (dqt.QCQP_DEFAULTS if cls == "qcqp" else dqt.QP_DEFAULTS).replace(
        eps=1e-6, max_iter=3000, backend="pallas")
    w = np.random.default_rng(10).standard_normal(q.shape)
    l64, g64 = _grads(solve, xs, cfg, w)
    assert spy.ran() == {"K1", "K2" if cls == "qcqp" else "K4"}
    assert spy.dtypes == {torch.float32}
    assert l64.dtype == np.float64 and all(g.dtype == np.float64 for g in g64)
    l32, g32 = _grads(solve, tuple(x.astype(np.float32) for x in xs), cfg, w.astype(np.float32))
    np.testing.assert_allclose(l64, l32, atol=2e-5, rtol=0)
    for a, b in zip(g64, g32):
        np.testing.assert_allclose(a, b, atol=1e-4 * max(1.0, float(np.abs(b).max())), rtol=0)
