"""Staging (``utils/staging.py``) and the capture guard, on the CPU:

  * the guard, with ``torch.cuda.is_current_stream_capturing`` patched to
    report a capture: a lockstep solve (``axis_name``) over a mesh whose
    shards lie on two devices raises the guard's ``RuntimeError`` naming the
    route and the reason; every other route runs and gives the bits it
    gives without the patch: the lockstep mode on one device (a sharded
    solve, a trace inside ``parallel.lockstep``), the float32 dense kernel
    route (the plain K1, K2 and K4 here), the engine with a diagonal P, in
    its inverse modes and in its spectral mode (a dense P at n = 6 in
    float64, with ``accel`` or ``backend='xla'``), the generic adjoint
    route's Newton-Schulz inverse, Cholesky and LU, a trace in either mode
    and the Jacobians (on CPU tensors these take their eager forms, the
    spectral mode LAPACK's eigh; their capture forms run on the card, the
    spectral mode's through the Jacobi kernel E1, the lockstep mode's as one
    WHILE node: ``chip_smoke.py`` phases 3o, 3p and 3q);
  * ``staged`` on CPU tensors is ``fn``, call for call, and captures
    nothing; its signature key separates shape, dtype and
    ``requires_grad``; it takes tensors only;
  * ``SystemID`` on the CPU keeps a non-capturable Adam and no staged step,
    with the JAX package's losses (as ``tests/test_torch_models.py``);
    ``system_id.capturable_route``, which decides whether a card model
    stages its step, names every route, the lockstep mode's included.

The staged step on a card is ``tests/test_torch_gpu.py``'s and
``chip_smoke.py``'s (phases 3n, 4n, 3o, 4o, 3p, 4p, 3q, 4q).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.diff import kkt
from diffqcqp_tpu_torch.models import system_id as tsid
from diffqcqp_tpu_torch.parallel import BatchMesh, lockstep, make_batch_mesh, solve_qcqp_sharded
from diffqcqp_tpu_torch.utils import staged
from diffqcqp_tpu_torch.utils.staging import Staged, signature

CFG = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400)


def _problems(b, nc, seed=0, dtype=np.float32):
    """bench.py's QCQP generator."""
    n = 2 * nc
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = rng.standard_normal((b, n)) * 0.5
    l_n = rng.random((b, nc)) * 0.5 + 0.05
    mu = rng.random((b, nc)) * 0.5 + 0.05
    return [torch.tensor(x.astype(dtype)) for x in (P, q, l_n, mu)]


def _report_capture(monkeypatch):
    """Make the CPU report a CUDA graph capture in progress."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)


def _lockstep_qcqp(devices):
    mesh = BatchMesh(tuple(torch.device(d) for d in devices), "batch")
    return lambda: solve_qcqp_sharded(*_problems(4, 3), mesh=mesh, config=CFG, lockstep=True)


# the lockstep mode (axis_name) on a mesh that cannot record: refused under
# a capture; on one device it records (the reason the refusal names)
ENGINE_CASES = {
    "axis_name": (_lockstep_qcqp(["cpu", "cuda:0"]), _lockstep_qcqp(["cpu", "cpu"]),
                  "on 2 devices (cpu, cuda:0)"),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_guard_refuses_the_engine_under_capture(monkeypatch, case):
    """The lockstep mode records under a capture, its shards' loops one
    loop, with its eager bits, where the mesh puts every shard of the
    process on one device; over two devices the guard refuses it, naming
    them, before any shard is placed."""
    refused, recorded, reason = ENGINE_CASES[case]
    _same(monkeypatch, recorded)
    _report_capture(monkeypatch)
    with pytest.raises(RuntimeError, match="the lockstep mode") as err:
        refused()
    assert reason in str(err.value)
    assert "cannot run inside a CUDA graph capture" in str(err.value)


def _same(monkeypatch, call):
    """``call()`` gives the same bits under the patched capture as without."""
    want = call()
    with monkeypatch.context() as m:
        _report_capture(m)
        got = call()
    leaves = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(leaves[0]) == len(leaves[1])
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(*leaves))


# the engine's routes that record under a capture (the loop a WHILE node,
# the inverse's recompute two IF nodes, the spectral set-up the Jacobi
# kernel E1 on the card): each runs with its eager bits
CAPTURED_ENGINE = {
    "float64, the spectral mode": lambda: _step_qcqp([x.double() for x in _problems(3, 3)]),
    "accel, the spectral mode": lambda: _step_qcqp(_problems(3, 3), CFG.replace(
        accel=True, adaptive_rho=False, alpha_relax=1.0)),
    "backend=xla, the spectral mode": lambda: _step_qcqp(_problems(3, 3),
                                                         CFG.replace(backend="xla")),
    "diagonal P": lambda: _step_qcqp([torch.diagonal(_problems(3, 3)[0], dim1=1, dim2=2)
                                      .contiguous(), *_problems(3, 3)[1:]]),
    "n=170, the float32 Newton-Schulz inverse": lambda: _step_qcqp(_problems(2, 85)),
    "float64 n=50, the Cholesky inverse": lambda: _step_qcqp(
        [x.double() for x in _problems(2, 25)]),
    "accel at n=50": lambda: _step_qcqp(_problems(2, 25), CFG.replace(
        accel=True, adaptive_rho=False, alpha_relax=1.0)),
    "linsolve='chol' at n=6": lambda: _step_qcqp(_problems(3, 3), CFG.replace(linsolve="chol")),
}


@pytest.mark.parametrize("case", list(CAPTURED_ENGINE))
def test_capture_lets_the_engine_through(monkeypatch, case):
    _same(monkeypatch, CAPTURED_ENGINE[case])


def _generic_qcqp(xs, dtype):
    """The generic QCQP adjoint with the duals given, at the problems' l."""
    P, q, l_n, mu = (x.to(dtype) for x in xs)
    l = dqt.solve_qcqp(P.float(), q.float(), l_n.float(), mu.float(), config=CFG,
                       device="cpu").to(dtype)
    r = l_n * mu
    return lambda: kkt.qcqp_vjp(P, q, r, l, 2.0 * l, CFG, duals=kkt.qcqp_dual(P, q, r, l, CFG))


@pytest.mark.parametrize("nc, dtype", [
    (3, torch.float64),             # nc + n = 9: the assembled system, an LU
    (3, torch.float32),             # float32 on the CPU: the LU as well
    (30, torch.float64),            # nc + n = 90 > 88: Cholesky of D, LU
])
def test_capture_lets_the_generic_route_through(monkeypatch, nc, dtype):
    _same(monkeypatch, _generic_qcqp(_problems(2, nc), dtype))


def test_capture_lets_the_float32_newton_schulz_inverse_through(monkeypatch):
    """The QP's generic route sends a float32 SPD system on the CPU to the
    Newton-Schulz inverse, whose loop records as a WHILE node."""
    P, q = _problems(2, 3)[:2]
    l = torch.clamp_min(torch.randn(2, 6, generator=torch.Generator().manual_seed(0)), 0)
    _same(monkeypatch, lambda: kkt._qp_assembled_vjp(P, q, l, torch.ones_like(l), CFG))


@pytest.mark.parametrize("name", ["trace_qp", "trace_qp, linsolve='chol'", "qp_jacobian",
                                  "qcqp_jacobian", "trace_qp, axis_name='batch'"])
def test_guard_refuses_traces_and_jacobians(monkeypatch, name):
    """None is refused: a trace in the spectral mode (N = 6), in the inverse
    mode or in the lockstep mode (inside a binding of its axis: its body
    steps, as in the JAX package) and the Jacobians (a Cholesky and an LU)
    run with their eager bits."""
    P, q, l_n, mu = _problems(2, 3)
    qc = dqt.QCQP_DEFAULTS.replace(eps=1e-7)
    call = {"trace_qp": lambda: dqt.debug.trace_qp(P, q, iters=3, device="cpu"),
            "trace_qp, linsolve='chol'": lambda: dqt.debug.trace_qp(
                P, q, iters=3, config=dqt.QP_DEFAULTS.replace(linsolve="chol"), device="cpu"),
            "qp_jacobian": lambda: dqt.qp_jacobian(P, q, l=torch.zeros_like(q), device="cpu"),
            "qcqp_jacobian": lambda: dqt.qcqp_jacobian(P, q, l_n, mu, config=qc.replace(
                backend="pallas"), device="cpu"),
            "trace_qp, axis_name='batch'": lambda: _in_binding(lambda: dqt.debug.trace_qp(
                P, q, iters=3, config=dqt.QP_DEFAULTS.replace(axis_name="batch"), device="cpu"))}
    _same(monkeypatch, call[name])


def _in_binding(fn):
    with lockstep(make_batch_mesh(["cpu"])):
        return fn()


def _step_qcqp(xs, cfg=CFG):
    leaves = [x.clone().requires_grad_() for x in xs]
    l, st = dqt.solve_qcqp_with_stats(*leaves, config=cfg, device="cpu")
    return l, st, torch.autograd.grad((l * l).sum(), leaves)


def _step_box(xs, signed):
    P, q = xs[:2]
    n = q.shape[-1]
    rng = np.random.default_rng(9)
    lo = torch.tensor(-(rng.random((q.shape[0], n)) * 0.9 + 0.1), dtype=torch.float32)
    hi = torch.tensor(rng.random((q.shape[0], n)) * 0.9 + 0.1, dtype=torch.float32)
    leaves = [x.clone().requires_grad_() for x in (P, q, lo, hi)]
    cfg = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=2000)
    if signed:
        v = torch.tensor(rng.standard_normal((q.shape[0], n)), dtype=torch.float32)
        l, st = dqt.solve_signed_box_qp_with_stats(*leaves, v, config=cfg, device="cpu")
    else:
        l, st = dqt.solve_box_qp_with_stats(*leaves, config=cfg, device="cpu")
    return l, st, torch.autograd.grad((l * l).sum(), leaves)


def _step_qp(xs):
    leaves = [x.clone().requires_grad_() for x in xs[:2]]
    l, st = dqt.solve_qp_with_stats(*leaves, config=dqt.QP_DEFAULTS.replace(eps=1e-7),
                                    device="cpu")
    return l, st, torch.autograd.grad((l * l).sum(), leaves)


STEPS = {"qcqp (K1, K2)": _step_qcqp, "qp (K1, K4)": _step_qp,
         "box (K1, K4)": lambda xs: _step_box(xs, False),
         "signed box (K1, K4)": lambda xs: _step_box(xs, True)}


@pytest.mark.parametrize("name", list(STEPS))
def test_guard_lets_the_kernel_route_through(monkeypatch, name):
    """The float32 dense route (the plain versions of K1 and K2 or K4 on the
    CPU) runs under the patched capture, with the bits it gives without."""
    xs = _problems(4, 4, seed=2)
    want = STEPS[name](xs)
    _report_capture(monkeypatch)
    got = STEPS[name](xs)
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)))


def test_staged_on_the_cpu_is_fn_and_captures_nothing():
    calls = []

    def step(P, q, l_n, mu):
        calls.append(1)
        return _step_qcqp((P, q, l_n, mu))

    s = staged(step)
    assert isinstance(s, Staged) and s.__name__ == "step"
    for seed in (0, 1, 2, 3, 4):                   # past the warm-up count
        xs = _problems(3, 3, seed=seed)
        got, want = s(*xs), _step_qcqp(xs)
        assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(got),
                                                     pytree.tree_leaves(want)))
    assert len(calls) == 5 and s.graphs == {}


def test_staged_as_a_decorator():
    @staged
    def f(a, b):
        """The sum."""
        return {"sum": a + b}

    assert isinstance(f, Staged) and f.__doc__ == "The sum."
    assert torch.equal(f(torch.ones(2), torch.ones(2))["sum"], torch.full((2,), 2.0))


def test_staged_takes_tensors_only():
    s = staged(lambda a, k: a * k)
    with pytest.raises(TypeError, match="tensors only"):
        s(torch.ones(2), 3.0)
    with pytest.raises(TypeError, match="tensors only"):
        signature(torch.ones(2), "x")


def test_signature_separates_shape_dtype_and_requires_grad():
    x = torch.zeros(4, 6)
    base = signature(x, (x, x))
    assert base == signature(torch.ones(4, 6), (torch.ones(4, 6), torch.ones(4, 6)))
    assert base != signature(torch.zeros(5, 6), (x, x))                       # shape
    assert base != signature(x.double(), (x, x))                              # dtype
    assert base != signature(x.clone().requires_grad_(), (x, x))              # requires_grad
    assert base != signature(x, [x, x])                                       # structure
    assert base != signature(x, (x, x), w=x)                                  # keywords


def _port_cfg(cfg):
    return dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))


def test_system_id_on_the_cpu_is_eager_and_matches_jax():
    """A CPU model keeps a non-capturable Adam and stages nothing, and its
    losses and parameters over 3 Adam steps are the JAX package's (optax
    Adam; float64 at eps=1e-10, as tests/test_torch_models.py)."""
    pytest.importorskip("optax")
    import jax
    import jax.numpy as jnp

    import diffqcqp_tpu as dq
    from diffqcqp_tpu.models import system_id as jsid

    jcfg = dq.QCQP_DEFAULTS.replace(eps=1e-10, max_iter=5000)
    jm = jsid.SystemID(kind="qcqp", config=jcfg, learning_rate=1e-2)
    params = jm.init_qcqp(jax.random.key(5), batch=4, nc=3)
    target = np.random.default_rng(6).random((4, 6)) * 0.1
    tm = tsid.SystemID(kind="qcqp", config=_port_cfg(jcfg), learning_rate=1e-2, device="cpu")
    tm.set_params(tsid.params_from_numpy(params, device="cpu", dtype=torch.float64))
    assert tm.opt.defaults["capturable"] is False and tm._staged_step is None
    state = jm.opt.init(params)
    for _ in range(3):
        params, state, jl = jm.train_step(params, state, jnp.asarray(target))
        tl = tm.train_step(torch.tensor(target))
        assert abs(float(tl) - float(jl)) <= 1e-8
    for name, a in zip(tm._fields, params):
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(), np.asarray(a), atol=1e-6)


def _sysid_params(kind, n, diag=False, dtype=torch.float32):
    m = tsid.SystemID(kind=kind, device="cpu")
    g = torch.Generator().manual_seed(1)
    if kind == "qp":
        return m.init_qp(g, batch=2, n=n, diag=diag, dtype=dtype)
    return m.init_qcqp(g, batch=2, nc=n // 2, dtype=dtype)


QP_CFG = dqt.QP_DEFAULTS.replace(eps=1e-7)
ROUTE_CASES = {
    # kind, n, diag, dtype, config, a CUDA graph can hold its step
    "qp dense float32": ("qp", 8, False, torch.float32, QP_CFG, True),
    "qcqp dense float32": ("qcqp", 8, False, torch.float32, CFG, True),
    "qp at K4's bound n=168": ("qp", 168, False, torch.float32, QP_CFG, True),
    "qcqp at K2's bound n=150": ("qcqp", 150, False, torch.float32, CFG, True),
    "qp diagonal P": ("qp", 8, True, torch.float32, QP_CFG, True),
    "qp float64": ("qp", 8, False, torch.float64, QP_CFG, True),
    "qcqp float64": ("qcqp", 8, False, torch.float64, CFG, True),
    "qp accel": ("qp", 8, False, torch.float32,
                 QP_CFG.replace(accel=True, adaptive_rho=False, alpha_relax=1.0), True),
    "qcqp backend=xla": ("qcqp", 8, False, torch.float32, CFG.replace(backend="xla"), True),
    "qp n=169, K1 but past K4": ("qp", 169, False, torch.float32, QP_CFG, True),
    "qcqp n=152, K1 but past K2": ("qcqp", 152, False, torch.float32, CFG, True),
    "qp n=170, past K1": ("qp", 170, False, torch.float32, QP_CFG, True),
    "qcqp float64 n=50, the Cholesky inverse": ("qcqp", 50, False, torch.float64, CFG, True),
    "qp float64 linsolve='chol'": ("qp", 8, False, torch.float64,
                                   QP_CFG.replace(linsolve="chol"), True),
    "qp axis_name": ("qp", 8, False, torch.float32, QP_CFG.replace(axis_name="batch"), True),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_system_id_stages_a_capturable_route(case):
    """``capturable_route`` is what ``SystemID.set_params`` asks before it
    stages a card model's step: True on every route (the spectral mode, a
    dense P at N <= 48 off K1, stages through the Jacobi kernel E1; the
    lockstep mode's mesh is checked at the capture, where a gloo group or
    shards on two cards refuse it)."""
    kind, n, diag, dtype, cfg, want = ROUTE_CASES[case]
    assert tsid.capturable_route(kind, _sysid_params(kind, n, diag, dtype), cfg) is want


@pytest.mark.parametrize("diag, dtype", [(True, torch.float32), (False, torch.float64)])
def test_system_id_off_the_kernel_route_trains_eagerly_past_the_warm_up(diag, dtype):
    """A diagonal-P and a float64 model keep training past ``WARMUP`` + 1
    steps (eagerly), their losses falling as without staging."""
    m = tsid.SystemID(kind="qp", config=QP_CFG, learning_rate=5e-2, device="cpu")
    m.init_qp(torch.Generator().manual_seed(2), batch=4, n=6, diag=diag, dtype=dtype)
    target = torch.rand(4, 6, generator=torch.Generator().manual_seed(3), dtype=dtype) * 0.1
    losses = [float(m.train_step(target)) for _ in range(6)]
    assert m._staged_step is None and m.opt.defaults["capturable"] is False
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
