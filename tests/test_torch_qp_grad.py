"""The QP-family slice end to end: gradients through the port's
``solve_qp`` / ``solve_box_qp`` / ``solve_signed_box_qp`` (in float32 K1
forward and K4 backward, their plain versions on the CPU; in float64 the
eager engine and the generic adjoint) against ``jax.grad`` through the
JAX package's, plus the duals, the raw derivatives, the ``*Fn2`` bindings
and the entry points' guards.

Problems: the JAX package's benchmark generators at B=8, N=8 (the QP row's
SPD P and q ~ N(0, 1); the box rows' l_min = -(U 0.9 + 0.1), l_max =
U 0.9 + 0.1 and v ~ N(0, 1), here with a zero column). Loss: sum(l^2) +
<w, l> with a fixed random w.

Bars: float32 against the JAX kernel path (backend="pallas": K1 and K4 in
interpret mode), atol 5e-4 * max(1, max|grad|), the JAX suite's end-to-end
bar (tests/test_coord_bwd_kernel.py). float64 against the JAX generic path
(backend="xla", eps=1e-10): atol 1e-8 * max(1, max|grad|); both sides run
the same float64 engine and generic route. Duals and derivatives in
float64: atol 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
from diffqcqp_tpu import torch_autograd as jta
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch import torch_autograd as tta

B, N = 8, 8
W = np.random.default_rng(3).standard_normal((B, N))
CLASSES = ("qp", "box_qp", "signed_box_qp")
BASE = {
    # benchmarks/run_benchmarks.py config 10 (QP) and config 9 (box classes)
    "qp": dq.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0,
                                 rho_update_period=24, power_iters=10),
    "box_qp": dq.QP_DEFAULTS.replace(eps=1e-7, max_iter=2000),
    "signed_box_qp": dq.QP_DEFAULTS.replace(eps=1e-7, max_iter=2000),
}
CASES = {
    f"{cls}_{tag}": (cls, dtype, eq)
    for cls in CLASSES
    for tag, dtype, eq in (("f32", np.float32, False), ("f64", np.float64, False),
                           ("f64_equilibrate", np.float64, True))
}


def _port_cfg(cfg):
    return dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))


def _cfg(cls, dtype, equilibrate=False):
    if dtype == np.float32:
        return BASE[cls].replace(backend="pallas", equilibrate=equilibrate)
    return BASE[cls].replace(backend="xla", eps=1e-10, max_iter=5000, equilibrate=equilibrate)


@pytest.fixture(scope="module")
def problems():
    """(P, q, l_min, l_max, v) in float32, from one seed."""
    rng = np.random.default_rng(9)
    S = rng.standard_normal((B, N, N)) / np.sqrt(N)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(N)
    q = rng.standard_normal((B, N))
    lo = -(rng.random((B, N)) * 0.9 + 0.1)
    hi = rng.random((B, N)) * 0.9 + 0.1
    v = rng.standard_normal((B, N))
    v[:, 2] = 0.0
    return tuple(x.astype(np.float32) for x in (P, q, lo, hi, v))


def _args(cls, probs):
    """The differentiable inputs of the class, then its other inputs."""
    P, q, lo, hi, v = probs
    return {"qp": ((P, q), ()), "box_qp": ((P, q, lo, hi), ()),
            "signed_box_qp": ((P, q, lo, hi), (v,))}[cls]


def _jax_grads(cls, probs, cfg):
    diff, rest = _args(cls, probs)
    solve = getattr(dq, f"solve_{cls}")
    w = jnp.asarray(W.astype(probs[0].dtype))

    def loss(*a):
        l = solve(*a, *map(jnp.asarray, rest), config=cfg)
        return jnp.sum(l * l) + jnp.sum(w * l)

    g = jax.grad(loss, argnums=tuple(range(len(diff))))(*map(jnp.asarray, diff))
    return [np.asarray(x) for x in g]


def _port_grads(cls, probs, cfg):
    diff, rest = _args(cls, probs)
    xs = [torch.from_numpy(x.copy()).requires_grad_() for x in diff]
    solve = getattr(dqt, f"solve_{cls}")
    l = solve(*xs, *(torch.from_numpy(x) for x in rest), config=_port_cfg(cfg), device="cpu")
    loss = (l * l).sum() + (torch.from_numpy(W).to(l.dtype) * l).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, xs)]


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def grads(request, problems):
    cls, dtype, eq = CASES[request.param]
    probs = tuple(x.astype(dtype) for x in problems)
    cfg = _cfg(cls, dtype, eq)
    return dtype, _jax_grads(cls, probs, cfg), _port_grads(cls, probs, cfg.replace(backend="auto"))


def test_gradients_match_jax(grads):
    dtype, gj, gt = grads
    rel = 5e-4 if dtype == np.float32 else 1e-8
    assert len(gj) == len(gt)
    for i, (a, b) in enumerate(zip(gj, gt)):
        assert b.dtype == dtype and b.shape == a.shape, i
        np.testing.assert_allclose(b, a, atol=rel * max(1.0, float(np.abs(a).max())), rtol=0,
                                   err_msg=f"gradient {i}")
        assert np.abs(a).max() > 1e-3, i        # every gradient is substantive


@pytest.fixture(scope="module")
def solved64(problems):
    """float64 problems and their JAX solutions (generic path, eps=1e-10)."""
    P, q, lo, hi, v = (x.astype(np.float64) for x in problems)
    sols = {}
    for cls in CLASSES:
        diff, rest = _args(cls, (P, q, lo, hi, v))
        solve = getattr(dq, f"solve_{cls}")
        sols[cls] = np.asarray(solve(*map(jnp.asarray, diff + rest), config=_cfg(cls, np.float64)))
    return (P, q, lo, hi, v), sols


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("act_floor", [100.0, 0.0], ids=["scale_aware", "absolute"])
def test_recover_duals_match_jax_f64(solved64, cls, act_floor):
    probs, sols = solved64
    diff, rest = _args(cls, probs)
    args = diff + rest + (sols[cls],)
    cfg = _cfg(cls, np.float64)
    name = f"recover_{cls}_duals"
    gj = getattr(dq, name)(*map(jnp.asarray, args), config=cfg, act_floor=act_floor)
    gt = getattr(dqt, name)(*args, config=_port_cfg(cfg), act_floor=act_floor, device="cpu")
    gj = (gj,) if cls == "qp" else tuple(gj)
    gt = (gt,) if cls == "qp" else tuple(gt)
    assert any((np.asarray(x) > 1e-6).any() for x in gj)
    for a, b in zip(gt, gj):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9, rtol=0)


@pytest.mark.parametrize("cls", CLASSES)
def test_derivatives_match_jax_f64(solved64, cls):
    """Through the port's *_vjp (the generic route in float64) against the JAX generic
    path."""
    probs, sols = solved64
    diff, rest = _args(cls, probs)
    g = 2.0 * sols[cls] + W
    args = diff + rest + (sols[cls], g)
    cfg = _cfg(cls, np.float64)
    name = f"{cls}_derivatives"
    rj = getattr(dq, name)(*map(jnp.asarray, args), config=cfg)
    rt = getattr(dqt, name)(*args, config=_port_cfg(cfg), device="cpu")
    if cls == "qp":
        rj, rt = {"dl": rj}, {"dl": rt}
    else:
        assert type(rt).__name__ == type(rj).__name__
        rj, rt = rj._asdict(), rt._asdict()
    assert rt.keys() == rj.keys()
    for k in rt:
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), atol=1e-9, rtol=0, err_msg=k)


@pytest.fixture
def cpu_backends():
    jta.set_backend("cpu")
    tta.set_backend("cpu")
    yield
    jta.set_backend(None)
    tta.set_backend("cuda")


FN2 = {"qp": "QPFn2", "box_qp": "BoxQPFn2", "signed_box_qp": "SignedBoxQPFn2"}


@pytest.mark.parametrize("cls", CLASSES)
def test_fn2_matches_jax_binding_f64(problems, cpu_backends, cls):
    """The port's binding against the JAX package's on the same float64 torch
    tensors in the reference's (B, N, 1) layout: atol 1e-7 on l and the
    gradients (both stop at eps=1e-10 by different linear solves)."""
    diff, rest = _args(cls, tuple(torch.from_numpy(x[:4].astype(np.float64)) for x in problems))
    diff = (diff[0],) + tuple(x[:, :, None] for x in diff[1:])
    rest = tuple(x[:, :, None] for x in rest)
    w = torch.from_numpy(W[:4])[:, :, None]
    outs = []
    for mod in (jta, tta):
        xs = [x.clone().requires_grad_() for x in diff]
        l = getattr(mod, FN2[cls]).apply(*xs, *rest, torch.zeros_like(diff[1]), 1e-10, 5000)
        outs.append((l, torch.autograd.grad((l * l).sum() + (w * l).sum(), xs)))
    (lj, gj), (lt, gt) = outs
    assert lt.shape == diff[1].shape and lt.dtype == torch.float64
    torch.testing.assert_close(lt, lj, atol=1e-7, rtol=0)
    for i, (a, b) in enumerate(zip(gt, gj)):
        assert a.shape == b.shape, i
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0, msg=f"gradient {i}")


def test_warm_start_and_v_get_zero_gradients(problems):
    P, q, lo, hi, v = (torch.from_numpy(x) for x in problems)
    cfg = _port_cfg(BASE["signed_box_qp"])
    ws, vv = torch.zeros_like(q).requires_grad_(), v.clone().requires_grad_()
    l = dqt.solve_signed_box_qp(P, q, lo, hi, vv, ws, config=cfg, device="cpu")
    gw, gv = torch.autograd.grad((l * l).sum(), (ws, vv))
    assert torch.equal(gw, torch.zeros_like(q)) and torch.equal(gv, torch.zeros_like(v))
    ws = torch.zeros_like(q).requires_grad_()
    l = dqt.solve_qp(P, q, ws, config=_port_cfg(BASE["qp"]), device="cpu")
    (gw,) = torch.autograd.grad((l * l).sum(), ws)
    assert torch.equal(gw, torch.zeros_like(q))


def _solve_args(cls, problems, P=None):
    diff, rest = _args(cls, tuple(torch.from_numpy(x) for x in problems))
    return ((diff[0] if P is None else P),) + diff[1:] + rest


@pytest.mark.parametrize("cls", CLASSES)
def test_diagonal_P_raises(problems, cls):
    """A diagonal P is solved by the eager engine; only the kernel path,
    backend='pallas', refuses it (K1 takes dense P, as the JAX kernel path)."""
    P_diag = torch.from_numpy(np.ascontiguousarray(np.diagonal(problems[0], axis1=1, axis2=2)))
    solve = getattr(dqt, f"solve_{cls}")
    with pytest.raises(ValueError, match=r"P must be \(B, n, n\)"):
        solve(*_solve_args(cls, problems, P_diag),
              config=_port_cfg(BASE[cls].replace(backend="pallas")), device="cpu")
    l = solve(*_solve_args(cls, problems, P_diag), device="cpu")
    assert l.shape == (B, N) and bool(torch.isfinite(l).all())


@pytest.mark.parametrize("cls", CLASSES)
def test_double_backward_raises(problems, cls):
    args = [x.clone().requires_grad_() for x in _solve_args(cls, problems)]
    l, st = getattr(dqt, f"solve_{cls}_with_stats")(*args, config=_port_cfg(BASE[cls]),
                                                    device="cpu")
    assert not any(x.requires_grad for x in st) and bool(st.converged.all())
    (gq,) = torch.autograd.grad((l * l).sum(), args[1], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), args[0])


@pytest.mark.parametrize("cls", CLASSES)
def test_default_device_raises_without_cuda(problems, monkeypatch, cls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _solve_args(cls, problems)
    l = args[1]
    calls = [
        lambda: getattr(dqt, f"solve_{cls}")(*args),
        lambda: getattr(dqt, f"recover_{cls}_duals")(*args, l),
        lambda: getattr(dqt, f"{cls}_derivatives")(*args, l, l),
        lambda: getattr(tta, FN2[cls]).apply(*args, torch.zeros_like(l), 1e-7, 400),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
