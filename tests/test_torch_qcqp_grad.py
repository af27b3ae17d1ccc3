"""The slice end to end: gradients through the port's ``solve_qcqp`` (in
float32 K1 forward and K2 backward, their plain versions on the CPU; in
float64 the eager engine and the generic adjoint) against
``jax.value_and_grad`` through the JAX package's ``solve_qcqp``.

Problems: bench.py's generator and configuration at B=16, N=24. Losses:
bench.py's sum(l^2), and sum(l^2) + <w, l> with a fixed random w. At this
point every contact binds (||l_c|| = r_c), so sum(l^2) = sum r^2 is flat in
P and q: their gradients are zero up to rounding on both sides and only the
second loss holds them to a substantive value.

Bars: float32 against the JAX kernel path (backend="pallas", K1 and K2 in
interpret mode): atol 2e-4 * max(1, max|grad|), K2's dgamma bar in the JAX
suite (measured ~6e-5 on l_n). float64 against the JAX generic path
(backend="xla", eps=1e-10): atol 1e-8 * max(1, max|grad|); both sides run
the same float64 engine and generic route.
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
from bench import _build_problems

B, NC = 16, 12
BENCH_CFG = dq.QCQP_DEFAULTS.replace(
    eps=1e-7, max_iter=400, rho0_scale=2.0, power_iters=10, rho_update_period=24,
)
W = np.random.default_rng(3).standard_normal((B, 2 * NC))
NAMES = ("P", "q", "l_n", "mu")
CASES = {
    "f32_sum_sq": (np.float32, "sum_sq", False),
    "f32_linear": (np.float32, "linear", False),
    "f32_linear_equilibrate": (np.float32, "linear", True),
    "f64_sum_sq": (np.float64, "sum_sq", False),
    "f64_linear": (np.float64, "linear", False),
    "f64_linear_equilibrate": (np.float64, "linear", True),
}


def _port_cfg(cfg):
    return dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))


def _cfg(dtype, equilibrate):
    if dtype == np.float32:
        return BENCH_CFG.replace(backend="pallas", equilibrate=equilibrate)
    return BENCH_CFG.replace(backend="xla", eps=1e-10, max_iter=2000, equilibrate=equilibrate)


@pytest.fixture(scope="module")
def problems():
    return tuple(x.astype(np.float32) for x in _build_problems(B, NC, np.float32, seed=0))


def _jax_grads(probs, cfg, loss_kind):
    w = jnp.asarray(W.astype(probs[0].dtype))

    def loss(*a):
        l = dq.solve_qcqp(*a, config=cfg)
        return jnp.sum(l * l) + (jnp.sum(w * l) if loss_kind == "linear" else 0.0)

    v, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, probs))
    return float(v), [np.asarray(x) for x in g]


def _port_grads(probs, cfg, loss_kind, device="cpu"):
    args = [torch.from_numpy(x.copy()).requires_grad_() for x in probs]
    l = dqt.solve_qcqp(*args, config=_port_cfg(cfg), device=device)
    v = (l * l).sum()
    if loss_kind == "linear":
        v = v + (torch.from_numpy(W).to(l.dtype) * l).sum()
    return float(v), [g.numpy() for g in torch.autograd.grad(v, args)]


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def grads(request, problems):
    dtype, loss_kind, eq = CASES[request.param]
    probs = tuple(x.astype(dtype) for x in problems)
    cfg = _cfg(dtype, eq)
    return dtype, loss_kind, _jax_grads(probs, cfg, loss_kind), _port_grads(
        probs, cfg.replace(backend="auto"), loss_kind)


def test_gradients_match_jax(grads):
    dtype, loss_kind, (vj, gj), (vt, gt) = grads
    rel = 2e-4 if dtype == np.float32 else 1e-8
    assert vt == pytest.approx(vj, rel=rel)
    for name, a, b in zip(NAMES, gj, gt):
        assert b.dtype == dtype and b.shape == a.shape, name
        atol = rel * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=name)
    # both packages see sum(l^2) flat in (P, q) and not in the radii here
    floor = 1e-5 if dtype == np.float32 else 1e-12
    for g in (gj, gt):
        assert (max(np.abs(g[0]).max(), np.abs(g[1]).max()) < floor) == (loss_kind == "sum_sq")
        assert np.abs(g[2]).max() > 0.1 and np.abs(g[3]).max() > 0.1


@pytest.mark.parametrize("layout", ["unbatched", "column", "shared_P"])
def test_layouts_carry_gradients(problems, layout):
    """Unbatched, (B, N, 1) column and (N, N) shared-P inputs get the
    batched path's gradients in their own layout (atol 1e-6, float64)."""
    P, q, l_n, mu = (x.astype(np.float64) for x in problems)
    cfg = _port_cfg(_cfg(np.float64, False).replace(backend="auto"))
    if layout == "shared_P":
        P = np.broadcast_to(P[0], P.shape).copy()
    base = [torch.from_numpy(x.copy()).requires_grad_() for x in (P, q, l_n, mu)]
    w = torch.from_numpy(W)
    l = dqt.solve_qcqp(*base, config=cfg, device="cpu")
    ref = torch.autograd.grad((l * l).sum() + (w * l).sum(), base)
    if layout == "unbatched":
        args = [torch.from_numpy(x[3].copy()).requires_grad_() for x in (P, q, l_n, mu)]
        l = dqt.solve_qcqp(*args, config=cfg, device="cpu")
        loss, want = (l * l).sum() + (w[3] * l).sum(), [g[3] for g in ref]
    elif layout == "column":
        args = [base[0].detach().clone().requires_grad_()] + [
            torch.from_numpy(x[:, :, None].copy()).requires_grad_() for x in (q, l_n, mu)]
        l = dqt.solve_qcqp(*args, config=cfg, device="cpu")
        assert l.shape == (B, 2 * NC, 1)
        loss, want = (l * l).sum() + (w[:, :, None] * l).sum(), [ref[0]] + [
            g[:, :, None] for g in ref[1:]]
    else:
        args = [torch.from_numpy(P[0].copy()).requires_grad_()] + [
            x.detach().clone().requires_grad_() for x in base[1:]]
        l = dqt.solve_qcqp(*args, config=cfg, device="cpu")
        loss, want = (l * l).sum() + (w * l).sum(), [ref[0].sum(0)] + list(ref[1:])
    got = torch.autograd.grad(loss, args)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)


def test_warm_start_gets_a_zero_gradient(problems):
    P, q, l_n, mu = (torch.from_numpy(x) for x in problems)
    ws = torch.zeros_like(q).requires_grad_()
    l = dqt.solve_qcqp(P, q, l_n, mu, ws, config=_port_cfg(BENCH_CFG), device="cpu")
    (g,) = torch.autograd.grad((l * l).sum(), ws)
    assert torch.equal(g, torch.zeros_like(q))


def test_double_backward_raises(problems):
    args = [torch.from_numpy(x.copy()).requires_grad_() for x in problems]
    l, st = dqt.solve_qcqp_with_stats(*args, config=_port_cfg(BENCH_CFG), device="cpu")
    assert not any(x.requires_grad for x in st)
    (gq,) = torch.autograd.grad((l * l).sum(), args[1], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), args[2])


@pytest.mark.parametrize("act_floor", [100.0, 0.0], ids=["scale_aware", "absolute"])
def test_recover_qcqp_duals_matches_jax_f64(problems, act_floor):
    P, q, l_n, mu = (x.astype(np.float64) for x in problems)
    cfg = _cfg(np.float64, False)
    l = np.asarray(dq.solve_qcqp(*map(jnp.asarray, (P, q, l_n, mu)), config=cfg))
    gj = np.asarray(dq.recover_qcqp_duals(*map(jnp.asarray, (P, q, l_n, mu, l)),
                                          config=cfg, act_floor=act_floor))
    gt = dqt.recover_qcqp_duals(P, q, l_n, mu, l, config=_port_cfg(cfg),
                                act_floor=act_floor, device="cpu")
    assert gt.dtype == torch.float64 and (gj > 0).all()
    np.testing.assert_allclose(gt.numpy(), gj, atol=1e-12, rtol=1e-12)


def test_qcqp_derivatives_match_jax_f64(problems):
    """Through the port's qcqp_vjp (float64 takes the generic route: the
    recovered duals and the assembled system) against the JAX generic path:
    atol 1e-9, as K2's float64 parity in test_torch_kkt.py."""
    P, q, l_n, mu = (x.astype(np.float64) for x in problems)
    cfg = _cfg(np.float64, False)
    l = np.asarray(dq.solve_qcqp(*map(jnp.asarray, (P, q, l_n, mu)), config=cfg))
    g = 2.0 * l + W
    rj = dq.qcqp_derivatives(*map(jnp.asarray, (P, q, l_n, mu, l, g)), config=cfg)
    rt = dqt.qcqp_derivatives(P, q, l_n, mu, l, g, config=_port_cfg(cfg), device="cpu")
    assert isinstance(rt, dqt.QCQPDerivatives)
    for name in rt._fields:
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   atol=1e-9, rtol=0, err_msg=name)


def test_duals_default_device_raises_without_cuda(problems, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P, q, l_n, mu = problems
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dqt.recover_qcqp_duals(P, q, l_n, mu, q)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dqt.qcqp_derivatives(P, q, l_n, mu, q, q)


@pytest.fixture
def cpu_backends():
    jta.set_backend("cpu")
    tta.set_backend("cpu")
    yield
    jta.set_backend(None)
    tta.set_backend("cuda")


@pytest.mark.parametrize("column", [True, False], ids=["B_N_1", "B_N"])
def test_qcqpfn2_matches_jax_binding_f64(problems, cpu_backends, column):
    """The port's QCQPFn2 against the JAX package's on the same float64 torch
    tensors (its XLA engine on the CPU): atol 1e-7 on l and the gradients
    (both stop at eps=1e-10 by different linear solves; measured ~1e-10)."""
    P, q, l_n, mu = (torch.from_numpy(x[:4].astype(np.float64)) for x in problems)
    if column:
        q, l_n, mu = q[:, :, None], l_n[:, :, None], mu[:, :, None]
    w = torch.from_numpy(W[:4]).reshape(q.shape)
    outs = []
    for mod in (jta, tta):
        args = [x.clone().requires_grad_() for x in (P, q, l_n, mu)]
        l = mod.QCQPFn2.apply(*args, torch.zeros_like(q), 1e-10, 2000)
        outs.append((l, torch.autograd.grad((l * l).sum() + (w * l).sum(), args)))
    (lj, gj), (lt, gt) = outs
    assert lt.shape == q.shape and lt.dtype == torch.float64
    torch.testing.assert_close(lt, lj, atol=1e-7, rtol=0)
    for name, a, b in zip(NAMES, gt, gj):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0, msg=name)


def test_qcqpfn2_default_backend_raises_without_cuda(problems, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P, q, l_n, mu = (torch.from_numpy(x) for x in problems)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tta.QCQPFn2.apply(P, q, l_n, mu, torch.zeros_like(q), 1e-7, 400)
    with pytest.raises(ValueError):
        tta.set_backend("tpu")
