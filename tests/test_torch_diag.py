"""Diagonal P end to end in the port: the four classes' solves and gradients
with a (B, N) P, against ``jax.grad`` through the JAX package's
(``backend="xla"``, float64) and against the port's own dense path on
diag_embed(P); the raw derivatives and dual recovery on a diagonal P, with
the duals recovered by the adjoint and with the duals given.

Problems: B=8, N=8 (QCQP: 4 contacts), P_ii ~ U(0.3, 1.3), q ~ N(0, 1), the
box rows' bounds as tests/test_diag_backward.py draws them, v with a zero
entry. Loss: sum(l^2) + <w, l> with a fixed random w.

Bars: against JAX, atol 1e-8 * max(1, max|grad|) (tests/test_diag_backward.py
uses atol 1e-8); against the port's dense path atol 1e-8, 1e-7 for the QCQP
(the JAX suite's own diagonal-vs-dense bars); raw derivatives and duals
atol 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
from diffqcqp_tpu.diff import kkt as jkkt
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.diff import kkt as tkkt
from diffqcqp_tpu_torch.kernels import admm_cuda, coord_bwd_cuda, qcqp_bwd_cuda, qr_solve_cuda

B, N = 8, 8
CLASSES = ("qp", "box_qp", "signed_box_qp", "qcqp")
CFG = {
    "qp": dq.SolverConfig(eps=1e-10, max_iter=5000, backend="xla"),
    "box_qp": dq.SolverConfig(eps=1e-10, max_iter=5000, backend="xla"),
    "signed_box_qp": dq.SolverConfig(eps=1e-10, max_iter=5000, backend="xla"),
    "qcqp": dq.QCQP_DEFAULTS.replace(eps=1e-10, max_iter=20000, backend="xla"),
}
W = np.random.default_rng(3).standard_normal((B, N))


def _port_cfg(cfg):
    return dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def problems():
    """(Pd, q, lo, hi, v, l_n, mu) in float64, from one seed."""
    rng = np.random.default_rng(21)
    Pd = rng.random((B, N)) + 0.3
    q = rng.standard_normal((B, N))
    lo = -(rng.random((B, N)) * 0.4 + 0.05)
    hi = rng.random((B, N)) * 0.4 + 0.05
    v = rng.standard_normal((B, N))
    v[:, 3] = 0.0
    l_n = rng.random((B, N // 2)) * 0.5 + 0.05
    mu = rng.random((B, N // 2)) * 0.5 + 0.05
    return Pd, q, lo, hi, v, l_n, mu


def _args(cls, probs, P=None):
    """(differentiable inputs, other inputs) of the class."""
    Pd, q, lo, hi, v, l_n, mu = probs
    P = Pd if P is None else P
    return {"qp": ((P, q), ()), "box_qp": ((P, q, lo, hi), ()),
            "signed_box_qp": ((P, q, lo, hi), (v,)), "qcqp": ((P, q, l_n, mu), ())}[cls]


def _jax_grads(cls, probs):
    diff, rest = _args(cls, probs)
    fn = getattr(dq, f"solve_{cls}")

    def loss(*xs):
        l = fn(*xs, *rest, config=CFG[cls])
        return jnp.sum(l * l) + jnp.sum(jnp.asarray(W) * l)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(diff))))(
        *(jnp.asarray(x) for x in diff))]


def _port_grads(cls, probs, P=None):
    diff, rest = _args(cls, probs, P)
    leaves = [torch.tensor(x).requires_grad_() for x in diff]
    l = getattr(dqt, f"solve_{cls}")(*leaves, *(torch.tensor(x) for x in rest),
                                     config=_port_cfg(CFG[cls]), device="cpu")
    return [g.numpy() for g in torch.autograd.grad(
        (l * l).sum() + (torch.tensor(W) * l).sum(), leaves)]


@pytest.mark.parametrize("cls", CLASSES)
def test_diag_grads_match_jax(problems, cls):
    """atol 1e-8 * max(1, max|grad|) against jax.grad, float64."""
    want = _jax_grads(cls, problems)
    got = _port_grads(cls, problems)
    assert got[0].shape == (B, N)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("cls", CLASSES)
def test_diag_grads_match_dense_path(problems, cls):
    """The closed forms against the port's dense path on diag_embed(P):
    grad P's diagonal and the other gradients, atol 1e-8 (QCQP 1e-7)."""
    Pdense = np.stack([np.diag(p) for p in problems[0]])
    got = _port_grads(cls, problems)
    dense = _port_grads(cls, problems, Pdense)
    atol = 1e-7 if cls == "qcqp" else 1e-8
    np.testing.assert_allclose(got[0], np.diagonal(dense[0], axis1=1, axis2=2), atol=atol)
    for a, b in zip(got[1:], dense[1:]):
        np.testing.assert_allclose(a, b, atol=atol)


@pytest.mark.parametrize("cls", CLASSES)
def test_diag_launches_no_kernel(problems, cls, monkeypatch):
    """A diagonal P takes the eager engine and the closed form: no kernel
    wrapper is called, and which_backend names 'xla'."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on a diagonal P")

    for mod, name in ((admm_cuda, "admm_solve_cuda"), (coord_bwd_cuda, "coord_kkt_bwd_fused_cuda"),
                      (qcqp_bwd_cuda, "qcqp_kkt_bwd_fused_cuda"),
                      (qcqp_bwd_cuda, "qcqp_kkt_bwd_cuda"), (qr_solve_cuda, "qr_solve_cuda")):
        monkeypatch.setattr(mod, name, refuse)
    from diffqcqp_tpu_torch import api
    monkeypatch.setattr(api, "admm_solve_cuda", refuse)
    for name in ("coord_kkt_bwd_fused_cuda", "qcqp_kkt_bwd_fused_cuda", "qcqp_kkt_bwd_cuda",
                 "qr_solve_cuda"):
        monkeypatch.setattr(tkkt, name, refuse)
    f32 = tuple(x.astype(np.float32) for x in problems)
    assert dqt.which_backend(f32[0], f32[1]) == "xla"
    cfg = _port_cfg(CFG[cls].replace(eps=1e-6, backend="auto"))
    diff, rest = _args(cls, f32)
    leaves = [torch.tensor(x).requires_grad_() for x in diff]
    l = getattr(dqt, f"solve_{cls}")(*leaves, *(torch.tensor(x) for x in rest), config=cfg,
                                     device="cpu")
    grads = torch.autograd.grad((l * l).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def _derivs(mod, cls, probs, l, g, cfg):
    """The class's raw derivatives and recovered duals through ``mod`` (dq or
    dqt) as a list of numpy arrays."""
    Pd, q, lo, hi, v, l_n, mu = probs
    kw = {"config": cfg} if mod is dq else {"config": cfg, "device": "cpu"}
    out = {
        "qp": lambda: (mod.qp_derivatives(Pd, q, l, g, **kw),
                       mod.recover_qp_duals(Pd, q, l, **kw)),
        "box_qp": lambda: (mod.box_qp_derivatives(Pd, q, lo, hi, l, g, **kw),
                           mod.recover_box_qp_duals(Pd, q, lo, hi, l, **kw)),
        "signed_box_qp": lambda: (mod.signed_box_qp_derivatives(Pd, q, lo, hi, v, l, g, **kw),
                                  mod.recover_signed_box_qp_duals(Pd, q, lo, hi, v, l, **kw)),
        "qcqp": lambda: (mod.qcqp_derivatives(Pd, q, l_n, mu, l, g, **kw),
                         mod.recover_qcqp_duals(Pd, q, l_n, mu, l, **kw)),
    }[cls]()
    flat = []
    for x in out:
        flat += list(x) if isinstance(x, tuple) else [x]
    return [np.asarray(x) for x in flat]


@pytest.mark.parametrize("cls", CLASSES)
def test_diag_derivatives_match_jax(problems, cls):
    """``*_derivatives`` and ``recover_*_duals`` on a diagonal P, the same
    float64 solution on both sides: atol 1e-9."""
    diff, rest = _args(cls, problems)
    l = np.asarray(getattr(dq, f"solve_{cls}")(*diff, *rest, config=CFG[cls]))
    g = 2.0 * l + W
    want = _derivs(dq, cls, problems, l, g, CFG[cls])
    got = _derivs(dqt, cls, problems, l, g, _port_cfg(CFG[cls]))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


@pytest.mark.parametrize("cls", ("box_qp", "qcqp"))
def test_diag_vjp_with_duals_given(problems, cls):
    """``box_vjp(duals=)`` / ``qcqp_vjp(duals=)`` on a diagonal P take the
    generic route on the densified P: against the JAX package's same call
    and against the closed form of the recovered duals, atol 1e-9."""
    Pd, q, lo, hi, v, l_n, mu = problems
    diff, rest = _args(cls, problems)
    l = np.asarray(getattr(dq, f"solve_{cls}")(*diff, *rest, config=CFG[cls]))
    g = 2.0 * l + W
    jcfg, tcfg = CFG[cls], _port_cfg(CFG[cls])
    T = lambda *xs: [torch.tensor(x) for x in xs]  # noqa: E731
    J = lambda *xs: [jnp.asarray(x) for x in xs]   # noqa: E731
    if cls == "box_qp":
        jd = jkkt.box_dual(*J(Pd, q, lo, hi, l), jcfg)
        want = jkkt.box_vjp(*J(Pd, q, lo, hi, l, g), jcfg, duals=jd)
        td = tkkt.box_dual(*T(Pd, q, lo, hi, l), tcfg)
        got = tkkt.box_vjp(*T(Pd, q, lo, hi, l, g), tcfg, duals=td)
        closed = tkkt.box_vjp(*T(Pd, q, lo, hi, l, g), tcfg)
    else:
        r = l_n * mu
        jd = jkkt.qcqp_dual(*J(Pd, q, r, l), jcfg)
        want = jkkt.qcqp_vjp(*J(Pd, q, r, l, g), jcfg, duals=jd)
        td = tkkt.qcqp_dual(*T(Pd, q, r, l), tcfg)
        got = tkkt.qcqp_vjp(*T(Pd, q, r, l, g), tcfg, duals=td)
        closed = tkkt.qcqp_vjp(*T(Pd, q, r, l, g), tcfg)
    for a, b, c in zip(got, want, closed):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=1e-9)
