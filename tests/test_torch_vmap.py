"""The port's solvers under ``torch.func``: ``vmap``, ``grad``, ``vjp``,
``jacrev`` and their nestings, against the JAX package's ``jax.vmap`` /
``jax.grad`` / ``jax.jacrev`` and against the port's own flat calls.

A vmapped solve folds its vmapped groups into the problem batch (the vmap
rules of ``api._Solve``, ``api._SolveAdjoint`` and
``ops.linalg._NSAdaptive``), so it is one call over the flat batch in the
flat batch's order, and its results equal the flat call's bit for bit; so
are ``jacrev``'s, whose n basis cotangents are one adjoint call over n*B
problems, against n ``torch.autograd.grad`` calls.

  * the twins of ``tests/test_vmap.py`` (same seeds, sizes, eps and bars:
    1e-9 for l, 1e-8 for the gradient; float64) and of
    ``tests/test_large_n.py::test_ns_adaptive_vmap_composability``;
  * ``vmap(jacrev(solve))`` over single problems against the port's
    ``*_jacobian`` and ``jax.vmap(jax.jacrev(...))``: in
    ``tests/test_torch_vmap_jacrev.py``, which shares this file's problems;
    ``*_jacobian`` and the ``*Fn2`` bindings under ``vmap``;
  * ``torch.func.grad`` and ``vjp`` equal ``torch.autograd.grad``;
  * the float32 kernel route (K1, then K2 or K4: their plain versions on a
    CPU tensor) at the flagship configuration (bench.py's generator, B=8)
    and configs 9 and 10: the vmapped forward, ``vmap(grad)`` and
    ``vmap(jacrev)`` bit for bit the flat calls and the basis-cotangent
    ``torch.autograd.grad`` calls. No comparison needs a rounding allowance:
    the plain versions round each problem alike at every batch size here.
  * a guard: the plain versions the wrappers call replaced by versions
    that raise on a functorch-wrapped tensor, which a CUDA wrapper could
    not read (``data_ptr``). Every transform passes it, and a backward that
    calls the adjoint without its own Function fails it;
  * forward mode and second derivatives raise;
  * batch-order invariance (the twin of ``tests/test_property.py``'s),
    which is what makes the fold sound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.func import grad, jacrev, jvp, vjp, vmap

import diffqcqp_tpu as dq
from diffqcqp_tpu.ops.linalg import ns_inverse_shifted as jax_ns_inverse_shifted
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch import api, torch_autograd as tta
from diffqcqp_tpu_torch.kernels import admm_cuda, coord_bwd_cuda, qcqp_bwd_cuda
from diffqcqp_tpu_torch.ops.linalg import ns_inverse_shifted
from bench import _build_problems

from .conftest import random_spd

CLASSES = ("qp", "box_qp", "signed_box_qp", "qcqp")


def T(x):
    return torch.tensor(np.asarray(x))


# --------------------------------------------------------------------------
# (a) the twins of tests/test_vmap.py, float64
# --------------------------------------------------------------------------

def test_vmap_over_problem_groups(rng):
    g, b, n = 3, 4, 6
    P = np.stack([random_spd(rng, b, n) for _ in range(g)])   # (G, B, N, N)
    q = rng.standard_normal((g, b, n))

    solve = lambda P, q: dqt.solve_qp(P, q, eps=1e-10, max_iter=3000, device="cpu")  # noqa: E731
    l_vmap = vmap(solve)(T(P), T(q))
    l_flat = solve(T(P.reshape(-1, n, n)), T(q.reshape(-1, n)))
    assert torch.equal(l_vmap.reshape(-1, n), l_flat)

    jsolve = lambda P, q: dq.solve_qp(P, q, eps=1e-10, max_iter=3000)  # noqa: E731
    want = np.array(jax.vmap(jsolve)(jnp.asarray(P), jnp.asarray(q)))
    np.testing.assert_allclose(l_vmap.numpy(), want, rtol=0, atol=1e-9)


def test_grad_under_vmap(rng):
    g, b, n = 2, 3, 5
    P = np.stack([random_spd(rng, b, n) for _ in range(g)])
    q = -np.abs(rng.standard_normal((g, b, n))) - 0.1

    def per_group_loss(P, q):
        return torch.sum(dqt.solve_qp(P, q, eps=1e-11, max_iter=5000, device="cpu") ** 2)

    grads = vmap(grad(per_group_loss, argnums=1))(T(P), T(q))
    qf = T(q.reshape(-1, n)).requires_grad_()
    (flat,) = torch.autograd.grad(per_group_loss(T(P.reshape(-1, n, n)), qf), qf)
    assert torch.equal(grads.reshape(-1, n), flat)

    def jax_loss(P, q):
        return jnp.sum(dq.solve_qp(P, q, eps=1e-11, max_iter=5000) ** 2)

    want = np.array(jax.vmap(jax.grad(jax_loss, argnums=1))(jnp.asarray(P), jnp.asarray(q)))
    np.testing.assert_allclose(grads.numpy(), want, rtol=0, atol=1e-8)


LAYOUTS = {
    # (in_dims, P's layout): the vmapped dim of P first or second, or P
    # shared by every group
    "both_dim0": ((0, 0), lambda P: P),
    "P_dim1": ((1, 0), lambda P: P.transpose(0, 1)),
    "P_unbatched": ((None, 0), lambda P: P[0]),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_vmap_in_dims_stats_and_warm_start(layout):
    """Any in_dims, the stats and a warm start (batched under vmap, as
    ``torch.zeros_like`` of a vmapped q makes it) fold like the flat call."""
    rng = np.random.default_rng(5)
    g, b, n = 2, 3, 6
    P = T(np.stack([random_spd(rng, b, n) for _ in range(g)]))
    q, ws = T(rng.standard_normal((g, b, n))), T(np.abs(rng.standard_normal((g, b, n))))
    in_dims, lay = LAYOUTS[layout]
    if layout == "P_unbatched":
        P = P[:1].expand(g, b, n, n)
    solve = lambda P, q, ws: dqt.solve_qp_with_stats(  # noqa: E731
        P, q, ws, eps=1e-10, max_iter=3000, device="cpu")
    l_v, st_v = vmap(solve, in_dims=in_dims + (0,))(lay(P), q, ws)
    l_f, st_f = solve(P.reshape(-1, n, n), q.reshape(-1, n), ws.reshape(-1, n))
    assert torch.equal(l_v.reshape(-1, n), l_f)
    for name, a, b_ in zip(st_f._fields, st_v, st_f):
        assert a.shape == (g, b) and torch.equal(a.reshape(-1), b_), name


# --------------------------------------------------------------------------
# (b) the twin of tests/test_large_n.py's ns_inverse_shifted under vmap
# --------------------------------------------------------------------------

def test_ns_adaptive_vmap_composability(rng):
    G, b, n = 3, 4, 12
    S = (rng.standard_normal((G, b, n, n)) / np.sqrt(n)).astype(np.float32)
    P = S @ S.transpose(0, 1, 3, 2) + 0.5 * np.eye(n, dtype=np.float32)
    shift = (rng.random((G, b)) + 0.5).astype(np.float32)
    X = vmap(ns_inverse_shifted)(T(P), T(shift))
    M = P.astype(np.float64) + shift.astype(np.float64)[..., None, None] * np.eye(n)
    R = np.eye(n) - np.einsum("gbij,gbjk->gbik", M, X.double().numpy())
    assert float(np.abs(R).max()) < 5e-5
    # the fold runs the flat batch's loop: the same bits, and the JAX
    # inverse (its groups each to their own residual) within the same bar
    assert torch.equal(X.reshape(-1, n, n),
                       ns_inverse_shifted(T(P.reshape(-1, n, n)), T(shift.reshape(-1))))
    want = np.asarray(jax.vmap(jax_ns_inverse_shifted)(jnp.asarray(P), jnp.asarray(shift)))
    assert float(np.abs(X.double().numpy() - want).max() / np.abs(want).max()) < 5e-5

    w = rng.standard_normal((G, b, n, n)).astype(np.float32)

    def loss(P, shift, w):
        return torch.sum(ns_inverse_shifted(P, shift) * w)

    g = vmap(grad(loss))(T(P), T(shift), T(w))
    assert bool(torch.isfinite(g).all()) and g.shape == P.shape


# --------------------------------------------------------------------------
# Problems of (c)-(g), float64 (tests/test_torch_vmap_jacrev.py holds (c):
# vmap(jacrev(solve)) against *_jacobian and jax.vmap(jax.jacrev))
# --------------------------------------------------------------------------

JCFG = {"qp": dq.SolverConfig(eps=1e-11, max_iter=20000, backend="xla")}
JCFG["box_qp"] = JCFG["signed_box_qp"] = JCFG["qp"]
JCFG["qcqp"] = dq.QCQP_DEFAULTS.replace(eps=1e-11, max_iter=20000, backend="xla")
B, N = 4, 6


def _port_cfg(cfg):
    return dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(41)          # test_torch_jacobian.py's problems
    S = rng.standard_normal((B, N, N)) / np.sqrt(N)
    return dict(
        dense=S @ S.transpose(0, 2, 1) + 0.1 * np.eye(N),
        diag=rng.random((B, N)) + 0.3,
        q=rng.standard_normal((B, N)),
        lo=-(rng.random((B, N)) * 0.9 + 0.1),
        hi=rng.random((B, N)) * 0.9 + 0.1,
        v=rng.standard_normal((B, N)),
        l_n=rng.random((B, N // 2)) * 0.5 + 0.05,
        mu=rng.random((B, N // 2)) * 0.5 + 0.05,
    )


def _inputs(pr, cls, kind):
    """(the solve's inputs, the argnums of the differentiable ones)."""
    rest = {"qp": (), "box_qp": (pr["lo"], pr["hi"]),
            "signed_box_qp": (pr["lo"], pr["hi"], pr["v"]), "qcqp": (pr["l_n"], pr["mu"])}[cls]
    xs = (pr[kind], pr["q"]) + rest
    return xs, tuple(range(min(len(xs), 4)))


def test_vmap_of_jacobian_and_fn2(problems, monkeypatch):
    """``*_jacobian`` and the ``*Fn2`` bindings run under ``torch.func.vmap``
    and give the flat calls' results."""
    P, q, lo, hi = (T(problems[k]) for k in ("dense", "q", "lo", "hi"))
    cfg = _port_cfg(JCFG["box_qp"])
    jac = lambda *a: dqt.box_qp_jacobian(*a, config=cfg, include_dP=True, device="cpu")  # noqa: E731
    for field, a, b in zip(dqt.diff.jacobian.BoxJacobian._fields, vmap(jac)(P, q, lo, hi),
                           jac(P, q, lo, hi)):
        assert torch.equal(a, b), field
    monkeypatch.setattr(tta, "_BACKEND", "cpu")
    fn2 = lambda P, q, lo, hi: tta.BoxQPFn2.apply(  # noqa: E731
        P, q, lo, hi, torch.zeros_like(q), 1e-11, 20000)
    got = vmap(fn2)(P[:, None], q[:, None, :, None], lo[:, None], hi[:, None])
    assert torch.equal(got.reshape(B, N), fn2(P, q[..., None], lo, hi).reshape(B, N))


def test_vmap_of_lockstep_raises():
    P = torch.eye(3, dtype=torch.float64).expand(2, 2, 3, 3)
    q = -torch.ones(2, 2, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="lockstep"):
        vmap(lambda P, q: dqt.solve_qp(P, q, axis_name="batch", device="cpu"))(P, q)


# --------------------------------------------------------------------------
# (d) torch.func.grad and vjp equal torch.autograd.grad, float64
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cls", CLASSES)
def test_func_grad_and_vjp_equal_autograd(problems, cls):
    xs, argnums = _inputs(problems, cls, "dense")
    cfg = _port_cfg(JCFG[cls])
    solve = getattr(dqt, f"solve_{cls}")
    w = T(np.random.default_rng(3).standard_normal((B, N)))

    def loss(*a):
        l = solve(*a, config=cfg, device="cpu")
        return (l * l).sum() + (w * l).sum()

    got = grad(loss, argnums=argnums)(*(T(x) for x in xs))
    leaves = [T(x).requires_grad_() for x in xs]
    want = torch.autograd.grad(loss(*leaves), [leaves[i] for i in argnums])
    l, pull = vjp(lambda *a: solve(*a, config=cfg, device="cpu"), *(T(x) for x in xs))
    ct = 2.0 * l + w
    want_vjp = torch.autograd.grad(solve(*leaves, config=cfg, device="cpu"), leaves,
                                   grad_outputs=ct)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    for i, (a, b) in enumerate(zip(pull(ct), want_vjp)):
        assert torch.equal(a, b), i


# --------------------------------------------------------------------------
# (e) the float32 kernel route: bit for bit the flat and basis calls
# --------------------------------------------------------------------------

FLAGSHIP_CFG = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0,
                                         power_iters=10, rho_update_period=24)
CFG10 = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0,
                                rho_update_period=24, power_iters=10)
CFG9 = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=2000)
G32, B32 = 2, 4            # vmapped groups x batch: 8 problems


def _f32_case(cls):
    """(solve, inputs (float32, 8 problems), argnums, config) of a class at
    its main-path point: bench.py's generator and the flagship config for
    the QCQP (N=24), config 10's generator and schedule for the QP, config
    9's for the box kinds (run_benchmarks.py's ``_spd``, then q ~ N(0, 1)
    and the bounds)."""
    b = G32 * B32
    if cls == "qcqp":
        xs = tuple(np.asarray(x, np.float32) for x in _build_problems(b, 12, np.float32))
        return dqt.solve_qcqp, xs, (0, 1, 2, 3), FLAGSHIP_CFG
    rng = np.random.default_rng(10 if cls == "qp" else 9)
    s = rng.standard_normal((b, 24, 24)).astype(np.float32) / np.float32(np.sqrt(24))
    P = (s @ s.transpose(0, 2, 1) + 0.1 * np.eye(24, dtype=np.float32)).astype(np.float32)
    q = rng.standard_normal((b, 24)).astype(np.float32)
    if cls == "qp":
        return dqt.solve_qp, (P, q), (0, 1), CFG10
    lo = -(rng.random((b, 24)) * 0.9 + 0.1).astype(np.float32)
    hi = (rng.random((b, 24)) * 0.9 + 0.1).astype(np.float32)
    v = rng.standard_normal((b, 24)).astype(np.float32)
    xs = (P, q, lo, hi) + ((v,) if cls == "signed_box_qp" else ())
    return getattr(dqt, f"solve_{cls}"), xs, (0, 1, 2, 3), CFG9


def _grouped(x):
    return x.reshape(G32, B32, *x.shape[1:])


def _check_kernel_route(cls, transform):
    """One transform of the class's float32 solve against its flat twin,
    bit for bit; the inputs go through K1 and K2 / K4's plain versions."""
    solve, xs, argnums, cfg = _f32_case(cls)
    assert api._use_kernel(T(xs[0]), T(xs[1]), cfg)
    f = lambda *a: solve(*a, config=cfg, device="cpu")  # noqa: E731
    xs = [T(x) for x in xs]
    w = T(np.random.default_rng(3).standard_normal(xs[1].shape).astype(np.float32))
    if transform == "vmap":
        assert torch.equal(vmap(f)(*map(_grouped, xs)).reshape(xs[1].shape), f(*xs))
        return
    leaves = [x.clone().requires_grad_() for x in xs]
    l = f(*leaves)
    if transform in ("grad", "vmap_grad"):
        def loss(*a):
            *a, w_ = a
            l_ = f(*a)
            return (l_ * l_).sum() + (w_ * l_).sum()

        want = torch.autograd.grad((l * l).sum() + (w * l).sum(), [leaves[i] for i in argnums])
        if transform == "grad":
            got = grad(loss, argnums=argnums)(*xs, w)
        else:
            got = vmap(grad(loss, argnums=argnums))(*map(_grouped, xs + [w]))
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a.reshape(b.shape), b), i
        return
    # vmap(jacrev) over single problems against n basis-cotangent calls
    got = vmap(jacrev(f, argnums=argnums))(*xs)
    rows = []
    for i in range(l.shape[-1]):
        e = torch.zeros_like(l)
        e[:, i] = 1.0
        rows.append(torch.autograd.grad(l, [leaves[j] for j in argnums], grad_outputs=e,
                                        retain_graph=True))
    for k, a in enumerate(got):
        assert torch.equal(a, torch.stack([r[k] for r in rows], dim=1)), k


# --------------------------------------------------------------------------
# (f) no kernel wrapper ever receives a functorch-wrapped tensor
# --------------------------------------------------------------------------

def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (tuple, list)):
            yield from _tensors(a)


@pytest.fixture
def guarded(monkeypatch):
    """Replace the plain versions the wrappers call on a CPU tensor by ones
    that raise on a functorch-wrapped tensor: a CUDA wrapper reads its
    tensors' storage (``data_ptr``), which a wrapped tensor has not. Yields
    the count of calls each saw."""
    calls = {}
    for mod, name in ((admm_cuda, "admm_solve_plain"),
                      (qcqp_bwd_cuda, "qcqp_kkt_bwd_fused_plain"),
                      (coord_bwd_cuda, "coord_kkt_bwd_fused_plain")):
        def check(*args, _fn=getattr(mod, name), _name=name, **kw):
            if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in _tensors(args)):
                raise RuntimeError(f"{_name} received a functorch-wrapped tensor")
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, check)
    yield calls


TRANSFORMS = ("vmap", "grad", "vmap_grad", "vmap_jacrev")
ROUTE_CASES = [(cls, t) for cls in CLASSES for t in TRANSFORMS]


@pytest.mark.parametrize("cls,transform", ROUTE_CASES, ids=["-".join(c) for c in ROUTE_CASES])
def test_kernel_route_bit_for_bit(guarded, cls, transform):
    """(e) under (f)'s guard: bit for bit the flat calls, and K1's and K2's /
    K4's plain versions called with plain tensors only."""
    _check_kernel_route(cls, transform)
    bwd = "qcqp_kkt_bwd_fused_plain" if cls == "qcqp" else "coord_kkt_bwd_fused_plain"
    assert guarded.get("admm_solve_plain", 0) >= 1, guarded
    assert transform == "vmap" or guarded.get(bwd, 0) >= 1, guarded


@pytest.mark.parametrize("transform", TRANSFORMS[1:])
def test_guard_catches_a_backward_without_its_own_function(guarded, monkeypatch, transform):
    """The repair this guard is for: a backward that runs the adjoint
    itself hands the kernel's wrapper functorch-wrapped tensors under
    ``torch.func``, which on the card fails in ``data_ptr``."""
    def backward(ctx, g, *_):
        *xs, l = ctx.saved_tensors
        grads = api._CLASSES[ctx.kind][1](*xs, l, g, ctx.cfg)
        return (None, None, *grads, None)

    monkeypatch.setattr(api._Solve, "backward", staticmethod(backward))
    with pytest.raises(RuntimeError, match="functorch-wrapped"):
        _check_kernel_route("qcqp", transform)


# --------------------------------------------------------------------------
# (g) forward mode and second derivatives raise
# --------------------------------------------------------------------------

def test_jvp_raises(problems):
    P, q = T(problems["dense"]), T(problems["q"])
    with pytest.raises(NotImplementedError, match="jvp"):
        jvp(lambda q: dqt.solve_qp(P, q, device="cpu"), (q,), (torch.ones_like(q),))


@pytest.mark.parametrize("cls", ("qp", "qcqp"))
def test_second_derivative_raises(problems, cls):
    xs, _ = _inputs(problems, cls, "dense")
    solve = getattr(dqt, f"solve_{cls}")
    cfg = _port_cfg(JCFG[cls])
    loss = lambda *a: (solve(*a, config=cfg, device="cpu") ** 2).sum()  # noqa: E731
    xs = [T(x) for x in xs]
    with pytest.raises(RuntimeError, match="differentiate twice"):
        grad(lambda q: grad(loss, argnums=1)(xs[0], q, *xs[2:]).sum())(xs[1])
    leaves = [x.clone().requires_grad_() for x in xs]
    (gq,) = torch.autograd.grad(loss(*leaves), [leaves[1]], create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        torch.autograd.grad(gq.sum(), [leaves[1]])


# --------------------------------------------------------------------------
# (h) the twin of tests/test_property.py's batch-order invariance
# --------------------------------------------------------------------------

PROP_CFG = dqt.SolverConfig(eps=1e-10, max_iter=20000)


def _property_problem(seed, b, n, scale_pow):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((b, n, n))
    scales = np.exp(rng.uniform(-scale_pow, scale_pow, (b, 1, 1)))
    P = (S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)) * scales
    q = rng.standard_normal((b, n)) * scales[:, :, 0]
    return T(P), T(q)


@settings(deadline=None, max_examples=15, derandomize=True)
@given(seed=st.integers(0, 2**20))
def test_batch_order_invariance(seed):
    b, n = 6, 6
    P, q = _property_problem(seed, b, n, 1.0)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(b))
    l = dqt.solve_qp(P, q, config=PROP_CFG, device="cpu")
    l_perm = dqt.solve_qp(P[perm], q[perm], config=PROP_CFG, device="cpu")
    np.testing.assert_allclose(l_perm.numpy(), l[perm].numpy(), rtol=0, atol=1e-12)
