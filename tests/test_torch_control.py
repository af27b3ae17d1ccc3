"""Control flow on the device (``utils/control.py``) and the routes that run
through it, on the CPU:

  * ``while_loop`` and ``cond`` against a plain Python loop and branch: no
    iteration when the first predicate is False, a cap on the iterations,
    a pytree carry with None standing for leaves; a body that returns
    another structure or shape raises;
  * the engine's body reads nothing on the host: ``Tensor.__bool__``,
    ``item``, ``tolist``, ``__int__``, ``__float__`` and ``nonzero`` raise
    inside every ``body_fn`` and ``cond_fn`` (the loop's and ``cond``'s own
    predicate reads, ``control._read``, excepted), for the four classes and
    the engine's modes: spectral, the float32 Newton-Schulz inverse (N >
    48), the float64 Cholesky inverse, a diagonal P, ``accel``, and
    ``rho_sync`` on and off; the guarded solves give the bits of the
    unguarded ones;
  * the engine through ``control.while_loop`` gives the bits of its body
    driven by a plain host loop (what ``admm_solve`` ran before the loop
    moved onto the card), and agrees with the JAX engine on the same numpy
    problems within ``tests/test_torch_engine.py``'s bars;
  * ``ops.linalg._ns_adaptive`` against the JAX package's
    ``newton_schulz_inverse_adaptive`` (float32 and float64, and at an
    iteration cap);
  * ``simulate`` and the contact system-ID step under the host-read guard
    against the JAX package's ``simulate`` and ``make_system_id_step`` at
    B=4, T=6-8.

The capture path (conditional graph nodes) runs on the card only:
``chip_smoke.py`` phase 3o.
"""

import contextlib
import dataclasses
import gc
import threading
import weakref
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
from diffqcqp_tpu.models import contact_sim as jcs
from diffqcqp_tpu.ops import linalg as jlinalg
from diffqcqp_tpu.solvers.admm import admm_solve as j_solve
from diffqcqp_tpu.ops import prox as jp
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.models import contact_sim as tcs
from diffqcqp_tpu_torch.ops import linalg as tlinalg
from diffqcqp_tpu_torch.ops import prox as tp
from diffqcqp_tpu_torch.solvers import admm as tadmm
from diffqcqp_tpu_torch.utils import control

READS = ("__bool__", "item", "tolist", "__int__", "__float__", "nonzero")


class _Guard(threading.local):
    on = False


_guard = _Guard()


@contextlib.contextmanager
def _set(on: bool):
    prev, _guard.on = _guard.on, on
    try:
        yield
    finally:
        _guard.on = prev


def _install_guard(monkeypatch):
    """Every ``body_fn`` and ``cond_fn`` that ``control.while_loop`` runs, and
    both branches of ``control.cond``, run with the host's reads of a tensor
    raising; ``control._read``, the loops' own predicate read, runs
    unguarded."""
    def deny(name, orig):
        def read(*a, **k):
            if _guard.on:
                raise AssertionError(f"a read of the device on the host: Tensor.{name}")
            return orig(*a, **k)
        return read

    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, deny(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", deny("nonzero", torch.nonzero))

    def guarded(fn):
        def run(*a):
            with _set(True):
                return fn(*a)
        return run

    read, loop, branch = control._read, control.while_loop, control.cond

    def unguarded_read(pred):
        with _set(False):
            return read(pred)

    monkeypatch.setattr(control, "_read", unguarded_read)
    monkeypatch.setattr(control, "while_loop",
                        lambda c, b, carry: loop(guarded(c), guarded(b), carry))
    monkeypatch.setattr(control, "cond",
                        lambda p, t, f, ops=(): branch(p, guarded(t), guarded(f), ops))


@pytest.fixture
def no_host_reads(monkeypatch):
    _install_guard(monkeypatch)


# --------------------------------------------------------------------------
# while_loop and cond against plain Python
# --------------------------------------------------------------------------

class Carry(NamedTuple):
    k: torch.Tensor
    x: torch.Tensor
    extra: Optional[torch.Tensor]
    rest: dict


def _plain_while(cond_fn, body_fn, carry):
    while bool(cond_fn(carry)):
        carry = body_fn(carry)
    return carry


def _carry(x0, extra=True):
    return Carry(k=torch.zeros((), dtype=torch.int32), x=torch.tensor(x0, dtype=torch.float64),
                 extra=torch.ones(3) if extra else None, rest={"n": torch.zeros(2, 2)})


def _body(c):
    return Carry(k=c.k + 1, x=c.x * 2.0 + 1.0,
                 extra=None if c.extra is None else c.extra + c.x.float(),
                 rest={"n": c.rest["n"] + 1.0})


LOOPS = {
    "runs to its test": (lambda c: c.x < 100.0, 0.5),
    "no iteration: the first test is False": (lambda c: c.x < 100.0, 500.0),
    "stopped by an iteration cap": (lambda c: (c.k < 3) & (c.x < 1e9), 0.5),
}


@pytest.mark.parametrize("extra", [True, False], ids=["tensor leaf", "None leaf"])
@pytest.mark.parametrize("case", list(LOOPS))
def test_while_loop_is_the_python_loop(case, extra):
    cond_fn, x0 = LOOPS[case]
    got = control.while_loop(cond_fn, _body, _carry(x0, extra))
    want = _plain_while(cond_fn, _body, _carry(x0, extra))
    assert type(got) is Carry and (got.extra is None) is (not extra)
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert int(got.k) == {"runs to its test": 7, "no iteration: the first test is False": 0,
                          "stopped by an iteration cap": 3}[case]


def test_while_loop_reads_its_predicate_once_an_iteration(monkeypatch):
    reads = []
    read = control._read
    monkeypatch.setattr(control, "_read", lambda p: reads.append(1) or read(p))
    out = control.while_loop(lambda c: c.x < 100.0, _body, _carry(0.5))
    assert len(reads) == int(out.k) + 1


@pytest.mark.parametrize("pred", [True, False])
def test_cond_is_the_python_branch(pred):
    a = torch.arange(4.0)
    out = control.cond(torch.tensor(pred), lambda x: {"y": x + 1, "z": (x * 2,)},
                       lambda x: {"y": x - 1, "z": (x,)}, (a,))
    want = {"y": a + 1, "z": (a * 2,)} if pred else {"y": a - 1, "z": (a,)}
    assert torch.equal(out["y"], want["y"]) and torch.equal(out["z"][0], want["z"][0])


def test_predicates_read_on_the_host_only_by_the_loop(no_host_reads):
    """The guard itself: a body that reads the host raises under it; the
    same loop without that read runs."""
    with pytest.raises(AssertionError, match="Tensor.__bool__"):
        control.while_loop(lambda c: c.x < 10.0,
                           lambda c: _body(c) if bool(c.x > 0) else c, _carry(0.5))
    assert int(control.while_loop(lambda c: c.x < 10.0, _body, _carry(0.5)).k) == 3


def test_capture_checks_are_not_taken_on_the_cpu(monkeypatch):
    """Under a capture, CPU tensors still run the Python loop: only CUDA
    tensors record a node."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert control.capturing()
    out = control.while_loop(lambda c: c.x < 100.0, _body, _carry(0.5))
    assert int(out.k) == 7


# --------------------------------------------------------------------------
# The engine's body reads nothing on the host
# --------------------------------------------------------------------------

def _problems(seed, b, n, dtype):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = rng.standard_normal((b, n))
    lo = -(rng.random((b, n)) * 0.5 + 0.2)
    hi = rng.random((b, n)) * 0.5 + 0.2
    v = rng.standard_normal((b, n))
    ln = rng.random((b, n // 2)) * 0.5 + 0.05
    mu = rng.random((b, n // 2)) * 0.5 + 0.05
    return [torch.tensor(x, dtype=dtype) for x in (P, q, lo, hi, v, ln, mu)]


def _step(kind, xs, cfg):
    """l, stats and the gradients of sum(l^2) + sum(l) through the public
    solve of ``kind``."""
    P, q, lo, hi, v, ln, mu = xs
    args = {"qp": (P, q), "box_qp": (P, q, lo, hi), "signed_box_qp": (P, q, lo, hi),
            "qcqp": (P, q, ln, mu)}[kind]
    leaves = [x.clone().requires_grad_() for x in args]
    extra = (v,) if kind == "signed_box_qp" else ()
    base = dqt.QCQP_DEFAULTS if kind == "qcqp" else dqt.QP_DEFAULTS
    l, st = getattr(dqt, f"solve_{kind}_with_stats")(
        *leaves, *extra, config=base.replace(**cfg), device="cpu")
    return l, st, torch.autograd.grad((l * l).sum() + l.sum(), leaves)


MODES = {
    # name: (n, dtype, diagonal P, config)
    "spectral f64": (6, torch.float64, False, {"eps": 1e-10}),
    "spectral f32": (6, torch.float32, False, {"eps": 1e-5, "backend": "xla"}),
    "f32 Newton-Schulz inverse (N > 48)": (50, torch.float32, False,
                                           {"eps": 1e-5, "backend": "xla"}),
    "f64 Cholesky inverse": (50, torch.float64, False, {"eps": 1e-10}),
    "f64 Cholesky inverse, rho_sync off": (50, torch.float64, False,
                                           {"eps": 1e-10, "rho_sync": False}),
    "diagonal P": (6, torch.float32, True, {"eps": 1e-6}),
    "accel": (6, torch.float64, False, {"eps": 1e-9, "accel": True, "adaptive_rho": False,
                                        "alpha_relax": 1.0}),
    "rho_sync off": (6, torch.float64, False, {"eps": 1e-10, "rho_sync": False}),
}
KINDS = ["qp", "box_qp", "signed_box_qp", "qcqp"]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", KINDS)
def test_the_engine_reads_nothing_on_the_host(monkeypatch, kind, mode):
    n, dtype, diag, cfg = MODES[mode]
    xs = _problems(3, 3, n, dtype)
    if diag:
        xs[0] = torch.diagonal(xs[0], dim1=1, dim2=2).contiguous()
    want = _step(kind, xs, cfg)
    loops = []
    loop = control.while_loop
    monkeypatch.setattr(control, "while_loop",
                        lambda c, b, carry: loops.append(1) or loop(c, b, carry))
    with monkeypatch.context() as m:
        _install_guard(m)
        got = _step(kind, xs, cfg)
    assert loops, "the solve did not go through control.while_loop"
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)


def test_the_guard_catches_each_read(no_host_reads):
    x = torch.ones(2)
    reads = [lambda: bool(x[0]), lambda: x[0].item(), lambda: x.tolist(), lambda: int(x[0]),
             lambda: float(x[0]), lambda: x.nonzero(), lambda: torch.nonzero(x)]
    for read in reads:
        with pytest.raises(AssertionError, match="a read of the device on the host"):
            control.while_loop(lambda c: c.x < 10.0, lambda c: read() and c, _carry(0.5))


# --------------------------------------------------------------------------
# Bit for bit the host-driven loop, and the JAX engine
# --------------------------------------------------------------------------

def _prox(mod, kind, args):
    return {"nonneg": mod.prox_nonneg, "box": lambda x: mod.prox_box(x, *args),
            "signed_box": lambda x: mod.prox_signed_box(x, *args),
            "disk": lambda x: mod.prox_disk(x, *args)}[kind]


ENGINE = {
    # name: (n, dtype, config changes)
    "f64 spectral": (8, np.float64, {"eps": 1e-10}),
    "f64 Cholesky inverse": (8, np.float64, {"eps": 1e-10, "linsolve": "chol"}),
    "f32 Newton-Schulz inverse": (8, np.float32, {"eps": 1e-5, "linsolve": "chol"}),
    "f64 spectral, rho_sync off": (8, np.float64, {"eps": 1e-10, "rho_sync": False}),
}


@pytest.mark.parametrize("case", list(ENGINE))
@pytest.mark.parametrize("kind", ["nonneg", "box", "signed_box", "disk"])
def test_engine_is_its_host_driven_body_and_matches_jax(kind, case):
    n, dtype, changes = ENGINE[case]
    # tests/test_torch_engine.py's generator, at which its bars hold
    rng = np.random.default_rng(0)
    S = rng.standard_normal((20, n, n))
    P, q = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n), rng.standard_normal((20, n))
    lo, hi = -(rng.random((20, n)) * 0.5 + 0.2), rng.random((20, n)) * 0.5 + 0.2
    vs, radius = np.sign(rng.standard_normal((20, n))), rng.random((20, n // 2)) * 0.5 + 0.05
    P, q, lo, hi, vs, radius = (x.astype(dtype) for x in (P, q, lo, hi, vs, radius))
    pa = {"nonneg": (), "box": (lo, hi), "signed_box": (lo, hi, vs), "disk": (radius,)}[kind]
    qstop = kind == "disk"
    jcfg = (dq.QCQP_DEFAULTS if qstop else dq.QP_DEFAULTS).replace(max_iter=3000, **changes)
    tcfg = dqt.SolverConfig.from_dict(dataclasses.asdict(jcfg))
    targs = (torch.from_numpy(P), torch.from_numpy(q), torch.zeros_like(torch.from_numpy(q)),
             _prox(tp, kind, tuple(map(torch.from_numpy, pa))), tcfg, qstop, not qstop)
    l, st = tadmm.admm_solve(*targs)
    cond, body, s = tadmm.make_admm_step(*targs)
    while bool(cond(s)):                         # the host loop admm_solve ran before
        s = body(s)
    assert torch.equal(l, s.l2) and torch.equal(st.iterations, s.iters)
    assert torch.equal(st.res_prim, s.res_prim) and torch.equal(st.rho, s.rho_res)
    lj, sj = j_solve(jnp.asarray(P), jnp.asarray(q), jnp.zeros_like(jnp.asarray(q)),
                     _prox(jp, kind, tuple(map(jnp.asarray, pa))), jcfg,
                     qcqp_stopping=qstop, damp_both_taus=not qstop)
    np.testing.assert_allclose(l.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-10 if dtype == np.float64 else 2e-5)
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
    assert int(np.abs(st.iterations.numpy() - np.asarray(sj.iterations)).max()) <= 1


def test_engine_state_counters_are_device_tensors():
    xs = _problems(1, 2, 6, torch.float64)
    cond, body, s = tadmm.make_admm_step(xs[0], xs[1], torch.zeros_like(xs[1]),
                                         tp.prox_nonneg, dqt.QP_DEFAULTS)
    assert s.it.ndim == 0 and s.it.dtype == torch.int32
    assert s.all_done.ndim == 0 and s.all_done.dtype == torch.bool
    c = cond(s)
    assert isinstance(c, torch.Tensor) and c.dtype == torch.bool and c.ndim == 0
    s1 = body(s)
    assert int(s1.it) == 1 and s1.all_done.dtype == torch.bool


# --------------------------------------------------------------------------
# The adaptive Newton-Schulz loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, max_iters", [(np.float32, 30), (np.float64, 30),
                                              (np.float32, 2)],
                         ids=["f32", "f64", "f32 capped at 2"])
def test_ns_adaptive_matches_jax(dtype, max_iters):
    rng = np.random.default_rng(7)
    S = rng.standard_normal((5, 12, 12))
    M = (S @ S.transpose(0, 2, 1) + 0.5 * np.eye(12)).astype(dtype)
    x0 = (np.eye(12)[None] / np.abs(M).sum(-1).max(-1)[:, None, None]).astype(dtype)
    Xj = np.asarray(jlinalg.newton_schulz_inverse_adaptive(jnp.asarray(M), jnp.asarray(x0),
                                                           max_iters=max_iters))
    Xt = tlinalg._ns_adaptive(torch.from_numpy(M), torch.from_numpy(x0), None, max_iters)
    tol = 2e-5 if dtype == np.float32 else 1e-12
    scale = np.abs(Xj).max()
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=0, atol=tol * scale)
    if max_iters == 30:
        inv = np.linalg.inv(M.astype(np.float64))
        assert np.abs(Xt.numpy() - inv).max() <= (1e-4 if dtype == np.float32 else 1e-10) * \
            np.abs(inv).max()


# --------------------------------------------------------------------------
# The contact rollout and its system-ID step under the guard
# --------------------------------------------------------------------------

def _rollout_inputs(b=4, t=8, seed=11):
    rng = np.random.default_rng(seed)
    mass = rng.random(b) * 2.0 + 0.5
    mu = rng.random(b) * 0.6 + 0.2
    v0 = rng.standard_normal((b, 3))
    v0[:, 2] = 0.0
    steps = rng.standard_normal((t, b, 3)) * 0.15
    steps[:, :, 2] = 0.0
    f = np.cumsum(steps, axis=0) + rng.standard_normal((1, b, 3)) * np.array([2.0, 2.0, 0.0])
    return (jcs.ContactParams(mass=mass, mu=mu), jcs.ContactState(x=np.zeros((b, 3)), v=v0), f)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_simulate_reads_nothing_on_the_host_and_matches_jax(no_host_reads, warm):
    params, state0, f = _rollout_inputs()
    jfinal, jtraj, jst = jcs.simulate(jcs.ContactParams(*map(jnp.asarray, params)),
                                      jcs.ContactState(*map(jnp.asarray, state0)),
                                      jnp.asarray(f), warm_start=warm, return_stats=True)
    tfinal, ttraj, tst = tcs.simulate(tcs.params_from_numpy(params, "cpu"),
                                      tcs.params_from_numpy(state0, "cpu"), torch.tensor(f),
                                      warm_start=warm, return_stats=True, device="cpu")
    np.testing.assert_allclose(ttraj.x.numpy(), np.asarray(jtraj.x), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tfinal.v.numpy(), np.asarray(jfinal.v), rtol=0, atol=1e-7)
    for k in ("qp_iters", "qcqp_iters"):
        assert np.abs(tst[k].numpy() - np.asarray(jst[k])).max() <= 1.0, k


def test_contact_system_id_step_reads_nothing_on_the_host_and_matches_jax(no_host_reads):
    optax = pytest.importorskip("optax")
    params, state0, f = _rollout_inputs(t=6)
    target = np.asarray(jcs.simulate(jcs.ContactParams(*map(jnp.asarray, params)),
                                     jcs.ContactState(*map(jnp.asarray, state0)),
                                     jnp.asarray(f))[1].x)
    raw0 = {"log_mass": np.zeros(4), "logit_mu": np.zeros(4)}
    opt = optax.adam(0.05)
    jstep, _ = jcs.make_system_id_step(opt, jcs.ContactState(*map(jnp.asarray, state0)),
                                       jnp.asarray(f), jnp.asarray(target))
    jraw = {k: jnp.asarray(v) for k, v in raw0.items()}
    jstate = opt.init(jraw)
    raw = {k: torch.tensor(v, requires_grad=True) for k, v in raw0.items()}
    tstep, _ = tcs.make_system_id_step(raw, tcs.params_from_numpy(state0, "cpu"),
                                       torch.tensor(f), torch.tensor(target),
                                       learning_rate=0.05, device="cpu")
    assert tstep.staged is None                 # on the CPU the step runs eagerly
    for _ in range(2):
        jraw, jstate, jl = jstep(jraw, jstate)
        tl = float(tstep())
        assert abs(tl - float(jl)) <= 1e-6 * abs(float(jl))
    for k in raw:
        np.testing.assert_allclose(raw[k].detach().numpy(), np.asarray(jraw[k]), atol=1e-6)


def test_graph_collects_dead_cycles_before_the_capture_and_none_during_it(monkeypatch):
    """``control.graph`` collects the dead reference cycles before the
    capture begins (a cycle may hold a graph of its own, whose collection
    inside another capture killed the process on the card) and keeps the
    cyclic collector off until the capture ends, then restores it. The
    capture is stood in for by a context that records what it sees."""
    seen = {}

    class Capture:                    # torch.cuda.graph's stand-in
        def __init__(self, g):
            pass

        def __enter__(self):
            seen["begin"] = (gc.isenabled(), ref() is None)

        def __exit__(self, *exc):
            seen["end"] = gc.isenabled()

    class Node:
        pass

    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(control, "_open", lambda *a: contextlib.nullcontext())
    for enabled in (False, True):
        cycle = Node()
        cycle.self = cycle
        ref = weakref.ref(cycle)
        del cycle
        gc.disable()                  # the cycle lives until graph collects it
        try:
            if enabled:
                gc.enable()
            with control.graph(Node()) as scope:
                assert not gc.isenabled() and scope.depth == 0
            assert seen == {"begin": (False, True), "end": False}
            assert gc.isenabled() is enabled
        finally:
            gc.enable()

