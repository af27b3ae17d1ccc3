"""The lockstep mode (``axis_name``) of the port's sharding: one loop steps
every shard (``parallel/sharding.py::Lockstep``), on the CPU.

  * the joint loop on ``make_batch_mesh(["cpu"] * 4)`` runs one thread at a
    time: a spy counting the threads at work (a shard thread from its solve's
    start to the hand-over of its loop and from its release to its end, the
    calling thread while it runs the joint loop) never sees two, and no
    ``threading.Barrier`` is made;
  * under the patched capture of ``tests/test_torch_staging.py``, a lockstep
    sharded step and a lockstep ``trace_qp`` inside a binding
    (``parallel.lockstep``) give their eager bits; a mesh over two devices,
    an NCCL group of two ranks (stood in for) and a gloo group each raise
    the guard's error naming that reason;
  * l and stats equal the JAX package's ``solve_*_sharded(...,
    lockstep=True)`` on its 8-device host mesh (float64, B=16,
    ``tests/test_torch_parallel.py``'s tolerances: atol 1e-9 on l for the QP
    family, 1e-7 for the QCQP; iterations within 1 a problem, the engine's
    parity bar);
  * a shard failing after its loop, or the joint loop failing, makes the
    caller raise that error, with no thread left behind;
  * a one-rank gloo group runs the cross-rank MIN once an iteration with the
    bits of a mesh without a group; a ``SystemID`` in the lockstep mode trains
    inside ``parallel.lockstep`` with the losses of the model without it.

The staged lockstep step on the card is ``chip_smoke.py``'s phase 3q.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import diffqcqp_tpu as dq
from diffqcqp_tpu.parallel import sharding as jsh
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.models import system_id as tsid
from diffqcqp_tpu_torch.parallel import (
    BatchMesh,
    lockstep,
    make_batch_mesh,
    shard_batch,
    solve_box_qp_sharded,
    solve_qcqp_sharded,
    solve_qp_sharded,
    solve_signed_box_qp_sharded,
)
from diffqcqp_tpu_torch.parallel import sharding as tsh

SHARDS = 4
CFG = dq.SolverConfig(eps=1e-10, max_iter=5000)
QCFG = dq.QCQP_DEFAULTS.replace(eps=1e-8, max_iter=20000)
TCFG = dqt.SolverConfig(eps=1e-10, max_iter=5000)
TQCFG = dqt.QCQP_DEFAULTS.replace(eps=1e-8, max_iter=20000)


def _spd(rng, b, n):
    s = rng.standard_normal((b, n, n))
    return s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n)


def _problems(kind, seed=0, b=16):
    """(numpy inputs, atol) of a class, as tests/test_sharding.py builds them."""
    rng = np.random.default_rng(seed)
    if kind == "qcqp":
        nc = 4
        P, q = _spd(rng, b, 2 * nc), rng.standard_normal((b, 2 * nc))
        return (P, q, rng.random((b, nc)) * 0.5 + 0.05, rng.random((b, nc)) * 0.5 + 0.05), 1e-7
    n = 8
    P, q = _spd(rng, b, n), rng.standard_normal((b, n))
    if kind == "qp":
        return (P, q), 1e-9
    lo, hi = -(rng.random((b, n)) * 0.4 + 0.05), rng.random((b, n)) * 0.4 + 0.05
    if kind == "box":
        return (P, q, lo, hi), 1e-9
    return (P, q, lo, hi, rng.standard_normal((b, n))), 1e-9


SOLVES = {
    "qp": (jsh.solve_qp_sharded, solve_qp_sharded, CFG, TCFG),
    "box": (jsh.solve_box_qp_sharded, solve_box_qp_sharded, CFG, TCFG),
    "signed_box": (jsh.solve_signed_box_qp_sharded, solve_signed_box_qp_sharded, CFG, TCFG),
    "qcqp": (jsh.solve_qcqp_sharded, solve_qcqp_sharded, QCFG, TQCFG),
}


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jsh.make_batch_mesh()


@pytest.fixture(scope="module")
def tmesh():
    return make_batch_mesh(["cpu"] * SHARDS)


@pytest.fixture
def steps(monkeypatch):
    """The joint loop's steps: the number of shards each ``Lockstep._step``
    call stepped."""
    calls = []
    inner = tsh.Lockstep._step

    def spy(self, bodies, states):
        calls.append(len(states))
        return inner(self, bodies, states)

    monkeypatch.setattr(tsh.Lockstep, "_step", spy)
    return calls


def _report_capture(monkeypatch):
    """Make the CPU report a CUDA graph capture in progress (as
    tests/test_torch_staging.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)


def _same(monkeypatch, call):
    """``call()`` gives the same bits under the patched capture as without."""
    want = call()
    with monkeypatch.context() as m:
        _report_capture(m)
        got = call()
    a, b = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------
# One thread at a time
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["qp", "qcqp"])
def test_one_thread_works_at_a_time(kind, tmesh, monkeypatch, steps):
    """The shard threads are call stacks: each runs its solve up to the
    hand-over of its loop, then the calling thread runs one loop over every
    shard, then each thread finishes in turn. Every shard thread sleeps at
    the start of its solve, so threads that ran at once would be seen."""
    xs, _ = _problems(kind)
    name = f"solve_{kind}_with_stats"
    inner_solve, inner_loop, inner_run = (getattr(dqt.api, name), tsh.Lockstep.loop,
                                          tsh.Lockstep.run)
    working, lock = [0, 0], threading.Lock()      # (now, most at once)
    barriers = []

    def move(d):
        with lock:
            working[0] += d
            working[1] = max(working[1], working[0])

    def solve(*a, **kw):
        move(1)
        try:
            time.sleep(0.02)
            return inner_solve(*a, **kw)
        finally:
            move(-1)

    def loop(self, *a):
        move(-1)                 # the shard hands its loop over and waits
        try:
            return inner_loop(self, *a)
        finally:
            move(1)

    def run(self, loops):
        move(1)
        try:
            return inner_run(self, loops)
        finally:
            move(-1)

    real_barrier = threading.Barrier

    def barrier(*a, **kw):
        barriers.append(1)
        return real_barrier(*a, **kw)

    monkeypatch.setattr(dqt.api, name, solve)
    monkeypatch.setattr(tsh.Lockstep, "loop", loop)
    monkeypatch.setattr(tsh.Lockstep, "run", run)
    monkeypatch.setattr(threading, "Barrier", barrier)
    _, tsolve, _, tcfg = SOLVES[kind]
    l, st = tsolve(*(shard_batch(torch.from_numpy(x), tmesh) for x in xs), mesh=tmesh,
                   config=tcfg, lockstep=True)
    assert bool(st.converged.all())
    assert working == [0, 1], working
    assert not barriers
    assert steps == [SHARDS] * int(st.iterations.max())


# --------------------------------------------------------------------------
# Under the (patched) capture
# --------------------------------------------------------------------------

def _lockstep_step(kind, mesh):
    """A lockstep sharded forward+backward step: l, stats and the gradient
    of sum(l^2) for every input."""
    xs, _ = _problems(kind, seed=3, b=8)
    _, tsolve, _, tcfg = SOLVES[kind]

    def call():
        leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
        l, st = tsolve(*leaves, mesh=mesh, config=tcfg, lockstep=True)
        return l, st, torch.autograd.grad((l * l).sum(), leaves[:2])
    return call


@pytest.mark.parametrize("kind", ["qp", "qcqp"])
def test_lockstep_step_records_with_its_eager_bits(kind, monkeypatch):
    """Under the patched capture the lockstep step on one device (four CPU
    shards) runs, with the bits it gives eagerly."""
    _same(monkeypatch, _lockstep_step(kind, make_batch_mesh(["cpu"] * SHARDS)))


def test_lockstep_trace_records_inside_a_binding(monkeypatch):
    """``trace_qp`` in the lockstep mode inside a binding of its axis runs its
    ``iters`` body steps, as in the JAX package, with its eager bits under the
    patched capture, and equals the trace without ``axis_name`` (one shard,
    no group: nothing to reduce)."""
    (P, q), _ = _problems("qp", b=4)
    P, q = torch.from_numpy(P), torch.from_numpy(q)
    cfg = TCFG.replace(axis_name="batch")
    with pytest.raises(NameError, match="unbound axis name 'batch'"):
        dqt.debug.trace_qp(P, q, iters=5, config=cfg, device="cpu")

    def traced():
        with lockstep(make_batch_mesh(["cpu"])):
            return dqt.debug.trace_qp(P, q, iters=5, config=cfg, device="cpu")

    _same(monkeypatch, traced)
    plain = dqt.debug.trace_qp(P, q, iters=5, config=TCFG, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(traced(), plain))


@pytest.fixture
def gloo_group():
    """A one-rank gloo process group (an in-memory store, no network)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_capture_refuses_a_mesh_over_two_devices(monkeypatch):
    """One loop records on one card: a mesh whose shards lie on two devices
    raises the guard's error, naming them, before any shard is placed."""
    mesh = BatchMesh((torch.device("cpu"), torch.device("cuda:0")), "batch")
    call = _lockstep_step("qp", mesh)
    _report_capture(monkeypatch)
    with pytest.raises(RuntimeError, match="cannot run inside a CUDA graph capture") as err:
        call()
    assert "the lockstep mode" in str(err.value)
    assert "on 2 devices (cpu, cuda:0)" in str(err.value)


@pytest.mark.parametrize("how", ["sharded call", "lockstep(mesh)"])
def test_capture_refuses_a_gloo_group(how, gloo_group, monkeypatch):
    """A gloo group's all-reduce of the done flag runs on the host: a
    sharded lockstep call and a lockstep solve inside ``lockstep(mesh)``
    each raise the guard's error naming gloo."""
    (P, q), _ = _problems("qp", b=4)
    P, q = torch.from_numpy(P), torch.from_numpy(q)
    if how == "sharded call":
        mesh = make_batch_mesh(["cpu", "cpu"])
        call = lambda: solve_qp_sharded(P, q, mesh=mesh, config=TCFG, lockstep=True)  # noqa: E731
    else:
        mesh = make_batch_mesh(["cpu"])

        def call():
            with lockstep(mesh):
                return dqt.solve_qp(P, q, config=TCFG.replace(axis_name="batch"), device="cpu")
    assert mesh.group is gloo_group
    _report_capture(monkeypatch)
    with pytest.raises(RuntimeError, match="cannot run inside a CUDA graph capture") as err:
        call()
    assert "process group is gloo" in str(err.value)


def test_capture_refuses_nccl_across_ranks(gloo_group, monkeypatch):
    """NCCL fails to record an all-reduce inside a WHILE node's body across
    ranks (on two H100s; one rank records): a capture over an NCCL group of
    two ranks raises the guard's error naming it, and over one rank it
    does not. The group here is a one-rank gloo group standing in for NCCL
    (``Lockstep._backend`` and the world size patched: the CPU has no
    NCCL)."""
    import torch.distributed as dist

    (P, q), _ = _problems("qp", b=4)
    mesh = make_batch_mesh(["cpu", "cpu"])
    call = lambda: solve_qp_sharded(torch.from_numpy(P), torch.from_numpy(q),  # noqa: E731
                                    mesh=mesh, config=TCFG, lockstep=True)
    monkeypatch.setattr(tsh.Lockstep, "_backend", lambda self: "nccl")
    assert tsh.Lockstep(mesh).capture_reason() is None        # one rank records
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    _report_capture(monkeypatch)
    with pytest.raises(RuntimeError, match="cannot run inside a CUDA graph capture") as err:
        call()
    assert "NCCL group spans 2 ranks" in str(err.value)


def test_one_rank_gloo_group_reduces_once_an_iteration(gloo_group, monkeypatch, steps):
    """Eagerly a one-rank gloo group takes one all-reduce MIN of the done
    flag a joint step, and gives the bits of the mesh without a group."""
    import torch.distributed as dist

    (P, q), _ = _problems("qp")
    P, q = torch.from_numpy(P), torch.from_numpy(q)
    calls, inner = [], dist.all_reduce

    def all_reduce(t, *a, **kw):
        calls.append(t.dtype)
        return inner(t, *a, **kw)

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    l_g, st_g = solve_qp_sharded(P, q, mesh=make_batch_mesh(["cpu", "cpu"]), config=TCFG,
                                 lockstep=True)
    n = int(st_g.iterations.max())
    assert calls == [torch.int32] * n and steps == [2] * n
    l, st = solve_qp_sharded(P, q, mesh=BatchMesh((torch.device("cpu"),) * 2, "batch"),
                             config=TCFG, lockstep=True)
    assert len(calls) == n
    assert torch.equal(l, l_g) and all(torch.equal(a, b) for a, b in zip(st, st_g))


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(SOLVES))
def test_lockstep_matches_jax(kind, jmesh, tmesh, steps):
    """l, converged flags and iterations of the port's lockstep solve on 4
    CPU shards against the JAX package's lockstep solve on its 8-device
    mesh; the joint loop ran the slowest problem's iterations."""
    xs, atol = _problems(kind, seed=5)
    jsolve, tsolve, jcfg, tcfg = SOLVES[kind]
    lj, sj = jsolve(*(jsh.shard_batch(jnp.asarray(x), jmesh) for x in xs), mesh=jmesh,
                    config=jcfg, lockstep=True)
    lt, st = tsolve(*(shard_batch(torch.from_numpy(x), tmesh) for x in xs), mesh=tmesh,
                    config=tcfg, lockstep=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=atol)
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
    assert bool(st.converged.all())
    assert np.abs(st.iterations.numpy() - np.asarray(sj.iterations)).max() <= 1
    assert steps == [SHARDS] * int(st.iterations.max())


# --------------------------------------------------------------------------
# Failures
# --------------------------------------------------------------------------

def _call_in_thread(fn):
    out = {}

    def call():
        try:
            out["value"] = fn()
        except Exception as e:   # noqa: BLE001 - the test reads it
            out["error"] = e

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the shards hung"
    return out


def test_failure_after_the_loop_raises_that_shards_error(tmesh, monkeypatch):
    """Shard 1 raises in its epilogue (after the joint loop): the caller
    gets that error, every shard thread ends, and the axis is free after."""
    (P, q), _ = _problems("qp")
    inner = dqt.api._map_back

    def map_back(out, d):
        if threading.current_thread().name == "batch-shard-1":
            raise ArithmeticError("shard 1's epilogue failed")
        return inner(out, d)

    monkeypatch.setattr(dqt.api, "_map_back", map_back)
    before = threading.active_count()
    out = _call_in_thread(lambda: solve_qp_sharded(P, q, mesh=tmesh, config=TCFG,
                                                   lockstep=True))
    assert isinstance(out.get("error"), ArithmeticError), out
    assert threading.active_count() == before
    monkeypatch.setattr(dqt.api, "_map_back", inner)
    _, st = solve_qp_sharded(P, q, mesh=tmesh, config=TCFG, lockstep=True)
    assert bool(st.converged.all())


def test_failure_in_the_joint_loop_raises_it(tmesh, monkeypatch):
    """A step of the joint loop raises: the shards are released without a
    final state (they end, aborted) and the caller gets the loop's error."""
    (P, q), _ = _problems("qp")

    def step(self, bodies, states):
        raise FloatingPointError("the joint step failed")

    monkeypatch.setattr(tsh.Lockstep, "_step", step)
    before = threading.active_count()
    out = _call_in_thread(lambda: solve_qp_sharded(P, q, mesh=tmesh, config=TCFG,
                                                   lockstep=True))
    assert isinstance(out.get("error"), FloatingPointError), out
    assert threading.active_count() == before


# --------------------------------------------------------------------------
# A model in the lockstep mode
# --------------------------------------------------------------------------

def test_system_id_in_lockstep_mode_trains_inside_a_binding():
    """A ``SystemID`` whose config names the axis stages on the card
    (``capturable_route``) and trains inside ``parallel.lockstep``; on one
    shard and no group its losses and parameters are the model's without
    ``axis_name``, bit for bit. ``lockstep`` takes one shard a process."""
    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-10, max_iter=5000)
    target = torch.tensor(np.random.default_rng(6).random((4, 6)) * 0.1)
    runs = []
    for c in (cfg, cfg.replace(axis_name="batch")):
        m = tsid.SystemID(kind="qcqp", config=c, learning_rate=1e-2, device="cpu")
        m.init_qcqp(torch.Generator().manual_seed(5), batch=4, nc=3, dtype=torch.float64)
        assert tsid.capturable_route("qcqp", m.params, c)
        with lockstep(make_batch_mesh(["cpu"])):
            losses = [m.train_step(target) for _ in range(3)]
        runs.append((torch.stack(losses), [p.detach() for p in m.params]))
    (la, pa), (lb, pb) = runs
    assert torch.equal(la, lb) and all(torch.equal(a, b) for a, b in zip(pa, pb))
    with pytest.raises(ValueError, match="one shard a process"):
        with lockstep(make_batch_mesh(["cpu", "cpu"])):
            pass
