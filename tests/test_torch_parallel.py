"""The port's batch sharding (``diffqcqp_tpu_torch/parallel``) against the
JAX package's (``diffqcqp_tpu/parallel``), on the same numpy problems.

The port's meshes hold 4 CPU shards (``make_batch_mesh(["cpu"] * 4)``, a
repeated device being the port's stand-in for virtual devices); the JAX
functions run on the conftest's 8-device CPU mesh. float64 throughout, B=16
(8 for the gradients), the JAX file's tolerances: atol 1e-9 on l for the QP
family, 1e-7 for the QCQP, 1e-8 for the gradients; per-problem iterations
equal in the uneven lockstep case.

``test_two_process_distributed`` runs this file's ``__main__`` block in two
gloo processes, each with 2 local CPU shards, free and lockstep: each
rank's slices of l and dl/dq, concatenated in rank order, are held against
a single-process solve of the same batch by the port (atol 1e-8 / 1e-6, as
tests/test_multihost.py) and by the JAX package.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
from diffqcqp_tpu.parallel import sharding as jsh
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.parallel import (
    global_batch_mesh,
    initialize_distributed,
    make_batch_mesh,
    shard_batch,
    shard_host_local_batch,
    solve_qcqp_sharded,
    solve_qp_sharded,
    solve_signed_box_qp_sharded,
)
from diffqcqp_tpu_torch.parallel import sharding as tsh

CFG = dq.SolverConfig(eps=1e-10, max_iter=5000)
QCFG = dq.QCQP_DEFAULTS.replace(eps=1e-8, max_iter=20000)
TCFG = dqt.SolverConfig(eps=1e-10, max_iter=5000)
TQCFG = dqt.QCQP_DEFAULTS.replace(eps=1e-8, max_iter=20000)
SHARDS = 4


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
    return (P, q, lo, hi, rng.standard_normal((b, n))), 1e-9


SOLVES = {
    "qp": (jsh.solve_qp_sharded, solve_qp_sharded, CFG, TCFG),
    "qcqp": (jsh.solve_qcqp_sharded, solve_qcqp_sharded, QCFG, TQCFG),
    "signed_box": (jsh.solve_signed_box_qp_sharded, solve_signed_box_qp_sharded, CFG, TCFG),
}


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jsh.make_batch_mesh()


@pytest.fixture(scope="module")
def tmesh():
    return make_batch_mesh(["cpu"] * SHARDS)


@pytest.fixture
def rounds(monkeypatch):
    """Each shard thread's calls of the lockstep reducer (one per engine
    iteration), by thread name."""
    calls, lock = {}, threading.Lock()
    inner = tsh._LockstepDone.__call__

    def spy(self, local_done):
        with lock:
            name = threading.current_thread().name
            calls[name] = calls.get(name, 0) + 1
        return inner(self, local_done)

    monkeypatch.setattr(tsh._LockstepDone, "__call__", spy)
    return calls


@pytest.mark.parametrize("kind, lockstep", [
    ("qp", False), ("qcqp", False), ("signed_box", False), ("qp", True), ("qcqp", True),
], ids=["qp", "qcqp", "signed_box", "lockstep_qp", "lockstep_qcqp"])
def test_sharded_matches_jax(kind, lockstep, jmesh, tmesh, rounds):
    xs, atol = _problems(kind)
    jsolve, tsolve, jcfg, tcfg = SOLVES[kind]
    lj, sj = jsolve(*(jsh.shard_batch(jnp.asarray(x), jmesh) for x in xs), mesh=jmesh,
                    config=jcfg, lockstep=lockstep)
    lt, st = tsolve(*(shard_batch(torch.from_numpy(x), tmesh) for x in xs), mesh=tmesh,
                    config=tcfg, lockstep=lockstep)
    assert lt.dtype == torch.float64 and lt.shape == (16, xs[1].shape[1])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=atol)
    assert bool(st.converged.all()) and bool(np.all(np.asarray(sj.converged)))
    # the port against its own unsharded solve
    solve = getattr(dqt, f"solve_{'signed_box_qp' if kind == 'signed_box' else kind}_with_stats")
    lu, su = solve(*map(torch.from_numpy, xs), config=tcfg, device="cpu")
    np.testing.assert_allclose(lt.numpy(), lu.numpy(), atol=atol)
    assert torch.equal(st.iterations, su.iterations)
    if lockstep:   # one reduction an iteration on every shard, until the slowest converged
        assert sorted(rounds) == [f"batch-shard-{i}" for i in range(SHARDS)]
        assert set(rounds.values()) == {int(su.iterations.max())}
    else:
        assert not rounds


def test_lockstep_uneven_convergence(jmesh, tmesh, rounds):
    """Shard 0's problems need many times the iterations: the MIN keeps
    every shard iterating until the globally slowest problem finishes, and
    per-problem iterations equal the unsharded solve's (frozen problems do
    not drift), as in the JAX package. The condition spread is exp(+-1)
    where tests/test_sharding.py takes exp(+-3) (~17,600 iterations): on the
    CPU every lockstep iteration hands the interpreter lock between the
    shard threads, so this keeps the case to ~365 iterations."""
    rng = np.random.default_rng(0)
    b, n = 16, 8
    P = _spd(rng, b, n)
    scale = np.exp(np.linspace(-1.0, 1.0, n))
    P[:2] = P[:2] * scale[None, :, None] * scale[None, None, :]
    q = rng.standard_normal((b, n))
    jcfg, tcfg = CFG.replace(max_iter=50000), TCFG.replace(max_iter=50000)
    lj, sj = jsh.solve_qp_sharded(jnp.asarray(P), jnp.asarray(q), mesh=jmesh, config=jcfg,
                                  lockstep=True)
    lt, st = solve_qp_sharded(torch.from_numpy(P), torch.from_numpy(q), mesh=tmesh,
                              config=tcfg, lockstep=True)
    _, su = dqt.solve_qp_with_stats(torch.from_numpy(P), torch.from_numpy(q), config=tcfg,
                                    device="cpu")
    it = su.iterations.numpy()
    assert it[:2].max() > 3 * it[2:].max(), "setup: shard 0 not slower"
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-8)
    assert bool(st.converged.all())
    np.testing.assert_array_equal(st.iterations.numpy(), it)
    # against the JAX engine within 1 iteration a problem (tests/test_torch_engine.py's bar)
    assert np.abs(st.iterations.numpy() - np.asarray(sj.iterations)).max() <= 1
    assert set(rounds.values()) == {int(it.max())} and len(rounds) == SHARDS


@pytest.mark.parametrize("lockstep", [False, True], ids=["free", "lockstep"])
def test_sharded_gradients_match(lockstep, jmesh, tmesh):
    """grad of sum(l^2) for P and q through the sharded solve, against
    jax.grad through the JAX package's sharded solve (atol 1e-8)."""
    rng = np.random.default_rng(1)
    b, n = 8, 6
    P, q = _spd(rng, b, n), rng.standard_normal((b, n))

    def jloss(P_, q_):
        l, _ = jsh.solve_qp_sharded(P_, q_, mesh=jmesh, config=CFG, lockstep=lockstep)
        return jnp.sum(l ** 2)

    gj = jax.grad(jloss, argnums=(0, 1))(jsh.shard_batch(jnp.asarray(P), jmesh),
                                         jsh.shard_batch(jnp.asarray(q), jmesh))
    Pt, qt = (torch.from_numpy(x).requires_grad_() for x in (P, q))
    l, _ = solve_qp_sharded(Pt, qt, mesh=tmesh, config=TCFG, lockstep=lockstep)
    gt = torch.autograd.grad((l ** 2).sum(), (Pt, qt))
    for a, b_ in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-8)


def test_batch_that_does_not_divide_raises(tmesh):
    (P, q), _ = _problems("qp", b=18)
    with pytest.raises(ValueError, match=r"P: the batch \(18\) must divide by the mesh's 4"):
        solve_qp_sharded(torch.from_numpy(P), torch.from_numpy(q), mesh=tmesh, config=TCFG)
    with pytest.raises(ValueError, match=r"\(18\).*4 shards"):
        shard_batch(P, tmesh)


def test_axis_name_without_a_mesh_raises():
    """axis_name with no sharded call binding it raises, naming the axis,
    as the JAX package's lax.pmin does for an unbound axis."""
    (P, q), _ = _problems("qp")
    cfg = TCFG.replace(axis_name="batch")
    with pytest.raises(NameError, match="unbound axis name 'batch'"):
        dqt.solve_qp(torch.from_numpy(P), torch.from_numpy(q), config=cfg, device="cpu")
    with pytest.raises(NameError, match="unbound axis name: batch"):
        dq.solve_qp(jnp.asarray(P), jnp.asarray(q), config=CFG.replace(axis_name="batch"))


def test_failing_shard_aborts_the_others(tmesh, monkeypatch):
    """A shard whose solve raises aborts the lockstep barrier: the other
    shards raise too instead of waiting for it, and the caller gets the
    failing shard's error, not a partial batch."""
    (P, q), _ = _problems("qp")
    inner = dqt.api.solve_qp_with_stats

    def shard_2_fails(P_, q_, *a, **kw):
        if threading.current_thread().name == "batch-shard-2":
            P_ = P_[:, :5, :5]             # this shard's P does not fit its q
        return inner(P_, q_, *a, **kw)

    monkeypatch.setattr(dqt.api, "solve_qp_with_stats", shard_2_fails)
    out = {}

    def call():
        try:
            solve_qp_sharded(P, q, mesh=tmesh, config=TCFG, lockstep=True)
        except Exception as e:   # noqa: BLE001 - the test reads it below
            out["error"] = e

    t = threading.Thread(target=call, daemon=True)
    t0 = time.perf_counter()
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the shards hung"
    assert isinstance(out.get("error"), ValueError), out
    assert "incompatible" in str(out["error"])
    assert time.perf_counter() - t0 < 60
    # the axis is free again afterwards
    monkeypatch.setattr(dqt.api, "solve_qp_with_stats", inner)
    lt, st = solve_qp_sharded(P, q, mesh=tmesh, config=TCFG, lockstep=True)
    assert bool(st.converged.all())


def test_independent_shards_run_in_the_callers_thread(tmesh, monkeypatch):
    """Without lockstep every shard is solved by the calling thread, in
    batch order, and shard_batch places the whole batch on the mesh's
    first device."""
    (P, q), _ = _problems("qp")
    seen, inner = [], dqt.api.solve_qp_with_stats

    def spy(P_, q_, *a, **kw):
        seen.append((threading.current_thread(), float(q_[0, 0])))
        return inner(P_, q_, *a, **kw)

    monkeypatch.setattr(dqt.api, "solve_qp_with_stats", spy)
    qs = shard_batch(q, tmesh)
    assert isinstance(qs, torch.Tensor) and torch.equal(qs, torch.from_numpy(q))
    solve_qp_sharded(shard_batch(P, tmesh), qs, mesh=tmesh, config=TCFG)
    assert [t for t, _ in seen] == [threading.current_thread()] * SHARDS
    assert [v for _, v in seen] == [float(q[i * 4, 0]) for i in range(SHARDS)]


def test_initialize_distributed_without_a_launch_is_a_no_op(monkeypatch):
    """No argument and no launch environment: a single process, no group,
    and the default mesh of a process holds none (as the JAX package's
    implicit initialize)."""
    import torch.distributed as dist

    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    initialize_distributed()
    assert not dist.is_initialized()
    assert make_batch_mesh(["cpu"]).group is None


# --------------------------------------------------------------------------
# Two processes over gloo
# --------------------------------------------------------------------------

MP_B, MP_NC = 16, 2
MP_CFG = dict(eps=1e-9, max_iter=5000)


def _mp_problem():
    """The batch both workers and the test build (tests/test_multihost.py's)."""
    n = 2 * MP_NC
    rng = np.random.default_rng(7)
    s = rng.standard_normal((MP_B, n, n)) / np.sqrt(n)
    P = s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = rng.standard_normal((MP_B, n)) * 0.5
    l_n = rng.random((MP_B, MP_NC)) * 0.5 + 0.05
    mu = rng.random((MP_B, MP_NC)) * 0.5 + 0.05
    return P, q, l_n, mu


def _worker(port: str, rank: int, outdir: str) -> None:
    """One rank: join the gloo group, take this rank's half of the batch on
    2 local CPU shards, solve it free and lockstep with dl/dq, save."""
    import torch.distributed as dist

    initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                           process_id=rank)
    assert dist.get_world_size() == 2 and dist.get_rank() == rank
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                           process_id=rank)                     # idempotent
    one = global_batch_mesh(device="cpu")
    assert one.group is not None and one.devices == (torch.device("cpu"),)
    mesh = make_batch_mesh(["cpu", "cpu"])
    assert mesh.group is not None
    half = MP_B // 2
    xs = [shard_host_local_batch(x[rank * half:(rank + 1) * half], mesh) for x in _mp_problem()]
    try:
        shard_host_local_batch(np.zeros((3 + rank, 2)), mesh)
        raise AssertionError("uneven local batches were accepted")
    except ValueError:
        pass
    cfg = dqt.QCQP_DEFAULTS.replace(**MP_CFG)
    rounds = []                       # the barrier actions: one cross-rank MIN each
    inner = tsh._LockstepDone._reduce

    def counted(self):
        rounds.append(1)
        inner(self)

    tsh._LockstepDone._reduce = counted
    for tag, lockstep in (("free", False), ("lockstep", True)):
        rounds.clear()
        q = xs[1].clone().requires_grad_()
        l, st = solve_qcqp_sharded(xs[0], q, xs[2], xs[3], mesh=mesh, config=cfg,
                                   lockstep=lockstep)
        (g,) = torch.autograd.grad((l * l).sum(), q)
        for name, x in (("l", l), ("g", g), ("conv", st.converged), ("it", st.iterations),
                        ("rounds", torch.tensor(len(rounds)))):
            np.save(os.path.join(outdir, f"{name}_{tag}_{rank}.npy"), x.detach().numpy())
    dist.destroy_process_group()
    print(f"worker {rank} done", flush=True)


def test_two_process_distributed(tmp_path):
    with socket.socket() as s:   # a free localhost port for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = root
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(i),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n[TIMEOUT]"
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"

    P, q, l_n, mu = _mp_problem()
    tcfg = dqt.QCQP_DEFAULTS.replace(**MP_CFG)
    qt = torch.from_numpy(q).requires_grad_()
    l_ref, st_ref = dqt.solve_qcqp_with_stats(P, qt, l_n, mu, config=tcfg, device="cpu")
    (g_ref,) = torch.autograd.grad((l_ref * l_ref).sum(), qt)
    jcfg = dq.QCQP_DEFAULTS.replace(**MP_CFG)
    lj = dq.solve_qcqp(*map(jnp.asarray, (P, q, l_n, mu)), config=jcfg)
    gj = jax.grad(lambda q_: jnp.sum(dq.solve_qcqp(jnp.asarray(P), q_, jnp.asarray(l_n),
                                                   jnp.asarray(mu), config=jcfg) ** 2))(
        jnp.asarray(q))
    load = lambda name, tag: np.concatenate(  # noqa: E731 - the ranks' slices in rank order
        [np.load(tmp_path / f"{name}_{tag}_{r}.npy") for r in range(2)])
    for tag in ("free", "lockstep"):
        assert load("conv", tag).all(), tag
        np.testing.assert_allclose(load("l", tag), l_ref.detach().numpy(), atol=1e-8, err_msg=tag)
        np.testing.assert_allclose(load("g", tag), g_ref.numpy(), atol=1e-6, err_msg=tag)
        np.testing.assert_allclose(load("l", tag), np.asarray(lj), atol=1e-8, err_msg=tag)
        np.testing.assert_allclose(load("g", tag), np.asarray(gj), atol=1e-6, err_msg=tag)
        np.testing.assert_array_equal(load("it", tag), st_ref.iterations.numpy(), err_msg=tag)
    # lockstep: both ranks reduced once an iteration until the global slowest
    # problem converged; free: no reduction at all
    rounds = [int(np.load(tmp_path / f"rounds_{tag}_{r}.npy")) for tag in ("free", "lockstep")
              for r in range(2)]
    assert rounds == [0, 0] + [int(st_ref.iterations.max())] * 2, rounds


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
