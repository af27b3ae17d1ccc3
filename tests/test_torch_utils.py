"""The port's utils (``diffqcqp_tpu_torch/utils``: retry, bucketing,
autotune, cache) against the JAX package's on the same numpy inputs, and
the kernel wrappers' launch counters under threads.

Bars: ``solve_resumed`` in float64 against the JAX one at atol 1e-10 on l
and every ``SolveStats`` field, iterations and flags equal, problems that
converged in the first round frozen bit for bit; bucketing equal to the
JAX functions exactly; padded solves against unpadded ones at atol 1e-12
(the JAX file's); ``tune_compact_iters`` equal to the JAX model at
``tile_b=1``.
"""

import dataclasses
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
from diffqcqp_tpu.utils import autotune as jautotune, bucketing as jbucket
from diffqcqp_tpu.utils.retry import solve_resumed as j_resumed
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.kernels import _build, admm_cuda, coord_bwd_cuda, qcqp_bwd_cuda, qr_solve_cuda
from diffqcqp_tpu_torch.utils import bucketing, enable_compilation_cache
from diffqcqp_tpu_torch.utils.retry import solve_resumed


def _spd(rng, b, n):
    s = rng.standard_normal((b, n, n))
    return s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n)


# --------------------------------------------------------------------------
# solve_resumed
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["qp", "qcqp"])
def test_resumed_matches_jax(kind):
    """A first round starved to 4 iterations caps most problems; the
    resumed rounds converge them, as the JAX package's do."""
    rng = np.random.default_rng(0)
    b, n = 8, 10
    xs = (_spd(rng, b, n), rng.standard_normal((b, n)))
    if kind == "qcqp":
        xs += (rng.random((b, n // 2)) * 0.5 + 0.05, rng.random((b, n // 2)) * 0.5 + 0.05)
    base = dq.QCQP_DEFAULTS if kind == "qcqp" else dq.QP_DEFAULTS
    jcfg = base.replace(eps=1e-10, max_iter=4)
    tcfg = dqt.SolverConfig.from_dict(dataclasses.asdict(jcfg))
    jsolve = getattr(dq, f"solve_{kind}_with_stats")
    tsolve = getattr(dqt, f"solve_{kind}_with_stats")
    _, st1 = tsolve(*xs, config=tcfg, device="cpu")
    assert not bool(st1.converged.all())
    lj, sj = j_resumed(jsolve, *map(jnp.asarray, xs), config=jcfg, rounds=4, growth=8)
    lt, st = solve_resumed(tsolve, *xs, config=tcfg, rounds=4, growth=8, device="cpu")
    assert bool(st.converged.all())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-10, rtol=0)
    for f in ("res_prim", "res_dual", "rho"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   atol=1e-10, rtol=0, err_msg=f)
    for f in ("iterations", "converged", "stalled"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                      err_msg=f)
    assert int(st.iterations.max()) > 4


def test_resumed_keeps_converged_frozen():
    rng = np.random.default_rng(1)
    P, q = _spd(rng, 6, 8), rng.standard_normal((6, 8))
    cfg = dqt.SolverConfig(eps=1e-10, max_iter=2000)
    l1, st1 = dqt.solve_qp_with_stats(P, q, config=cfg, device="cpu")
    assert bool(st1.converged.all())
    l, st = solve_resumed(dqt.solve_qp_with_stats, P, q, config=cfg, rounds=2, device="cpu")
    assert torch.equal(l, l1) and torch.equal(st.iterations, st1.iterations)


def test_resumed_kernel_route_freezes_the_converged():
    """Dense float32 takes K1 (its plain version on the CPU), one launch a
    round: the problems converged in round 1 keep round 1's l bit for bit,
    the others converge later."""
    rng = np.random.default_rng(2)
    b, nc = 64, 6
    n = 2 * nc
    s = rng.standard_normal((b, n, n)) / np.sqrt(n)
    xs = tuple(x.astype(np.float32) for x in (
        s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n), rng.standard_normal((b, n)) * 0.5,
        rng.random((b, nc)) * 0.5 + 0.05, rng.random((b, nc)) * 0.5 + 0.05))
    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-6, max_iter=16, rho0_scale=2.0, power_iters=10,
                                    rho_update_period=24)
    assert dqt.which_backend(xs[0], xs[1], cfg) == "pallas"
    l1, st1 = dqt.solve_qcqp_with_stats(*xs, config=cfg, device="cpu")
    done = st1.converged
    assert 0 < int(done.sum()) < b
    l, st = solve_resumed(dqt.solve_qcqp_with_stats, *xs, config=cfg, rounds=3, growth=4,
                          device="cpu")
    assert bool(st.converged.all())
    assert torch.equal(l[done], l1[done])
    assert torch.equal(st.iterations[done], st1.iterations[done])
    assert bool((st.iterations[~done] > 16).all())


# --------------------------------------------------------------------------
# bucketing
# --------------------------------------------------------------------------

def test_bucket_size_equals_jax():
    for buckets in ((128, 512), (16, 64), (8,), (512, 128, 2048)):
        for batch in (1, 7, 8, 9, 16, 100, 128, 129, 200, 512, 513, 1500, 2048, 5000):
            assert bucketing.bucket_size(batch, buckets) == jbucket.bucket_size(batch, buckets)
    assert bucketing.bucket_size(513, (128, 512)) == 1024


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "diagonal"])
def test_pad_to_bucket_equals_jax(dense):
    rng = np.random.default_rng(3)
    for b in (3, 11, 16, 17):
        n = 6
        P = _spd(rng, b, n) if dense else rng.random((b, n)) + 0.3
        xs = (P, rng.standard_normal((b, n)), rng.random((b, n // 2)))
        (tp, ti), (jp, ji) = (bucketing.pad_to_bucket(tuple(map(torch.from_numpy, xs)), (8, 16)),
                              jbucket.pad_to_bucket(tuple(map(jnp.asarray, xs)), (8, 16)))
        assert tuple(ti) == tuple(ji)
        for a, c in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        assert torch.equal(bucketing.unpad(tp[1], ti), torch.from_numpy(xs[1]))
    with pytest.raises(ValueError, match=r"args\[1\] has leading dim 4 != 3"):
        bucketing.pad_to_bucket((torch.zeros(3, 2, 2), torch.zeros(4, 2)))


def test_padded_solve_matches_unpadded():
    rng = np.random.default_rng(4)
    b, n = 11, 8
    P, q = torch.from_numpy(_spd(rng, b, n)), torch.from_numpy(rng.standard_normal((b, n)))
    cfg = dqt.SolverConfig(eps=1e-10, max_iter=5000)
    l_ref, _ = dqt.solve_qp_with_stats(P, q, config=cfg, device="cpu")
    (Pp, qp), info = bucketing.pad_to_bucket((P, q), buckets=(16, 64))
    assert info.padded == 16 and Pp.shape[0] == 16
    l_pad, s_pad = dqt.solve_qp_with_stats(Pp, qp, config=cfg, device="cpu")
    np.testing.assert_allclose(bucketing.unpad(l_pad, info).numpy(), l_ref.numpy(), atol=1e-12)
    assert bool(bucketing.unpad(s_pad.converged, info).all())
    # identity padding converges immediately and to exactly zero
    assert bool((l_pad[b:] == 0.0).all())
    assert int(s_pad.iterations[b:].max()) <= 2


def test_padded_qcqp_diag():
    rng = np.random.default_rng(5)
    b, nc = 5, 3
    n = 2 * nc
    xs = tuple(map(torch.from_numpy, (rng.random((b, n)) + 0.3, rng.standard_normal((b, n)),
                                      rng.random((b, nc)) + 0.1, rng.random((b, nc)) + 0.1)))
    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-9, max_iter=20000)
    l_ref = dqt.solve_qcqp(*xs, config=cfg, device="cpu")
    padded, info = bucketing.pad_to_bucket(xs, buckets=(8,))
    l_pad = dqt.solve_qcqp(*padded, config=cfg, device="cpu")
    np.testing.assert_allclose(bucketing.unpad(l_pad, info).numpy(), l_ref.numpy(), atol=1e-12)


# --------------------------------------------------------------------------
# tune_compact_iters, enable_compilation_cache
# --------------------------------------------------------------------------

def _distributions():
    rng = np.random.default_rng(6)
    tail = np.full(4096, 12)
    tail[rng.choice(4096, 40, replace=False)] = 400       # 1 % stragglers at 400
    return {
        "flagship-like": rng.integers(9, 30, 4096),
        "uniform": rng.integers(1, 400, 2048),
        "long tail": tail,
        "constant": np.full(1000, 17),
    }


@pytest.mark.parametrize("name", list(_distributions()))
def test_tune_compact_iters_prices_the_card_tile(name):
    """The JAX package's model at the card's tile of one problem: always 0.
    On the long tail the JAX default (a 512-problem TPU tile) picks a K;
    the card has no tile tail to compact."""
    it = _distributions()[name]
    got = dqt.tune_compact_iters(it)
    at_one = jautotune.tune_compact_iters(it, tile_b=1, n=None)
    tpu = jautotune.tune_compact_iters(it)
    print(f"{name}: port {got}, JAX model at tile_b=1 {at_one}, JAX default (tile_b=512) {tpu}")
    assert got == at_one == 0
    assert dqt.tune_compact_iters(torch.from_numpy(it), tile_b=64, n=24, max_iter=50) == 0
    if name == "long tail":
        assert tpu > 0


def test_enable_compilation_cache(tmp_path):
    before = _build.BUILD_DIR
    try:
        path = dqt.enable_compilation_cache(str(tmp_path / "cache" / "dqt"))
        assert path == str(tmp_path / "cache" / "dqt")
        assert (tmp_path / "cache" / "dqt").is_dir()
        assert _build.BUILD_DIR == tmp_path / "cache" / "dqt"
        assert _build.library_path("admm").parent == tmp_path / "cache" / "dqt"
        assert dqt.enable_compilation_cache(path) == path         # again: safe
    finally:
        _build.BUILD_DIR = before
    assert _build.BUILD_DIR == before


# --------------------------------------------------------------------------
# the launch counters under threads
# --------------------------------------------------------------------------

def test_launch_counters_count_exactly_from_threads():
    """8 threads bump every kernel wrapper's counter through
    ``_build.count_launch`` (as the shards of a sharded solve do), with a
    short switch interval: no increment is lost."""
    wrappers = (admm_cuda.admm_solve_cuda, coord_bwd_cuda.coord_kkt_bwd_fused_cuda,
                qcqp_bwd_cuda.qcqp_kkt_bwd_fused_cuda, qcqp_bwd_cuda.qcqp_kkt_bwd_cuda,
                qr_solve_cuda.qr_solve_cuda)
    saved = [w.launches for w in wrappers]
    interval = sys.getswitchinterval()
    per_thread = 2000
    try:
        sys.setswitchinterval(1e-6)
        for w in wrappers:
            w.launches = 0
        start = threading.Barrier(8)

        def bump():
            start.wait()
            for _ in range(per_thread):
                for w in wrappers:
                    _build.count_launch(w)

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [w.launches for w in wrappers] == [8 * per_thread] * len(wrappers)
    finally:
        sys.setswitchinterval(interval)
        for w, n in zip(wrappers, saved):
            w.launches = n
