"""Tests of the port that need a CUDA card (marker ``gpu``): each skips
without one. They import no JAX; run them on a card with

    python -m pytest --noconftest -o addopts='' -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other
files).
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.models.system_id import SystemID
from diffqcqp_tpu_torch.parallel import make_batch_mesh, solve_qcqp_sharded
from diffqcqp_tpu_torch.utils import staged
from diffqcqp_tpu_torch.utils.staging import WARMUP

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _flagship(b, nc=12, seed=0):
    """bench.py's QCQP generator, float32."""
    n = 2 * nc
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)).astype(np.float32) / np.sqrt(n)
    P = s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32)
    q = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    l_n = (rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32)
    mu = (rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32)
    return P, q, l_n, mu


@pytest.mark.parametrize("lockstep", [False, True], ids=["independent", "lockstep"])
def test_sharded_solve_runs_on_the_callers_stream(card, lockstep):
    """The inputs are filled on a side stream after ~50 ms of other work on
    it, and the sharded solve is called under that stream: its shards must
    wait for the fill (they run on the caller's stream, also in lockstep's
    shard threads), so l equals the unsharded solve of the same inputs
    (within 1e-5: lockstep runs the engine, which rounds otherwise at
    another batch size). A shard on the default stream would read zeros."""
    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400)
    src = [torch.tensor(x, device=card) for x in _flagship(512)]
    l_ref, _ = dqt.solve_qcqp_with_stats(*src, config=cfg)
    xs = [torch.zeros_like(x) for x in src]
    torch.cuda.synchronize(card)
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        for x, s in zip(xs, src):
            x.copy_(s)
        l, st = solve_qcqp_sharded(*xs, mesh=make_batch_mesh([card, card]), config=cfg,
                                   lockstep=lockstep)
        l = l.clone()
    side.synchronize()
    torch.cuda.synchronize(card)
    assert bool(st.converged.all())
    assert float((l - l_ref).abs().max()) <= 1e-5


FLAG_CFG = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0, power_iters=10,
                                     rho_update_period=24)


def _flagship_step(P, q, l_n, mu):
    """bench.py's step: the solve and the gradient of sum(l^2) for P, q,
    l_n and mu, with the stats."""
    xs = [x.detach().requires_grad_() for x in (P, q, l_n, mu)]
    l, st = dqt.solve_qcqp_with_stats(*xs, config=FLAG_CFG)
    return l, st, torch.autograd.grad((l * l).sum(), xs)


def test_staged_flagship_step_is_the_eager_step_bit_for_bit(card):
    """The flagship step at B=64 staged as one CUDA graph: past its warm-up
    calls (eager) the capture and every replay give the eager step's l,
    stats and gradients bit for bit, on two input sets (q, then q + 1e-5 k
    as bench.py perturbs it)."""
    P, q, l_n, mu = (torch.tensor(x, device=card, dtype=torch.float32) for x in _flagship(64))
    step = staged(_flagship_step)
    for k in range(6):
        xs = (P, q + 1e-5 * (k % 2), l_n, mu)
        got, want = step(*xs), _flagship_step(*xs)
        leaves = torch.utils._pytree.tree_leaves
        assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want))), k
    assert len(step.graphs) == 1


def test_lockstep_step_on_two_shards_stages_as_one_loop(card):
    """The two-shard lockstep flagship step at B=64 (both shards on the
    card) staged: the capture records one WHILE node, E1 and K2 once a
    shard, and every replay gives the eager step's l, stats and gradients
    bit for bit on two input sets."""
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import qcqp_kkt_bwd_fused_cuda

    mesh = make_batch_mesh([card, card])

    def step(P, q, l_n, mu):
        xs = [x.detach().requires_grad_() for x in (P, q, l_n, mu)]
        l, st = solve_qcqp_sharded(*xs, mesh=mesh, config=FLAG_CFG, lockstep=True)
        return l, st, torch.autograd.grad((l * l).sum(), xs)

    P, q, l_n, mu = (torch.tensor(x, device=card, dtype=torch.float32) for x in _flagship(64))
    s = staged(step)
    for k in range(6):
        xs = (P, q + 1e-5 * (k % 2), l_n, mu)
        eigh_cuda.launches = qcqp_kkt_bwd_fused_cuda.launches = 0
        got = s(*xs)
        if k == WARMUP:
            assert (eigh_cuda.launches, qcqp_kkt_bwd_fused_cuda.launches) == (2, 2)
        want = step(*xs)
        leaves = torch.utils._pytree.tree_leaves
        assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want))), k
    (nodes,) = s.nodes.values()
    assert nodes == {("while", 0): 1}


def test_float64_flagship_step_is_staged_bit_for_bit(card, monkeypatch):
    """The float64 flagship step at B=64 takes the engine's spectral mode,
    its set-up the Jacobi kernel E1: staged as one CUDA graph, past its
    warm-up calls every replay gives the eager step's l, stats and
    gradients bit for bit, on two input sets, and the capture records E1
    once and no call of torch.linalg.eigh."""
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda

    def no_eigh(*a, **k):
        raise AssertionError("torch.linalg.eigh called on the card")

    monkeypatch.setattr(torch.linalg, "eigh", no_eigh)
    P, q, l_n, mu = (torch.tensor(x, device=card, dtype=torch.float64) for x in _flagship(64))
    step = staged(_flagship_step)
    for k in range(6):
        xs = (P, q + 1e-5 * (k % 2), l_n, mu)
        eigh_cuda.launches = 0
        got = step(*xs)
        if k == WARMUP:
            assert eigh_cuda.launches == 1
        want = _flagship_step(*xs)
        leaves = torch.utils._pytree.tree_leaves
        assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want))), k
    assert len(step.graphs) == 1


@pytest.mark.parametrize("n, dtype", [(24, torch.float32), (24, torch.float64),
                                      (7, torch.float32), (33, torch.float32),
                                      (130, torch.float64)])
def test_jacobi_eigh_is_its_plain_version_bit_for_bit(card, n, dtype):
    """E1 against its plain version on the card (one warp a problem at N <=
    32, block-wide at N=33; at N=130 in float64 V^T on its global
    workspace): eigenvalues, eigenvectors and sweeps bit for bit,
    eigenvalues ascending, and V orthonormal and V diag(lam) V^T = P within
    50 N u."""
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda, jacobi_eigh_plain

    P = torch.tensor(_flagship(16, (n + 1) // 2)[0][:, :n, :n], dtype=dtype, device=card)
    w, V, sw = eigh_cuda(P, stats=True)
    wp, Vp, swp, _ = jacobi_eigh_plain(P, stats=True)
    assert torch.equal(w, wp) and torch.equal(V, Vp) and torch.equal(sw, swp)
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    u = torch.finfo(dtype).eps / 2
    V64, P64 = V.double(), P.double()
    res = torch.linalg.matrix_norm(V64 @ torch.diag_embed(w.double()) @ V64.mT - P64)
    assert float((res / torch.linalg.matrix_norm(P64)).max()) <= 50 * n * u
    assert float((V64.mT @ V64 - torch.eye(n, dtype=torch.float64, device=card)).abs().max()) \
        <= 50 * n * u


def test_jacobi_eigh_gives_nan_for_a_non_finite_problem(card):
    """A problem whose P holds a NaN or an inf gives NaN eigenvalues and
    eigenvectors and no error; the others are untouched."""
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda

    P = torch.tensor(_flagship(4, 3)[0], device=card)
    P[1, 2, 3] = float("nan")
    P[2, 0, 0] = float("inf")
    w, V = eigh_cuda(P)
    bad = torch.tensor([False, True, True, False], device=card)
    assert bool(torch.isnan(w[bad]).all()) and bool(torch.isnan(V[bad]).all())
    assert bool(torch.isfinite(w[~bad]).all()) and bool(torch.isfinite(V[~bad]).all())


@pytest.mark.parametrize("kind", ["qp", "qcqp"])
def test_system_id_in_the_spectral_mode_is_staged_on_the_card(card, kind):
    """A float64 card model at N=6 takes the engine's spectral mode, whose
    set-up is the Jacobi kernel E1: it stages its step (a capturable Adam)
    and trains past the warm-up steps, its loss falling."""
    dtype = torch.float64
    m = SystemID(kind=kind, config=(dqt.QP_DEFAULTS if kind == "qp" else FLAG_CFG).replace(
        eps=1e-7), learning_rate=5e-2, device=card)
    g = torch.Generator().manual_seed(2)
    if kind == "qp":
        m.init_qp(g, batch=8, n=6, dtype=dtype)
    else:
        m.init_qcqp(g, batch=8, nc=3, dtype=dtype)
    target = torch.rand(8, 6, generator=torch.Generator().manual_seed(3), dtype=dtype) * 0.1
    losses = [float(m.train_step(target.to(card))) for _ in range(WARMUP + 3)]
    assert m._staged_step is not None and m.opt.defaults["capturable"] is True
    assert len(m._staged_step.graphs) == 1
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_system_id_with_a_diagonal_p_is_staged_on_the_card(card):
    """A diagonal-P card model (the engine, its loop a WHILE node) stages
    its step, with the losses of the same model trained eagerly."""
    def model():
        m = SystemID(kind="qp", config=dqt.QP_DEFAULTS.replace(eps=1e-7), learning_rate=5e-2,
                     device=card)
        m.init_qp(torch.Generator().manual_seed(2), batch=8, n=6, diag=True)
        return m

    staged_m, eager_m = model(), model()
    assert staged_m._staged_step is not None and staged_m.opt.defaults["capturable"] is True
    target = torch.rand(8, 6, generator=torch.Generator().manual_seed(3)).to(card) * 0.1
    for k in range(WARMUP + 3):
        got, want = staged_m.train_step(target), eager_m._train_step(target)
        assert torch.equal(got, want), k
    assert len(staged_m._staged_step.graphs) == 1


def test_system_id_on_the_kernel_route_is_staged_on_the_card(card):
    """A dense float32 card model stages its step: one graph after the
    warm-up, with the losses of the same model trained eagerly (a
    capturable Adam on both sides)."""
    def model():
        m = SystemID(kind="qcqp", config=FLAG_CFG, learning_rate=1e-2, device=card)
        m.init_qcqp(torch.Generator().manual_seed(4), batch=64, nc=12)
        return m

    staged_m, eager_m = model(), model()
    assert staged_m._staged_step is not None and staged_m.opt.defaults["capturable"] is True
    target = torch.rand(64, 24, generator=torch.Generator().manual_seed(5)).to(card) * 0.1
    for k in range(WARMUP + 3):
        got, want = staged_m.train_step(target), eager_m._train_step(target)
        assert torch.equal(got, want), k
    assert len(staged_m._staged_step.graphs) == 1


def test_while_loop_is_decided_on_the_card_at_every_replay(card):
    """``control.while_loop`` under a capture opened by ``control.graph`` is
    one WHILE node: each replay runs as many iterations as its inputs
    need, with the eager loop's bits, and reads nothing on the host."""
    from diffqcqp_tpu_torch.utils import control

    def loop(x, lim):
        return control.while_loop(lambda s: s[1].max() < lim,
                                  lambda s: (s[0] + 1, s[1] * 2.0 + 1.0),
                                  (torch.zeros((), dtype=torch.int32, device=card), x))

    x = torch.rand(64, device=card)
    sx, sl = x.clone(), torch.tensor(1000.0, device=card)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with control.graph(g) as scope:
        k, y = loop(sx, sl)
    g.instantiate()
    assert dict(scope.recorded) == {("while", 0): 1}
    assert control.node_counts(g)["conditional"] == 1
    for lim in (10.0, 1e5, 0.0):
        sl.fill_(lim)
        torch.cuda.set_sync_debug_mode("error")
        try:
            g.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        k_e, y_e = loop(x, torch.tensor(lim, device=card))
        assert torch.equal(k, k_e) and torch.equal(y, y_e), lim


@pytest.mark.parametrize("identity", ["true_fn", "false_fn"])
def test_cond_writes_nothing_into_a_returned_operand(card, identity):
    """``control.cond`` under a capture opened by ``control.graph``, with
    one branch that returns its operand: a replay leaves the operand as it
    is, whichever branch the predicate picks, and gives the eager
    result."""
    from diffqcqp_tpu_torch.utils import control

    fns = (lambda x: x, lambda x: x + 1.0)
    if identity == "false_fn":
        fns = fns[::-1]
    x = torch.rand(64, device=card)
    x0, p = x.clone(), torch.tensor(True, device=card)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with control.graph(g) as scope:
        y = control.cond(p, *fns, (x,))
    g.instantiate()
    assert dict(scope.recorded) == {("if", 0): 2}
    for pred in (False, True, False):
        p.fill_(pred)
        g.replay()
        torch.cuda.synchronize(card)
        assert torch.equal(x, x0), pred
        assert torch.equal(y, (fns[0] if pred else fns[1])(x0)), pred


def test_cond_returns_the_buffer_both_branches_return(card):
    """The engine's recompute: one branch writes a buffer in place, the
    other returns it. Under a capture ``cond`` returns that buffer itself
    (no copy into another), and a replay writes it only where the predicate
    holds."""
    from diffqcqp_tpu_torch.utils import control

    buf, src = torch.zeros(64, device=card), torch.rand(64, device=card)
    p = torch.tensor(False, device=card)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with control.graph(g):
        out = control.cond(p, lambda: buf.copy_(src * 2.0), lambda: buf)
    g.instantiate()
    assert out is buf
    g.replay()
    torch.cuda.synchronize(card)
    assert torch.equal(buf, torch.zeros_like(buf))
    p.fill_(True)
    g.replay()
    torch.cuda.synchronize(card)
    assert torch.equal(buf, src * 2.0)


def test_a_dead_staged_model_is_collected_before_a_capture_not_inside_it(card):
    """A card ``SystemID`` and its staged step form a reference cycle that
    holds a CUDA graph. Dropped, it is collected when ``control.graph``
    opens the next capture, not by a collection inside that capture (which
    destroyed its graph mid-capture and killed the process at the
    capture's end); the capture records and replays as it should."""
    from diffqcqp_tpu_torch.utils import control

    def dead_model():
        m = SystemID(kind="qp", config=dqt.QP_DEFAULTS.replace(eps=1e-7), device=card)
        m.init_qp(torch.Generator().manual_seed(2), batch=8, n=6)
        target = torch.zeros(8, 6, device=card)
        for _ in range(WARMUP + 1):
            m.train_step(target)
        assert len(m._staged_step.graphs) == 1
        return weakref.ref(m._staged_step)

    gc.disable()
    try:
        ref = dead_model()
        assert ref() is not None
        g = torch.cuda.CUDAGraph(keep_graph=True)
        x = torch.ones(64, device=card)
        with control.graph(g):
            assert ref() is None and not gc.isenabled()
            junk = [[] for _ in range(100_000)]     # past the collector's thresholds
            y = x * 2.0
        del junk
        g.instantiate()
        g.replay()
        torch.cuda.synchronize(card)
        assert torch.equal(y, torch.full_like(x, 2.0))
    finally:
        gc.enable()



def test_k1_launch_plan_is_the_librarys(card):
    """K1's launch plan as the built library computes it (dq_admm_plan) is
    the wrapper's at every n the kernel takes."""
    from diffqcqp_tpu_torch.kernels import admm_cuda

    for n in range(1, 170):
        assert admm_cuda.c_launch_plan(n) == admm_cuda.launch_plan(n)


def test_staged_n96_step_records_k1s_register_instance(card):
    """A staged QP step at N=96 records one K1 launch at its capture, of the
    register instance 96 (``admm_solve_cuda.launches_by_instance``), and its
    replay gives the eager step's l bit for bit."""
    from diffqcqp_tpu_torch.kernels import admm_cuda

    rng = np.random.default_rng(96)
    s = rng.standard_normal((64, 96, 96)).astype(np.float32) / np.sqrt(96)
    P = torch.tensor(s @ s.transpose(0, 2, 1) + 0.1 * np.eye(96), dtype=torch.float32, device=card)
    q = torch.tensor(rng.standard_normal((64, 96)), dtype=torch.float32, device=card)
    cfg = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho_update_period=24)
    step = staged(lambda P_, q_: dqt.solve_qp_with_stats(P_, q_, config=cfg)[0])
    for _ in range(WARMUP):
        l_eager = step(P, q)
    admm_cuda.admm_solve_cuda.launches_by_instance.clear()
    l = step(P, q)
    torch.cuda.synchronize(card)
    assert admm_cuda.admm_solve_cuda.launches_by_instance == {96: 1}
    assert torch.equal(l, l_eager)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("b", [1, 2048])
@pytest.mark.parametrize("n", [8, 24, 33, 96, 170])
def test_glue_kernels_are_their_plain_versions_bit_for_bit(card, n, b, dtype):
    """G1 (forward and adjoint) and G2 give their plain versions' bits on
    the card, for a contiguous P, a batch-broadcast one (batch stride 0)
    and a transposed view, and G1's output is exactly symmetric; each call
    counts one launch."""
    from diffqcqp_tpu_torch.kernels import glue_cuda as G

    gen = torch.Generator(device=card).manual_seed(n * 7 + b)
    X = torch.randn((b, n, n), generator=gen, dtype=dtype, device=card)
    inputs = {"contiguous": X, "broadcast": X[:1].expand(b, n, n), "transposed": X.mT}
    before = dict(G.symmetrize_cuda.launches_by_instance)
    for name, x in inputs.items():
        for adjoint in (False, True):
            y = G.symmetrize_cuda(x, adjoint)
            assert y.is_contiguous() and torch.equal(y, G.symmetrize_plain(x, adjoint)), (name,
                                                                                           adjoint)
            assert torch.equal(y, y.mT)
    after = G.symmetrize_cuda.launches_by_instance
    assert all(after[k] - before.get(k, 0) == 3 for k in ("forward", "adjoint"))
    dl = torch.randn((b, n), generator=gen, dtype=dtype, device=card)
    l = torch.randn((b, n), generator=gen, dtype=dtype, device=card)
    launches = G.grad_p_cuda.launches
    g = G.grad_p_cuda(dl, l)
    torch.cuda.synchronize(card)
    assert G.grad_p_cuda.launches == launches + 1
    assert torch.equal(g, G.grad_p_plain(dl, l)) and torch.equal(g, g.mT)


def _qp_train_step(P, q):
    """config 6's QP training step: the solve and the gradients of sum(l^2)
    for P and q."""
    xs = [x.detach().requires_grad_() for x in (P, q)]
    cfg = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho_update_period=24)
    l, _ = dqt.solve_qp_with_stats(*xs, config=cfg)
    return (l, *torch.autograd.grad((l * l).sum(), xs))


@pytest.mark.parametrize("n", [24, 96])
def test_staged_qp_train_step_records_one_pass_of_each_glue_kernel(card, monkeypatch, n):
    """A staged QP train step records one G1 forward, one G1 adjoint and one
    G2 launch at its capture, and its l, dP and dq equal, bit for bit, those
    of the eager step with the PyTorch formulas the kernels replaced
    (0.5 * (P + P^T) differentiated by autograd, -0.5 * (dl l^T + l dl^T))."""
    from diffqcqp_tpu_torch import api
    from diffqcqp_tpu_torch.kernels import glue_cuda as G
    from diffqcqp_tpu_torch.utils import shapes

    rng = np.random.default_rng(n)
    s = rng.standard_normal((256, n, n)).astype(np.float32) / np.sqrt(n)
    skew = 0.01 * rng.standard_normal((256, n, n)).astype(np.float32)
    P = torch.tensor(s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n) + skew, dtype=torch.float32,
                     device=card)
    q = torch.tensor(rng.standard_normal((256, n)), dtype=torch.float32, device=card)
    step = staged(_qp_train_step)
    for _ in range(WARMUP):
        step(P, q)
    G.symmetrize_cuda.launches_by_instance.clear()
    launches = G.grad_p_cuda.launches
    got = step(P, q)
    torch.cuda.synchronize(card)
    assert G.symmetrize_cuda.launches_by_instance == {"forward": 1, "adjoint": 1}
    assert G.grad_p_cuda.launches == launches + 1
    monkeypatch.setattr(shapes, "symmetrize", G.symmetrize_plain)
    monkeypatch.setattr(api, "grad_p_cuda", G.grad_p_plain)
    want = _qp_train_step(P, q)
    torch.cuda.synchronize(card)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_glue_kernels_past_a_blocks_width(card, dtype):
    """At N = 1100 (G1 as tile pairs, G2 with more runs a row than a block
    has threads) both kernels give their plain versions' bits."""
    from diffqcqp_tpu_torch.kernels import glue_cuda as G

    gen = torch.Generator(device=card).manual_seed(1100)
    X = torch.randn((3, 1100, 1100), generator=gen, dtype=dtype, device=card)
    for adjoint in (False, True):
        assert torch.equal(G.symmetrize_cuda(X, adjoint), G.symmetrize_plain(X, adjoint))
    dl, l = (torch.randn((3, 1100), generator=gen, dtype=dtype, device=card) for _ in range(2))
    assert torch.equal(G.grad_p_cuda(dl, l), G.grad_p_plain(dl, l))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_glue_kernels_take_unaligned_inputs_and_refuse_other_dtypes(card, dtype):
    """G2 at N=96 on dl and l that start off a 16-byte boundary (its
    one-element runs) gives its plain version's bits; both CUDA wrappers
    raise on float16 rather than run a formula."""
    from diffqcqp_tpu_torch.kernels import glue_cuda as G

    gen = torch.Generator(device=card).manual_seed(96)
    b, n = 2048, 96
    buf = torch.randn((2, b * n + 1), generator=gen, dtype=dtype, device=card)
    dl, l = (x[1:].view(b, n) for x in buf)
    assert dl.data_ptr() % 16 != 0
    assert torch.equal(G.grad_p_cuda(dl, l), G.grad_p_plain(dl, l))
    with pytest.raises(TypeError):
        G.symmetrize_cuda(torch.zeros((2, 8, 8), dtype=torch.float16, device=card))
    with pytest.raises(TypeError):
        G.grad_p_cuda(dl.half(), l.half())
