"""The spectral mode's eigendecomposition on the card, the Jacobi kernel E1
(``kernels/eigh_cuda.py``), through its plain version on the CPU:

  * ``jacobi_eigh_plain`` against ``jnp.linalg.eigh`` on the same numpy P
    (float64 and float32; N = 1, 2, 7, 24, 48; repeated eigenvalues; a
    diagonal P; an SPD P of condition ~1e8 in float64), with ``chip_smoke.py``
    phase 2p's bars, u the dtype's unit roundoff: |lam - lam_jax| <= 50 N u
    ||P||_2, ||V diag(lam) V^T - P||_F / ||P||_F <= 50 N u, max |V^T V - I| <=
    50 N u; the eigenvalues ascending; a P with a NaN or an inf gives NaN for
    that problem alone and raises nothing;
  * the wrapper on CPU tensors is the plain version and counts no launch;
    the round-robin order pairs every index with every other once a sweep;
    the fused pass's block map covers every entry of A once a round; the
    launch plan (one warp a problem to N = 32 and the problems a block, the
    threads above, each plan's shared memory; A and V^T in shared memory to
    N = 169 float32 / 119 float64, A alone to 239 / 169, then the global
    workspace);
  * ``ops/linalg.py::factorize`` keeps LAPACK's ``torch.linalg.eigh`` on
    CPU tensors;
  * the engine twin: ``tests/test_torch_engine.py::test_engine_matches_jax``'s
    spectral cases (the four prox kinds, float64 and float32) run again with
    the engine's ``factorize`` patched to the plain Jacobi, against the JAX
    engine at that file's bars (float64: atol 1e-10 on l, iterations within
    1, equal ``converged`` and ``stalled``; float32: atol 2e-5, iterations
    within 1, equal ``converged``): the card's factorization gives the
    engine the JAX package's answers.

The kernel itself runs on the card: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phases 2p, 3p and 4p.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffqcqp_tpu_torch.kernels import _build, eigh_cuda as E
from diffqcqp_tpu_torch.ops import linalg as tl
from diffqcqp_tpu_torch.solvers import admm as tadmm
from tests.test_torch_engine import EPS, KINDS, QCQP, QP, _assert_parity, _problems, _run_both


def _spd(b, n, seed, dtype):
    """bench.py's P: S S^T / n + 0.1 I."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)) / np.sqrt(n)
    return (s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n)).astype(dtype)


def _with_spectrum(lams, b, seed, dtype):
    """Q diag(lams) Q^T for a random orthogonal Q per problem."""
    rng = np.random.default_rng(seed)
    n = len(lams)
    Q = np.linalg.qr(rng.standard_normal((b, n, n)))[0]
    P = Q @ (np.asarray(lams)[None, :, None] * Q.transpose(0, 2, 1))
    return (0.5 * (P + P.transpose(0, 2, 1))).astype(dtype)


CASES = {
    **{f"n={n} {np.dtype(dt).name}": (lambda n=n, dt=dt: _spd(8, n, n, dt))
       for n, dt in itertools.product((1, 2, 7, 24, 48), (np.float64, np.float32))},
    "repeated eigenvalues float64": lambda: _with_spectrum([1, 1, 1, 2, 2, 3, 3, 3, 0.5], 6, 1,
                                                           np.float64),
    "repeated eigenvalues float32": lambda: _with_spectrum([1, 1, 1, 2, 2, 3, 3, 3, 0.5], 6, 1,
                                                           np.float32),
    "diagonal P float64": lambda: np.stack([np.diag(d) for d in np.random.default_rng(2).random(
        (5, 10))]).astype(np.float64),
    "diagonal P float32": lambda: np.stack([np.diag(d) for d in np.random.default_rng(2).random(
        (5, 10))]).astype(np.float32),
    "SPD of condition 1e8 float64": lambda: _with_spectrum(np.logspace(0, -8, 12), 6, 3,
                                                           np.float64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_jacobi_matches_jax_eigh(case):
    P = CASES[case]()
    n = P.shape[-1]
    u = np.finfo(P.dtype).eps / 2
    w, V = E.jacobi_eigh_plain(torch.from_numpy(P))
    assert w.dtype == V.dtype == torch.from_numpy(P).dtype
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    wj = np.asarray(jnp.linalg.eigh(jnp.asarray(P))[0]).astype(np.float64)
    w, V, P64 = w.double().numpy(), V.double().numpy(), P.astype(np.float64)
    norm2 = np.linalg.norm(P64, ord=2, axis=(1, 2))
    assert np.all(np.abs(w - wj).max(axis=1) <= 50 * n * u * norm2)
    resid = np.linalg.norm(V @ (w[:, :, None] * V.transpose(0, 2, 1)) - P64, axis=(1, 2))
    assert np.all(resid <= 50 * n * u * np.linalg.norm(P64, axis=(1, 2)))
    assert np.abs(V.transpose(0, 2, 1) @ V - np.eye(n)).max() <= 50 * n * u


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_non_finite_problem_gives_nan_alone(dtype):
    P = torch.from_numpy(_spd(4, 6, 0, np.float64)).to(dtype)
    P[1, 2, 3] = float("nan")
    P[2, 0, 0] = float("inf")
    w, V, sweeps, _ = E.jacobi_eigh_plain(P, stats=True)
    bad = torch.tensor([False, True, True, False])
    assert bool(torch.isnan(w[bad]).all()) and bool(torch.isnan(V[bad]).all())
    assert bool(torch.isfinite(w[~bad]).all()) and bool(torch.isfinite(V[~bad]).all())
    assert sweeps[bad].tolist() == [0, 0] and bool((sweeps[~bad] > 0).all())


def test_wrapper_on_the_cpu_is_the_plain_version():
    P = torch.from_numpy(_spd(5, 9, 4, np.float32))
    E.eigh_cuda.launches = 0
    got, want = E.eigh_cuda(P, stats=True), E.jacobi_eigh_plain(P, stats=True)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert E.eigh_cuda.launches == 0
    with pytest.raises(ValueError, match="B, N, N"):
        E.eigh_cuda(P[0])
    with pytest.raises(TypeError, match="float32 or float64"):
        E.eigh_cuda(P.half())


@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 24, 25])
def test_round_robin_pairs_every_index_once_a_sweep(n):
    rounds = E.round_pairs(n)
    assert len(rounds) == n - 1 + (n & 1)
    seen = []
    for ps, qs in rounds:
        idx = ps + qs
        assert len(set(idx)) == len(idx)                     # disjoint within a round
        assert all(p < q < n for p, q in zip(ps, qs))
        seen += list(zip(ps, qs))
    assert sorted(seen) == list(itertools.combinations(range(n), 2))


# dtype: (last N with A and V^T in shared memory, last N with A there,
# problems a block at N = 24 and N = 32 in the one-warp kernel)
PLAN_PINS = {torch.float32: (169, 239, 1, 5), torch.float64: (119, 169, 2, 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_launch_plan_keeps_a_and_v_in_shared_memory_to_the_opt_in(dtype):
    both, a_only, w24, w32 = PLAN_PINS[dtype]
    item = 8 if dtype == torch.float64 else 4
    plane = lambda n: item * n * (n | 1)                                   # noqa: E731
    scratch = lambda n: item * 4 * ((n + 1) // 2) + 4 * ((n + 1) // 2 + n)  # noqa: E731
    # N <= 32: one warp a problem, A, V^T and the ranks of each in shared memory
    for n, problems in ((24, w24), (32, w32)):
        plan = E.launch_plan(n, dtype)
        assert (plan.warp, plan.problems, plan.threads, plan.bound, plan.layout) == \
            (1, problems, 32 * problems, 256, E.SHARED)
        assert plan.smem == problems * ((2 * plane(n) + 4 * n + 15) // 16 * 16)
        assert plan.smem <= _build.HOPPER_SMEM_OPTIN
    # N > 32: one block a problem, a warp for every 128 of the (N/2)^2 blocks
    assert E.launch_plan(33, dtype)[:3] == (0, 1, 96)
    assert E.launch_plan(48, dtype).threads == 160 and E.launch_plan(130, dtype).threads == 1024
    # A and V^T to the first bound, then A alone (V^T in the workspace), then
    # neither; each plan's shared memory by the formula, within the opt-in
    assert E.in_shared(both, dtype) and not E.in_shared(both + 1, dtype)
    assert E.a_in_shared(a_only, dtype) and not E.a_in_shared(a_only + 1, dtype)
    for n, layout, planes, work in ((both, E.SHARED, 2, 0), (both + 1, E.VT_GLOBAL, 1, 1),
                                    (a_only, E.VT_GLOBAL, 1, 1), (a_only + 1, E.GLOBAL, 0, 2)):
        plan = E.launch_plan(n, dtype)
        assert (plan.warp, plan.layout) == (0, layout)
        assert plan.smem == scratch(n) + planes * plane(n) <= _build.HOPPER_SMEM_OPTIN
        assert E.workspace_elems(n, dtype) == work * n * (n | 1)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 24, 25, 33, 48])
def test_fused_pass_covers_every_entry_of_a_once_a_round(n):
    """The fused pass's block map (the kernel's plan at n: one warp a
    problem to N = 32, block-wide above): each round, every entry of A (and
    of V^T) lies in exactly one thread's 2 x 2 blocks, and in the one-warp
    kernel every block's column pair is its lane's own, the pair whose
    parameters that lane computed (so pair k's diagonal block takes them
    from registers)."""
    plan = E.launch_plan(n, torch.float32)
    m = n + (n & 1)
    lanes = E.block_map(n, 32 if plan.warp else plan.threads, bool(plan.warp))
    for r in range(m - 1):
        pairs = [E.pair_of(r, k, m) for k in range(m // 2)]
        seen = np.zeros((n, n), dtype=int)
        for t, blocks in enumerate(lanes):
            for k, kc in blocks:
                rows = [i for i in pairs[k] if i < n]
                cols = [j for j in pairs[kc] if j < n]
                seen[np.ix_(rows, cols)] += 1
                if plan.warp:
                    assert kc == t % ((n + 1) // 2)
        assert (seen == 1).all()


def test_factorize_keeps_lapack_on_the_cpu(monkeypatch):
    P = torch.from_numpy(_spd(3, 6, 5, np.float64))
    monkeypatch.setattr(E, "jacobi_eigh_plain", lambda *a, **k: pytest.fail("plain Jacobi"))
    f = tl.factorize(P)
    w, V = torch.linalg.eigh(P)
    assert torch.equal(f.eigvals, w) and torch.equal(f.eigvecs, V)


def _plain_factorize(P):
    if P.ndim == 2:
        return tl.Factorization(eigvals=P, eigvecs=None, diag=P)
    _plain_factorize.calls += 1
    w, V = E.jacobi_eigh_plain(P)
    return tl.Factorization(eigvals=w, eigvecs=V, diag=None)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_engine_with_the_jacobi_factorization_matches_jax(monkeypatch, kind, dtype):
    """test_engine_matches_jax's spectral case with the engine's factorize
    patched to the plain Jacobi (the card kernel's arithmetic)."""
    monkeypatch.setattr(tadmm, "factorize", _plain_factorize)
    _plain_factorize.calls = 0
    P, q, pa = _problems(0, 20, 8, dtype)
    cfg = (QCQP if kind == "disk" else QP).replace(eps=EPS[dtype], linsolve="auto")
    out_j, out_t = _run_both(kind, P, q, np.zeros_like(q), pa[kind], cfg)
    assert _plain_factorize.calls == 1
    _assert_parity(out_j, out_t, dtype, stalled=dtype == np.float64)
    assert out_t[1].converged.all()
