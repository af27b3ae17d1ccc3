"""K1's plain version (``admm_solve_plain``) against the JAX package.

float32: against the JAX kernel itself, ``admm_solve_pallas(interpret=True)``
as tests/test_pallas.py runs it on the CPU, on that file's problems (b=20,
n=8; b=8, n=6 for the padding case), for all four prox kinds and the
warm_start_dual, rho_sync=False and max_iter cases. Bars: atol 2e-5 on l,
equal ``converged`` and ``stalled``, iterations within 1 per problem.

These run at eps=1e-5. At the JAX suite's eps=1e-6 most of these problems
(P = S S^T with unscaled S) stop through the float32 stall floor (delta <= 8
ulp * |l2|), and when that test first passes, or whether eps passes first,
follows rounding order: the JAX interpreter and eager torch fuse and reduce
differently. Measured there: one box problem exits at 75 against 77
iterations, and one signed-box and one disk problem are floor-admitted on
one side and eps-certified on the other. That compares rounding, not the
algorithm, so at eps=1e-6 the tests hold the JAX suite's own bar for these
kinds (tests/test_pallas.py): atol 2e-5 and every problem converged.

float64: against the XLA engine ``admm_solve`` with lmax_method='power' at
eps=1e-10, where both run the same algorithm with different linear solves
(eigh vs the refined Gauss-Jordan inverse). Asserted atol 1e-11 and
iterations within 1.

The plain version, as the kernel, iterates against the explicit inverse
(``gj_inverse``) by one refined solve, where the JAX kernel sweeps an LDL^T
factor: these bars are what holds that change to the JAX kernel's
trajectory, at the stall floor too. It also rounds as the kernel does (its
fused multiply-adds and its block sums' order; two tests pin those), so
that on the card the kernel and its plain version agree bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffqcqp_tpu.config import QCQP_DEFAULTS, SolverConfig
from diffqcqp_tpu.kernels import admm_pallas as jk
from diffqcqp_tpu.ops.prox import prox_box, prox_disk, prox_nonneg, prox_signed_box
from diffqcqp_tpu.solvers.admm import admm_solve
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.kernels import admm_cuda as tk

# tests/test_pallas.py's configurations, and the same at eps=1e-5
CFG6 = SolverConfig(eps=1e-6, max_iter=3000, lmax_method="power", power_iters=10)
QCFG6 = QCQP_DEFAULTS.replace(eps=1e-6, max_iter=5000, lmax_method="power")
CFG, QCFG = CFG6.replace(eps=1e-5), QCFG6.replace(eps=1e-5)


def _problems(seed, b, n, dtype):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((b, n, n)).astype(dtype)
    P = S @ S.transpose(0, 2, 1) + dtype(0.1) * np.eye(n, dtype=dtype)
    q = rng.standard_normal((b, n)).astype(dtype)
    lo = -(rng.random((b, n)) * 0.5 + 0.2).astype(dtype)
    hi = (rng.random((b, n)) * 0.5 + 0.2).astype(dtype)
    vs = np.sign(rng.standard_normal((b, n))).astype(dtype)
    radius = (rng.random((b, n // 2)) * 0.5 + 0.05).astype(dtype)
    return P, q, {"nonneg": (), "box": (lo, hi), "signed_box": (lo, hi, vs),
                  "disk": (radius,)}


KINDS = {"nonneg": jk.PROX_NONNEG, "box": jk.PROX_BOX,
         "signed_box": jk.PROX_SIGNED_BOX, "disk": jk.PROX_DISK}


def _port_cfg(cfg):
    return dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))


def _run_both(P, q, ws, kind, pa, cfg):
    qstop = kind == "disk"
    lj, sj = jk.admm_solve_pallas(
        jnp.asarray(P), jnp.asarray(q), jnp.asarray(ws), KINDS[kind],
        tuple(jnp.asarray(a) for a in pa), cfg, qcqp_stopping=qstop,
        damp_both=not qstop, interpret=True, tile_b=128,
    )
    lt, st = tk.admm_solve_plain(
        torch.from_numpy(P), torch.from_numpy(q), torch.from_numpy(ws),
        KINDS[kind], tuple(torch.from_numpy(a) for a in pa),
        _port_cfg(cfg), qstop, not qstop,
    )
    return (np.asarray(lj), sj), (lt.numpy(), st)


def _assert_parity(out_j, out_t, atol=2e-5):
    (lj, sj), (lt, st) = out_j, out_t
    assert lt.dtype == np.float32
    np.testing.assert_allclose(lt, lj, atol=atol, rtol=0)
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
    np.testing.assert_array_equal(st.stalled.numpy(), np.asarray(sj.stalled))
    it_j = np.asarray(sj.iterations)
    it_t = st.iterations.numpy()
    assert int(np.abs(it_t - it_j).max()) <= 1, (it_j, it_t)
    assert np.all(np.isfinite(st.res_prim.numpy()) == np.isfinite(np.asarray(sj.res_prim)))


@pytest.mark.parametrize("kind", ["nonneg", "box", "signed_box", "disk"])
def test_plain_matches_jax_kernel_f32(kind):
    P, q, pa = _problems(0, 20, 8, np.float32)
    cfg = QCFG if kind == "disk" else CFG
    factors = torch.zeros(20, dtype=torch.int64)
    out_t = _plain(P, q, kind, pa[kind], cfg, factors=factors)
    _assert_parity(_jax_kernel_on_problems(kind, cfg), out_t)
    assert out_t[1].converged.all() and bool((factors >= 1).all())
    if kind == "disk":
        pts = out_t[0].reshape(20, 4, 2)
        assert np.all(np.linalg.norm(pts, axis=-1) <= pa["disk"][0] + 1e-5)


@pytest.mark.parametrize("kind", ["nonneg", "box", "signed_box", "disk"])
def test_plain_matches_jax_kernel_f32_at_the_stall_floor(kind):
    """The regime where an unrefined float32 inverse moved the nonneg
    problems' rho schedule (8.7e-5 off the JAX kernel): the refinement's
    float64 residual keeps the trajectory on the JAX kernel's."""
    P, q, pa = _problems(0, 20, 8, np.float32)
    cfg = QCFG6 if kind == "disk" else CFG6
    lt, st = _plain(P, q, kind, pa[kind], cfg)
    lj, sj = _jax_kernel_on_problems(kind, cfg)
    np.testing.assert_allclose(lt, lj, atol=2e-5, rtol=0)
    assert st.converged.all() and bool(np.all(np.asarray(sj.converged)))
    assert st.stalled.any()                 # this is the floor regime


def test_plain_matches_jax_kernel_padding_case():
    """n=6: the JAX kernel pads to 8 rows; the port does not pad."""
    P, q, pa = _problems(1, 8, 6, np.float32)
    out_j, out_t = _run_both(P, q, np.zeros_like(q), "nonneg", (), CFG)
    _assert_parity(out_j, out_t)


def test_plain_matches_jax_kernel_warm_start_dual():
    P, q, _ = _problems(0, 20, 8, np.float32)
    l0, _ = tk.admm_solve_plain(
        torch.from_numpy(P), torch.from_numpy(q), torch.zeros(20, 8),
        tk.PROX_NONNEG, (), _port_cfg(CFG),
    )
    out_j, out_t = _run_both(P, q, l0.numpy(), "nonneg", (),
                             CFG.replace(warm_start_dual=True))
    _assert_parity(out_j, out_t)
    assert int(out_t[1].iterations.max()) <= 8


def test_plain_matches_jax_kernel_staggered_schedule():
    """rho_sync=False: the per-problem cpt % period gate."""
    P, q, _ = _problems(0, 20, 8, np.float32)
    out_j, out_t = _run_both(P, q, np.zeros_like(q), "nonneg", (),
                             CFG.replace(rho_sync=False))
    _assert_parity(out_j, out_t)


def test_plain_matches_jax_kernel_max_iter_cap():
    P, q, pa = _problems(0, 20, 8, np.float32)
    out_j, out_t = _run_both(P, q, np.zeros_like(q), "disk", pa["disk"],
                             QCFG.replace(max_iter=2))
    _assert_parity(out_j, out_t)
    st = out_t[1]
    assert not st.converged.any()
    assert torch.all(st.iterations == 2)
    np.testing.assert_allclose(st.rho.numpy(), np.asarray(out_j[1].rho), rtol=1e-6)


@pytest.mark.parametrize("kind", ["nonneg", "box", "signed_box", "disk"])
def test_plain_matches_xla_engine_f64(kind):
    P, q, pa = _problems(0, 20, 8, np.float64)
    ws = np.zeros_like(q)
    qstop = kind == "disk"
    cfg = (QCFG6 if qstop else CFG6).replace(eps=1e-10)
    ja = tuple(jnp.asarray(a) for a in pa[kind])
    prox = {
        "nonneg": prox_nonneg,
        "box": lambda x: prox_box(x, *ja),
        "signed_box": lambda x: prox_signed_box(x, *ja),
        "disk": lambda x: prox_disk(x, *ja),
    }[kind]
    lj, sj = admm_solve(jnp.asarray(P), jnp.asarray(q), jnp.asarray(ws), prox,
                        cfg, qcqp_stopping=qstop, damp_both_taus=not qstop)
    lt, st = tk.admm_solve_plain(
        torch.from_numpy(P), torch.from_numpy(q), torch.from_numpy(ws),
        KINDS[kind], tuple(torch.from_numpy(a) for a in pa[kind]),
        _port_cfg(cfg), qstop, not qstop,
    )
    assert lt.dtype == torch.float64
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-11, rtol=0)
    assert st.converged.all() and bool(np.all(np.asarray(sj.converged)))
    np.testing.assert_array_equal(st.stalled.numpy(), np.asarray(sj.stalled))
    assert int(np.abs(st.iterations.numpy() - np.asarray(sj.iterations)).max()) <= 1


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    P, q, pa = _problems(2, 6, 8, np.float32)
    args = (torch.from_numpy(P), torch.from_numpy(q), torch.zeros(6, 8),
            tk.PROX_DISK, (torch.from_numpy(pa["disk"][0]),), _port_cfg(QCFG),
            True, False)
    before = tk.admm_solve_cuda.launches
    lw, sw = tk.admm_solve_cuda(*args)
    lp, sp = tk.admm_solve_plain(*args)
    assert torch.equal(lw, lp) and torch.equal(sw.iterations, sp.iterations)
    assert tk.admm_solve_cuda.launches == before


@pytest.mark.parametrize("bad", ["P_shape", "ws_shape", "radius_shape", "n_args", "kind"])
def test_wrapper_checks_its_inputs(bad):
    P, q, pa = _problems(2, 4, 8, np.float32)
    P, q = torch.from_numpy(P), torch.from_numpy(q)
    ws = torch.zeros_like(q)
    kind, args = tk.PROX_DISK, (torch.from_numpy(pa["disk"][0]),)
    if bad == "P_shape":
        P = P[:, :7, :7]
    elif bad == "ws_shape":
        ws = ws[:3]
    elif bad == "radius_shape":
        args = (args[0][:, :3],)
    elif bad == "n_args":
        args = ()
    else:
        kind = 7
    with pytest.raises(ValueError):
        tk.admm_solve_cuda(P, q, ws, kind, args, _port_cfg(QCFG), True, False)


def test_prox_kind_codes_match_jax():
    assert (tk.PROX_NONNEG, tk.PROX_BOX, tk.PROX_SIGNED_BOX, tk.PROX_DISK) == (
        jk.PROX_NONNEG, jk.PROX_BOX, jk.PROX_SIGNED_BOX, jk.PROX_DISK)


def test_smem_bytes_bounds():
    # one warp and ~5 KB at the flagship N=24; N=112 (the JAX kernel's auto
    # bound) fits the 227 KB a Hopper block may opt into
    assert tk.smem_bytes(24) < 48 * 1024
    assert tk.smem_bytes(112) <= 232448


# ---------------------------------------------------------------------------
# Shared by the tests above and below
# ---------------------------------------------------------------------------

_JAX = {}


def _jax_kernel_on_problems(kind, cfg):
    """The JAX kernel's result on _problems(0, 20, 8) (cached: the tests of
    both paths compare against the same run)."""
    if (kind, cfg) not in _JAX:
        P, q, pa = _problems(0, 20, 8, np.float32)
        qstop = kind == "disk"
        lj, sj = jk.admm_solve_pallas(
            jnp.asarray(P), jnp.asarray(q), jnp.zeros_like(jnp.asarray(q)), KINDS[kind],
            tuple(jnp.asarray(a) for a in pa[kind]), cfg, qcqp_stopping=qstop,
            damp_both=not qstop, interpret=True, tile_b=128,
        )
        _JAX[(kind, cfg)] = (np.asarray(lj), sj)
    return _JAX[(kind, cfg)]


def _plain(P, q, kind, pa, cfg, **kw):
    qstop = kind == "disk"
    lt, st = tk.admm_solve_plain(
        torch.from_numpy(P), torch.from_numpy(q), torch.zeros_like(torch.from_numpy(q)),
        KINDS[kind], tuple(torch.from_numpy(a) for a in pa), _port_cfg(cfg), qstop, not qstop, **kw)
    return lt.numpy(), st


@pytest.mark.parametrize("n", [8, 34], ids=["n8", "n34"])
@pytest.mark.parametrize("kind", ["box", "disk"])
def test_inverse_path_matches_xla_engine_f64(kind, n):
    """float64 against the XLA engine (eps = 1e-10, lmax by power
    iteration) on another seed: atol 1e-11 and iterations within 1, at one
    warp (n = 8) and past it (n = 34)."""
    P, q, pa = _problems(3, 12, n, np.float64)
    qstop = kind == "disk"
    cfg = (QCFG6 if qstop else CFG6).replace(eps=1e-10)
    ja = tuple(jnp.asarray(a) for a in pa[kind])
    prox = (lambda x: prox_box(x, *ja)) if kind == "box" else (lambda x: prox_disk(x, *ja))
    lj, sj = admm_solve(jnp.asarray(P), jnp.asarray(q), jnp.zeros_like(jnp.asarray(q)), prox,
                        cfg, qcqp_stopping=qstop, damp_both_taus=not qstop)
    lt, st = _plain(P, q, kind, pa[kind], cfg)
    assert lt.dtype == np.float64
    np.testing.assert_allclose(lt, np.asarray(lj), atol=1e-11, rtol=0)
    assert st.converged.all() and bool(np.all(np.asarray(sj.converged)))
    assert int(np.abs(st.iterations.numpy() - np.asarray(sj.iterations)).max()) <= 1


def test_inverse_path_f32_at_n34_matches_xla_engine():
    """float32 past one warp against the XLA engine at eps = 1e-5 (the JAX
    kernel in interpret mode takes ~1 min at this n): atol 2e-5 and
    iterations within 1, the kernel-against-engine bar of the JAX suite."""
    P, q, pa = _problems(4, 8, 34, np.float32)
    cfg = QCFG
    ja = (jnp.asarray(pa["disk"][0]),)
    lj, sj = admm_solve(jnp.asarray(P), jnp.asarray(q), jnp.zeros_like(jnp.asarray(q)),
                        lambda x: prox_disk(x, *ja), cfg, qcqp_stopping=True, damp_both_taus=False)
    lt, st = _plain(P, q, "disk", pa["disk"], cfg)
    np.testing.assert_allclose(lt, np.asarray(lj), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
    assert int(np.abs(st.iterations.numpy() - np.asarray(sj.iterations)).max()) <= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_gj_inverse_and_refined_solve(dtype):
    """gj_inverse against torch.linalg.inv (float64 1e-12; float32 within
    64 cond eps); _refined_solve's residual taken in float64 brings a float32
    solve to about float32 rounding of the float64 solution."""
    P, _, _ = _problems(5, 6, 9, np.float64)
    shift = torch.rand(6, dtype=torch.float64) + 0.1
    Pt = torch.from_numpy(P)
    M = Pt + shift[:, None, None] * torch.eye(9, dtype=torch.float64)
    ref = torch.linalg.inv(M)
    X = tk.gj_inverse(Pt.to(dtype), shift.to(dtype))
    cond = float(torch.linalg.cond(M).max())
    bar = 1e-12 if dtype == torch.float64 else 64 * cond * 1.2e-7
    assert float((X.double() - ref).abs().max() / ref.abs().max()) <= bar
    rhs = torch.from_numpy(np.random.default_rng(6).standard_normal((6, 9)))
    x64 = torch.linalg.solve(M, rhs[..., None])[..., 0]
    x = tk._refined_solve(Pt.to(dtype), X, rhs.to(dtype), shift.to(dtype))
    assert x.dtype == dtype
    scale = float(x64.abs().max())
    assert float((x.double() - x64).abs().max()) <= (1e-13 if dtype == torch.float64 else 2e-6) * scale


def test_fma_rounds_once_as_the_kernel():
    """``_fma`` (the kernel's fmaf in the plain version) gives the float32
    nearest to the exact a b + c, which a product rounded before the sum
    misses on some inputs."""
    from fractions import Fraction

    rng = np.random.default_rng(7)
    a, b, c = (rng.standard_normal(3000).astype(np.float32) for _ in range(3))
    got = tk._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(Fraction(float(r)) - exact)
        for nb in (np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))):
            assert err <= abs(Fraction(float(nb)) - exact)
    assert np.any(got != (a * b) + c)
    assert tk._fma(*(torch.from_numpy(x).double() for x in (a, b, c))).dtype == torch.float64


@pytest.mark.parametrize("n", [7, 32, 40, 96])
def test_block_sum_adds_in_the_kernel_order(n):
    """``_block_sum`` against the kernel's block_reduce written out: within
    each warp of 32 rows the butterfly (lane i adds lane i ^ o for o = 16,
    8, 4, 2, 1; rows past n hold 0), then the warps' sums in order; float32
    bit for bit."""
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32) * 1e3
    got = tk._block_sum(torch.from_numpy(x)).numpy()
    nw = -(-n // 32)
    for row, g in zip(x, got):
        lanes = np.zeros(32 * nw, dtype=np.float32)
        lanes[:n] = row
        sums = []
        for w in range(nw):
            v = list(lanes[32 * w : 32 * w + 32])
            for o in (16, 8, 4, 2, 1):
                v = [np.float32(v[i] + v[i ^ o]) for i in range(32)]
            sums.append(v[0])
        acc = sums[0]
        for s_ in sums[1:]:
            acc = np.float32(acc + s_)
        assert acc == g
