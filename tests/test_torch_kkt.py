"""The QCQP backward of the port against the JAX package, module by module.

  * ``qcqp_dual`` / ``qcqp_strict_active`` against ``diff/kkt.py``'s, at
    float64 (atol 1e-12) and float32 (atol and rtol 1e-6 on gamma, equal
    masks).
  * K2's plain version (``qcqp_kkt_bwd_fused_plain``) against the JAX kernel
    ``qcqp_kkt_bwd_fused(interpret=True)`` in float32, at nc = 3, 4 (30 % zero
    radii, 30 % of the radii 50 times wider, which leaves contacts inactive)
    and 12, B = 12, with the JAX suite's bars (tests/test_qcqp_bwd_kernel.py)
    scaled per problem: dl 5e-5 * max(1, |dl_b|_inf), dgamma 2e-4 * max(1,
    |dgamma_b|_inf) (dgamma solves an
    nc x nc system; at nc=12 it reaches several units where the suite's nc
    <= 5 stays below 1), gamma 1e-4, and the same strict mask. Both run at
    the main path's eps=1e-7 (bench.py): at that suite's eps=1e-8, about one
    float32 ulp of a radius ~0.1, the recovery's slack test r - ||l_c|| <=
    eps on a binding contact is decided by rounding, and 4 of the 144
    contacts at nc=12 flip between the two float32 implementations.
  * The same plain version in float64 against the JAX generic path
    ``qcqp_vjp(backend="xla")`` (assembled LU): atol 1e-9; the port's
    assembled branch (``duals`` given) against it: atol 1e-10.
  * ``chol_factor`` with a per-row shift against a dense Cholesky, and the
    K2 wrapper's CPU dispatch and input checks.

The problems are tests/test_qcqp_bwd_kernel.py's, solved by the JAX package
at eps=1e-9; both sides get the same numpy l and cotangent g.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
import diffqcqp_tpu.diff.kkt as K
from diffqcqp_tpu.config import QCQP_DEFAULTS
from diffqcqp_tpu.kernels.qcqp_bwd_pallas import qcqp_kkt_bwd_fused
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.diff import kkt as TK
from diffqcqp_tpu_torch.kernels import qcqp_bwd_cuda as tk
from diffqcqp_tpu_torch.kernels.ldl import chol_factor

CFG = QCQP_DEFAULTS.replace(eps=1e-8, backend="xla")
EPS32 = 1e-7                       # bench.py's eps, the float32 main path's
TCFG = dqt.SolverConfig.from_dict(dataclasses.asdict(CFG))
F32_ULPS = 8.0 * float(np.finfo(np.float32).eps)
CASES = {"nc3": (3, 0.0, 0.0), "nc4_degenerate": (4, 0.3, 0.3), "nc12": (12, 0.0, 0.0)}


def _problem(seed, b, nc, zero_frac, wide_frac):
    """Random SPD QCQPs; ``zero_frac`` of the radii set to 0 and
    ``wide_frac`` of them made 50 times wider, which leaves most of those
    contacts strictly inside their cone (shifting q would not: any force
    still presses on a disk)."""
    rng = np.random.default_rng(seed)
    n = 2 * nc
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = rng.standard_normal((b, n)) * 0.5
    l_n = rng.random((b, nc)) * 0.5 + 0.05
    l_n = np.where(rng.random((b, nc)) < wide_frac, 50.0 * l_n, l_n)
    l_n = np.where(rng.random((b, nc)) < zero_frac, 0.0, l_n)
    mu = rng.random((b, nc)) * 0.5 + 0.05
    P, q, l_n, mu = (x.astype(np.float32) for x in (P, q, l_n, mu))
    l = np.asarray(dq.solve_qcqp(*map(jnp.asarray, (P, q, l_n, mu)), eps=1e-9, max_iter=5000))
    g = rng.standard_normal(l.shape).astype(np.float32)
    return P, q, l, g, l_n * mu


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def case(request):
    return _problem(0, 12, *CASES[request.param])


@pytest.fixture(scope="module")
def jax_fused(case):
    P, q, l, g, r = case
    out = qcqp_kkt_bwd_fused(*map(jnp.asarray, case), eps=EPS32, act_eps=CFG.act_eps,
                             stall_ulps=F32_ULPS, interpret=True)
    return tuple(np.asarray(x) for x in out)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def test_cases_cover_inactive_and_zero_radius_contacts(case, jax_fused):
    _, _, _, _, r = case
    active = jax_fused[0] != 0
    if r.shape[-1] == 4:
        assert (r == 0).any() and not active[r == 0].any()
        assert ((r > 0) & ~active).sum() >= 3
    else:
        assert active.mean() > 0.8


def test_plain_k2_matches_jax_kernel_f32(case, jax_fused):
    dg, dl, gam = tk.qcqp_kkt_bwd_fused_plain(*_t(*case), EPS32, CFG.act_eps, F32_ULPS)
    assert dl.dtype == torch.float32
    dgj, dlj, gamj = jax_fused
    np.testing.assert_array_equal(dg.numpy() == 0, dgj == 0)      # same strict mask
    for got, want, bar in ((dl.numpy(), dlj, 5e-5), (dg.numpy(), dgj, 2e-4)):
        scale = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
        assert np.all(np.abs(got - want) <= bar * scale)
    np.testing.assert_allclose(gam.numpy(), gamj, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def f64_case(case):
    x64 = tuple(x.astype(np.float64) for x in case)
    P, q, l, g, r = x64
    ref = K.qcqp_vjp(*map(jnp.asarray, (P, q, r, l, g)), CFG)
    return x64, tuple(np.asarray(x) for x in (ref.dl, ref.dgamma, ref.gamma))


def test_plain_k2_matches_jax_generic_path_f64(f64_case):
    (P, q, l, g, r), (dlj, dgj, gamj) = f64_case
    dg, dl, gam = tk.qcqp_kkt_bwd_fused_plain(
        *_t(P, q, l, g, r), CFG.eps, CFG.act_eps, 8.0 * float(np.finfo(np.float64).eps))
    assert dl.dtype == torch.float64
    np.testing.assert_allclose(dl.numpy(), dlj, atol=1e-9, rtol=0)
    np.testing.assert_allclose(dg.numpy(), dgj, atol=1e-9, rtol=0)
    np.testing.assert_allclose(gam.numpy(), gamj, atol=1e-9, rtol=0)


def test_qcqp_vjp_dispatch_matches_jax_generic_path_f64(f64_case):
    """Without duals a float64 qcqp_vjp takes the generic route, as the JAX
    package's: qcqp_dual, then the assembled system."""
    (P, q, l, g, r), (dlj, dgj, _) = f64_case
    Pt, qt, lt, gt, rt = _t(P, q, l, g, r)
    out = TK.qcqp_vjp(Pt, qt, rt, lt, gt, TCFG)
    np.testing.assert_allclose(out.dl.numpy(), dlj, atol=1e-9, rtol=0)
    np.testing.assert_allclose(out.dgamma.numpy(), dgj, atol=1e-9, rtol=0)


def test_assembled_branch_matches_jax_generic_path_f64(f64_case):
    (P, q, l, g, r), (dlj, dgj, gamj) = f64_case
    Pt, qt, lt, gt, rt = _t(P, q, l, g, r)
    duals = TK.qcqp_dual(Pt, qt, rt, lt, TCFG)
    out = TK.qcqp_vjp(Pt, qt, rt, lt, gt, TCFG, duals=duals)
    np.testing.assert_allclose(out.dl.numpy(), dlj, atol=1e-10, rtol=0)
    np.testing.assert_allclose(out.dgamma.numpy(), dgj, atol=1e-10, rtol=0)
    np.testing.assert_allclose(out.gamma.numpy(), gamj, atol=1e-10, rtol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_dual_and_strict_active_match_jax(case, dtype):
    P, q, l, _, r = (x.astype(dtype) for x in case)
    dj = K.qcqp_dual(*map(jnp.asarray, (P, q, r, l)), CFG)
    sj, aj = K.qcqp_strict_active(jnp.asarray(l), jnp.asarray(r), dj.gamma, CFG)
    Pt, qt, lt, rt = _t(P, q, l, r)
    dt = TK.qcqp_dual(Pt, qt, rt, lt, TCFG)
    st, at = TK.qcqp_strict_active(lt, rt, dt.gamma, TCFG)
    atol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(dt.gamma.numpy(), np.asarray(dj.gamma), atol=atol, rtol=atol)
    np.testing.assert_array_equal(dt.active.numpy(), np.asarray(dj.active))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=atol, rtol=0)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_radius_factors_match_jax():
    rng = np.random.default_rng(5)
    l_n, mu, gam = (rng.random((4, 3)) for _ in range(3))
    ej = K.qcqp_radius_factors(*map(jnp.asarray, (l_n, mu, gam)))
    et = TK.qcqp_radius_factors(*_t(l_n, mu, gam))
    for a, b in zip(et, ej):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15)


def test_chol_factor_per_row_shift_matches_dense():
    rng = np.random.default_rng(2)
    S = rng.standard_normal((3, 8, 8))
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(8)
    shift = rng.random((3, 8))
    L = chol_factor(*_t(P, shift))
    ref = np.linalg.cholesky(P + shift[:, :, None] * np.eye(8))
    np.testing.assert_allclose(L.numpy(), ref, atol=1e-12, rtol=0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing(case):
    args = _t(*case) + (EPS32, CFG.act_eps, F32_ULPS)
    before = tk.qcqp_kkt_bwd_fused_cuda.launches
    out_w = tk.qcqp_kkt_bwd_fused_cuda(*args)
    out_p = tk.qcqp_kkt_bwd_fused_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(out_w, out_p))
    assert tk.qcqp_kkt_bwd_fused_cuda.launches == before


@pytest.mark.parametrize("bad", ["P_shape", "g_shape", "radius_shape", "odd_n", "mixed_dtype", "int_dtype"])
def test_wrapper_checks_its_inputs(bad):
    rng = np.random.default_rng(0)
    P = torch.eye(8).expand(2, 8, 8).contiguous()
    q, l, g = (torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)) for _ in range(3))
    r = torch.ones(2, 4)
    err = ValueError
    if bad == "P_shape":
        P = P[:, :6, :6]
    elif bad == "g_shape":
        g = g[:1]
    elif bad == "radius_shape":
        r = r[:, :3]
    elif bad == "odd_n":
        P, q, l, g = P[:, :7, :7], q[:, :7], l[:, :7], g[:, :7]
    elif bad == "mixed_dtype":
        q, err = q.double(), TypeError
    else:
        P, q, l, g, r = (x.to(torch.int32) for x in (P, q, l, g, r))
        err = TypeError
    with pytest.raises(err):
        tk.qcqp_kkt_bwd_fused_cuda(P, q, l, g, r, 1e-8, 1e-10, F32_ULPS)


def test_smem_bytes_bounds():
    # ~7 KB at the flagship N=24 (one warp); N=96 opts in above 48 KB and
    # fits the 227 KB a Hopper block may use
    assert tk.smem_bytes(24) < 8 * 1024
    assert 48 * 1024 < tk.smem_bytes(96) <= 232448
