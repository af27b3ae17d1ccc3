"""Kernel K6's plain version and the QCQP's generic adjoint route (duals
given) of the port against the JAX package.

  * ``qcqp_kkt_bwd_plain`` against ``qcqp_kkt_bwd_pallas(interpret=True)`` in
    float32, both fed the same gamma, s and strict mask from the JAX
    package's ``qcqp_dual`` / ``qcqp_strict_active``, at nc = 3, 4 (30 % zero
    radii) and 5, B = 12, with the bars of tests/test_qcqp_bwd_kernel.py: dl
    atol 5e-5, dgamma atol 2e-4.
  * ``_qcqp_schur_vjp`` against the JAX one in float64 (1e-9), both a
    Cholesky and an LU; in float32 the port's route runs K6 (its plain
    version here, an LDL^T and a Householder QR), held against the JAX
    float64 route with the kernel bars (dl 5e-5, dgamma 2e-4); past K6's
    bound its float32 branch (a Newton-Schulz inverse of D) against the
    JAX float32 branch, with the same bars.
  * ``qcqp_vjp(duals=)`` against the JAX one in float64 on both sides of the
    route's bound, B = 2: nc = 29 (m = nc + n = 87, the assembled system) and
    nc = 30 (m = 90, the Schur route), and the route each size takes;
    ``box_vjp(duals=)`` against the JAX one in float64. atol 1e-9 max(1,
    |.|_inf).
  * K6's plain version fed K2's own gamma, s and strict mask gives K2's plain
    dl and dgamma (the two share steps 4-8): equal to 1e-12 in float64 and
    1e-6 of scale in float32.
  * K6's wrapper: its CPU dispatch and its input checks.

The problems are exact KKT points built in float64: each contact binds
(|l_c| = r_c, gamma_c > 0) or sits strictly inside its disk (gamma_c = 0),
and q = -(P l + 2 gamma_c l_c) makes l stationary, so the duals are known
and no solver runs (the box's points likewise). Both sides get the same
numpy inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu.diff.kkt as K
from diffqcqp_tpu.config import QCQP_DEFAULTS
from diffqcqp_tpu.kernels.qcqp_bwd_pallas import qcqp_kkt_bwd_pallas
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.diff import kkt as TK
from diffqcqp_tpu_torch.kernels import qcqp_bwd_cuda as tk

CFG = QCQP_DEFAULTS.replace(eps=1e-8, backend="xla")
TCFG = dqt.SolverConfig.from_dict(dataclasses.asdict(CFG))
CASES = {"nc3": (3, 0.0), "nc4_zero_radii": (4, 0.3), "nc5": (5, 0.0)}

T = torch.from_numpy
J = jnp.asarray


def _qcqp_point(seed, b, nc, zero_frac=0.0):
    """(P, q, l, g, radius) in float64: 70 % of the contacts binding with
    gamma ~ U(0.2, 1), the rest inside their disk at 20-80 % of the radius,
    ``zero_frac`` of the radii 0 (l_c = 0 there)."""
    rng = np.random.default_rng(seed)
    n = 2 * nc
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    r = rng.random((b, nc)) * 0.3 + 0.05
    r = np.where(rng.random((b, nc)) < zero_frac, 0.0, r)
    bind = rng.random((b, nc)) < 0.7
    rho = np.where(bind, 1.0, rng.random((b, nc)) * 0.6 + 0.2)
    th = rng.random((b, nc)) * 2 * np.pi
    l = np.stack([r * rho * np.cos(th), r * rho * np.sin(th)], axis=-1).reshape(b, n)
    gam = np.where(bind & (r > 0), rng.random((b, nc)) * 0.8 + 0.2, 0.0)
    q = -np.einsum("bij,bj->bi", P, l) - 2.0 * np.repeat(gam, 2, axis=-1) * l
    return P, q, l, rng.standard_normal((b, n)), r


def _jax_duals(P, q, l, r):
    """gamma, s and the strict mask from the JAX package, as numpy."""
    d = K.qcqp_dual(J(P), J(q), J(r), J(l), CFG)
    s, active = K.qcqp_strict_active(J(l), J(r), d.gamma, CFG)
    return np.array(d.gamma), np.array(s), np.array(active)


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def case(request):
    nc, zero_frac = CASES[request.param]
    return _qcqp_point(nc, 12, nc, zero_frac)


def test_cases_cover_inactive_and_zero_radius_contacts(case):
    P, q, l, _, r = case
    _, _, active = _jax_duals(P, q, l, r)
    assert 0.4 < active.mean() < 0.95
    if (r == 0).any():
        assert not active[r == 0].any()


def test_plain_k6_matches_jax_kernel_f32(case):
    P, q, l, g, r = (x.astype(np.float32) for x in case)
    gam, s, active = _jax_duals(P, q, l, r)
    dgj, dlj = (np.asarray(x) for x in qcqp_kkt_bwd_pallas(
        J(P), J(l), J(g), J(gam), J(s), J(active), interpret=True))
    dg, dl = tk.qcqp_kkt_bwd_plain(*(T(x) for x in (P, l, g, gam, s, active)))
    assert dl.dtype == torch.float32
    np.testing.assert_array_equal(dg.numpy() == 0, dgj == 0)
    np.testing.assert_allclose(dl.numpy(), dlj, atol=5e-5, rtol=0)
    np.testing.assert_allclose(dg.numpy(), dgj, atol=2e-4, rtol=0)


def test_schur_vjp_matches_jax_f64(case):
    P, q, l, g, r = case
    gam, s, active = _jax_duals(P, q, l, r)
    nc, n = r.shape[-1], l.shape[-1]
    am = active.astype(np.float64)
    want = K._qcqp_schur_vjp(J(P), J(l), J(g), J(s), J(am), J(gam), nc, n)
    got = TK._qcqp_schur_vjp(*(T(x) for x in (P, l, g, s, am, gam)))
    assert got.dl.dtype == torch.float64
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9, rtol=0)


def test_schur_vjp_f32_runs_k6_and_matches_jax_f64(case, monkeypatch):
    """In float32 the route is K6 (its plain version on a CPU tensor), fed
    the float mask as it is; against the JAX float64 route with the kernel
    bars of tests/test_qcqp_bwd_kernel.py."""
    P, q, l, g, r = case
    gam, s, active = _jax_duals(P, q, l, r)
    nc, n = r.shape[-1], l.shape[-1]
    am = active.astype(np.float64)
    want = K._qcqp_schur_vjp(J(P), J(l), J(g), J(s), J(am), J(gam), nc, n)
    masks = []
    monkeypatch.setattr(TK, "qcqp_kkt_bwd_cuda",
                        lambda *a: masks.append(a[-1].dtype) or tk.qcqp_kkt_bwd_cuda(*a))
    got = TK._qcqp_schur_vjp(*(T(x.astype(np.float32)) for x in (P, l, g, s, am, gam)))
    assert masks == [torch.float32] and got.dl.dtype == torch.float32
    np.testing.assert_allclose(got.dl.numpy(), np.asarray(want.dl), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got.dgamma.numpy(), np.asarray(want.dgamma), atol=2e-4, rtol=0)


def _schur_f32_past_k6(P, l, g, s, am, gam, monkeypatch):
    """The port's float32 Schur route with K6 out of the way (any call of it
    fails the test): the Newton-Schulz inverse of D, then the nc x nc
    solve."""
    def no_k6(*a):
        raise AssertionError("K6 ran past its bound")

    monkeypatch.setattr(TK, "qcqp_kkt_bwd_cuda", no_k6)
    return TK._qcqp_schur_vjp(*(T(x.astype(np.float32)) for x in (P, l, g, s, am, gam)))


@pytest.mark.parametrize("nc", [4, 76], ids=["nc4_bound_moved", "nc76_past_k6"])
def test_schur_vjp_f32_past_k6_matches_jax_f32(nc, monkeypatch):
    """Past K6's bound (n > 150; at nc = 4 the bound is moved below n) the
    float32 route is the JAX package's own float32 branch: D^{-1} by the
    Newton-Schulz inverse (``_spd_inverse_f32``), then the nc x nc solve.
    Held against that JAX branch in float32 on the same inputs with the
    kernel bars of tests/test_qcqp_bwd_kernel.py (dl 5e-5, dgamma 2e-4)."""
    P, q, l, g, r = _qcqp_point(60 + nc, 2 if nc > 8 else 12, nc, 0.3 if nc < 8 else 0.0)
    gam, s, active = _jax_duals(P, q, l, r)
    n = 2 * nc
    if nc < 8:
        monkeypatch.setattr(tk, "fits", lambda n_: n_ < n)
    assert not tk.fits(n)
    am = active.astype(np.float64)
    f32 = [x.astype(np.float32) for x in (P, l, g, s, am, gam)]
    want = K._qcqp_schur_vjp(*map(J, f32), nc, n)
    got = _schur_f32_past_k6(P, l, g, s, am, gam, monkeypatch)
    assert got.dl.dtype == torch.float32 and 0 < active.mean() < 1
    np.testing.assert_allclose(got.dl.numpy(), np.asarray(want.dl), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got.dgamma.numpy(), np.asarray(want.dgamma), atol=2e-4, rtol=0)


def _close(got, want, bar):
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=bar * max(1.0, float(np.abs(b).max())), rtol=0)


@pytest.mark.parametrize("nc,route", [(29, "assembled"), (30, "schur")])
def test_qcqp_vjp_with_duals_matches_jax_f64(nc, route, monkeypatch):
    P, q, l, g, r = _qcqp_point(40 + nc, 2, nc)
    jd = K.qcqp_dual(J(P), J(q), J(r), J(l), CFG)
    want = K.qcqp_vjp(J(P), J(q), J(r), J(l), J(g), CFG, duals=jd)
    Pt, qt, lt, gt, rt = (T(x) for x in (P, q, l, g, r))
    duals = TK.qcqp_dual(Pt, qt, rt, lt, TCFG)
    taken = []
    for name in ("_qcqp_schur_vjp", "_qcqp_assembled_vjp"):
        fn = getattr(TK, name)
        monkeypatch.setattr(TK, name, lambda *a, _f=fn, _n=name: taken.append(_n) or _f(*a))
    got = TK.qcqp_vjp(Pt, qt, rt, lt, gt, TCFG, duals=duals)
    assert taken == [f"_qcqp_{route}_vjp"]
    assert 0 < float(duals.active.double().mean()) < 1
    _close(got, want, 1e-9)


def test_box_vjp_with_duals_matches_jax_f64():
    rng = np.random.default_rng(50)
    b, n = 3, 8
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    lo, hi = -(rng.random((b, n)) * 0.4 + 0.1), rng.random((b, n)) * 0.4 + 0.1
    u = rng.random((b, n))
    l = np.where(u < 0.3, lo, np.where(u < 0.6, hi, lo + (hi - lo) * rng.random((b, n))))
    g_lo, g_hi = np.where(u < 0.3, 0.5, 0.0), np.where((u >= 0.3) & (u < 0.6), 0.7, 0.0)
    q = -np.einsum("bij,bj->bi", P, l) + g_lo - g_hi       # P l + q + J^T gamma = 0
    g = rng.standard_normal((b, n))
    jx = tuple(map(J, (P, q, lo, hi, l, g)))
    want = K.box_vjp(*jx, CFG, duals=K.box_dual(*jx[:5], CFG))
    tx = tuple(map(T, (P, q, lo, hi, l, g)))
    got = TK.box_vjp(*tx, TCFG, duals=TK.box_dual(*tx[:5], TCFG))
    assert float((got.dgamma != 0).double().mean()) > 0.2
    _close(got, want, 1e-9)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_plain_k6_fed_k2_duals_gives_k2(case, dtype):
    P, q, l, g, r = (T(x.astype(dtype)) for x in case)
    ulps = 8.0 * float(np.finfo(dtype).eps)
    dg2, dl2, gam2 = tk.qcqp_kkt_bwd_fused_plain(P, q, l, g, r, CFG.eps, CFG.act_eps, ulps)
    s, active = TK.qcqp_strict_active(l, r, gam2, TCFG)
    dg6, dl6 = tk.qcqp_kkt_bwd_plain(P, l, g, gam2, s, active)
    bar = 1e-12 if dtype == np.float64 else 1e-6
    for a, b in ((dl6, dl2), (dg6, dg2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=bar * max(1.0, float(b.abs().max())),
                                   rtol=0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing(case):
    P, q, l, g, r = (x.astype(np.float32) for x in case)
    args = tuple(T(x) for x in (P, l, g, *_jax_duals(P, q, l, r)))
    before = tk.qcqp_kkt_bwd_cuda.launches
    out_w, out_p = tk.qcqp_kkt_bwd_cuda(*args), tk.qcqp_kkt_bwd_plain(*args)
    out_f = tk.qcqp_kkt_bwd_cuda(*args[:5], args[5].to(torch.float32))
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(out_w, out_p, out_f))
    assert tk.qcqp_kkt_bwd_cuda.launches == before


@pytest.mark.parametrize("bad", ["P_shape", "g_shape", "gamma_shape", "odd_n", "int_mask",
                                 "mixed_dtype"])
def test_wrapper_checks_its_inputs(bad):
    P, l, g = torch.eye(8).expand(2, 8, 8).contiguous(), torch.ones(2, 8), torch.ones(2, 8)
    gam, s, act = torch.ones(2, 4), torch.zeros(2, 4), torch.ones(2, 4, dtype=torch.bool)
    err = ValueError
    if bad == "P_shape":
        P = P[:, :6, :6]
    elif bad == "g_shape":
        g = g[:1]
    elif bad == "gamma_shape":
        gam = gam[:, :3]
    elif bad == "odd_n":
        P, l, g = P[:, :7, :7], l[:, :7], g[:, :7]
    elif bad == "int_mask":
        act, err = act.int(), TypeError
    else:
        s, err = s.double(), TypeError
    with pytest.raises(err):
        tk.qcqp_kkt_bwd_cuda(P, l, g, gam, s, act)
