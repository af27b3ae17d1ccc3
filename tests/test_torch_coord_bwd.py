"""The QP family's backward in the port against the JAX package, module by
module.

  * K4's plain version (``coord_kkt_bwd_fused_plain``) against the JAX kernel
    ``coord_kkt_bwd_fused(interpret=True)`` in float32, for the three kinds at
    B = 12 and n = 6, 8, 11, with tests/test_coord_bwd_kernel.py's bars (dl
    atol 5e-5; dgamma atol 2e-4, rtol 2e-3; gamma atol 5e-5) and the same
    strict mask. At n = 8 the box is tight (spread 0.05), and 30 % of the
    coordinates have l_min = l_max (box: both slots active, the dual split
    between them) or l_min = 0 (signed box: with v < 0 the sign constraint
    repeats the lower bound, two slots of one coordinate are strictly active
    and the residual splits at minimal norm); v has a zero column (a no-op
    sign slot).
  * The same plain version in float64, and the port's assembled branch,
    against the JAX generic path (``qp_vjp`` / ``box_vjp`` /
    ``signed_box_vjp`` with backend="xla"): atol 1e-8 max(1, |.|_inf), on all
    cases but the tight signed box (two strict slots on one coordinate make
    the assembled system singular).
  * ``qp_dual`` / ``box_dual`` / ``signed_box_dual`` against the JAX package's
    in float64 (atol 1e-12), the masked factor against a dense solve of K,
    and K4's wrapper: its CPU dispatch and its input checks.
  * K4's kernels, which factor and solve only the free block (the one-warp
    kernel at n <= 32, the block-wide one above, compacting the free
    coordinates by a ballot a warp and a prefix over the warps), emulated
    per problem in float32 (the free rows gathered in order, the nf x nf
    block of P factored and solved, dl scattered back, P dl over the free
    columns alone) give the plain version's dl, dgamma and gamma bit for
    bit, apart from the sign of zeros: on every case above, on the three
    kinds at n = 33, 48, 96 and 168 (the block-wide sizes; B = 6, built at
    points with a known strict mask, ``_block_problem``), and where no
    coordinate (nf = 0) or every coordinate (nf = n) is free, at n = 10 and
    at those four sizes.

Each problem is solved by the JAX package at eps=1e-8; both sides get the
same numpy l and cotangent g.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
import diffqcqp_tpu.diff.kkt as K
from diffqcqp_tpu.kernels.coord_bwd_pallas import coord_kkt_bwd_fused
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.diff import kkt as TK
from diffqcqp_tpu_torch.kernels import coord_bwd_cuda as tk
from diffqcqp_tpu_torch.kernels.ldl import chol_factor, chol_to_unit, ldl_solve

CFG = dq.SolverConfig(eps=1e-8, backend="xla")
TCFG = dqt.SolverConfig.from_dict(dataclasses.asdict(CFG))
KINDS = {"qp": tk.KIND_QP, "box": tk.KIND_BOX, "signed_box": tk.KIND_SIGNED_BOX}
CASES = [f"{kind}_n{n}" for kind in KINDS for n in (6, 8, 11)]
BLOCK_NS = (33, 48, 96, 168)      # K4's block-wide kernel: just past one warp to its bound
BLOCK_CASES = [f"{kind}_n{n}" for kind in KINDS for n in BLOCK_NS]
# the cases with no coordinate whose two slots are strictly active
F64_CASES = [c for c in CASES if c != "signed_box_n8"]


@functools.lru_cache(maxsize=None)
def _problem(name):
    """Random SPD problem of the named case, solved by the JAX package; the
    box kinds' n = 8 case is tight, with l_min = l_max (box) or l_min = 0
    (signed box) on 30 % of the coordinates. Returns (P, q, l, g, l_min, l_max, v) in float32 numpy,
    None for what the kind does not take."""
    kind, n = name.rsplit("_n", 1)
    n = int(n)
    b = 12
    rng = np.random.default_rng(n + 10 * KINDS[kind])
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = (S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)).astype(np.float32)
    q = (rng.standard_normal((b, n)) * 0.8).astype(np.float32)
    cfg = CFG.replace(max_iter=5000)
    lo = hi = v = None
    if kind == "qp":
        l = dq.solve_qp(P, q, config=cfg)
    else:
        spread = 0.05 if n == 8 else 0.4
        lo = -(rng.random((b, n)) * spread + 0.02).astype(np.float32)
        hi = (rng.random((b, n)) * spread + 0.02).astype(np.float32)
        pin = rng.random((b, n)) < 0.3
        if n == 8 and kind == "box":
            hi = np.where(pin, lo, hi).astype(np.float32)
        elif n == 8:
            lo = np.where(pin, 0.0, lo).astype(np.float32)
        if kind == "box":
            l = dq.solve_box_qp(P, q, lo, hi, config=cfg)
        else:
            v = rng.standard_normal((b, n)).astype(np.float32)
            v[:, 0] = 0.0
            l = dq.solve_signed_box_qp(P, q, lo, hi, v, config=cfg)
    l = np.asarray(l).astype(np.float32)
    g = rng.standard_normal((b, n)).astype(np.float32)
    return KINDS[kind], (P, q, l, g, lo, hi, v)


@pytest.fixture(scope="module", params=CASES, ids=CASES)
def case(request):
    return request.param, *_problem(request.param)


def _t(*xs):
    return tuple(None if x is None else torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _kernel_inputs(arrs):
    P, q, l, g, lo, hi, v = arrs
    return P, q, l, g, lo, hi, None if v is None else np.sign(v)


@pytest.fixture(scope="module")
def jax_kernel(case):
    _, kind, arrs = case
    out = coord_kkt_bwd_fused(
        *(None if x is None else jnp.asarray(x) for x in _kernel_inputs(arrs)),
        kind, eps=CFG.eps, act_eps=CFG.act_eps, interpret=True,
    )
    return tuple(np.asarray(x) for x in out)


def test_cases_exercise_the_masks(case, jax_kernel):
    name, kind, (_, _, _, _, lo, hi, v) = case
    dl = jax_kernel[0]
    assert (dl == 0).any() and (dl != 0).any()     # pinned and free coordinates
    if kind != tk.KIND_QP:
        dg = jax_kernel[1]
        n = dl.shape[-1]
        assert (dg[:, :n] != 0).any() and (dg[:, n : 2 * n] != 0).any()
        gam = jax_kernel[2]
        if name == "box_n8":          # l_min = l_max: the dual split over both slots
            tight = lo == hi
            assert tight.any() and (dl[tight] == 0).all()
            np.testing.assert_array_equal(gam[:, :n][tight], -gam[:, n:][tight])
        if name == "signed_box_n8":   # l_min = 0, v < 0: two strict slots
            both = (dg[:, :n] != 0) & (dg[:, 2 * n :] != 0)
            assert both.any() and (lo[both] == 0).all() and (v[both] < 0).all()


def test_plain_k4_matches_jax_kernel_f32(case, jax_kernel):
    _, kind, arrs = case
    out = tk.coord_kkt_bwd_fused_plain(*_t(*_kernel_inputs(arrs)), kind, CFG.eps, CFG.act_eps)
    assert len(out) == len(jax_kernel) and out[0].dtype == torch.float32
    np.testing.assert_allclose(out[0].numpy(), jax_kernel[0], atol=5e-5, rtol=0)
    np.testing.assert_array_equal(out[0].numpy() == 0, jax_kernel[0] == 0)
    if kind != tk.KIND_QP:
        dg, gam = out[1].numpy(), out[2].numpy()
        np.testing.assert_array_equal(dg == 0, jax_kernel[1] == 0)   # same strict mask
        np.testing.assert_allclose(dg, jax_kernel[1], atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(gam, jax_kernel[2], atol=5e-5, rtol=0)


def _jax_generic(kind, arrs):
    P, q, l, g, lo, hi, v = (None if x is None else jnp.asarray(x) for x in arrs)
    if kind == tk.KIND_QP:
        return (K.qp_vjp(P, q, l, g, CFG),)
    if kind == tk.KIND_BOX:
        return tuple(K.box_vjp(P, q, lo, hi, l, g, CFG))
    return tuple(K.signed_box_vjp(P, q, lo, hi, v, l, g, CFG))


@pytest.fixture(scope="module", params=F64_CASES, ids=F64_CASES)
def f64_case(request):
    kind, arrs = _problem(request.param)
    x64 = tuple(None if x is None else x.astype(np.float64) for x in arrs)
    return kind, x64, tuple(np.asarray(x) for x in _jax_generic(kind, x64))


def _close(got, want, bar=1e-8):
    for a, b in zip(got, want):
        a = a.numpy()
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, atol=bar * max(1.0, float(np.abs(b).max())), rtol=0)


def test_plain_k4_matches_jax_generic_path_f64(f64_case):
    kind, arrs, ref = f64_case
    _close(tk.coord_kkt_bwd_fused_plain(*_t(*_kernel_inputs(arrs)), kind, CFG.eps, CFG.act_eps),
           ref)


def test_vjp_and_assembled_branch_match_jax_generic_path_f64(f64_case):
    """The port's *_vjp (float64 takes the generic route, as in the JAX
    package) and its assembled branch against the JAX generic path."""
    kind, arrs, ref = f64_case
    P, q, l, g, lo, hi, v = _t(*arrs)
    if kind == tk.KIND_QP:
        vjp = (TK.qp_vjp(P, q, l, g, TCFG),)
        assembled = (TK._qp_assembled_vjp(P, q, l, g, TCFG),)
    elif kind == tk.KIND_BOX:
        vjp = TK.box_vjp(P, q, lo, hi, l, g, TCFG)
        assembled = TK.box_vjp(P, q, lo, hi, l, g, TCFG, duals=TK.box_dual(P, q, lo, hi, l, TCFG))
    else:
        vjp = TK.signed_box_vjp(P, q, lo, hi, v, l, g, TCFG)
        assembled = TK._signed_box_assembled_vjp(P, q, lo, hi, v, l, g, TCFG)
    _close(vjp, ref)
    _close(assembled, ref)


def test_duals_match_jax_f64(case):
    _, kind, arrs = case
    P, q, l, _, lo, hi, v = (None if x is None else x.astype(np.float64) for x in arrs)
    Pt, qt, lt, lot, hit, vt = _t(P, q, l, lo, hi, v)
    j = lambda *xs: tuple(jnp.asarray(x) for x in xs)  # noqa: E731
    if kind == tk.KIND_QP:
        pairs = [(TK.qp_dual(Pt, qt, lt, TCFG), K.qp_dual(*j(P, q, l), CFG))]
    elif kind == tk.KIND_BOX:
        dt, dj = TK.box_dual(Pt, qt, lot, hit, lt, TCFG), K.box_dual(*j(P, q, lo, hi, l), CFG)
        pairs = list(zip(dt, dj))
    else:
        dt = TK.signed_box_dual(Pt, qt, lot, hit, vt, lt, TCFG)
        dj = K.signed_box_dual(*j(P, q, lo, hi, v, l), CFG)
        pairs = list(zip(dt, dj))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)


def test_masked_factor_solves_k():
    """chol_factor of fm P fm with shift am, then ldl_solve, against a dense
    solve of K = fm P fm + diag(am) (float64)."""
    rng = np.random.default_rng(7)
    S = rng.standard_normal((4, 9, 9))
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(9)
    am = (rng.random((4, 9)) < 0.4).astype(np.float64)
    fm = 1.0 - am
    rhs = rng.standard_normal((4, 9)) * fm
    Kd = P * fm[:, :, None] * fm[:, None, :] + am[:, :, None] * np.eye(9)
    Pt, amt, fmt, rt = _t(P, am, fm, rhs)
    Lh, dinv = chol_to_unit(chol_factor(Pt * fmt[:, :, None] * fmt[:, None, :], amt))
    x = ldl_solve(Lh, dinv, rt)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(Kd, rhs[..., None])[..., 0],
                               atol=1e-11, rtol=0)
    assert (x.numpy()[am > 0] == 0).all()


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing(case):
    _, kind, arrs = case
    args = _t(*_kernel_inputs(arrs)) + (kind, CFG.eps, CFG.act_eps)
    before = tk.coord_kkt_bwd_fused_cuda.launches
    out_w = tk.coord_kkt_bwd_fused_cuda(*args)
    out_p = tk.coord_kkt_bwd_fused_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(out_w, out_p))
    assert tk.coord_kkt_bwd_fused_cuda.launches == before


@pytest.mark.parametrize(
    "bad", ["P_shape", "g_shape", "bound_shape", "missing_bound", "extra_bound",
            "unknown_kind", "mixed_dtype"],
)
def test_wrapper_checks_its_inputs(bad):
    rng = np.random.default_rng(0)
    P = torch.eye(6).expand(2, 6, 6).contiguous()
    q, l, g, lo, hi = (torch.from_numpy(rng.standard_normal((2, 6)).astype(np.float32))
                       for _ in range(5))
    vs, kind, err = None, tk.KIND_BOX, ValueError
    if bad == "P_shape":
        P = P[:, :5, :5]
    elif bad == "g_shape":
        g = g[:1]
    elif bad == "bound_shape":
        hi = hi[:, :5]
    elif bad == "missing_bound":
        hi = None
    elif bad == "extra_bound":
        vs = torch.sign(lo)
    elif bad == "unknown_kind":
        kind = 3
    else:
        q, err = q.double(), TypeError
    with pytest.raises(err):
        tk.coord_kkt_bwd_fused_cuda(P, q, l, g, lo, hi, vs, kind, 1e-8, 1e-10)


def test_smem_bytes_bounds():
    # ~5 KB at N=24 (one warp); N=96 opts in above 48 KB and fits the 227 KB
    # a Hopper block may use
    assert tk.smem_bytes(24) < 6 * 1024
    assert 48 * 1024 < tk.smem_bytes(96) <= 232448


@functools.lru_cache(maxsize=None)
def _block_problem(name):
    """A block-wide case (B = 6) built at a point with a known strict mask,
    not solved: P as in ``_problem``; 45 % of the coordinates on a bound
    with P l + q = s pressing them there, |s| ~ U(0.05, 1.05) (QP: l = 0,
    s > 0; box kinds: l = l_min with s > 0 or l = l_max with s < 0; signed
    box also l = 0 with s = -sign(v) |s|), 5 % on a bound with s = 0
    (weakly active: rounding decides), the rest strictly inside with s = 0;
    l_min = l_max on 10 % (box), l_min = 0 on 10 % (signed box; with v < 0
    the sign slot repeats the lower bound); v with a zero column. Returns
    what ``_problem`` returns."""
    kind, n = name.rsplit("_n", 1)
    n, b = int(n), 6
    rng = np.random.default_rng(200 + n + 10 * KINDS[kind])
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    u = rng.random((b, n))
    mag = rng.random((b, n)) + 0.05
    lo = -(rng.random((b, n)) * 0.4 + 0.02)
    hi = rng.random((b, n)) * 0.4 + 0.02
    inside = lo + (hi - lo) * (0.1 + 0.8 * rng.random((b, n)))
    strict = u < 0.45
    v = None
    if kind == "qp":
        lo = hi = None
        l = np.where(u < 0.5, 0.0, np.abs(inside) + 0.05)
        s = np.where(strict, mag, 0.0)
    else:
        pin = rng.random((b, n)) < 0.1
        if kind == "box":
            hi = np.where(pin, lo, hi)
        else:
            lo = np.where(pin, 0.0, lo)
            v = rng.standard_normal((b, n))
            v[:, 0] = 0.0
        side = rng.integers(0, 3 if kind == "signed_box" else 2, (b, n))   # lo | hi | sign
        on_bound = np.choose(side, [lo, hi, np.zeros((b, n))])
        l = np.where(u < 0.5, on_bound, inside)
        sign = np.choose(side, [np.ones((b, n)), -np.ones((b, n)),
                                -np.sign(v) if v is not None else np.ones((b, n))])
        s = np.where(strict, sign * mag, 0.0)
    q = s - np.einsum("bij,bj->bi", P, l)
    g = rng.standard_normal((b, n))
    f32 = lambda x: None if x is None else np.asarray(x, np.float32)  # noqa: E731
    return KINDS[kind], tuple(f32(x) for x in (P, q, l, g, lo, hi, v))


def _free_block_k4(P, q, l, g, lo, hi, vs, kind, eps, act_eps):
    """K4's kernels (csrc/coord_bwd.cu: coord_bwd_kernel_w at one warp,
    coord_bwd_kernel above it) emulated per problem: the free coordinates in
    row order (the block-wide kernel's ballot a warp and prefix over the
    warps give the same order), the factor and solve of the nf x nf free
    block of P (fm P fm = P and diag(am) = 0 there), dl 0 on the strictly
    active rows, and P dl over the free columns alone."""
    am, slots = tk.coord_duals_plain(P, q, l, lo, hi, vs, kind, eps, act_eps)
    B, n = l.shape
    dl, pdl = torch.zeros_like(l), torch.zeros_like(l)
    for b in range(B):
        free = torch.nonzero(am[b] == 0).flatten()
        nf = free.numel()
        if nf:
            Pf = P[b][free][:, free][None]
            Lh, dinv = chol_to_unit(chol_factor(Pf, torch.zeros(1, nf, dtype=P.dtype)))
            dl[b, free] = ldl_solve(Lh, dinv, g[b, free][None])[0]
        acc = torch.zeros(n, dtype=P.dtype)
        for c in free.tolist():
            acc = acc + P[b, :, c] * dl[b, c]
        pdl[b] = acc
    if kind == tk.KIND_QP:
        return (dl,)
    return (dl,) + tk.coord_dgamma_plain(g, pdl, am, slots)


def _same_bits_but_zero_signs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a + 0.0, b + 0.0)


@pytest.mark.parametrize("name", CASES + BLOCK_CASES)
def test_free_block_factor_and_solve_give_the_plain_bits(name):
    kind, arrs = (_problem if name in CASES else _block_problem)(name)
    args = _t(*_kernel_inputs(arrs)) + (kind, CFG.eps, CFG.act_eps)
    out = tk.coord_kkt_bwd_fused_plain(*args)
    if name in BLOCK_CASES:      # every problem has strictly active and free coordinates
        nf = (out[0] != 0).sum(dim=1)
        assert bool((nf > 0).all()) and bool((nf < int(name.rsplit("_n", 1)[1])).all())
    _same_bits_but_zero_signs(_free_block_k4(*args), out)


NO_AND_EVERY = [(kind, free, n) for kind in KINDS for free in ("none", "all")
                for n in (10,) + BLOCK_NS]


@pytest.mark.parametrize(
    "kind,free,n", NO_AND_EVERY,
    ids=[f"{k}-{f}" + ("" if n == 10 else f"-n{n}") for k, f, n in NO_AND_EVERY],
)
def test_free_block_at_no_and_every_free_coordinate(kind, free, n):
    """nf = 0: l on its lower bound (0 for the QP) with q pressing it there;
    nf = n: l strictly inside and q = -P l."""
    rng = np.random.default_rng(31 + KINDS[kind] + (0 if n == 10 else n))
    b = 6
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = (S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)).astype(np.float32)
    lo = -(rng.random((b, n)) * 0.5 + 0.2).astype(np.float32)
    hi = (rng.random((b, n)) * 0.5 + 0.2).astype(np.float32)
    base = np.zeros((b, n), np.float32) if kind == "qp" else lo
    if free == "none":
        l = base
        q = (rng.random((b, n)) + 0.5).astype(np.float32) - np.einsum("bij,bj->bi", P, l)
    else:
        l = (base + rng.random((b, n)) * 0.1 + 0.05).astype(np.float32)
        q = -np.einsum("bij,bj->bi", P, l)
    v = np.ones((b, n), np.float32) if kind == "signed_box" else None   # l <= 0, inactive at l < 0
    arrs = (P, q.astype(np.float32), l, rng.standard_normal((b, n)).astype(np.float32),
            None if kind == "qp" else lo, None if kind == "qp" else hi, v)
    args = _t(*_kernel_inputs(arrs)) + (KINDS[kind], CFG.eps, CFG.act_eps)
    out = tk.coord_kkt_bwd_fused_plain(*args)
    assert bool((out[0] == 0).all()) == (free == "none")
    assert bool((out[0] != 0).all()) == (free == "all")
    _same_bits_but_zero_signs(_free_block_k4(*args), out)
