"""The port's plain ops against the JAX package at float64: prox, Ruiz
equilibration, input canonicalisation, and the LDL^T helpers against a dense
numpy solve.

Tolerance: atol 1e-12 at float64. Both sides evaluate the same formulas in
the same precision; only the order of a few reductions may differ, which
costs a few ulps of O(1) values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffqcqp_tpu.ops import equilibrate as jeq
from diffqcqp_tpu.ops import prox as jprox
from diffqcqp_tpu.utils.shapes import canon_like as j_canon_like
from diffqcqp_tpu.utils.shapes import canon_problem as j_canon_problem
from diffqcqp_tpu_torch.kernels.ldl import chol_factor, chol_to_unit, ldl_solve
from diffqcqp_tpu_torch.ops import equilibrate as teq
from diffqcqp_tpu_torch.ops import prox as tprox
from diffqcqp_tpu_torch.utils.shapes import canon_like, canon_problem

ATOL = 1e-12


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    b, nc = 7, 5
    n = 2 * nc
    x = rng.standard_normal((b, n)) * 2.0
    lo = -(rng.random((b, n)) * 0.5 + 0.2)
    hi = rng.random((b, n)) * 0.5 + 0.2
    vs = np.sign(rng.standard_normal((b, n)))
    radius = rng.random((b, nc)) * 0.8
    radius[0, 0] = 0.0                      # zero radius: exact zero force
    x[1, 2:4] = 0.0                         # zero vector inside the disk
    S = rng.standard_normal((b, n, n))
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    P[2] *= np.exp(rng.uniform(-6, 6, n))[:, None]     # badly scaled rows
    P[2] = 0.5 * (P[2] + P[2].T)
    return dict(x=x, lo=lo, hi=hi, vs=vs, radius=radius, P=P)


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("kind", ["nonneg", "box", "signed_box", "disk"])
def test_prox_matches_jax(data, kind):
    d = data
    if kind == "nonneg":
        t, j = tprox.prox_nonneg(T(d["x"])), jprox.prox_nonneg(J(d["x"]))
    elif kind == "box":
        t = tprox.prox_box(T(d["x"]), T(d["lo"]), T(d["hi"]))
        j = jprox.prox_box(J(d["x"]), J(d["lo"]), J(d["hi"]))
    elif kind == "signed_box":
        t = tprox.prox_signed_box(T(d["x"]), T(d["lo"]), T(d["hi"]), T(d["vs"]))
        j = jprox.prox_signed_box(J(d["x"]), J(d["lo"]), J(d["hi"]), J(d["vs"]))
    else:
        t = tprox.prox_disk(T(d["x"]), T(d["radius"]))
        j = jprox.prox_disk(J(d["x"]), J(d["radius"]))
        assert np.all(t.numpy()[0, :2] == 0.0)
    _close(t, j)


def test_prox_box_upper_clamp_wins():
    x = torch.tensor([[0.0, 5.0, -5.0]], dtype=torch.float64)
    lo = torch.full_like(x, 1.0)
    hi = torch.full_like(x, -1.0)
    assert torch.equal(tprox.prox_box(x, lo, hi), hi)


@pytest.mark.parametrize("diag", [False, True], ids=["dense", "diagonal"])
def test_ruiz_diag_matches_jax(data, diag):
    P = data["P"]
    if diag:
        P = np.abs(np.diagonal(P, axis1=1, axis2=2)).copy()
        P[0, 0] = 0.0                       # zero row keeps scale 1
    _close(teq.ruiz_diag(T(P), 10), jeq.ruiz_diag(J(P), 10))


def test_scale_problem_and_isotropize_match_jax(data):
    P, q = data["P"], data["x"]
    dt = teq.isotropize(teq.ruiz_diag(T(P), 10))
    dj = jeq.isotropize(jeq.ruiz_diag(J(P), 10))
    _close(dt, dj)
    Pt, qt = teq.scale_problem(T(P), T(q), dt)
    Pj, qj = jeq.scale_problem(J(P), J(q), dj)
    _close(Pt, Pj)
    _close(qt, qj)
    _close(teq.contact_scale(dt), jeq.contact_scale(dj))


def _layouts(rng, b, n):
    P = rng.standard_normal((b, n, n))
    q = rng.standard_normal((b, n))
    return [
        ("batched", P, q),
        ("column", P, q[:, :, None]),
        ("unbatched", P[0], q[0]),
        ("unbatched_column", P[0], q[0][:, None]),
        ("shared_P", P[0], q),
        ("batch1_P", P[:1], q),
        ("diag_batched", np.abs(q) + 1.0, q),
        ("diag_unbatched", np.abs(q[0]) + 1.0, q[0]),
        ("mixed_precision", P.astype(np.float32), q),
    ]


@pytest.mark.parametrize("idx", range(9))
def test_canon_problem_layouts_match_jax(idx):
    rng = np.random.default_rng(4)
    name, P, q = _layouts(rng, 3, 4)[idx]
    ct = canon_problem(P, q)
    cj = j_canon_problem(J(P), J(q))
    assert ct.batched == cj.batched and ct.column == cj.column, name
    assert str(ct.P.dtype).split(".")[-1] == str(cj.P.dtype), name
    _close(ct.P, cj.P)                       # includes the symmetrisation of P
    _close(ct.q, cj.q)
    w = rng.standard_normal(ct.q.shape)
    _close(ct.restore(T(w)), cj.restore(J(w)))
    wl = np.asarray(cj.restore(J(w)))       # an auxiliary vector in the caller's layout
    n = ct.q.shape[-1]
    _close(canon_like(wl, ct, "ws", width=n), j_canon_like(J(wl), cj, "ws", width=n))


def test_canon_rejects_bad_shapes():
    with pytest.raises(ValueError, match="incompatible"):
        canon_problem(np.eye(3)[None], np.ones((1, 4)))
    with pytest.raises(ValueError, match="batch mismatch"):
        canon_problem(np.ones((2, 3, 3)), np.ones((3, 3)))
    c = canon_problem(np.ones((2, 4, 4)), np.ones((2, 4)))
    with pytest.raises(ValueError, match="batch 3 != 2"):
        canon_like(np.ones((3, 2)), c, "l_n", width=2)


@pytest.mark.parametrize("n,start", [(8, 0), (8, 3), (16, 0), (5, 0)])
def test_ldl_factor_and_solve_match_dense(n, start):
    """chol_factor + chol_to_unit + ldl_solve reproduce a dense solve of
    P + diag(shift), including the start (known-zero leading rows) skip.
    float32, relative 5e-5 (the bound tests/test_ldl.py holds the TPU
    helpers to)."""
    rng = np.random.default_rng(0)
    b = 64
    A = (rng.standard_normal((b, n, n)) / np.sqrt(n)).astype(np.float32)
    P = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(n, dtype=np.float32)
    shift = (rng.random(b) * 2.0 + 0.1).astype(np.float32)
    rhs = rng.standard_normal((b, n)).astype(np.float32)
    rhs[:, :start] = 0.0
    Lh, dinv = chol_to_unit(chol_factor(T(P), T(shift)))
    assert torch.all(torch.diagonal(Lh, dim1=1, dim2=2) == 0)
    assert torch.all(torch.triu(Lh) == 0)
    x = ldl_solve(Lh, dinv, T(rhs), start=start).numpy()
    K = P.astype(np.float64) + shift[:, None, None] * np.eye(n)
    ref = np.linalg.solve(K, rhs.astype(np.float64)[..., None])[..., 0]
    err = np.max(np.abs(x - ref) / (1.0 + np.abs(ref)))
    assert err < 5e-5, err


def test_ldl_float64_exact():
    rng = np.random.default_rng(1)
    b, n = 16, 24
    A = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(n)
    shift = rng.random(b) + 0.1
    rhs = rng.standard_normal((b, n))
    Lh, dinv = chol_to_unit(chol_factor(T(P), T(shift)))
    x = ldl_solve(Lh, dinv, T(rhs)).numpy()
    K = P + shift[:, None, None] * np.eye(n)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", K, x), rhs, atol=1e-12)
