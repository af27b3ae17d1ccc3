"""The port's KKT oracle (``diffqcqp_tpu_torch.verify``) against the JAX
package's (``diffqcqp_tpu.verify``): every field of ``check_qp``,
``check_box_qp``, ``check_signed_box_qp`` and ``check_qcqp`` and
``stationarity_bound``, computed in float64 from the same numpy inputs, on a
float64 and on a float32 solution (the float32 one sets the activity
tolerance at 100 float32 eps, as on the card).

Problems: B=6, N=8 (QCQP: 4 contacts), P = S S^T + 0.1 I dense and, for the
QP, also diagonal; the solutions from the JAX package's solve
(``backend="xla"``). Bar: rtol 1e-10, with an absolute floor of 1e-13 times
the problem's scale (max(1, |P l|_inf + |q|_inf)) for residuals that are
themselves rounding (~1e-16) and whose last bits depend on the order of a
sum.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
from diffqcqp_tpu import verify as jverify
from diffqcqp_tpu_torch import verify as tverify

B, N = 6, 8


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(31)
    S = rng.standard_normal((B, N, N)) / np.sqrt(N)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(N)
    q = rng.standard_normal((B, N))
    lo = -(rng.random((B, N)) * 0.9 + 0.1)
    hi = rng.random((B, N)) * 0.9 + 0.1
    v = rng.standard_normal((B, N))
    l_n = rng.random((B, N // 2)) * 0.5 + 0.05
    mu = rng.random((B, N // 2)) * 0.5 + 0.05
    Pd = rng.random((B, N)) + 0.3
    return dict(P=P, Pd=Pd, q=q, lo=lo, hi=hi, v=v, l_n=l_n, mu=mu)


CASES = [(cls, dt) for cls in ("qp", "qp_diag", "box_qp", "signed_box_qp", "qcqp")
         for dt in ("f64", "f32")]


def _inputs(cls, pr, dtype):
    """(solver name, inputs before l) of the case, in ``dtype``."""
    P = pr["Pd"] if cls == "qp_diag" else pr["P"]
    base = {"qp": (), "qp_diag": (), "box_qp": ("lo", "hi"), "signed_box_qp": ("lo", "hi", "v"),
            "qcqp": ("l_n", "mu")}[cls]
    xs = (P, pr["q"]) + tuple(pr[k] for k in base)
    return ("qp" if cls == "qp_diag" else cls), tuple(x.astype(dtype) for x in xs)


def _solve(name, xs, dtype):
    cfg = (dq.QCQP_DEFAULTS if name == "qcqp" else dq.QP_DEFAULTS).replace(
        backend="xla", eps=1e-10 if dtype == np.float64 else 1e-6, max_iter=5000)
    l, st = getattr(dq, f"solve_{name}_with_stats")(*(jnp.asarray(x) for x in xs), config=cfg)
    stats = SimpleNamespace(**{k: np.asarray(getattr(st, k)) for k in ("res_prim", "res_dual",
                                                                        "rho")})
    return np.asarray(l), stats


def _close(got, want, scale):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10, atol=1e-13 * scale)


@pytest.mark.parametrize("cls,dt", CASES, ids=[f"{c}-{d}" for c, d in CASES])
def test_check_matches_jax(problems, cls, dt):
    dtype = np.float64 if dt == "f64" else np.float32
    name, xs = _inputs(cls, problems, dtype)
    l, _ = _solve(name, xs, dtype)
    assert l.dtype == dtype
    want = getattr(jverify, f"check_{name}")(*xs, l)
    got = getattr(tverify, f"check_{name}")(*xs, l, device="cpu")
    assert all(x.dtype == torch.float64 for x in got)
    P = xs[0].astype(np.float64)
    pl = P * l if P.ndim == 2 else np.einsum("bij,bj->bi", P, l)
    scale = max(1.0, float(np.abs(pl).max() + np.abs(xs[1]).max()))
    for field, a, b in zip(tverify.KKTResiduals._fields, got, want):
        _close(a, b, scale)
    # a float32 solution is certified at its own precision: the residuals
    # are small against the problem's scale (the oracle is not vacuous)
    assert float(got.primal.max()) < 1e-5 and float(got.stationarity.max()) < 1e-2


@pytest.mark.parametrize("cls,dt", CASES, ids=[f"{c}-{d}" for c, d in CASES])
def test_stationarity_bound_matches_jax(problems, cls, dt):
    dtype = np.float64 if dt == "f64" else np.float32
    name, xs = _inputs(cls, problems, dtype)
    l, stats = _solve(name, xs, dtype)
    want = np.asarray(jverify.stationarity_bound(xs[0], xs[1], l, stats))
    got = tverify.stationarity_bound(xs[0], xs[1], l, stats, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)
    # the bound holds for the measured stationarity (tpu_smoke.py's claim)
    stat = getattr(tverify, f"check_{name}")(*xs, l, device="cpu").stationarity
    assert bool((stat <= 2.0 * got).all())


def test_check_takes_tensors_and_keeps_their_device(problems):
    """torch inputs (any layout canon_problem takes) give the numpy inputs'
    results, on the device asked for; ``dtype`` sets the computation's
    dtype."""
    name, xs = _inputs("qcqp", problems, np.float64)
    l, _ = _solve(name, xs, np.float64)
    a = tverify.check_qcqp(*xs, l, device="cpu")
    b = tverify.check_qcqp(*(torch.tensor(x) for x in xs), torch.tensor(l)[..., None],
                           device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.device.type == "cpu"
    c = tverify.check_qcqp(*xs, l, dtype=torch.float32, device="cpu")
    assert c.stationarity.dtype == torch.float32


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
@pytest.mark.parametrize("name", ["qp", "box_qp", "signed_box_qp", "qcqp", "bound"])
def test_default_device_is_the_card(problems, name):
    """Like every entry point of the port, the oracle runs on the card unless
    the caller asks for the CPU: without CUDA the default raises."""
    cls = "qcqp" if name == "bound" else name
    _, xs = _inputs(cls, problems, np.float64)
    l = np.zeros_like(xs[1])
    stats = SimpleNamespace(res_prim=np.zeros(B), res_dual=np.zeros(B), rho=np.ones(B))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if name == "bound":
            tverify.stationarity_bound(xs[0], xs[1], l, stats)
        else:
            getattr(tverify, f"check_{name}")(*xs, l)
