"""K2's radius gradients in float32 at contacts on their rim.

The problems are built at a known KKT point: every contact of l on its rim
(|l_c| within an ulp of r_c in float32), its dual gamma_c drawn
log-uniformly from 1e-3 to 3 (weakly binding contacts among them) and q =
-(P l + 2 gamma l) formed in float64, so that P l + q cancels in float32 on
the weak contacts. K2's plain version in float32 is held against the same
version in float64 on the same float32 inputs: dgamma and the radius
gradients e2 dgamma (for l_n) and e1 dgamma (for mu) of ``api.py``'s
``_qcqp_grads``, per problem ||got - want|| / ||want||.

With the cotangent g = 2 l of the loss sum(l^2), every contact on its rim
makes sum(l^2) = sum(r^2): dL/dr_c = 2 r_c exactly, dl = 0, and gamma
dgamma = 1. A float32 Schur solve of the whole g, with gamma from a float32
P l + q, misses those by ~1e-4 in dgamma and ~2e-5 in the radius gradients;
K2's float64 duals and slacks and its split of g along C's columns keep
them to ~1e-7 of the float64 run (which sees the same rounding of l off
the rim). Bars: 1e-6 for g = 2 l, 5e-6 for a random g (~1.6e-6 after the
repair, ~1.7e-5 before), 2e-7 on gamma (~5e-8 after, ~1.2e-6 before).
``qcqp_dual``, the generic routes' recovery, is held per contact to 1e-6 of
its float64 gamma (~6e-8 after, ~1.2e-4 before).

The generic routes of ``qcqp_vjp`` likewise, each in float32 against itself
in float64 on the same float32 inputs and strict mask (``qcqp_dual``'s
gamma, ``qcqp_strict_active``'s slacks, which are float64 sums on the
active contacts; float64's own mask, at its 8-ulp slack floor, would drop
the contacts that float32 l leaves an ulp off the rim): the assembled
system (``_solve_direct``; an LU of it on the CPU) and the Schur complement
past K6 (the Newton-Schulz inverse of D), each on the split cotangent, and
K6 on the whole g. Radius gradients, per problem: assembled 1.4e-7 (g =
2 l) and 9.5e-6 (random g; the float32 LU of the saddle system), bars 1e-6
and 3e-5; Schur 1.4e-7 and 6.1e-7, bars 1e-6 and 5e-6; K6 2.7e-6 and 1.9e-6,
bar 1e-5. Before (float32 slacks, no split) every route read 1.7e-5 to
2.0e-5. ``qcqp_jacobian``'s entries (dl/dq, dl/dl_n, dl/dmu) read 7.7e-6
of float64 (1.8e-5 with float32 slacks), bar 1.2e-5.
"""

import math

import pytest
import torch

import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.diff import kkt as TK
from diffqcqp_tpu_torch.kernels import qcqp_bwd_cuda as tk

F32_ULPS = 8.0 * torch.finfo(torch.float32).eps
EPS, ACT_EPS = 1e-7, 1e-10
B, NC = 64, 12


def rim_problems(b, nc, seed):
    """(P, q, l, l_n, mu) in float32 at a KKT point with every contact on
    its rim and gamma ~ 10^U(-3, 0.5)."""
    gen = torch.Generator().manual_seed(seed)
    n = 2 * nc
    f64 = torch.float64
    S = torch.randn(b, n, n, generator=gen, dtype=f64) / math.sqrt(n)
    P = (S @ S.mT + 0.1 * torch.eye(n, dtype=f64)).float()
    l_n = (torch.rand(b, nc, generator=gen, dtype=f64) * 0.5 + 0.05).float()
    mu = (torch.rand(b, nc, generator=gen, dtype=f64) * 0.5 + 0.05).float()
    r = (l_n * mu).double()
    th = torch.rand(b, nc, generator=gen, dtype=f64) * 2 * math.pi
    l = torch.stack([r * th.cos(), r * th.sin()], dim=-1).reshape(b, n).float()
    gam = 10.0 ** (torch.rand(b, nc, generator=gen, dtype=f64) * 3.5 - 3.0)
    lw = l.double()
    q = -(P.double() @ lw[..., None])[..., 0] - 2.0 * gam.repeat_interleave(2, dim=-1) * lw
    return P, q.float(), l, l_n, mu


@pytest.fixture(scope="module")
def rim():
    P, q, l, l_n, mu = rim_problems(B, NC, 3)
    slack = (l.reshape(B, NC, 2).double().norm(dim=-1) - (l_n * mu).double()).abs()
    assert float((slack / (l_n * mu).double()).max()) <= 2.0 ** -22     # on the rim
    return P, q, l, l_n, mu


def _rel(got, want):
    got, want = got.double(), want.double()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def _both(rim, g):
    P, q, l, l_n, mu = rim
    r = l_n * mu
    out32 = tk.qcqp_kkt_bwd_fused_plain(P, q, l, g, r, EPS, ACT_EPS, F32_ULPS)
    out64 = tk.qcqp_kkt_bwd_fused_plain(*(x.double() for x in (P, q, l, g, r)), EPS, ACT_EPS,
                                        F32_ULPS)
    assert torch.equal(out32[0] != 0, out64[0] != 0)          # the same strict mask
    assert bool((out64[0] != 0).all())                         # every contact binds
    return out32, out64


def _radius_grads(l_n, mu, out):
    dgamma, _, gamma = out
    e1, e2 = TK.qcqp_radius_factors(l_n.double(), mu.double(), gamma.double())
    return e2 * dgamma.double(), e1 * dgamma.double()


@pytest.mark.parametrize("cotangent", ["2l", "random"])
def test_plain_k2_f32_radius_gradients_match_f64_on_the_rim(rim, cotangent):
    P, q, l, l_n, mu = rim
    g = 2.0 * l if cotangent == "2l" else torch.randn(
        l.shape, generator=torch.Generator().manual_seed(9))
    out32, out64 = _both(rim, g)
    bar = 1e-6 if cotangent == "2l" else 5e-6
    got, want = _radius_grads(l_n, mu, out32), _radius_grads(l_n, mu, out64)
    for name, a, b in (("dl_n", got[0], want[0]), ("dmu", got[1], want[1])):
        assert _rel(a, b) <= bar, name
    if cotangent == "2l":
        assert _rel(out32[0], out64[0]) <= 1e-6                 # dgamma
    assert _rel(out32[2], out64[2]) <= 2e-7                     # gamma


def test_qcqp_dual_f32_matches_f64_on_the_rim(rim):
    P, q, l, l_n, mu = rim
    cfg = dqt.QCQP_DEFAULTS.replace(eps=EPS)
    r = l_n * mu
    d32 = TK.qcqp_dual(P, q, r, l, cfg)
    d64 = TK.qcqp_dual(P.double(), q.double(), r.double(), l.double(), cfg)
    assert d32.gamma.dtype == torch.float32
    assert torch.equal(d32.active, d64.active) and bool(d32.active.all())
    assert float(((d32.gamma.double() - d64.gamma).abs() / d64.gamma).max()) <= 1e-6


ROUTE_BARS = {("assembled", "2l"): 1e-6, ("assembled", "random"): 3e-5,
              ("schur", "2l"): 1e-6, ("schur", "random"): 5e-6,
              ("k6", "2l"): 1e-5, ("k6", "random"): 1e-5}
CFG = dqt.QCQP_DEFAULTS.replace(eps=EPS, act_eps=ACT_EPS, backend="xla")


def _strict_f32(rim, monkeypatch):
    """``qcqp_strict_active`` with the float32 run's mask in both dtypes."""
    P, q, l, l_n, mu = rim
    real = TK.qcqp_strict_active
    mask = real(l, l_n * mu, TK.qcqp_dual(P, q, l_n * mu, l, CFG).gamma, CFG)[1]
    assert bool(mask.all())

    def strict(l_, r_, gamma, cfg):
        return real(l_, r_, gamma, cfg)[0], mask
    monkeypatch.setattr(TK, "qcqp_strict_active", strict)


def _route(route, rim, g, dtype, monkeypatch):
    P, q, l, l_n, mu, g, r = (x.to(dtype) for x in (*rim, g, rim[3] * rim[4]))
    if route == "assembled":
        out = TK.qcqp_vjp(P, q, r, l, g, CFG)
    else:
        d = TK.qcqp_dual(P, q, r, l, CFG)
        s, am = TK.qcqp_strict_active(l, r, d.gamma, CFG)
        with monkeypatch.context() as m:
            if route == "schur" or dtype == torch.float64:      # K6 has no float64
                m.setattr(tk, "fits", lambda n: False)
            out = TK._qcqp_schur_vjp(P, l, g, s, am.to(dtype), d.gamma)
    return _radius_grads(l_n, mu, (out.dgamma, None, out.gamma))


@pytest.mark.parametrize("cotangent", ["2l", "random"])
@pytest.mark.parametrize("route", ["assembled", "schur", "k6"])
def test_generic_routes_f32_radius_gradients_match_f64_on_the_rim(rim, route, cotangent,
                                                                 monkeypatch):
    _strict_f32(rim, monkeypatch)
    l = rim[2]
    g = 2.0 * l if cotangent == "2l" else torch.randn(
        l.shape, generator=torch.Generator().manual_seed(9))
    k6_runs = []
    real_k6 = TK.qcqp_kkt_bwd_cuda
    monkeypatch.setattr(TK, "qcqp_kkt_bwd_cuda", lambda *a: k6_runs.append(1) or real_k6(*a))
    got = _route(route, rim, g, torch.float32, monkeypatch)
    assert bool(k6_runs) is (route == "k6")
    want = _route(route, rim, g, torch.float64, monkeypatch)
    for name, a, b in (("dl_n", got[0], want[0]), ("dmu", got[1], want[1])):
        assert _rel(a, b) <= ROUTE_BARS[route, cotangent], name


def test_qcqp_jacobian_f32_matches_f64_on_the_rim(rim, monkeypatch):
    from diffqcqp_tpu_torch.diff.jacobian import qcqp_jacobian

    _strict_f32(rim, monkeypatch)
    P, q, l, l_n, mu = rim
    j32 = qcqp_jacobian(P, q, l_n, mu, l=l, config=CFG, device="cpu")
    j64 = qcqp_jacobian(*(x.double() for x in rim[:2]), l_n.double(), mu.double(),
                        l=l.double(), config=CFG, device="cpu")
    for name in ("dl_dq", "dl_dl_n", "dl_dmu"):
        a, b = getattr(j32, name).flatten(1), getattr(j64, name).flatten(1)
        assert _rel(a, b) <= 1.2e-5, name
