"""The block-wide redesign of K6 / K2 (n > 32) and of K5, on the CPU.

  * (a) The plain Schur core (``qcqp_bwd_cuda._schur_core_plain``) against
    the plain core as it was before the redesign, written out below
    (``_torch_sum_core``: the same factor and solves, the QR's sums by
    ``torch.sum``), at B = 2: at N = 24 (one warp, whose QR keeps that
    order) bit for bit; at N = 96, where the QR now adds in the kernel's
    lane order (4 lanes a column, ``householder_solve(group=4)``), within
    128 float32 ulps of each problem's scale, max(1, |x_b|_inf): two orders
    of the same sums over a system of condition ~1e2.
  * (a') ``group_sum`` against a direct reading of the lane order.
  * (b) The wrappers' launch plans against the kernels' formulas, restated
    here from csrc/qcqp_bwd.cu and csrc/qr_solve.cu, at n = 24, 34, 96, 142
    and m = 5, 33, 36, 72, 88; every even n <= 142 and every m <= 239 that
    the previous kernels took still fits a block (232,448 bytes of shared
    memory, the kernel's thread bound), and N = 96 fits three blocks in an
    SM's 233,472 bytes (1 KB reserved for each).
  * (c) ``_build.check_geometry`` raises past a kernel's bound or the
    shared-memory limit and accepts the n = 142 launch.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against these plain versions there).
"""

import numpy as np
import pytest
import torch

from diffqcqp_tpu_torch.kernels import _build
from diffqcqp_tpu_torch.kernels import qcqp_bwd_cuda as k26
from diffqcqp_tpu_torch.kernels import qr_solve_cuda as k5
from diffqcqp_tpu_torch.kernels.ldl import TINY, chol_factor, chol_to_unit, ldl_solve

SMEM_OPTIN = 232448          # a Hopper block's opt-in shared memory
SMEM_SM = 233472             # an H100 SM's shared memory (228 KB)
ULP32 = float(np.finfo(np.float32).eps)


def _torch_sum_householder(Ab):
    """The plain QR before the redesign: sums by torch.sum."""
    m = Ab.shape[1]
    for k in range(m):
        ck = Ab[:, k:, k]
        akk = ck[:, 0]
        alpha = torch.where(akk < 0, 1.0, -1.0).to(Ab.dtype) * torch.sqrt(torch.sum(ck * ck, dim=-1))
        v = ck.clone()
        v[:, 0] = akk - alpha
        vsq = torch.sum(v * v, dim=-1)
        beta = torch.where(vsq > TINY, 2.0 / torch.clamp_min(vsq, TINY), torch.zeros_like(vsq))
        rest = Ab[:, k:, k + 1 :]
        wd = torch.sum(v[:, :, None] * rest, dim=1)
        Ab[:, k:, k + 1 :] = rest - (beta[:, None] * wd)[:, None, :] * v[:, :, None]
        Ab[:, k, k] = alpha
    bvec = Ab[:, :, m].clone()
    x = torch.zeros_like(bvec)
    for k in reversed(range(m)):
        d = Ab[:, k, k]
        x[:, k] = bvec[:, k] / torch.where(d.abs() > TINY, d, torch.full_like(d, TINY))
        bvec[:, :k] = bvec[:, :k] - Ab[:, :k, k] * x[:, k : k + 1]
    return x


def _torch_sum_core(P, l, g, gam_raw, am, sigma):
    """The plain Schur core before the redesign (steps 4-8)."""
    nc = l.shape[-1] // 2
    gam = gam_raw * am
    Lh, dinv = chol_to_unit(chol_factor(P, torch.repeat_interleave(2.0 * gam_raw, 2, dim=-1)))
    Wg = ldl_solve(Lh, dinv, g)
    Wc = []
    for c in range(nc):
        rhs = torch.zeros_like(l)
        rhs[:, 2 * c : 2 * c + 2] = 2.0 * l[:, 2 * c : 2 * c + 2] * am[:, c : c + 1]
        Wc.append(ldl_solve(Lh, dinv, rhs, start=2 * c))
    ct = lambda z: 2.0 * ((l * z)[:, 0::2] + (l * z)[:, 1::2]) * am  # noqa: E731
    eye = torch.eye(nc, dtype=torch.bool)
    cols = [torch.where(eye[c], sigma, torch.zeros_like(sigma)) - ct(Wc[c]) * gam[:, c : c + 1]
            for c in range(nc)]
    dgamma = _torch_sum_householder(torch.stack(cols + [-ct(Wg)], dim=-1)) * am
    dl = Wg
    for c in range(nc):
        dl = dl - Wc[c] * (gam[:, c : c + 1] * dgamma[:, c : c + 1])
    return dgamma, dl


def _core_inputs(nc, seed):
    rng = np.random.default_rng(seed)
    n = 2 * nc
    S = rng.standard_normal((2, n, n)) / np.sqrt(n)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    l = rng.standard_normal((2, n)) * 0.3
    g = rng.standard_normal((2, n))
    gam = rng.random((2, nc)) + 0.05
    am = (rng.random((2, nc)) < 0.6).astype(np.float64)
    s = -rng.random((2, nc)) * 1e-3 * am
    P, l, g, gam, am, s = (torch.from_numpy(x.astype(np.float32)) for x in (P, l, g, gam, am, s))
    return P, l, g, gam, am, s * am + (1.0 - am)


@pytest.mark.parametrize("nc", [12, 48], ids=["N24", "N96"])
def test_plain_core_against_the_pre_redesign_core(nc):
    args = _core_inputs(nc, seed=nc)
    new = k26._schur_core_plain(*args)
    old = _torch_sum_core(*args)
    for a, b in zip(new, old):
        if nc * 2 <= k26.ONE_WARP_MAX_N:
            assert torch.equal(a, b)
        else:
            scale = b.abs().amax(-1).clamp_min(1.0)
            assert float(((a - b).abs().amax(-1) / scale).max()) <= 128 * ULP32


@pytest.mark.parametrize("group", [1, 2, 4])
def test_group_sum_follows_the_lane_order(group):
    x = torch.from_numpy(np.random.default_rng(group).standard_normal((3, 37)).astype(np.float32))
    lanes = [torch.zeros(3) for _ in range(group)]
    for i in range(37):
        lanes[i % group] = lanes[i % group] + x[:, i]
    s = group // 2
    while s:
        lanes = [lanes[q] + lanes[q ^ s] for q in range(group)]
        s //= 2
    assert torch.equal(k5.group_sum(x, group), lanes[0])


def _c_qcqp_plan(n):
    """csrc/qcqp_bwd.cu's dq_qcqp_bwd_plan, restated."""
    nc, ld, ldm = n // 2, n | 1, (n // 2) | 1
    if n <= 32:
        return 32, 4 * (96 + n * ld + (nc + 1) * ldm + 3 * nc), 32, 0
    smem = 4 * (n * ld + (nc + 1) * (n + 1) + (nc + 1) * ldm + 4 * n + 4 * nc + 6)
    return 256, smem, 256, 3 if n <= 96 else 6


def _c_qr_plan(m):
    """csrc/qr_solve.cu's dq_qr_solve_plan, restated."""
    g = 1 if m < 32 or m >= 128 else 2
    return 32 * ((g * (m + 1) + 31) // 32), 4 * ((m + 1) * (m | 1) + m + 4), 256, g


@pytest.mark.parametrize("n", [24, 34, 96, 142])
def test_qcqp_launch_plan_matches_the_kernel(n):
    assert k26.launch_plan(n) == _c_qcqp_plan(n)
    assert k26.smem_bytes(n) == _c_qcqp_plan(n)[1]


@pytest.mark.parametrize("m", [5, 33, 36, 72, 88])
def test_qr_launch_plan_matches_the_kernel(m):
    assert k5.launch_plan(m) == _c_qr_plan(m)
    assert k5.smem_bytes(m) == _c_qr_plan(m)[1]


def test_every_previously_accepted_size_still_fits():
    for n in range(2, 144, 2):
        threads, smem, bound, _ = k26.launch_plan(n)
        _build.check_geometry(threads, smem, bound, SMEM_OPTIN)
    for m in range(1, 240):
        threads, smem, bound, _ = k5.launch_plan(m)
        _build.check_geometry(threads, smem, bound, SMEM_OPTIN)
    # N = 96 in place: three blocks share an SM (it took two before)
    assert 3 * (k26.smem_bytes(96) + 1024) <= SMEM_SM


def test_check_geometry_bounds():
    threads, smem, bound, rows = k26.launch_plan(142)
    assert rows == 6
    _build.check_geometry(threads, smem, bound, SMEM_OPTIN)
    with pytest.raises(ValueError):
        _build.check_geometry(bound + 32, smem, bound, SMEM_OPTIN)
    with pytest.raises(ValueError):
        _build.check_geometry(threads, SMEM_OPTIN + 4, bound, SMEM_OPTIN)
    with pytest.raises(ValueError):
        k26.launch_plan(152)       # register tiles past the large instance
    with pytest.raises(ValueError):
        k26.launch_plan(35)        # odd n
