"""QCQP backward: the CUDA kernels K2 (fused) and K6 (Schur adjoint with
the duals given), and their plain versions.

``qcqp_kkt_bwd_fused_cuda`` replaces ``diffqcqp_tpu/kernels/qcqp_bwd_pallas.py::
qcqp_kkt_bwd_fused`` (kernel ``_qcqp_bwd_fused_kernel`` -> ``_schur_core``):
the closed-form dual recovery and the Schur-complement KKT adjoint of the
friction-cone QCQP in one launch. ``qcqp_kkt_bwd_cuda`` replaces
``qcqp_kkt_bwd_pallas`` (kernel ``_qcqp_bwd_kernel`` -> ``_schur_core``): the
same Schur adjoint from the caller's raw gamma, squared slacks s and strict
mask, the solve of ``diff/kkt.py::_qcqp_schur_vjp``. On a CUDA tensor each
launches its kernel in ``kernels/csrc/qcqp_bwd.cu`` (one thread block per
problem; see the note at the top of that file) or raises; on a CPU tensor
it runs its plain version. There is no fallback from one to the other.
Both run one warp per problem at n <= 32 (``ONE_WARP_MAX_N``) and a block of
256 threads above it, in two instances (n <= 96, n <= 150 =
``MW_MAX_N``); ``launch_plan`` gives each launch's geometry.

The plain versions repeat the kernels' arithmetic on whole batches in eager
PyTorch, in any dtype: K2's P l + q accumulated over columns in float64,
its per-contact duals and slacks (float64, rounded once), strict mask and
split of the cotangent along C's columns (``split_cotangent``, which the
generic routes of ``diff/kkt.py`` take too), then, shared by both
(``_schur_core_plain``), the LDL^T factor of D = P + diag(2 gamma_raw)
(``kernels/ldl.py``), the nc + 1 solves (column c of C starting at row 2c),
M and y, the Householder QR and back substitution
(``kernels/qr_solve_cuda.py::householder_solve``, summing in the order of
the kernels' QR at each n: ``qr_group``), and dl. The kernels' block-wide
factor and multi-right-hand-side sweeps give the bits of the thread-per-row
ones, so the plain factor and solves serve both paths. The CPU path and
the tests use them; ``chip_smoke.py`` holds the kernels against them on the
card.

Layout: reference order, contact c owns coordinates 2c and 2c + 1; n = 2 nc.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ldl import TINY, chol_factor, chol_to_unit, ldl_solve
from .qr_solve_cuda import householder_solve

__all__ = [
    "qcqp_kkt_bwd_cuda",
    "qcqp_kkt_bwd_fused_cuda",
    "qcqp_kkt_bwd_fused_plain",
    "qcqp_kkt_bwd_plain",
    "split_cotangent",
    "fits",
    "launch_plan",
    "smem_bytes",
]

ONE_WARP_MAX_N = 32   # csrc/qcqp_bwd.cu's kOneWarpMaxN: one warp per problem up to here
MW_THREADS = 256      # kMwThreads: the block-wide path's threads and bound
MW_MAX_N = 150        # kMwMaxN: the largest n of the block-wide path


def qr_group(n: int) -> int | None:
    """The order of the plain version's sums in the QR of the Schur system at
    size n: the kernels' lanes per column above one warp (csrc/qcqp_bwd.cu's
    Tiles::kQG: 4 up to n = 96, 2 above); None at one warp, ``torch.sum``'s
    order. The one-warp kernels' QR (csrc/qr.cuh's qr_solve_warp, one lane
    a column, serial sums with fused multiply-adds) adds in an order of its
    own there, as the one-warp kernels always have, and is held to the plain
    version by tolerance on the card."""
    return None if n <= ONE_WARP_MAX_N else (4 if n <= 96 else 2)


def _ct(l: torch.Tensor, z: torch.Tensor, am: torch.Tensor) -> torch.Tensor:
    """(C^T z)_c = 2 (l_2c z_2c + l_2c+1 z_2c+1) am_c, (B, nc)."""
    t = l * z
    return 2.0 * (t[:, 0::2] + t[:, 1::2]) * am


def _schur_core_plain(
    P: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    gam_raw: torch.Tensor,
    am: torch.Tensor,
    sigma: torch.Tensor,
    ainv: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 4-8 of K2 and K6 (csrc/qcqp_bwd.cu's schur_core): the LDL^T
    factor of D = P + diag(2 gam_raw) (``kernels/ldl.py``), W = D^{-1} [g | C]
    (column c of C starting at row 2c), M and y, the Householder QR and back
    substitution (``householder_solve``, in the order of the kernels' QR at
    this n: ``qr_group``), and dl. ``am`` is the (B, nc) strict mask as 0 /
    1 in l's dtype, ``sigma`` = s am + (1 - am). ``ainv`` (K2's, B x nc) is
    a / gamma of the part C a of the cotangent that K2 takes out of g
    before the call (``split_cotangent``): y then starts from -sigma ainv, and
    dgamma = (ainv + the solve's) am. Returns (dgamma (B, nc), dl (B, n))."""
    nc = l.shape[-1] // 2
    gam = gam_raw * am

    Lh, dinv = chol_to_unit(chol_factor(P, torch.repeat_interleave(2.0 * gam_raw, 2, dim=-1)))
    Wg = ldl_solve(Lh, dinv, g)
    Wc = []
    for c in range(nc):
        rhs = torch.zeros_like(l)
        rhs[:, 2 * c : 2 * c + 2] = 2.0 * l[:, 2 * c : 2 * c + 2] * am[:, c : c + 1]
        Wc.append(ldl_solve(Lh, dinv, rhs, start=2 * c))

    # [M | y], (B, nc rows, nc + 1 columns)
    eye = torch.eye(nc, dtype=torch.bool, device=l.device)
    cols = [
        torch.where(eye[c], sigma, torch.zeros_like(sigma)) - _ct(l, Wc[c], am) * gam[:, c : c + 1]
        for c in range(nc)
    ]
    y = -_ct(l, Wg, am)
    if ainv is not None:
        y = y - sigma * ainv
    Ab = torch.stack(cols + [y], dim=-1)
    dgamma = householder_solve(Ab, qr_group(l.shape[-1])) * am

    dl = Wg
    for c in range(nc):
        dl = dl - Wc[c] * (gam[:, c : c + 1] * dgamma[:, c : c + 1])
    if ainv is not None:
        dgamma = (ainv + dgamma) * am
    return dgamma, dl


def split_cotangent(l: torch.Tensor, g: torch.Tensor, sq: torch.Tensor, gam_raw: torch.Tensor,
                    am: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's split of the cotangent, g = C a + g_r: on each strictly active
    contact a_c = <g_c, l_c> / (2 |l_c|^2), the part of g along C's column
    2 l_c (0 elsewhere). The part C a has the exact solution dgamma = a /
    gamma, dl = 0 where the slack s is 0, so only g_r and s's part go
    through the float32 Schur solve: a contact on its rim keeps the exact
    dL/dr = 2 gamma r dgamma. Returns (g_r (B, n), ainv = a / gamma (B, nc))."""
    on = am > 0
    a = torch.where(on, (l[:, 0::2] * g[:, 0::2] + l[:, 1::2] * g[:, 1::2])
                    / torch.clamp_min(2.0 * sq, TINY), torch.zeros_like(sq))
    g_r = g - 2.0 * l * torch.repeat_interleave(a, 2, dim=-1)
    ainv = torch.where(on, a / torch.where(on, gam_raw, torch.ones_like(gam_raw)),
                       torch.zeros_like(a))
    return g_r, ainv


def qcqp_kkt_bwd_fused_plain(
    P: torch.Tensor,
    q: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    radius: torch.Tensor,
    eps: float,
    act_eps: float,
    stall_ulps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's plain PyTorch version over a whole batch, in the inputs' dtype
    and on their device. Returns (dgamma (B, nc), dl (B, n), gamma (B, nc)),
    gamma being the raw recovered duals.

    P l + q, <l_c, (P l + q)_c>, |l_c|^2 and the slack s = |l_c|^2 - r^2
    that sigma takes are formed in float64 (each product of two float32
    numbers is exact there, and the sums add in the kernel's order), then
    gamma and sigma are rounded to l's dtype; the activity tests stay in l's
    dtype. The cotangent is split (``split_cotangent``) before the Schur solve."""
    wide = torch.float64
    plq = q.to(wide)
    for k in range(l.shape[-1]):
        plq = plq + P[:, :, k].to(wide) * l[:, k : k + 1].to(wide)

    la, lb = l[:, 0::2], l[:, 1::2]
    law, lbw = la.to(wide), lb.to(wide)
    sq = la * la + lb * lb
    sqw = law * law + lbw * lbw
    act = (radius - torch.sqrt(sq) <= eps) & (radius >= eps)
    num = torch.clamp_min(-2.0 * (law * plq[:, 0::2] + lbw * plq[:, 1::2]), 0.0)
    gam_raw = torch.where(act, (num / torch.clamp_min(4.0 * sqw, TINY)).to(l.dtype),
                          torch.zeros_like(la))
    rr = radius * radius
    s = sq - rr
    s_tol = torch.clamp_min(stall_ulps * (sq + rr), act_eps)
    am = ((s > -s_tol) & (radius > act_eps) & (gam_raw > act_eps)).to(l.dtype)
    rw = radius.to(wide)
    sigma = torch.where(am > 0, (sqw - rw * rw).to(l.dtype), torch.ones_like(s))
    g_r, ainv = split_cotangent(l, g, sq, gam_raw, am)
    dgamma, dl = _schur_core_plain(P, l, g_r, gam_raw, am, sigma, ainv)
    return dgamma, dl, gam_raw


def qcqp_kkt_bwd_plain(
    P: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    gamma: torch.Tensor,
    s: torch.Tensor,
    active: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's plain PyTorch version over a whole batch, in l's dtype and on its
    device: the Schur adjoint with the raw duals ``gamma`` (D's shift), the
    squared slacks ``s`` and the strict mask ``active`` (bool, or 0 / 1 in
    l's dtype) given, all (B, nc). C and B^T use gamma * am, Sigma = s am + (1 - am), and dgamma is
    masked. Returns (dgamma (B, nc), dl (B, n))."""
    am = active.to(l.dtype)
    return _schur_core_plain(P, l, g, gamma, am, s * am + (1.0 - am))


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("qcqp_bwd")
    if not getattr(lib, "_dq_typed", False):
        vp, f = ctypes.c_void_p, ctypes.c_float
        lib.dq_qcqp_bwd_f32.argtypes = [vp] * 8 + [ctypes.c_int] * 2 + [f] * 3 + [vp]
        lib.dq_qcqp_bwd_f32.restype = ctypes.c_int
        lib.dq_qcqp_schur_f32.argtypes = [vp] * 8 + [ctypes.c_int] * 2 + [vp]
        lib.dq_qcqp_schur_f32.restype = ctypes.c_int
        ip, lp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)
        lib.dq_qcqp_bwd_plan.argtypes = [ctypes.c_int, ip, lp, ip, ip]
        lib.dq_qcqp_bwd_plan.restype = ctypes.c_int
        lib.dq_qcqp_bwd_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dq_qcqp_bwd_blocks_per_sm.restype = ctypes.c_int
        lib._dq_typed = True
    return lib


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one block of K2 or K6 at problem size n (as
    ``smem_bytes`` in csrc/qcqp_bwd.cu computes it). One warp (n <= 32): two
    32-float publish slots and l (96 floats), P and its factor in one n x
    (n|1) plane, [M | y] ((nc|1) x (nc+1)) and three nc-vectors; W stays in
    registers. Block-wide: P and its factor in one plane,
    W ((n+1) x (nc+1)), [M | y], four n-vectors (two of them the factor's
    column buffers), four nc-vectors and six slots."""
    nc, ld, ldm = n // 2, n | 1, (n // 2) | 1
    if n <= ONE_WARP_MAX_N:
        return 4 * (96 + n * ld + (nc + 1) * ldm + 3 * nc)
    return 4 * (n * ld + (nc + 1) * (n + 1) + (nc + 1) * ldm + 4 * n + 4 * nc + 6)


def launch_plan(n: int) -> tuple[int, int, int, int]:
    """(threads per block, dynamic shared memory per block, the kernel's
    __launch_bounds__, register tile rows of the sweeps) of K2 or K6 at size
    n, as csrc/qcqp_bwd.cu's dq_qcqp_bwd_plan computes them. One warp at n
    <= 32 (bound 32, tile rows 0); above, 256 threads, in the small instance
    up to n = 96 (3 rows) and the large one up to ``MW_MAX_N`` = 150 (6
    rows). Raises ValueError for an odd n or n > 150."""
    if n < 2 or n % 2 or n > MW_MAX_N:
        raise ValueError(f"n must be even, 2 <= n <= {MW_MAX_N}, got {n}")
    if n <= ONE_WARP_MAX_N:
        return 32, smem_bytes(n), 32, 0
    return MW_THREADS, smem_bytes(n), MW_THREADS, 3 if n <= 96 else 6


def fits(n: int) -> bool:
    """Whether K2 and K6 launch at size n (``launch_plan`` takes it: n even,
    2 <= n <= ``MW_MAX_N``); the dispatch rules decide on it."""
    return 2 <= n <= MW_MAX_N and n % 2 == 0


def c_launch_plan(n: int) -> tuple[int, int, int, int] | None:
    """``launch_plan`` as the built library computes it (needs nvcc); None
    where the library refuses n."""
    lib = _lib()
    t, s, bd, r = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    bad = lib.dq_qcqp_bwd_plan(n, ctypes.byref(t), ctypes.byref(s), ctypes.byref(bd),
                               ctypes.byref(r))
    return None if bad else (t.value, s.value, bd.value, r.value)


def c_blocks_per_sm(n: int, schur: bool) -> int:
    """Blocks of K6 (``schur``) or K2 at size n that one SM of the current
    card holds, from CUDA's occupancy calculator (needs nvcc and a card)."""
    return _lib().dq_qcqp_bwd_blocks_per_sm(n, int(schur))


def _check(P, q, l, g, radius):
    if l.ndim != 2 or l.shape[-1] % 2:
        raise ValueError(f"l must be (B, 2 nc), got {tuple(l.shape)}")
    B, n = l.shape
    if tuple(P.shape) != (B, n, n):
        raise ValueError(f"P must be (B, n, n) = {(B, n, n)}, got {tuple(P.shape)}")
    for name, t in (("q", q), ("g", g)):
        if tuple(t.shape) != (B, n):
            raise ValueError(f"{name} must be {(B, n)}, got {tuple(t.shape)}")
    if tuple(radius.shape) != (B, n // 2):
        raise ValueError(f"radius must be {(B, n // 2)}, got {tuple(radius.shape)}")
    dtypes = {t.dtype for t in (P, q, l, g, radius)}
    if len(dtypes) != 1 or not l.dtype.is_floating_point:
        raise TypeError(f"inputs must share one floating dtype, got {sorted(map(str, dtypes))}")


def qcqp_kkt_bwd_fused_cuda(
    P: torch.Tensor,
    q: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    radius: torch.Tensor,
    eps: float,
    act_eps: float,
    stall_ulps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: the whole QCQP backward of a batch in one launch. Returns
    (dgamma (B, nc), dl (B, n), gamma (B, nc)).

    CPU tensors go to ``qcqp_kkt_bwd_fused_plain``. CUDA tensors must be
    contiguous float32 on one device; the kernel is launched on the current
    stream (no synchronisation) or this raises. ``qcqp_kkt_bwd_fused_cuda.
    launches`` counts the launches this wrapper issues or, inside a CUDA
    graph capture, records: a replay of the graph runs the kernel again and
    counts nothing.
    """
    tensors = (P, q, l, g, radius)
    _check(*tensors)
    if all(t.device.type == "cpu" for t in tensors):
        return qcqp_kkt_bwd_fused_plain(P, q, l, g, radius, eps, act_eps, stall_ulps)
    B, n = l.shape
    dev = _build.check_launch(tensors, *launch_plan(n)[:3])

    lib = _lib()
    dgamma = torch.empty_like(radius)
    dl = torch.empty_like(l)
    gamma = torch.empty_like(radius)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dq_qcqp_bwd_f32(
            *(t.data_ptr() for t in tensors), dgamma.data_ptr(), dl.data_ptr(),
            gamma.data_ptr(), B, n, eps, act_eps, stall_ulps, stream,
        )
    _build.check_rc(lib, rc, f"qcqp_bwd (B={B}, n={n})")
    _build.count_launch(qcqp_kkt_bwd_fused_cuda)
    return dgamma, dl, gamma


qcqp_kkt_bwd_fused_cuda.launches = 0


def _check_schur(P, l, g, gamma, s, active):
    if l.ndim != 2 or l.shape[-1] % 2:
        raise ValueError(f"l must be (B, 2 nc), got {tuple(l.shape)}")
    B, n = l.shape
    if tuple(P.shape) != (B, n, n):
        raise ValueError(f"P must be (B, n, n) = {(B, n, n)}, got {tuple(P.shape)}")
    if tuple(g.shape) != (B, n):
        raise ValueError(f"g must be {(B, n)}, got {tuple(g.shape)}")
    for name, t in (("gamma", gamma), ("s", s), ("active", active)):
        if tuple(t.shape) != (B, n // 2):
            raise ValueError(f"{name} must be {(B, n // 2)}, got {tuple(t.shape)}")
    if active.dtype not in (torch.bool, l.dtype):
        raise TypeError(f"active must be bool or 0 / 1 in {l.dtype}, got {active.dtype}")
    dtypes = {t.dtype for t in (P, l, g, gamma, s)}
    if len(dtypes) != 1 or not l.dtype.is_floating_point:
        raise TypeError(f"inputs must share one floating dtype, got {sorted(map(str, dtypes))}")


def qcqp_kkt_bwd_cuda(
    P: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    gamma: torch.Tensor,
    s: torch.Tensor,
    active: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: the QCQP Schur adjoint of a batch in one launch, with the raw
    duals, squared slacks and strict mask (bool, or 0 / 1 in the inputs'
    dtype) given. Returns (dgamma (B, nc), dl (B, n)).

    CPU tensors go to ``qcqp_kkt_bwd_plain``. CUDA tensors must be
    contiguous float32 on one device; the kernel is launched on the current
    stream (no synchronisation) or this raises.
    ``qcqp_kkt_bwd_cuda.launches`` counts the launches.
    """
    tensors = (P, l, g, gamma, s, active)
    _check_schur(*tensors)
    if all(t.device.type == "cpu" for t in tensors):
        return qcqp_kkt_bwd_plain(*tensors)
    B, n = l.shape
    am = active.to(torch.float32)       # the kernel's 0 / 1 mask; a float32 mask as it is
    dev = _build.check_launch((P, l, g, gamma, s, am), *launch_plan(n)[:3])

    lib = _lib()
    dgamma = torch.empty_like(gamma)
    dl = torch.empty_like(l)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dq_qcqp_schur_f32(
            *(t.data_ptr() for t in (P, l, g, gamma, s, am)), dgamma.data_ptr(),
            dl.data_ptr(), B, n, stream,
        )
    _build.check_rc(lib, rc, f"qcqp_schur (B={B}, n={n})")
    _build.count_launch(qcqp_kkt_bwd_cuda)
    return dgamma, dl


qcqp_kkt_bwd_cuda.launches = 0
