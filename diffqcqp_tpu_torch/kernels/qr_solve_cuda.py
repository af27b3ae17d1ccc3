"""Batched dense solve by Householder QR: the CUDA kernel K5 and its plain
version.

``qr_solve_cuda`` replaces ``diffqcqp_tpu/kernels/qr_solve_pallas.py::
qr_solve_pallas`` (kernel ``_qr_solve_kernel``): A x = b for a batch of
small dense systems, by unpivoted Householder QR and back substitution, in
float32. Its caller is ``diff/kkt.py::_solve_direct``, the generic KKT
adjoint route. On a CUDA tensor it launches ``kernels/csrc/qr_solve.cu``
(one thread block per problem, ``qr_group(m)`` lanes per column of [A |
b]; see the note at the top of that file) or raises; on a CPU tensor it
runs ``qr_solve_plain``. There is no fallback from one to the other.

``householder_solve`` is the plain arithmetic, shared with the plain
versions of K2 and K6 (``kernels/qcqp_bwd_cuda.py``), whose Schur systems
the CUDA kernels solve with the ``csrc/qr.cuh`` helpers: per column k
the reflector alpha = -sign(a_kk) ||A[k:, k]|| (sign(0) = +1), v = A[k:, k]
- alpha e_k, beta = 2 / ||v||^2 or 0 when ||v||^2 <= 1e-30, applied to the
later columns; then back substitution column by column with the diagonal
floored at 1e-30 in magnitude. It runs on whole batches, in any dtype,
and adds in the kernels' order (``group``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ldl import TINY

__all__ = [
    "group_sum", "householder_solve", "launch_plan", "qr_group", "qr_solve_cuda", "qr_solve_plain",
    "smem_bytes",
]

BOUND = 256         # csrc/qr_solve.cu's kBound: __launch_bounds__


def group_sum(x: torch.Tensor, group: int) -> torch.Tensor:
    """Sum over the last dimension (a column's rows 0 .. m - 1, zeros where a
    step skips a row) in the order of csrc/qr.cuh's qr_solve_lanes with
    ``group`` lanes per column: lane q adds the rows i = q (mod group) in
    order, then a butterfly adds the lanes (stages group / 2, ..., 1)."""
    m = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (-m) % group)).unflatten(-1, (-1, group))
    p = x[..., 0, :]
    for r in range(1, x.shape[-2]):
        p = p + x[..., r, :]
    lanes = torch.arange(group, device=x.device)
    s = group // 2
    while s:
        p = p + p[..., lanes ^ s]
        s //= 2
    return p[..., 0]


def qr_group(m: int) -> int:
    """Lanes per column of K5's QR for an m x m system (csrc/qr_solve.cu's
    qr_group): 2 from m = 32 to 127, else 1."""
    return 1 if m < 32 or m >= 128 else 2


def householder_solve(Ab: torch.Tensor, group: int | None) -> torch.Tensor:
    """x of [A | b] x = ... for an augmented batch Ab (B, m, m + 1), in its
    dtype and on its device. Ab is overwritten with R and Q^T b (below R's
    diagonal it keeps stale values that nothing reads).

    ``group`` is the kernel's lanes per column: the sums over a column's rows
    run in ``group_sum``'s order, as csrc/qr.cuh's qr_solve_lanes adds them
    (K5; K2 and K6 above one warp): ||A[k+1:, k]||^2 once, which gives
    ||A[k:, k]||^2 = a_kk^2 + tail and ||v||^2 = v_k^2 + tail, and each v^T
    A_j. With None (the plain versions of K2 and K6 at one warp, whose
    kernels add in an order of their own; see ``qcqp_bwd_cuda.qr_group``)
    the sums are ``torch.sum``'s, as they were before the kernels were
    redesigned."""
    m = Ab.shape[1]
    for k in range(m):
        ck = Ab[:, k:, k]
        akk = ck[:, 0]
        sign = torch.where(akk < 0, 1.0, -1.0).to(Ab.dtype)
        v = ck.clone()
        rest = Ab[:, k:, k + 1 :]
        if group is None:
            alpha = sign * torch.sqrt(torch.sum(ck * ck, dim=-1))
            v[:, 0] = akk - alpha
            vsq = torch.sum(v * v, dim=-1)
            wd = torch.sum(v[:, :, None] * rest, dim=1)
        else:
            sq = torch.zeros_like(Ab[:, :, k])
            sq[:, k + 1 :] = ck[:, 1:] * ck[:, 1:]
            tail = group_sum(sq, group)
            alpha = sign * torch.sqrt(akk * akk + tail)
            v[:, 0] = akk - alpha
            vsq = v[:, 0] * v[:, 0] + tail
            prod = torch.zeros_like(Ab[:, :, k + 1 :])
            prod[:, k:] = v[:, :, None] * rest
            wd = group_sum(prod.transpose(1, 2), group)
        beta = torch.where(vsq > TINY, 2.0 / torch.clamp_min(vsq, TINY), torch.zeros_like(vsq))
        Ab[:, k:, k + 1 :] = rest - (beta[:, None] * wd)[:, None, :] * v[:, :, None]
        Ab[:, k, k] = alpha

    bvec = Ab[:, :, m].clone()
    x = torch.zeros_like(bvec)
    for k in reversed(range(m)):
        d = Ab[:, k, k]
        x[:, k] = bvec[:, k] / torch.where(d.abs() > TINY, d, torch.full_like(d, TINY))
        bvec[:, :k] = bvec[:, :k] - Ab[:, :k, k] * x[:, k : k + 1]
    return x


def qr_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5's plain PyTorch version: x (B, m) of A x = b, A (B, m, m), in the
    inputs' dtype and on their device, in the kernel's order of sums."""
    return householder_solve(torch.cat([A, b[..., None]], dim=-1), qr_group(A.shape[-1]))


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("qr_solve")
    if not getattr(lib, "_dq_typed", False):
        vp = ctypes.c_void_p
        lib.dq_qr_solve_f32.argtypes = [vp] * 3 + [ctypes.c_int] * 2 + [vp]
        lib.dq_qr_solve_f32.restype = ctypes.c_int
        ip, lp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)
        lib.dq_qr_solve_plan.argtypes = [ctypes.c_int, ip, lp, ip, ip]
        lib.dq_qr_solve_plan.restype = None
        lib._dq_typed = True
    return lib


def smem_bytes(m: int) -> int:
    """Dynamic shared memory of one block for an m x m system (as
    ``smem_bytes`` in csrc/qr_solve.cu computes it): [A | b], m + 1 columns
    of stride m | 1, the m-vector of the solution and four slots."""
    return 4 * ((m + 1) * (m | 1) + m + 4)


def launch_plan(m: int) -> tuple[int, int, int, int]:
    """(threads per block, dynamic shared memory per block, the kernel's
    __launch_bounds__, lanes per column) of an m x m system, as
    csrc/qr_solve.cu's dq_qr_solve_plan computes them: one problem per
    block, ``qr_group(m)`` lanes per column of [A | b] in whole warps,
    bound 256."""
    g = qr_group(m)
    return 32 * (-(-(g * (m + 1)) // 32)), smem_bytes(m), BOUND, g


def c_launch_plan(m: int) -> tuple[int, int, int, int]:
    """``launch_plan`` as the built library computes it (needs nvcc)."""
    lib = _lib()
    out = [ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()]
    lib.dq_qr_solve_plan(m, *map(ctypes.byref, out))
    return tuple(o.value for o in out)


def _check(A, b):
    if A.ndim != 3 or A.shape[1] != A.shape[2] or A.shape[1] < 1:
        raise ValueError(f"A must be (B, m, m) with m >= 1, got {tuple(A.shape)}")
    if tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(f"b must be {tuple(A.shape[:2])}, got {tuple(b.shape)}")
    if A.dtype != b.dtype or not A.dtype.is_floating_point:
        raise TypeError(f"A and b must share one floating dtype, got {A.dtype} and {b.dtype}")


def qr_solve_cuda(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5: x (B, m) of A x = b for a batch, A (B, m, m), in one launch.

    CPU tensors go to ``qr_solve_plain``. CUDA tensors must be contiguous
    float32 on one device, with m small enough that [A | b] fits a block's
    shared memory (m <= ~240 on an H100); the kernel
    is launched on the current stream (no synchronisation) or this raises.
    ``qr_solve_cuda.launches`` counts the launches.
    """
    _check(A, b)
    if A.device.type == "cpu" and b.device.type == "cpu":
        return qr_solve_plain(A, b)
    B, m = b.shape
    dev = _build.check_launch((A, b), *launch_plan(m)[:3])

    lib = _lib()
    x = torch.empty_like(b)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dq_qr_solve_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, m, stream)
    _build.check_rc(lib, rc, f"qr_solve (B={B}, m={m})")
    _build.count_launch(qr_solve_cuda)
    return x


qr_solve_cuda.launches = 0
