"""Batched symmetric eigendecomposition by two-sided cyclic Jacobi: the CUDA
kernel E1 and its plain version.

``eigh_cuda`` is the spectral mode's set-up (``ops/linalg.py::factorize``)
on the card, in place of the JAX package's ``jnp.linalg.eigh``
(``diffqcqp_tpu/ops/linalg.py:63``), which XLA compiles into the jitted
program. It is no Pallas kernel's port: ``torch.linalg.eigh`` checks its
info on the host, so it cannot be recorded in a CUDA graph, and cuSOLVER's
batched Jacobi stops at n = 32. On a CUDA tensor it launches
``kernels/csrc/jacobi_eigh.cu`` (a round one fused pass over 2 x 2 blocks;
one warp a problem at N <= 32, one block above; see the note at the top of
that file) or raises; on a CPU tensor it runs ``jacobi_eigh_plain``.
There is no fallback from one to the other.

The algorithm, the same in both (so that they round alike: the kernel is
built with ``-fmad=false``):

  * a sweep is m - 1 rounds of m / 2 disjoint pairs (m = N rounded up to
    even; at odd N the index N is a dummy whose pairs are skipped), in the
    round-robin order of ``round_pairs``: round r pairs i and j where
    i + j = 2r (mod m - 1), and r with m - 1;
  * a pair (p, q), p < q, rotates where |a_pq| > u sqrt(|a_pp| |a_qq|), u
    the dtype's unit roundoff, with Rutishauser's formulas: theta = (a_qq -
    a_pp) / (2 a_pq), t = sign(theta) / (|theta| + sqrt(theta^2 + 1))
    (sign(0) = +1), c = 1 / sqrt(t^2 + 1), s = t c;
  * a round applies its rotations to A's rows (row p <- c row p - s row q,
    row q <- s row p + c row q), then to A's columns (the same), and to the
    rows of V^T; then a_pp <- a_pp - t a_pq, a_qq <- a_qq + t a_pq from the
    round's starting values and a_pq = a_qp = 0, for the rotated pairs;
  * a problem is done after a sweep in which no pair rotated, or after
    ``MAX_SWEEPS``; nothing is read on the host;
  * the eigenvalues are A's diagonal, put in ascending order by the rank
    #{j: l_j < l_i} + #{j < i: l_j = l_i}, V's columns with them;
  * a problem whose P holds a non-finite value, or whose eigenvalues come
    out NaN, gives NaN eigenvalues and eigenvectors (and 0 sweeps for the
    former), as LAPACK's eigh gives NaN; nothing raises.

The outputs have ``torch.linalg.eigh``'s shapes and meaning: eigenvalues
(B, N) ascending and eigenvectors (B, N, N) in the columns; the signs of
the eigenvectors may differ from LAPACK's, which nothing in the solvers
reads (``solve_shifted`` and ``Factorization.lmax`` do not depend on them).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["MAX_SWEEPS", "Plan", "a_in_shared", "block_map", "eigh_cuda", "in_shared",
           "jacobi_eigh_plain", "launch_plan", "pair_of", "planned_problems_per_sm", "round_pairs",
           "workspace_elems"]

# the most sweeps a problem runs (passed to the kernel). The threshold test
# stops bench.py's problems after 7.4 sweeps on average at N = 24 in float32
# (at most 9), 8.3 in float64 (at most 10), and at most 12 at N = 130
# (``chip_smoke.py`` phase 2p on an H100); 30 only bounds a problem that
# would not settle
MAX_SWEEPS = 30
_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.float64: 2.0 ** -53}


def pair_of(r: int, k: int, m: int) -> tuple[int, int]:
    """Pair k of round r at the even size m, (p, q) with p < q, as
    csrc/jacobi_eigh.cu's ``pair_of``: round r pairs i and j where i + j = 2r
    (mod m - 1), and r with m - 1; a q at N or above is the dummy of an odd
    N."""
    a, b = (r, m - 1) if k == 0 else ((r + k) % (m - 1), (r - k) % (m - 1))
    return min(a, b), max(a, b)


def round_pairs(n: int) -> list[tuple[list[int], list[int]]]:
    """The rounds of one sweep at size n: [(p's, q's)] with p < q, the
    dummy's pairs left out; the order in which csrc/jacobi_eigh.cu's
    ``pair_of`` walks them."""
    m = n + (n & 1)
    rounds = []
    for r in range(m - 1):
        pairs = [pair_of(r, k, m) for k in range(m // 2)]
        rounds.append(([p for p, q in pairs if q < n], [q for p, q in pairs if q < n]))
    return rounds


def _check(P: torch.Tensor) -> None:
    if P.ndim != 3 or P.shape[1] != P.shape[2] or P.shape[1] < 1:
        raise ValueError(f"P must be (B, N, N) with N >= 1, got {tuple(P.shape)}")
    if P.dtype not in _ROUNDOFF:
        raise TypeError(f"P must be float32 or float64, got {P.dtype}")


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root the kernel takes (IEEE ``sqrt``):
    ``torch.sqrt`` on a CUDA tensor; on the CPU, where PyTorch's vectorized
    ``sqrt`` is off by an ulp on ~1 % of float64 inputs, NumPy's."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.numpy()))


def _sorted_outputs(A: torch.Tensor, Vt: torch.Tensor, bad: torch.Tensor):
    """The eigenvalues (A's diagonal) in ascending order by the kernel's rank
    (ties broken by index) and V's columns with them; NaN for ``bad``
    problems and for those whose eigenvalues came out NaN."""
    B, n, _ = A.shape
    lam = torch.diagonal(A, dim1=1, dim2=2)
    bad = bad | torch.isnan(lam).any(dim=1)
    idx = torch.arange(n, device=A.device)
    less = (lam[:, None, :] < lam[:, :, None]).sum(dim=2)
    ties = ((lam[:, None, :] == lam[:, :, None]) & (idx[None, :] < idx[:, None])[None]).sum(dim=2)
    rank = torch.where(bad[:, None], idx[None, :], less + ties)
    w = torch.empty_like(lam).scatter_(1, rank, lam)
    V = torch.empty_like(A).scatter_(2, rank[:, None, :].expand(B, n, n), Vt.mT)
    nan = torch.tensor(float("nan"), dtype=A.dtype, device=A.device)
    return torch.where(bad[:, None], nan, w), torch.where(bad[:, None, None], nan, V)


def jacobi_eigh_plain(P: torch.Tensor, stats: bool = False):
    """E1's plain PyTorch version: (eigenvalues (B, N) ascending,
    eigenvectors (B, N, N)) of a symmetric batch P, in its dtype and on its
    device, by the kernel's rounds, formulas, threshold, cap and sort,
    vectorized over the batch and a round's pairs. With ``stats`` also
    (sweeps (B,) int32, rotations (B,) int64): the sweeps each problem ran
    (the kernel's count) and the rotations it applied."""
    _check(P)
    B, n, _ = P.shape
    dev, dt = P.device, P.dtype
    u = _ROUNDOFF[dt]
    A = P.clone()
    Vt = torch.eye(n, dtype=dt, device=dev).expand(B, n, n).clone()
    bad = ~torch.isfinite(P).all(dim=2).all(dim=1)
    done = bad.clone()
    sweeps = torch.zeros(B, dtype=torch.int32, device=dev)
    rotations = torch.zeros(B, dtype=torch.int64, device=dev)
    rounds = [(torch.tensor(ps, dtype=torch.long, device=dev),
               torch.tensor(qs, dtype=torch.long, device=dev)) for ps, qs in round_pairs(n)
              if ps]
    for _ in range(MAX_SWEEPS):
        if bool(done.all()):
            break
        sweeps += (~done).to(torch.int32)
        rotated = torch.zeros(B, dtype=torch.bool, device=dev)
        for p, q in rounds:
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
            rot = apq.abs() > u * _sqrt(app.abs() * aqq.abs())
            theta = (aqq - app) / (2.0 * apq)
            sgn = torch.where(theta >= 0, 1.0, -1.0).to(dt)
            t = sgn / (theta.abs() + _sqrt(theta * theta + 1.0))
            c = 1.0 / _sqrt(t * t + 1.0)
            s = t * c
            c3, s3, r3 = c[..., None], s[..., None], rot[..., None]
            for M in (A, Vt):                                  # rows p and q
                x, y = M[:, p, :], M[:, q, :]
                M[:, p, :] = torch.where(r3, c3 * x - s3 * y, x)
                M[:, q, :] = torch.where(r3, s3 * x + c3 * y, y)
            x, y = A[:, :, p], A[:, :, q]                      # columns p and q
            cc, sc, rc = c[:, None, :], s[:, None, :], rot[:, None, :]
            A[:, :, p] = torch.where(rc, cc * x - sc * y, x)
            A[:, :, q] = torch.where(rc, sc * x + cc * y, y)
            A[:, p, p] = torch.where(rot, app - t * apq, A[:, p, p])
            A[:, q, q] = torch.where(rot, aqq + t * apq, A[:, q, q])
            zero = torch.zeros_like(apq)
            A[:, p, q] = torch.where(rot, zero, A[:, p, q])
            A[:, q, p] = torch.where(rot, zero, A[:, q, p])
            rotated |= rot.any(dim=1)
            rotations += rot.sum(dim=1)
        done |= ~rotated
    w, V = _sorted_outputs(A, Vt, bad)
    if not stats:
        return w, V
    return w, V, torch.where(bad, 0, sweeps).to(torch.int32), rotations


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("jacobi_eigh")
    if not getattr(lib, "_dq_typed", False):
        vp = ctypes.c_void_p
        for fn in (lib.dq_jacobi_eigh_f32, lib.dq_jacobi_eigh_f64):
            fn.argtypes = [vp] * 5 + [ctypes.c_int] * 3 + [vp]
            fn.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.dq_jacobi_eigh_plan.argtypes = [ctypes.c_int, ctypes.c_int, ip, ip, ip,
                                            ctypes.POINTER(ctypes.c_longlong), ip, ip]
        lib.dq_jacobi_eigh_plan.restype = None
        lib.dq_jacobi_eigh_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dq_jacobi_eigh_blocks_per_sm.restype = ctypes.c_int
        lib._dq_typed = True
    return lib


# csrc/jacobi_eigh.cu's constants
WARP_MAX_N = 32        # one warp a problem to N = 32, one block a problem above
WARP_BOUND = 256       # the warp kernel's __launch_bounds__ (8 problems a block at most) ...
WARP_REGS = 64         # ... with 4 such blocks an SM: at most 64 registers a thread
BLOCK_BOUND = 1024     # the block-wide kernel's __launch_bounds__ (64 registers a thread)
BLOCKS_PER_THREAD = 4  # 2 x 2 blocks a thread a round, block-wide
SMEM_PER_SM = 233472   # shared memory of a Hopper SM
SMEM_RESERVED = 1024   # the runtime's share of it per block
REGS_PER_SM = 65536
# where a block-wide problem keeps A and V^T: the number of them in the workspace
SHARED, VT_GLOBAL, GLOBAL = 0, 1, 2


class Plan(NamedTuple):
    """A launch of E1 at one size and dtype (csrc/jacobi_eigh.cu's plan_of)."""
    warp: int        # 1: one warp a problem (N <= 32); 0: one block a problem
    problems: int    # problems a block
    threads: int     # threads a block
    smem: int        # dynamic shared memory a block, bytes
    bound: int       # the kernel's __launch_bounds__
    layout: int      # SHARED, VT_GLOBAL or GLOBAL


def _ld(n: int) -> int:
    """Row stride of A and V^T in the kernel's work space: odd, so that a
    walk down a column is free of bank conflicts."""
    return n | 1


def _itemsize(dtype: torch.dtype) -> int:
    return 8 if dtype == torch.float64 else 4


def _plane_bytes(n: int, dtype: torch.dtype) -> int:
    """Bytes of one problem's A (or V^T)."""
    return _itemsize(dtype) * n * _ld(n)


def _scratch_bytes(n: int, dtype: torch.dtype) -> int:
    """A block-wide problem's per-pair (c, s, new a_pp, new a_qq; packed p,
    q, rotates) and per-index (ranks) scratch (csrc/jacobi_eigh.cu's
    scratch_bytes)."""
    pairs = (n + 1) // 2
    return _itemsize(dtype) * 4 * pairs + 4 * (pairs + n)


def in_shared(n: int, dtype: torch.dtype) -> bool:
    """Whether A and V^T both sit in shared memory at size n: where they and
    the scratch fit what a Hopper block may opt into (232,448 bytes: float32
    to N = 169, float64 to N = 119)."""
    return 2 * _plane_bytes(n, dtype) + _scratch_bytes(n, dtype) <= _build.HOPPER_SMEM_OPTIN


def a_in_shared(n: int, dtype: torch.dtype) -> bool:
    """Whether A alone fits shared memory at size n (float32 to N = 239,
    float64 to N = 169): past ``in_shared`` V^T goes to the global
    workspace, past this bound A too."""
    return _plane_bytes(n, dtype) + _scratch_bytes(n, dtype) <= _build.HOPPER_SMEM_OPTIN


def _warp_problem_bytes(n: int, dtype: torch.dtype) -> int:
    """One problem's shared memory in the warp kernel: A, V^T and the ranks,
    rounded up to 16 bytes."""
    return (2 * _plane_bytes(n, dtype) + 4 * n + 15) // 16 * 16


def _warp_problems_per_sm(problems: int, per: int) -> int:
    """Problems an SM holds in the warp kernel with ``problems`` a block of
    ``per`` shared bytes each: by its shared memory (less the runtime's
    share a block), its registers at ``WARP_REGS`` a thread, 32 blocks and
    64 warps."""
    blocks = min(SMEM_PER_SM // (problems * per + SMEM_RESERVED),
                 REGS_PER_SM // (WARP_REGS * 32 * problems), 32, 64 // problems)
    return blocks * problems


def planned_problems_per_sm(n: int, dtype: torch.dtype) -> int | None:
    """The problems an SM holds by the count that sized the one-warp plan
    at size n (None for a block-wide plan, which is sized by its work)."""
    plan = launch_plan(n, dtype)
    return _warp_problems_per_sm(plan.problems, plan.smem // plan.problems) if plan.warp else None


def launch_plan(n: int, dtype: torch.dtype) -> Plan:
    """E1's launch at size n, as csrc/jacobi_eigh.cu's dq_jacobi_eigh_plan
    computes it. N <= 32: one warp a problem, the fewest problems a block
    that put the most problems on an SM (its 233,472 bytes of shared memory
    less 1,024 a block, 64 registers a thread, 32 blocks, 64 warps). N > 32:
    one block a problem, a warp for every 4 x 32 of the pass's (N/2)^2 2 x 2
    blocks, at most 1024 threads; A and V^T where ``in_shared`` and
    ``a_in_shared`` put them."""
    if n <= WARP_MAX_N:
        per = _warp_problem_bytes(n, dtype)
        best = 1
        for w in range(2, WARP_BOUND // 32 + 1):
            if _warp_problems_per_sm(w, per) > _warp_problems_per_sm(best, per):
                best = w
        return Plan(1, best, 32 * best, best * per, WARP_BOUND, SHARED)
    half = (n + 1) // 2
    per_warp = 32 * BLOCKS_PER_THREAD
    threads = min(-(-half * half // per_warp) * 32, BLOCK_BOUND)
    layout = SHARED if in_shared(n, dtype) else VT_GLOBAL if a_in_shared(n, dtype) else GLOBAL
    # the layout counts the planes (A, V^T) in the workspace: 2 - layout in shared memory
    return Plan(0, 1, threads, _scratch_bytes(n, dtype) + (2 - layout) * _plane_bytes(n, dtype),
                BLOCK_BOUND, layout)


def workspace_elems(n: int, dtype: torch.dtype) -> int:
    """Elements of one problem's global workspace: none where A and V^T sit
    in shared memory, V^T's n (n | 1) where A alone does, A's and V^T's
    past that."""
    return launch_plan(n, dtype).layout * n * _ld(n)


def block_map(n: int, threads: int, warp: bool) -> list[list[tuple[int, int]]]:
    """The fused pass's 2 x 2 blocks of one round, thread by thread, as
    csrc/jacobi_eigh.cu walks them: [(row pair k, column pair k')] for each
    of ``threads`` threads (the lanes of one warp where ``warp``). Warp: lane
    l takes column pair l mod half, whose parameters it computes, and row
    pairs l // half + g j < half, g = 32 // half (lanes with l // half >= g
    none). Block-wide: block i is row pair i // half, column pair i mod
    half, thread t taking i = t, t + threads, ..."""
    half = (n + 1) // 2
    if warp:
        g = 32 // half
        return [[(k, t % half) for k in range(t // half, half, g)] if t // half < g else []
                for t in range(threads)]
    return [[(i // half, i % half) for i in range(t, half * half, threads)]
            for t in range(threads)]


def c_launch_plan(n: int, dtype: torch.dtype) -> Plan:
    """``launch_plan`` as the built library computes it (needs nvcc)."""
    lib = _lib()
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int(),
           ctypes.c_int()]
    lib.dq_jacobi_eigh_plan(n, _itemsize(dtype), *map(ctypes.byref, out))
    return Plan(*(o.value for o in out))


def c_blocks_per_sm(n: int, dtype: torch.dtype) -> int:
    """Blocks of E1's plan at size n that one SM of the current card holds,
    from CUDA's occupancy calculator (needs nvcc and a card)."""
    return _lib().dq_jacobi_eigh_blocks_per_sm(n, _itemsize(dtype))


def eigh_cuda(P: torch.Tensor, stats: bool = False):
    """E1: (eigenvalues (B, N) ascending, eigenvectors (B, N, N)) of a batch
    of symmetric matrices in one launch, ``torch.linalg.eigh``'s outputs but
    for the eigenvectors' signs; with ``stats`` also the sweeps each problem
    ran, (B,) int32.

    CPU tensors go to ``jacobi_eigh_plain``. A CUDA tensor must be float32
    or float64 (it is made contiguous); the kernel is launched on the
    current stream (no synchronisation, no read on the host, so it can be
    recorded in a CUDA graph) or this raises. ``eigh_cuda.launches`` counts
    the launches.
    """
    _check(P)
    if P.device.type == "cpu":
        out = jacobi_eigh_plain(P, stats=stats)
        return out[:3] if stats else out
    if P.device.type != "cuda":
        raise ValueError(f"P must lie on a CUDA device or the CPU, got {P.device}")
    P = P.contiguous()
    B, n, _ = P.shape
    plan = launch_plan(n, P.dtype)
    _build.check_geometry(plan.threads, plan.smem, plan.bound,
                          torch.cuda.get_device_properties(P.device).shared_memory_per_block_optin)
    lib = _lib()
    w = torch.empty((B, n), dtype=P.dtype, device=P.device)
    V = torch.empty_like(P)
    sweeps = torch.empty(B, dtype=torch.int32, device=P.device)
    work = (None if plan.layout == SHARED else
            torch.empty((B, workspace_elems(n, P.dtype)), dtype=P.dtype, device=P.device))
    fn = lib.dq_jacobi_eigh_f64 if P.dtype == torch.float64 else lib.dq_jacobi_eigh_f32
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        rc = fn(P.data_ptr(), w.data_ptr(), V.data_ptr(), sweeps.data_ptr(),
                None if work is None else work.data_ptr(), B, n, MAX_SWEEPS, stream)
    _build.check_rc(lib, rc, f"jacobi_eigh (B={B}, N={n}, {P.dtype})")
    _build.count_launch(eigh_cuda)
    return (w, V, sweeps) if stats else (w, V)


eigh_cuda.launches = 0
