"""Fused QP-family backward: the CUDA kernel K4 and its plain version.

``coord_kkt_bwd_fused_cuda`` replaces ``diffqcqp_tpu/kernels/
coord_bwd_pallas.py::coord_kkt_bwd_fused`` (kernel ``_coord_bwd_kernel``):
the closed-form dual recovery and the decoupled KKT adjoint of the
non-negative, box and signed-box QP in one launch. On a CUDA tensor it
launches ``kernels/csrc/coord_bwd.cu`` (one thread block per problem; see the
note at the top of that file) or raises; on a CPU tensor it runs
``coord_kkt_bwd_fused_plain``. There is no fallback from one to the other.

``coord_kkt_bwd_fused_plain`` repeats the kernel's arithmetic on whole
batches in eager PyTorch, in any dtype: P l + q accumulated over columns,
the per-coordinate duals and strict mask am, the LDL^T factor of
K = fm P fm + diag(am) (``kernels/ldl.py``), dl = K^{-1}(g fm) fm, and for
the box kinds the residual (g - P dl) am split over the strict slots. The
CPU path and the tests use it; ``chip_smoke.py`` holds the kernel against it
on the card. The kernel factors only the block of the free coordinates (a
strictly active coordinate's row and column of K are unit vectors), which
keeps every free entry's operations in this version's order: the two agree
bit for bit apart from the sign of zeros (``tests/test_torch_coord_bwd.py``
emulates the compaction at one warp and block-wide).

Outputs, as the JAX wrapper's: ``(dl,)`` for ``KIND_QP``; ``(dl, dgamma,
gamma)`` for ``KIND_BOX`` ((B, 2n) blocks [lo | hi]) and ``KIND_SIGNED_BOX``
((B, 3n) blocks [lo | hi | sg]).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ldl import TINY, chol_factor, chol_to_unit, ldl_solve

__all__ = [
    "KIND_QP", "KIND_BOX", "KIND_SIGNED_BOX",
    "coord_kkt_bwd_fused_cuda", "coord_kkt_bwd_fused_plain", "fits", "smem_bytes", "threads",
]

KIND_QP = 0
KIND_BOX = 1
KIND_SIGNED_BOX = 2
_SLOTS = {KIND_QP: 0, KIND_BOX: 2, KIND_SIGNED_BOX: 3}   # constraints per coordinate


def coord_kkt_bwd_fused_plain(
    P: torch.Tensor,
    q: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    l_min: torch.Tensor | None,
    l_max: torch.Tensor | None,
    v_sign: torch.Tensor | None,
    kind: int,
    eps: float,
    act_eps: float,
) -> tuple[torch.Tensor, ...]:
    """K4's plain PyTorch version over a whole batch, in the inputs' dtype
    and on their device."""
    n = l.shape[-1]
    am, slots = coord_duals_plain(P, q, l, l_min, l_max, v_sign, kind, eps, act_eps)
    fm = 1.0 - am

    Lh, dinv = chol_to_unit(chol_factor(P * fm[:, :, None] * fm[:, None, :], am))
    dl = ldl_solve(Lh, dinv, g * fm) * fm
    if kind == KIND_QP:
        return (dl,)

    pdl = P[:, :, 0] * dl[:, 0:1]
    for k in range(1, n):
        pdl = pdl + P[:, :, k] * dl[:, k : k + 1]
    return (dl,) + coord_dgamma_plain(g, pdl, am, slots)


def coord_duals_plain(P, q, l, l_min, l_max, v_sign, kind, eps, act_eps):
    """K4's steps 1-2: (am, slots), am the (B, n) strict mask as 0 / 1 in
    l's dtype; for the box kinds ``slots`` = (coef, gam, strict), one entry
    per slot [lo, hi(, sg)], else None."""
    n = l.shape[-1]
    dtype = l.dtype
    plq = q
    for k in range(n):
        plq = plq + P[:, :, k] * l[:, k : k + 1]

    if kind == KIND_QP:
        return ((l <= eps) & (plq > act_eps)).to(dtype), None
    rhs = -plq
    acts = [((l - l_min) <= eps).to(dtype), ((l - l_max) >= -eps).to(dtype)]
    if kind == KIND_SIGNED_BOX:
        acts.append((v_sign * l >= -eps).to(dtype) * (v_sign * v_sign))
    denom = torch.clamp_min(sum(acts), 1.0)
    coef = [-1.0, 1.0, v_sign][: len(acts)]
    gam = [a * c * rhs / denom for a, c in zip(acts, coef)]
    strict = [a * (gk > act_eps).to(dtype) for a, gk in zip(acts, gam)]
    return torch.clamp_max(sum(strict), 1.0), (coef, gam, strict)


def coord_dgamma_plain(g, pdl, am, slots):
    """K4's step 5 for the box kinds, from P dl: (dgamma, gamma), the
    residual (g - P dl) am split over the strict slots at minimal norm."""
    coef, gam, strict = slots
    resid = (g - pdl) * am
    cs = [c * gk * m for c, gk, m in zip(coef, gam, strict)]
    den = torch.clamp_min(sum(c * c for c in cs), TINY)
    dgamma = torch.cat([c * resid / den for c in cs], dim=-1)
    return dgamma, torch.cat(gam, dim=-1)


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("coord_bwd")
    if not getattr(lib, "_dq_typed", False):
        vp, f = ctypes.c_void_p, ctypes.c_float
        lib.dq_coord_bwd_f32.argtypes = [vp] * 10 + [ctypes.c_int] * 3 + [f] * 2 + [vp]
        lib.dq_coord_bwd_f32.restype = ctypes.c_int
        lib.dq_coord_bwd_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dq_coord_bwd_blocks_per_sm.restype = ctypes.c_int
        lib._dq_typed = True
    return lib


ONE_WARP_MAX_N = 32   # csrc/coord_bwd.cu's kOneWarpMaxN: the one-warp kernel up to here
BLOCK_THREADS = 256   # csrc/coord_bwd.cu's kBwThreads: the block-wide kernel's threads


def threads(n: int) -> int:
    """Threads of K4's block at problem size n, which is also the kernel's
    ``__launch_bounds__``: one warp to n = 32, then eight."""
    return 32 if n <= ONE_WARP_MAX_N else BLOCK_THREADS


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one block at problem size n (as
    ``smem_bytes`` in csrc/coord_bwd.cu computes it): P and the free
    block's factor (n x (n|1) each) and, at one warp (n <= 32), the publish
    slots, l and the map of free coordinates (128 words); above it six
    n-vectors (the factor's published columns, l then dl, 1 / L_ff, the
    map, and slots)."""
    return 4 * (2 * n * (n | 1) + (128 if n <= ONE_WARP_MAX_N else 6 * n))


def c_blocks_per_sm(n: int, kind: int) -> int:
    """Blocks of K4 of ``kind`` at size n that one SM of the current card
    holds, from CUDA's occupancy calculator (needs nvcc and a card)."""
    return _lib().dq_coord_bwd_blocks_per_sm(n, kind)


def fits(n: int) -> bool:
    """Whether K4 launches at size n on a Hopper card: ``smem_bytes(n)``
    within the 232,448 bytes a block may opt into (n <= 168) and its block
    within its launch bound; the dispatch rule decides on it."""
    return _build.fits(threads(n), smem_bytes(n), threads(n))


def _bounds(kind, l_min, l_max, v_sign) -> tuple:
    """The kind's bound tensors (its first ``_SLOTS[kind]`` of l_min, l_max,
    v_sign); raises if one is missing or one more is given."""
    if kind not in _SLOTS:
        raise ValueError(f"unknown kind {kind}")
    given = (l_min, l_max, v_sign)
    if tuple(t is not None for t in given) != tuple(i < _SLOTS[kind] for i in range(3)):
        raise ValueError(
            f"kind {kind} takes the first {_SLOTS[kind]} of l_min, l_max, v_sign"
        )
    return given[: _SLOTS[kind]]


def _check(P, q, l, g, bounds):
    if l.ndim != 2:
        raise ValueError(f"l must be (B, n), got {tuple(l.shape)}")
    B, n = l.shape
    if tuple(P.shape) != (B, n, n):
        raise ValueError(f"P must be (B, n, n) = {(B, n, n)}, got {tuple(P.shape)}")
    for name, t in (("q", q), ("g", g)) + tuple(("bound", t) for t in bounds):
        if tuple(t.shape) != (B, n):
            raise ValueError(f"{name} must be {(B, n)}, got {tuple(t.shape)}")
    dtypes = {t.dtype for t in (P, q, l, g) + bounds}
    if len(dtypes) != 1 or not l.dtype.is_floating_point:
        raise TypeError(f"inputs must share one floating dtype, got {sorted(map(str, dtypes))}")


def coord_kkt_bwd_fused_cuda(
    P: torch.Tensor,
    q: torch.Tensor,
    l: torch.Tensor,
    g: torch.Tensor,
    l_min: torch.Tensor | None,
    l_max: torch.Tensor | None,
    v_sign: torch.Tensor | None,
    kind: int,
    eps: float,
    act_eps: float,
) -> tuple[torch.Tensor, ...]:
    """K4: the whole QP-family backward of a batch in one launch. Returns
    (dl,) for ``KIND_QP``, (dl, dgamma, gamma) for the box kinds.

    CPU tensors go to ``coord_kkt_bwd_fused_plain``. CUDA tensors must be
    contiguous float32 on one device; the kernel is launched on the current
    stream (no synchronisation) or this raises. ``coord_kkt_bwd_fused_cuda.
    launches`` counts the launches this wrapper issues or, inside a CUDA
    graph capture, records: a replay of the graph runs the kernel again and
    counts nothing.
    """
    bounds = _bounds(kind, l_min, l_max, v_sign)
    tensors = (P, q, l, g) + bounds
    _check(P, q, l, g, bounds)
    if all(t.device.type == "cpu" for t in tensors):
        return coord_kkt_bwd_fused_plain(P, q, l, g, l_min, l_max, v_sign, kind, eps, act_eps)
    B, n = l.shape
    dev = _build.check_launch(tensors, threads(n), smem_bytes(n), threads(n))

    lib = _lib()
    dl = torch.empty_like(l)
    dgamma = torch.empty((B, _SLOTS[kind] * n), dtype=l.dtype, device=dev)
    gamma = torch.empty_like(dgamma)
    ptr = lambda t: None if t is None or t.numel() == 0 else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dq_coord_bwd_f32(
            *(ptr(t) for t in (P, q, l, g, l_min, l_max, v_sign, dl, dgamma, gamma)),
            B, n, kind, eps, act_eps, stream,
        )
    _build.check_rc(lib, rc, f"coord_bwd (kind={kind}, B={B}, n={n})")
    _build.count_launch(coord_kkt_bwd_fused_cuda)
    return (dl,) if kind == KIND_QP else (dl, dgamma, gamma)


coord_kkt_bwd_fused_cuda.launches = 0
