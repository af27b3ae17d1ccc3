"""Fused ADMM forward solve: the CUDA kernel K1 and its plain version.

``admm_solve_cuda`` replaces ``diffqcqp_tpu/kernels/admm_pallas.py::
admm_solve_pallas`` (kernel ``_admm_chol_kernel``). On a CUDA tensor it
launches ``kernels/csrc/admm.cu`` (one thread block per problem; see the note
at the top of that file) or raises; on a CPU tensor it runs
``admm_solve_plain``. There is no fallback from one to the other.

``admm_solve_plain`` repeats the kernel's arithmetic on whole batches in a
masked eager loop, in any dtype: power iteration; the explicit inverse of
P + (rho + mu) I by the kernel's Gauss-Jordan elimination (``gj_inverse``)
and one refined solve per iteration (``_refined_solve``: two products with
the inverse, in the kernel's four partial sums, around a residual taken in
float64); and the same update order, stopping rules, stall floors and
adaptive-rho gating, forming a new inverse wherever rho changed. The CPU
path and the tests use it; ``chip_smoke.py`` holds the kernel against it on
the card.
Its stall floor is ``stall_tol * finfo(dtype).eps`` (the kernel's float32
floor at float32, the XLA engine's at float64).

``fits(n)`` says whether the kernel launches at size n on a Hopper card (its
shared memory and block size); ``api.py::_use_kernel`` dispatches on it.

Prox kinds and their ``prox_args``, as in the JAX kernel:

    PROX_NONNEG      ()
    PROX_BOX         (l_min, l_max)            each (B, n)
    PROX_SIGNED_BOX  (l_min, l_max, v_sign)    each (B, n)
    PROX_DISK        (radius,)                 (B, n // 2), reference order
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import SolverConfig
from ..ops.prox import prox_box, prox_disk, prox_nonneg, prox_signed_box
from ..solvers.admm import SolveStats
from . import _build
from .ldl import TINY

__all__ = [
    "PROX_NONNEG", "PROX_BOX", "PROX_SIGNED_BOX", "PROX_DISK",
    "admm_solve_cuda", "admm_solve_plain", "fits", "gj_inverse", "prox_fn", "smem_bytes",
]

PROX_NONNEG = 0
PROX_BOX = 1
PROX_SIGNED_BOX = 2
PROX_DISK = 3
_N_ARGS = {PROX_NONNEG: 0, PROX_BOX: 2, PROX_SIGNED_BOX: 3, PROX_DISK: 1}
_GJ = 4     # Gauss-Jordan steps a pass (kGJ in csrc/admm.cu)


def prox_fn(prox_kind: int, prox_args: tuple):
    """The projection of a prox kind with its arguments, over (B, n)."""
    if prox_kind == PROX_NONNEG:
        return prox_nonneg
    if prox_kind == PROX_BOX:
        return lambda x: prox_box(x, *prox_args)
    if prox_kind == PROX_SIGNED_BOX:
        return lambda x: prox_signed_box(x, *prox_args)
    if prox_kind == PROX_DISK:
        return lambda x: prox_disk(x, prox_args[0])
    raise ValueError(f"unknown prox_kind {prox_kind}")


def _matvec(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(P x) accumulated over columns in order in fused multiply-adds, as
    the kernel's ``matvec``."""
    acc = P[:, :, 0] * x[:, 0:1]
    for k in range(1, P.shape[-1]):
        acc = _fma(P[:, :, k], x[:, k : k + 1], acc)
    return acc


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once in float32, as the kernel's fmaf: the product of
    two float32 values is exact in float64 and the sum is rounded there,
    then to float32 (a second rounding that changes the result only when
    the float64 sum is a float32 tie). Any other dtype: a b + c."""
    if c.dtype != torch.float32:
        return c + a * b
    return (c.double() + a.double() * b.double()).float()


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of x (B, n) in the kernel's order
    (``block_reduce``): a butterfly within each warp of 32 rows (the rows
    past n add 0), then the warps' sums in order."""
    B, n = x.shape
    nw = -(-n // 32)
    x = torch.nn.functional.pad(x, (0, 32 * nw - n)).view(B, nw, 32)
    for h in (16, 8, 4, 2, 1):
        x = x[..., :h] + x[..., h : 2 * h]
    acc = x[:, 0, 0]
    for w in range(1, nw):
        acc = acc + x[:, w, 0]
    return acc


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """x ** e with e rounded to x's dtype, taken in float64 and rounded once
    to x's dtype, as the kernel takes it."""
    e = torch.tensor(e, dtype=x.dtype).item()
    return torch.pow(x.double(), e).to(x.dtype)


def gj_inverse(P: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(P + shift I)^{-1} for symmetric positive definite P (B, n, n), shift
    (B,), by in-place Gauss-Jordan elimination without pivoting, with the
    arithmetic of the kernel's ``csrc/admm.cu::gj_inverse``: row r of the
    working matrix A belongs to thread r, and step c eliminates column c.
    Row c of A is not read: by symmetry of the original and of the active
    Schur complement, the pivot row equals column c with the sign of its
    finished entries (j < c) flipped, so each row publishes its own column-c
    entry, w_j = -A[j, c] (j < c), A[j, c] (j > c), w_c = 1, with the pivot
    p = A[c, c] floored at ``TINY``. Then every row j != c takes g = A[j, c]
    / p, sets A[j, c] = 0 and A[j, :] -= g w, and row c becomes w / p. The
    kernel takes the steps in passes of ``_GJ``: an update of the pass's own
    columns is rounded twice (the product, then the difference; it runs in
    registers), any other one once (a fused multiply-add), and so here. The
    result is a row-wise inverse, symmetric up to rounding."""
    B, n, _ = P.shape
    A = P + shift[:, None, None] * torch.eye(n, dtype=P.dtype, device=P.device)
    rows = torch.arange(n, device=P.device)
    for c in range(n):
        col = A[:, :, c]
        w = torch.where(rows < c, -col, col)
        w[:, c] = 1.0
        pinv = 1.0 / torch.clamp_min(col[:, c], TINY)
        g = col * pinv[:, None]
        g[:, c] = 0.0
        A[:, :, c] = torch.where(rows == c, A[:, :, c], torch.zeros_like(col))
        c0 = c - c % _GJ
        own = (rows >= c0) & (rows < c0 + _GJ)
        gw = g[:, :, None] * w[:, None, :]
        A = torch.where(own, A - gw, _fma(-g[:, :, None], w[:, None, :], A))
        A[:, c, :] = w * pinv[:, None]
    return A


def _matvec4(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(P x) in four partial sums of fused multiply-adds, column c into sum
    c % 4, then (s0 + s1) + (s2 + s3), as the kernel's ``row_dot4``."""
    s = [torch.zeros_like(x) for _ in range(4)]
    for c in range(P.shape[-1]):
        s[c % 4] = _fma(P[:, :, c], x[:, c : c + 1], s[c % 4])
    return (s[0] + s[1]) + (s[2] + s[3])


def _refined_solve(P, Minv, rhs, shift):
    """(P + shift I)^{-1} rhs from the explicit inverse, with one step of
    refinement whose residual is taken in float64 (the kernel's
    ``refined_solve``): l0 = Minv rhs, res = rhs - (P l0 + shift l0) in
    float64 (each product of two float32 values is exact there, so for the
    same l0 this is the kernel's residual bit for bit), l = l0 + Minv res."""
    wide = torch.float64
    l0 = _matvec4(Minv, rhs)
    l0w = l0.to(wide)
    res = rhs.to(wide) - (_matvec4(P.to(wide), l0w) + shift.to(wide)[:, None] * l0w)
    return l0 + _matvec4(Minv, res.to(rhs.dtype))


def admm_solve_plain(
    P: torch.Tensor,
    q: torch.Tensor,
    warm_start: torch.Tensor,
    prox_kind: int,
    prox_args: tuple,
    cfg: SolverConfig,
    qcqp_stopping: bool = False,
    damp_both: bool = True,
    factors: torch.Tensor | None = None,
) -> tuple[torch.Tensor, SolveStats]:
    """K1's plain PyTorch version, over a whole batch in the inputs' dtype
    and on their device. P (B, n, n) symmetric, q and warm_start (B, n).
    It iterates against the explicit inverse (``gj_inverse``,
    ``_refined_solve``), as the kernel does. ``factors``, a (B,) integer
    tensor, gets one added per problem for each inverse the solve forms (the
    first, and one per rho change)."""
    B, n = q.shape
    dtype, dev = q.dtype, q.device
    prox = prox_fn(prox_kind, prox_args)

    def c(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    eps, eps_rel, mu = c(cfg.eps), c(cfg.eps_rel), c(cfg.mu_prox)
    alpha, one_m_alpha = c(cfg.alpha_relax), c(1.0) - c(cfg.alpha_relax)
    mu_thresh, damp, tiny = c(cfg.mu_thresh), c(cfg.tau_damping), c(TINY)
    floor = c(cfg.stall_tol * torch.finfo(dtype).eps)
    one = c(1.0)

    # power iteration for L, then rho0 and tau0
    v = torch.full((B, n), 1.0 / math.sqrt(n), dtype=dtype, device=dev)
    for _ in range(cfg.power_iters):
        av = _matvec(P, v)
        nrm = torch.sqrt(_block_sum(av * av))[:, None]
        v = av / torch.maximum(nrm, tiny)
    L = torch.maximum(_block_sum(v * _matvec(P, v)), mu)
    ratio = L / mu
    rho = torch.sqrt(mu * L) * _pow(ratio, 0.4) * c(cfg.rho0_scale)
    tau0 = _pow(ratio, 0.15)

    X = gj_inverse(P, rho + mu)
    if factors is not None:
        factors += 1
    l2 = warm_start.to(dtype).clone()
    u = -(_matvec(P, l2) + q) if cfg.warm_start_dual else torch.zeros_like(q)
    q_prox = q.clone()
    tau_inc, tau_dec = tau0.clone(), tau0.clone()
    rho_up = torch.zeros(B, dtype=torch.int32, device=dev)
    cpt = torch.zeros(B, dtype=torch.int32, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    stall = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    resp = torch.full((B,), math.inf, dtype=dtype, device=dev)
    resd = torch.full((B,), math.inf, dtype=dtype, device=dev)
    rho_rec = rho.clone()
    primal_test = qcqp_stopping or cfg.primal_check

    for it in range(cfg.max_iter):
        if bool(conv.all()):
            break
        active = ~conv
        rc = rho[:, None]
        l = _refined_solve(P, X, rc * l2 - u - q_prox, rho + mu)
        q_prox_n = q - mu * l
        r = alpha * l + one_m_alpha * l2
        l2_n = prox(r + u / rc)
        u_n = u + rc * (r - l2_n)
        delta = torch.amax(torch.abs(l2_n - l2), dim=-1)
        rd = rho * delta
        rp = torch.amax(torch.abs(l2_n - r), dim=-1)

        eps_ok = rd < eps
        noise = floor * torch.maximum(torch.amax(torch.abs(l2_n), dim=-1), one)
        dual_ok = eps_ok | (delta <= noise) if cfg.stall_tol > 0.0 else eps_ok
        if primal_test:
            lnorm = torch.sqrt(_block_sum(l * l))
            prim_eps = rp < eps + eps_rel * lnorm
            prim_ok = prim_eps | (rp <= noise) if cfg.stall_tol > 0.0 else prim_eps
            newly = prim_ok & dual_ok
            certified = eps_ok & prim_eps
        else:
            newly = dual_ok
            certified = eps_ok

        rho_n = rho
        if cfg.adaptive_rho:
            adapt = active & ~newly
            inc = adapt & (rp > mu_thresh * rd)
            dec = adapt & ~inc & (rd > mu_thresh * rp)
            fire = inc | dec
            if cfg.rho_sync:
                gate = it % cfg.rho_update_period == 0 and it > 0
            else:
                gate = cpt % cfg.rho_update_period == 0
            app_inc, app_dec = inc & gate, dec & gate
            flip_inc = app_inc & (rho_up == -1)
            flip_dec = app_dec & (rho_up == 1)
            damped_inc = one + damp * (tau_inc - one)
            damped_dec = one + damp * (tau_dec - one)
            if damp_both:
                dm = flip_inc | flip_dec
                tau_inc = torch.where(dm, damped_inc, tau_inc)
                tau_dec = torch.where(dm, damped_dec, tau_dec)
            else:
                tau_inc = torch.where(flip_inc, damped_inc, tau_inc)
                tau_dec = torch.where(flip_dec, damped_dec, tau_dec)
            rho_n = torch.where(
                app_inc, rho * tau_inc, torch.where(app_dec, rho / tau_dec, rho)
            )
            rho_up = torch.where(
                app_inc, 1, torch.where(app_dec, -1, rho_up)
            ).to(torch.int32)
            cpt = cpt + fire.to(torch.int32)
            # a new inverse only for the problems whose rho changed (it is a
            # pure function of (P, rho), so the others keep theirs)
            changed = torch.nonzero(app_inc | app_dec).flatten()
            if changed.numel():
                X = X.index_copy(0, changed, gj_inverse(P[changed], rho_n[changed] + mu))
                if factors is not None:
                    factors[changed] += 1

        m = active[:, None]
        l2 = torch.where(m, l2_n, l2)
        u = torch.where(m, u_n, u)
        q_prox = torch.where(m, q_prox_n, q_prox)
        resp = torch.where(active, rp, resp)
        resd = torch.where(active, rd, resd)
        rho_rec = torch.where(active, rho, rho_rec)
        conv = conv | (active & newly)
        stall = stall | (active & newly & ~certified)
        iters = iters + active.to(torch.int32)
        rho = rho_n

    return l2, SolveStats(iters, resp, resd, rho_rec, conv, stall)


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

class _Params(ctypes.Structure):
    # field for field the AdmmParams struct of csrc/admm.cu
    _fields_ = [
        (name, ctypes.c_float) for name in (
            "eps", "eps_rel", "mu_prox", "alpha", "mu_thresh", "damp",
            "rho0_scale", "stall_floor", "v0",
        )
    ] + [
        (name, ctypes.c_int) for name in (
            "n", "max_iter", "rho_update_period", "power_iters", "prox_kind",
            "adaptive_rho", "rho_sync", "warm_start_dual", "primal_test",
            "damp_both", "stall_on",
        )
    ]


_F32_EPS = 1.1920929e-7   # the kernel works in float32 whatever the caller's dtype


def _lib():
    lib = _build.load("admm")
    if not getattr(lib, "_dq_typed", False):
        vp = ctypes.c_void_p
        lib.dq_admm_solve_f32.argtypes = [vp] * 13 + [
            ctypes.c_int, ctypes.POINTER(_Params), vp,
        ]
        lib.dq_admm_solve_f32.restype = ctypes.c_int
        lib.dq_admm_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.dq_admm_blocks_per_sm.restype = ctypes.c_int
        lib._dq_typed = True
    return lib


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one block at problem size n (as
    ``smem_bytes`` in csrc/admm.cu computes it): two n x (n|1) matrices, five
    n-vectors of broadcast/scratch slots, 32 reduction slots (4 for each of
    at most 8 warps)."""
    return 4 * (2 * n * (n | 1) + 5 * n + 32)


def c_blocks_per_sm(n: int) -> int:
    """Blocks of K1 at size n that one SM of the current card holds, from
    CUDA's occupancy calculator (needs nvcc and a card)."""
    return _lib().dq_admm_blocks_per_sm(n)


def fits(n: int) -> bool:
    """Whether K1 launches at size n on a Hopper card: a block of
    ``row_threads(n)`` threads within its ``__launch_bounds__`` and
    ``smem_bytes(n)`` within the 232,448 bytes a block may opt into (n <=
    169). The card's own bound; the JAX kernel's automatic N <= 112 is the
    TPU's VMEM bound and does not apply here."""
    return _build.fits(_build.row_threads(n), smem_bytes(n), _build.ROW_BOUND)


def _check(P, q, ws, prox_kind, prox_args, cfg):
    if prox_kind not in _N_ARGS:
        raise ValueError(f"unknown prox_kind {prox_kind}")
    if len(prox_args) != _N_ARGS[prox_kind]:
        raise ValueError(
            f"prox_kind {prox_kind} takes {_N_ARGS[prox_kind]} prox_args, "
            f"got {len(prox_args)}"
        )
    if q.ndim != 2:
        raise ValueError(f"q must be (B, n), got {tuple(q.shape)}")
    B, n = q.shape
    if tuple(P.shape) != (B, n, n):
        raise ValueError(f"P must be (B, n, n) = {(B, n, n)}, got {tuple(P.shape)}")
    if tuple(ws.shape) != (B, n):
        raise ValueError(f"warm_start must be {(B, n)}, got {tuple(ws.shape)}")
    want = (B, n // 2) if prox_kind == PROX_DISK else (B, n)
    for a in prox_args:
        if tuple(a.shape) != want:
            raise ValueError(f"prox arg must be {want}, got {tuple(a.shape)}")
    if cfg.rho_update_period < 1:
        raise ValueError("rho_update_period must be >= 1")


def admm_solve_cuda(
    P: torch.Tensor,
    q: torch.Tensor,
    warm_start: torch.Tensor,
    prox_kind: int,
    prox_args: tuple,
    cfg: SolverConfig,
    qcqp_stopping: bool = False,
    damp_both: bool = True,
) -> tuple[torch.Tensor, SolveStats]:
    """K1: the whole ADMM forward solve of a batch in one launch.

    CPU tensors go to ``admm_solve_plain``. CUDA tensors must be contiguous
    float32 on one device; the kernel is launched on the current stream (no
    synchronisation) or this raises. ``admm_solve_cuda.launches`` counts the
    launches.
    """
    tensors = (P, q, warm_start) + tuple(prox_args)
    _check(P, q, warm_start, prox_kind, prox_args, cfg)
    if all(t.device.type == "cpu" for t in tensors):
        return admm_solve_plain(
            P, q, warm_start, prox_kind, prox_args, cfg, qcqp_stopping, damp_both
        )
    B, n = q.shape
    dev = _build.check_launch(tensors, _build.row_threads(n), smem_bytes(n), _build.ROW_BOUND)

    lib = _lib()
    prm = _Params(
        eps=cfg.eps, eps_rel=cfg.eps_rel, mu_prox=cfg.mu_prox,
        alpha=cfg.alpha_relax, mu_thresh=cfg.mu_thresh, damp=cfg.tau_damping,
        rho0_scale=cfg.rho0_scale, stall_floor=cfg.stall_tol * _F32_EPS,
        v0=1.0 / math.sqrt(n),
        n=n, max_iter=cfg.max_iter, rho_update_period=cfg.rho_update_period,
        power_iters=cfg.power_iters, prox_kind=prox_kind,
        adaptive_rho=int(cfg.adaptive_rho), rho_sync=int(cfg.rho_sync),
        warm_start_dual=int(cfg.warm_start_dual),
        primal_test=int(qcqp_stopping or cfg.primal_check),
        damp_both=int(damp_both), stall_on=int(cfg.stall_tol > 0.0),
    )
    l2 = torch.empty_like(q)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    resp = torch.empty(B, dtype=torch.float32, device=dev)
    resd = torch.empty(B, dtype=torch.float32, device=dev)
    rho = torch.empty(B, dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    stall = torch.empty(B, dtype=torch.bool, device=dev)
    pargs = list(prox_args) + [None] * (3 - len(prox_args))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dq_admm_solve_f32(
            ptr(P), ptr(q), ptr(warm_start), *(ptr(a) for a in pargs),
            ptr(l2), ptr(iters), ptr(resp), ptr(resd), ptr(rho), ptr(conv),
            ptr(stall), B, ctypes.byref(prm), stream,
        )
    _build.check_rc(lib, rc, f"admm (B={B}, n={n})")
    _build.count_launch(admm_solve_cuda)
    return l2, SolveStats(iters, resp, resd, rho, conv, stall)


admm_solve_cuda.launches = 0
