"""Fused ADMM forward solve: the CUDA kernel K1 and its plain version.

``admm_solve_cuda`` replaces ``diffqcqp_tpu/kernels/admm_pallas.py::
admm_solve_pallas`` (kernel ``_admm_chol_kernel``). On a CUDA tensor it
launches ``kernels/csrc/admm.cu`` (one thread block per problem; see the note
at the top of that file) or raises; on a CPU tensor it runs
``admm_solve_plain``. There is no fallback from one to the other.

``admm_solve_plain`` repeats the kernel's arithmetic on whole batches in a
masked eager loop, in any dtype: power iteration, left-looking Cholesky ->
zero-diagonal LDL^T -> (2n + 1)-step solves (``kernels/ldl.py``), the same
update order, stopping rules, stall floors and adaptive-rho gating. The CPU
path and the tests use it; ``chip_smoke.py`` holds the kernel against it on
the card. Its stall floor is ``stall_tol * finfo(dtype).eps`` (the kernel's
float32 floor at float32, the XLA engine's at float64).

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
from .ldl import TINY, chol_factor, chol_to_unit, ldl_solve

__all__ = [
    "PROX_NONNEG", "PROX_BOX", "PROX_SIGNED_BOX", "PROX_DISK",
    "admm_solve_cuda", "admm_solve_plain", "smem_bytes",
]

PROX_NONNEG = 0
PROX_BOX = 1
PROX_SIGNED_BOX = 2
PROX_DISK = 3
_N_ARGS = {PROX_NONNEG: 0, PROX_BOX: 2, PROX_SIGNED_BOX: 3, PROX_DISK: 1}


def _prox_fn(prox_kind: int, prox_args: tuple):
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
    """(P x) accumulated over columns in order, as the kernels do."""
    acc = P[:, :, 0] * x[:, 0:1]
    for k in range(1, P.shape[-1]):
        acc = acc + P[:, :, k] * x[:, k : k + 1]
    return acc


def _factor(P, shift):
    return chol_to_unit(chol_factor(P, shift))


def admm_solve_plain(
    P: torch.Tensor,
    q: torch.Tensor,
    warm_start: torch.Tensor,
    prox_kind: int,
    prox_args: tuple,
    cfg: SolverConfig,
    qcqp_stopping: bool = False,
    damp_both: bool = True,
) -> tuple[torch.Tensor, SolveStats]:
    """K1's plain PyTorch version, over a whole batch in the inputs' dtype
    and on their device. P (B, n, n) symmetric, q and warm_start (B, n)."""
    B, n = q.shape
    dtype, dev = q.dtype, q.device
    prox = _prox_fn(prox_kind, prox_args)

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
        nrm = torch.sqrt(torch.sum(av * av, dim=-1, keepdim=True))
        v = av / torch.maximum(nrm, tiny)
    L = torch.maximum(torch.sum(v * _matvec(P, v), dim=-1), mu)
    ratio = L / mu
    rho = torch.sqrt(mu * L) * torch.pow(ratio, c(0.4)) * c(cfg.rho0_scale)
    tau0 = torch.pow(ratio, c(0.15))

    Lh, dinv = _factor(P, rho + mu)
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
        l = ldl_solve(Lh, dinv, rc * l2 - u - q_prox)
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
            lnorm = torch.sqrt(torch.sum(l * l, dim=-1))
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
            # refactor only the problems whose rho changed (the factor is a
            # pure function of (P, rho), so the others keep theirs)
            changed = torch.nonzero(app_inc | app_dec).flatten()
            if changed.numel():
                Lh_c, dinv_c = _factor(P[changed], rho_n[changed] + mu)
                Lh = Lh.index_copy(0, changed, Lh_c)
                dinv = dinv.index_copy(0, changed, dinv_c)

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
        lib._dq_typed = True
    return lib


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one block at problem size n (as
    ``smem_bytes`` in csrc/admm.cu computes it): two n x (n|1) matrices, five
    n-vectors of broadcast/scratch slots, 128 reduction slots."""
    return 4 * (2 * n * (n | 1) + 5 * n + 128)


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
    admm_solve_cuda.launches += 1
    return l2, SolveStats(iters, resp, resd, rho, conv, stall)


admm_solve_cuda.launches = 0
