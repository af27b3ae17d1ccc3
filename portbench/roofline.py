"""The yardstick of the kernels' roofline shares, and the device's busy time.

``bound_ms``, ``k1_bound_ms``, ``schur_flops``, ``k2_bound_ms`` and
``k4_bound_ms`` are a frozen copy of ``chip_smoke.py``'s functions of the
same names as of commit f1cc821 (peaks: H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s float32
outside the tensor cores). They stay as they are here whatever happens to
the originals, so that a later change to a kernel is read against the same
work. The counts fed to them come from the benchmark's side: iterations and
factorisations per problem from the configuration's file, strictly active
contacts from the plain reference.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM data sheet, float32 outside the tensor cores


def k1_bound_ms(B, n, nc, iters, factors, power_iters):
    """Least time for a K1 solve on an H100 SXM: the larger of bytes (inputs
    read once, outputs written once) over the memory rate and FLOPs over the
    float32 peak. FLOPs count the least work this run's data needs, by the
    LDL^T route whatever K1 runs: power iteration, n^3 / 3 + n^2 per
    factorisation (``factors``: per problem, the first and one per rho
    change, counted by the plain version), and per executed iteration two
    triangular sweeps (n^2 / 2 multiply-adds each) plus ~21 n of vector
    updates and reductions."""
    bytes_ = 4 * (B * n * n + 2 * B * n + B * nc) + 4 * B * n + B * (4 * 4 + 2)
    per_prob = (power_iters + 1) * (2 * n * n + 3 * n)
    per_factor = n ** 3 / 3 + n * n
    per_iter = 2 * n * n + 21 * n
    return bound_ms(bytes_, B * per_prob + float(factors.sum()) * per_factor
                    + float(iters.sum()) * per_iter)


def bound_ms(bytes_, flops, peak=FP32_FLOPS):
    """(ms, what bounds it, bytes, FLOPs): the larger of the bytes over the
    memory rate and the FLOPs over ``peak`` (the float32 one by default)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), bytes_, flops


def schur_flops(B, n, nc, active):
    """FLOPs of the Schur adjoint (K2's steps 4-8, the whole of K6) that this
    run's data needs: per problem the Cholesky of D (n^3 / 3), the g solve
    (2 n^2), C^T W for M and y (4 n (nc + 1)), the QR of the nc x (nc + 1)
    system (4 nc^3 / 3), the back substitution (nc^2) and dl (2 n nc); per
    strictly active contact c its solve, whose forward sweep starts at row 2c
    ((n - 2c)^2 + n^2). ``active`` is the (B, nc) mask."""
    c = torch.arange(nc, dtype=torch.float64, device=active.device)
    solves = float((active.double() * ((n - 2 * c) ** 2 + n * n)).sum())
    per_prob = n ** 3 / 3 + 2 * n * n + 4 * n * (nc + 1) + 4 * nc ** 3 / 3 + nc * nc + 2 * n * nc
    return B * per_prob + solves


def k2_bound_ms(B, n, nc, active):
    """Least time for K2 on an H100 SXM: bytes of P, q, l, g and radius read
    once and dgamma, dl and gamma written once, against P l + q (2 n^2 per
    problem) and ``schur_flops``."""
    bytes_ = 4 * (B * n * n + 3 * B * n + B * nc) + 4 * (B * n + 2 * B * nc)
    return bound_ms(bytes_, schur_flops(B, n, nc, active) + B * 2 * n * n)


def k4_bound_ms(B, n, slots, n_bounds):
    """Least time for K4 on an H100 SXM: bytes of P, q, l, g and the class's
    ``n_bounds`` bound vectors read once and dl (and, for the box kinds,
    dgamma and gamma of ``slots`` n entries each) written once, against the
    FLOPs per problem: 2 n^2 for P l + q, n^3 / 3 for the factor, 2 n^2 for
    the solve, and 2 n^2 for the box kinds' residual."""
    bytes_ = 4 * B * (n * n + (3 + n_bounds) * n) + 4 * B * n * (1 + 2 * slots)
    return bound_ms(bytes_, B * (4 * n * n + n ** 3 / 3 + (2 * n * n if slots else 0)))


def union_seconds(intervals, lo, hi) -> float:
    """Seconds covered by the union of ``intervals`` ((start, end) pairs, in
    seconds) inside [lo, hi]. Overlapping intervals count once, so the busy
    time never exceeds the window and the idle share never reads below 0."""
    busy, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            busy += e - s
            reach = e
    return busy


def gaps(intervals, lo, hi) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in order."""
    out, reach = [], lo
    for s, e in sorted(intervals):
        if s > reach and reach < hi:
            out.append((reach, min(s, hi)))
        reach = max(reach, e)
    if reach < hi:
        out.append((reach, hi))
    return out
