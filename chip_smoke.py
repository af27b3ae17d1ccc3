"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``diffqcqp_tpu_torch/kernels/csrc`` and
drives the port's main path: the friction-cone QCQP forward solve at B=4096,
N=24 (12 contacts) with the benchmark generator and configuration (seed 0).
Phases, each of which fails the run if its check fails:

  1. the card: name and power limit (nvidia-smi), kernel build time;
  2. kernel K1 (``admm_solve_cuda``) against its plain PyTorch version
     (``admm_solve_plain``) on the same card inputs: at the flagship point,
     for all four prox kinds and the rho_sync=False, primal_check=False,
     max_iter and warm_start_dual branches at B=256, N=12, and at N=96,
     B=512 (three warps per block). Bars: max |dl| <= 2e-5, per-problem
     |d iterations| <= 1, equal ``converged``;
  3. the slice through ``solve_qcqp_with_stats`` (launch counters zeroed
     just before, read just after): K1 launched, every problem converged,
     every contact feasible, and max |dl| <= 1e-4 against the plain version
     in float64 on the card at eps=1e-10 (the accuracy referee);
  4. timing at the flagship point: K1 and the entry point per call over
     back-to-back calls with CUDA events (warm-up, median of samples; K1's
     is the ``ms`` reported), K1's device time per launch from
     torch.profiler (and its set-up alone, max_iter=0), and the plain
     version;
  5. one JSON line of every ported kernel, then as the last line
     ``{"ok": true, "device": {...}}``.

Imports torch, numpy and the port only. Exits non-zero without a result
when no CUDA device is present or the port cannot be imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B_FLAG, NC_FLAG = 4096, 12
ITER_ANCHOR = 17.21       # mean iterations of the JAX package at this config (its r04 record)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM data sheet, float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def build_problems(b, nc, seed=0):
    """The benchmark generator (bench.py::_build_problems), float32."""
    n = 2 * nc
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)).astype(np.float32) / np.sqrt(n)
    P = s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32)
    q = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    l_n = (rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32)
    mu = (rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32)
    return tuple(x.astype(np.float32) for x in (P, q, l_n, mu))


def cuda(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in xs)


def compare(name, out_k, out_p, tol=2e-5):
    """K1 against its plain version; fails on the bars, returns max |dl|."""
    (lk, sk), (lp, sp) = out_k, out_p
    dl = float((lk - lp).abs().max())
    dit = (sk.iterations - sp.iterations).abs()
    conv_eq = bool((sk.converged == sp.converged).all())
    stall_eq = int((sk.stalled != sp.stalled).sum())
    log(f"  {name}: max|dl|={dl:.3e} max|d iters|={int(dit.max())} "
        f"problems with |d iters|>1: {int((dit > 1).sum())}/{dit.numel()} "
        f"converged equal={conv_eq} stalled {int(sk.stalled.sum())} "
        f"(differ on {stall_eq}) "
        f"kernel mean iters={float(sk.iterations.float().mean()):.3f} "
        f"plain mean iters={float(sp.iterations.float().mean()):.3f}")
    if not (dl <= tol and int(dit.max()) <= 1 and conv_eq and torch.isfinite(lk).all()):
        raise AssertionError(f"K1 disagrees with its plain version: {name}")
    return dl


def time_cuda(fn, reps, calls=1):
    """Median milliseconds per call of ``fn`` over ``reps`` samples, CUDA
    events around ``calls`` back-to-back calls each. With several calls the
    device queue stays full, so a fast kernel is not timed as the host's
    enqueue latency (one call per sample times the wrapper's Python work)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / calls)
    return float(np.median(ts)), ts


def kernel_device_ms(fn, kernel, calls=10):
    """Mean device time per launch of the kernel whose name contains
    ``kernel``, from torch.profiler's CUDA activity; None when the trace
    holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key:
            return ev.device_time_total / 1e3 / ev.count
    return None


def k1_bound_ms(B, n, nc, iters, power_iters):
    """Least time for the flagship solve on an H100 SXM: the larger of bytes
    (inputs read once, outputs written once) over the memory rate and
    FLOPs over the float32 peak. FLOPs count what this run's data needs:
    power iteration, one factorisation per problem (refactorisations after
    a rho change are not counted, so this is a lower bound), and per
    executed iteration two triangular sweeps (n^2 / 2 multiply-adds each)
    plus ~21 n of vector updates and reductions."""
    bytes_ = 4 * (B * n * n + 2 * B * n + B * nc) + 4 * B * n + B * (4 * 4 + 2)
    per_prob = (power_iters + 1) * (2 * n * n + 3 * n) + n ** 3 / 3 + n * n
    per_iter = 2 * n * n + 21 * n
    flops = B * per_prob + float(iters.sum()) * per_iter
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), bytes_, flops


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    import diffqcqp_tpu_torch as dqt
    from diffqcqp_tpu_torch.kernels import _build
    from diffqcqp_tpu_torch.kernels.admm_cuda import (
        PROX_BOX, PROX_DISK, PROX_NONNEG, PROX_SIGNED_BOX,
        admm_solve_cuda, admm_solve_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0)

    # ---- phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: card {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    t_build = time.perf_counter() - t0
    log(f"phase 1: built {sources} in {t_build:.1f} s")
    for name in sources:
        ptx = _build.library_path(name).with_suffix(".log").read_text().strip()
        log(f"  ptxas ({name}): " + " | ".join(
            ln.strip() for ln in ptx.splitlines() if "Used" in ln or "spill" in ln))

    cfg = dqt.QCQP_DEFAULTS.replace(
        eps=1e-7, max_iter=400, rho0_scale=2.0, power_iters=10,
        rho_update_period=24,
    )

    # ---- phase 2: K1 against its plain version on the card
    log("phase 2: K1 against admm_solve_plain on the card")
    P, q, l_n, mu = cuda(*build_problems(B_FLAG, NC_FLAG))
    radius = (l_n * mu).contiguous()
    ws = torch.zeros_like(q)
    args = (P, q, ws, PROX_DISK, (radius,), cfg, True, False)
    out_k = admm_solve_cuda(*args)
    out_p = admm_solve_plain(*args)
    err_flag = compare("flagship B=4096 N=24 disk", out_k, out_p)

    rng = np.random.default_rng(1)
    b, n = 256, 12
    S = (rng.standard_normal((b, n, n)) / np.sqrt(n)).astype(np.float32)
    Pk, qk = cuda(S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32),
                  rng.standard_normal((b, n)).astype(np.float32))
    lo, hi, vs, rad = cuda(
        -(rng.random((b, n)) * 0.5 + 0.2).astype(np.float32),
        (rng.random((b, n)) * 0.5 + 0.2).astype(np.float32),
        np.sign(rng.standard_normal((b, n))).astype(np.float32),
        (rng.random((b, n // 2)) * 0.5 + 0.05).astype(np.float32),
    )
    # eps=1e-5: the QP-family problems here certify on eps before their
    # iterates reach the float32 noise floor. Below it (eps=1e-6) most of them
    # stop through the 8-ulp stall test, whose first passing iteration moves
    # with rounding order (kernel FMAs vs eager ops): up to 4 iterations apart
    # on an H100, which measures rounding, not the algorithm.
    qp_cfg = dqt.QP_DEFAULTS.replace(eps=1e-5, max_iter=3000)
    wsk = torch.zeros_like(qk)
    for name, kind, pa, c, qstop in [
        ("nonneg", PROX_NONNEG, (), qp_cfg, False),
        ("box", PROX_BOX, (lo, hi), qp_cfg, False),
        ("signed box", PROX_SIGNED_BOX, (lo, hi, vs), qp_cfg, False),
        ("disk", PROX_DISK, (rad,), cfg.replace(eps=1e-6), True),
        # the kernel's other branches: the per-problem cpt gate, the
        # dual-only stopping rule, and a max_iter cap mid-solve
        ("nonneg rho_sync=False", PROX_NONNEG, (), qp_cfg.replace(rho_sync=False), False),
        ("box primal_check=False", PROX_BOX, (lo, hi), qp_cfg.replace(primal_check=False), False),
        ("disk max_iter=2", PROX_DISK, (rad,), cfg.replace(max_iter=2), True),
    ]:
        a = (Pk, qk, wsk, kind, pa, c, qstop, not qstop)
        compare(f"{name} B={b} N={n}", admm_solve_cuda(*a), admm_solve_plain(*a))
    # warm_start_dual from a converged primal: u0 = -(P ws + q)
    l0, _ = admm_solve_plain(Pk, qk, wsk, PROX_NONNEG, (), qp_cfg)
    a = (Pk, qk, l0, PROX_NONNEG, (), qp_cfg.replace(warm_start_dual=True))
    compare(f"nonneg warm_start_dual B={b} N={n}", admm_solve_cuda(*a), admm_solve_plain(*a))

    Pb, qb, lnb, mub = cuda(*build_problems(512, 48, seed=2))
    a = (Pb, qb, torch.zeros_like(qb), PROX_DISK, ((lnb * mub).contiguous(),),
         cfg, True, False)
    compare("disk B=512 N=96 (3 warps)", admm_solve_cuda(*a), admm_solve_plain(*a))

    # ---- phase 3: the slice through the public entry point
    log("phase 3: solve_qcqp_with_stats at B=4096 N=24")
    admm_solve_cuda.launches = 0
    l, st = dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg)
    torch.cuda.synchronize()
    launches = admm_solve_cuda.launches
    conv_frac = float(st.converged.float().mean())
    mean_iters = float(st.iterations.float().mean())
    norms = l.reshape(B_FLAG, NC_FLAG, 2).norm(dim=-1)
    viol = float((norms - (radius * (1 + 1e-5) + 1e-7)).max())
    ref_cfg = cfg.replace(eps=1e-10, max_iter=5000)
    l64, st64 = admm_solve_plain(
        P.double(), q.double(), ws.double(), PROX_DISK, (radius.double(),),
        ref_cfg, True, False,
    )
    err_ref = float((l.double() - l64).abs().max())
    log(f"  K1 launches={launches} converged_frac={conv_frac} "
        f"mean_iters={mean_iters:.4f} (JAX package r04 anchor {ITER_ANCHOR}) "
        f"max_iters={int(st.iterations.max())} "
        f"max feasibility excess={viol:.3e} max|l - l_f64 referee|={err_ref:.3e} "
        f"(referee converged_frac={float(st64.converged.float().mean())}, "
        f"mean_iters={float(st64.iterations.float().mean()):.2f})")
    if launches < 1:
        raise AssertionError("the main path did not launch K1")
    if conv_frac != 1.0 or viol > 0 or not (err_ref <= 1e-4):
        raise AssertionError("slice check failed")
    if not bool(st64.converged.all()):
        raise AssertionError("float64 referee did not converge")

    # ---- phase 4: timing at the flagship point
    args0 = args[:5] + (cfg.replace(max_iter=0),) + args[6:]
    k1 = lambda: admm_solve_cuda(*args)            # noqa: E731
    k1_setup = lambda: admm_solve_cuda(*args0)     # noqa: E731 (set-up only)
    api = lambda: dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg)  # noqa: E731
    dev_k = kernel_device_ms(k1, "admm_kernel")
    dev_setup = kernel_device_ms(k1_setup, "admm_kernel")
    ev_k, ts_k = time_cuda(k1, reps=5, calls=20)
    ev_k1, _ = time_cuda(k1, reps=20, calls=1)
    ev_api, _ = time_cuda(api, reps=5, calls=20)
    ms_p, ts_p = time_cuda(lambda: admm_solve_plain(*args), reps=5)
    bound, bound_by, nbytes, nflops = k1_bound_ms(
        B_FLAG, 2 * NC_FLAG, NC_FLAG, out_k[1].iterations.double(), cfg.power_iters)
    fmt = lambda x: "not in the trace" if x is None else f"{x:.4f} ms"  # noqa: E731
    log(f"phase 4 ({smi}):\n"
        f"  K1 device time per launch (torch.profiler): {fmt(dev_k)}; "
        f"set-up only, max_iter=0: {fmt(dev_setup)}\n"
        f"  K1 per call, 20 back-to-back calls (CUDA events): {ev_k:.4f} ms "
        f"(samples {[round(t, 4) for t in ts_k]}); one call at a time: {ev_k1:.4f} ms\n"
        f"  solve_qcqp_with_stats per call, 20 back-to-back: {ev_api:.4f} ms\n"
        f"  plain version: {ms_p:.2f} ms (samples {[round(t, 2) for t in ts_p]})\n"
        f"  bound {bound:.5f} ms ({bound_by}: {nbytes} bytes, {nflops:.4g} FLOP); "
        f"K1 'ms' below is the back-to-back CUDA-event time")

    # ---- phase 5: the kernels line, then the result
    print(json.dumps({"kernels": [{
        "name": "admm_solve_cuda (K1, with the K3 LDL^T helpers inlined)",
        "route": "cuda",
        "source": "diffqcqp_tpu_torch/kernels/csrc/admm.cu",
        "replaces": "diffqcqp_tpu/kernels/admm_pallas.py:78",
        "launches": launches,
        "max_abs_err": err_flag,
        "ms": ev_k,
        "plain_ms": ms_p,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
