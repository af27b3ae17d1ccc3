"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``diffqcqp_tpu_torch/kernels/csrc`` and
drives the port's paths: the friction-cone QCQP forward solve and the
forward+backward step (bench.py's value_and_grad of sum(l^2) with gradients
for P, q, l_n and mu) at B=4096, N=24 (12 contacts) with the benchmark
generator and configuration (seed 0); and the forward+backward steps of the
QP family at the JAX package's benchmark points (benchmarks/
run_benchmarks.py): the non-negative QP at B=4096, N=24 (config 10, seed 10)
and the box and signed-box QP at B=2048, N=24 (config 9, seed 9); and the
generic adjoint route with the duals given (``kkt.qcqp_vjp`` /
``kkt.box_vjp`` with ``duals=``) at the QCQP flagship, at config 9's box
point and at the JAX package's large-N size (B=2048, N=96, 48 contacts;
its config 6). Phases, each of which fails the run if its check fails:

  1. the card: name and power limit (nvidia-smi), the build of every
     ``kernels/_build.SOURCES`` library (one nvcc each, all at once); each
     kernel's launch plan (threads, shared memory, bound) as the built library
     computes it against the Python wrapper's, for K2 / K6 at n = 24, 34, 96,
     142 and K5 at m = 5, 33, 36, 72, 88, and three blocks of K6, K2 and K1
     on an SM at N=96 (the occupancy calculator); ptxas's registers and
     spills per kernel; blocks per SM of K1, K2, K6 and K4 (each kind) at
     N=24 and the waves each main-path launch takes, ceil(B / (blocks per
     SM x SMs)) at B=4096 (K1, K2, K6, K4's QP) and B=2048 (K4's box kinds):
     the run fails, after phase 4 so that its times are printed, if K2, K6
     or K4 takes more than one;
  2. kernel K1 (``admm_solve_cuda``) against its plain PyTorch version
     (``admm_solve_plain``) on the same card inputs: at the flagship point,
     for all four prox kinds and the rho_sync=False, primal_check=False,
     max_iter and warm_start_dual branches at B=256, N=12, and past one
     warp at N=96, B=512 (three warps per block) and N=34, B=512 (two); K1
     iterates against an explicit inverse at every n. Bars: max |dl| <= 2e-5,
     per-problem |d iterations| <= 1, equal ``converged``; with the count of
     problems whose l and iterations are equal bit for bit, and each
     solve's iterations and factorisations per problem (the first and one
     per rho change, counted by the plain version) at the flagship;
  2b. kernel K2 (``qcqp_kkt_bwd_fused_cuda``) against its plain version
     (``qcqp_kkt_bwd_fused_plain``) on the same card inputs, with l from K1
     and the cotangents g = 2 l and a random g: at the flagship point, at
     B=256, N=12 with 30 % zero radii and 30 % of the radii 50 times wider
     (inactive contacts), at B=512, N=96, at the largest one-warp size, B=256
     N=32, and at the block-wide path's edges, B=256 at N=34 (just past one
     warp) and N=142, the last three on problems built at a known KKT point
     (``kkt_problems``). Bars, on the problems whose
     strict mask agrees: per problem max |d dl| <= 5e-5 max(1, |dl|_inf);
     max |d dgamma| <= 2e-4 max(1, |dgamma|_inf) over the batch (the JAX
     suite's K2 bars), and per problem <= 2e-3 max(1, |dgamma|_inf), since
     float32 rounding in the worst-conditioned KKT systems moves a few
     problems' dgamma past 2e-4 of their own scale in the plain version
     too, as the printed comparison with its float64 run shows; max |d
     gamma| <= 1e-4; all finite; the mask may differ on at most 0.1 % of the
     contacts;
  2c. kernel K4 (``coord_kkt_bwd_fused_cuda``) against its plain version
     (``coord_kkt_bwd_fused_plain``) on the same card inputs, l from K1, g =
     2 l and a random g: the three classes at their benchmark points; tight
     boxes at B=256, N=12 (30 % of the coordinates with l_min = l_max, v with
     20 % zeros); the three at B=256, N=32 (the largest one-warp size) and
     at B=512, N=96. Bars, on the problems whose
     strict mask agrees (the zero pattern of dgamma, or of dl for the QP):
     per problem max |d dl| <= 5e-5 max(1, |dl|_inf); max |d dgamma| <=
     2e-4 max(1, |dgamma|_inf) over the batch and <= 2e-3 max(1,
     |dgamma|_inf) per problem; max |d gamma| <= 5e-5; all finite; the mask
     may differ on at most 0.1 % of the slots. The float64 plain version is
     printed beside them;
  2d. kernel K5 (``qr_solve_cuda``) against its plain version
     (``qr_solve_plain``) on the same card systems: the assembled adjoint
     systems of the QCQP flagship (4096, 36, 36) and of config 9's box
     (2048, 72, 72), the QP's SPD K at config 10 (4096, 24, 24), a QCQP at
     the route's bound, m = 87 (B=1024, N=58), l from K1 and g = 2 l, and at
     the lane-group edges a QCQP at m = 33 (B=1024, N=22) and a random
     system at m = 5 (B=1024, A = N(0, 1) + 3 I). Bar: per
     problem max |dx| <= min(2e-3, max(1e-4, m kappa_b u)) max(1, |x_b|_inf),
     kappa_b the problem's condition number, u float32's unit roundoff (see
     ``phase_2d``); over the batch the kernel at most twice as far off a
     float64 ``torch.linalg.solve`` of the same system as the plain version;
  2e. kernel K6 (``qcqp_kkt_bwd_cuda``) against its plain version
     (``qcqp_kkt_bwd_plain``) at B=2048, N=96, at the flagship and at phase
     2b's N=32, N=34 and N=142 problems, fed gamma,
     s and the strict mask from ``qcqp_dual`` / ``qcqp_strict_active``, g =
     2 l and a random g, with phase 2b's bars; then K6 fed K2's own gamma
     against K2 at the flagship, on the problems whose mask agrees;
  3. the slice through ``solve_qcqp_with_stats`` (launch counters zeroed
     just before, read just after): K1 launched, every problem converged,
     every contact feasible, and max |dl| <= 1e-4 against the plain version
     in float64 on the card at eps=1e-10 (the accuracy referee);
  3b. the forward+backward step through ``solve_qcqp`` and
     ``torch.autograd.grad`` (counters zeroed just before, read just after):
     K1 and K2 launched, every gradient finite; the gradients held to a
     float64 referee (the plain K1 at eps=1e-10, then the assembled KKT
     system by ``torch.linalg.solve``, a route that shares none of K2's
     Schur arithmetic), per-problem relative error median <= 1e-3 and max
     <= 2e-3; a float64 central difference on 4 problems; ``QCQPFn2`` in the
     (B, N, 1) layout against the entry point; K5 and K6 not launched.
     Phase 3 also shows that the entry point's K1 launch gives the bits of a
     direct launch;
  3c. for each QP-family class, the forward+backward step of sum(l^2) +
     <w, l> through ``solve_qp`` / ``solve_box_qp`` / ``solve_signed_box_qp``
     (``*_with_stats``) and ``torch.autograd.grad`` (counters zeroed just
     before, read just after): K1 and K4 launched, every problem converged,
     feasible to 1e-6, max |l - l_f64| <= 1e-4 against the plain K1 in
     float64 at eps=1e-10; the gradients against a float64 referee (that l,
     then the assembled KKT system by ``torch.linalg.solve``), per-problem
     relative error median <= 1e-3 and max <= 2e-3 on the problems whose
     strict mask the referee shares; float64 central differences on 4
     problems for q and the bounds; the class's ``*Fn2`` binding in the
     (B, N, 1) layout against the entry point; K5 and K6 not launched;
  3d. the generic route's three calls, g the cotangent of sum(l^2) + <w, l>,
     each with the launch counters zeroed just before and read just after:
     ``qcqp_vjp(duals=qcqp_dual(...))`` at
     the flagship (K5 once), ``box_vjp(duals=box_dual(...))`` at config 9
     (K5 once) and ``qcqp_vjp(duals=...)`` at B=2048, N=96 (nc + n = 144 >
     88: K6 once), no other kernel; each against a float64 referee, the
     assembled system of the call's own duals and mask solved by
     ``torch.linalg.solve`` (sharing no arithmetic with K5 or K6), with the
     route run on the kernel's plain version and the float32 LU of the same
     system printed beside it. Bars: dl per-problem relative error median
     <= 1e-3, max <= 2e-3; dgamma per problem <= 2e-3 max(1, |dgamma|_inf),
     or twice the plain route's worst where that is larger, capped at 1e-2,
     which the plain route's worst must also meet (see ``phase_3d``); then
     the N=96 call in float64 on the card: no kernel launched (the Schur
     route's Cholesky-and-LU branch) and within 1e-7 of the referee.
     Every float64 referee of phases 3b-3d solves its
     assembled system by ``torch.linalg.solve`` itself;
  3e. the dispatch past the kernels' bounds and in float64, each case with
     the launch counters zeroed just before and read just after:
     ``solve_qcqp`` + autograd at B=256, N=160 (``kkt_problems``; K1 runs,
     K2 and K6 do not: the Schur route's Newton-Schulz branch), gradients
     on all 256 problems against the float64 referee built on the route's
     own classification of the contacts (its recovered duals and strict
     mask), at phase 3b's bars; ``solve_qp`` +
     autograd at B=256, N=176 (no kernel: the eager engine and the
     assembled system), l within 1e-4 of the float64 plain K1 and the
     gradients at phase 3c's bars; a float64 ``solve_qcqp`` + autograd on
     the card at B=256, N=24 (no kernel; float64 results within 1e-8 (l)
     and 1e-7 (gradients, of each problem's scale) of the float64 referee);
     ``backend='xla'`` float32 at the flagship against K1 (both estimate L
     by power iteration): iterations within 4, |dl| <= 1e-4, equal
     ``converged``, with the engine's time per forward; and that TF32
     matmuls stay off throughout;
  3f. diagonal P (B, N) through the four entry points and autograd (bench.py's
     generator with P replaced by its diagonal: QP and QCQP at B=4096, N=24,
     seed 0; the box kinds at B=2048 with config 9's bounds), counters zeroed
     just before each run and read just after: no kernel launched (the eager
     engine and the closed-form adjoints, as in the JAX package), in float32
     and in float64; the gradients against the dense path on diag_embed(P)
     (K1, then K2 or K4 launched) and against a float64 run of the same
     diagonal problems (eps=1e-10): per-problem relative error median <=
     1e-3 over every problem and max <= 2e-3 over the problems whose strict
     mask agrees (phase 3's bars);
  3g. the twin of tpu_smoke.py: the float32 K1 solutions of
     ``solve_*_with_stats`` at the four classes' main-path points (the QCQP
     flagship, config 10's QP, config 9's box and signed box) certified by
     ``verify.check_*`` in float64 on the card, per problem: stationarity <
     2 ``verify.stationarity_bound`` (from the solve's own stats); primal
     median < 1e-6, max < 1e-5; complementarity median < 5e-4, max < 5e-2;
     the float32 ``recover_*_duals`` against verify's float64 least-squares
     multipliers, median relative error < 1e-2 over the strong ones (>
     max(1e-2, 10 eps)); float32 central differences through the public
     solve at h=1e-3 of a loss with a linear term, median relative error <
     1e-2 over the 5 largest coordinates of each checked input;
  3h. the config-4 system-ID step (benchmarks/run_benchmarks.py config 4: B=2048
     QPs + 2048 QCQPs, N=24, seed 3, the production schedule, Adam lr 1e-2)
     through ``models.system_id``'s problem map (P = S S^T + 0.1 I shared):
     one step (forward, backward, Adam) with the counters zeroed just before
     and read just after launches K1 twice, K4 once and K2 once and nothing
     else; its gradients against the same step on float64 inputs (the engine
     and the generic route, eps=1e-10), phase 3's bars on the problems whose
     QP and QCQP strict masks both agree; the loss falls over 20 steps;
  3i. the config-11 contact rollout (B=2048, T=50, seed 11; a diagonal-P QP
     and a diagonal-P QCQP per body and step), warm starts on and off,
     counters zeroed just before each and read just after: no kernel; the
     float32 positions within 1e-4 of a float64 rollout on the card
     (eps=1e-10); warm and cold within 1e-4; tests/test_contact_sim.py's
     probes in float64: a resting body stays put (1e-5), a sliding body
     decelerates at ~mu g and stops;
  4. timing at the flagship point: K1, K2, the forward entry point and the
     forward+backward step per call over back-to-back calls with CUDA events
     (warm-up, median of samples; K1's is the ``ms`` reported),
     device times per launch from torch.profiler (K1's set-up alone,
     max_iter=0) and the step's device time by kernel, the plain versions,
     and the library call beside K2 (``torch.linalg.solve`` of the
     assembled float32 system); then at each QP-family point K4 (CUDA events
     over 20 back-to-back calls and torch.profiler), its plain version, its
     bound, ``torch.linalg.solve`` of the assembled float32 system and the
     class's step with its device time by kernel, and K4 at phase 2c's B=512
     N=96 cases (profiler and events). K4's ``ms`` is its device
     time per launch from torch.profiler: back to back, its wrapper's host
     work outlasts the kernel, so the CUDA-event time measures the host (so
     is K2's since its one-warp redesign); K5
     at each phase-2d point (profiler and events), its plain version, its
     bound and ``torch.linalg.solve`` of the same system; K6 at N=96 and at
     the flagship beside K2 on the same problems and ``torch.linalg.solve``
     of the assembled (2048, 144, 144) / (4096, 36, 36) system; one
     ``qcqp_vjp(duals=)`` call end to end against the K2 route. K5's and
     K6's ``ms`` are profiler device times, as K4's; K2's bound at N=96; then
     the public QCQP step at B=2048, N=96 (the phase-2e problems,
     ``solve_qcqp`` then ``torch.autograd.grad`` of sum(l^2), launch counters
     zeroed just before and read just after: K1 and K2 alone), timed as the
     flagship step, with its device time by kernel and the card's idle
     share; then K1 alone on those problems against its plain version, its
     device time (whole, and set-up only), its bound and its iterations and
     inverses per problem;
  4f. timing of this slice's paths, each as the steps above (CUDA events,
     warm-up, median of 5) with its device time by kernel and the card's
     idle share: the config-4 system-ID step (problems/s = 4096 / step);
     the contact rollout warm and cold (steps/s, mean iterations per step);
     the contact system-ID step (``make_system_id_step``, B=2048, T=50);
     ``qcqp_jacobian`` at the flagship, l solved inside (K1) and given, held
     in float64 against ``qcqp_vjp`` of a random cotangent (1e-7); the
     diagonal-P flagship QCQP step;
  3j. the sharded, bucketed and resumed flagship paths and the traces
     (``parallel``, ``utils``, ``debug``), each with the launch counters
     zeroed just before and read just after:
     (a) a mesh of two shards on the one card: the flagship forward+backward
     step (sum(l^2) + <w, l>) and config 10's QP step in independent mode
     (K1 2, K2 2 / K4 2), l within 2e-5 of the unsharded step's (with the
     count of problems equal bit for bit) and the gradients within phase
     3b's bars of it; then the flagship step in lockstep mode (K1 0, K2 2:
     the eager engine forward) on the batch sorted by K1's iterations, so
     that shard 0's slowest problem stops early: each shard thread calls
     the reducer exactly as often as the batch's slowest problem iterates
     (and the barrier acts as often), l and per-problem iterations equal bit
     for bit to each shard's own ``backend='xla'`` solve, and within 1e-5
     (l) and 4 iterations of one such solve of the whole batch (the engine
     rounds otherwise at another batch size);
     (b) a one-rank NCCL process group (``initialize_distributed`` on a free
     local port): the lockstep flagship solve on ``global_batch_mesh()`` and
     ``shard_host_local_batch``, one reducer call and one all-reduce an
     iteration, bit for bit the whole batch's ``backend='xla'`` solve, and
     within 1e-5 and 4 iterations of (a)'s lockstep run; the group is
     destroyed after;
     (c) the flagship generator at B=4000 padded to a bucket of 4096
     (``pad_to_bucket``): the step launches K1 1, K2 1, the padded problems
     converge in 1 iteration to l = 0, and the real 4000's l and gradients
     are held against an unpadded step (2e-5, phase 3b's bars);
     (d) ``solve_resumed`` at the flagship from ``max_iter=8``, 3 rounds,
     growth 4: K1 3, everything converged, the problems converged after
     rounds 1 and 2 unchanged bit for bit by the later rounds, l within 1e-4
     of the float64 referee;
     (e) ``trace_qcqp`` at the flagship, 64 iterations (L by power
     iteration, as K1): its l2 and iterations equal to a ``backend='xla'``
     solve capped at 64, histories (64, 4096), ``active`` never on again once
     off, iterations within 1 of K1's (phase 2);
     (f) ``enable_compilation_cache`` in two fresh processes on one
     temporary directory: the first builds K5's library, the second loads it
     with no build (``_build.build`` reports 0 s for it);
  4g. timing of phase 3j's paths, each through ``timed_step`` (CUDA events,
     warm-up, median, device time by kernel, the card's idle share): the
     sharded independent flagship step beside the unsharded one, the
     lockstep flagship forward, the bucketed step, the resumed solve, and
     the trace (ms per iteration);
  5. one JSON line of every ported kernel, then as the last line
     ``{"ok": true, "device": {...}}``.

Imports torch, numpy and the port only. Exits non-zero without a result
when no CUDA device is present or the port cannot be imported.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

B_FLAG, NC_FLAG = 4096, 12
ITER_ANCHOR = 17.21       # mean iterations of the JAX package at this config (its r04 record)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM data sheet, float32 outside the tensor cores
DGAMMA_CAP = 1e-2          # phase 3d: the most dgamma's bar may grow to, of the problem's scale


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


def kkt_problems(b, nc, seed):
    """(P, q, l, radius), float32, QCQPs built at a known KKT point: P as the
    benchmark generator's, l ~ 0.3 N(0, 1), 60 % of the contacts binding (r_c
    = |l_c|) with duals gamma_c ~ U(0.05, 1.05), the rest strictly inside (r_c
    = 1.5 |l_c|), and q = -(P l + 2 gamma l). Unlike the benchmark generator's
    problems, whose every contact binds, none of these has a weakly active
    contact (gamma near 0, dgamma ~ 1 / gamma), so the Schur systems stay well
    conditioned as nc grows; with the benchmark generator at N=142 both
    float32 versions sit ~3e-2 of dgamma's scale off their float64 run (an
    H100 run), which measures the system and not the kernel."""
    n = 2 * nc
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n)
    l = rng.standard_normal((b, n)) * 0.3
    norm = np.linalg.norm(l.reshape(b, nc, 2), axis=-1)
    act = rng.random((b, nc)) < 0.6
    radius = np.where(act, norm, 1.5 * norm)
    gam = np.where(act, rng.random((b, nc)) + 0.05, 0.0)
    q = -(np.einsum("bij,bj->bi", P, l) + 2.0 * np.repeat(gam, 2, axis=1) * l)
    return tuple(x.astype(np.float32) for x in (P, q, l, radius))


def cuda(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in xs)


def compare(name, out_k, out_p, tol=2e-5):
    """K1 against its plain version; fails on the bars, returns max |dl|."""
    (lk, sk), (lp, sp) = out_k, out_p
    dl = float((lk - lp).abs().max())
    dit = (sk.iterations - sp.iterations).abs()
    conv_eq = bool((sk.converged == sp.converged).all())
    stall_eq = int((sk.stalled != sp.stalled).sum())
    same = int(((lk == lp).all(dim=-1) & (sk.iterations == sp.iterations)).sum())
    log(f"  {name}: max|dl|={dl:.3e} problems bit for bit equal {same}/{dit.numel()} "
        f"max|d iters|={int(dit.max())} "
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
    for _ in range(calls):
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


def counts(label, iters, factors):
    """One line of a solve's iterations and factorisations per problem."""
    log(f"  {label}: iterations per problem mean {float(iters.double().mean()):.4f} max "
        f"{int(iters.max())}; factorisations (inverses formed) per problem (the first and one "
        f"per rho change, from the plain version) mean {float(factors.double().mean()):.4f} max "
        f"{int(factors.max())}")


def bound_ms(bytes_, flops):
    """(ms, what bounds it, bytes, FLOPs): the larger of the bytes over the
    memory rate and the FLOPs over the float32 peak."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
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


def k6_bound_ms(B, n, nc, active):
    """Least time for K6 on an H100 SXM: bytes of P, l, g, gamma, s and the
    float mask read once and dgamma and dl written once, against
    ``schur_flops``."""
    bytes_ = 4 * (B * n * n + 2 * B * n + 3 * B * nc) + 4 * (B * nc + B * n)
    return bound_ms(bytes_, schur_flops(B, n, nc, active))


def k5_bound_ms(B, m):
    """Least time for K5 on an H100 SXM: A and b read once and x written
    once, against 4/3 m^3 + m^2 FLOPs per problem (the Householder
    triangularisation of [A | b] and the back substitution; the schedule is
    the same for every problem)."""
    return bound_ms(4 * B * (m * m + 2 * m), B * (4 * m ** 3 / 3 + m * m))


def per_problem(x, ref, rows):
    """Each problem's max error against its own scale, max(1, |ref|_inf), on
    the problems ``rows`` selects."""
    ref = ref.double()
    return ((x.double() - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1.0))[rows]


def compare_k2(name, out_k, out_p, out_64, kernel="K2"):
    """K2 (or K6, ``kernel``) against its plain version; fails on the bars,
    returns max |d dl|. dgamma is exactly 0 where the strict mask am is 0
    and almost surely not elsewhere, so its zero pattern shows each side's
    mask. ``out_64`` is the
    plain version in float64 on the same inputs, printed to show how far
    float32 rounding alone moves each side's dgamma."""
    (dgk, dlk, gk), (dgp, dlp, gp), dg64 = out_k, out_p, out_64[0]
    flip = (dgk == 0) != (dgp == 0)
    agree = ~flip.any(dim=-1)
    agree64 = agree & ~((dgp == 0) != (dg64 == 0)).any(dim=-1)
    e_dl = float((dlk - dlp)[agree].abs().max())
    e_dg = float((dgk - dgp)[agree].abs().max())
    e_g = float((gk - gp)[agree].abs().max())
    bar_dg = 2e-4 * max(1.0, float(dgp.abs().max()))
    s_dl, s_dg = float(per_problem(dlk, dlp, agree).max()), per_problem(dgk, dgp, agree)
    s_k64, s_p64 = (float(per_problem(x, dg64, agree64).max()) for x in (dgk, dgp))
    finite = all(bool(torch.isfinite(x).all()) for x in out_k)
    n_flip = int(flip.sum())
    log(f"  {name}: max|d dl|={e_dl:.3e}, per problem /max(1,|dl|_inf) {s_dl:.3e} (bar 5e-5); "
        f"max|d dgamma|={e_dg:.3e} (bar {bar_dg:.3e}), per problem /max(1,|dgamma|_inf) "
        f"{float(s_dg.max()):.3e} (bar 2e-3; over 2e-4 on {int((s_dg > 2e-4).sum())}/"
        f"{s_dg.numel()} problems; against the float64 plain version, on the "
        f"{int(agree64.sum())} problems whose mask it shares: kernel {s_k64:.3e}, "
        f"plain {s_p64:.3e}); max|d gamma|={e_g:.3e} (bar 1e-4) "
        f"finite={finite} contacts whose mask differs: {n_flip}/{flip.numel()} "
        f"strictly active: {float((dgp != 0).double().mean()):.4f}")
    if not (finite and n_flip <= 1e-3 * flip.numel() and s_dl <= 5e-5 and e_dg <= bar_dg
            and float(s_dg.max()) <= 2e-3 and e_g <= 1e-4):
        raise AssertionError(f"{kernel} disagrees with its plain version: {name}")
    return e_dl


def ptxas_summary(text):
    """Registers and spill bytes of each kernel in an ``-Xptxas=-v`` log,
    "name[template ints]: R registers, S spill" joined by " | "."""
    out, name, spill = [], None, "?"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", ln)
        if m:                   # <length><name> pairs, past the anonymous namespace's
            mangled, pos = m.group(1), 3 if m.group(1).startswith("_ZN") else 2
            ident = mangled
            while (digits := re.match(r"\d+", mangled[pos:])) is not None:
                pos += len(digits.group()) + int(digits.group())
                ident = mangled[pos - int(digits.group()):pos]
                if not ident.startswith("_GLOBAL__N"):
                    break
            ints = re.findall(r"Li(\d+)E", mangled[pos:])
            name = ident + (f"[{','.join(ints)}]" if ints else "")
        elif "spill stores" in ln:
            spill = re.search(r"(\d+) bytes spill stores", ln).group(1)
        elif "Used" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {spill} bytes spilled")
            name = None
    return " | ".join(out)


def rel_err(got, ref, floor=None):
    """Per-problem ||got - ref|| / max(||ref||, floor) over the flattened
    trailing dimensions."""
    d = (got.double() - ref).flatten(1).norm(dim=1)
    den = ref.flatten(1).norm(dim=1)
    return d / (den if floor is None else torch.maximum(den, floor))


def device_time_by_kernel(fn, calls=10):
    """[(kernel name, ms per call, launches per call)] of the CUDA kernels
    that ``fn`` runs, from torch.profiler, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(ev.key, ev.device_time_total / 1e3 / calls, ev.count / calls)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def per_launch_ms(rows, kernel):
    """Device ms per launch of the kernel whose name contains ``kernel``, from
    ``device_time_by_kernel``'s rows; None when the trace holds no such kernel."""
    return next((ms / cnt for name, ms, cnt in rows if kernel in name), None)


def timed_step(label, fn, smi, reps=5, calls=1, problems=None, top=0):
    """``fn`` timed as phase 4 times the steps (CUDA events, warm-up, median
    of ``reps`` samples of ``calls`` back-to-back calls) with its device
    time by kernel from torch.profiler (the ``top`` largest kernels listed)
    and the card's idle share. Returns (ms per call, idle share)."""
    ms, ts = time_cuda(fn, reps=reps, calls=calls)
    rows = device_time_by_kernel(fn, calls=calls)
    dev = sum(r_[1] for r_ in rows)
    by = {k: sum(r_[1] for r_ in rows if tag in r_[0]) for k, tag in
          (("K1", "admm_kernel"), ("K2", "qcqp_bwd_kernel"), ("K4", "coord_bwd_kernel"))}
    rate = "" if problems is None else f" = {problems / ms * 1e3:.1f} problems/s"
    log(f"  {label} ({smi}): {ms:.4f} ms per call, {calls} back-to-back (CUDA events; samples "
        f"{[round(t, 4) for t in ts]}){rate}; device time by kernel (torch.profiler, ms per "
        f"call): total {dev:.4f}, " + ", ".join(f"{k} {v:.4f}" for k, v in by.items())
        + f", other kernels {dev - sum(by.values()):.4f}; device idle {ms - dev:.4f} ms "
        f"({(ms - dev) / ms:.1%})")
    for name_, ms_, cnt in rows[:top]:
        log(f"    {ms_:.4f} ms  x{cnt:g}  {name_[:110]}")
    return ms, (ms - dev) / ms


# ---------------------------------------------------------------------------
# The QP family: non-negative, box and signed-box QP (forward K1, backward K4)
# ---------------------------------------------------------------------------

def spd_problems(b, n, seed):
    """The JAX package's QP-family benchmark generator
    (benchmarks/run_benchmarks.py::_spd, then q ~ N(0, 1)): (rng, P, q) with
    P and q float32; the box rows draw their bounds from the same rng next."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)).astype(np.float32) / np.sqrt(n)
    P = (s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32)).astype(np.float32)
    return rng, P, rng.standard_normal((b, n)).astype(np.float32)


def box_bounds(rng, b, n):
    """The box rows' l_min = -(U 0.9 + 0.1), l_max = U 0.9 + 0.1 and
    v ~ N(0, 1), float32 (run_benchmarks.py config 9)."""
    lo = -(rng.random((b, n)) * 0.9 + 0.1).astype(np.float32)
    hi = (rng.random((b, n)) * 0.9 + 0.1).astype(np.float32)
    return lo, hi, rng.standard_normal((b, n)).astype(np.float32)


def qp_class(name, P, q, cfg, lo=None, hi=None, v=None):
    """One QP-family class on given card tensors: its entry point's extra
    inputs (``params``), K1's prox kind and arguments, K4's kind and bounds."""
    from types import SimpleNamespace

    from diffqcqp_tpu_torch.kernels import admm_cuda as a1, coord_bwd_cuda as a4

    vs = None if v is None else torch.sign(v).contiguous()
    spec = {
        "qp": (a1.PROX_NONNEG, a4.KIND_QP, (), (), (None, None, None)),
        "box_qp": (a1.PROX_BOX, a4.KIND_BOX, (lo, hi), (lo, hi), (lo, hi, None)),
        "signed_box_qp": (a1.PROX_SIGNED_BOX, a4.KIND_SIGNED_BOX, (lo, hi, v),
                          (lo, hi, vs), (lo, hi, vs)),
    }[name]
    return SimpleNamespace(name=name, P=P, q=q, cfg=cfg, prox=spec[0], kind=spec[1],
                           params=spec[2], prox_args=spec[3], bounds=spec[4])


def k4_mask(kind, out):
    """(B, slots) strict mask of a K4 output: dgamma != 0 for the box kinds;
    for the QP dl == 0 (exactly 0 at the strictly active coordinates and
    almost surely not elsewhere)."""
    return out[0] == 0 if kind == 0 else out[1] != 0


def _max(t):
    return float(t.max()) if t.numel() else float("nan")


def compare_k4(name, kind, out_k, out_p, out_64):
    """K4 against its plain version; fails on the bars, returns max |d dl|.
    ``out_64`` is the plain version in float64 on the same inputs, printed to
    show how far float32 rounding alone moves each side."""
    mk, mp, m64 = (k4_mask(kind, o) for o in (out_k, out_p, out_64))
    flip = mk != mp
    agree = ~flip.any(dim=-1)
    agree64 = agree & ~(mp != m64).any(dim=-1)
    (dlk, *rest_k), (dlp, *rest_p) = out_k, out_p
    e_dl = _max((dlk - dlp)[agree].abs())
    s_dl = _max(per_problem(dlk, dlp, agree))
    finite = all(bool(torch.isfinite(x).all()) for x in out_k)
    n_flip = int(flip.sum())
    ok = finite and n_flip <= 1e-3 * flip.numel() and s_dl <= 5e-5
    msg = (f"  {name}: max|d dl|={e_dl:.3e}, per problem /max(1,|dl|_inf) {s_dl:.3e} "
           f"(bar 5e-5; against the float64 plain version: kernel "
           f"{_max(per_problem(dlk, out_64[0], agree64)):.3e}, plain "
           f"{_max(per_problem(dlp, out_64[0], agree64)):.3e})")
    if rest_k:
        (dgk, gk), (dgp, gp), dg64 = rest_k, rest_p, out_64[1]
        e_dg = _max((dgk - dgp)[agree].abs())
        e_g = _max((gk - gp)[agree].abs())
        bar_dg = 2e-4 * max(1.0, float(dgp.abs().max()))
        s_dg = per_problem(dgk, dgp, agree)
        msg += (f"; max|d dgamma|={e_dg:.3e} (bar {bar_dg:.3e}), per problem "
                f"/max(1,|dgamma|_inf) {_max(s_dg):.3e} (bar 2e-3; over 2e-4 on "
                f"{int((s_dg > 2e-4).sum())}/{s_dg.numel()} problems; against the float64 "
                f"plain version: kernel {_max(per_problem(dgk, dg64, agree64)):.3e}, plain "
                f"{_max(per_problem(dgp, dg64, agree64)):.3e}); max|d gamma|={e_g:.3e} "
                f"(bar 5e-5)")
        ok = ok and e_dg <= bar_dg and _max(s_dg) <= 2e-3 and e_g <= 5e-5
    log(msg + f"; finite={finite} slots whose mask differs: {n_flip}/{flip.numel()} "
        f"(problems {int((~agree).sum())}) strictly active: {float(mp.double().mean()):.4f}")
    if not ok:
        raise AssertionError(f"K4 disagrees with its plain version: {name}")
    return e_dl


def phase_2c(cases, rand_g):
    """K4 against its plain version on the card, l from K1, g = 2 l and a
    random g. Returns the first case's max |d dl| with g = 2 l."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import admm_solve_cuda
    from diffqcqp_tpu_torch.kernels.coord_bwd_cuda import (
        coord_kkt_bwd_fused_cuda, coord_kkt_bwd_fused_plain,
    )

    errs = []
    for label, c in cases:
        l, st = admm_solve_cuda(c.P, c.q, torch.zeros_like(c.q), c.prox, c.prox_args, c.cfg)
        if not bool(st.converged.all()):
            raise AssertionError(f"K1 did not converge on {label}")
        for gname, g in (("g=2l", 2.0 * l), ("random g", rand_g(l))):
            a = (c.P, c.q, l, g.contiguous(), *c.bounds, c.kind, c.cfg.eps, c.cfg.act_eps)
            a64 = tuple(None if x is None else x.double() for x in a[:7]) + a[7:]
            errs.append(compare_k4(f"{label} {gname}", c.kind, coord_kkt_bwd_fused_cuda(*a),
                                   coord_kkt_bwd_fused_plain(*a), coord_kkt_bwd_fused_plain(*a64)))
    return errs[0]


def feasibility_excess(c, l):
    """Largest violation of the class's constraints past a 1e-6 slack (<= 0
    when feasible)."""
    ex = [-l - 1e-6] if c.name == "qp" else [c.params[0] - l - 1e-6, l - c.params[1] - 1e-6]
    if c.name == "signed_box_qp":
        ex.append(torch.sign(c.params[2]) * l - 1e-6)
    return max(float(x.max()) for x in ex)


def solve64(A, rhs):
    """x of A x = rhs by ``torch.linalg.solve`` in float64: the referees' own
    solve of an assembled system, which shares no arithmetic with K2, K4, K5
    or K6 (the port's dispatch would send some of these systems to them)."""
    return torch.linalg.solve(A.double(), rhs.double()[..., None])[..., 0]


def class_referee(c, xs64, rest64, l64, g64):
    """float64 gradients of <g64, l> from the assembled KKT system solved by
    ``solve64``, and its (B, slots) strict mask."""
    from diffqcqp_tpu_torch.api import _bound_grads, _grad_P
    from diffqcqp_tpu_torch.diff import kkt

    P, q, *bnd = xs64
    if c.name == "qp":
        K, rhs, fm = kkt._qp_kkt_system(P, q, l64, g64, c.cfg)
        dl = solve64(K, rhs) * fm
        return (_grad_P(dl, l64, P), -dl), fm == 0
    if c.name == "box_qp":
        duals = kkt.box_dual(P, q, *bnd, l64, c.cfg)
        ST, rhs, am = kkt._box_kkt_system(P, l64, g64, duals, c.cfg)
        gamma = duals.gamma
    else:
        ST, rhs, am, gamma = kkt._signed_box_kkt_system(P, q, *bnd, *rest64, l64, g64, c.cfg)
    x = solve64(ST, rhs)
    m = am.shape[-1]
    r = kkt.BoxVJP(dl=x[:, m:], dgamma=x[:, :m] * am, gamma=gamma)
    return (_grad_P(r.dl, l64, P), -r.dl, *_bound_grads(r, l64.shape[-1])), am > 0


def phase_3c(dqt, c, w):
    """The class's forward+backward step through its entry point and
    torch.autograd.grad, with the launch counters zeroed just before and read
    just after; then the checks against a float64 referee, central
    differences and the class's ``*Fn2`` binding. Returns (launches of K1,
    launches of K4, the step as a closure for the timing)."""
    from diffqcqp_tpu_torch import torch_autograd as ta
    from diffqcqp_tpu_torch.kernels.admm_cuda import admm_solve_cuda, admm_solve_plain
    from diffqcqp_tpu_torch.kernels.coord_bwd_cuda import coord_kkt_bwd_fused_cuda
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import qcqp_kkt_bwd_cuda
    from diffqcqp_tpu_torch.kernels.qr_solve_cuda import qr_solve_cuda

    solve = getattr(dqt, f"solve_{c.name}_with_stats")
    diff = (c.P, c.q) + (c.params[:2] if c.params else ())
    rest = c.params[2:]
    leaves = [x.clone().requires_grad_() for x in diff]

    def step(xs=leaves, config=c.cfg, fn=solve, extra=rest):
        lx = fn(*xs, *extra, config=config)
        lx = lx[0] if isinstance(lx, tuple) else lx
        return lx, torch.autograd.grad((lx * lx).sum() + (w.reshape(lx.shape) * lx).sum(), xs)

    kernels = (admm_solve_cuda, coord_kkt_bwd_fused_cuda, qr_solve_cuda, qcqp_kkt_bwd_cuda)
    for k_ in kernels:
        k_.launches = 0
    l, st = solve(*leaves, *rest, config=c.cfg)
    grads = torch.autograd.grad((l * l).sum() + (w * l).sum(), leaves)
    torch.cuda.synchronize()
    n_k1, n_k4, n_k5, n_k6 = (k_.launches for k_ in kernels)
    l = l.detach()
    finite = all(bool(torch.isfinite(x).all()) for x in grads)
    conv = float(st.converged.float().mean())
    excess = feasibility_excess(c, l)

    # float64 referee: the plain K1 at eps=1e-10, then the assembled system
    xs64, rest64 = [x.double() for x in diff], [x.double() for x in rest]
    pa64 = tuple(x.double() for x in c.prox_args)
    ref_cfg = c.cfg.replace(eps=1e-10, max_iter=5000)
    l64, st64 = admm_solve_plain(xs64[0], xs64[1], torch.zeros_like(xs64[1]), c.prox, pa64, ref_cfg)
    err_l = float((l.double() - l64).abs().max())
    g64 = 2.0 * l64 + w.double()
    ref, am_ref = class_referee(c, xs64, rest64, l64, g64)
    out_k4 = coord_kkt_bwd_fused_cuda(c.P, c.q, l, (2.0 * l + w).contiguous(), *c.bounds,
                                      c.kind, c.cfg.eps, c.cfg.act_eps)
    shared = ~(k4_mask(c.kind, out_k4) != am_ref).any(dim=-1)
    log(f"  {c.name}: launches K1 {n_k1}, K4 {n_k4}, K5 {n_k5}, K6 {n_k6}; converged_frac={conv} "
        f"mean_iters={float(st.iterations.float().mean()):.4f} "
        f"max_iters={int(st.iterations.max())} stalled={float(st.stalled.float().mean()):.4f} "
        f"max feasibility excess={excess:.3e} max|l - l_f64 referee|={err_l:.3e} "
        f"(referee converged {bool(st64.converged.all())}, mean_iters "
        f"{float(st64.iterations.float().mean()):.2f}); gradients finite {finite}; strictly "
        f"active slots {float(am_ref.double().mean()):.4f}; problems whose strict mask the "
        f"referee does not share: {int((~shared).sum())}/{shared.numel()}")
    if n_k1 < 1 or n_k4 < 1 or n_k5 or n_k6 or not finite:
        raise AssertionError(f"the {c.name} step did not run through K1 and K4 alone")
    if conv != 1.0 or excess > 0 or not err_l <= 1e-4 or not bool(st64.converged.all()):
        raise AssertionError(f"{c.name} forward check failed")
    worst = worst_max = 0.0
    for i, (a, b) in enumerate(zip(grads, ref)):
        e = rel_err(a, b, b.new_tensor(1e-30))     # a problem with no strict slot: 0 / 0
        med, mx = float(e.median()), _max(e[shared])
        worst, worst_max = max(worst, med), max(worst_max, mx)
        log(f"    grad {('P', 'q', 'l_min', 'l_max')[i]}: per-problem relative error vs f64 "
            f"referee median {med:.3e} max {mx:.3e} (|ref|_max {float(b.abs().max()):.3e})")
    if not (worst <= 1e-3 and worst_max <= 2e-3):
        raise AssertionError(f"{c.name} gradients disagree with the float64 referee")

    # central differences in float64 on 4 problems, the plain K1 at eps=1e-12
    fd_cfg = c.cfg.replace(eps=1e-12, max_iter=20000)
    base = [x[:4] for x in xs64]
    h, w4 = 1e-5, w[:4].double()
    jobs = []
    for pi in range(1, len(base)):
        an = grads[pi][:4].double()
        for flat in torch.topk(an.abs().flatten(), 5).indices.tolist():
            b_, j_ = divmod(flat, an.shape[1])
            jobs += [(pi, b_, j_, s_, float(an[b_, j_])) for s_ in (h, -h)]
    xs = [torch.stack([x[j[1]] for j in jobs]).clone() for x in base]
    for k_, (pi, _, j_, s_, _) in enumerate(jobs):
        xs[pi][k_, j_] += s_
    signs = tuple(torch.stack([x[j[1]] for j in jobs]) for x in pa64[2:])   # sign(v), signed box
    lf, stf = admm_solve_plain(xs[0], xs[1], torch.zeros_like(xs[1]), c.prox,
                               tuple(xs[2:]) + signs, fd_cfg)
    wj = torch.stack([w4[j[1]] for j in jobs])
    f = ((lf * lf).sum(1) + (wj * lf).sum(1)).tolist()
    fd_rel = {}
    for k_ in range(0, len(jobs), 2):
        pi, fd = jobs[k_][0], (f[k_] - f[k_ + 1]) / (2 * h)
        fd_rel.setdefault(("P", "q", "l_min", "l_max")[pi], []).append(
            abs(fd - jobs[k_][4]) / max(abs(fd), 1e-30))
    fd_med = {k: float(np.median(v)) for k, v in fd_rel.items()}
    log(f"    central differences (f64, h={h}, 4 problems, 5 largest coordinates each; FD "
        f"solves converged: {bool(stf.converged.all())}): median relative error "
        + ", ".join(f"{k}: {v:.3e}" for k, v in fd_med.items()))
    if not (bool(stf.converged.all()) and max(fd_med.values()) < 1e-3):
        raise AssertionError(f"{c.name} central differences disagree with the gradients")

    # the reference binding in the (B, N, 1) layout against the entry point
    fn2 = getattr(ta, {"qp": "QPFn2", "box_qp": "BoxQPFn2",
                       "signed_box_qp": "SignedBoxQPFn2"}[c.name])
    dcfg = dqt.QP_DEFAULTS.replace(eps=c.cfg.eps, max_iter=c.cfg.max_iter)
    col = [diff[0].clone().requires_grad_()] + [x[..., None].clone().requires_grad_()
                                                for x in diff[1:]]
    _, g_fn2 = step(col, dcfg, lambda *a, config: fn2.apply(
        *a, torch.zeros_like(a[1]), config.eps, config.max_iter), [x[..., None] for x in rest])
    _, g_api = step([x.clone().requires_grad_() for x in diff], dcfg)
    e_fn2 = max(float((a.reshape(b.shape) - b).abs().max()) for a, b in zip(g_fn2, g_api))
    log(f"    {fn2.__name__} (B, N, 1) vs solve_{c.name} gradients: max|d| = {e_fn2:.3e}")
    if not e_fn2 <= 1e-6:
        raise AssertionError(f"{fn2.__name__} disagrees with the entry point")
    return n_k1, n_k4, step


def k4_bound_ms(B, n, slots, n_bounds):
    """Least time for K4 on an H100 SXM: bytes of P, q, l, g and the class's
    ``n_bounds`` bound vectors read once and dl (and, for the box kinds,
    dgamma and gamma of ``slots`` n entries each) written once, against the
    FLOPs per problem: 2 n^2 for P l + q, n^3 / 3 for the factor, 2 n^2 for
    the solve, and 2 n^2 for the box kinds' residual."""
    bytes_ = 4 * B * (n * n + (3 + n_bounds) * n) + 4 * B * n * (1 + 2 * slots)
    return bound_ms(bytes_, B * (4 * n * n + n ** 3 / 3 + (2 * n * n if slots else 0)))


def time_k4(c):
    """K4 on the class's problems, l from K1 and g = 2 l: (its arguments, its
    device time per launch from torch.profiler, (ms, samples) per call over
    20 back-to-back calls by CUDA events, its bound)."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import admm_solve_cuda
    from diffqcqp_tpu_torch.kernels.coord_bwd_cuda import coord_kkt_bwd_fused_cuda

    B, n = c.q.shape
    l = admm_solve_cuda(c.P, c.q, torch.zeros_like(c.q), c.prox, c.prox_args, c.cfg)[0]
    a = (c.P, c.q, l, (2.0 * l).contiguous(), *c.bounds, c.kind, c.cfg.eps, c.cfg.act_eps)
    k4 = lambda: coord_kkt_bwd_fused_cuda(*a)   # noqa: E731
    dev = per_launch_ms(device_time_by_kernel(k4), "coord_bwd_kernel")
    slots = len(c.params[:2]) + (1 if c.name == "signed_box_qp" else 0)
    return a, dev, time_cuda(k4, reps=5, calls=20), k4_bound_ms(B, n, slots, slots)


def phase_4c(c, step, smi):
    """K4, its plain version, its bound, the library call and the class's
    forward+backward step, timed at the class's point. Returns K4's numbers
    for the kernels line."""
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.kernels.coord_bwd_cuda import coord_kkt_bwd_fused_plain

    B, n = c.q.shape
    a, dev_k4, (ev_k4, ts_k4), (bound, bound_by, nbytes, nflops) = time_k4(c)
    ms_p, ts_p = time_cuda(lambda: coord_kkt_bwd_fused_plain(*a), reps=3)
    l = a[2]
    # the library call: the same adjoint solve, assembled in float32 and
    # solved by torch.linalg.solve (the dual recovery not included)
    g = a[3]
    if c.name == "qp":
        A, rhs, _ = kkt._qp_kkt_system(c.P, c.q, l, g, c.cfg)
    elif c.name == "box_qp":
        duals = kkt.box_dual(c.P, c.q, *c.params, l, c.cfg)
        A, rhs, _ = kkt._box_kkt_system(c.P, l, g, duals, c.cfg)
    else:
        A, rhs, *_ = kkt._signed_box_kkt_system(c.P, c.q, *c.params, l, g, c.cfg)
    A, rhs = A.contiguous(), rhs[..., None].contiguous()
    ms_lib, ts_lib = time_cuda(lambda: torch.linalg.solve(A, rhs), reps=5, calls=20)
    fmt = lambda x: "not in the trace" if x is None else f"{x:.4f} ms"  # noqa: E731
    log(f"  {c.name} at B={B} N={n} ({smi}):\n"
        f"    K4 device time per launch (torch.profiler): {fmt(dev_k4)}\n"
        f"    K4 per call, 20 back-to-back calls (CUDA events): {ev_k4:.4f} ms "
        f"(samples {[round(t, 4) for t in ts_k4]})\n"
        f"    K4 plain version: {ms_p:.2f} ms (samples {[round(t, 2) for t in ts_p]})\n"
        f"    K4 bound {bound:.5f} ms ({bound_by}: {nbytes} bytes, {nflops:.4g} FLOP)\n"
        f"    library call torch.linalg.solve, assembled float32 {tuple(A.shape)}: "
        f"{ms_lib:.4f} ms (samples {[round(t, 4) for t in ts_lib]})")
    timed_step(f"{c.name} forward+backward step", step, smi, calls=20, problems=B, top=8)
    # the device time: back to back, the wrapper's host work outlasts K4
    ms = dev_k4 if dev_k4 is not None else ev_k4
    return dict(ms=ms, plain_ms=ms_p, bound_ms=bound, bound_by=bound_by, library_ms=ms_lib)


# ---------------------------------------------------------------------------
# The generic adjoint route, duals given: K5 (QR solve) and K6 (Schur adjoint)
# ---------------------------------------------------------------------------

def qcqp_system(P, q, radius, l, g, cfg, dtype=None, route=None):
    """(S^T, rhs, am) of ``qcqp_vjp(duals=)``'s assembled system, with the
    duals, squared slacks and strict mask that route computes from these
    inputs; assembled in ``dtype`` (default: the inputs'). ``route`` =
    (recovered, strict), two (B, nc) masks, imposes another solve's
    classification: gamma is kept where ``recovered`` holds and 0 elsewhere,
    and ``strict`` is the strict mask."""
    from diffqcqp_tpu_torch.diff import kkt

    gamma = kkt.qcqp_dual(P, q, radius, l, cfg).gamma
    s, act = kkt.qcqp_strict_active(l, radius, gamma, cfg)
    if route is not None:
        gamma, act = gamma * route[0], route[1]
    dt = dtype or l.dtype
    am = act.to(dt)
    return (*kkt._qcqp_kkt_system(*(x.to(dt) for x in (P, l, g, gamma, s)), am), am)


def box_system(c, l, g, dtype=None):
    """(S^T, rhs, am) of ``box_vjp(duals=)``'s assembled system for the class
    ``c``, with the duals and strict mask that route computes from these
    inputs; assembled in ``dtype`` (default: the inputs')."""
    from diffqcqp_tpu_torch.diff import kkt

    d = kkt.box_dual(c.P, c.q, *c.params, l, c.cfg)
    dt = dtype or l.dtype
    d = kkt.BoxDuals(d.gamma.to(dt), d.act_lo, d.act_hi)
    return kkt._box_kkt_system(c.P.to(dt), l.to(dt), g.to(dt), d, c.cfg)


def phase_2d(points):
    """K5 against its plain version on the card at each (label, A, b), both
    beside a float64 ``torch.linalg.solve`` of the same system. Returns
    {label: max |dx|}.

    Bar, per problem: max |dx| <= min(2e-3, max(1e-4, m kappa_b u)) max(1,
    |x_b|_inf), x_b the plain version's, kappa_b the 2-norm condition number
    of A_b (in float64) and u = 2^-24 float32's unit roundoff. Householder QR
    is backward stable, so each float32 solve sits up to about m kappa u of
    its scale off the exact solution (the first-order normwise bound), and
    two such solves in different rounding orders differ by as much. So 1e-4
    holds where kappa is small (the QP's K, the box system), and the QCQP's
    assembled system, which carries the 1/gamma-sized dgamma of weakly
    active contacts (kappa ~1e5, up to ~4e7), gets phase 2b's per-problem
    dgamma bar of 2e-3: there the kernel and the plain version alike sit
    ~1e-3 of scale off the float64 solve. And over the batch the kernel's
    worst error against the float64 solve must be at most twice the plain
    version's plus 1e-5: the kernel is as accurate as its plain version."""
    from diffqcqp_tpu_torch.kernels.qr_solve_cuda import qr_solve_cuda, qr_solve_plain

    u = torch.finfo(torch.float32).eps / 2
    errs = {}
    for label, A, b in points:
        xk, xp, x64 = qr_solve_cuda(A, b), qr_solve_plain(A, b), solve64(A, b)
        m = A.shape[-1]
        kappa = torch.linalg.cond(A.double())
        bar = (m * kappa * u).clamp(1e-4, 2e-3)
        every = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
        s_kp = per_problem(xk, xp, every)
        s_k64, s_p64 = (float(per_problem(x, x64, every).max()) for x in (xk, xp))
        errs[label] = float((xk - xp).abs().max())
        finite = bool(torch.isfinite(xk).all())
        log(f"  {label} {tuple(A.shape)}: max|dx|={errs[label]:.3e}, per problem "
            f"/max(1,|x|_inf) {float(s_kp.max()):.3e} (over 1e-4 on "
            f"{int((s_kp > 1e-4).sum())}/{s_kp.numel()} problems; largest share of the "
            f"problem's bar min(2e-3, max(1e-4, m kappa u)) {float((s_kp / bar).max()):.3f}; "
            f"kappa median "
            f"{float(kappa.median()):.3e} max {float(kappa.max()):.3e}); against the float64 "
            f"solve: kernel {s_k64:.3e}, plain {s_p64:.3e}; |x|_max {float(x64.abs().max()):.3e}; "
            f"finite={finite}")
        if not (finite and bool((s_kp <= bar).all()) and s_k64 <= 2.0 * s_p64 + 1e-5):
            raise AssertionError(f"K5 disagrees with its plain version: {label}")
    return errs


def phase_2e(cases, rand_g, cfg):
    """K6 against its plain version on the card: gamma, s and the strict mask
    from ``qcqp_dual`` / ``qcqp_strict_active`` on the card, g = 2 l and a
    random g, with phase 2b's bars (``compare_k2``) and the float64 plain
    version beside. Returns the first case's max |d dl| with g = 2 l."""
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import qcqp_kkt_bwd_cuda, qcqp_kkt_bwd_plain

    errs = []
    for label, (P, q, l, r) in cases:
        duals = kkt.qcqp_dual(P, q, r, l, cfg)
        s, act = kkt.qcqp_strict_active(l, r, duals.gamma, cfg)
        for gname, g in (("g=2l", 2.0 * l), ("random g", rand_g(l))):
            a6 = (P, l, g.contiguous(), duals.gamma, s, act)
            a64 = tuple(x.double() for x in a6[:5]) + (act,)
            errs.append(compare_k2(f"{label} {gname}", qcqp_kkt_bwd_cuda(*a6) + (duals.gamma,),
                                   qcqp_kkt_bwd_plain(*a6) + (duals.gamma,),
                                   qcqp_kkt_bwd_plain(*a64), kernel="K6"))
    return errs[0]


def k6_against_k2(P, q, l, r, g, cfg, ulps):
    """K6 fed K2's own gamma (s and the strict mask from
    ``qcqp_strict_active`` on it) against K2 on the same problem, with phase
    2b's bars on the problems whose strict mask agrees: the two kernels share
    steps 4-8, so they differ only where the slack is rounded differently."""
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import (
        qcqp_kkt_bwd_cuda, qcqp_kkt_bwd_fused_cuda, qcqp_kkt_bwd_fused_plain,
    )

    out2 = qcqp_kkt_bwd_fused_cuda(P, q, l, g, r, cfg.eps, cfg.act_eps, ulps)
    s, act = kkt.qcqp_strict_active(l, r, out2[2], cfg)
    out6 = qcqp_kkt_bwd_cuda(P, l, g, out2[2], s, act) + (out2[2],)
    out64 = qcqp_kkt_bwd_fused_plain(*(x.double() for x in (P, q, l, g, r)), cfg.eps,
                                     cfg.act_eps, ulps)
    return compare_k2("K6 fed K2's duals against K2, flagship B=4096 N=24 g=2l", out6, out2,
                      out64, kernel="K6 against K2")


def qcqp_referee(P64, q64, ln64, mu64, l64, g64, cfg, route=None):
    """float64 gradients of <g64, l> for (P, q, l_n, mu) at the float64
    solution l64: the recovered duals, then the assembled KKT system solved
    by ``solve64`` (sharing no arithmetic with K2, K5 or K6), on its own
    classification of the contacts or on ``route``'s (see
    ``qcqp_system``)."""
    from diffqcqp_tpu_torch.api import _grad_P
    from diffqcqp_tpu_torch.diff import kkt

    r64 = ln64 * mu64
    nc = r64.shape[-1]
    gamma = kkt.qcqp_dual(P64, q64, r64, l64, cfg).gamma
    if route is not None:
        gamma = gamma * route[0]
    ST, rhs, am = qcqp_system(P64, q64, r64, l64, g64, cfg, route=route)
    x = solve64(ST, rhs)
    dl, dgamma = x[:, nc:], x[:, :nc] * am
    e1, e2 = kkt.qcqp_radius_factors(ln64, mu64, gamma)
    return _grad_P(dl, l64, P64), -dl, e2 * dgamma, e1 * dgamma


def check_no_tf32(where):
    """The port never turns TF32 on: every float32 product on a solve path
    stays full float32."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError(f"TF32 matmuls are on ({where})")


def stepped(kernels, solve, xs, cfg, w):
    """One forward+backward step of sum(l^2) + <w, l> through ``solve`` and
    torch.autograd.grad, the launch counters zeroed just before and read
    just after. Returns (l, stats, grads, {kernel: launches})."""
    for k_ in kernels.values():
        k_.launches = 0
    leaves = [x.clone().requires_grad_() for x in xs]
    l, st = solve(*leaves, config=cfg)
    grads = torch.autograd.grad((l * l).sum() + (w * l).sum(), leaves)
    torch.cuda.synchronize()
    return l.detach(), st, grads, {name: k_.launches for name, k_ in kernels.items()}


def grad_errors(label, grads, ref, names, bar_med, bar_max, floor=None, rows=None):
    """Per-problem relative errors of each gradient against its referee;
    fails past the bars (median over every problem, max over the problems
    ``rows`` selects, default all)."""
    worst = worst_max = 0.0
    for gname, a, b in zip(names, grads, ref):
        e = rel_err(a, b, b.new_tensor(floor) if floor else None)
        med, mx = float(e.median()), _max(e if rows is None else e[rows])
        worst, worst_max = max(worst, med), max(worst_max, mx)
        over = "" if rows is None else f" over the {int(rows.sum())}/{rows.numel()} problems " \
            "whose strict mask agrees"
        log(f"    {label} grad {gname}: per-problem relative error vs referee median "
            f"{med:.3e} max {mx:.3e}{over} (|ref|_max {float(b.abs().max()):.3e})")
    if not (worst <= bar_med and worst_max <= bar_max):
        raise AssertionError(f"{label}: gradients disagree with the float64 referee")


def phase_3e(dqt, cfg, qp_cfg, kernels, rand_g, flag, out_k, l64_flag):
    """The dispatch past the kernels' bounds and in float64, each case with
    the launch counters zeroed just before and read just after; every route
    is the one ``api._use_kernel`` / ``kkt._use_fused_kernel`` name."""
    from diffqcqp_tpu_torch import api
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.kernels import coord_bwd_cuda, qcqp_bwd_cuda
    from diffqcqp_tpu_torch.kernels.admm_cuda import PROX_DISK, PROX_NONNEG, admm_solve_plain

    check_no_tf32("phase 3e")
    names = ("P", "q", "l_n", "mu")

    def only(got, want=()):
        """Each kernel in ``want`` launched, every other one not."""
        return all((n >= 1) if k in want else (n == 0) for k, n in got.items())

    # (a) QCQP at N=160 (past K2 and K6, within K1): K1, then the generic Schur
    # route's Newton-Schulz branch
    P, q, _, r = cuda(*kkt_problems(256, 80, seed=16))
    l_n, mu = r, torch.ones_like(r)
    if not (api._use_kernel(P, q, cfg) and not kkt._use_fused_kernel(P, q, cfg, qcqp_bwd_cuda.fits)):
        raise AssertionError("the dispatch does not name K1 and the generic route at N=160")
    w = rand_g(q)
    l, st, grads, got = stepped(kernels, dqt.solve_qcqp_with_stats, (P, q, l_n, mu), cfg, w)
    P64, q64, ln64, mu64 = (x.double() for x in (P, q, l_n, mu))
    l64, st64 = admm_solve_plain(P64, q64, torch.zeros_like(q64), PROX_DISK, (ln64 * mu64,),
                                 cfg.replace(eps=1e-10, max_iter=5000), True, False)
    err = float((l.double() - l64).abs().max())
    # the referee solves its system on the route's own classification of
    # the contacts (the duals it recovers from the float32 l, and its strict
    # mask), so every problem is held to it. Where the float64 solution
    # classifies a contact otherwise, the run prints why: the recovery's
    # test r - |l_c| <= eps (the JAX package's autodiff rule too,
    # diffqcqp_tpu/diff/kkt.py::qcqp_dual) on the float32 l
    d32, d64 = kkt.qcqp_dual(P, q, r, l, cfg), kkt.qcqp_dual(P64, q64, ln64 * mu64, l64, cfg)
    act = kkt.qcqp_strict_active(l, r, d32.gamma, cfg)[1]
    act64 = kkt.qcqp_strict_active(l64, ln64 * mu64, d64.gamma, cfg)[1]
    differ = (act != act64).any(dim=-1)
    flip = d32.active != d64.active
    slack32 = r - torch.linalg.vector_norm(l.reshape(256, 80, 2), dim=-1)
    why = (f"; where the recovery differs ({int(flip.sum())} contacts: "
           f"{int((d32.active & ~d64.active).sum())} active on l only): radius "
           f"{float(r[flip].min()):.4f}-{float(r[flip].max()):.4f}, float32 r - |l_c| "
           f"{float(slack32[flip].min()):.3e}-{float(slack32[flip].max()):.3e} against eps "
           f"{cfg.eps:.1e}, float64 gamma {float(d64.gamma[flip].min()):.3e}-"
           f"{float(d64.gamma[flip].max()):.3e}" if bool(flip.any()) else "")
    log(f"  QCQP B=256 N=160 (solve_qcqp + autograd): launches "
        + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; converged_frac={float(st.converged.float().mean())} mean_iters="
        f"{float(st.iterations.float().mean()):.2f}; max|l - l_f64 referee|={err:.3e} (referee "
        f"converged {bool(st64.converged.all())}); problems whose strict mask on l differs from "
        f"the mask on l_f64: {int(differ.sum())}/{differ.numel()} ({int((act != act64).sum())} "
        f"contacts: {int((act & ~act64).sum())} active on l only, {int((~act & act64).sum())} "
        f"on l_f64 only){why}")
    if not (only(got, ("K1",)) and bool(st.converged.all()) and err <= 1e-4
            and bool(st64.converged.all())):
        raise AssertionError("the N=160 QCQP step left its route or its forward check")
    ref = qcqp_referee(P64, q64, ln64, mu64, l64, 2.0 * l64 + w.double(), cfg,
                       route=(d32.active, act))
    grad_errors("N=160", grads, ref, names, 1e-3, 2e-3)

    # (b) QP at N=176 (past K1 and K4): the eager engine (Newton-Schulz
    # inverse), then the assembled SPD system (Newton-Schulz again)
    _, P, q = spd_problems(256, 176, seed=17)
    P, q = cuda(P, q)
    c = qp_class("qp", P, q, qp_cfg)
    if api._use_kernel(P, q, qp_cfg) or kkt._use_fused_kernel(P, q, qp_cfg, coord_bwd_cuda.fits):
        raise AssertionError("the dispatch names a kernel at N=176")
    w = rand_g(q)
    l, st, grads, got = stepped(kernels, dqt.solve_qp_with_stats, (P, q), qp_cfg, w)
    xs64 = [P.double(), q.double()]
    l64, st64 = admm_solve_plain(*xs64, torch.zeros_like(xs64[1]), PROX_NONNEG, (),
                                 qp_cfg.replace(eps=1e-10, max_iter=5000))
    err = float((l.double() - l64).abs().max())
    ref, am_ref = class_referee(c, xs64, [], l64, 2.0 * l64 + w.double())
    am = kkt._qp_kkt_system(P, q, l, 2.0 * l + w, qp_cfg)[2] == 0    # the route's strict mask
    shared = ~(am != am_ref).any(dim=-1)
    log(f"  QP B=256 N=176 (solve_qp + autograd): launches "
        + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; converged_frac={float(st.converged.float().mean())} mean_iters="
        f"{float(st.iterations.float().mean()):.2f}; max|l - l_f64 referee|={err:.3e} (referee "
        f"converged {bool(st64.converged.all())}); problems whose strict mask the referee does "
        f"not share: {int((~shared).sum())}/{shared.numel()}")
    if not (only(got) and bool(st.converged.all()) and err <= 1e-4
            and bool(st64.converged.all())):
        raise AssertionError("the N=176 QP step left its route or its forward check")
    grad_errors("N=176", [g[shared] for g in grads], [x[shared] for x in ref], names[:2],
                1e-3, 2e-3, floor=1e-30)

    # (c) a float64 QCQP on the card: the engine and the generic route in
    # float64, no kernel, against the float64 referee (plain K1 at eps=1e-10)
    P, q, l_n, mu = (x[:256].double() for x in flag)
    w = rand_g(q).double()
    c64 = cfg.replace(eps=1e-10, max_iter=5000)
    l, st, grads, got = stepped(kernels, dqt.solve_qcqp_with_stats, (P, q, l_n, mu), c64, w)
    l64 = l64_flag[:256]
    err = float((l - l64).abs().max())
    ref = qcqp_referee(P, q, l_n, mu, l64, 2.0 * l64 + w, c64)
    every = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    e_g = max(float(per_problem(a.flatten(1), b.flatten(1), every).max())
              for a, b in zip(grads, ref))
    log(f"  float64 QCQP B=256 N=24 on the card: launches "
        + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; dtypes {l.dtype} / {grads[0].dtype}; converged_frac="
        f"{float(st.converged.float().mean())}; max|l - l_f64 referee|={err:.3e} (bar 1e-8); "
        f"gradients per problem /max(1,|ref|_inf) {e_g:.3e} (bar 1e-7)")
    if not (only(got) and l.dtype == torch.float64 and all(g.dtype == torch.float64
                                                              for g in grads)
            and bool(st.converged.all()) and err <= 1e-8 and e_g <= 1e-7):
        raise AssertionError("the float64 QCQP step left float64 or its referee")

    # (d) backend='xla' at the flagship, float32, against K1 (both estimate
    # L by power iteration)
    xcfg = cfg.replace(backend="xla", lmax_method="power")
    for k_ in kernels.values():
        k_.launches = 0
    lx, sx = dqt.solve_qcqp_with_stats(*flag, config=xcfg)
    torch.cuda.synchronize()
    got = {name: k_.launches for name, k_ in kernels.items()}
    lk, sk = out_k
    dl = float((lx - lk).abs().max())
    dit = int((sx.iterations - sk.iterations).abs().max())
    conv_eq = bool((sx.converged == sk.converged).all())
    ms_x, ts_x = time_cuda(lambda: dqt.solve_qcqp_with_stats(*flag, config=xcfg), reps=3)
    log(f"  backend='xla' at the flagship B=4096 N=24 (the eager engine, spectral handle): "
        f"launches " + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; against K1: max|dl|={dl:.3e} (bar 1e-4), max|d iters|={dit} (bar 4), converged "
        f"equal={conv_eq}; engine mean iters {float(sx.iterations.float().mean()):.3f}, K1 "
        f"{float(sk.iterations.float().mean()):.3f}; the engine's forward {ms_x:.2f} ms per "
        f"call (CUDA events, samples {[round(t, 2) for t in ts_x]})")
    if not (only(got) and dl <= 1e-4 and dit <= 4 and conv_eq):
        raise AssertionError("backend='xla' left the engine or disagrees with K1")
    check_no_tf32("phase 3e, end")
    return ms_x


def phase_3d(calls, kernels):
    """Each (label, call, plain, system, want) of the generic adjoint route:
    the launch counters zeroed just before the call and read just after,
    which must show ``want`` ({kernel: launches}; every other kernel 0); then
    the call's (dl, dgamma) against a float64 referee, ``system(torch.
    float64)`` (the assembled system of the call's own duals and strict mask,
    built from its float32 inputs) solved by ``solve64``, beside ``plain()``
    (the same route with the kernel's plain version in its place) and the
    float32 LU of ``system(torch.float32)``. Bars: per-problem relative
    error of dl median <= 1e-3 and max <= 2e-3 (phases 3b and 3c's gradient
    bars; grad q = -dl), each problem's |dl_ref| floored at 1e-3 |g_b| (a
    problem whose every slot is strictly active has dl = 0 exactly in the
    referee and float32 rounding noise in any float32 solve; a free
    coordinate has |dl_i| >~ |g_i| / 4, P's largest eigenvalue being ~4
    for these generators); per problem max |d dgamma| <= 2e-3 max(1,
    |dgamma|_inf) (phase 2b's), or at most twice the plain route's worst
    where that is larger: the route's algorithm itself (unpivoted
    Householder QR of the assembled system, as the JAX package runs it)
    loses more of the 1/gamma-sized dgamma of weakly active contacts in
    float32 than the pivoted LU does (4.0e-3 of scale at the flagship on
    an H100). That bar is capped at ``DGAMMA_CAP`` = 1e-2 of scale, which
    the plain route's own worst must also meet, so an error of the shared
    algorithm cannot raise it. Returns the launches of each kernel summed
    over the calls."""
    total = dict.fromkeys(kernels, 0)
    for label, call, plain, system, want in calls:
        for k_ in kernels.values():
            k_.launches = 0
        out = call()
        torch.cuda.synchronize()
        got = {name: k_.launches for name, k_ in kernels.items()}
        for name, n_ in got.items():
            total[name] += n_
        ST, rhs, am = system(torch.float64)
        m = am.shape[-1]
        x64 = solve64(ST, rhs)
        ref = (x64[:, m:], x64[:, :m] * am)
        ST32, rhs32, am32 = system(torch.float32)
        x32 = torch.linalg.solve(ST32, rhs32[..., None])[..., 0]
        pl = plain()
        every = torch.ones(am.shape[0], dtype=torch.bool, device=am.device)
        floor = 1e-3 * rhs.norm(dim=-1)     # rhs = [0; g]
        e_dl, e_dlp, e_dl32 = (rel_err(x, ref[0], floor) for x in (out.dl, pl[0], x32[:, m:]))
        e_dg, e_dgp, e_dg32 = (per_problem(x, ref[1], every)
                               for x in (out.dgamma, pl[1], x32[:, :m] * am32))
        bar_dg = min(DGAMMA_CAP, max(2e-3, 2.0 * float(e_dgp.max())))
        finite = bool(torch.isfinite(out.dl).all() and torch.isfinite(out.dgamma).all())
        log(f"  {label} (m = {ST.shape[-1]}): launches " + ", ".join(f"{k} {v}" for k, v in got.items())
            + f"; strictly active slots {float(am.mean()):.4f}; finite {finite}\n"
            f"    against the float64 referee (dl median / dl max / dgamma max, per problem): "
            f"the call {float(e_dl.median()):.3e} / {float(e_dl.max()):.3e} / "
            f"{float(e_dg.max()):.3e} (dgamma bar {bar_dg:.3e}; over 2e-4 on "
            f"{int((e_dg > 2e-4).sum())}/{e_dg.numel()} problems); the plain version's route "
            f"{float(e_dlp.median()):.3e} / {float(e_dlp.max()):.3e} / {float(e_dgp.max()):.3e}; "
            f"float32 LU of the same system {float(e_dl32.median()):.3e} / "
            f"{float(e_dl32.max()):.3e} / {float(e_dg32.max()):.3e}")
        if got != {name: want.get(name, 0) for name in kernels} or not finite:
            raise AssertionError(f"{label} did not run through {want} alone")
        if not (float(e_dl.median()) <= 1e-3 and float(e_dl.max()) <= 2e-3
                and float(e_dg.max()) <= bar_dg and float(e_dgp.max()) <= DGAMMA_CAP):
            raise AssertionError(f"{label} disagrees with its float64 referee")
    return total


def phase_3d_f64(a64, cfg, kernels):
    """``qcqp_vjp(duals=)`` on float64 card tensors above the route's bound
    (a64 = (P, q, radius, l, g)): the Schur route's float64 branch, a
    Cholesky of D and an LU of the nc x nc system, launches no kernel (the
    counters zeroed just before, read just after), and its (dl, dgamma) sit
    within 1e-7 of each problem's scale of the float64 referee, the
    assembled system solved by ``solve64``: both are float64 solves of the
    same system, apart by about kappa u64 <~ 1e-8 (kappa up to ~4e7 on the
    QCQP systems of phase 2d), while a float32 solve sits ~1e-4 off."""
    from diffqcqp_tpu_torch.diff import kkt

    for k_ in kernels.values():
        k_.launches = 0
    out = kkt.qcqp_vjp(*a64, cfg, duals=kkt.qcqp_dual(*a64[:4], cfg))
    torch.cuda.synchronize()
    got = {name: k_.launches for name, k_ in kernels.items()}
    ST, rhs, am = qcqp_system(*a64, cfg)
    m = am.shape[-1]
    x64 = solve64(ST, rhs)
    every = torch.ones(am.shape[0], dtype=torch.bool, device=am.device)
    e_dl = float(per_problem(out.dl, x64[:, m:], every).max())
    e_dg = float(per_problem(out.dgamma, x64[:, :m] * am, every).max())
    log(f"  qcqp_vjp(duals=) in float64, B={am.shape[0]} N={a64[3].shape[-1]}: launches "
        + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; dtype {out.dl.dtype}; against the float64 referee, per problem /max(1,|.|_inf): "
        f"dl {e_dl:.3e}, dgamma {e_dg:.3e} (bar 1e-7)")
    if any(got.values()) or out.dl.dtype != torch.float64 or not (e_dl <= 1e-7 and e_dg <= 1e-7):
        raise AssertionError("qcqp_vjp(duals=) in float64 left its float64 route")


def qr_plain_route(system):
    """(dl, dgamma) of the assembled route with K5's plain version in the
    kernel's place: ``system(torch.float32)`` solved by ``qr_solve_plain``."""
    from diffqcqp_tpu_torch.kernels.qr_solve_cuda import qr_solve_plain

    ST, rhs, am = system(torch.float32)
    m = am.shape[-1]
    x = qr_solve_plain(ST.contiguous(), rhs.contiguous())
    return x[:, m:], x[:, :m] * am


def schur_plain_route(P, q, r, l, g, cfg):
    """(dl, dgamma) of the Schur route with K6's plain version in the
    kernel's place, on the duals and mask ``qcqp_vjp`` computes."""
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import qcqp_kkt_bwd_plain

    gamma = kkt.qcqp_dual(P, q, r, l, cfg).gamma
    s, act = kkt.qcqp_strict_active(l, r, gamma, cfg)
    dgamma, dl = qcqp_kkt_bwd_plain(P, l, g, gamma, s, act)
    return dl, dgamma


def phase_4d(points, smi):
    """K5 at each phase-2d point: its device time per launch
    (torch.profiler), CUDA events over 20 back-to-back calls, its plain
    version, its bound and ``torch.linalg.solve`` of the same float32
    system. Returns {label: the numbers of the kernels line}."""
    from diffqcqp_tpu_torch.kernels.qr_solve_cuda import qr_solve_cuda, qr_solve_plain

    out = {}
    for label, A, b in points:
        B, m = b.shape
        k5 = lambda: qr_solve_cuda(A, b)   # noqa: E731
        dev = per_launch_ms(device_time_by_kernel(k5), "qr_solve_kernel")
        ev, ts = time_cuda(k5, reps=5, calls=20)
        ms_p, ts_p = time_cuda(lambda: qr_solve_plain(A, b), reps=3)
        b3 = b[..., None].contiguous()
        ms_lib, ts_lib = time_cuda(lambda: torch.linalg.solve(A, b3), reps=5, calls=20)
        bound, bound_by, nbytes, nflops = k5_bound_ms(B, m)
        log(f"  K5 at {label} {tuple(A.shape)} ({smi}): device time per launch "
            f"(torch.profiler) {dev if dev is None else round(dev, 4)} ms; per call, 20 "
            f"back-to-back (CUDA events) {ev:.4f} ms (samples {[round(t, 4) for t in ts]}); "
            f"plain version {ms_p:.2f} ms (samples {[round(t, 2) for t in ts_p]}); bound "
            f"{bound:.5f} ms ({bound_by}: {nbytes} bytes, {nflops:.4g} FLOP); torch.linalg.solve "
            f"{ms_lib:.4f} ms (samples {[round(t, 4) for t in ts_lib]})")
        out[label] = dict(ms=dev if dev is not None else ev, plain_ms=ms_p, bound_ms=bound,
                          bound_by=bound_by, library_ms=ms_lib)
    return out


def phase_4e(cases, smi):
    """K6 at each (label, K6 inputs, K2 inputs, (S^T, rhs)): beside K2 on the
    same problems (its own duals) and ``torch.linalg.solve`` of the
    assembled float32 system; device time per launch (torch.profiler), CUDA
    events over 20 back-to-back calls, the plain version and the bound.
    Returns the first case's numbers for the kernels line."""
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import (
        qcqp_kkt_bwd_cuda, qcqp_kkt_bwd_fused_cuda, qcqp_kkt_bwd_plain,
    )

    out = []
    for label, a6, a2, (ST, rhs) in cases:
        B, n = a6[1].shape
        k6 = lambda: qcqp_kkt_bwd_cuda(*a6)          # noqa: E731
        k2 = lambda: qcqp_kkt_bwd_fused_cuda(*a2)    # noqa: E731
        dev6 = per_launch_ms(device_time_by_kernel(k6), "qcqp_schur_kernel")
        dev2 = per_launch_ms(device_time_by_kernel(k2), "qcqp_bwd_kernel")
        ev6, ts6 = time_cuda(k6, reps=5, calls=20)
        ev2, _ = time_cuda(k2, reps=5, calls=20)
        ms_p, ts_p = time_cuda(lambda: qcqp_kkt_bwd_plain(*a6), reps=2)
        rhs3 = rhs[..., None].contiguous()
        ms_lib, ts_lib = time_cuda(lambda: torch.linalg.solve(ST, rhs3), reps=3, calls=5)
        bound, bound_by, nbytes, nflops = k6_bound_ms(B, n, n // 2, a6[5])
        b2, b2_by, b2_bytes, b2_flops = k2_bound_ms(B, n, n // 2, a6[5])
        fmt = lambda x: "not in the trace" if x is None else f"{x:.4f} ms"  # noqa: E731
        log(f"  K6 at {label} ({smi}): device time per launch (torch.profiler) {fmt(dev6)}; "
            f"per call, 20 back-to-back (CUDA events) {ev6:.4f} ms (samples "
            f"{[round(t, 4) for t in ts6]}); K2 on the same problems {fmt(dev2)} device, "
            f"{ev2:.4f} ms events; plain version {ms_p:.2f} ms (samples "
            f"{[round(t, 2) for t in ts_p]}); bound {bound:.5f} ms ({bound_by}: {nbytes} bytes, "
            f"{nflops:.4g} FLOP; {int(a6[5].sum())} strictly active contacts); K2's bound "
            f"{b2:.5f} ms ({b2_by}: {b2_bytes} bytes, {b2_flops:.4g} FLOP); "
            f"torch.linalg.solve of the assembled float32 {tuple(ST.shape)} (K6's and K2's "
            f"library call): {ms_lib:.4f} ms (samples {[round(t, 4) for t in ts_lib]})")
        out.append(dict(ms=dev6 if dev6 is not None else ev6, plain_ms=ms_p, bound_ms=bound,
                        bound_by=bound_by, library_ms=ms_lib))
    return out[0]


# ---------------------------------------------------------------------------
# Diagonal P, the KKT oracle, the system-ID step and the contact rollout
# ---------------------------------------------------------------------------

def strict_mask(name, P, q, params, l, cfg):
    """(B, slots) strict-complementarity mask the class's adjoint uses at l
    (P dense or diagonal)."""
    from diffqcqp_tpu_torch.diff import kkt

    if name == "qp":
        return kkt.qp_dual(P, q, l, cfg) < -cfg.act_eps
    if name == "qcqp":
        r = params[0] * params[1]
        return kkt.qcqp_strict_active(l, r, kkt.qcqp_dual(P, q, r, l, cfg).gamma, cfg)[1]
    d = (kkt.box_dual(P, q, *params[:2], l, cfg) if name == "box_qp"
         else kkt.signed_box_dual(P, q, *params[:3], l, cfg))
    return torch.cat(d[1:], dim=-1) & (d.gamma > cfg.act_eps)


def diag_cases(cfg, qp_cfg, box_cfg, b_flag=B_FLAG, b_box=2048):
    """The four classes with P replaced by its diagonal, float32 on the card:
    {name: (differentiable inputs, other inputs, config)}. QP and QCQP:
    bench.py's generator (seed 0); box and signed box: the generator at seed
    9 with config 9's bounds."""
    P, q, l_n, mu = build_problems(b_flag, NC_FLAG)
    P9, q9, _, _ = build_problems(b_box, NC_FLAG, seed=9)
    lo, hi, v = box_bounds(np.random.default_rng(9), b_box, 2 * NC_FLAG)
    Pd, Pd9 = (np.ascontiguousarray(np.diagonal(x, axis1=1, axis2=2)) for x in (P, P9))
    Pd, q, l_n, mu, Pd9, q9, lo, hi, v = cuda(Pd, q, l_n, mu, Pd9, q9, lo, hi, v)
    return {"qp": ((Pd, q), (), qp_cfg), "box_qp": ((Pd9, q9, lo, hi), (), box_cfg),
            "signed_box_qp": ((Pd9, q9, lo, hi), (v,), box_cfg),
            "qcqp": ((Pd, q, l_n, mu), (), cfg)}


def phase_3f(dqt, kernels, cases, rand_g):
    """Diagonal P through the four entry points and autograd, each run with
    the launch counters zeroed just before and read just after: no kernel
    launched in float32 or float64; the gradients against the dense path on
    diag_embed(P) (K1, then K2 or K4) and against a float64 run of the same
    diagonal problems (eps=1e-10), phase 3's bars on the problems whose
    strict mask agrees. Returns {name: the float32 step as a closure}."""
    steps = {}
    for name, (diff, rest, c) in cases.items():
        solve = getattr(dqt, f"solve_{name}_with_stats")
        f = lambda *a, config, solve=solve, rest=rest: solve(*a, *rest, config=config)  # noqa: E731
        w = rand_g(diff[1])
        l, st, grads, got = stepped(kernels, f, diff, c, w)
        dense = (torch.diag_embed(diff[0]),) + diff[1:]
        ld, std, gd, got_d = stepped(kernels, f, dense, c, w)
        c64 = c.replace(eps=1e-10, max_iter=5000)
        rest64 = tuple(x.double() for x in rest)
        f64 = lambda *a, config, solve=solve: solve(*a, *rest64, config=config)  # noqa: E731
        l64, st64, g64, got_64 = stepped(kernels, f64, [x.double() for x in diff], c64, w.double())
        bwd = "K2" if name == "qcqp" else "K4"
        conv = [float(s.converged.float().mean()) for s in (st, std, st64)]
        log(f"  diagonal P, {name} B={diff[1].shape[0]} N={diff[1].shape[1]}: launches "
            + ", ".join(f"{k} {v}" for k, v in got.items())
            + f" (float64: {sum(got_64.values())}; dense path on diag_embed(P): "
            + ", ".join(f"{k} {v}" for k, v in got_d.items())
            + f"); converged_frac {conv[0]} (dense {conv[1]}, float64 {conv[2]}); mean iters "
            + " / ".join(f"{float(s_.iterations.float().mean()):.2f}" for s_ in (st, std, st64))
            + f" (diagonal / dense / float64); max|l - l_dense| "
            f"{float((l - ld).abs().max()):.3e}, max|l - l_f64| "
            f"{float((l.double() - l64).abs().max()):.3e}")
        if any(got.values()) or any(got_64.values()) or got_d["K1"] < 1 or got_d[bwd] < 1:
            raise AssertionError(f"diagonal P {name}: a kernel ran, or the dense path missed "
                                 f"K1 or {bwd}")
        if min(conv) < 1.0 or not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"diagonal P {name}: a solve did not converge or a gradient is "
                                 f"not finite")
        names = ("P", "q", "l_n", "mu") if name == "qcqp" else ("P", "q", "l_min", "l_max")
        params = diff[2:] + rest
        mask = strict_mask(name, diff[0], diff[1], params, l, c)
        gd = (torch.diagonal(gd[0], dim1=1, dim2=2),) + gd[1:]
        grad_errors(f"diagonal P {name} against the dense path", grads, gd, names, 1e-3, 2e-3,
                    1e-30, ~(mask != strict_mask(name, diff[0], diff[1], params, ld, c)).any(-1))
        mask64 = strict_mask(name, *(x.double() for x in diff[:2]),
                             tuple(x.double() for x in params), l64, c64)
        grad_errors(f"diagonal P {name} against float64", grads, g64, names, 1e-3, 2e-3, 1e-30,
                    ~(mask != mask64).any(dim=-1))
        leaves = [x.clone().requires_grad_() for x in diff]

        def step(xs=leaves, f=f, c=c, w=w):
            lx = f(*xs, config=c)[0]
            return torch.autograd.grad((lx * lx).sum() + (w * lx).sum(), xs)

        steps[name] = step
    return steps


def fd_median(solve, xs, rest, grads, pi, w, h=1e-3, k=5):
    """tpu_smoke.py's finite-difference check through the public solve on
    the card (float32): the median over the k largest coordinates of the
    analytic gradient of input ``pi`` of |fd - ad| / max(|fd|, |ad|, 1e-3),
    fd the central difference at step h of the perturbed problem's own
    loss sum(l^2) + <w, l> (the other problems' terms are unchanged), all
    2k perturbed problems solved in one call."""
    g = grads[pi]
    flat = torch.topk(g.abs().flatten(), k).indices.tolist()
    per = g[0].numel()
    jobs = [(idx // per, idx % per, s) for idx in flat for s in (h, -h)]
    rows = torch.tensor([j[0] for j in jobs], device=g.device)
    batch = [x[rows].clone() for x in xs]
    for r_, (_, j_, s_) in enumerate(jobs):
        batch[pi][r_].view(-1)[j_] += s_
    l = solve(*batch, *(x[rows] for x in rest))[0].double()
    f = ((l * l).sum(-1) + (w[rows].double() * l).sum(-1)).tolist()
    rels = []
    for r_ in range(0, len(jobs), 2):
        fd = (f[r_] - f[r_ + 1]) / (2 * h)
        ad = float(g[jobs[r_][0]].flatten()[jobs[r_][1]])
        rels.append(abs(fd - ad) / max(abs(fd), abs(ad), 1e-3))
    return float(np.median(rels))


def phase_3g(dqt, kernels, points, rand_g):
    """The twin of tpu_smoke.py at the four classes' main-path points: the
    float32 K1 solutions from ``*_with_stats`` (K1 launched) certified by
    ``verify.check_*`` in float64 on the card, per problem: stationarity <
    2 ``verify.stationarity_bound``; primal median < 1e-6, max < 1e-5;
    complementarity median < 5e-4, max < 5e-2; the float32 duals of
    ``recover_*_duals`` against verify's float64 least-squares multipliers,
    median relative error < 1e-2 over the strong ones (> max(1e-2, 10 eps));
    central differences (``fd_median``) < 1e-2 for each checked input."""
    from diffqcqp_tpu_torch import verify

    check = {"qp": verify.check_qp, "box_qp": verify.check_box_qp,
             "signed_box_qp": verify.check_signed_box_qp, "qcqp": verify.check_qcqp}
    for name, (diff, rest, c, fd_inputs) in points.items():
        solve = getattr(dqt, f"solve_{name}_with_stats")
        for k_ in kernels.values():
            k_.launches = 0
        l, st = solve(*diff, *rest, config=c)
        torch.cuda.synchronize()
        n_k1 = kernels["K1"].launches
        r = check[name](*diff, *rest, l)
        bound = verify.stationarity_bound(diff[0], diff[1], l, st, alpha=c.alpha_relax,
                                          mu_prox=c.mu_prox)
        ratio = r.stationarity / (2.0 * bound)
        prim, comp = r.primal, r.complementarity
        rec = getattr(dqt, f"recover_{name}_duals")(*diff, *rest, l, config=c)
        g32 = torch.cat(rec, dim=-1) if isinstance(rec, tuple) else rec
        strong = r.gamma > max(1e-2, 10 * c.eps)
        dual_rel = float(((g32.double() - r.gamma).abs() / r.gamma)[strong].median()) \
            if bool(strong.any()) else float("inf")
        w = rand_g(diff[1])
        leaves = [x.clone().requires_grad_() for x in diff]
        lx = solve(*leaves, *rest, config=c)[0]
        grads = torch.autograd.grad((lx * lx).sum() + (w * lx).sum(), leaves)
        fd = {nm: fd_median(lambda *a: solve(*a, config=c), diff, rest, grads, pi, w)
              for nm, pi in fd_inputs}
        log(f"  certified {name} B={diff[1].shape[0]} N={diff[1].shape[1]}: K1 launches {n_k1}; "
            f"float64 on the card ({r.stationarity.dtype}, {r.stationarity.device}): "
            f"stationarity median {float(r.stationarity.median()):.3e} max "
            f"{float(r.stationarity.max()):.3e}, over 2x its bound max {float(ratio.max()):.3f} "
            f"(bar < 1); primal median {float(prim.median()):.3e} max {float(prim.max()):.3e} "
            f"(bars 1e-6, 1e-5); complementarity median {float(comp.median()):.3e} max "
            f"{float(comp.max()):.3e} (bars 5e-4, 5e-2); float32 duals against verify's, "
            f"{int(strong.sum())} strong multipliers: median relative error {dual_rel:.3e} "
            f"(bar 1e-2); central differences (h=1e-3, 5 largest coordinates) median relative "
            f"error " + ", ".join(f"{k}: {v:.3e}" for k, v in fd.items()) + " (bar 1e-2)")
        if not (n_k1 >= 1 and bool((ratio < 1.0).all()) and float(prim.median()) < 1e-6
                and float(prim.max()) < 1e-5 and float(comp.median()) < 5e-4
                and float(comp.max()) < 5e-2 and dual_rel < 1e-2 and max(fd.values()) < 1e-2):
            raise AssertionError(f"the certification of {name} failed")


def sysid_inputs(b=2048, nc=NC_FLAG, seed=3):
    """run_benchmarks.py config 4's parameters and target, float32 on the
    card: S ~ N(0, 1) / sqrt(n), q ~ N(0, 0.09), log_l_n = logit_mu = 0,
    target ~ U(0, 0.1)."""
    n = 2 * nc
    rng = np.random.default_rng(seed)
    S = (rng.standard_normal((b, n, n)) / np.sqrt(n)).astype(np.float32)
    q = (rng.standard_normal((b, n)) * 0.3).astype(np.float32)
    target = (rng.random((b, n)) * 0.1).astype(np.float32)
    zeros = np.zeros((b, nc), np.float32)
    return cuda(S, q, zeros, zeros.copy()), cuda(target)[0]


def sysid_loss(dqt, params, target, qp_cfg, qc_cfg):
    """Config 4's loss through ``models.system_id``'s problem map: P = S S^T
    + 0.1 I shared by a non-negative QP and a QCQP, the mean squared error
    of both solutions against the target."""
    from diffqcqp_tpu_torch.models.system_id import QCQPSystemIDParams, qcqp_params_to_problem

    P, q, l_n, mu = qcqp_params_to_problem(QCQPSystemIDParams(*params), reg=0.1)
    l_qp = dqt.solve_qp(P, q, config=qp_cfg)
    l_qc = dqt.solve_qcqp(P, q, l_n, mu, config=qc_cfg)
    return torch.mean((l_qp - target) ** 2) + torch.mean((l_qc - target) ** 2), (P, q, l_n, mu,
                                                                               l_qp, l_qc)


def phase_3h(dqt, kernels, sysid, qp_cfg, qc_cfg, steps=20):
    """The config-4 system-ID step (2048 QPs + 2048 QCQPs, N=24, Adam lr
    1e-2): its launches, counted from just before one step (forward,
    backward, Adam) to just after, must be K1 2, K4 1 and K2 1 and no
    other; its gradients against the same step on float64 inputs (the
    engine and the generic route, eps=1e-10), phase 3's bars on the problems
    whose QP and QCQP strict masks both agree; the loss falls over
    ``steps`` Adam steps. Returns (the launches, the step as a closure)."""
    (S, q, ln, lm), target = sysid
    names = ("S", "q", "log_l_n", "logit_mu")
    leaves = [x.clone().requires_grad_() for x in (S, q, ln, lm)]
    loss, aux = sysid_loss(dqt, leaves, target, qp_cfg, qc_cfg)
    grads = torch.autograd.grad(loss, leaves)
    p64 = [x.double().requires_grad_() for x in (S, q, ln, lm)]
    c64 = (qp_cfg.replace(eps=1e-10, max_iter=5000), qc_cfg.replace(eps=1e-10, max_iter=5000))
    loss64, aux64 = sysid_loss(dqt, p64, target.double(), *c64)
    g64 = torch.autograd.grad(loss64, p64)
    (P, qq, ln_, mu_, lq, lc), (P64, q64, ln64, mu64, lq64, lc64) = (
        [x.detach() for x in a] for a in (aux, aux64))
    shared = ~((strict_mask("qp", P, qq, (), lq, qp_cfg)
                != strict_mask("qp", P64, q64, (), lq64, c64[0])).any(dim=-1)
               | (strict_mask("qcqp", P, qq, (ln_, mu_), lc, qc_cfg)
                  != strict_mask("qcqp", P64, q64, (ln64, mu64), lc64, c64[1])).any(dim=-1))
    log(f"  config-4 loss float32 {float(loss.detach()):.6e}, float64 {float(loss64.detach()):.6e}")
    grad_errors("system-ID step", grads, g64, names, 1e-3, 2e-3, 1e-30, shared)

    params = [x.clone().requires_grad_() for x in (S, q, ln, lm)]
    opt = torch.optim.Adam(params, lr=1e-2)

    def step():
        opt.zero_grad(set_to_none=True)
        value, _ = sysid_loss(dqt, params, target, qp_cfg, qc_cfg)
        value.backward()
        opt.step()
        return value.detach()

    for k_ in kernels.values():
        k_.launches = 0
    losses = [step()]
    torch.cuda.synchronize()
    got = {name: k_.launches for name, k_ in kernels.items()}
    losses += [step() for _ in range(steps - 1)]
    losses = [float(x) for x in losses]
    log(f"  config-4 system-ID step B=2048+2048 N=24: launches in one step "
        + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; loss over {steps} Adam steps {losses[0]:.6e} -> {losses[-1]:.6e}")
    if got != {"K1": 2, "K2": 1, "K4": 1, "K5": 0, "K6": 0}:
        raise AssertionError(f"the system-ID step's launches are {got}, not K1 2, K4 1, K2 1")
    if not losses[-1] < losses[0]:
        raise AssertionError("the system-ID loss did not fall")
    return got, step


def rollout_inputs(b=2048, t=50, seed=11):
    """run_benchmarks.py config 11's bodies and pushes, float32 on the card:
    (ContactParams, ContactState, f_ext (T, B, 3))."""
    from diffqcqp_tpu_torch.models import contact_sim as cs

    rng = np.random.default_rng(seed)
    mass = (rng.random(b) * 2.0 + 0.5).astype(np.float32)
    mu = (rng.random(b) * 0.6 + 0.2).astype(np.float32)
    x0 = np.zeros((b, 3), np.float32)
    v0 = rng.standard_normal((b, 3)).astype(np.float32)
    v0[:, 2] = 0.0
    steps = rng.standard_normal((t, b, 3)).astype(np.float32) * 0.15
    steps[:, :, 2] = 0.0
    f = np.cumsum(steps, axis=0) + rng.standard_normal((1, b, 3)).astype(
        np.float32) * np.array([2.0, 2.0, 0.0], np.float32)
    mass, mu, x0, v0, f = cuda(mass, mu, x0, v0, f.astype(np.float32))
    return cs.ContactParams(mass, mu), cs.ContactState(x0, v0), f


def phase_3i(kernels, rollout):
    """The config-11 contact rollout (diagonal-P QP and QCQP per body and
    step) warm and cold, counters zeroed just before each and read just
    after: no kernel; the float32 positions against a float64 rollout on the
    card (eps=1e-10) within 1e-4; warm and cold within 1e-4; then
    tests/test_contact_sim.py's probes in float64: a resting body stays put
    (1e-5) and a sliding body decelerates at ~mu g and stops."""
    from diffqcqp_tpu_torch.models import contact_sim as cs

    params, state0, f = rollout
    trajs = {}
    for warm in (True, False):
        for k_ in kernels.values():
            k_.launches = 0
        _, traj, st = cs.simulate(params, state0, f, warm_start=warm, return_stats=True)
        torch.cuda.synchronize()
        got = {name: k_.launches for name, k_ in kernels.items()}
        trajs[warm] = traj
        log(f"  contact rollout B={f.shape[1]} T={f.shape[0]} warm_start={warm}: launches "
            + ", ".join(f"{k} {v}" for k, v in got.items())
            + f"; mean iterations per step (steps 1..T-1) QP "
            f"{float(st['qp_iters'][1:].mean()):.3f}, "
            f"QCQP {float(st['qcqp_iters'][1:].mean()):.3f}")
        if any(got.values()) or not bool(torch.isfinite(traj.x).all()):
            raise AssertionError("the contact rollout launched a kernel or is not finite")
    cfg64 = dict(qp_cfg=cs.QP_CFG.replace(eps=1e-10, max_iter=5000),
                 qcqp_cfg=cs.QCQP_CFG.replace(eps=1e-10, max_iter=5000))
    _, traj64, st64 = cs.simulate(cs.ContactParams(*(x.double() for x in params)),
                                  cs.ContactState(*(x.double() for x in state0)), f.double(),
                                  return_stats=True, **cfg64)
    dev = float((trajs[True].x.double() - traj64.x).abs().max())
    dev_wc = float((trajs[True].x - trajs[False].x).abs().max())
    log(f"  max position deviation, float32 warm rollout against float64 (eps=1e-10; mean iters "
        f"QP {float(st64['qp_iters'].mean()):.2f}, QCQP {float(st64['qcqp_iters'].mean()):.2f}): "
        f"{dev:.3e} (bar 1e-4); warm against cold {dev_wc:.3e} (bar 1e-4)")
    if not (dev <= 1e-4 and dev_wc <= 1e-4):
        raise AssertionError("the contact rollout disagrees with float64 or with itself")

    dt64 = dict(dtype=torch.float64, device=f.device)
    b = 4
    rest = cs.ContactParams(torch.ones(b, **dt64), torch.full((b,), 0.5, **dt64))
    final, traj = cs.simulate(rest, cs.ContactState(torch.zeros(b, 3, **dt64),
                                                    torch.zeros(b, 3, **dt64)),
                              torch.zeros(50, b, 3, **dt64))
    rest_x, rest_vz = float(final.x.abs().max()), float(traj.v[:, :, 2].abs().max())
    slide = cs.ContactParams(torch.ones(2, **dt64), torch.tensor([0.3, 0.8], **dt64))
    v0 = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], **dt64)
    _, traj = cs.simulate(slide, cs.ContactState(torch.zeros(2, 3, **dt64), v0),
                          torch.zeros(120, 2, 3, **dt64))
    speeds = traj.v[:, :, :2].norm(dim=-1)
    stop = (speeds < 1e-3).double().argmax(dim=0)
    expected = 1.0 - 0.3 * 9.81 * 30 * 0.01
    log(f"  probes: resting body max|x| {rest_x:.3e}, max|v_z| {rest_vz:.3e} (bars 1e-5); sliding "
        f"bodies (mu 0.3, 0.8): largest speed increase {float(speeds.diff(dim=0).max()):.3e} "
        f"(bar 1e-5), final speeds {speeds[-1].tolist()} (bar 1e-4), stop steps {stop.tolist()}, "
        f"speed at step 30 {float(speeds[29, 0]):.4f} against 1 - mu g t = {expected:.4f} "
        f"(bar 0.05)")
    if not (rest_x < 1e-5 and rest_vz < 1e-5 and float(speeds.diff(dim=0).max()) <= 1e-5
            and bool((speeds[-1] < 1e-4).all()) and int(stop[1]) < int(stop[0])
            and abs(float(speeds[29, 0]) - expected) < 0.05):
        raise AssertionError("a contact physics probe failed")


def phase_4f(dqt, smi, sysid_step, rollout, diag_step, flag, cfg):
    """Phase 4's timings of this slice's paths: the config-4 system-ID step;
    the contact rollout warm and cold (steps/s and mean iterations per
    step); the contact system-ID step (``make_system_id_step``, lr 0.05,
    from mass 1 and mu 0.5 towards the rollout's own trajectory);
    ``qcqp_jacobian`` at the flagship (l solved inside: K1, and l given) and
    held against ``qcqp_vjp`` in float64; the diagonal-P flagship step."""
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.models import contact_sim as cs

    timed_step("config-4 system-ID step, B=2048 QPs + 2048 QCQPs N=24 (forward, backward, "
               "Adam)", sysid_step, smi, calls=20, problems=4096)
    params, state0, f = rollout
    T, B = f.shape[:2]
    for warm in (True, False):
        roll = lambda warm=warm: cs.simulate(params, state0, f, warm_start=warm,  # noqa: E731
                                             return_stats=True)
        _, _, st = roll()
        ms, _ = timed_step(f"contact rollout B={B} T={T} warm_start={warm}", roll, smi)
        log(f"    = {T / ms * 1e3:.2f} steps/s, {B * T / ms * 1e3:.1f} body-steps/s; mean "
            f"iterations per step (steps 1..T-1) QP {float(st['qp_iters'][1:].mean()):.3f}, QCQP "
            f"{float(st['qcqp_iters'][1:].mean()):.3f}")
    _, traj = cs.simulate(params, state0, f)
    raw = {"log_mass": torch.zeros(B, device=f.device, requires_grad=True),
           "logit_mu": torch.zeros(B, device=f.device, requires_grad=True)}
    cstep, _ = cs.make_system_id_step(raw, state0, f, traj.x.detach(), learning_rate=0.05)
    losses = []
    timed_step(f"contact system-ID step B={B} T={T} (rollout, backward through {2 * T} solves, "
               f"Adam)", lambda: losses.append(float(cstep())), smi)
    l0, l1 = losses[0], losses[-1]
    log(f"    contact system-ID loss {l0:.6e} -> {l1:.6e} over {len(losses)} Adam steps")
    if not (np.isfinite(l1) and l1 < l0):
        raise AssertionError("the contact system-ID loss did not fall")

    P, q, l_n, mu = flag
    timed_step("qcqp_jacobian at the flagship B=4096 N=24, l solved inside (K1)",
               lambda: dqt.qcqp_jacobian(P, q, l_n, mu, config=cfg), smi, calls=5)
    l = dqt.solve_qcqp(P, q, l_n, mu, config=cfg)
    timed_step("qcqp_jacobian at the flagship, l given",
               lambda: dqt.qcqp_jacobian(P, q, l_n, mu, l=l, config=cfg), smi, calls=5)
    x64 = [x.double() for x in (P, q, l_n, mu, l)]
    jac = dqt.qcqp_jacobian(*x64[:4], l=x64[4], config=cfg)
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64).to(q.device)
    r = kkt.qcqp_vjp(x64[0], x64[1], x64[2] * x64[3], x64[4], w, cfg)
    every = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    e = float(per_problem(-(w[:, None, :] @ jac.dl_dq)[:, 0], r.dl, every).max())
    e2 = kkt.qcqp_radius_factors(x64[2], x64[3], r.gamma)[1]
    e_ln = float(per_problem((w[:, None, :] @ jac.dl_dl_n)[:, 0], e2 * r.dgamma, every).max())
    log(f"    qcqp_jacobian in float64 on the card against qcqp_vjp of a random cotangent w (the "
        f"assembled system by an LU; the Jacobian by a Cholesky of D and the Schur complement): "
        f"-w^T dl/dq against dl per problem /max(1,|.|_inf) {e:.3e}, w^T dl/dl_n against e2 "
        f"dgamma {e_ln:.3e} (bars 1e-7: two float64 solves of systems with kappa up to ~4e7)")
    if not (e <= 1e-7 and e_ln <= 1e-7):
        raise AssertionError("qcqp_jacobian disagrees with qcqp_vjp")
    timed_step("diagonal-P flagship QCQP step B=4096 N=24 (the eager engine and the closed form)",
               diag_step, smi, calls=5, problems=4096)


# ---------------------------------------------------------------------------
# Sharded, bucketed and resumed steps, traces and the build cache
# ---------------------------------------------------------------------------

def free_port():
    """A free TCP port on the loopback interface."""
    import socket

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def l_agree(label, l, ref, bar, st=None, st_ref=None, it_bar=0):
    """max |l - ref| within ``bar``, with the count of problems equal bit for
    bit; with stats, every problem converged and per-problem iterations
    within ``it_bar``. Returns max |dl|."""
    dl = float((l - ref).abs().max())
    same = (l == ref).all(dim=-1)
    msg = f"    {label}: max|dl|={dl:.3e} (bar {bar:g}), problems bit for bit equal " \
          f"{int(same.sum())}/{same.numel()}"
    ok = dl <= bar and bool(torch.isfinite(l).all())
    if st is not None:
        dit = (st.iterations - st_ref.iterations).abs()
        msg += (f", max|d iterations|={int(dit.max())} (bar {it_bar}; problems with any: "
                f"{int((dit > 0).sum())})")
        ok = ok and int(dit.max()) <= it_bar and bool(st.converged.all())
    log(msg)
    if not ok:
        raise AssertionError(f"{label} disagrees")
    return dl


@contextlib.contextmanager
def lockstep_rounds():
    """Count, for the block, the lockstep reducer's calls by shard thread
    (one an engine iteration) and its barrier actions ("actions": one done
    flag MIN a round, an all-reduce under a process group)."""
    from diffqcqp_tpu_torch.parallel import sharding as tsh

    calls, lock = {}, threading.Lock()
    call, reduce = tsh._LockstepDone.__call__, tsh._LockstepDone._reduce

    def counted_call(self, local_done):
        with lock:
            name = threading.current_thread().name
            calls[name] = calls.get(name, 0) + 1
        return call(self, local_done)

    def counted_reduce(self):
        calls["actions"] = calls.get("actions", 0) + 1
        reduce(self)

    tsh._LockstepDone.__call__, tsh._LockstepDone._reduce = counted_call, counted_reduce
    try:
        yield calls
    finally:
        tsh._LockstepDone.__call__, tsh._LockstepDone._reduce = call, reduce


def in_rounds(label, rounds, k, slowest, own=None):
    """Every one of the k shard threads made exactly ``slowest`` reducer
    calls (the batch's slowest problem's iterations), and the barrier acted
    as often. With ``own``, each shard's own slowest problem, at least one
    of which stops earlier: a reducer that did not reduce would let that
    shard's thread leave after its own count."""
    shards = {f"batch-shard-{i}": rounds.get(f"batch-shard-{i}") for i in range(k)}
    log(f"    {label}: reducer calls by shard thread {shards}, barrier actions "
        f"{rounds.get('actions')}; the batch's slowest problem {slowest} iterations"
        + ("" if own is None else f", each shard's own slowest {own}"))
    if set(shards.values()) != {slowest} or rounds.get("actions") != slowest \
            or len(rounds) != k + 1:
        raise AssertionError(f"{label}: the shards did not reduce once an iteration in step")
    if own is not None and min(own) >= slowest:
        raise AssertionError(f"{label}: no shard stops early, so the rounds cannot show a MIN")


def phase_3j(dqt, kernels, flag, cfg, c10, W, l64, k1_iters, b_bucket=4000):
    """Phase 3j: the sharded (independent and lockstep, one process and a
    one-rank process group), bucketed and resumed flagship paths, the trace,
    and the build cache in two processes. ``flag`` are the flagship's card
    tensors, ``W`` the linear term's weights, ``l64`` the float64 referee's
    l and ``k1_iters`` K1's iterations on the flagship (phase 2). Returns
    the closures phase 4g times."""
    import os
    import tempfile

    import torch.distributed as dist

    from diffqcqp_tpu_torch.parallel import (
        global_batch_mesh, initialize_distributed, make_batch_mesh, shard_host_local_batch,
        solve_qcqp_sharded, solve_qp_sharded,
    )
    from diffqcqp_tpu_torch.utils.bucketing import pad_to_bucket, unpad
    from diffqcqp_tpu_torch.utils.retry import solve_resumed

    names = ("P", "q", "l_n", "mu")
    B = flag[1].shape[0]
    mesh = make_batch_mesh(["cuda:0", "cuda:0"])

    def sharded(fn, **kw):
        return lambda *a, config: fn(*a, mesh=mesh, config=config, **kw)

    def counted(label, n, want):
        log(f"    {label}: launches " + ", ".join(f"{k} {v}" for k, v in n.items()))
        if n != {**dict.fromkeys(kernels, 0), **want}:
            raise AssertionError(f"{label} launched {n}, not {want}")

    # (a) two shards on the one card, independent mode, then lockstep
    log(f"  3j-a: a mesh of two shards on cuda:0, B={B} (two of {B // 2})")
    l_u, st_u, g_u, n_u = stepped(kernels, dqt.solve_qcqp_with_stats, flag, cfg, W)
    counted("unsharded flagship step", n_u, {"K1": 1, "K2": 1})
    l_s, st_s, g_s, n_s = stepped(kernels, sharded(solve_qcqp_sharded), flag, cfg, W)
    counted("sharded flagship step, independent", n_s, {"K1": 2, "K2": 2})
    l_agree("sharded vs unsharded l", l_s, l_u, 2e-5, st_s, st_u)
    grad_errors("sharded vs unsharded", g_s, g_u, names, 1e-3, 2e-3)
    qp_xs, w10 = (c10.P, c10.q), W[: c10.q.shape[0]]
    lq_u, stq_u, gq_u, _ = stepped(kernels, dqt.solve_qp_with_stats, qp_xs, c10.cfg, w10)
    lq_s, stq_s, gq_s, nq_s = stepped(kernels, sharded(solve_qp_sharded), qp_xs, c10.cfg, w10)
    counted("sharded config-10 QP step, independent", nq_s, {"K1": 2, "K4": 2})
    l_agree("sharded vs unsharded QP l", lq_s, lq_u, 2e-5, stq_s, stq_u)
    grad_errors("sharded vs unsharded QP", gq_s, gq_u, ("P", "q"), 1e-3, 2e-3)
    # lockstep runs the eager engine. Each shard's problems follow the
    # trajectories of an engine solve of that shard alone (the MIN only
    # keeps converged problems frozen for longer), so it is held bit for bit
    # to the shards' own backend='xla' solves; against one solve of the
    # whole batch only to rounding: the engine's batched eigh and products
    # round otherwise at B=4096 than at 2048, which moves the float32
    # stall-floor stop by a few iterations (phase 2's note; bar 4, phase
    # 3e's engine-against-K1 bar). The batch goes in sorted by K1's
    # iterations, so shard 0's slowest problem stops well before the
    # batch's: only a MIN keeps its thread in the barrier rounds until the
    # batch's slowest problem is done, which the round counts show.
    xcfg = cfg.replace(backend="xla")
    l_x, st_x = dqt.solve_qcqp_with_stats(*flag, config=xcfg)
    order = torch.argsort(k1_iters.to(flag[1].device), stable=True)
    flag_s, W_s = [x[order] for x in flag], W[order]
    h = B // 2
    halves = [dqt.solve_qcqp_with_stats(*(x[i * h:(i + 1) * h] for x in flag_s), config=xcfg)
              for i in range(2)]
    l_xh = torch.cat([lh for lh, _ in halves])
    st_xh = type(st_x)(*(torch.cat([sh[f] for _, sh in halves]) for f in range(len(st_x))))
    with lockstep_rounds() as rounds:
        l_lk, st_lk, g_lk, n_lk = stepped(kernels, sharded(solve_qcqp_sharded, lockstep=True),
                                          flag_s, cfg, W_s)
    counted("sharded flagship step, lockstep", n_lk, {"K2": 2})
    in_rounds("two-shard lockstep", rounds, 2, int(st_lk.iterations.max()),
              [int(sh.iterations.max()) for _, sh in halves])
    l_agree("lockstep vs each shard's own backend='xla' solve", l_lk, l_xh, 0.0, st_lk, st_xh)
    l_agree("lockstep vs the whole batch's backend='xla' solve", l_lk, l_x[order], 1e-5, st_lk,
            type(st_x)(*(f[order] for f in st_x)), it_bar=4)
    if not all(bool(torch.isfinite(g).all()) for g in g_lk):
        raise AssertionError("lockstep gradients not finite")

    # (b) a one-rank NCCL process group around the lockstep solve
    port = free_port()
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                           process_id=0)
    try:
        gmesh = global_batch_mesh()
        log(f"  3j-b: process group {dist.get_backend()} world {dist.get_world_size()} on "
            f"port {port}, mesh {[str(d) for d in gmesh.devices]}")
        local = [shard_host_local_batch(x, gmesh) for x in flag]
        with lockstep_rounds() as rounds:
            l_g, st_g = solve_qcqp_sharded(*local, mesh=gmesh, config=cfg, lockstep=True)
            torch.cuda.synchronize()
        in_rounds("one-rank group lockstep", rounds, 1, int(st_g.iterations.max()))
        # one shard of the whole batch: the unsharded engine solve's bits
        l_agree("one-rank group lockstep vs the whole batch's backend='xla' solve", l_g, l_x,
                0.0, st_g, st_x)
        l_agree("one-rank group lockstep vs 3j-a's two-shard lockstep", l_g[order], l_lk, 1e-5,
                type(st_g)(*(f[order] for f in st_g)), st_lk, it_bar=4)
    finally:
        dist.destroy_process_group()

    # (c) the flagship generator at b_bucket, padded to a bucket
    xs_b = cuda(*build_problems(b_bucket, NC_FLAG))
    padded, info = pad_to_bucket(xs_b, buckets=(512, 1024, 2048, 4096))
    log(f"  3j-c: B={b_bucket} padded to a bucket of {info.padded}")
    w_b = W[:b_bucket]
    w_pad = torch.cat([w_b, w_b.new_zeros(info.padded - b_bucket, w_b.shape[1])])
    l_b, st_b, g_b, _ = stepped(kernels, dqt.solve_qcqp_with_stats, xs_b, cfg, w_b)
    l_p, st_p, g_p, n_p = stepped(kernels, dqt.solve_qcqp_with_stats, padded, cfg, w_pad)
    counted("bucketed step", n_p, {"K1": 1, "K2": 1})
    pad_it, pad_l = st_p.iterations[b_bucket:], l_p[b_bucket:]
    log(f"    padded problems: iterations max {int(pad_it.max())}, max|l| "
        f"{float(pad_l.abs().max()):.3e}, converged {bool(st_p.converged[b_bucket:].all())}")
    if int(pad_it.max()) != 1 or bool((pad_l != 0).any()):
        raise AssertionError("the padded problems did not converge in one iteration to 0")
    st_pu = type(st_p)(*(unpad(x, info) for x in st_p))
    l_agree("bucketed vs unpadded l", unpad(l_p, info), l_b, 2e-5, st_pu, st_b)
    grad_errors("bucketed vs unpadded", [unpad(g, info) for g in g_p], g_b, names, 1e-3, 2e-3)

    # (d) resumed from max_iter=8: 3 rounds, growth 4
    rcfg = cfg.replace(max_iter=8)

    def resumed(rounds=3):
        return solve_resumed(dqt.solve_qcqp_with_stats, *flag, config=rcfg, rounds=rounds,
                             growth=4)

    (l_r1, st_r1), (l_r2, st_r2) = (resumed(r) for r in (1, 2))
    for k_ in kernels.values():
        k_.launches = 0
    l_r, st_r = resumed()
    torch.cuda.synchronize()
    counted("resumed solve, 3 rounds", {k: k_.launches for k, k_ in kernels.items()},
            {"K1": 3})
    frozen = [bool((l_r[st.converged] == l_prev[st.converged]).all())
              and bool((st_r.iterations[st.converged] == st.iterations[st.converged]).all())
              for l_prev, st in ((l_r1, st_r1), (l_r2, st_r2))]
    err_r = float((l_r.double() - l64).abs().max())
    log(f"    converged after round 1: {int(st_r1.converged.sum())}, after round 2: "
        f"{int(st_r2.converged.sum())}, after round 3: {int(st_r.converged.sum())}/{B}; "
        f"those of rounds 1 and 2 unchanged bit for bit: {frozen}; iterations summed mean "
        f"{float(st_r.iterations.float().mean()):.3f} max {int(st_r.iterations.max())}; "
        f"max|l - l_f64 referee|={err_r:.3e} (bar 1e-4)")
    if not (bool(st_r.converged.all()) and all(frozen) and err_r <= 1e-4):
        raise AssertionError("the resumed solve failed its checks")

    # (e) the trace, 64 iterations, L by power iteration as K1 estimates it
    tcfg = cfg.replace(lmax_method="power")
    for k_ in kernels.values():
        k_.launches = 0
    tr = dqt.debug.trace_qcqp(*flag, iters=64, config=tcfg)
    torch.cuda.synchronize()
    counted("trace_qcqp", {k: k_.launches for k, k_ in kernels.items()}, {})
    l_t, st_t = dqt.solve_qcqp_with_stats(*flag, config=tcfg.replace(max_iter=64, backend="xla"))
    act = tr.active
    back_on = bool((act[1:] & ~act[:-1]).any())
    d_k1 = int((tr.iterations - k1_iters).abs().max())
    same = torch.equal(tr.l2, l_t) and torch.equal(tr.iterations, st_t.iterations)
    log(f"  3j-e: trace_qcqp at the flagship, 64 iterations: histories "
        f"{tuple(tr.res_dual.shape)}, converged {int(tr.converged.sum())}/{B}; l2 and "
        f"iterations equal the backend='xla' solve capped at 64: {same}; active on again "
        f"after off: {back_on}; max|d iterations| against K1: {d_k1} (bar 1)")
    shapes = all(tuple(x.shape) == (64, B) for x in (tr.res_prim, tr.res_dual, tr.rho, act))
    if not (same and shapes and not back_on and d_k1 <= 1):
        raise AssertionError("the trace failed its checks")

    # (f) the build cache in two fresh processes
    tmp = tempfile.mkdtemp(prefix="dqt_build_cache_")
    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys\n"
            "import diffqcqp_tpu_torch as dqt\n"
            "from diffqcqp_tpu_torch.kernels import _build\n"
            "path = dqt.enable_compilation_cache(sys.argv[1])\n"
            "secs = _build.build(['qr_solve'])\n"
            "_build.load('qr_solve')\n"
            "print(json.dumps({'path': path, 'built': secs, 'dir': sorted(__import__('os')"
            ".listdir(path))}))\n")
    try:
        runs = []
        for _ in range(2):
            r = subprocess.run([sys.executable, "-c", code, tmp], cwd=root, capture_output=True,
                               text=True, timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"the build-cache process failed:\n{r.stdout}{r.stderr}")
            runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
        log(f"  3j-f: enable_compilation_cache({tmp}) in two processes: first "
            f"{runs[0]['built']} s of nvcc, second {runs[1]['built']} s; files {runs[1]['dir']}")
        if not (runs[0]["built"]["qr_solve"] > 0 and runs[1]["built"]["qr_solve"] == 0.0
                and runs[0]["path"] == tmp):
            raise AssertionError("the second process did not load the first one's build")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    leaves = [x.clone().requires_grad_() for x in flag]
    leaves_p = [x.clone().requires_grad_() for x in padded]

    def step_with(solve, xs, w):
        def run():
            lx, _ = solve(*xs, config=cfg)
            return torch.autograd.grad((lx * lx).sum() + (w * lx).sum(), xs)
        return run

    return {
        "sharded": step_with(sharded(solve_qcqp_sharded), leaves, W),
        "unsharded": step_with(dqt.solve_qcqp_with_stats, leaves, W),
        "lockstep": lambda: solve_qcqp_sharded(*flag, mesh=mesh, config=cfg, lockstep=True),
        "bucketed": step_with(dqt.solve_qcqp_with_stats, leaves_p, w_pad),
        "resumed": resumed,
        "trace": lambda: dqt.debug.trace_qcqp(*flag, iters=64, config=tcfg),
    }


def phase_4g(smi, paths, B=B_FLAG):
    """Phase 4g: phase 3j's paths through ``timed_step``."""
    ms_u, idle_u = timed_step(f"unsharded flagship step B={B} (K1 + K2)", paths["unsharded"],
                              smi, calls=20, problems=B)
    ms_s, idle_s = timed_step(f"sharded flagship step, two shards on one card, independent "
                              f"(K1 x2 + K2 x2)", paths["sharded"], smi, calls=20, problems=B)
    log(f"    sharded / unsharded: {ms_s / ms_u:.3f}x wall time")
    timed_step("lockstep flagship forward, two shards (the eager engine, a barrier an "
               "iteration)", paths["lockstep"], smi, reps=3, calls=1, problems=B)
    timed_step("bucketed step, 4000 padded to 4096 (K1 + K2)", paths["bucketed"], smi,
               calls=20, problems=4000)
    timed_step("resumed solve from max_iter=8, 3 rounds (K1 x3)", paths["resumed"], smi,
               calls=5, problems=B)
    ms_t, _ = timed_step("trace_qcqp, 64 iterations (the eager engine)", paths["trace"], smi,
                         reps=3, calls=1)
    log(f"    = {ms_t / 64:.4f} ms per traced iteration")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import diffqcqp_tpu_torch as dqt
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.kernels import _build
    from diffqcqp_tpu_torch.kernels.admm_cuda import (
        PROX_BOX, PROX_DISK, PROX_NONNEG, PROX_SIGNED_BOX,
        admm_solve_cuda, admm_solve_plain,
    )
    from diffqcqp_tpu_torch.kernels.coord_bwd_cuda import coord_kkt_bwd_fused_cuda
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import (
        qcqp_kkt_bwd_cuda, qcqp_kkt_bwd_fused_cuda, qcqp_kkt_bwd_fused_plain,
    )
    from diffqcqp_tpu_torch.kernels.qr_solve_cuda import qr_solve_cuda
    from diffqcqp_tpu_torch.torch_autograd import QCQPFn2
    from diffqcqp_tpu_torch.utils.shapes import canon_problem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0)

    # ---- phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: card {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sources = list(_build.SOURCES)
    t0 = time.perf_counter()
    _build.build(sources)
    t_build = time.perf_counter() - t0
    log(f"phase 1: built {sources} in {t_build:.1f} s")
    for name in sources:
        log(f"  ptxas ({name}): "
            + ptxas_summary(_build.library_path(name).with_suffix(".log").read_text()))

    # each launch plan as the built library computes it, against the wrappers'
    from diffqcqp_tpu_torch.kernels import qcqp_bwd_cuda as k26, qr_solve_cuda as k5m
    plans = [(f"K2/K6 n={n}", k26.launch_plan(n), k26.c_launch_plan(n)) for n in (24, 34, 96, 142)]
    plans += [(f"K5 m={m}", k5m.launch_plan(m), k5m.c_launch_plan(m)) for m in (5, 33, 36, 72, 88)]
    for label, py, c in plans:
        log(f"  launch plan {label}: (threads, smem bytes, bound, tile) wrapper {py} library {c}")
    from diffqcqp_tpu_torch.kernels import admm_cuda as k1m
    from diffqcqp_tpu_torch.kernels import coord_bwd_cuda as k4m
    occ96 = {name: k26.c_blocks_per_sm(96, schur) for name, schur in (("K2", False), ("K6", True))}
    occ96["K1"] = k1m.c_blocks_per_sm(96)
    log(f"  blocks per SM at N=96 (occupancy calculator): {occ96}")
    if any(py != c for _, py, c in plans) or min(occ96.values()) < 3:
        raise AssertionError("a launch plan disagrees with the library, or N=96 fits fewer "
                             "than three blocks on an SM")
    # the main path's launches at N=24: blocks per SM and the waves each takes,
    # ceil(B / (blocks per SM x SMs)); K2, K6 and K4 must take one (checked
    # after phase 4, so that a tree which fails it still prints its times)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ24 = {"K1": (k1m.c_blocks_per_sm(24), B_FLAG), "K2": (k26.c_blocks_per_sm(24, False), B_FLAG),
             "K6": (k26.c_blocks_per_sm(24, True), B_FLAG),
             "K4 qp": (k4m.c_blocks_per_sm(24, k4m.KIND_QP), 4096),
             "K4 box": (k4m.c_blocks_per_sm(24, k4m.KIND_BOX), 2048),
             "K4 signed box": (k4m.c_blocks_per_sm(24, k4m.KIND_SIGNED_BOX), 2048)}
    waves24 = {name: -(-b_ // max(blk * sms, 1)) for name, (blk, b_) in occ24.items()}
    log(f"  blocks per SM at N=24 (occupancy calculator), {sms} SMs: "
        + ", ".join(f"{name} {blk} (B={b_}: {waves24[name]} wave(s))"
                    for name, (blk, b_) in occ24.items()))

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
    factors_flag = torch.zeros(B_FLAG, dtype=torch.int64, device=q.device)
    out_p = admm_solve_plain(*args, factors=factors_flag)
    err_flag = compare("flagship B=4096 N=24 disk", out_k, out_p)
    counts("flagship B=4096 N=24", out_p[1].iterations, factors_flag)

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
    compare("disk B=512 N=96 (3 warps)", admm_solve_cuda(*a),
            admm_solve_plain(*a))
    l96 = admm_solve_cuda(*a)[0]
    P17, q17, ln17, mu17 = cuda(*build_problems(512, 17, seed=15))
    a = (P17, q17, torch.zeros_like(q17), PROX_DISK, ((ln17 * mu17).contiguous(),),
         cfg, True, False)
    compare("disk B=512 N=34 (2 warps)", admm_solve_cuda(*a),
            admm_solve_plain(*a))

    # ---- phase 2b: K2 against its plain version on the card
    log("phase 2b: K2 against qcqp_kkt_bwd_fused_plain on the card")
    f32_ulps = 8.0 * torch.finfo(torch.float32).eps
    rand_g = lambda l: cuda(np.random.default_rng(3).standard_normal(  # noqa: E731
        tuple(l.shape)).astype(np.float32))[0]
    P2, q2, ln2, mu2 = build_problems(256, 6, seed=4)
    rng = np.random.default_rng(4)
    ln2 = np.where(rng.random(ln2.shape) < 0.3, 50.0 * ln2, ln2)   # strictly inside: inactive
    ln2 = np.where(rng.random(ln2.shape) < 0.3, 0.0, ln2).astype(np.float32)
    P2, q2, ln2, mu2 = cuda(P2, q2, ln2, mu2)
    rad2 = (ln2 * mu2).contiguous()
    l2 = admm_solve_cuda(P2, q2, torch.zeros_like(q2), PROX_DISK, (rad2,), cfg, True, False)[0]
    # the block-wide path's edges: just past one warp, and the largest n
    # the kernels took before they ran block-wide (``kkt_problems``)
    edge = {label: cuda(*kkt_problems(256, nc_e, seed))
            for label, nc_e, seed in (("N=32", 16, 12), ("N=34", 17, 13), ("N=142", 71, 14))}
    errs_k2 = []     # the first is the flagship with the main path's g = 2 l
    for name, (Pc, qc, lc, rc) in [
        ("flagship B=4096 N=24", (P, q, out_k[0], radius)),
        (f"B=256 N=12, {int((rad2 == 0).sum())} zero radii", (P2, q2, l2, rad2)),
        ("B=512 N=96 (block-wide)", (Pb, qb, l96, (lnb * mub).contiguous())),
        ("B=256 N=32 (one warp, the n <= 32 instance)", edge["N=32"]),
        ("B=256 N=34 (block-wide, just past one warp)", edge["N=34"]),
        ("B=256 N=142 (block-wide, large tiles)", edge["N=142"]),
    ]:
        for gname, g in (("g=2l", 2.0 * lc), ("random g", rand_g(lc))):
            a2 = (Pc, qc, lc, g.contiguous(), rc, cfg.eps, cfg.act_eps, f32_ulps)
            a64 = tuple(x.double() for x in a2[:5]) + a2[5:]
            errs_k2.append(compare_k2(f"{name} {gname}", qcqp_kkt_bwd_fused_cuda(*a2),
                                      qcqp_kkt_bwd_fused_plain(*a2),
                                      qcqp_kkt_bwd_fused_plain(*a64)))
    torch.cuda.synchronize()

    # ---- phase 2c: K4 against its plain version on the card
    log("phase 2c: K4 against coord_kkt_bwd_fused_plain on the card")
    qp_cfg10 = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0,
                                       rho_update_period=24, power_iters=10)
    box_cfg9 = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=2000)
    _, P10, q10 = spd_problems(4096, 24, seed=10)
    rng9, P9, q9 = spd_problems(2048, 24, seed=9)
    lo9, hi9, v9 = cuda(*box_bounds(rng9, *q9.shape))
    P10, q10, P9, q9 = cuda(P10, q10, P9, q9)
    families = {                # the three classes at their benchmark points
        "qp": qp_class("qp", P10, q10, qp_cfg10),
        "box_qp": qp_class("box_qp", P9, q9, box_cfg9, lo9, hi9),
        "signed_box_qp": qp_class("signed_box_qp", P9, q9, box_cfg9, lo9, hi9, v9),
    }
    # tight boxes at B=256, N=12: spread 0.05, l_min = l_max on 30 % of the
    # coordinates (pinned where the sign constraint allows), v 20 % zeros
    rng, Pt, qt = spd_problems(256, 12, seed=12)
    lot = -(rng.random(qt.shape) * 0.05 + 0.02)
    hit = rng.random(qt.shape) * 0.05 + 0.02
    vt = np.where(rng.random(qt.shape) < 0.2, 0.0, rng.standard_normal(qt.shape))
    pin = rng.random(qt.shape) < 0.3
    at = np.where(vt < 0, hit, lot)
    lot, hit = np.where(pin, at, lot), np.where(pin, at, hit)
    Pt, qt, lot, hit, vt = cuda(*(x.astype(np.float32) for x in (Pt, qt, lot, hit, vt)))
    rng, P32, q32 = spd_problems(256, 32, seed=16)   # K4's one-warp n <= 32 instance
    lo32, hi32, v32 = cuda(*box_bounds(rng, *q32.shape))
    P32, q32 = cuda(P32, q32)
    rng, P96, q96 = spd_problems(512, 96, seed=11)
    lo96, hi96, v96 = cuda(*box_bounds(rng, *q96.shape))
    P96, q96 = cuda(P96, q96)
    fam96 = {                   # past one warp: K4's block-wide path, timed in phase 4
        "qp B=512 N=96 (3 warps)": qp_class("qp", P96, q96, qp_cfg10),
        "box B=512 N=96": qp_class("box_qp", P96, q96, box_cfg9, lo96, hi96),
        "signed box B=512 N=96": qp_class("signed_box_qp", P96, q96, box_cfg9, lo96, hi96, v96),
    }
    err_k4 = phase_2c([
        ("qp B=4096 N=24 (config 10)", families["qp"]),
        ("box B=2048 N=24 (config 9)", families["box_qp"]),
        ("signed box B=2048 N=24 (config 9)", families["signed_box_qp"]),
        ("box B=256 N=12 tight", qp_class("box_qp", Pt, qt, box_cfg9, lot, hit)),
        ("signed box B=256 N=12 tight, v 20 % zeros",
         qp_class("signed_box_qp", Pt, qt, box_cfg9, lot, hit, vt)),
        ("qp B=256 N=32", qp_class("qp", P32, q32, qp_cfg10)),
        ("box B=256 N=32", qp_class("box_qp", P32, q32, box_cfg9, lo32, hi32)),
        ("signed box B=256 N=32", qp_class("signed_box_qp", P32, q32, box_cfg9, lo32, hi32, v32)),
        *fam96.items(),
    ], rand_g)
    torch.cuda.synchronize()

    # ---- phase 2d: K5 against its plain version on the card, at the two K5
    # points of the generic route (the QCQP flagship's and config 9's box
    # adjoint), the QP's SPD K at config 10 and m = 87 at the route's bound
    log("phase 2d: K5 against qr_solve_plain on the card")
    lk = out_k[0]
    c9, c10 = families["box_qp"], families["qp"]
    l9, l10 = (admm_solve_cuda(c.P, c.q, torch.zeros_like(c.q), c.prox, c.prox_args, c.cfg)[0]
               for c in (c9, c10))
    P29, q29, ln29, mu29 = cuda(*build_problems(1024, 29, seed=5))
    r29 = (ln29 * mu29).contiguous()
    l29 = admm_solve_cuda(P29, q29, torch.zeros_like(q29), PROX_DISK, (r29,), cfg, True, False)[0]
    P11, q11, ln11, mu11 = cuda(*build_problems(1024, 11, seed=7))
    r11 = (ln11 * mu11).contiguous()
    l11 = admm_solve_cuda(P11, q11, torch.zeros_like(q11), PROX_DISK, (r11,), cfg, True, False)[0]
    rng = np.random.default_rng(8)
    A5, b5 = cuda((rng.standard_normal((1024, 5, 5)) + 3.0 * np.eye(5)).astype(np.float32),
                  rng.standard_normal((1024, 5)).astype(np.float32))
    k5_points = [(label, A.contiguous(), b.contiguous()) for label, A, b, *_ in (
        ("QCQP flagship B=4096 N=24", *qcqp_system(P, q, radius, lk, 2.0 * lk, cfg)),
        ("box B=2048 N=24 (config 9)", *box_system(c9, l9, 2.0 * l9)),
        ("QP B=4096 N=24 (config 10), SPD K", *kkt._qp_kkt_system(c10.P, c10.q, l10, 2.0 * l10,
                                                                 c10.cfg)),
        ("QCQP B=1024 N=58, at the route's bound", *qcqp_system(P29, q29, r29, l29, 2.0 * l29, cfg)),
        ("QCQP B=1024 N=22 (m = 33, two lanes a column)",
         *qcqp_system(P11, q11, r11, l11, 2.0 * l11, cfg)),
        ("random B=1024 m = 5 (one warp)", A5, b5),
    )]
    err_k5 = phase_2d(k5_points)
    torch.cuda.synchronize()

    # ---- phase 2e: K6 against its plain version on the card, at the JAX
    # package's large-N size (B=2048, N=96) and at the flagship
    log("phase 2e: K6 against qcqp_kkt_bwd_plain on the card")
    P48, q48, ln48, mu48 = cuda(*build_problems(2048, 48, seed=6))
    r48 = (ln48 * mu48).contiguous()
    l48, st48 = dqt.solve_qcqp_with_stats(P48, q48, ln48, mu48, config=cfg)
    log(f"  B=2048 N=96 problems solved by solve_qcqp_with_stats: converged_frac="
        f"{float(st48.converged.float().mean())} mean_iters {float(st48.iterations.float().mean()):.2f}")
    err_k6 = phase_2e([("B=2048 N=96", (P48, q48, l48, r48)),
                       ("flagship B=4096 N=24", (P, q, lk, radius)),
                       ("B=256 N=32", edge["N=32"]), ("B=256 N=34", edge["N=34"]),
                       ("B=256 N=142", edge["N=142"])],
                      rand_g, cfg)
    k6_against_k2(P, q, lk, radius, (2.0 * lk).contiguous(), cfg, f32_ulps)
    torch.cuda.synchronize()

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
    P64, q64, ln64, mu64 = (x.double() for x in (P, q, l_n, mu))
    r64 = ln64 * mu64
    l64, st64 = admm_solve_plain(P64, q64, ws.double(), PROX_DISK, (r64,), ref_cfg, True, False)
    err_ref = float((l.double() - l64).abs().max())
    # the entry point hands K1 the arguments of a direct launch on the
    # canonical (symmetrised) problem, so the two give the same bits
    P_c = canon_problem(P, q).P.contiguous()
    l_dir, st_dir = admm_solve_cuda(P_c, q, ws, PROX_DISK, (radius,), cfg, True, False)
    bitwise = torch.equal(l, l_dir) and torch.equal(st.iterations, st_dir.iterations)
    log(f"  entry point's l and iterations equal a direct K1 launch bit for bit: {bitwise}")
    log(f"  K1 launches={launches} converged_frac={conv_frac} "
        f"mean_iters={mean_iters:.4f} (JAX package r04 anchor {ITER_ANCHOR}) "
        f"max_iters={int(st.iterations.max())} "
        f"max feasibility excess={viol:.3e} max|l - l_f64 referee|={err_ref:.3e} "
        f"(referee converged_frac={float(st64.converged.float().mean())}, "
        f"mean_iters={float(st64.iterations.float().mean()):.2f})")
    if launches < 1:
        raise AssertionError("the main path did not launch K1")
    if conv_frac != 1.0 or viol > 0 or not (err_ref <= 1e-4) or not bitwise:
        raise AssertionError("slice check failed")
    if not bool(st64.converged.all()):
        raise AssertionError("float64 referee did not converge")

    # ---- phase 3b: the forward+backward step through the public entry point
    log("phase 3b: forward+backward step, solve_qcqp + autograd at B=4096 N=24")
    W = rand_g(q)
    leaves = [x.clone().requires_grad_() for x in (P, q, l_n, mu)]

    def step(linear=False, config=cfg, xs=leaves, solve=dqt.solve_qcqp):
        lx = solve(*xs, config=config)
        v = (lx * lx).sum() + ((W.reshape(lx.shape) * lx).sum() if linear else 0.0)
        return lx, torch.autograd.grad(v, xs)

    kernels = {"K1": admm_solve_cuda, "K2": qcqp_kkt_bwd_fused_cuda,
               "K4": coord_kkt_bwd_fused_cuda, "K5": qr_solve_cuda, "K6": qcqp_kkt_bwd_cuda}
    for k_ in kernels.values():
        k_.launches = 0
    l_sq, g_sq = step()
    torch.cuda.synchronize()
    n_3b = {name_: k_.launches for name_, k_ in kernels.items()}
    launches_k1, launches_k2 = n_3b["K1"], n_3b["K2"]
    _, g_lin = step(linear=True)
    finite = all(bool(torch.isfinite(x).all()) for x in g_sq + g_lin)
    log("  launches in the step: " + ", ".join(f"{k} {v}" for k, v in n_3b.items())
        + f"; gradients finite: {finite}")
    if launches_k1 < 1 or launches_k2 < 1 or n_3b["K4"] or n_3b["K5"] or n_3b["K6"] or not finite:
        raise AssertionError("the forward+backward step did not run through K1 and K2 alone")

    # float64 referee: the plain K1 at eps=1e-10 (l64 above, solved with the
    # float64 radius, as its strict mask at float64's floor needs), then the
    # assembled KKT system solved by torch.linalg.solve

    def referee(g64):
        return qcqp_referee(P64, q64, ln64, mu64, l64, g64, cfg)

    # sum(l^2) is flat in P and q where every contact binds (|l_c| = r_c):
    # those two gradients are zero up to rounding, so their error is taken
    # against the cotangent's scale (|g| for q, |g| |l| for P) instead
    gn = (2.0 * l64).norm(dim=1)
    floors = {"sum(l^2)": (gn * l64.norm(dim=1), gn, None, None),
              "sum(l^2) + <w, l>": (None,) * 4}
    worst = worst_max = 0.0
    for loss, got, ref in (("sum(l^2)", g_sq, referee(2.0 * l64)),
                           ("sum(l^2) + <w, l>", g_lin, referee(2.0 * l64 + W.double()))):
        for gname, a, b, fl in zip(("P", "q", "l_n", "mu"), got, ref, floors[loss]):
            e = rel_err(a, b, fl)
            med, mx = float(e.median()), float(e.max())
            worst, worst_max = max(worst, med), max(worst_max, mx)
            log(f"  {loss} grad {gname}: per-problem relative error vs f64 referee "
                f"median {med:.3e} max {mx:.3e} (|ref|_max {float(b.abs().max()):.3e})")
    if not (worst <= 1e-3 and worst_max <= 2e-3):
        raise AssertionError("gradients disagree with the float64 referee")

    # central differences in float64 on 4 problems, the plain K1 at eps=1e-12
    fd_cfg = cfg.replace(eps=1e-12, max_iter=20000)
    base = [x[:4].double() for x in (P, q, l_n, mu)]
    W4, h = W[:4].double(), 1e-5
    jobs = []
    for pi in (1, 2, 3):
        an = g_lin[pi][:4].double()
        for flat in torch.topk(an.abs().flatten(), 5).indices.tolist():
            b_, c_ = divmod(flat, an.shape[1])
            jobs += [(pi, b_, c_, s_, float(an[b_, c_])) for s_ in (h, -h)]
    xs = [torch.stack([x[j[1]] for j in jobs]).clone() for x in base]
    for k_, (pi, _, c_, s_, _) in enumerate(jobs):
        xs[pi][k_, c_] += s_
    lf, stf = admm_solve_plain(xs[0], xs[1], torch.zeros_like(xs[1]), PROX_DISK,
                               ((xs[2] * xs[3]).contiguous(),), fd_cfg, True, False)
    Wj = torch.stack([W4[j[1]] for j in jobs])
    f = ((lf * lf).sum(1) + (Wj * lf).sum(1)).tolist()
    fd_rel = {1: [], 2: [], 3: []}
    for k_ in range(0, len(jobs), 2):
        pi, fd = jobs[k_][0], (f[k_] - f[k_ + 1]) / (2 * h)
        fd_rel[pi].append(abs(fd - jobs[k_][4]) / max(abs(fd), 1e-30))
    fd_med = {n_: float(np.median(fd_rel[pi])) for n_, pi in (("q", 1), ("l_n", 2), ("mu", 3))}
    log(f"  central differences (f64, h={h}, 4 problems, 5 largest coordinates each; "
        f"FD solves converged: {bool(stf.converged.all())}): median relative error "
        + ", ".join(f"{k}: {v:.3e}" for k, v in fd_med.items()))
    if not (bool(stf.converged.all()) and max(fd_med.values()) < 1e-3):
        raise AssertionError("central differences disagree with the gradients")

    # QCQPFn2 in the reference's (B, N, 1) layout against the entry point
    dcfg = dqt.QCQP_DEFAULTS.replace(eps=cfg.eps, max_iter=cfg.max_iter)
    col = [x.clone().requires_grad_() for x in (P, q[..., None], l_n[..., None], mu[..., None])]
    fn2 = lambda *a, config: QCQPFn2.apply(*a, torch.zeros_like(a[1]), config.eps,  # noqa: E731
                                           config.max_iter)
    _, g_fn2 = step(True, dcfg, col, fn2)
    _, g_api = step(True, dcfg, [x.clone().requires_grad_() for x in (P, q, l_n, mu)])
    e_fn2 = max(float((a.reshape(b.shape) - b).abs().max()) for a, b in zip(g_fn2, g_api))
    log(f"  QCQPFn2 (B, N, 1) vs solve_qcqp gradients: max|d| = {e_fn2:.3e}")
    if not e_fn2 <= 1e-6:
        raise AssertionError("QCQPFn2 disagrees with the entry point")

    # ---- phase 3c: the QP family's forward+backward steps through their
    # entry points (config 10 for the QP, config 9 for the box classes)
    log("phase 3c: forward+backward steps, solve_qp / solve_box_qp / solve_signed_box_qp "
        "+ autograd")
    steps = {}
    for name_, c in families.items():
        n_k1, n_k4, step_c = phase_3c(dqt, c, rand_g(c.q))
        steps[name_] = (n_k4, step_c)

    # ---- phase 3d: the generic adjoint route, duals given, with problems and
    # l from the entry points (K1): K5 at N=24, K6 at N=96
    log("phase 3d: the generic adjoint route, kkt.qcqp_vjp / kkt.box_vjp with duals given")
    l9e = dqt.solve_box_qp(c9.P, c9.q, *c9.params, config=c9.cfg)
    # the cotangent of sum(l^2) + <w, l>: where every contact binds, sum(l^2)
    # alone is flat in P and q and its dl is rounding noise (phase 3b)
    g_fl, g9, g48 = ((2.0 * x + rand_g(x)).contiguous() for x in (l, l9e, l48))
    sys_fl = lambda dt: qcqp_system(P, q, radius, l, g_fl, cfg, dt)  # noqa: E731
    sys_9 = lambda dt: box_system(c9, l9e, g9, dt)  # noqa: E731
    launches_3d = phase_3d([
        ("qcqp_vjp(duals=qcqp_dual(...)), flagship B=4096 N=24",
         lambda: kkt.qcqp_vjp(P, q, radius, l, g_fl, cfg,
                              duals=kkt.qcqp_dual(P, q, radius, l, cfg)),
         lambda: qr_plain_route(sys_fl), sys_fl, {"K5": 1}),
        ("box_vjp(duals=box_dual(...)), config 9 B=2048 N=24",
         lambda: kkt.box_vjp(c9.P, c9.q, *c9.params, l9e, g9, c9.cfg,
                             duals=kkt.box_dual(c9.P, c9.q, *c9.params, l9e, c9.cfg)),
         lambda: qr_plain_route(sys_9), sys_9, {"K5": 1}),
        ("qcqp_vjp(duals=qcqp_dual(...)), B=2048 N=96",
         lambda: kkt.qcqp_vjp(P48, q48, r48, l48, g48, cfg,
                              duals=kkt.qcqp_dual(P48, q48, r48, l48, cfg)),
         lambda: schur_plain_route(P48, q48, r48, l48, g48, cfg),
         lambda dt: qcqp_system(P48, q48, r48, l48, g48, cfg, dt), {"K6": 1}),
    ], kernels)
    phase_3d_f64(tuple(x.double() for x in (P48, q48, r48, l48, g48)), cfg, kernels)

    # ---- phase 3e: the dispatch past the kernels' bounds and in float64
    log("phase 3e: the routes past the kernels' bounds, float64 and backend='xla'")
    ms_engine = phase_3e(dqt, cfg, qp_cfg10, kernels, rand_g, (P, q, l_n, mu), out_k, l64)

    # ---- phase 3f: diagonal P through the four entry points, no kernel
    log("phase 3f: diagonal P, solve_* + autograd (B=4096 QP and QCQP, B=2048 box kinds, N=24)")
    diag_steps = phase_3f(dqt, kernels, diag_cases(cfg, qp_cfg10, box_cfg9), rand_g)

    # ---- phase 3g: the twin of tpu_smoke.py, float32 K1 solutions certified
    # in float64 on the card by the port's KKT oracle
    log("phase 3g: verify.check_* in float64 on the card of the float32 K1 solutions")
    phase_3g(dqt, kernels, {
        "qcqp": ((P, q, l_n, mu), (), cfg, (("q", 1), ("l_n", 2), ("mu", 3))),
        "qp": ((c10.P, c10.q), (), c10.cfg, (("P", 0), ("q", 1))),
        "box_qp": ((c9.P, c9.q, lo9, hi9), (), c9.cfg, (("q", 1), ("l_min", 2), ("l_max", 3))),
        "signed_box_qp": ((c9.P, c9.q, lo9, hi9), (v9,), c9.cfg,
                          (("q", 1), ("l_min", 2), ("l_max", 3))),
    }, rand_g)

    # ---- phase 3h: the config-4 system-ID step (K1 x2, K4, K2)
    log("phase 3h: the config-4 system-ID step through models.system_id's problem map")
    sysid_cfgs = (
        dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0, rho_update_period=24),
        dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0, rho_update_period=24,
                                  power_iters=10),
    )
    launches_sysid, sysid_step = phase_3h(dqt, kernels, sysid_inputs(), *sysid_cfgs)

    # ---- phase 3i: the config-11 contact rollout (no kernel)
    log("phase 3i: the config-11 contact rollout, models.contact_sim.simulate")
    rollout = rollout_inputs()
    phase_3i(kernels, rollout)

    # ---- phase 3j: the sharded, bucketed and resumed flagship paths, the
    # trace and the build cache
    log("phase 3j: parallel/, utils/ and debug at the flagship")
    paths_3j = phase_3j(dqt, kernels, (P, q, l_n, mu), cfg, families["qp"], W, l64,
                        out_k[1].iterations)

    # ---- phase 4: timing at the flagship point
    args0 = args[:5] + (cfg.replace(max_iter=0),) + args[6:]
    k1 = lambda: admm_solve_cuda(*args)            # noqa: E731
    k1_setup = lambda: admm_solve_cuda(*args0)     # noqa: E731 (set-up only)
    api = lambda: dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg)  # noqa: E731
    dev_k = per_launch_ms(device_time_by_kernel(k1), "admm_kernel")
    dev_setup = per_launch_ms(device_time_by_kernel(k1_setup), "admm_kernel")
    ev_k, ts_k = time_cuda(k1, reps=5, calls=20)
    ev_k1, _ = time_cuda(k1, reps=20, calls=1)
    ev_api, _ = time_cuda(api, reps=5, calls=20)
    ms_p, ts_p = time_cuda(lambda: admm_solve_plain(*args), reps=5)
    bound, bound_by, nbytes, nflops = k1_bound_ms(
        B_FLAG, 2 * NC_FLAG, NC_FLAG, out_k[1].iterations, factors_flag, cfg.power_iters)
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

    # K2 at the flagship point with the main path's cotangent g = 2 l
    lk = out_k[0]
    k2_args = (P, q, lk, (2.0 * lk).contiguous(), radius, cfg.eps, cfg.act_eps, f32_ulps)
    k2 = lambda: qcqp_kkt_bwd_fused_cuda(*k2_args)   # noqa: E731
    dev_k2 = per_launch_ms(device_time_by_kernel(k2), "qcqp_bwd_kernel")
    ev_k2, ts_k2 = time_cuda(k2, reps=5, calls=20)
    ms_p2, ts_p2 = time_cuda(lambda: qcqp_kkt_bwd_fused_plain(*k2_args), reps=3)
    active = k2()[0] != 0
    bound2, bound2_by, nbytes2, nflops2 = k2_bound_ms(B_FLAG, 2 * NC_FLAG, NC_FLAG, active)
    # the library call: the same adjoint solve, assembled in float32 and
    # solved by torch.linalg.solve (the dual recovery not included)
    ST, rhs, _ = qcqp_system(P, q, radius, lk, k2_args[3], cfg)
    ST, rhs = ST.contiguous(), rhs[..., None].contiguous()
    ms_lib, ts_lib = time_cuda(lambda: torch.linalg.solve(ST, rhs), reps=5, calls=20)

    log(f"  K2 device time per launch (torch.profiler): {fmt(dev_k2)}\n"
        f"  K2 per call, 20 back-to-back calls (CUDA events): {ev_k2:.4f} ms "
        f"(samples {[round(t, 4) for t in ts_k2]})\n"
        f"  K2 plain version: {ms_p2:.2f} ms (samples {[round(t, 2) for t in ts_p2]})\n"
        f"  K2 bound {bound2:.5f} ms ({bound2_by}: {nbytes2} bytes, {nflops2:.4g} FLOP; "
        f"{int(active.sum())} strictly active contacts)\n"
        f"  library call torch.linalg.solve, assembled float32 (B, 36, 36): "
        f"{ms_lib:.4f} ms (samples {[round(t, 4) for t in ts_lib]})")
    # the forward+backward step, as bench.py times it, and its device time
    timed_step(f"flagship forward+backward step B={B_FLAG} N={2 * NC_FLAG}", step, smi,
               calls=20, problems=B_FLAG, top=10)
    k4_times = {name_: phase_4c(c, steps[name_][1], smi) for name_, c in families.items()}
    for label, c in fam96.items():
        _, dev96_k4, (ev96_k4, ts96_k4), (b_, b_by, *_) = time_k4(c)
        log(f"  K4 at {label} ({smi}): device time per launch (torch.profiler) {fmt(dev96_k4)}; "
            f"per call, 20 back-to-back (CUDA events) {ev96_k4:.4f} ms (samples "
            f"{[round(t, 4) for t in ts96_k4]}); bound {b_:.5f} ms ({b_by})")

    # K5 at each phase-2d point; K6 at N=96 and at the flagship beside K2
    # and the library call; the generic route's call against the K2 route
    k5_times = phase_4d(k5_points, smi)
    cases_4e = []
    for label, (Pc, qc, lc, rc) in (("B=2048 N=96", (P48, q48, l48, r48)),
                                     ("flagship B=4096 N=24", (P, q, lk, radius))):
        gc = (2.0 * lc).contiguous()
        duals = kkt.qcqp_dual(Pc, qc, rc, lc, cfg)
        s_, act_ = kkt.qcqp_strict_active(lc, rc, duals.gamma, cfg)
        ST_, rhs_, _ = qcqp_system(Pc, qc, rc, lc, gc, cfg)
        cases_4e.append((label, (Pc, lc, gc, duals.gamma, s_, act_),
                         (Pc, qc, lc, gc, rc, cfg.eps, cfg.act_eps, f32_ulps),
                         (ST_.contiguous(), rhs_.contiguous())))
    k6_times = phase_4e(cases_4e, smi)
    del cases_4e
    generic = lambda: kkt.qcqp_vjp(P, q, radius, lk, k2_args[3], cfg,  # noqa: E731
                                   duals=kkt.qcqp_dual(P, q, radius, lk, cfg))
    fused = lambda: kkt.qcqp_vjp(P, q, radius, lk, k2_args[3], cfg)  # noqa: E731
    ev_gen, ts_gen = time_cuda(generic, reps=5, calls=20)
    ev_fus, ts_fus = time_cuda(fused, reps=5, calls=20)
    rows_gen = device_time_by_kernel(generic)
    dev_gen = sum(r_[1] for r_ in rows_gen)
    dev_gen_k5 = sum(r_[1] for r_ in rows_gen if "qr_solve_kernel" in r_[0])
    log(f"  qcqp_vjp at the flagship, per call, 20 back-to-back (CUDA events): duals given "
        f"(qcqp_dual, then the assembled system through K5) {ev_gen:.4f} ms (samples "
        f"{[round(t, 4) for t in ts_gen]}); the K2 route {ev_fus:.4f} ms (samples "
        f"{[round(t, 4) for t in ts_fus]}); the generic call's device time (torch.profiler) "
        f"{dev_gen:.4f} ms, of which K5 {dev_gen_k5:.4f} ms")
    for name_, ms_, cnt in rows_gen[:8]:
        log(f"    {ms_:.4f} ms  x{cnt:g}  {name_[:110]}")

    # the public QCQP step at B=2048, N=96 (the phase-2e problems), timed as
    # the flagship step, with the launch counters around one step
    leaves96 = [x.clone().requires_grad_() for x in (P48, q48, ln48, mu48)]
    step96 = lambda: step(xs=leaves96)   # noqa: E731
    for k_ in kernels.values():
        k_.launches = 0
    step96()
    torch.cuda.synchronize()
    n_96 = {name_: k_.launches for name_, k_ in kernels.items()}
    if n_96["K1"] < 1 or n_96["K2"] < 1 or n_96["K4"] or n_96["K5"] or n_96["K6"]:
        raise AssertionError("the N=96 step did not run through K1 and K2 alone")
    timed_step("public QCQP step at B=2048 N=96, launches "
               + ", ".join(f"{k} {v}" for k, v in n_96.items()), step96, smi, calls=5,
               problems=2048, top=8)
    # K1 alone on the same problems: its time, bound and counts
    a96 = (P48, q48, torch.zeros_like(q48), PROX_DISK, (r48,), cfg, True, False)
    k1_96 = lambda: admm_solve_cuda(*a96)   # noqa: E731
    out96 = k1_96()
    B96 = q48.shape[0]
    factors96 = torch.zeros(B96, dtype=torch.int64, device=q48.device)
    t0 = time.perf_counter()
    out96p = admm_solve_plain(*a96, factors=factors96)
    torch.cuda.synchronize()
    ms_p96 = (time.perf_counter() - t0) * 1e3
    compare("K1 at B=2048 N=96 (the step's problems)", out96, out96p)
    counts("B=2048 N=96", out96p[1].iterations, factors96)
    dev_k96 = per_launch_ms(device_time_by_kernel(k1_96, calls=5), "admm_kernel")
    ev_k96, ts_k96 = time_cuda(k1_96, reps=5, calls=5)
    # K1's two halves: its set-up (power iteration and the first inverse,
    # max_iter=0), with and without the power iteration, and the iterations
    a96_0 = a96[:5] + (cfg.replace(max_iter=0),) + a96[6:]
    a96_00 = a96[:5] + (cfg.replace(max_iter=0, power_iters=0),) + a96[6:]
    setup_ms = lambda a: per_launch_ms(  # noqa: E731
        device_time_by_kernel(lambda: admm_solve_cuda(*a), calls=5), "admm_kernel")
    dev_k96_setup, dev_k96_setup0 = setup_ms(a96_0), setup_ms(a96_00)
    b96, b96_by, b96_bytes, b96_flops = k1_bound_ms(B96, 96, 48, out96[1].iterations,
                                                    factors96, cfg.power_iters)
    log(f"  K1 at B=2048 N=96 ({smi}): device time per launch (torch.profiler) {fmt(dev_k96)}; "
        f"per call, 5 back-to-back (CUDA events) {ev_k96:.4f} ms (samples "
        f"{[round(t, 4) for t in ts_k96]}); plain version {ms_p96:.1f} ms (one call); bound "
        f"{b96:.5f} ms ({b96_by}: {b96_bytes} bytes, {b96_flops:.4g} FLOP); set-up only "
        f"(max_iter=0) {fmt(dev_k96_setup)}, without the power iteration "
        f"{fmt(dev_k96_setup0)}")

    # this slice's paths: the system-ID steps, the rollout, the Jacobian and
    # the diagonal-P step
    log(f"phase 4f: the system-ID and rollout timings (launches in one config-4 step: "
        f"{launches_sysid})")
    phase_4f(dqt, smi, sysid_step, rollout, diag_steps["qcqp"], (P, q, l_n, mu), cfg)

    log(f"phase 4g: the sharded, bucketed, resumed and traced paths")
    phase_4g(smi, paths_3j)

    # the waves of phase 1: K2, K6 and K4 take one at the main path's sizes
    if any(waves24[name] > 1 for name in waves24 if name != "K1"):
        raise AssertionError(f"K2, K6 or K4 takes more than one wave at N=24: {waves24}")

    # ---- phase 5: the kernels line, then the result
    log(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "admm_solve_cuda (K1: an explicit inverse and one refined solve per "
                "iteration; numbers at the flagship, B=4096 N=24)",
        "route": "cuda",
        "source": "diffqcqp_tpu_torch/kernels/csrc/admm.cu",
        "replaces": "diffqcqp_tpu/kernels/admm_pallas.py:78",
        "launches": launches_k1,
        "max_abs_err": err_flag,
        "ms": ev_k,
        "plain_ms": ms_p,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "qcqp_kkt_bwd_fused_cuda (K2, with the K3 LDL^T helpers inlined)",
        "route": "cuda",
        "source": "diffqcqp_tpu_torch/kernels/csrc/qcqp_bwd.cu",
        "replaces": "diffqcqp_tpu/kernels/qcqp_bwd_pallas.py:200",
        "launches": launches_k2,
        "max_abs_err": errs_k2[0],
        # the device time: back to back, the wrapper's host work outlasts K2
        "ms": dev_k2 if dev_k2 is not None else ev_k2,
        "plain_ms": ms_p2,
        "bound_ms": bound2,
        "bound_by": bound2_by,
        "library_ms": ms_lib,
    }, {
        "name": "coord_kkt_bwd_fused_cuda (K4, with the K3 LDL^T helpers inlined; "
                "numbers at the QP point, B=4096 N=24)",
        "route": "cuda",
        "source": "diffqcqp_tpu_torch/kernels/csrc/coord_bwd.cu",
        "replaces": "diffqcqp_tpu/kernels/coord_bwd_pallas.py:55",
        "launches": steps["qp"][0],
        "max_abs_err": err_k4,
        **k4_times["qp"],
    }, {
        "name": "qr_solve_cuda (K5; numbers at the QCQP flagship's assembled system, "
                "B=4096 m=36)",
        "route": "cuda",
        "source": "diffqcqp_tpu_torch/kernels/csrc/qr_solve.cu",
        "replaces": "diffqcqp_tpu/kernels/qr_solve_pallas.py:43",
        "launches": launches_3d["K5"],
        "max_abs_err": err_k5[k5_points[0][0]],
        **k5_times[k5_points[0][0]],
    }, {
        "name": "qcqp_kkt_bwd_cuda (K6, K2's steps 4-8 with the duals given; numbers at "
                "B=2048 N=96)",
        "route": "cuda",
        "source": "diffqcqp_tpu_torch/kernels/csrc/qcqp_bwd.cu",
        "replaces": "diffqcqp_tpu/kernels/qcqp_bwd_pallas.py:44",
        "launches": launches_3d["K6"],
        "max_abs_err": err_k6,
        **k6_times,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
