"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py config6    # phase 1, then config 6's phases alone (2c's
                                     # block-wide K4 cases, 3k, 4h); no result line
    python3 chip_smoke.py staged     # phase 1, then phases 3n and 4n alone, the
                                     # kernels line (launches read at the staged
                                     # steps' captures) and the result line
    python3 chip_smoke.py control    # phase 1, then phases 3o and 4o alone; no
                                     # result line
    python3 chip_smoke.py eigh       # phase 1, then phases 2p, 3p and 4p alone;
                                     # no result line
    python3 chip_smoke.py lockstep   # phase 1, then phases 3q and 4q alone and,
                                     # with two cards or more, two NCCL ranks a
                                     # card each, eager lockstep and the refusal
                                     # of its capture (``lockstep_ranks``); no
                                     # result line
    python3 chip_smoke.py eager ROOT # the port at ROOT times the engine's eager
                                     # paths (``eager_run``); no result line
    python3 chip_smoke.py k1 [ROOT]  # K1 alone from the port at ROOT (this
                                     # checkout by default): its plans, phase
                                     # 2's K1 points and its times (``k1_run``);
                                     # no result line
    python3 chip_smoke.py k2         # phase 1, then phase 2b, K6 fed K2's duals
                                     # against K2 and K2's flagship numbers
                                     # (``k2_run``); no result line
    python3 chip_smoke.py sysid      # phase 1, then the mixed SystemID staged
                                     # at config 4's size (``sysid_run``); no
                                     # result line
    python3 chip_smoke.py glue       # phase 2g (G1 and G2 against the PyTorch
                                     # formulas they replaced, bit for bit),
                                     # then both timed against the formulas
                                     # (``glue_run``); no result line

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
point and at a QCQP of the JAX package's large-N size (B=2048, N=96, 48
contacts: the port's own point, config 6's width); and config 6 itself,
the JAX package's large-N QP (B=2048, N=96, seed 6: K1, then K4's
block-wide path). Phases, each of which fails the run if its check fails:

  1. the card: name and power limit (nvidia-smi), the build of every
     ``kernels/_build.SOURCES`` library (one nvcc each, all at once); each
     kernel's launch plan (threads, shared memory, bound) as the built library
     computes it against the Python wrapper's, for K2 / K6 at n = 24, 34, 96,
     142, K5 at m = 5, 33, 36, 72, 88 and E1 at N = 2 to 240
     (``E1_PLAN_NS``: one warp against block-wide, either side of each
     shared-memory bound), and at N=96 three blocks of K6 and of K2 on an
     SM and four of K1 (the occupancy calculator); E1's plan at the main path's points
     (problems a block, threads, shared memory, layout) with problems an SM
     by the occupancy calculator (failing below the plan's own count) and
     the waves (``e1_occupancy``); ptxas's registers and
     spills per kernel; blocks per SM of K1, K2, K6 and K4 (each kind) at
     N=24 and the waves each main-path launch takes, ceil(B / (blocks per
     SM x SMs)) at B=4096 (K1, K2, K6, K4's QP) and B=2048 (K4's box kinds):
     the run fails, after phase 4 so that its times are printed, if K2, K6
     or K4 takes more than one; K4's blocks per SM (each kind) at the
     block-wide sizes N=48, 96 and 168 and the waves at B=2048;
  2. kernel K1 (``admm_solve_cuda``) against its plain PyTorch version
     (``admm_solve_plain``) on the same card inputs (``phase_2_k1``): at the
     flagship point; for all four prox kinds and the rho_sync=False,
     primal_check=False, max_iter (2 and 0) and warm_start_dual branches at
     every ``K1_BRANCH_POINTS`` (B=256 at N = 8, 12 and 16: four, two and
     two problems a warp; B=512 at N = 40, 96 and 100, one on each
     block-wide register instance, and N = 140, the two-plane kernel); at every
     one-warp edge ``K1_EDGE_NS`` (n = 1 to 33); on ragged batches (B=1027
     at N=8, B=1025 at N=16); at config 5's size (B=65,536 N=8, one launch);
     past one warp at N=96, B=512 (three warps per block) and N=34, B=512
     (two); and at each block-wide register instance's edges
     ``K1_BLOCK_EDGE_NS`` (its smallest and largest n, and the first n past
     it), B=512, the non-negative QP and the disk; K1 iterates against an
     explicit inverse at every n. Bar:
     bit for bit, every problem's l, iterations, ``converged`` and
     ``stalled`` equal (the printed line also gives max |dl| and the
     iterations); each solve's iterations and factorisations per problem
     (the first and one per rho change, counted by the plain version) at
     the flagship and at config 5's size; phase 1 prints K1's launch plans
     at n = 1-169 (wrapper against library), each one-warp and block-wide
     instance's registers, spills and problems an SM, and fails if the
     flagship's instance spills or takes two waves at B=4096, or a
     block-wide register instance spills (``k1_occupancy``);
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
     at B=512, N=96; then K4's block-wide path, the three kinds at config 6
     (B=2048, N=96, the box kinds' bounds drawn by ``box_bounds`` from the
     seed-6 rng), at B=256, N=33 (just past one warp) and at B=256, N=168
     (the largest N K4 takes). Bars, on the problems whose
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
  2p. kernel E1 (``eigh_cuda``, the spectral mode's batched Jacobi
     eigendecomposition) against its plain version (``jacobi_eigh_plain``)
     on the same card inputs (``eigh_points``): the flagship's P (B=4096
     N=24) in float32 and as the float64 referee takes it; B=256 at N = 2,
     7, 32, 33, 48 and 130 in both dtypes; B=32 either side of each
     shared-memory bound (float64 N = 119 / 120 and 169 / 170, float32 169 /
     170 and 239 / 240: A and V^T in shared memory, V^T in the workspace,
     both there); repeated eigenvalues and a diagonal dense P;
     a P with a NaN and an inf. For each: the sweeps a problem (max, mean),
     the problems bit for bit the plain version's, max |d| against it, and
     both outputs against ``torch.linalg.eigh`` in float64: ||V diag(lam)
     V^T - P||_F / ||P||_F, max |V^T V - I| and |lam - lam_eigh| / ||P||_2,
     each <= 50 N u (u the dtype's unit roundoff); ascending; a non-finite
     problem all NaN, the others finite;
  2g. kernels G1 (``symmetrize_cuda``, forward and adjoint) and G2
     (``grad_p_cuda``) bit for bit the PyTorch formulas they replaced, at
     B=2048 N=96 and B=4096 N=24 in float32 and float64 (``phase_2g``);
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
     (B, N, 1) layout against the entry point; K1 and K4 launched once
     each, K2, K5 and K6 not at all;
  3k. config 6 (``run_benchmarks.py`` config 6: B=2048, N=96, ``_spd``'s P
     and q ~ N(0, 1), seed 6, ``QP_DEFAULTS.replace(eps=1e-7, max_iter=400,
     rho_update_period=24)``): its step, ``solve_qp`` then the gradient of
     sum(l^2) for P and q, through phase 3c's checks (K1 and K4 once, no
     other kernel; every problem converged; the float64 referee's bars and
     central differences); l against scipy's NNLS (an exact active-set
     solve, config 6's referee in the JAX package) on 256 problems, bar
     1e-4; the share of free coordinates nf / n of the three kinds, and how
     many problems take the register factor (nf <= 32);
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
     the card at B=256, N=24 (none of K1-K6; its spectral set-up is E1,
     counted in phase 3p; float64 results within 1e-8 (l)
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
     (warm-up, median of samples),
     device times per launch from torch.profiler (K1's set-up alone,
     max_iter=0) and the step's device time by kernel, the plain versions,
     and the library call beside K2 (``torch.linalg.solve`` of the
     assembled float32 system); K1 at config 5's size (B=65,536 N=8, phase
     2's problems: profiler and events, its plain version's time in phase 2,
     its bound); then at each QP-family point K4 (CUDA events
     over 20 back-to-back calls and torch.profiler), its plain version, its
     bound, ``torch.linalg.solve`` of the assembled float32 system and the
     class's step with its device time by kernel, and K4 at phase 2c's B=512
     N=96 cases (profiler and events). K4's ``ms`` is its device
     time per launch from torch.profiler: back to back, its wrapper's host
     work outlasts the kernel, so the CUDA-event time measures the host (so
     are K2's and K1's since their one-warp redesigns); K5
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
     ``qcqp_jacobian`` at the flagship, l given, held in float64 against
     ``qcqp_vjp`` of a random cotangent (1e-7) (the rollout, the contact
     system-ID step, the diagonal-P step and ``qcqp_jacobian`` with l solved
     inside: phase 4o);
  3j. the sharded, bucketed and resumed flagship paths and the traces
     (``parallel``, ``utils``, ``debug``), each with the launch counters
     zeroed just before and read just after:
     (a) a mesh of two shards on the one card: the flagship forward+backward
     step (sum(l^2) + <w, l>) and config 10's QP step in independent mode
     (K1 2, K2 2 / K4 2), l within 2e-5 of the unsharded step's (with the
     count of problems equal bit for bit) and the gradients within phase
     3b's bars of it; then the flagship step in lockstep mode (K1 0, K2 2:
     the eager engine forward) on the batch sorted by K1's iterations, so
     that shard 0's slowest problem stops early: the joint loop steps both
     shards exactly as often as the batch's slowest problem iterates
     (``lockstep_rounds``), l and per-problem iterations equal bit
     for bit to each shard's own ``backend='xla'`` solve, and within 1e-5
     (l) and 4 iterations of one such solve of the whole batch (the engine
     rounds otherwise at another batch size);
     (b) a one-rank NCCL process group (``initialize_distributed`` on a free
     local port): the lockstep flagship solve on ``global_batch_mesh()`` and
     ``shard_host_local_batch``, one joint step and one all-reduce an
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
  3l. config 5's size on one card: examples_torch/sharded_batch.py's
     problems (B=65,536, N=8) and schedule, each of the four 16,384-problem
     slices (one card's shard of its four-card run) solved by K1, by the
     float32 eager engine (``backend='xla'``: what lockstep runs, bit for
     bit, phase 3j) and in float64 by the engine at eps=1e-10: max |l -
     l_f64| of K1 and of the engine per slice, both within 1e-4, every
     solve converged;
  3m. the solves under ``torch.func``, each with the launch counters zeroed
     just before and read just after: ``vmap(grad)`` of sum(l^2) (l the aux
     output) at the flagship over (2, 2048) groups, gradients for P, q, l_n
     and mu, launching K1 once and K2 once and nothing else, its l and
     every gradient bit for bit the flat 4096 step's; the same at config
     10's QP (P, q; K1 once, K4 once); ``vmap(jacrev(solve_qcqp))`` over the
     flagship's first 256 problems one at a time: K1 once and K2 once, over
     24 x 256 problems (a spy on the wrapper's batch), bit for bit the 24
     basis-cotangent ``torch.autograd.grad`` calls of the flat solve, and
     against ``dqt.qcqp_jacobian`` in float32 on the same l and a float64
     referee (``qcqp_jacobian`` of the float64 problems at the float64
     plain K1's l, eps=1e-10) within phase 3b's bars, per-problem relative
     error median <= 1e-3 and max <= 2e-3 on the problems whose strict
     mask each shares, every difference printed; the same for
     ``solve_qp`` at config 10's first 256 problems with K4;
  4h. config 6's timings: K4's QP kind (profiler and CUDA events), its
     plain version, its bound and ``torch.linalg.solve`` of the assembled
     (2048, 96, 96) system, the step (CUDA events, problems/s, device time
     by kernel, idle share); K1 on config 6's problems against its plain
     version (phase 2's bars), its time and its bound from its iterations
     and the plain version's inverses formed; K4's box kinds on the same P
     and q; the three kinds on config 6's generator at B=2048, N = 33, 48
     and 64;
  4g. timing of phase 3j's paths, each through ``timed_step`` (CUDA events,
     warm-up, median, device time by kernel, the card's idle share): the
     sharded independent flagship step beside the unsharded one, the
     lockstep flagship forward, the bucketed step, the resumed solve, and
     the trace (ms per iteration);
  4m. the vmapped flagship step of phase 3m beside the flat one, each
     through ``timed_step`` (CUDA events, warm-up, median, device time by
     kernel, the card's idle share), and their difference on a line of its
     own;
  3n. the steps staged as one CUDA graph each (``utils.staged``, the
     counterpart of ``jax.jit``): first, before any capture, which calls
     read the device on the host (``torch.cuda.set_sync_debug_mode("error")``):
     not the eager flagship and config-10 steps, nor the generic route through
     K5 (``qcqp_vjp(duals=)`` at the flagship) and K6 (at B=2048 N=96), nor
     ``_solve_direct``'s LU (cuSOLVER's, no check on the host); the others do
     (the eager engine, ``_solve_direct``'s Cholesky and Newton-Schulz
     inverse, ``_qcqp_schur_vjp``'s Cholesky and LU). Then, staged: the flagship step (bench.py's sum(l^2), gradients for
     P, q, l_n and mu), config 10's QP step, config 9's box and signed-box
     steps (phase 3c's loss), config 6's step, the QCQP step at B=2048 N=96
     and those two generic calls: past the warm-up calls, the capture records
     exactly the eager step's kernels (K1 1 with K2 1 or K4 1; K5 1; K6 1; no
     other; at the flagship and config 6 also G1's forward, G1's adjoint
     and G2 once each, read from their counters), a replay counts none, a profiled replay runs the same kernels
     once each, and the replay's l, stats and gradients equal the eager step's
     bit for bit on the inputs and on q + 1e-5; the flagship's graph (bucket
     4096) replayed for B=4000 and 3000 padded by ``pad_to_bucket``, bit for
     bit the eager bucketed step; the config-4
     system-ID step (forward, backward, ``Adam(capturable=True)``) staged
     against the same step run eagerly over 20 steps (K1 2, K4 1, K2 1 at
     capture, none a replay; the same kernels in a profiled replay), and
     ``SystemID(kind="qcqp").train_step`` (staged by the model on the card)
     on config 4's QCQP half against the same model stepped eagerly (K1 1,
     K2 1): losses and parameters bit for bit (whether S S^T in a replay is
     the eager product's bits is printed); a float64 QCQP ``SystemID`` (N=24:
     the spectral mode, its set-up E1) and a diagonal-P QP one on the card
     stage their steps, their losses falling past the warm-up steps;
  4n. each staged step beside its eager step, both through ``timed_step``
     (20 back-to-back calls a sample, median of 5; device time and the
     card's idle share), and a line each: eager and staged ms, device ms and
     idle share, and their ratio;
  3o. the engine's loops on the card as CUDA graph conditional nodes
     (``utils/control.py``; phase 1 first prints ``torch.version.cuda``,
     nvcc's and the driver's versions and fails without CUDA 12.4+ or the
     private PyTorch APIs it takes), each path staged (``utils.staged``):
     the config-11 rollout warm and cold (B=2048, T=50), the diagonal-P
     flagship step, the QCQP at n=170 (``kkt_problems``, B=256) and the QP
     at N=176 (B=256) past K1's bound, the float64 QCQP step at B=256 N=96
     (the Cholesky-inverse mode), the generic route's float64 LU
     (``qcqp_vjp(duals=)``) and Cholesky (the QP's SPD system) at B=4096
     N=24, ``qcqp_jacobian`` at the flagship (K1 inside) and ``trace_qcqp``
     (64 iterations, ``linsolve='chol'``): past the warm-up calls the
     capture records the kernels it must (K1 once in the Jacobian, none
     elsewhere) and the WHILE nodes it must at the graph's top level (100
     a rollout, 1 the diagonal-P and float64 steps and the trace, 3 the
     n=170 and N=176 steps), which the kept graph holds
     (``control.node_counts``); on two input sets the replay is the eager
     run bit for bit (l, stats, gradients, trajectories) with each set's
     own eager iterations, which differ (the LU paths included: the port
     takes cuSOLVER's LU eagerly too, ``ops/linalg.py::solve``); a replay under
     ``set_sync_debug_mode("error")`` reads nothing on the host. Then the
     contact system-ID step (``make_system_id_step``, staged by the
     module) against the same ``Adam(capturable=True)`` step run eagerly
     over 20 steps: losses and parameters bit for bit, 100 WHILE nodes,
     no host read (the spectral mode stages in phase 3p, the lockstep mode
     in phase 3q);
  4o. each path of phase 3o eagerly and staged through ``timed_step``
     (median of 3; device time by kernel; where the graph holds
     conditional nodes the profiler does not count their bodies' kernels
     reliably, so the staged line gives the wall time alone);
  3p. the spectral mode's routes staged, their set-up E1 (``phase_3p``):
     the float64 flagship step (B=4096 N=24), the ``backend='xla'``
     flagship step, an ``accel`` flagship forward, ``trace_qcqp`` at the
     flagship (64 iterations, the default ``linsolve``), a float64
     ``SystemID(kind="qcqp")`` at config 4's QCQP half (B=2048 N=24, 20 Adam
     steps) and ``linsolve='spectral'`` at B=256 N=130 in float64. Each
     eagerly launches E1 once a solve and calls ``torch.linalg.eigh`` never
     (a spy); staged, the capture records the eager launches and the WHILE
     nodes, a replay reads nothing on the host and is the eager run bit for
     bit on the inputs and on q + 1e-5, each with its eager iterations; each
     solution within 1e-4 of the float64 referee and of K1 on the same
     problems (iterations within 4 of K1's where both estimate L by power
     iteration: the ``backend='xla'`` step); a float64 flagship solve at
     the referee's eps beside it, all 4096 problems converged and within
     1e-8 of the referee (phase 3e's bar);
  4p. each path of phase 3p eagerly and staged (phase 4o's timing); E1
     alone at B=4096 N=24 and B=2048 N=48 in float32 and float64 and at
     B=256 N=130 in float64 (profiler and CUDA events), its plain version,
     its bound (``e1_bound_ms``) and ``torch.linalg.eigh`` of the same P,
     and what one such call launches at N=48;
  3q. the lockstep mode staged, one loop over every shard, inside a
     one-rank NCCL group (``lockstep_phases``, ``phase_3q``): on two shards
     of cuda:0, the flagship step (B=4096, seeds 0 and 1) and config 10's
     QP step (seeds 10 and 11), each eagerly on both sets: E1 2 and K2 2 /
     K4 2 (one a shard) and no other kernel, the joint loop's steps the
     slowest problem's iterations (which differ between the sets), l and
     stats bit for bit each shard's own ``backend='xla'`` solve; staged
     (``staged_loop_check``): the same launches at capture, one WHILE node,
     the replay bit for bit the eager step on both sets, no host read. The
     flagship forward alone staged alike; the flagship step over the NCCL
     group: its ``all_reduce`` recorded once, in the body, the replay bit
     for bit its eager run and the step without a group. Then a capture
     refuses, naming each reason, a mesh over cuda:0 and the CPU and a gloo
     group;
  4q. each path of phase 3q eagerly and staged through ``timed_step``
     (median of 5; the eager path's device time and idle share; the staged
     graph's wall time alone);
  5. one JSON line of every ported kernel (K4's block-wide path at config 6
     its own entry; E1, the spectral mode's eigendecomposition, which
     replaces XLA's ``eigh`` and no Pallas kernel), then as the last line
     ``{"ok": true, "device": {...}}``.

Imports torch, numpy and the port only. Exits non-zero without a result
when no CUDA device is present or the port cannot be imported.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

B_FLAG, NC_FLAG = 4096, 12
ITER_ANCHOR = 17.21       # mean iterations of the JAX package at this config (its r04 record)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12         # H100 SXM data sheet, float32 outside the tensor cores
DGAMMA_CAP = 1e-2          # phase 3d: the most dgamma's bar may grow to, of the problem's scale


_T0 = time.perf_counter()


def log(*a):
    """Print at once; a phase's heading carries the script's seconds so far."""
    if a and isinstance(a[0], str) and a[0].startswith("phase "):
        a = (f"[{time.perf_counter() - _T0:.1f} s] {a[0]}", *a[1:])
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


def rand_g(l):
    """A random cotangent of l's shape (numpy, seed 3), float32 on the card."""
    return cuda(np.random.default_rng(3).standard_normal(tuple(l.shape)).astype(np.float32))[0]


def compare(name, out_k, out_p, tol=2e-5, exact=False):
    """K1 against its plain version; fails on the bars, returns max |dl|.
    With ``exact`` the bar is bit for bit: every problem's l, iterations,
    ``converged`` and ``stalled`` equal."""
    (lk, sk), (lp, sp) = out_k, out_p
    dl = float((lk - lp).abs().max())
    dit = (sk.iterations - sp.iterations).abs()
    conv_eq = bool((sk.converged == sp.converged).all())
    stall_eq = int((sk.stalled != sp.stalled).sum())
    same = int(((lk == lp).all(dim=-1) & (sk.iterations == sp.iterations)).sum())
    if exact and not (same == dit.numel() and conv_eq and stall_eq == 0):
        log(f"  {name}: max|dl|={dl:.3e} problems bit for bit equal {same}/{dit.numel()}")
        raise AssertionError(f"K1 is not bit for bit its plain version: {name}")
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


# phase 2's one-warp edges: each instance's ends (n = 8 | 9, 16 | 17, 24 |
# 25, 32 | 33: four, two, one problem a warp, then block-wide) and n = 1, 2,
# 7, 15
K1_EDGE_NS = (1, 2, 7, 8, 9, 15, 16, 17, 24, 25, 32, 33)
# K1's block-wide register instances' edges: each one's smallest and largest
# n, and the first n past it (the next instance, or the two-plane kernel)
K1_BLOCK_EDGE_NS = (33, 64, 65, 96, 97, 128, 129)
# (B, N, seed) of phase 2's run over K1's prox kinds and branches: the
# one-warp instances at N = 8, 12 and 16 (four, two and two problems a warp),
# each register instance past one warp (N = 40, 96 and 100: kN = 64, 96 and
# 128) and the two-plane kernel (N = 140)
K1_BRANCH_POINTS = ((256, 8, 8), (256, 12, 1), (256, 16, 16), (512, 40, 40), (512, 96, 96),
                    (512, 100, 100), (512, 140, 140))
# where k1_occupancy gives K1's blocks an SM past one warp
K1_BLOCK_NS = (33, 64, 96, 128, 169)


def k1_branch_inputs(b, n, seed):
    """(P, q, lo, hi, v_sign, radius), float32 on the card, drawn in this
    order from one rng: P = S S^T + 0.1 I (S ~ N(0, 1 / n)), q ~ N(0, 1), the
    box bounds -U(0.2, 0.7) and U(0.2, 0.7), signs, radii U(0.05, 0.55)."""
    rng = np.random.default_rng(seed)
    S = (rng.standard_normal((b, n, n)) / np.sqrt(n)).astype(np.float32)
    return cuda(S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32),
                rng.standard_normal((b, n)).astype(np.float32),
                -(rng.random((b, n)) * 0.5 + 0.2).astype(np.float32),
                (rng.random((b, n)) * 0.5 + 0.2).astype(np.float32),
                np.sign(rng.standard_normal((b, n))).astype(np.float32),
                (rng.random((b, n // 2)) * 0.5 + 0.05).astype(np.float32))


def phase_2_k1(dqt, cfg, flag, gate=True):
    """Phase 2: K1 (``admm_solve_cuda``) against its plain version
    (``admm_solve_plain``) on the same card inputs, bit for bit
    (``compare(exact=gate)``: every problem's l, iterations, ``converged``
    and ``stalled`` equal): the flagship (``flag``, B=4096 N=24, the disk);
    the prox kinds and branches at every ``K1_BRANCH_POINTS``: B=256 at
    N = 8, 12 and 16 (four, two and two problems a warp), B=512 at N = 40,
    96 and 100 (the register instances kN = 64, 96, 128) and N = 140 (the
    two-plane kernel) (``k1_branch_inputs``) at eps=1e-5 (the QP kinds) and 1e-6 (the disk): non-negative,
    box, signed box, disk, rho_sync=False (the per-problem cpt gate),
    primal_check=False (the dual-only rule), max_iter=2 and 0, and
    warm_start_dual from a converged primal; every one-warp edge
    ``K1_EDGE_NS`` at B=256, the disk at the flagship's schedule and the
    non-negative QP; ragged batches, B=1027 at N=8 and B=1025 at N=16 (a
    last warp with padding); config 5's size, examples_torch/
    sharded_batch.py's 65,536 problems at N=8 in one launch (eps=1e-7,
    max_iter=1000); past one warp, B=512 at N=96 (three warps) and N=34,
    and at every block-wide edge ``K1_BLOCK_EDGE_NS`` at B=512, the disk at
    the flagship's schedule and the non-negative QP (seeds 60 + n).
    Returns {"flagship": (K1's output, inverses a problem, max |dl|),
    "config 5": (args, K1's output, the plain version's output, inverses a
    problem, the plain version's ms), "N=96": (P, q, l_n, mu, K1's l)}."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import (
        PROX_BOX, PROX_DISK, PROX_NONNEG, PROX_SIGNED_BOX, admm_solve_cuda, admm_solve_plain,
    )

    out = {}

    def held(name, a, factors=None):
        out_k = admm_solve_cuda(*a)
        t0 = time.perf_counter()
        out_p = admm_solve_plain(*a, factors=factors)
        torch.cuda.synchronize()
        ms_p = (time.perf_counter() - t0) * 1e3
        return out_k, out_p, compare(name, out_k, out_p, exact=gate), ms_p

    P, q, l_n, mu = flag
    args = (P, q, torch.zeros_like(q), PROX_DISK, ((l_n * mu).contiguous(),), cfg, True, False)
    factors = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    out_k, out_p, err, _ = held("flagship B=4096 N=24 disk", args, factors)
    counts("flagship B=4096 N=24", out_p[1].iterations, factors)
    out["flagship"] = (out_k, factors, err)

    # eps=1e-5: the QP-family problems here certify on eps before their
    # iterates reach the float32 noise floor. Below it (eps=1e-6) most of them
    # stop through the 8-ulp stall test, whose first passing iteration moves
    # with rounding order (kernel FMAs vs eager ops): up to 4 iterations apart
    # on an H100, which measures rounding, not the algorithm.
    qp_cfg = dqt.QP_DEFAULTS.replace(eps=1e-5, max_iter=3000)
    for b, n, seed in K1_BRANCH_POINTS:
        Pk, qk, lo, hi, vs, rad = k1_branch_inputs(b, n, seed)
        wsk = torch.zeros_like(qk)
        for name, kind, pa, c, qstop in [
            ("nonneg", PROX_NONNEG, (), qp_cfg, False),
            ("box", PROX_BOX, (lo, hi), qp_cfg, False),
            ("signed box", PROX_SIGNED_BOX, (lo, hi, vs), qp_cfg, False),
            ("disk", PROX_DISK, (rad,), cfg.replace(eps=1e-6), True),
            # the kernel's other branches: the per-problem cpt gate, the
            # dual-only stopping rule, and a max_iter cap mid-solve and at 0
            ("nonneg rho_sync=False", PROX_NONNEG, (), qp_cfg.replace(rho_sync=False), False),
            ("box primal_check=False", PROX_BOX, (lo, hi), qp_cfg.replace(primal_check=False),
             False),
            ("disk max_iter=2", PROX_DISK, (rad,), cfg.replace(max_iter=2), True),
            ("disk max_iter=0", PROX_DISK, (rad,), cfg.replace(max_iter=0), True),
        ]:
            held(f"{name} B={b} N={n}", (Pk, qk, wsk, kind, pa, c, qstop, not qstop))
        # warm_start_dual from a converged primal: u0 = -(P ws + q)
        l0, _ = admm_solve_plain(Pk, qk, wsk, PROX_NONNEG, (), qp_cfg)
        held(f"nonneg warm_start_dual B={b} N={n}",
             (Pk, qk, l0, PROX_NONNEG, (), qp_cfg.replace(warm_start_dual=True)))

    for n in K1_EDGE_NS:
        Pk, qk, _, _, _, rad = k1_branch_inputs(256, n, 40 + n)
        wsk = torch.zeros_like(qk)
        if n >= 2:
            held(f"edge disk B=256 N={n}", (Pk, qk, wsk, PROX_DISK, (rad,), cfg, True, False))
        held(f"edge nonneg B=256 N={n}", (Pk, qk, wsk, PROX_NONNEG, (), qp_cfg))

    for b, n, seed in ((1027, 8, 5), (1025, 16, 6)):
        Pk, qk, lo, hi, _, rad = k1_branch_inputs(b, n, seed)
        wsk = torch.zeros_like(qk)
        held(f"ragged disk B={b} N={n}", (Pk, qk, wsk, PROX_DISK, (rad,), cfg, True, False))
        held(f"ragged box B={b} N={n}", (Pk, qk, wsk, PROX_BOX, (lo, hi), qp_cfg))

    P5, q5, ln5, mu5 = sharded_example_problems(65536)
    a5 = (P5, q5, torch.zeros_like(q5), PROX_DISK, ((ln5 * mu5).contiguous(),),
          dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=1000), True, False)
    factors5 = torch.zeros(q5.shape[0], dtype=torch.int64, device=q5.device)
    out_k5, out_p5, _, ms_p5 = held("config 5's size B=65536 N=8 disk", a5, factors5)
    counts("config 5's size B=65536 N=8", out_p5[1].iterations, factors5)
    out["config 5"] = (a5, out_k5, out_p5, factors5, ms_p5)

    Pb, qb, lnb, mub = cuda(*build_problems(512, 48, seed=2))
    a = (Pb, qb, torch.zeros_like(qb), PROX_DISK, ((lnb * mub).contiguous(),), cfg, True, False)
    out_kb, _, _, _ = held("disk B=512 N=96 (3 warps)", a)
    out["N=96"] = (Pb, qb, lnb, mub, out_kb[0])
    P17, q17, ln17, mu17 = cuda(*build_problems(512, 17, seed=15))
    held("disk B=512 N=34 (2 warps)", (P17, q17, torch.zeros_like(q17), PROX_DISK,
                                        ((ln17 * mu17).contiguous(),), cfg, True, False))
    for n in K1_BLOCK_EDGE_NS:
        Pk, qk, _, _, _, rad = k1_branch_inputs(512, n, 60 + n)
        wsk = torch.zeros_like(qk)
        held(f"block edge disk B=512 N={n}", (Pk, qk, wsk, PROX_DISK, (rad,), cfg, True, False))
        held(f"block edge nonneg B=512 N={n}", (Pk, qk, wsk, PROX_NONNEG, (), qp_cfg))
    torch.cuda.synchronize()
    return out


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
    that ``fn`` runs, from torch.profiler, largest first. User annotations
    (``Optimizer.step#Adam.step`` spans the optimiser's kernels on the
    device timeline) are left out: they are ranges, not kernels, and
    counting them would count their kernels twice. Late in a long run the
    profiler may hold none of a session's first launches (PERF.md §7):
    ``timed_step`` and ``e1_times`` say so where they look for a kernel."""
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
            if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[1])


def per_launch_ms(rows, kernel):
    """Device ms per launch of the kernel whose name contains ``kernel``, from
    ``device_time_by_kernel``'s rows; None when the trace holds no such kernel."""
    return next((ms / cnt for name, ms, cnt in rows if kernel in name), None)


def timed_step(label, fn, smi, reps=5, calls=1, problems=None, top=0, expect=None,
               device=True):
    """``fn`` timed as phase 4 times the steps (CUDA events, warm-up, median
    of ``reps`` samples of ``calls`` back-to-back calls) with its device
    time by kernel from torch.profiler (the ``top`` largest kernels listed)
    and the card's idle share; where ``fn`` launches E1 (``expect="E1"``) and
    the trace holds none of it, the line says so. ``device=False`` (a staged
    graph with conditional nodes, whose bodies' kernels the profiler does
    not count reliably) times the wall alone. Returns (ms per call, idle
    share or None)."""
    ms, ts = time_cuda(fn, reps=reps, calls=calls)
    rate = "" if problems is None else f" = {problems / ms * 1e3:.1f} problems/s"
    if not device:
        log(f"  {label} ({smi}): {ms:.4f} ms per call, {calls} back-to-back (CUDA events; samples "
            f"{[round(t, 4) for t in ts]}){rate}; device time not measured")
        return ms, None
    rows = device_time_by_kernel(fn, calls=calls)
    dev = sum(r_[1] for r_ in rows)
    by = {k: sum(r_[1] for r_ in rows if tag in r_[0]) for k, tag in
          (("K1", "admm_kernel"), ("K2", "qcqp_bwd_kernel"), ("K4", "coord_bwd_kernel"),
           ("E1", "jacobi_eigh"))}
    lost = (f"; the trace holds no {expect} though the path launches it: device time and idle "
            "share without it (PERF.md §7)" if expect and by[expect] == 0 else "")
    log(f"  {label} ({smi}): {ms:.4f} ms per call, {calls} back-to-back (CUDA events; samples "
        f"{[round(t, 4) for t in ts]}){rate}; device time by kernel (torch.profiler, ms per "
        f"call): total {dev:.4f}, " + ", ".join(f"{k} {v:.4f}" for k, v in by.items())
        + f", other kernels {dev - sum(by.values()):.4f}; device idle {ms - dev:.4f} ms "
        f"({(ms - dev) / ms:.1%}){lost}")
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
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import qcqp_kkt_bwd_cuda, qcqp_kkt_bwd_fused_cuda
    from diffqcqp_tpu_torch.kernels.qr_solve_cuda import qr_solve_cuda

    solve = getattr(dqt, f"solve_{c.name}_with_stats")
    diff = (c.P, c.q) + (c.params[:2] if c.params else ())
    rest = c.params[2:]
    leaves = [x.clone().requires_grad_() for x in diff]

    def step(xs=leaves, config=c.cfg, fn=solve, extra=rest):
        lx = fn(*xs, *extra, config=config)
        lx = lx[0] if isinstance(lx, tuple) else lx
        return lx, torch.autograd.grad((lx * lx).sum() + (w.reshape(lx.shape) * lx).sum(), xs)

    kernels = (admm_solve_cuda, coord_kkt_bwd_fused_cuda, qcqp_kkt_bwd_fused_cuda, qr_solve_cuda,
               qcqp_kkt_bwd_cuda)
    for k_ in kernels:
        k_.launches = 0
    l, st = solve(*leaves, *rest, config=c.cfg)
    grads = torch.autograd.grad((l * l).sum() + (w * l).sum(), leaves)
    torch.cuda.synchronize()
    n_k1, n_k4, n_k2, n_k5, n_k6 = (k_.launches for k_ in kernels)
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
    log(f"  {c.name}: launches K1 {n_k1}, K4 {n_k4}, K2 {n_k2}, K5 {n_k5}, K6 {n_k6}; "
        f"converged_frac={conv} "
        f"mean_iters={float(st.iterations.float().mean()):.4f} "
        f"max_iters={int(st.iterations.max())} stalled={float(st.stalled.float().mean()):.4f} "
        f"max feasibility excess={excess:.3e} max|l - l_f64 referee|={err_l:.3e} "
        f"(referee converged {bool(st64.converged.all())}, mean_iters "
        f"{float(st64.iterations.float().mean()):.2f}); gradients finite {finite}; strictly "
        f"active slots {float(am_ref.double().mean()):.4f}; problems whose strict mask the "
        f"referee does not share: {int((~shared).sum())}/{shared.numel()}")
    if n_k1 != 1 or n_k4 != 1 or n_k2 or n_k5 or n_k6 or not finite:
        raise AssertionError(f"the {c.name} step did not run through K1 and K4 once each alone")
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
# Config 6: the JAX package's large-N QP (run_benchmarks.py config 6, B=2048,
# N=96, seed 6), K1 then K4's block-wide path
# ---------------------------------------------------------------------------

K4_OCC_SIZES = (48, 96, 168)     # K4's block-wide path: blocks per SM printed in phase 1


def config6_classes(dqt, b=2048, n=96, seed=6):
    """Config 6's problems (``spd_problems(2048, 96, seed=6)``) as the three
    QP-family classes: the QP at config 6's schedule (``QP_DEFAULTS.replace(
    eps=1e-7, max_iter=400, rho_update_period=24)``), the box kinds with
    ``box_bounds`` drawn next from the seed-6 rng, at config 9's schedule."""
    rng, P, q = spd_problems(b, n, seed)
    lo, hi, v = cuda(*box_bounds(rng, b, n))
    P, q = cuda(P, q)
    box_cfg = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=2000)
    return {"qp": qp_class("qp", P, q, dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400,
                                                                rho_update_period=24)),
            "box_qp": qp_class("box_qp", P, q, box_cfg, lo, hi),
            "signed_box_qp": qp_class("signed_box_qp", P, q, box_cfg, lo, hi, v)}


def k4_block_cases(dqt, c6):
    """Phase 2c's cases on K4's block-wide path: the three kinds at config 6
    (B=2048, N=96; the QP first), at N=33 (B=256, just past one warp) and at
    N=168 (B=256, the largest n K4 takes)."""
    qp_cfg = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0,
                                     rho_update_period=24, power_iters=10)
    box_cfg = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=2000)
    cases = [(f"{name} B=2048 N=96 (config 6)", c) for name, c in c6.items()]
    for n, seed in ((33, 17), (168, 18)):
        rng, P, q = spd_problems(256, n, seed)
        lo, hi, v = cuda(*box_bounds(rng, 256, n))
        P, q = cuda(P, q)
        cases += [(f"qp B=256 N={n}", qp_class("qp", P, q, qp_cfg)),
                  (f"box B=256 N={n}", qp_class("box_qp", P, q, box_cfg, lo, hi)),
                  (f"signed box B=256 N={n}", qp_class("signed_box_qp", P, q, box_cfg, lo, hi, v))]
    return cases


def k4_occupancy(sms):
    """Print K4's blocks per SM (the occupancy calculator) and waves at
    B=2048, ceil(B / (blocks per SM x SMs)), for each kind at the block-wide
    sizes ``K4_OCC_SIZES``; fail if one does not fit an SM."""
    from diffqcqp_tpu_torch.kernels import coord_bwd_cuda as k4m

    kinds = (("qp", k4m.KIND_QP), ("box", k4m.KIND_BOX), ("signed box", k4m.KIND_SIGNED_BOX))
    occ = {}
    for n in K4_OCC_SIZES:
        for name, kind in kinds:
            blk = k4m.c_blocks_per_sm(n, kind)
            occ[(n, name)] = (blk, -(-2048 // max(blk * sms, 1)))
    log(f"  K4 block-wide, blocks per SM (occupancy calculator) and waves at B=2048 on {sms} "
        f"SMs, shared memory {[(n, k4m.smem_bytes(n)) for n in K4_OCC_SIZES]} bytes: "
        + ", ".join(f"N={n} {name} {blk} ({w} waves)" for (n, name), (blk, w) in occ.items()))
    if min(blk for blk, _ in occ.values()) < 1:
        raise AssertionError(f"K4's block-wide path does not fit an SM: {occ}")


def nnls_solve_batch(P, q):
    """Float64 solutions of the non-negative QPs min 1/2 l'Pl + q'l, l >= 0,
    by scipy's NNLS (Lawson-Hanson, an exact active-set method) on
    min ||A l - b|| with A = chol(P)^T, b = -A^-T q: a copy of
    benchmarks/external_oracle.py::nnls_solve_batch (numpy and scipy only),
    config 6's referee in the JAX package."""
    from scipy.linalg import cholesky, solve_triangular
    from scipy.optimize import nnls

    P, q = np.asarray(P, np.float64), np.asarray(q, np.float64)
    out = np.empty_like(q)
    for i in range(q.shape[0]):
        L = cholesky(P[i], lower=True)
        out[i], _ = nnls(L.T, solve_triangular(L, -q[i], lower=True))
    return out


def phase_3k(dqt, c6, n_nnls=256):
    """Config 6's step, ``solve_qp`` then ``torch.autograd.grad`` of sum(l^2)
    for P and q, through phase_3c (launch counters zeroed just before and
    read just after: K1 and K4 once each, nothing else; every problem
    converged; the float64 referee, central differences and ``QPFn2``);
    then l against scipy's NNLS on the first ``n_nnls`` problems (bar 1e-4)
    and the share of free coordinates nf / n that K4 factors. Returns
    (launches of K1, of K4, the step)."""
    from diffqcqp_tpu_torch.kernels.coord_bwd_cuda import coord_kkt_bwd_fused_cuda

    c = c6["qp"]
    n_k1, n_k4, step = phase_3c(dqt, c, torch.zeros_like(c.q))
    l, _ = dqt.solve_qp_with_stats(c.P, c.q, config=c.cfg)
    t0 = time.perf_counter()
    l_nnls = nnls_solve_batch(c.P[:n_nnls].cpu().numpy(), c.q[:n_nnls].cpu().numpy())
    err = float((l[:n_nnls].double().cpu() - torch.from_numpy(l_nnls)).abs().max())
    log(f"  config 6: max|l - l_NNLS| over {n_nnls} problems {err:.3e} (bar 1e-4; scipy NNLS "
        f"{time.perf_counter() - t0:.1f} s)")
    if not err <= 1e-4:
        raise AssertionError("config 6's l disagrees with the NNLS referee")
    for name, ci in c6.items():
        li = l if name == "qp" else getattr(dqt, f"solve_{name}")(ci.P, ci.q, *ci.params,
                                                                 config=ci.cfg)
        out = coord_kkt_bwd_fused_cuda(ci.P, ci.q, li, (2.0 * li).contiguous(), *ci.bounds,
                                       ci.kind, ci.cfg.eps, ci.cfg.act_eps)
        am = k4_mask(ci.kind, out)
        if ci.kind != 0:        # a coordinate is strictly active if any of its slots is
            am = am.reshape(am.shape[0], -1, c.q.shape[1]).any(dim=1)
        nf = (~am).sum(dim=1).double()
        n = c.q.shape[1]
        log(f"  config 6 {name}: free share nf / n mean {float(nf.mean()) / n:.4f}, min "
            f"{float(nf.min()) / n:.4f}, max {float(nf.max()) / n:.4f}; problems with nf <= 32 "
            f"(the register factor): {int((nf <= 32).sum())}/{nf.numel()}")
    return n_k1, n_k4, step


def sharded_example_problems(b, seed=0):
    """examples_torch/sharded_batch.py's problems (bench.py's generator at
    nc=4, N=8, its own float32 casts), float32 on the card."""
    nc, n = 4, 8
    rng = np.random.default_rng(seed)
    S = (rng.standard_normal((b, n, n)) / np.sqrt(n)).astype(np.float32)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32)
    q = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    l_n = (rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32)
    mu = (rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32)
    return cuda(P, q, l_n, mu)


def phase_3l(dqt, b=65536, slices=4):
    """Config 5's size on one card: the sharded example's problems (B=65,536,
    N=8) and schedule (eps=1e-7, max_iter=1000), each of its four
    16,384-problem slices (one card's shard) solved three ways: K1 (the
    unsharded reference of the example), the float32 eager engine
    (``backend='xla'``: lockstep runs it, and its l is bit for bit each
    shard's own engine solve, phase 3j) and a float64 referee (the engine at
    eps=1e-10). Prints max |l - l_f64| of K1 and of the engine per slice;
    fails unless every solve converged and both are within 1e-4 of float64
    (phase 3's bar). Returns [(K1's, the engine's, |engine - K1|)] a
    slice."""
    xs = sharded_example_problems(b)
    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=1000)
    rows = []
    for k in range(slices):
        sl = slice(k * b // slices, (k + 1) * b // slices)
        part = [x[sl].contiguous() for x in xs]
        l_k1, st_k1 = dqt.solve_qcqp_with_stats(*part, config=cfg)
        l_en, st_en = dqt.solve_qcqp_with_stats(*part, config=cfg.replace(backend="xla"))
        l64, st64 = dqt.solve_qcqp_with_stats(*(x.double() for x in part),
                                              config=cfg.replace(eps=1e-10, max_iter=5000))
        e_k1, e_en = (float((x.double() - l64).abs().max()) for x in (l_k1, l_en))
        e_d = float((l_en - l_k1).abs().max())
        conv = all(bool(st.converged.all()) for st in (st_k1, st_en, st64))
        log(f"  slice {k} (problems {sl.start}-{sl.stop - 1}): max|l - l_f64| K1 {e_k1:.3e}, "
            f"engine {e_en:.3e}; max|l_engine - l_K1| {e_d:.3e}; mean iterations K1 "
            f"{float(st_k1.iterations.float().mean()):.2f}, engine "
            f"{float(st_en.iterations.float().mean()):.2f} (max {int(st_en.iterations.max())}), "
            f"float64 {float(st64.iterations.float().mean()):.2f}; all converged {conv}")
        if not (conv and e_k1 <= 1e-4 and e_en <= 1e-4):
            raise AssertionError(f"config 5's slice {k}: a solve did not converge or is past "
                                 "1e-4 of the float64 referee")
        rows.append((e_k1, e_en, e_d))
    return rows


def phase_4h(dqt, c6, step6, smi):
    """Config 6's timings: K4's QP kind, its plain version, bound and library
    call and the step (``phase_4c``); K1 on config 6's problems against its
    plain version (``compare``'s bars), its time and its bound
    (``k1_bound_ms`` from its iterations and the plain version's inverses
    formed); then K4's box kinds on the same P and q, and the three kinds on config 6's generator at B=2048 and the
    block-wide path's smaller sizes N = 33, 48, 64 (profiler and events,
    bound). Returns the QP kind's numbers for the kernels line."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import admm_solve_cuda, admm_solve_plain

    k4_6 = phase_4c(c6["qp"], step6, smi)
    fmt = lambda x: "not in the trace" if x is None else f"{x:.4f} ms"  # noqa: E731
    # K1 at config 6: its time, and its bound from this run's iterations and
    # the plain version's count of inverses formed
    c = c6["qp"]
    B, n = c.q.shape
    a = (c.P, c.q, torch.zeros_like(c.q), c.prox, c.prox_args, c.cfg)
    k1 = lambda: admm_solve_cuda(*a)   # noqa: E731
    out_k = k1()
    factors = torch.zeros(B, dtype=torch.int64, device=c.q.device)
    compare(f"K1 at config 6, B={B} N={n}", out_k, admm_solve_plain(*a, factors=factors))
    counts(f"config 6, B={B} N={n}", out_k[1].iterations, factors)
    dev = per_launch_ms(device_time_by_kernel(k1, calls=5), "admm_kernel")
    ev, ts = time_cuda(k1, reps=5, calls=5)
    b_, b_by, nbytes, nflops = k1_bound_ms(B, n, 0, out_k[1].iterations, factors,
                                           c.cfg.power_iters)
    log(f"  K1 at config 6, B={B} N={n} ({smi}): device time per launch (torch.profiler) "
        f"{fmt(dev)}; per call, 5 back-to-back (CUDA events) {ev:.4f} ms (samples "
        f"{[round(t, 4) for t in ts]}); bound {b_:.5f} ms ({b_by}: {nbytes} bytes, "
        f"{nflops:.4g} FLOP)")
    cases = [(f"{name} at config 6, B=2048 N=96", c6[name]) for name in ("box_qp", "signed_box_qp")]
    for n in (33, 48, 64):
        cases += [(f"{name} B=2048 N={n}", c) for name, c in config6_classes(dqt, n=n).items()]
    for label, c in cases:
        _, dev, (ev, ts), (b_, b_by, *_) = time_k4(c)
        log(f"  K4 {label} ({smi}): device time per launch (torch.profiler) {fmt(dev)}; per "
            f"call, 20 back-to-back (CUDA events) {ev:.4f} ms (samples "
            f"{[round(t, 4) for t in ts]}); bound {b_:.5f} ms ({b_by})")
    return k4_6


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


def phase_2b(cfg, flag, n96):
    """K2 against its plain version on the card (phase 2b): ``flag`` and
    ``n96`` are (P, q, K1's l, radius) at the flagship and at B=512 N=96;
    the other points are built here. Returns (the block-wide edges' problems
    by label, max |d dl| of each comparison, the flagship's with g = 2 l
    first)."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import PROX_DISK, admm_solve_cuda
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import (
        qcqp_kkt_bwd_fused_cuda, qcqp_kkt_bwd_fused_plain,
    )

    log("phase 2b: K2 against qcqp_kkt_bwd_fused_plain on the card")
    f32_ulps = 8.0 * torch.finfo(torch.float32).eps
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
        ("flagship B=4096 N=24", flag),
        (f"B=256 N=12, {int((rad2 == 0).sum())} zero radii", (P2, q2, l2, rad2)),
        ("B=512 N=96 (block-wide)", n96),
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
    return edge, errs_k2


def k2_run(dqt, smi, t_start):
    """``chip_smoke.py k2``: K2's phases alone, after a change to it: phase
    2b, phase 2e's K6 against K2 at the flagship, and K2's numbers at the
    flagship (``k1_k2_times``)."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import PROX_DISK, admm_solve_cuda, admm_solve_plain

    cfg = flagship_cfg(dqt)
    P, q, l_n, mu = cuda(*build_problems(B_FLAG, NC_FLAG))
    radius = (l_n * mu).contiguous()
    args = (P, q, torch.zeros_like(q), PROX_DISK, (radius,), cfg, True, False)
    out_k = admm_solve_cuda(*args)
    factors = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    admm_solve_plain(*args, factors=factors)
    Pb, qb, lnb, mub = cuda(*build_problems(512, 48, seed=2))
    rb = (lnb * mub).contiguous()
    lb = admm_solve_cuda(Pb, qb, torch.zeros_like(qb), PROX_DISK, (rb,), cfg, True, False)[0]
    lk = out_k[0]
    phase_2b(cfg, (P, q, lk, radius), (Pb, qb, lb, rb))
    k6_against_k2(P, q, lk, radius, (2.0 * lk).contiguous(), cfg,
                  8.0 * torch.finfo(torch.float32).eps)
    k1_k2_times(P, q, radius, cfg, out_k, factors, smi)
    torch.cuda.synchronize()
    log(f"chip_smoke: K2 phases passed, {time.perf_counter() - t_start:.1f} s")
    return 0


def sysid_run(dqt, smi, t_start):
    """``chip_smoke.py sysid``: ``SystemID(kind="mixed")`` at config 4's size
    (2048 jobs of a QP and a 12-contact QCQP on shared S and q) staged on
    the card: ``train_step`` captured once as one graph, its layout naming
    ``sysid.params``, ``sysid.loss`` and ``sysid.update``, its losses and
    parameters after six steps against a second model's eager steps, and
    the time a step, staged and eager (CUDA events)."""
    from diffqcqp_tpu_torch.models import system_id as sid

    B, nc = 2048, 12
    n = 2 * nc
    g = torch.Generator().manual_seed(3)
    S = torch.randn(B, n, n, generator=g) / n ** 0.5
    q = torch.randn(B, n, generator=g) * 0.3
    target = (torch.rand(B, n, generator=g) * 0.1).cuda()
    qp_cfg = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0, rho_update_period=24)
    qc_cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0,
                                       rho_update_period=24, power_iters=10)

    def model():
        m = sid.SystemID(kind="mixed", config=qc_cfg, qp_config=qp_cfg, device="cuda")
        m.set_params(sid.QCQPSystemIDParams(S.cuda(), q.cuda(), torch.zeros(B, nc).cuda(),
                                            torch.zeros(B, nc).cuda()))
        return m

    log(f"phase sysid: SystemID(kind='mixed') at B={B} jobs, N={n}, staged ({smi})")
    staged_m, eager_m = model(), model()
    for k in range(6):
        ls = staged_m.train_step(target)
        le = eager_m._train_step(target)
        log(f"  step {k}: loss staged {float(ls):.9g} eager {float(le):.9g}")
    st = staged_m._staged_step
    layout = next(iter(st.layout.values()))
    paths = sorted({p for p, _ in layout if p})
    d = max(float((a - b).abs().max()) for a, b in zip(staged_m.params, eager_m.params))
    log(f"  captures {st.captures}, graphs {len(st.graphs)}, eager calls {st.eager_calls}; "
        f"layout paths {paths}; max |staged - eager| over the parameters {d:.3e}")
    if (st.captures != 1 or len(st.graphs) != 1
            or not {"sysid.params", "sysid.loss", "sysid.update"} <= set(paths) or d > 1e-6):
        raise AssertionError("the mixed SystemID step is not one graph naming its spans, or its "
                             "staged steps leave the eager ones")
    ms_s, ts_s = time_cuda(lambda: staged_m.train_step(target), reps=5, calls=20)
    ms_e, ts_e = time_cuda(lambda: eager_m._train_step(target), reps=3, calls=5)
    log(f"  a step: staged {ms_s:.4f} ms (samples {[round(t, 4) for t in ts_s]}), eager "
        f"{ms_e:.4f} ms (samples {[round(t, 4) for t in ts_e]})")
    log(f"chip_smoke: sysid phase passed, {time.perf_counter() - t_start:.1f} s")
    return 0


def k6_against_k2(P, q, l, r, g, cfg, ulps):
    """K6 fed K2's own gamma (s and the strict mask from
    ``qcqp_strict_active`` on it) against K2 on the same problem, with phase
    2b's bars on the problems whose strict mask agrees: the two kernels share
    steps 4-8, and differ by K2's slack taken in double and its split of the
    cotangent along C's columns (K6 solves the whole g in float)."""
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
    # float64, none of K1-K6 (the spectral set-up is E1, counted in phase
    # 3p), against the float64 referee (plain K1 at eps=1e-10)
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


def phase_4f(dqt, smi, sysid_step, flag, cfg):
    """Phase 4's timings of this slice's paths: the config-4 system-ID step;
    ``qcqp_jacobian`` at the flagship, l given, and held against
    ``qcqp_vjp`` in float64. The rollout, the contact system-ID step, the
    diagonal-P step and ``qcqp_jacobian`` with l solved inside are timed
    eagerly and staged in phase 4o."""
    from diffqcqp_tpu_torch.diff import kkt

    timed_step("config-4 system-ID step, B=2048 QPs + 2048 QCQPs N=24 (forward, backward, "
               "Adam)", sysid_step, smi, calls=20, problems=4096)
    P, q, l_n, mu = flag
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
    """Count, for the block, the steps of the lockstep joint loop
    (``parallel.sharding.Lockstep._step``: one engine iteration of every
    shard of the process, then one done-flag MIN, an all-reduce under a
    process group): a list with the number of shards each step stepped."""
    from diffqcqp_tpu_torch.parallel import sharding as tsh

    steps = []
    inner = tsh.Lockstep._step

    def counted(self, bodies, states):
        steps.append(len(states))
        return inner(self, bodies, states)

    tsh.Lockstep._step = counted
    try:
        yield steps
    finally:
        tsh.Lockstep._step = inner


def in_rounds(label, rounds, k, slowest, own=None):
    """The joint loop made exactly ``slowest`` steps (the batch's slowest
    problem's iterations), each over all k shards. With ``own``, each
    shard's own slowest problem, at least one of which stops earlier: a loop
    that did not take the MIN would stop there."""
    log(f"    {label}: joint loop steps {len(rounds)}, shards a step {sorted(set(rounds))}; the "
        f"batch's slowest problem {slowest} iterations"
        + ("" if own is None else f", each shard's own slowest {own}"))
    if rounds != [k] * slowest:
        raise AssertionError(f"{label}: the joint loop did not step every shard once an "
                             "iteration until the slowest problem converged")
    if own is not None and min(own) >= slowest:
        raise AssertionError(f"{label}: no shard stops early, so the steps cannot show a MIN")


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
    # batch's: only a MIN keeps the joint loop stepping it until the batch's
    # slowest problem is done, which the step counts show.
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
    timed_step("bucketed step, 4000 padded to 4096 (K1 + K2)", paths["bucketed"], smi,
               calls=20, problems=4000)
    timed_step("resumed solve from max_iter=8, 3 rounds (K1 x3)", paths["resumed"], smi,
               calls=5, problems=B)
    ms_t, _ = timed_step("trace_qcqp, 64 iterations (the eager engine)", paths["trace"], smi,
                         reps=3, calls=1)
    log(f"    = {ms_t / 64:.4f} ms per traced iteration")


# ---------------------------------------------------------------------------
# torch.func: the solves under vmap, grad and jacrev (the groups folded into
# the batch: one launch of each kernel)
# ---------------------------------------------------------------------------

def launched(kernels, fn):
    """(``fn()``, the launches of each kernel in it): the counters zeroed
    just before, read just after a synchronisation."""
    for k_ in kernels.values():
        k_.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name_: k_.launches for name_, k_ in kernels.items()}


def only_launched(label, n, want):
    """Fail unless the kernels ``want`` names launched exactly so often and
    no other kernel launched."""
    if any(n[k] != want.get(k, 0) for k in n):
        raise AssertionError(f"{label}: launches {n}, want {want} and no other kernel")


def vmapped_step(dqt, kernels, label, solve, xs, cfg, want, groups=2):
    """``torch.func.vmap(torch.func.grad(loss))`` of sum(l^2) over ``groups``
    groups of the batch (``xs`` reshaped (G, B / G, ...)), l as the aux
    output, beside the flat step (``solve`` then ``torch.autograd.grad``) on
    the same inputs. Fails unless the vmapped step launches exactly ``want``
    and its l and every gradient equal the flat step's bit for bit. Returns
    (the vmapped step, the flat step) as closures for the timing."""
    from torch.func import grad, vmap

    def loss(*a):
        l = solve(*a, config=cfg)
        return (l * l).sum(), l

    argnums = tuple(range(len(xs)))
    grouped = [x.reshape(groups, x.shape[0] // groups, *x.shape[1:]) for x in xs]
    leaves = [x.clone().requires_grad_() for x in xs]

    def step_v():
        return vmap(grad(loss, argnums=argnums, has_aux=True))(*grouped)

    def step_f():
        l = solve(*leaves, config=cfg)
        return torch.autograd.grad((l * l).sum(), leaves), l

    (g_v, l_v), n_v = launched(kernels, step_v)
    (g_f, l_f), n_f = launched(kernels, step_f)
    same_l = torch.equal(l_v.reshape(l_f.shape), l_f)
    same_g = [torch.equal(a.reshape(b.shape), b) for a, b in zip(g_v, g_f)]
    d_g = [float((a.reshape(b.shape) - b).abs().max()) for a, b in zip(g_v, g_f)]
    log(f"  {label}: vmap(grad) over {tuple(grouped[1].shape)}: launches {n_v} (the flat "
        f"step's {n_f}); l bit for bit the flat step's: {same_l}; gradients bit for bit: "
        f"{same_g} (max |d| {d_g}); finite: {all(bool(torch.isfinite(x).all()) for x in g_v)}")
    only_launched(label, n_v, want)
    if not (same_l and all(same_g)):
        raise AssertionError(f"{label}: the vmapped step is not the flat step bit for bit")
    return step_v, step_f


def jac_errors(label, got, ref, active_got, active_ref, names):
    """Per-problem relative (Frobenius) error of each Jacobian block against
    ``ref``: median over every problem and max over the problems whose strict
    mask (``active_*``, (B, slots) bool) ``ref`` shares. Returns the worst
    (median, max)."""
    shared = ~(active_got != active_ref).any(dim=-1)
    worst = worst_max = 0.0
    parts = []
    for name_, a, b in zip(names, got, ref):
        e = rel_err(a, b.double(), b.new_tensor(1e-30, dtype=torch.float64))
        med, mx = float(e.median()), _max(e[shared])
        worst, worst_max = max(worst, med), max(worst_max, mx)
        parts.append(f"{name_} median {med:.3e} max {mx:.3e}")
    log(f"    against {label} (problems whose strict mask it shares: {int(shared.sum())}/"
        f"{shared.numel()}): " + "; ".join(parts))
    return worst, worst_max


def vmapped_jacrev(dqt, kernels, label, cls, xs, cfg, bwd, ref64):
    """``torch.func.vmap(torch.func.jacrev(solve))`` over the problems of
    ``xs`` one at a time (counters zeroed just before, read just after):
    K1 once and the backward kernel ``bwd`` once, over n x B problems (a spy
    on the wrapper's batch), nothing else; bit for bit the n basis-cotangent
    ``torch.autograd.grad`` calls of the flat solve; against
    ``dqt.<cls>_jacobian`` in float32 on the same l and the float64 referee
    ``ref64`` (``*_jacobian`` of float64 inputs at the float64 plain K1's l),
    per-problem relative error median <= 1e-3 and max <= 2e-3 on the
    problems whose strict mask each shares (phase 3b's bars)."""
    from torch.func import jacrev, vmap

    from diffqcqp_tpu_torch.diff import kkt

    solve = getattr(dqt, f"solve_{cls}")
    f = lambda *a: solve(*a, config=cfg)  # noqa: E731
    argnums = tuple(range(len(xs)))
    wrapper = {"K2": "qcqp_kkt_bwd_fused_cuda", "K4": "coord_kkt_bwd_fused_cuda"}[bwd]
    orig, seen = getattr(kkt, wrapper), []

    def spy(*a):
        seen.append(a[0].shape[0])
        return orig(*a)

    setattr(kkt, wrapper, spy)
    try:
        J, n_j = launched(kernels, lambda: vmap(jacrev(f, argnums=argnums))(*xs))
    finally:
        setattr(kkt, wrapper, orig)
    B, n = xs[1].shape
    leaves = [x.clone().requires_grad_() for x in xs]
    l = f(*leaves)
    rows = []
    for i in range(n):
        e = torch.zeros_like(l)
        e[:, i] = 1.0
        rows.append(torch.autograd.grad(l, leaves, grad_outputs=e, retain_graph=True))
    basis = [torch.stack([r[k] for r in rows], dim=1) for k in argnums]
    same = [torch.equal(a, b) for a, b in zip(J, basis)]
    log(f"  {label}: vmap(jacrev) over {B} problems, N={n}: launches {n_j}, {bwd} over "
        f"{seen} problems (want [{n * B}]); bit for bit the {n} basis-cotangent "
        f"autograd.grad calls: {same}")
    only_launched(label, n_j, {"K1": 1, bwd: 1})
    if seen != [n * B] or not all(same):
        raise AssertionError(f"{label}: jacrev is not one {bwd} launch over n x B problems, "
                             "or not the basis calls bit for bit")
    fields = {"qp": ("dl_dP", "dl_dq"), "qcqp": ("dl_dP", "dl_dq", "dl_dl_n", "dl_dmu")}[cls]
    jac32 = getattr(dqt, f"{cls}_jacobian")(*xs, l=l.detach(), config=cfg, include_dP=True)

    def active(jac):            # strict mask: the zero pattern of the Jacobian's blocks
        if cls == "qp":         # dl_dq's rows and columns vanish at active coordinates
            return jac[1].abs().amax(dim=1) == 0
        return jac[2].abs().amax(dim=1) != 0

    worst = [jac_errors(f"dqt.{cls}_jacobian, float32, the same l", J,
                        [getattr(jac32, k) for k in fields], active(J),
                        active([getattr(jac32, k) for k in fields]), fields),
             jac_errors("the float64 referee", J, [getattr(ref64, k) for k in fields],
                        active(J), active([getattr(ref64, k) for k in fields]), fields)]
    if not all(med <= 1e-3 and mx <= 2e-3 for med, mx in worst):
        raise AssertionError(f"{label}: jacrev disagrees with *_jacobian or the float64 "
                             "referee past phase 3b's bars")


def phase_3m(dqt, kernels, flag, cfg, c10, b_jac=256):
    """The solves under ``torch.func``, each with the launch counters zeroed
    just before and read just after: ``vmap(grad)`` of sum(l^2) at the
    flagship over (2, 2048) (P, q, l_n, mu; K1 1, K2 1) and at config 10's QP
    (P, q; K1 1, K4 1), bit for bit the flat steps; ``vmap(jacrev)`` of
    ``solve_qcqp`` (K2) and ``solve_qp`` (K4) over the first ``b_jac``
    problems of each (``vmapped_jacrev``). Returns (the vmapped flagship
    step, the flat one) for phase 4m."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import PROX_DISK, PROX_NONNEG, admm_solve_plain

    steps = vmapped_step(dqt, kernels, f"flagship B={flag[1].shape[0]} N={flag[1].shape[1]}",
                         dqt.solve_qcqp, flag, cfg, {"K1": 1, "K2": 1})
    vmapped_step(dqt, kernels, f"config 10 QP B={c10.q.shape[0]} N={c10.q.shape[1]}",
                 dqt.solve_qp, (c10.P, c10.q), c10.cfg, {"K1": 1, "K4": 1})
    ref_cfg = dict(eps=1e-10, max_iter=5000)
    xs = [x[:b_jac].contiguous() for x in flag]
    x64 = [x.double() for x in xs]
    r64 = (x64[2] * x64[3]).contiguous()
    l64, _ = admm_solve_plain(x64[0], x64[1], torch.zeros_like(x64[1]), PROX_DISK, (r64,),
                              cfg.replace(**ref_cfg), True, False)
    vmapped_jacrev(dqt, kernels, "flagship QCQP", "qcqp", xs, cfg, "K2",
                   dqt.qcqp_jacobian(*x64, l=l64, config=cfg, include_dP=True))
    xs = [c10.P[:b_jac].contiguous(), c10.q[:b_jac].contiguous()]
    x64 = [x.double() for x in xs]
    l64, _ = admm_solve_plain(x64[0], x64[1], torch.zeros_like(x64[1]), PROX_NONNEG, (),
                              c10.cfg.replace(**ref_cfg))
    vmapped_jacrev(dqt, kernels, "config 10 QP", "qp", xs, c10.cfg, "K4",
                   dqt.qp_jacobian(*x64, l=l64, config=c10.cfg, include_dP=True))
    return steps


def phase_4m(smi, steps, B=B_FLAG):
    """Phase 4m: the vmapped flagship step beside the flat one, each through
    ``timed_step``, and their ratio on a line of its own."""
    ms_v, idle_v = timed_step(f"vmap(grad) flagship step, (2, {B // 2}) (K1 + K2)", steps[0],
                              smi, calls=20, problems=B)
    ms_f, idle_f = timed_step(f"flat flagship step B={B} (K1 + K2)", steps[1], smi, calls=20,
                              problems=B)
    log(f"  phase 4m ({smi}): vmapped flagship step {ms_v:.4f} ms (card idle {idle_v:.1%}), "
        f"flat {ms_f:.4f} ms (card idle {idle_f:.1%}): {ms_v - ms_f:+.4f} ms, "
        f"{ms_v / ms_f:.3f}x")
    return ms_v, idle_v, ms_f, idle_f


# ---------------------------------------------------------------------------
# Staged steps: each step captured as one CUDA graph (utils/staging.py), the
# port's counterpart of jax.jit; phases 3n and 4n
# ---------------------------------------------------------------------------

# the kernels' names in a profiler trace (K2's tag also matches its
# block-wide instance, K4's its one-warp one)
KERNEL_TAGS = (("K1", "admm_kernel"), ("K2", "qcqp_bwd_kernel"), ("K4", "coord_bwd_kernel"),
               ("K5", "qr_solve_kernel"), ("K6", "qcqp_schur_kernel"), ("E1", "jacobi_eigh"))


def grad_step(solve, cfg, n_diff, w=None):
    """A forward+backward step as a function of tensors, for ``staged``: the
    entry point ``solve`` (a ``*_with_stats``) on its inputs, then the
    gradient of sum(l^2) (+ <w, l> where ``w`` is given) for the first
    ``n_diff`` of them. Returns (l, stats, gradients)."""
    def step(*xs):
        leaves = [x.detach().requires_grad_() for x in xs[:n_diff]]
        l, st = solve(*leaves, *xs[n_diff:], config=cfg)
        v = (l * l).sum() if w is None else (l * l).sum() + (w * l).sum()
        return l, st, torch.autograd.grad(v, leaves)
    return step


def bit_diffs(got, ref):
    """[max |d|] over the tensor leaves of two outputs whose bits differ
    (empty where every leaf is equal bit for bit)."""
    from torch.utils import _pytree as pytree

    a, b = pytree.tree_leaves(got), pytree.tree_leaves(ref)
    if len(a) != len(b) or any((x is None) != (y is None) for x, y in zip(a, b)):
        raise AssertionError(f"outputs of {len(a)} and {len(b)} tensors")
    return [float((x.double() - y.double()).abs().max()) for x, y in zip(a, b)
            if x is not None and not torch.equal(x, y)]


def kernels_in_trace(fn, calls=5):
    """{K: launches a call} of the port's kernels in a torch.profiler trace of
    ``calls`` calls of ``fn`` (``device_time_by_kernel``), rounded to whole
    launches: late in a run the profiler can hold none of a session's first
    launches (PERF.md §7), which over one call reads as a kernel that never
    ran; over five, a loss of less than two calls' launches still rounds to
    the count a call runs."""
    rows = device_time_by_kernel(fn, calls=calls)
    return {k: round(sum(cnt for name_, _, cnt in rows if tag in name_)) for k, tag in KERNEL_TAGS}


def host_reads(fn):
    """The first line of the error that ``fn`` raises under
    ``torch.cuda.set_sync_debug_mode("error")`` (a read of the device on the
    host), or None."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        why = None
    except RuntimeError as e:
        why = str(e).strip().splitlines()[0][:120]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return why


def refused_under_capture(label, fn, capture=True):
    """Fail unless ``fn`` raises the guard's error inside a CUDA graph
    capture: one opened here, or (``capture=False``) the one ``fn`` opens
    itself, as a staged call does."""
    try:
        if capture:
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                fn()
        else:
            fn()
        msg = "nothing raised"
    except RuntimeError as e:
        msg = str(e)
    torch.cuda.synchronize()
    ok = "cannot run inside a CUDA graph capture" in msg
    log(f"    {label}: under capture {'the guard raised' if ok else 'NOT the guard'}: {msg[:200]}")
    if not ok:
        raise AssertionError(f"{label}: the guard did not refuse the capture")


class InstanceCounter:
    """``launches`` of one instance of a wrapper's ``launches_by_instance``,
    settable as ``launched`` zeroes a counter."""

    def __init__(self, wrapper, instance):
        self.wrapper, self.instance = wrapper, instance

    @property
    def launches(self):
        return self.wrapper.launches_by_instance.get(self.instance, 0)

    @launches.setter
    def launches(self, value):
        self.wrapper.launches_by_instance[self.instance] = value


def glue_counters():
    """{G: the counter of that kernel's launches}: G1's forward and adjoint
    instances and G2."""
    from diffqcqp_tpu_torch.kernels.glue_cuda import grad_p_cuda, symmetrize_cuda

    return {"G1 forward": InstanceCounter(symmetrize_cuda, "forward"),
            "G1 adjoint": InstanceCounter(symmetrize_cuda, "adjoint"), "G2": grad_p_cuda}


# a train step's glue on a dense P: P symmetrised (G1), the adjoint of that
# (G1's adjoint instance) and grad_P (G2), one launch each
GLUE_STEP = {"G1 forward": 1, "G1 adjoint": 1, "G2": 1}


def staged_check(label, kernels, step, xs, want, perturb=1):
    """Phase 3n's checks of one step staged as a CUDA graph
    (``utils.staged``): past its warm-up calls, the capture records exactly
    the kernels ``want`` names ({K: launches}, no other of the port's), a
    replay counts none, a profiled replay runs the same kernels once each,
    and the replay's outputs (l, stats, gradients) equal the eager step's
    bit for bit on ``xs`` and on ``xs`` with input ``perturb`` + 1e-5 (q +
    1e-5 k at k = 1, as bench.py perturbs it). Returns (the staged step,
    the launches at capture)."""
    from diffqcqp_tpu_torch.utils.staging import WARMUP, staged

    s = staged(step)
    for _ in range(WARMUP):
        s(*xs)
    _, n_cap = launched(kernels, lambda: s(*xs))
    _, n_rep = launched(kernels, lambda: s(*xs))
    traced = kernels_in_trace(lambda: s(*xs))
    sets = [xs, [x + 1e-5 if i == perturb else x for i, x in enumerate(xs)]]
    diffs = [bit_diffs(s(*xk), step(*xk)) for xk in sets]
    log(f"  {label}: launches at capture {n_cap}, in a replay {n_rep}; a profiled replay runs "
        f"{traced}; replay against the eager step, leaves whose bits differ (max |d|): "
        f"{diffs[0]} on the inputs, {diffs[1]} on the second set")
    only_launched(f"{label} at capture", n_cap, want)
    only_launched(f"{label}, a replay", n_rep, {})
    if traced != {k: want.get(k, 0) for k in traced}:
        raise AssertionError(f"{label}: a profiled replay runs {traced}, want {want}")
    if any(diffs):
        raise AssertionError(f"{label}: the replay is not the eager step bit for bit")
    return s, n_cap


def trajectories(label, kernels, eager, staged_step, steps, want):
    """An optimiser loop run ``steps`` steps eagerly (``eager()``) and
    staged (``staged_step()``, warm-up calls first), each step returning its
    loss: the staged step's launches are read at its capture (``want``) and
    at every replay (none). Returns (the eager losses, the staged losses,
    the launches at capture)."""
    from diffqcqp_tpu_torch.utils.staging import WARMUP

    losses_e = torch.stack([eager() for _ in range(steps)])
    losses_s, n_cap = [], None
    for k in range(steps):
        out, n = launched(kernels, staged_step)
        losses_s.append(out)
        if k == WARMUP:
            n_cap = n
            only_launched(f"{label} at capture", n, want)
        elif k > WARMUP:
            only_launched(f"{label}, a replay", n, {})
    return losses_e, torch.stack(losses_s), n_cap


def held_bit_for_bit(label, run_e, run_s, cublas_same):
    """Staged against eager runs ((parameters, losses) each): bit for bit,
    and the staged loss falls. The failure names whether cuBLAS gave the
    capture stream other bits in S S^T (``cublas_same``), the one place a
    graph could part from the eager step."""
    (p_e, l_e), (p_s, l_s) = run_e, run_s
    same = torch.equal(l_e, l_s) and all(torch.equal(a, b) for a, b in zip(p_e, p_s))
    log(f"  {label}: {len(l_e)} steps, losses {float(l_e[0]):.6e} -> {float(l_e[-1]):.6e} "
        f"(eager) and {float(l_s[0]):.6e} -> {float(l_s[-1]):.6e} (staged); parameters and "
        f"losses bit for bit: {same}")
    if not same:
        raise AssertionError(f"{label}: the staged run is not the eager run bit for bit (S S^T "
                             f"in a replay bit for bit the eager product: {cublas_same})")
    if not float(l_s[-1]) < float(l_s[0]):
        raise AssertionError(f"{label}: the staged loss did not fall")


def phase_3n(dqt, kernels, flag, cfg, families, c6, qc96, sysid, sysid_cfgs, b_guard=256,
             b_pads=(4000, 3000), steps=20):
    """Phase 3n: the steps staged as one CUDA graph each (``utils.staged``).
    Before any capture, which calls read the device on the host
    (``set_sync_debug_mode("error")``): not the eager flagship and config-10
    steps, nor the generic route through K5 and K6, nor (since the LU is
    cuSOLVER's eagerly) its LU; eagerly, the engine and the generic route's
    Newton-Schulz inverse and Cholesky do (phase 3o stages their
    device-side forms). Then each step through
    ``staged_check``; the flagship's
    graph replayed for batches of ``b_pads`` padded to its own batch (the
    4096 bucket); the config-4 system-ID
    step (capturable Adam) staged against the same step run eagerly over
    ``steps`` steps, and ``SystemID(kind="qcqp").train_step`` on config 4's
    QCQP half against the same model stepped eagerly; a diagonal-P and a
    float64 ``SystemID`` (the spectral mode, E1) staged, their losses falling
    past the warm-up steps (phase 3p holds a float64 one to its eager twin
    bit for bit). The float64 flagship and ``backend='xla'`` steps, which
    refused a capture here before E1, stage in phase 3p. Returns ({path:
    launches at capture}, [(label, eager step, staged step, problems)] for
    phase 4n)."""
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.models.system_id import QCQPSystemIDParams, SystemID
    from diffqcqp_tpu_torch.utils import pad_to_bucket
    from diffqcqp_tpu_torch.utils.staging import WARMUP, staged

    P, q, l_n, mu = flag
    B = q.shape[0]
    c10, c9, c9s, c6q = families["qp"], families["box_qp"], families["signed_box_qp"], c6["qp"]
    solve_qc = dqt.solve_qcqp_with_stats
    flag_step = grad_step(solve_qc, cfg, 4)
    paths = {       # label: (step, inputs, launches at capture, problems)
        "flagship QCQP step B=4096 N=24": (flag_step, flag, {"K1": 1, "K2": 1, **GLUE_STEP}, B),
        "config 10 QP step B=4096 N=24": (
            grad_step(dqt.solve_qp_with_stats, c10.cfg, 2, rand_g(c10.q)), (c10.P, c10.q),
            {"K1": 1, "K4": 1}, c10.q.shape[0]),
        "config 9 box step B=2048 N=24": (
            grad_step(dqt.solve_box_qp_with_stats, c9.cfg, 4, rand_g(c9.q)),
            (c9.P, c9.q, *c9.params), {"K1": 1, "K4": 1}, c9.q.shape[0]),
        "config 9 signed-box step B=2048 N=24": (
            grad_step(dqt.solve_signed_box_qp_with_stats, c9s.cfg, 4, rand_g(c9s.q)),
            (c9s.P, c9s.q, *c9s.params), {"K1": 1, "K4": 1}, c9s.q.shape[0]),
        "config 6 step B=2048 N=96": (grad_step(dqt.solve_qp_with_stats, c6q.cfg, 2),
                                      (c6q.P, c6q.q), {"K1": 1, "K4": 1, **GLUE_STEP},
                                      c6q.q.shape[0]),
        "QCQP step B=2048 N=96": (grad_step(solve_qc, cfg, 4), qc96, {"K1": 1, "K2": 1},
                                  qc96[1].shape[0]),
    }
    # the generic route, duals given: K5 at the flagship, K6 at N=96
    def generic(P_, q_, r_, l_, g_):
        return kkt.qcqp_vjp(P_, q_, r_, l_, g_, cfg, duals=kkt.qcqp_dual(P_, q_, r_, l_, cfg))

    for label, (Pg, qg, lng, mug), want in (("flagship B=4096 N=24", flag, {"K5": 1}),
                                            ("B=2048 N=96", qc96, {"K6": 1})):
        rg = (lng * mug).contiguous()
        lg = dqt.solve_qcqp(Pg, qg, lng, mug, config=cfg)
        paths[f"generic route qcqp_vjp(duals=) at {label}"] = (
            generic, (Pg, qg, rg, lg, (2.0 * lg + rand_g(lg)).contiguous()), want, qg.shape[0])

    # which calls read the device on the host, before any capture
    xs64 = [x[:b_guard].double() for x in flag]
    r64 = xs64[2] * xs64[3]
    l64 = dqt.solve_qcqp(*xs64, config=cfg)
    g64 = 2.0 * l64
    ST64, rhs64, _ = qcqp_system(*xs64[:2], r64, l64, g64, cfg)
    P10, q10 = c10.P[:b_guard], c10.q[:b_guard]
    l10 = dqt.solve_qp(P10, q10, config=c10.cfg)
    K32, rhs32, _ = kkt._qp_kkt_system(P10, q10, l10, 2.0 * l10, c10.cfg)
    x96 = [x[:b_guard].double() for x in qc96]
    r96 = x96[2] * x96[3]
    l96 = dqt.solve_qcqp(*x96, config=cfg)
    d96 = kkt.qcqp_dual(x96[0], x96[1], r96, l96, cfg)
    s96, a96 = kkt.qcqp_strict_active(l96, r96, d96.gamma, cfg)
    free = {name: paths[name] for name in ("flagship QCQP step B=4096 N=24",
                                           "config 10 QP step B=4096 N=24",
                                           "generic route qcqp_vjp(duals=) at flagship B=4096 N=24",
                                           "generic route qcqp_vjp(duals=) at B=2048 N=96")}
    # run eagerly these read the host; under a capture each records a
    # device-side form instead (phase 3o). The LU does not: on the card it is
    # cuSOLVER's without the host's check, eagerly as under a capture
    lu_free = {"_solve_direct's LU (float64 assembled QCQP system)":
               lambda: kkt._solve_direct(ST64, rhs64, cfg)}
    guarded = {
        "the eager engine (float64 flagship forward)": lambda: dqt.solve_qcqp(*xs64, config=cfg),
        "_solve_direct's Cholesky (float64 SPD K of the QP)":
            lambda: kkt._solve_direct(K32.double(), rhs32.double(), c10.cfg, spd=True),
        "_solve_direct's Newton-Schulz inverse (float32 SPD K, backend='xla')":
            lambda: kkt._solve_direct(K32, rhs32, c10.cfg.replace(backend="xla"), spd=True),
        "_qcqp_schur_vjp's Cholesky and LU (float64, N=96)":
            lambda: kkt._qcqp_schur_vjp(x96[0], l96, 2.0 * l96, s96, a96.double(), d96.gamma),
    }
    for fn, xs, _, _ in free.values():
        fn(*xs)                                 # lazy state made before the check
    reads = {label: host_reads(lambda fn=fn, xs=xs: fn(*xs)) for label, (fn, xs, _, _)
             in free.items()}
    reads.update({label: host_reads(fn) for label, fn in lu_free.items()})
    reads_g = {label: host_reads(fn) for label, fn in guarded.items()}
    for label, why in {**reads, **reads_g}.items():
        log(f"  reads the device on the host (set_sync_debug_mode('error')): {label}: "
            f"{why is not None}{'' if why is None else ' (' + why + ')'}")
    if any(why is not None for why in reads.values()):
        raise AssertionError("a route the guard lets into a capture reads the device on the host")
    if any(why is None for why in reads_g.values()):
        raise AssertionError("a route that reads the host eagerly does not")

    # the flagship's and config 6's captures also count G1 and G2
    launches, pairs, staged_steps, glue = {}, [], {}, glue_counters()
    for label, (step, xs, want, problems) in paths.items():
        counters = {**kernels, **glue} if glue.keys() & want.keys() else kernels
        s, launches[label] = staged_check(label, counters, step, xs, want)
        staged_steps[label] = s
        pairs.append((label, lambda step=step, xs=xs: step(*xs), lambda s=s, xs=xs: s(*xs),
                      problems))

    # the flagship's graph, captured at its batch (4096), replayed for
    # batches of b_pads padded to that bucket
    s_flag = staged_steps["flagship QCQP step B=4096 N=24"]
    for b in b_pads:
        padded, info = pad_to_bucket(cuda(*build_problems(b, NC_FLAG)), buckets=(B,))
        d = bit_diffs(s_flag(*padded), flag_step(*padded))
        log(f"  the flagship's graph (bucket {B}) at B={b} padded to {info.padded}: leaves whose "
            f"bits differ from the eager bucketed step: {d}")
        if d or len(s_flag.graphs) != 1:
            raise AssertionError(f"the bucketed replay at B={b} is not the eager step bit for bit")

    # the config-4 system-ID step: forward, backward, capturable Adam
    (S, qs, ln, lm), target = sysid

    def make_sysid():
        params = [x.clone().requires_grad_() for x in (S, qs, ln, lm)]
        opt = torch.optim.Adam(params, lr=1e-2, capturable=True)

        def step(target_):
            opt.zero_grad(set_to_none=True)
            value, _ = sysid_loss(dqt, params, target_, *sysid_cfgs)
            value.backward()
            opt.step()
            return value.detach()
        return params, step

    gram = staged(lambda S_: S_ @ S_.mT)
    for _ in range(WARMUP):
        gram(S)
    cublas_same = torch.equal(gram(S), S @ S.mT)
    log(f"  S S^T (cuBLAS) in a graph replay bit for bit the eager product: {cublas_same}")
    (p_e, step_e), (p_s, step_s) = make_sysid(), make_sysid()
    s_sid = staged(step_s)
    run_e = lambda: step_e(target)    # noqa: E731
    run_s = lambda: s_sid(target)     # noqa: E731
    l_e, l_s, launches["config-4 system-ID step"] = trajectories(
        "config-4 system-ID step", kernels, run_e, run_s, steps,
        {"K1": 2, "K4": 1, "K2": 1})
    held_bit_for_bit("config-4 system-ID step, staged against eager (capturable Adam)",
                     (p_e, l_e), (p_s, l_s), cublas_same)
    traced = kernels_in_trace(run_s)
    log(f"  config-4 system-ID step: a profiled replay runs {traced}")
    if traced != {"K1": 2, "K2": 1, "K4": 1, "K5": 0, "K6": 0, "E1": 0}:
        raise AssertionError(f"the staged system-ID step runs {traced}, not K1 2, K4 1, K2 1")
    pairs.append(("config-4 system-ID step (forward, backward, Adam)", run_e, run_s, 4096))

    # SystemID(kind="qcqp").train_step on config 4's QCQP half, staged by the
    # model itself on the card, against the same model stepped eagerly
    models = [SystemID(kind="qcqp", config=sysid_cfgs[1], learning_rate=1e-2, device="cuda")
              for _ in range(2)]
    for m in models:
        m.set_params(QCQPSystemIDParams(*(x.clone() for x in (S, qs, ln, lm))))
    m_e, m_s = models
    if not (m_s.opt.defaults["capturable"] and m_s._staged_step is not None):
        raise AssertionError("a card SystemID has no capturable Adam or no staged step")
    run_e = lambda: m_e._train_step(target)    # noqa: E731
    run_s = lambda: m_s.train_step(target)     # noqa: E731
    l_e, l_s, launches["SystemID qcqp train_step"] = trajectories(
        "SystemID(kind='qcqp').train_step", kernels, run_e, run_s, steps, {"K1": 1, "K2": 1})
    held_bit_for_bit("SystemID(kind='qcqp').train_step, staged against eager",
                     (list(m_e.params), l_e), (list(m_s.params), l_s), cublas_same)
    pairs.append(("SystemID(kind='qcqp').train_step, config 4's QCQP half", run_e, run_s, 2048))

    # a card model on a capturable route stages its step: a diagonal P (the
    # engine's loop a graph node) and float64 at N=24 (the spectral mode,
    # its set-up E1)
    rng = np.random.default_rng(12)
    for label, kind, diag, dtype in (("diagonal-P QP", "qp", True, torch.float32),
                                     ("float64 QCQP", "qcqp", False, torch.float64)):
        m = SystemID(kind=kind, config=sysid_cfgs[0 if kind == "qp" else 1], learning_rate=5e-2,
                     device="cuda")
        gen = torch.Generator().manual_seed(13)
        if kind == "qp":
            m.init_qp(gen, batch=b_guard, n=2 * NC_FLAG, diag=diag, dtype=dtype)
        else:
            m.init_qcqp(gen, batch=b_guard, nc=NC_FLAG, dtype=dtype)
        tgt = torch.tensor(rng.random((b_guard, 2 * NC_FLAG)) * 0.1, dtype=dtype).cuda()
        losses = [float(m.train_step(tgt)) for _ in range(WARMUP + 3)]
        stage = True
        log(f"  SystemID {label} on the card: staged {m._staged_step is not None}, capturable "
            f"Adam {m.opt.defaults['capturable']} (want {stage}); losses over {len(losses)} steps "
            f"{losses[0]:.6e} -> {losses[-1]:.6e}")
        if ((m._staged_step is not None) != stage or m.opt.defaults["capturable"] != stage
                or not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]):
            raise AssertionError(f"SystemID {label}: staged {m._staged_step is not None}, want "
                                 f"{stage}, or its loss did not fall past the warm-up")
    return launches, pairs


def phase_4n(smi, pairs):
    """Phase 4n: each staged step beside its eager step, both through
    ``timed_step`` (20 back-to-back calls a sample, median of 5; device time
    by kernel, the six largest listed, and the card's idle share), then one
    line each."""
    rows = []
    for label, eager, st, problems in pairs:
        ms_e, idle_e = timed_step(f"{label}, eager", eager, smi, calls=20, problems=problems,
                                  top=6)
        ms_s, idle_s = timed_step(f"{label}, staged (one CUDA graph)", st, smi, calls=20,
                                  problems=problems, top=6)
        rows.append((label, ms_e, idle_e, ms_s, idle_s))
    log(f"  phase 4n ({smi}), ms per step (device ms, card idle):")
    for label, ms_e, idle_e, ms_s, idle_s in rows:
        log(f"    {label}: eager {ms_e:.4f} ({ms_e * (1 - idle_e):.4f}, {idle_e:.1%}), staged "
            f"{ms_s:.4f} ({ms_s * (1 - idle_s):.4f}, {idle_s:.1%}): {ms_e / ms_s:.3f}x")
    return rows


# ---------------------------------------------------------------------------
# The engine's loops on the card: conditional graph nodes (utils/control.py)
# ---------------------------------------------------------------------------

def control_requirements():
    """Phase 1's check of what ``utils/control.py`` records with: the CUDA
    runtime ``graph_loop.cu`` was built against, the driver's and PyTorch's
    (conditional WHILE nodes need 12.4 or later), nvcc's and the driver's
    versions printed, and the private PyTorch APIs it takes (the pool
    routing, a kept graph). Fails before anything else runs if one lacks."""
    from diffqcqp_tpu_torch.kernels import _build
    from diffqcqp_tpu_torch.utils import control

    v = control.versions()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    apis = {name: hasattr(torch._C, name) for name in control.POOL_APIS}
    apis.update({f"CUDAGraph.{m}": hasattr(g, m) for m in ("instantiate", "raw_cuda_graph")})
    log(f"  conditional graph nodes: torch.version.cuda {torch.version.cuda}, nvcc '{nvcc}', driver "
        f"{driver}; versions as integers {v} (need >= {control.MIN_CUDA}); private APIs {apis}")
    if min(v.values()) < control.MIN_CUDA or not all(apis.values()):
        raise AssertionError("this CUDA or PyTorch lacks what conditional graph nodes need")


def within_bars(label, got, ref):
    """The referee bars a staged path is held to where a library routine
    rounds otherwise under capture (printed): integer and bool leaves equal;
    each float leaf per problem (its leading axis) within 1e-4 of the eager
    run's scale (l's bar, max(1, |ref|_inf)), and relative errors median <=
    1e-3, max <= 2e-3 (the gradients' bars; each problem's norm floored at
    1e-6 of the batch's largest)."""
    from torch.utils import _pytree as pytree

    worst_abs = worst_med = worst_max = 0.0
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(ref)):
        if a is None:
            continue
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: an integer or bool output differs under capture")
            continue
        a2, b2 = (x.reshape(x.shape[0] if x.ndim else 1, -1).double() for x in (a, b))
        worst_abs = max(worst_abs, float(per_problem(a2, b2, slice(None)).max()))
        # relative to each problem's norm, floored at 1e-6 of the batch's
        # largest: an all-but-zero gradient row is held to the batch's scale
        floor = torch.clamp_min(1e-6 * b2.norm(dim=1).max(), 1e-30)
        e = rel_err(a2, b2, floor)
        worst_med, worst_max = max(worst_med, float(e.median())), max(worst_max, float(e.max()))
    log(f"    {label}: held to the referee bars instead: per problem max |d| / max(1, |ref|) "
        f"{worst_abs:.3e} (bar 1e-4), relative error median {worst_med:.3e} (bar 1e-3), max "
        f"{worst_max:.3e} (bar 2e-3)")
    if not (worst_abs <= 1e-4 and worst_med <= 1e-3 and worst_max <= 2e-3):
        raise AssertionError(f"{label}: the staged path is off the eager run past the bars")


def staged_loop_check(label, kernels, step, sets, want, whiles, iters=None):
    """Phase 3o's gates of one path staged (``utils.staged``): past the
    warm-up calls the capture records the kernels ``want`` names and no
    other, and ``whiles`` WHILE nodes at the graph's top level; the kept
    graph holds one conditional node for each top-level node recorded
    (``control.node_counts``); each input set of ``sets`` replays the eager
    run bit for bit (else ``within_bars``, printed) with its own eager
    iterations (``iters(out)``), which differ between the sets; a replay
    under ``set_sync_debug_mode("error")`` reads nothing on the host.
    Returns (the staged step, its launches at capture, the label where a
    replay's bits differ, else None)."""
    from diffqcqp_tpu_torch.utils import control
    from diffqcqp_tpu_torch.utils.staging import WARMUP, staged

    s = staged(step)
    for _ in range(WARMUP):
        s(*sets[0])
    _, n_cap = launched(kernels, lambda: s(*sets[0]))
    (key,) = s.graphs
    rec, nodes = s.nodes[key], control.node_counts(s.graphs[key])
    top = {k: v for (k, d), v in rec.items() if d == 0}
    nested = {f"{k}@{d}": v for (k, d), v in sorted(rec.items()) if d > 0}
    iters_seen, excepted = [], None
    for i, xs in enumerate(sets):
        got, ref = s(*xs), step(*xs)
        d = bit_diffs(got, ref)
        it_g, it_r = (None, None) if iters is None else (iters(got), iters(ref))
        same_it = it_g is None or torch.equal(it_g, it_r)
        log(f"  {label}, input set {i}: replay against eager, leaves whose bits differ (max |d|) "
            f"{d}; iterations equal to the eager run's: {same_it}"
            + ("" if it_r is None else f" (mean {float(it_r.double().mean()):.4f})"))
        if d:
            excepted = label
            within_bars(f"{label}, input set {i}", got, ref)
        if not same_it:
            raise AssertionError(f"{label}: the replay's iterations are not the eager run's")
        iters_seen.append(it_r)
    reads = host_reads(lambda: s(*sets[0]))
    log(f"  {label}: launches at capture {n_cap}; conditional nodes recorded {dict(top)} at the "
        f"top level, {nested} nested; the kept graph's top level {nodes}; a replay reads the "
        f"host: {reads}")
    only_launched(f"{label} at capture", n_cap, want)
    if top.get("while", 0) != whiles or nodes["conditional"] != sum(top.values()):
        raise AssertionError(f"{label}: want {whiles} WHILE nodes at the top level, recorded "
                             f"{top}, the graph holds {nodes}")
    if iters is not None and len(sets) > 1:
        same_sets = torch.equal(iters_seen[0], iters_seen[1])
        log(f"  {label}: the input sets' iterations differ: {not same_sets}")
        if same_sets:
            raise AssertionError(f"{label}: the two input sets run the same iterations")
    if reads is not None:
        raise AssertionError(f"{label}: a replay reads the device on the host: {reads}")
    return s, n_cap, excepted


def phase_3o(dqt, kernels, cfg, qp_cfg, rollouts, b_past=256, b_trace=4096, steps=20):
    """Phase 3o: the engine's loops as conditional graph nodes
    (``utils/control.py``), each path staged through ``staged_loop_check``:
    the config-11 rollout warm and cold at full size; the contact system-ID
    step (``make_system_id_step``, staged by the module) against the same
    Adam(capturable=True) step run eagerly over ``steps`` steps; the
    diagonal-P flagship step; the QCQP at n=170 and the QP at N=176 past
    K1's bound; the float64 QCQP step at N=96 (the Cholesky-inverse mode);
    the generic route's float64 LU (``qcqp_vjp(duals=)`` at the flagship's
    size) and Cholesky (the QP's assembled SPD system); ``qcqp_jacobian`` at
    the flagship (K1 inside); ``trace_qcqp``, 64 iterations at the flagship
    in the inverse mode (``linsolve='chol'``). The spectral mode stages in
    phase 3p, the lockstep mode in phase 3q. Every replay is its eager run bit for bit, the LU paths
    included (cuSOLVER's LU eagerly too). Returns [(label, eager step,
    staged step, problems, conditional nodes)] for phase 4o."""
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.models import contact_sim as cs

    (params, state0, f), (params2, state2, f2) = rollouts
    T, B = f.shape[:2]
    flag = cuda(*build_problems(B_FLAG, NC_FLAG))
    flag2 = cuda(*build_problems(B_FLAG, NC_FLAG, seed=1))
    solve_qc, solve_qp = dqt.solve_qcqp_with_stats, dqt.solve_qp_with_stats
    st_iters = lambda out: out[1].iterations                      # noqa: E731
    roll_iters = lambda out: torch.stack([out[2]["qp_iters"], out[2]["qcqp_iters"]])  # noqa: E731
    diag = lambda xs: [torch.diagonal(xs[0], dim1=1, dim2=2).contiguous(), *xs[1:]]  # noqa: E731
    paths, pairs, excepted = {}, [], []

    for warm in (True, False):
        def roll(mass, mu, x0, v0, f_, warm=warm):
            return cs.simulate(cs.ContactParams(mass, mu), cs.ContactState(x0, v0), f_,
                               warm_start=warm, return_stats=True)
        paths[f"config-11 rollout B={B} T={T} warm_start={warm}"] = (
            roll, [(*params, *state0, f), (*params2, *state2, f2)], {}, 2 * T, roll_iters, B * T)
    paths["diagonal-P flagship QCQP step B=4096 N=24"] = (
        grad_step(solve_qc, cfg, 4), [diag(flag), diag(flag2)], {}, 1, st_iters, B_FLAG)
    k170 = [cuda(*kkt_problems(b_past, 85, seed=s_)) for s_ in (16, 18)]
    paths[f"QCQP step B={b_past} n=170 (past K1)"] = (
        grad_step(solve_qc, cfg, 4), [(P_, q_, r_, torch.ones_like(r_)) for P_, q_, _, r_ in k170],
        {}, 3, st_iters, b_past)
    q176 = [cuda(*spd_problems(b_past, 176, seed=s_)[1:]) for s_ in (17, 19)]
    paths[f"QP step B={b_past} N=176 (past K1)"] = (
        grad_step(solve_qp, qp_cfg, 2), q176, {}, 3, st_iters, b_past)
    f96 = [tuple(x.double() for x in cuda(*build_problems(b_past, 48, seed=s_))) for s_ in (6, 7)]
    paths[f"float64 QCQP step B={b_past} N=96 (Cholesky inverse)"] = (
        grad_step(solve_qc, cfg, 4), f96, {}, 1, st_iters, b_past)

    def generic_lu(P_, q_, ln_, mu_, l_, g_):
        r_ = ln_ * mu_
        return kkt.qcqp_vjp(P_, q_, r_, l_, g_, cfg, duals=kkt.qcqp_dual(P_, q_, r_, l_, cfg))

    def generic_chol(P_, q_, l_, g_):
        return kkt._qp_assembled_vjp(P_, q_, l_, g_, qp_cfg)

    lu_sets, chol_sets = [], []
    for xs in (flag, flag2):
        x64 = [x.double() for x in xs]
        l64 = dqt.solve_qcqp(*x64[:4], config=cfg.replace(linsolve="chol"))
        lu_sets.append((*x64, l64, 2.0 * l64 + 1.0))
        lq = dqt.solve_qp(*x64[:2], config=qp_cfg.replace(linsolve="chol"))
        chol_sets.append((*x64[:2], lq, 2.0 * lq + 1.0))
    paths["generic route float64 LU, qcqp_vjp(duals=) B=4096 N=24"] = (
        generic_lu, lu_sets, {}, 0, None, B_FLAG)
    paths["generic route float64 Cholesky, the QP's SPD system B=4096 N=24"] = (
        generic_chol, chol_sets, {}, 0, None, B_FLAG)
    paths["qcqp_jacobian B=4096 N=24, l solved inside (K1)"] = (
        lambda *xs: dqt.qcqp_jacobian(*xs, config=cfg), [flag, flag2], {"K1": 1}, 0, None,
        B_FLAG)
    tcfg = cfg.replace(linsolve="chol")
    small = [[x[:b_trace] for x in xs] for xs in (flag, flag2)]
    paths[f"trace_qcqp 64 iterations B={b_trace} N=24, linsolve='chol'"] = (
        lambda *xs: dqt.debug.trace_qcqp(*xs, iters=64, config=tcfg), small, {}, 1,
        lambda tr: tr.iterations, b_trace)

    for label, (step, sets, want, whiles, iters, problems) in paths.items():
        s, _, exc = staged_loop_check(label, kernels, step, sets, want, whiles, iters)
        if exc is not None:
            excepted.append(exc)
        pairs.append((label, lambda step=step, xs=sets[0]: step(*xs),
                      lambda s=s, xs=sets[0]: s(*xs), problems, sum(next(iter(s.nodes.values()))
                                                                   .values())))

    # the contact system-ID step: the module stages it on the card; its twin
    # here runs the same Adam(capturable=True) step eagerly
    _, traj = cs.simulate(params, state0, f)
    target = traj.x.detach()

    def raw():
        return {"log_mass": torch.zeros(B, device=f.device, requires_grad=True),
                "logit_mu": torch.zeros(B, device=f.device, requires_grad=True)}

    raw_e, raw_s = raw(), raw()
    opt = torch.optim.Adam(list(raw_e.values()), lr=0.05, capturable=True)

    def eager_step():
        opt.zero_grad(set_to_none=True)
        loss = cs.trajectory_loss(cs.ContactParams(torch.exp(raw_e["log_mass"]),
                                                   torch.sigmoid(raw_e["logit_mu"])),
                                  state0, f, target)
        loss.backward()
        opt.step()
        return loss.detach()

    staged_step, _ = cs.make_system_id_step(raw_s, state0, f, target, learning_rate=0.05)
    label = f"contact system-ID step B={B} T={T} (rollout, backward, Adam)"
    l_e, l_s, _ = trajectories(label, kernels, eager_step, staged_step, steps, {})
    held_bit_for_bit(f"{label}, staged against eager over {steps} steps",
                     (list(raw_e.values()), l_e), (list(raw_s.values()), l_s), True)
    (key,) = staged_step.staged.graphs
    rec = staged_step.staged.nodes[key]
    log(f"  {label}: conditional nodes recorded {dict(rec)}, the kept graph's top level "
        f"{control_nodes(staged_step.staged.graphs[key])}")
    if rec.get(("while", 0), 0) != 2 * T:
        raise AssertionError(f"{label}: want {2 * T} WHILE nodes at the top level, got {rec}")
    reads = host_reads(staged_step)
    log(f"  {label}: a replay reads the host: {reads}")
    if reads is not None:
        raise AssertionError(f"{label}: a replay reads the device on the host")
    pairs.append((label, eager_step, staged_step, B, sum(rec.values())))

    # cuSOLVER's LU runs eagerly too (ops/linalg.py::solve): every path is
    # its eager run bit for bit, the LU paths included
    log(f"  paths whose replay is not the eager run bit for bit: {excepted or 'none'}")
    if excepted:
        raise AssertionError(f"replays not the eager run bit for bit: {excepted}")
    return pairs


def control_nodes(graph):
    from diffqcqp_tpu_torch.utils import control

    return control.node_counts(graph)


def phase_4o(smi, pairs, calls=None, expect=None):
    """Phase 4o: each path of phase 3o eagerly and staged, in turn, through
    ``timed_step`` (CUDA events, median of 3 samples; device time and the
    card's idle share), one back-to-back call a sample for the rollouts and
    the contact system-ID step (a second each eagerly), 5 for the others;
    then a line each. torch.profiler does not count the kernels inside a
    conditional node's body (a graph the card launches itself) reliably:
    for the same staged rollout it gave 21.4 ms in one run and 183.5 ms,
    more than the wall time, in another. Where the staged graph holds
    nodes, it is timed and printed by its wall time alone: its device time
    and idle share are not measured. ``calls`` sets the calls a sample for every
    path (phase 4p: 1); ``expect`` names a kernel every path launches
    (phase 4p: E1, ``timed_step``)."""
    rows = []
    for label, eager, st, problems, nodes in pairs:
        slow = "rollout" in label or "contact system-ID" in label
        kw = dict(reps=3, calls=calls or (1 if slow else 5), problems=problems, expect=expect)
        ms_e, idle_e = timed_step(f"{label}, eager", eager, smi, **kw)
        ms_s, idle_s = timed_step(f"{label}, staged (one CUDA graph)", st, smi, **kw,
                                  device=not nodes)
        rows.append((label, ms_e, idle_e, ms_s, idle_s, nodes))
    log(f"  phase 4o ({smi}), ms per call (device ms, card idle):")
    for label, ms_e, idle_e, ms_s, idle_s, nodes in rows:
        staged_dev = (f"{nodes} conditional nodes: device time and idle not measured" if nodes
                      else f"{ms_s * (1 - idle_s):.4f}, {idle_s:.1%}")
        log(f"    {label}: eager {ms_e:.4f} ({ms_e * (1 - idle_e):.4f}, {idle_e:.1%}), staged "
            f"{ms_s:.4f} ({staged_dev}): {ms_e / ms_s:.3f}x")
    return rows


# ---------------------------------------------------------------------------
# The spectral mode's eigendecomposition on the card: the Jacobi kernel E1
# ---------------------------------------------------------------------------

FP64_FLOPS = 34e12         # H100 SXM data sheet, float64 outside the tensor cores


def e1_bound_ms(B, n, dtype, rotations):
    """Least time of an E1 call on an H100 SXM: the larger of the bytes (P
    read once, V and the eigenvalues written once) over the memory rate and
    the operations this run's data needs over the dtype's peak (float32 67
    TFLOP/s, float64 34 TFLOP/s outside the tensor cores): the Jacobi
    rotations the plain version applies on the same P (``rotations``), 12 N
    flops each, the least a rotation needs: rows p and q of V^T and of A, 6
    N each, A's columns p and q being its rows by symmetry (the kernel
    rotates them too, 18 N). Returns (ms, what bounds it, bytes, FLOPs)."""
    f64 = dtype == torch.float64
    return bound_ms((8 if f64 else 4) * B * (2 * n * n + n), 12.0 * n * float(rotations.sum()),
                    FP64_FLOPS if f64 else FP32_FLOPS)


# E1's plans checked in phase 1: one warp (N <= 32) against block-wide (33),
# and either side of each shared-memory bound: A and V^T (float64 119 / 120,
# float32 169 / 170), A alone (float64 169 / 170, float32 239 / 240)
E1_PLAN_NS = (2, 24, 32, 33, 48, 119, 120, 130, 169, 170, 239, 240)
# phase 2p's points either side of E1's shared-memory bounds: A and V^T
# there to float64 N = 119 and float32 169, A alone to 169 and 239
E1_EDGES = ((torch.float64, (119, 120, 169, 170)), (torch.float32, (169, 170, 239, 240)))
# eigh_cuda's layouts (SHARED, VT_GLOBAL, GLOBAL)
E1_LAYOUTS = ("A and V^T in shared memory", "A in shared memory, V^T in the workspace",
              "A and V^T in the workspace")


def k1_occupancy(sms, ptxas, gate=True):
    """Phase 1: K1's launch plan (instance, problems a block, threads, shared
    memory) at n = 1-169 as the wrapper and the built library compute it
    (fails where they differ); for each one-warp instance its registers and
    spills (``ptxas``, ptxas_summary's line) and problems an SM by the
    occupancy calculator, with the waves at the main path's batches (the
    flagship's B=4096 at N=24, config 5's B=65,536 at N=8); the same past
    one warp at ``K1_BLOCK_NS``, with the waves at B=2048; fails if the
    flagship's instance spills or holds too few problems an SM for B=4096 in
    one wave, or a block-wide register instance spills (with ``gate``; else
    it says so). A port without ``launch_plan`` (before the one-warp
    instances) prints its blocks an SM alone. Returns {n: problems an SM}."""
    from diffqcqp_tpu_torch.kernels import admm_cuda as k1m

    per_sm = {}
    if not hasattr(k1m, "launch_plan"):
        for n in (8, 16, 24, 32):
            per_sm[n] = k1m.c_blocks_per_sm(n)
        log(f"  K1 blocks (one problem each) an SM: {per_sm}")
        return per_sm
    plans = {n: (k1m.launch_plan(n), k1m.c_launch_plan(n)) for n in range(1, 170)}
    log("  K1 launch plans (instance, problems a block, threads, smem bytes), wrapper = "
        "library: " + ", ".join(f"n={n} {py}{'' if py == c else f' != {c}'}"
                                for n, (py, c) in plans.items()
                                if n <= 33 or n in K1_BLOCK_EDGE_NS + K1_BLOCK_NS))
    if any(py != c for py, c in plans.values()):
        raise AssertionError("K1's launch plan disagrees with the library's")

    def faults(what):
        if gate:
            raise AssertionError(what)
        log(f"  {what}")

    for n, b in ((8, 65536), (16, 4096), (24, B_FLAG), (32, 4096)):
        inst, probs = plans[n][0][:2]
        per_sm[n] = probs * k1m.c_blocks_per_sm(n)
        m = re.search(rf"admm_kernel_warp\[{inst},\d+,\d+\]: (\d+) registers, (\d+) bytes", ptxas)
        regs, spill = (m.group(1), m.group(2)) if m else ("?", "?")
        log(f"  K1 one-warp instance {inst} ({probs} problem(s) a warp): {regs} registers, "
            f"{spill} bytes spilled; {per_sm[n]} problems an SM (occupancy calculator); "
            f"B={b} N={n}: {-(-b // max(per_sm[n] * sms, 1))} wave(s)")
        if n == 24 and (spill != "0" or per_sm[n] * sms < B_FLAG):
            faults("K1's flagship instance spills or takes more than one wave at B=4096")
    for n in K1_BLOCK_NS:
        inst, probs, threads, smem = plans[n][0]
        per_sm[n] = probs * k1m.c_blocks_per_sm(n)
        name = rf"admm_kernel_rows\[{inst},\d+\]" if inst else "admm_kernel"
        m = re.search(rf"(?:^|\| ){name}: (\d+) registers, (\d+) bytes", ptxas)
        regs, spill = (m.group(1), m.group(2)) if m else ("?", "?")
        log(f"  K1 block-wide at n={n}: instance {inst} ({threads} threads, {smem} bytes of "
            f"shared memory), {regs} registers, {spill} bytes spilled; {per_sm[n]} blocks an SM "
            f"(occupancy calculator); B=2048: {-(-2048 // max(per_sm[n] * sms, 1))} wave(s)")
        if inst and spill != "0":
            faults(f"K1's block-wide register instance {inst} spills")
    return per_sm


def e1_occupancy(sms):
    """Phase 1: E1's launch plan at the main path's points (problems a block,
    threads, shared memory, where A and V^T sit), blocks and problems an SM
    by the plan's own count and by the occupancy calculator, and the waves
    at that point's batch. Fails if the calculator holds fewer problems an
    SM than the plan counts on."""
    from diffqcqp_tpu_torch.kernels import eigh_cuda as e1m

    short = []
    for B, n in ((4096, 24), (2048, 32), (2048, 33), (2048, 48), (256, 130)):
        for dt in (torch.float32, torch.float64):
            pl = e1m.launch_plan(n, dt)
            per_sm = pl.problems * e1m.c_blocks_per_sm(n, dt)
            planned = e1m.planned_problems_per_sm(n, dt)
            log(f"  E1 plan N={n} {str(dt)[6:]}: {'one warp' if pl.warp else 'block-wide'}, "
                f"{pl.problems} problem(s) a block of {pl.threads} threads, {pl.smem} bytes of "
                f"shared memory, {E1_LAYOUTS[pl.layout]}; "
                f"problems an SM {per_sm} (occupancy calculator; the plan counts on {planned}), "
                f"B={B}: {-(-B // max(per_sm * sms, 1))} wave(s)")
            if per_sm < 1 or (planned is not None and per_sm < planned):
                short.append((n, dt))
    if short:
        raise AssertionError(f"E1's occupancy falls short of its plan at {short}")


def with_spectrum(lams, b, seed):
    """Q diag(lams) Q^T, float64 numpy, for a random orthogonal Q a problem."""
    rng = np.random.default_rng(seed)
    n = len(lams)
    Q = np.linalg.qr(rng.standard_normal((b, n, n)))[0]
    P = Q @ (np.asarray(lams, dtype=np.float64)[None, :, None] * Q.transpose(0, 2, 1))
    return 0.5 * (P + P.transpose(0, 2, 1))


def eigh_points(P_flag):
    """Phase 2p's points: the flagship's P (B=4096 N=24) in float32 and as the
    float64 referee takes it; B=256 at N = 2, 7, 32 (the largest one-warp
    size), 33 (the smallest block-wide one), 48 and 130 in both dtypes;
    B=32 on either side of each shared-memory bound (``E1_EDGES``);
    repeated eigenvalues and a diagonal dense P (float64 and float32, B=256
    N=24); the flagship's first 256 P with a NaN in problem 3 and an inf in
    problem 7."""
    from diffqcqp_tpu_torch.kernels.eigh_cuda import launch_plan

    pts = [("flagship B=4096 N=24 float32", P_flag),
           ("the float64 referee's P, flagship B=4096 N=24 float64", P_flag.double())]
    for n in (2, 7, 32, 33, 48, 130):
        P = cuda(spd_problems(256, n, seed=20 + n)[1])[0]
        pts += [(f"B=256 N={n} float64", P.double()), (f"B=256 N={n} float32", P)]
    for dt, ns in E1_EDGES:
        for n in ns:
            P = cuda(spd_problems(32, n, seed=20 + n)[1])[0].to(dt)
            pts.append((f"B=32 N={n} {str(dt)[6:]} ({E1_LAYOUTS[launch_plan(n, dt).layout]})", P))
    rep = cuda(with_spectrum([1.0] * 6 + [2.0] * 6 + [0.5] * 6 + list(np.linspace(3, 4, 6)),
                             256, 21))[0]
    diag = torch.diag_embed(cuda(np.random.default_rng(22).random((256, 24)) + 0.1)[0])
    for label, P in (("repeated eigenvalues B=256 N=24", rep), ("diagonal dense P B=256 N=24",
                                                               diag)):
        pts += [(f"{label} float64", P), (f"{label} float32", P.float())]
    bad = P_flag[:256].clone()
    bad[3, 2, 5] = float("nan")
    bad[7, 0, 0] = float("inf")
    pts.append(("flagship's first 256 P, a NaN in problem 3 and an inf in problem 7", bad))
    return pts


def phase_2p(points):
    """Phase 2p: E1 (``eigh_cuda``) against its plain version
    (``jacobi_eigh_plain``) on the same card inputs, at each point of
    ``points`` ([(label, P)]): the sweeps a problem (max, mean), the problems
    whose eigenvalues, eigenvectors and sweeps are the plain version's bit
    for bit (gated: every problem), max |d lam| and |d V| against it (gated:
    0, as the two round alike under -fmad=false), and both outputs' residuals
    against ``torch.linalg.eigh`` of the same P in float64 (on the host's
    LAPACK), with u the dtype's unit roundoff: ||V diag(lam) V^T - P||_F /
    ||P||_F <= 50 N u, max |V^T V - I| <= 50 N u, |lam - lam_eigh| <= 50 N u
    ||P||_2; the eigenvalues ascending; a problem with a non-finite P all
    NaN, the others finite. Returns ({label: max |d| against the plain
    version}, {label: the plain version's rotations a problem})."""
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda, jacobi_eigh_plain

    errs, rotations = {}, {}
    for label, P in points:
        B, n, _ = P.shape
        bar = 50 * n * torch.finfo(P.dtype).eps / 2
        wk, Vk, sk = eigh_cuda(P, stats=True)
        wp, Vp, sp, rot = jacobi_eigh_plain(P, stats=True)
        torch.cuda.synchronize()
        same = lambda a, b: (a == b) | (torch.isnan(a) & torch.isnan(b))   # noqa: E731
        bits = int((same(wk, wp).all(1) & same(Vk, Vp).flatten(1).all(1) & (sk == sp)).sum())
        fin = torch.isfinite(P).flatten(1).all(1)
        nan_ok = (bool(torch.isnan(wk[~fin]).all() and torch.isnan(Vk[~fin]).all())
                  and bool(torch.isfinite(wk[fin]).all() and torch.isfinite(Vk[fin]).all()))
        d = max(float((wk[fin].double() - wp[fin].double()).abs().max()),
                float((Vk[fin].double() - Vp[fin].double()).abs().max()))
        P64 = P[fin].double().cpu()
        w_ref = torch.linalg.eigh(P64)[0]
        norm2 = w_ref.abs().amax(dim=1)
        eye = torch.eye(n, dtype=torch.float64)

        def resid(w, V):
            w, V = w[fin].double().cpu(), V[fin].double().cpu()
            r = (torch.linalg.matrix_norm(V @ (w[:, :, None] * V.mT) - P64)
                 / torch.linalg.matrix_norm(P64))
            return (float(r.max()), float((V.mT @ V - eye).abs().max()),
                    float(((w - w_ref).abs().amax(dim=1) / norm2).max()))

        rk, rp = resid(wk, Vk), resid(wp, Vp)
        asc = bool((wk[fin][:, 1:] >= wk[fin][:, :-1]).all())
        log(f"  E1 {label}: sweeps a problem max {int(sk.max())} mean "
            f"{float(sk[fin].double().mean()):.3f}; problems bit for bit the plain version's "
            f"{bits}/{B}; max |d| against it {d:.3e}; against torch.linalg.eigh (bar 50 N u = "
            f"{bar:.3e}): kernel residual {rk[0]:.3e}, orthogonality {rk[1]:.3e}, |d lam| / "
            f"||P||_2 {rk[2]:.3e}; plain {rp[0]:.3e}, {rp[1]:.3e}, {rp[2]:.3e}; ascending "
            f"{asc}; non-finite problems all NaN, the rest finite: {nan_ok}")
        if not (bits == B and d == 0.0 and all(x <= bar for x in rk + rp) and asc and nan_ok):
            raise AssertionError(f"E1 at {label} is past its bars")
        errs[label], rotations[label] = d, rot
    return errs, rotations


def spectral_bars(label, l, iters, ok, l64, k1, bar64=1e-4):
    """Phase 3p's accuracy gates of one path's solution ``l`` (its
    iterations ``iters``) on the problems it converged (``ok``): within
    ``bar64`` of the float64 referee ``l64``, and against K1 on the same
    problems (``k1`` = (l, stats, iterations bar)) |dl| <= 1e-4 with the
    iterations within the bar (None: printed only)."""
    l = l.detach()
    e64 = float((l[ok].double() - l64[ok]).abs().max())
    lk, sk, it_bar = k1
    dk = float((l[ok].double() - lk[ok].double()).abs().max())
    dit = int((iters - sk.iterations).abs().max())
    log(f"    {label}: converged {int(ok.sum())}/{ok.numel()}; max |l - l_f64 referee| {e64:.3e} "
        f"(bar {bar64:g}); against K1 max |dl| {dk:.3e} (bar 1e-4), max |d iterations| {dit} "
        f"(bar {it_bar}); mean iterations {float(iters.double().mean()):.4f} (K1 "
        f"{float(sk.iterations.double().mean()):.4f})")
    if not (e64 <= bar64 and dk <= 1e-4 and (it_bar is None or dit <= it_bar)):
        raise AssertionError(f"{label}: past the referee or K1 bars")


@contextlib.contextmanager
def eigh_spy():
    """Count the calls of ``torch.linalg.eigh`` inside the block (a list of
    one int), the port's included."""
    calls = [0]
    real = torch.linalg.eigh

    def spy(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    torch.linalg.eigh = spy
    try:
        yield calls
    finally:
        torch.linalg.eigh = real


def phase_3p(dqt, kernels, cfg, flag, out_k, l64, sysid, qc_cfg, b_past=256, steps=20):
    """Phase 3p: the spectral mode's routes staged (``utils.staged``), its
    set-up the Jacobi kernel E1: the float64 flagship step (B=4096 N=24,
    ``grad_step``), the ``backend='xla'`` flagship step (L by power
    iteration, as K1), an ``accel`` flagship forward (``accel=True,
    adaptive_rho=False, alpha_relax=1.0``), ``trace_qcqp`` at the flagship
    (64 iterations, the default ``linsolve``), a float64
    ``SystemID(kind="qcqp")`` at config 4's QCQP half (B=2048 N=24, 20 Adam
    steps, staged by the model against the same model stepped eagerly) and
    ``linsolve='spectral'`` at B=256 N=130 in float64 (``kkt_problems``).
    Each eagerly: E1 once a solve, ``torch.linalg.eigh`` never (a spy);
    staged through ``staged_loop_check`` on the inputs and on q + 1e-5 (q +
    1e-3 at N=130): the
    capture records the eager step's launches (E1 among them), the replay
    is the eager run bit for bit with its iterations, reads nothing on the
    host; each solution, on the problems it converged, within 1e-4 of the
    float64 referee (the plain K1 in float64 at eps=1e-10) and of K1 on the
    same problems, the iterations within 4 of K1's where both estimate L by
    power iteration (the ``backend='xla'`` step), printed elsewhere; a
    float64 flagship solve at the referee's eps beside it, every one of its
    4096 problems converged and within 1e-8 of the referee (phase 3e's bar
    for the float64 route, there on 256 problems). Returns [(label,
    eager, staged, problems, conditional nodes)] for phase 4p and the
    float64 flagship step's eager launches (the kernels line's E1 count)."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import PROX_DISK, admm_solve_cuda, admm_solve_plain
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda
    from diffqcqp_tpu_torch.models.system_id import (
        QCQPSystemIDParams, SystemID, qcqp_params_to_problem,
    )

    kern = {**kernels, "E1": eigh_cuda}
    P, q, l_n, mu = flag
    flag64 = tuple(x.double() for x in flag)
    perturb = lambda xs, h=1e-5: [xs[0], xs[1] + h, *xs[2:]]          # noqa: E731
    solve_qc = dqt.solve_qcqp_with_stats
    st_iters = lambda out: out[1].iterations                          # noqa: E731
    k1_flag = (out_k[0], out_k[1], None)
    whole = lambda out: (out[0], out[1])                              # noqa: E731
    paths = {      # label: (step, sets, iterations, (l, stats), referee, K1, problems)
        "float64 flagship step B=4096 N=24": (
            grad_step(solve_qc, cfg, 4), [flag64, perturb(flag64)], st_iters, whole, l64,
            k1_flag, B_FLAG),
        "backend='xla' flagship step B=4096 N=24 (L by power iteration, as K1)": (
            grad_step(solve_qc, cfg.replace(backend="xla", lmax_method="power"), 4),
            [flag, perturb(flag)], st_iters, whole, l64, (out_k[0], out_k[1], 4), B_FLAG),
        "accel flagship forward B=4096 N=24": (
            lambda *xs: solve_qc(*xs, config=cfg.replace(accel=True, adaptive_rho=False,
                                                         alpha_relax=1.0)),
            [flag, perturb(flag)], st_iters, whole, l64, k1_flag, B_FLAG),
        "trace_qcqp 64 iterations B=4096 N=24, the default linsolve": (
            lambda *xs: dqt.debug.trace_qcqp(*xs, iters=64, config=cfg), [flag, perturb(flag)],
            lambda tr: tr.iterations, None, l64, k1_flag, B_FLAG),
    }
    P130, q130, _, r130 = (x.double() for x in cuda(*kkt_problems(b_past, 65, seed=23)))
    x130 = (P130, q130, r130, torch.ones_like(r130))
    l130_64 = admm_solve_plain(P130, q130, torch.zeros_like(q130), PROX_DISK, (r130,),
                               cfg.replace(eps=1e-10, max_iter=5000), True, False)[0]
    k130 = admm_solve_cuda(*(x.float().contiguous() for x in (P130, q130)),
                           torch.zeros_like(q130).float(), PROX_DISK, (r130.float().contiguous(),),
                           cfg, True, False)
    # at N=130, q + 1e-5 runs the same iterations (an H100 run): q + 1e-3
    # moves them on ~20 of the 256 problems
    paths[f"linsolve='spectral' step B={b_past} N=130 float64 (E1: V^T in the workspace)"] = (
        grad_step(solve_qc, cfg.replace(linsolve="spectral"), 4), [x130, perturb(x130, 1e-3)],
        st_iters, whole, l130_64, (k130[0], k130[1], None), b_past)

    pairs = []
    for label, (step, sets, iters, sol, ref, k1, problems) in paths.items():
        t0 = time.perf_counter()
        with eigh_spy() as calls:
            out, n_e = launched(kern, lambda: step(*sets[0]))
        log(f"  {label}: eagerly launches {n_e}; torch.linalg.eigh called {calls[0]} times")
        if n_e["E1"] != 1 or calls[0]:
            raise AssertionError(f"{label}: E1 not once a solve eagerly, or torch.linalg.eigh "
                                 "called")
        if label.startswith("float64 flagship step"):
            launches_f64 = n_e
        with eigh_spy() as calls:
            s, _, exc = staged_loop_check(label, kern, step, sets, n_e, 0 if sol is None else 1,
                                          iters)
        if exc is not None or calls[0]:
            raise AssertionError(f"{label}: the replay is not the eager run bit for bit, or "
                                 "torch.linalg.eigh called")
        if sol is None:          # the trace: its l2 on the problems it converged
            spectral_bars(label, out.l2, out.iterations, out.converged, ref, k1)
        else:
            l_, st_ = sol(out)
            spectral_bars(label, l_, st_.iterations, st_.converged, ref, k1)
        pairs.append((label, lambda step=step, xs=sets[0]: step(*xs),
                      lambda s=s, xs=sets[0]: s(*xs), problems,
                      sum(next(iter(s.nodes.values())).values())))
        log(f"  {label}: checks took {time.perf_counter() - t0:.1f} s")

    # the float64 flagship at the referee's own eps, over the whole batch,
    # gated at phase 3e's bar (1e-8 there on 256 problems; here all 4096
    # converged and within 1e-8), E1 its set-up
    t0 = time.perf_counter()
    l_f64, st_f64 = solve_qc(*flag64, config=cfg.replace(eps=1e-10, max_iter=5000))
    label = "float64 flagship solve at eps=1e-10 (the referee's eps), B=4096"
    spectral_bars(label, l_f64, st_f64.iterations, st_f64.converged, l64, k1_flag, bar64=1e-8)
    if not bool(st_f64.converged.all()):
        raise AssertionError(f"{label}: not every problem converged")

    # a float64 SystemID on config 4's QCQP half: staged by the model, against
    # the same model stepped eagerly
    (S, qs, ln, lm), target = sysid
    tgt = target.double()
    label = "float64 SystemID(kind='qcqp').train_step, config 4's QCQP half B=2048 N=24"

    def model():
        m = SystemID(kind="qcqp", config=qc_cfg, learning_rate=1e-2, device="cuda")
        m.set_params(QCQPSystemIDParams(*(x.double().clone() for x in (S, qs, ln, lm))))
        return m

    probe, m_e, m_s = model(), model(), model()
    if not (m_s.opt.defaults["capturable"] and m_s._staged_step is not None):
        raise AssertionError(f"{label}: no capturable Adam or no staged step")
    with torch.no_grad():
        P0, q0, ln0, mu0 = qcqp_params_to_problem(probe.params)
        l0, st0 = solve_qc(P0, q0, ln0, mu0, config=qc_cfg)
        r0 = ln0 * mu0
        l0_64 = admm_solve_plain(P0, q0, torch.zeros_like(q0), PROX_DISK, (r0,),
                                 qc_cfg.replace(eps=1e-10, max_iter=5000), True, False)[0]
        k0 = admm_solve_cuda(P0.float(), q0.float(), torch.zeros_like(q0).float(), PROX_DISK,
                             (r0.float(),), qc_cfg, True, False)
    spectral_bars(f"{label}, the first step's solve", l0, st0.iterations, st0.converged, l0_64,
                  (k0[0], k0[1], None))
    log(f"  the eps=1e-10 solve and the system-ID referees took {time.perf_counter() - t0:.1f} s")
    with eigh_spy() as calls:
        _, n_e = launched(kern, lambda: probe._train_step(tgt))
        run_e = lambda: m_e._train_step(tgt)    # noqa: E731
        run_s = lambda: m_s.train_step(tgt)     # noqa: E731
        l_e, l_s, _ = trajectories(label, kern, run_e, run_s, steps, n_e)
    log(f"  {label}: eagerly launches {n_e} a step; torch.linalg.eigh called {calls[0]} times")
    if n_e["E1"] != 1 or calls[0]:
        raise AssertionError(f"{label}: E1 not once a step eagerly, or torch.linalg.eigh called")
    held_bit_for_bit(f"{label}, staged against eager over {steps} steps",
                     (list(m_e.params), l_e), (list(m_s.params), l_s), True)
    (key,) = m_s._staged_step.graphs
    rec = m_s._staged_step.nodes[key]
    reads = host_reads(run_s)
    log(f"  {label}: conditional nodes recorded {dict(rec)}, the kept graph's top level "
        f"{control_nodes(m_s._staged_step.graphs[key])}; a replay reads the host: {reads}")
    if rec.get(("while", 0), 0) != 1 or reads is not None:
        raise AssertionError(f"{label}: want 1 WHILE node and no host read, got {rec}, {reads}")
    pairs.append((label, run_e, run_s, 2048, sum(rec.values())))
    return pairs, launches_f64


def phase_4p(smi, pairs, P_flag, rotations, dev):
    """Phase 4p: each path of phase 3p eagerly and staged (``phase_4o``'s
    timing; where an eager path's trace holds no E1, its line says so); then
    E1 alone (``e1_times``) at ``e1_points``, with the rotations of phase
    2p's plain run at the flagship and the device times ``dev`` of
    ``e1_device_times``. Returns the float64 flagship point's numbers for
    the kernels line."""
    phase_4o(smi, pairs, calls=1, expect="E1")
    out = {label: e1_times(label, P, rot, smi, dev[label])
           for label, P, rot in e1_points(P_flag, rotations)}
    return out["B=4096 N=24 float64"]


def e1_device_times(P_flag):
    """{label: E1's device ms per launch} at each of ``e1_points`` from
    torch.profiler (10 launches), taken right after phase 2p: later in the
    run, past its first CUDA graphs and many profiler sessions, the
    profiler holds no device activity for short sessions (PERF.md §7); None
    where the trace holds no E1 there either."""
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda

    out = {label: per_launch_ms(device_time_by_kernel(lambda P=P: eigh_cuda(P)), "jacobi_eigh")
           for label, P, _ in e1_points(P_flag)}
    log(f"  E1's device time per launch (torch.profiler, ms): {out}")
    return out


def e1_points(P_flag, rotations=(None, None)):
    """E1's timed points: the flagship's P (B=4096 N=24) in float32 and
    float64 (with phase 2p's rotations where given), B=2048 N=48 in both
    and the ``linsolve='spectral'`` step's P at B=256 N=130 in float64
    (phase 3p's, V^T in the workspace): [(label, P, rotations or None)]."""
    P48 = cuda(spd_problems(2048, 48, seed=24)[1])[0]
    P130 = cuda(*kkt_problems(256, 65, seed=23))[0].double()
    return [("B=4096 N=24 float32", P_flag, rotations[0]),
            ("B=4096 N=24 float64", P_flag.double(), rotations[1]),
            ("B=2048 N=48 float32", P48, None), ("B=2048 N=48 float64", P48.double(), None),
            ("B=256 N=130 float64", P130, None)]


def e1_times(label, P, rot, smi, dev):
    """E1's numbers at one point: its device time per launch ``dev``
    (torch.profiler, ``e1_device_times``) and per call over 20 back-to-back
    calls (CUDA events),
    its plain version's time (one call), its bound (``e1_bound_ms`` with
    ``rot``, the plain version's rotations a problem, or this call's plain
    run's where None) and ``torch.linalg.eigh`` of the same P (CUDA events;
    at N=48 one call, and at N=48 in float32 what one call launches on the
    first 256 problems: ``launch_profile``). Returns dict(ms, plain_ms,
    bound_ms, bound_by, library_ms): ``ms`` the profiler's device time, or
    the CUDA events' time where the trace holds no E1 (logged so)."""
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda, jacobi_eigh_plain

    B, n, _ = P.shape
    t0 = time.perf_counter()
    rot_ = jacobi_eigh_plain(P, stats=True)[3]
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    rot = rot_ if rot is None else rot
    if dev is None:
        log(f"  E1 at {label}: the profiler's trace held no E1: its ms is the CUDA events' time")
    ev, ts = time_cuda(lambda: eigh_cuda(P), reps=5, calls=20)
    # at N=48 torch.linalg.eigh takes ~1.5 s a call: one timed call
    lib_calls, lib_reps = (20, 3) if n <= 24 else (1, 1)
    ms_lib, ts_lib = time_cuda(lambda: torch.linalg.eigh(P), reps=lib_reps, calls=lib_calls)
    b_, b_by, b_bytes, b_flops = e1_bound_ms(B, n, P.dtype, rot)
    log(f"  E1 at {label} ({smi}): device time per launch (torch.profiler) "
        f"{'not in the trace' if dev is None else f'{dev:.4f} ms'}; per call, 20 "
        f"back-to-back (CUDA events) {ev:.4f} ms (samples {[round(t, 4) for t in ts]}); "
        f"plain version {ms_p:.1f} ms (one call); bound {b_:.5f} ms ({b_by}: {b_bytes} "
        f"bytes, {b_flops:.4g} FLOP, {float(rot.double().mean()):.1f} rotations a problem); "
        f"torch.linalg.eigh {ms_lib:.4f} ms per call ({lib_calls} a sample, samples "
        f"{[round(t, 3) for t in ts_lib]})")
    if label == "B=2048 N=48 float32":
        # what one call launches, on the first 256 problems (the profiler
        # holds ~18 launches of each batched-Jacobi kernel a problem)
        P256 = P[:256].contiguous()
        launch_profile("torch.linalg.eigh B=256 N=48 float32", lambda: torch.linalg.eigh(P256),
                       top=6)
    return dict(ms=dev if dev is not None else ev, plain_ms=ms_p, bound_ms=b_, bound_by=b_by,
                library_ms=ms_lib)


def eigh_run(dqt, smi, t_start) -> int:
    """``python3 chip_smoke.py eigh``: after phase 1, phases 2p, 3p and 4p
    alone; no result line."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import PROX_DISK, admm_solve_cuda, admm_solve_plain

    cfg = flagship_cfg(dqt)
    flag = cuda(*build_problems(B_FLAG, NC_FLAG))
    P, q, l_n, mu = flag
    log("phase 2p: E1 (eigh_cuda) against jacobi_eigh_plain on the card")
    _, rotations = phase_2p(eigh_points(P))
    e1_dev = e1_device_times(P)
    log(f"  phase 2p done at {time.perf_counter() - t_start:.1f} s")
    args = (P, q, torch.zeros_like(q), PROX_DISK, ((l_n * mu).contiguous(),), cfg, True, False)
    out_k = admm_solve_cuda(*args)
    # the referee as phase 3 takes it: the radii l_n mu formed in float64,
    # as the float64 routes form them
    l64, _ = admm_solve_plain(*(x.double() for x in args[:3]), PROX_DISK,
                              (l_n.double() * mu.double(),), cfg.replace(eps=1e-10, max_iter=5000),
                              True, False)
    log("phase 3p: the spectral mode's routes staged, E1 their set-up")
    log(f"  the referee done at {time.perf_counter() - t_start:.1f} s")
    pairs, _ = phase_3p(dqt, kernels_by_name(), cfg, flag, out_k, l64, sysid_inputs(),
                        sysid_configs(dqt)[1])
    log(f"  phase 3p done at {time.perf_counter() - t_start:.1f} s")
    log("phase 4p: the spectral routes eagerly and staged, E1 and torch.linalg.eigh")
    phase_4p(smi, pairs, P, (rotations["flagship B=4096 N=24 float32"],
                             rotations["the float64 referee's P, flagship B=4096 N=24 float64"]),
             e1_dev)
    log(f"chip_smoke: eigh phases passed, {time.perf_counter() - t_start:.1f} s")
    return 0


# ---------------------------------------------------------------------------
# The lockstep mode staged: one loop over every shard of the process
# (parallel/sharding.py::Lockstep), its done flag's MIN a device op;
# phases 3q and 4q, and two NCCL ranks a card each
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def all_reduce_spy():
    """Count ``torch.distributed.all_reduce`` calls in the block: [made
    eagerly, recorded in a CUDA graph capture]."""
    import torch.distributed as dist

    calls = [0, 0]
    inner = dist.all_reduce

    def spy(t, *a, **kw):
        calls[1 if torch.cuda.is_current_stream_capturing() else 0] += 1
        return inner(t, *a, **kw)

    dist.all_reduce = spy
    try:
        yield calls
    finally:
        dist.all_reduce = inner


def lockstep_check(label, kern, solve, own, sets, cfg, n_diff, mesh, want):
    """Phase 3q's gates of one lockstep step (``solve``, a ``solve_*_sharded``,
    with ``lockstep=True`` on ``mesh``, then the gradient of sum(l^2) for its
    first ``n_diff`` inputs): eagerly on each input set, exactly the kernels
    ``want`` names (E1 and K2 or K4 once a shard), the joint loop's steps the
    batch's slowest problem's iterations over every shard, and l and stats
    bit for bit each shard's own ``backend='xla'`` solve (``own``); the two
    sets' loops run different iteration counts; then staged through
    ``staged_loop_check``: the same kernels at capture, one WHILE node at
    the graph's top level, the replay the eager step bit for bit on both
    sets, no host read in a replay. Returns (eager step, staged step, the
    conditional nodes recorded)."""
    step = grad_step(lambda *a, config: solve(*a, mesh=mesh, config=config, lockstep=True),
                     cfg, n_diff)
    k, slowest = len(mesh.devices), []
    for i, xs in enumerate(sets):
        with lockstep_rounds() as rounds:
            (l, st, _), n_e = launched(kern, lambda: step(*xs))
        log(f"  {label}, input set {i}: eagerly launches {n_e}")
        only_launched(f"{label}, eagerly", n_e, want)
        h = xs[1].shape[0] // k
        halves = [own(*(x[j * h:(j + 1) * h] for x in xs), config=cfg.replace(backend="xla"))
                  for j in range(k)]
        slowest.append(int(st.iterations.max()))
        in_rounds(f"{label}, input set {i}", rounds, k, slowest[-1],
                  [int(sh.iterations.max()) for _, sh in halves])
        st_own = type(st)(*(torch.cat([sh[f] for _, sh in halves]) for f in range(len(st))))
        l_agree(f"{label}, input set {i}: eager lockstep vs each shard's own backend='xla' "
                "solve", l.detach(), torch.cat([lh for lh, _ in halves]), 0.0, st, st_own)
    log(f"  {label}: the joint loop's iterations on the two input sets {slowest}")
    if slowest[0] == slowest[1]:
        raise AssertionError(f"{label}: the two input sets' loops run the same iterations")
    st_iters = lambda out: out[1].iterations        # noqa: E731
    s, _, exc = staged_loop_check(label, kern, step, sets, want, 1, st_iters)
    if exc is not None:
        raise AssertionError(f"{label}: the replay is not the eager step bit for bit")
    return (lambda: step(*sets[0])), (lambda: s(*sets[0])), sum(next(iter(s.nodes.values()))
                                                                 .values())


def phase_3q(dqt, kernels, cfg, qp_cfg, b=B_FLAG):
    """Phase 3q: the lockstep mode staged (``utils.staged``), each shard's
    loop one loop of the process, one WHILE node. Needs a one-rank NCCL
    process group (``lockstep_phases`` makes it). Through ``lockstep_check``
    on two shards of cuda:0 (a mesh without a group): the flagship QCQP step
    (B=4096, bench.py's generator at seeds 0 and 1, its config) and config
    10's QP step (seeds 10 and 11); the flagship forward alone (E1 once a
    shard, no kernel else; phase 4g's lockstep path before the joint loop).
    Then the flagship step over the NCCL group (``make_batch_mesh`` takes the world group): its
    ``all_reduce`` recorded once, in the loop's body, the replay bit for
    bit its eager run and the step without a group. Then the refusals a
    capture keeps, each printing its reason: a mesh over cuda:0 and the
    CPU, and a gloo group. Returns [(label, eager, staged, problems,
    conditional nodes)] for phase 4q."""
    import torch.distributed as dist

    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda
    from diffqcqp_tpu_torch.parallel import (
        BatchMesh, make_batch_mesh, solve_qcqp_sharded, solve_qp_sharded,
    )

    kern = {**kernels, "E1": eigh_cuda}
    card = torch.device("cuda:0")
    mesh = BatchMesh((card, card), "batch")
    flag_sets = [cuda(*build_problems(b, NC_FLAG, seed=s_)) for s_ in (0, 1)]
    qp_sets = [cuda(*spd_problems(b, 24, seed=s_)[1:]) for s_ in (10, 11)]
    label_f = f"two-shard lockstep flagship QCQP step B={b}"
    pairs = []
    for label, solve, own, sets, c, n_diff, want in (
            (label_f, solve_qcqp_sharded, dqt.solve_qcqp_with_stats, flag_sets, cfg, 4,
             {"K2": 2, "E1": 2}),
            (f"two-shard lockstep config-10 QP step B={b}", solve_qp_sharded,
             dqt.solve_qp_with_stats, qp_sets, qp_cfg, 2, {"K4": 2, "E1": 2})):
        t0 = time.perf_counter()
        eager, staged_step, nodes = lockstep_check(label, kern, solve, own, sets, c, n_diff,
                                                   mesh, want)
        pairs.append((label, eager, staged_step, b, nodes))
        log(f"  {label}: checks took {time.perf_counter() - t0:.1f} s")

    # the forward alone, as phase 4g timed it before the joint loop
    label = f"two-shard lockstep flagship forward B={b}"
    fwd = lambda *xs: solve_qcqp_sharded(*xs, mesh=mesh, config=cfg, lockstep=True)  # noqa: E731
    s_fwd, _, exc = staged_loop_check(label, kern, fwd, flag_sets, {"E1": 2}, 1,
                                      lambda out: out[1].iterations)
    if exc is not None:
        raise AssertionError(f"{label}: the replay is not the eager forward bit for bit")
    pairs.append((label, lambda: fwd(*flag_sets[0]), lambda: s_fwd(*flag_sets[0]), b, 1))

    # the same step over the one-rank NCCL group: the done flag's all_reduce
    # recorded in the WHILE node's body
    gmesh = make_batch_mesh([card, card])
    backend = dist.get_backend(gmesh.group)
    label = f"two-shard lockstep flagship QCQP step B={b}, {backend} group of one rank"
    gstep = grad_step(lambda *a, config: solve_qcqp_sharded(*a, mesh=gmesh, config=config,
                                                            lockstep=True), cfg, 4)
    with all_reduce_spy() as ar:
        s_g, _, exc = staged_loop_check(label, kern, gstep, flag_sets, {"K2": 2, "E1": 2}, 1,
                                        lambda out: out[1].iterations)
    d_nogroup = bit_diffs(s_g(*flag_sets[0]), pairs[0][2]())
    log(f"  {label}: all_reduce calls eagerly {ar[0]}, recorded in the capture {ar[1]}; the "
        f"replay against the staged step without a group, leaves whose bits differ: "
        f"{d_nogroup}")
    if backend != "nccl" or exc is not None or ar[1] != 1 or d_nogroup:
        raise AssertionError(f"{label}: want an NCCL group, its all_reduce recorded once and "
                             "the replay bit for bit the eager step and the step without a "
                             "group")
    pairs.append((label, lambda: gstep(*flag_sets[0]), lambda: s_g(*flag_sets[0]), b, 1))

    # what a capture refuses, each with its reason
    small = [x[:256] for x in flag_sets[0]]
    refused_under_capture("two-shard lockstep over cuda:0 and the CPU", lambda: solve_qcqp_sharded(
        *small, mesh=make_batch_mesh([card, "cpu"]), config=cfg, lockstep=True))
    gloo = BatchMesh(gmesh.devices, gmesh.axis_name, dist.new_group(backend="gloo"))
    refused_under_capture("two-shard lockstep over a gloo group", lambda: solve_qcqp_sharded(
        *small, mesh=gloo, config=cfg, lockstep=True))
    return pairs


def phase_4q(smi, pairs):
    """Phase 4q: each path of phase 3q eagerly, then staged, through
    ``timed_step`` (CUDA events, median of 5 samples of one call; the eager
    path's device time and idle share by torch.profiler, each path
    launching E1; the staged graph holds a WHILE node, whose kernels the
    profiler does not count reliably: its wall time alone)."""
    rows = []
    for label, eager, st, problems, nodes in pairs:
        ms_e, idle_e = timed_step(f"{label}, eager", eager, smi, reps=5, problems=problems,
                                  expect="E1")
        ms_s, _ = timed_step(f"{label}, staged (one CUDA graph)", st, smi, reps=5,
                             problems=problems, device=False)
        rows.append((label, ms_e, idle_e, ms_s, nodes))
    log(f"  phase 4q ({smi}), ms per call (eager device ms, card idle):")
    for label, ms_e, idle_e, ms_s, nodes in rows:
        log(f"    {label}: eager {ms_e:.4f} ({ms_e * (1 - idle_e):.4f}, {idle_e:.1%}), staged "
            f"{ms_s:.4f} ({nodes} conditional node: device time and idle not measured): "
            f"{ms_e / ms_s:.3f}x")
    return rows


def lockstep_phases(dqt, kernels, smi, t_start):
    """Phases 3q and 4q inside a one-rank NCCL process group on a free
    loopback port, destroyed after."""
    import torch.distributed as dist

    from diffqcqp_tpu_torch.parallel import initialize_distributed

    port = free_port()
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                           process_id=0)
    try:
        log(f"phase 3q: the lockstep mode staged, one loop over every shard (process group "
            f"{dist.get_backend()} of {dist.get_world_size()} rank on port {port})")
        pairs = phase_3q(dqt, kernels, flagship_cfg(dqt), qp_families(dqt)["qp"].cfg)
        log(f"  phase 3q done at {time.perf_counter() - t_start:.1f} s")
        log("phase 4q: each path of phase 3q eagerly and staged")
        phase_4q(smi, pairs)
        log(f"  phase 4q done at {time.perf_counter() - t_start:.1f} s")
    finally:
        dist.destroy_process_group()


def host_ms(fn, reps=5):
    """Median host-clock milliseconds of ``fn`` then a synchronisation,
    after one warm-up call (examples_torch/sharded_batch.py's ``_ms``)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def lockstep_rank(rank, world, port, b_global):
    """One rank of ``lockstep_ranks`` (its own process and card): config 5's
    problems (``sharded_example_problems``, B=65,536 over the ranks, N=8,
    eps=1e-7, max_iter=1000), this rank's slice solved through
    ``global_batch_mesh()``: collective-free (K1) and lockstep, eagerly.
    Gates: the joint loop's steps the global batch's slowest problem's
    iterations, one all-reduce a step; a capture of the lockstep solve
    refused with the guard's error naming NCCL across ranks (an NCCL
    all-reduce inside a WHILE node's body fails to record across ranks).
    Prints one line of times (the host clock, as
    ``examples_torch/sharded_batch.py`` times, and CUDA events; median of
    5)."""
    torch.cuda.set_device(rank)
    import torch.distributed as dist

    import diffqcqp_tpu_torch as dqt
    from diffqcqp_tpu_torch.parallel import (
        global_batch_mesh, initialize_distributed, shard_host_local_batch, solve_qcqp_sharded,
    )

    initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                           process_id=rank)
    try:
        mesh = global_batch_mesh()
        h = b_global // world
        local = [shard_host_local_batch(x[rank * h:(rank + 1) * h], mesh)
                 for x in sharded_example_problems(b_global)]
        cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=1000)
        fwd = lambda: solve_qcqp_sharded(*local, mesh=mesh, config=cfg, lockstep=True)  # noqa: E731
        free = lambda: solve_qcqp_sharded(*local, mesh=mesh, config=cfg)  # noqa: E731
        with lockstep_rounds() as rounds, all_reduce_spy() as ar:
            l_e, st_e = fwd()
        slowest = st_e.iterations.max().to(torch.int64)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        refused_under_capture(f"rank {rank}: the lockstep forward over an NCCL group of {world} "
                              "ranks", fwd)
        out = {"rank": rank, "card": torch.cuda.current_device(), "local_batch": h,
               "joint_steps": len(rounds), "global_slowest": int(slowest),
               "all_reduce_eager": ar[0], "converged": bool(st_e.converged.all()),
               "max_abs_dl_vs_free": float((l_e - free()[0]).abs().max()),
               "host_ms": {"free": host_ms(free), "lockstep_eager": host_ms(fwd)},
               "event_ms": {"free": time_cuda(free, reps=5)[0],
                            "lockstep_eager": time_cuda(fwd, reps=5)[0]}}
        print(f"    rank {rank}: " + json.dumps(out), flush=True)
        if not (len(rounds) == int(slowest) == ar[0] and out["converged"]):
            raise AssertionError(f"rank {rank}: the cross-rank lockstep solve failed its gates")
    finally:
        dist.destroy_process_group()


def lockstep_ranks(smi, world=2, b_global=65536, limit_s=300):
    """Two NCCL ranks, one card each, spawned with torch.multiprocessing:
    ``lockstep_rank`` on each (config 5's size), within ``limit_s``
    seconds or both are killed and the run fails."""
    import torch.multiprocessing as mp

    log(f"  two NCCL ranks, one card each ({smi}), config 5's size: B={b_global} over the "
        f"ranks, N=8, the lockstep forward eagerly; a capture of it refused")
    ctx = mp.start_processes(lockstep_rank, args=(world, free_port(), b_global), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + limit_s
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the {world} NCCL ranks did not finish in {limit_s} s")


def lockstep_run(dqt, smi, t_start) -> int:
    """``python3 chip_smoke.py lockstep``: after phase 1, phases 3q and 4q
    alone; where the machine shows two cards or more, two NCCL ranks a card
    each (``lockstep_ranks``); no result line."""
    lockstep_phases(dqt, kernels_by_name(), smi, t_start)
    if torch.cuda.device_count() >= 2:
        lockstep_ranks(smi)
    else:
        log(f"  two NCCL ranks, one card each: not run (this machine shows "
            f"{torch.cuda.device_count()} card)")
    log(f"chip_smoke: lockstep phases passed, {time.perf_counter() - t_start:.1f} s")
    return 0


def flagship_cfg(dqt):
    """bench.py's flagship configuration."""
    return dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0, power_iters=10,
                                     rho_update_period=24)


def sysid_configs(dqt):
    """Config 4's QP and QCQP configurations (the production schedule)."""
    return (
        dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0, rho_update_period=24),
        dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0, rho_update_period=24,
                                  power_iters=10),
    )


def qp_families(dqt):
    """The three QP-family classes at their benchmark points: config 10's QP
    (B=4096, N=24, seed 10) and config 9's box and signed box (B=2048,
    N=24, seed 9, ``box_bounds``)."""
    qp_cfg10 = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0,
                                       rho_update_period=24, power_iters=10)
    box_cfg9 = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=2000)
    _, P10, q10 = spd_problems(4096, 24, seed=10)
    rng9, P9, q9 = spd_problems(2048, 24, seed=9)
    lo9, hi9, v9 = cuda(*box_bounds(rng9, *q9.shape))
    P10, q10, P9, q9 = cuda(P10, q10, P9, q9)
    return {
        "qp": qp_class("qp", P10, q10, qp_cfg10),
        "box_qp": qp_class("box_qp", P9, q9, box_cfg9, lo9, hi9),
        "signed_box_qp": qp_class("signed_box_qp", P9, q9, box_cfg9, lo9, hi9, v9),
    }


# the kernels line's entries: key, name, source, the TPU kernel it replaces
KERNEL_ENTRIES = (
    ("K1", "admm_solve_cuda (K1: an explicit inverse and one refined solve per iteration; at "
           "N <= 32 one warp, the inverse's row in registers; numbers at the flagship, B=4096 "
           "N=24)",
     "diffqcqp_tpu_torch/kernels/csrc/admm.cu", "diffqcqp_tpu/kernels/admm_pallas.py:78"),
    ("K2", "qcqp_kkt_bwd_fused_cuda (K2, with the K3 LDL^T helpers inlined)",
     "diffqcqp_tpu_torch/kernels/csrc/qcqp_bwd.cu", "diffqcqp_tpu/kernels/qcqp_bwd_pallas.py:200"),
    ("K4", "coord_kkt_bwd_fused_cuda (K4, with the K3 LDL^T helpers inlined; numbers at the QP "
           "point, B=4096 N=24)",
     "diffqcqp_tpu_torch/kernels/csrc/coord_bwd.cu", "diffqcqp_tpu/kernels/coord_bwd_pallas.py:55"),
    ("K4bw", "coord_kkt_bwd_fused_cuda, block-wide path (K4 at n > 32: the free block "
             "compacted, factored by register tiles; numbers at config 6, B=2048 N=96)",
     "diffqcqp_tpu_torch/kernels/csrc/coord_bwd.cu", "diffqcqp_tpu/kernels/coord_bwd_pallas.py:55"),
    ("K5", "qr_solve_cuda (K5; numbers at the QCQP flagship's assembled system, B=4096 m=36)",
     "diffqcqp_tpu_torch/kernels/csrc/qr_solve.cu", "diffqcqp_tpu/kernels/qr_solve_pallas.py:43"),
    ("K6", "qcqp_kkt_bwd_cuda (K6, K2's steps 4-8 with the duals given; numbers at B=2048 N=96)",
     "diffqcqp_tpu_torch/kernels/csrc/qcqp_bwd.cu", "diffqcqp_tpu/kernels/qcqp_bwd_pallas.py:44"),
    ("E1", "eigh_cuda (E1: the spectral mode's batched Jacobi eigendecomposition; numbers at "
           "the float64 flagship, B=4096 N=24)",
     "diffqcqp_tpu_torch/kernels/csrc/jacobi_eigh.cu",
     "diffqcqp_tpu/ops/linalg.py:63 (jnp.linalg.eigh; XLA, no Pallas kernel)"),
)


def kernels_line(launches, errs, times):
    """The kernels line: for each of ``KERNEL_ENTRIES`` its launches on
    the main path (``launches[key]``), its
    max |d| against its plain version and its numbers (``times[key]``: ms,
    plain_ms, bound_ms, bound_by, library_ms)."""
    return json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[key], "max_abs_err": errs[key], **times[key]}
        for key, name, src, rep in KERNEL_ENTRIES]})


def k1_k2_times(P, q, radius, cfg, out_k, factors, smi):
    """K1's and K2's numbers in the kernels line at the flagship point, the
    one function that both phase 4 and ``chip_smoke.py staged`` take them
    from: each by the profiler's device time per launch (back to back the
    wrappers' host work outlasts K2 and, since its one-warp redesign, K1;
    CUDA events where the trace lacks it), with the main path's
    cotangent g = 2 l; their plain versions' times; the bounds from this
    run's counts (``factors``, the plain K1's) and K2's strictly active
    contacts; K2's library call, ``torch.linalg.solve`` of the same adjoint
    system assembled in float32 (the dual recovery not included). Returns
    {"K1": ..., "K2": ...}, each dict(ms, plain_ms, bound_ms, bound_by,
    library_ms)."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import PROX_DISK, admm_solve_cuda, admm_solve_plain
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import (
        qcqp_kkt_bwd_fused_cuda, qcqp_kkt_bwd_fused_plain,
    )

    B, n = q.shape
    args = (P, q, torch.zeros_like(q), PROX_DISK, (radius,), cfg, True, False)
    dev_k = per_launch_ms(device_time_by_kernel(lambda: admm_solve_cuda(*args)), "admm_kernel")
    ev_k, ts_k = time_cuda(lambda: admm_solve_cuda(*args), reps=5, calls=20)
    ms_p, ts_p = time_cuda(lambda: admm_solve_plain(*args), reps=3)
    b1, b1_by, b1_bytes, b1_flops = k1_bound_ms(B, n, n // 2, out_k[1].iterations, factors,
                                                cfg.power_iters)
    lk = out_k[0]
    a2 = (P, q, lk, (2.0 * lk).contiguous(), radius, cfg.eps, cfg.act_eps,
          8.0 * torch.finfo(torch.float32).eps)
    k2 = lambda: qcqp_kkt_bwd_fused_cuda(*a2)   # noqa: E731
    dev_k2 = per_launch_ms(device_time_by_kernel(k2), "qcqp_bwd_kernel")
    ev_k2, ts_k2 = time_cuda(k2, reps=5, calls=20)
    ms_p2, ts_p2 = time_cuda(lambda: qcqp_kkt_bwd_fused_plain(*a2), reps=3)
    active = k2()[0] != 0
    b2, b2_by, b2_bytes, b2_flops = k2_bound_ms(B, n, n // 2, active)
    ST, rhs, _ = qcqp_system(P, q, radius, lk, a2[3], cfg)
    ST, rhs = ST.contiguous(), rhs[..., None].contiguous()
    ms_lib, ts_lib = time_cuda(lambda: torch.linalg.solve(ST, rhs), reps=5, calls=20)
    fmt = lambda x: "not in the trace" if x is None else f"{x:.4f} ms"  # noqa: E731
    samples = lambda ts, d=4: [round(t, d) for t in ts]  # noqa: E731
    log(f"  K1 at B={B} N={n} ({smi}): device time per launch (torch.profiler) {fmt(dev_k)}; per "
        f"call, 20 back-to-back (CUDA events) {ev_k:.4f} ms "
        f"(samples {samples(ts_k)}); plain version {ms_p:.2f} ms (samples {samples(ts_p, 2)}); "
        f"bound {b1:.5f} ms ({b1_by}: {b1_bytes} bytes, {b1_flops:.4g} FLOP)\n"
        f"  K2 at B={B} N={n}: device time per launch (torch.profiler) {fmt(dev_k2)}; per "
        f"call, 20 back-to-back (CUDA events) {ev_k2:.4f} ms (samples {samples(ts_k2)}); plain "
        f"version {ms_p2:.2f} ms (samples {samples(ts_p2, 2)}); bound {b2:.5f} ms ({b2_by}: "
        f"{b2_bytes} bytes, {b2_flops:.4g} FLOP; {int(active.sum())} strictly active "
        f"contacts); torch.linalg.solve of the assembled float32 system (B, {ST.shape[-1]}, "
        f"{ST.shape[-1]}) {ms_lib:.4f} ms (samples {samples(ts_lib)})")
    return {"K1": dict(ms=dev_k if dev_k is not None else ev_k, plain_ms=ms_p, bound_ms=b1,
                       bound_by=b1_by, library_ms=None),
            "K2": dict(ms=dev_k2 if dev_k2 is not None else ev_k2, plain_ms=ms_p2,
                       bound_ms=b2, bound_by=b2_by, library_ms=ms_lib)}


def kernel_numbers(dqt, flag, cfg, c10, c6q, qc96, step10, step6, smi):
    """The kernels line's numbers at the main path's points, for
    ``chip_smoke.py staged``: K1 and K2 at the flagship against their plain
    versions (``compare``, ``compare_k2``) and their numbers by
    ``k1_k2_times``, as phase 4 takes them; K4 at config 10 and at config 6
    (``phase_2c``, ``phase_4c``, which also times the class's eager step
    ``step10`` / ``step6``); K5 at the flagship's assembled system
    (``phase_2d``, ``phase_4d``); K6 at B=2048 N=96 (``phase_2e``,
    ``phase_4e``). Returns (errs, times) keyed as ``KERNEL_ENTRIES``."""
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.kernels.admm_cuda import PROX_DISK, admm_solve_cuda, admm_solve_plain
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import (
        qcqp_kkt_bwd_fused_cuda, qcqp_kkt_bwd_fused_plain,
    )

    P, q, l_n, mu = flag
    radius = (l_n * mu).contiguous()
    args = (P, q, torch.zeros_like(q), PROX_DISK, (radius,), cfg, True, False)
    out_k = admm_solve_cuda(*args)
    factors = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    errs = {"K1": compare("K1 flagship B=4096 N=24 disk", out_k,
                          admm_solve_plain(*args, factors=factors))}
    lk = out_k[0]
    ulps = 8.0 * torch.finfo(torch.float32).eps
    a2 = (P, q, lk, (2.0 * lk).contiguous(), radius, cfg.eps, cfg.act_eps, ulps)
    errs["K2"] = compare_k2("K2 flagship B=4096 N=24 g=2l", qcqp_kkt_bwd_fused_cuda(*a2),
                            qcqp_kkt_bwd_fused_plain(*a2),
                            qcqp_kkt_bwd_fused_plain(*(x.double() for x in a2[:5]), *a2[5:]))
    times = k1_k2_times(P, q, radius, cfg, out_k, factors, smi)
    ST, rhs, _ = qcqp_system(P, q, radius, lk, a2[3], cfg)
    ST, rhs = ST.contiguous(), rhs.contiguous()
    for key, label, c, step in (("K4", "qp B=4096 N=24 (config 10)", c10, step10),
                                ("K4bw", "qp B=2048 N=96 (config 6)", c6q, step6)):
        errs[key] = phase_2c([(label, c)], rand_g)
        times[key] = phase_4c(c, step, smi)
    k5 = [("QCQP flagship B=4096 N=24", ST, rhs)]
    errs["K5"] = phase_2d(k5)[k5[0][0]]
    times["K5"] = phase_4d(k5, smi)[k5[0][0]]
    P48, q48, ln48, mu48 = qc96
    r48 = (ln48 * mu48).contiguous()
    l48 = dqt.solve_qcqp(*qc96, config=cfg)
    errs["K6"] = phase_2e([("B=2048 N=96", (P48, q48, l48, r48))], rand_g, cfg)
    g48 = (2.0 * l48).contiguous()
    duals = kkt.qcqp_dual(P48, q48, r48, l48, cfg)
    s48, act48 = kkt.qcqp_strict_active(l48, r48, duals.gamma, cfg)
    ST6, rhs6, _ = qcqp_system(P48, q48, r48, l48, g48, cfg)
    times["K6"] = phase_4e([("B=2048 N=96", (P48, l48, g48, duals.gamma, s48, act48),
                             (P48, q48, l48, g48, r48, cfg.eps, cfg.act_eps, ulps),
                             (ST6.contiguous(), rhs6.contiguous()))], smi)
    return errs, times


def e1_numbers(dqt, flag, cfg, smi):
    """E1's entry in the kernels line for ``chip_smoke.py staged``, at the
    float64 flagship as the whole run takes it: its launches in one eager
    float64 flagship step, max |d| against its plain version (``phase_2p``
    at that point, gated) and its numbers (``e1_times``)."""
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda

    label = "the float64 referee's P, flagship B=4096 N=24 float64"
    flag64 = tuple(x.double() for x in flag)
    errs, rotations = phase_2p([(label, flag64[0])])
    dev = per_launch_ms(device_time_by_kernel(lambda: eigh_cuda(flag64[0])), "jacobi_eigh")
    _, n_e = launched({"E1": eigh_cuda},
                      lambda: grad_step(dqt.solve_qcqp_with_stats, cfg, 4)(*flag64))
    return n_e["E1"], errs[label], e1_times("B=4096 N=24 float64", flag64[0], rotations[label],
                                            smi, dev)


def kernels_by_name():
    """{K: the wrapper whose ``launches`` counts that kernel}."""
    from diffqcqp_tpu_torch.kernels.admm_cuda import admm_solve_cuda
    from diffqcqp_tpu_torch.kernels.coord_bwd_cuda import coord_kkt_bwd_fused_cuda
    from diffqcqp_tpu_torch.kernels.qcqp_bwd_cuda import qcqp_kkt_bwd_cuda, qcqp_kkt_bwd_fused_cuda
    from diffqcqp_tpu_torch.kernels.qr_solve_cuda import qr_solve_cuda

    return {"K1": admm_solve_cuda, "K2": qcqp_kkt_bwd_fused_cuda, "K4": coord_kkt_bwd_fused_cuda,
            "K5": qr_solve_cuda, "K6": qcqp_kkt_bwd_cuda}


def staged_run(dqt, c6, smi, dev_name, t_start) -> int:
    """``python3 chip_smoke.py staged``: after phase 1, phases 3n and 4n
    alone, then the kernels line (its launches read at the staged steps'
    captures, E1's in an eager float64 flagship step; its numbers from
    ``kernel_numbers`` and ``e1_numbers``) and the result line."""
    kernels = kernels_by_name()
    cfg = flagship_cfg(dqt)
    flag = cuda(*build_problems(B_FLAG, NC_FLAG))
    families = qp_families(dqt)
    qc96 = cuda(*build_problems(2048, 48, seed=6))
    log("phase 3n: the steps staged as one CUDA graph each (utils.staged)")
    launches, pairs = phase_3n(dqt, kernels, flag, cfg, families, c6, qc96, sysid_inputs(),
                               sysid_configs(dqt))
    log("phase 4n: each staged step beside its eager step")
    phase_4n(smi, pairs)
    eager = {label: fn for label, fn, _, _ in pairs}
    log("the kernels line's numbers at the main path's points")
    errs, times = kernel_numbers(dqt, flag, cfg, families["qp"], c6["qp"], qc96,
                                 eager["config 10 QP step B=4096 N=24"],
                                 eager["config 6 step B=2048 N=96"], smi)
    flag_n, qp_n = launches["flagship QCQP step B=4096 N=24"], launches["config 10 QP step B=4096 N=24"]
    n_e1, errs["E1"], times["E1"] = e1_numbers(dqt, flag, cfg, smi)
    log(f"chip_smoke: staged phases passed, {time.perf_counter() - t_start:.1f} s")
    print(kernels_line(
        {"K1": flag_n["K1"], "K2": flag_n["K2"], "K4": qp_n["K4"],
         "K4bw": launches["config 6 step B=2048 N=96"]["K4"],
         "K5": launches["generic route qcqp_vjp(duals=) at flagship B=4096 N=24"]["K5"],
         "K6": launches["generic route qcqp_vjp(duals=) at B=2048 N=96"]["K6"], "E1": n_e1},
        errs, times), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def eager_run(root) -> int:
    """``python3 chip_smoke.py eager ROOT``: the port found at ROOT (a
    checkout, such as the parent commit's unpacked beside this one) times
    the engine's eager paths: the config-11 rollout (B=2048, T=50, warm
    start; median of 3), the diagonal-P flagship step (B=4096), the QP step
    at N=176, the QCQP step at n=170 and the float64 QCQP step at N=96
    (B=256), the spectral mode's float64 and ``backend='xla'`` flagship
    steps and ``backend='xla'`` flagship forward (B=4096), the generic
    route's float64 LU (``qcqp_vjp(duals=)`` at B=4096 N=24),
    ``qcqp_jacobian`` at the flagship, ``ops.linalg.solve`` alone on
    random systems of each shape those paths hand it and E1 alone at
    ``e1_points`` (median of 5 samples of 5 calls, 20 for E1 at N=24),
    CUDA events, and what one call asks of the card
    (``launch_profile``). Prints one JSON line; run it for two trees in
    turn (A, B, B, A) to compare them on one card."""
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import diffqcqp_tpu_torch as dqt
    from diffqcqp_tpu_torch.diff import kkt
    from diffqcqp_tpu_torch.kernels import _build
    from diffqcqp_tpu_torch.kernels.eigh_cuda import eigh_cuda
    from diffqcqp_tpu_torch.models import contact_sim as cs
    from diffqcqp_tpu_torch.ops.linalg import solve

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build(list(_build.SOURCES))
    cfg = flagship_cfg(dqt)
    params, state0, f = rollout_inputs()
    P, q, l_n, mu = cuda(*build_problems(B_FLAG, NC_FLAG))
    diag = (torch.diagonal(P, dim1=1, dim2=2).contiguous(), q, l_n, mu)
    f96 = tuple(x.double() for x in cuda(*build_problems(256, 48, seed=6)))
    q176 = cuda(*spd_problems(256, 176, seed=17)[1:])
    qp_cfg = qp_families(dqt)["qp"].cfg
    x64 = [x.double() for x in (P, q, l_n, mu)]
    r64 = x64[2] * x64[3]
    l64 = dqt.solve_qcqp(*x64, config=cfg.replace(linsolve="chol"))
    g64 = 2.0 * l64 + 1.0
    P170, q170, _, r170 = cuda(*kkt_problems(256, 85, seed=16))
    xla = cfg.replace(backend="xla", lmax_method="power")
    rng = np.random.default_rng(25)

    def lu(b, m, k, dtype):
        A = rng.standard_normal((b, m, m)) + m * np.eye(m)
        return tuple(x.to(dtype) for x in cuda(A, rng.standard_normal((b, m, k))))

    # ops.linalg.solve's systems on these paths: the n=170 step's and the
    # float64 N=96 step's Schur systems (nc x nc), the float64 and xla
    # flagship steps' assembled systems (nc + n), qcqp_jacobian's Schur
    # system (nc x nc, n columns)
    lus = {f"ops.linalg.solve alone B={b} m={m} {k} column(s) {str(dt)[6:]} ({what})":
           lu(b, m, k, dt) for b, m, k, dt, what in (
               (256, 85, 1, torch.float32, "the n=170 step's Schur system"),
               (256, 48, 1, torch.float64, "the float64 N=96 step's Schur system"),
               (4096, 36, 1, torch.float64, "the float64 flagship step's assembled system"),
               (4096, 36, 1, torch.float32, "the backend='xla' flagship step's assembled system"),
               (4096, 12, 24, torch.float32, "qcqp_jacobian's Schur system"))}
    steps = {
        "config-11 rollout B=2048 T=50 warm_start=True":
            (lambda: cs.simulate(params, state0, f, warm_start=True), 3, 1),
        "diagonal-P flagship QCQP step B=4096 N=24":
            (lambda: grad_step(dqt.solve_qcqp_with_stats, cfg, 4)(*diag), 5, 5),
        "QP step B=256 N=176 (past K1)":
            (lambda: grad_step(dqt.solve_qp_with_stats, qp_cfg, 2)(*q176), 5, 5),
        "QCQP step B=256 n=170 (past K1)":
            (lambda: grad_step(dqt.solve_qcqp_with_stats, cfg, 4)(
                P170, q170, r170, torch.ones_like(r170)), 5, 5),
        "float64 QCQP step B=256 N=96 (Cholesky inverse)":
            (lambda: grad_step(dqt.solve_qcqp_with_stats, cfg, 4)(*f96), 5, 5),
        "float64 flagship QCQP step B=4096 N=24 (spectral)":
            (lambda: grad_step(dqt.solve_qcqp_with_stats, cfg, 4)(*x64), 5, 5),
        "backend='xla' flagship step B=4096 N=24 (spectral, L by power iteration)":
            (lambda: grad_step(dqt.solve_qcqp_with_stats, xla, 4)(P, q, l_n, mu), 5, 5),
        "backend='xla' flagship forward B=4096 N=24 (spectral)":
            (lambda: dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg.replace(backend="xla")),
             5, 5),
        "generic route float64 LU, qcqp_vjp(duals=) B=4096 N=24":
            (lambda: kkt.qcqp_vjp(x64[0], x64[1], r64, l64, g64, cfg,
                                  duals=kkt.qcqp_dual(x64[0], x64[1], r64, l64, cfg)), 5, 5),
        "qcqp_jacobian B=4096 N=24": (lambda: dqt.qcqp_jacobian(P, q, l_n, mu, config=cfg), 5, 5),
        **{label: (lambda xs=xs: solve(*xs), 5, 5) for label, xs in lus.items()},
        **{f"E1 alone {label}": (lambda P=P_: eigh_cuda(P), 5, 20 if P_.shape[1] <= 24 else 5)
           for label, P_, _ in e1_points(P)},
    }
    ms, prof = {}, {}
    for label, (fn, reps, calls) in steps.items():
        ms[label] = time_cuda(fn, reps=reps, calls=calls)[0]
        prof[label] = launch_profile(label, fn)
    print(json.dumps({"tree": str(root), "package": dqt.__file__, "card": smi,
                      "eager_ms": ms, "per_call": prof}), flush=True)
    return 0


# ``chip_smoke.py k1``: the flagship's first B problems (B=132: one problem an
# SM) and the fixed iteration counts of the set-up-against-iteration sweep
K1_SWEEP_B = (132, 528, 1056, 2112, 4096)
K1_FIXED_K = (0, 8, 16, 32)


GLUE_POINTS = ((2048, 96), (4096, 24))    # config 6's size and the flagship's


def glue_cases(b, n, dtype=torch.float32, seed=23):
    """G1 (forward and adjoint) and G2 at batch b, size n: [(label, the
    kernel, the PyTorch formula it replaced)] on random inputs."""
    from diffqcqp_tpu_torch.kernels import glue_cuda as G

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    P, Gc = (torch.randn((b, n, n), generator=gen, dtype=dtype, device=dev) for _ in range(2))
    dl, l = (torch.randn((b, n), generator=gen, dtype=dtype, device=dev) for _ in range(2))
    return [("G1 forward", lambda: G.symmetrize_cuda(P), lambda: 0.5 * (P + P.transpose(-1, -2))),
            ("G1 adjoint", lambda: G.symmetrize_cuda(Gc, True),
             lambda: G.symmetrize_plain(Gc, True)),
            ("G2", lambda: G.grad_p_cuda(dl, l), lambda: G.grad_p_plain(dl, l))]


def phase_2g():
    """Phase 2g: G1 and G2 against the PyTorch formulas they replaced, bit
    for bit, at ``GLUE_POINTS`` in float32 and float64."""
    for b, n in GLUE_POINTS:
        for dtype in (torch.float32, torch.float64):
            same = {label: torch.equal(kernel(), formula())
                    for label, kernel, formula in glue_cases(b, n, dtype)}
            log(f"  B={b} N={n} {dtype}: bit for bit {same}")
            if not all(same.values()):
                raise AssertionError(f"glue: B={b} N={n} {dtype}: a kernel differs from its "
                                     f"formula: {same}")
    torch.cuda.synchronize()


def glue_run() -> int:
    """G1 (P's symmetrisation and its adjoint) and G2 (grad_P) alone at
    ``GLUE_POINTS``: phase 2g's bits, then each timed against the PyTorch
    formula it replaced, as 20 calls recorded in one CUDA graph (CUDA
    events over 10 replays, and torch.profiler's device time), beside its
    bound at HBM_BYTES_PER_S (G1 reads and writes B N N entries, G2 reads dl
    and l and writes B N N) and a plain copy of P."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"glue: card {smi}")
    phase_2g()
    for b, n in GLUE_POINTS:
        pass_ms = 1e3 * b * n * n * 4 / HBM_BYTES_PER_S
        bounds = {"G1 forward": 2 * pass_ms, "G1 adjoint": 2 * pass_ms,
                  "G2": pass_ms + 1e3 * 2 * b * n * 4 / HBM_BYTES_PER_S, "copy of P": 2 * pass_ms}
        P = torch.randn((b, n, n), device="cuda:0")
        for label, kernel, formula in glue_cases(b, n) + [("copy of P", P.clone, None)]:
            for name, fn in (("kernel", kernel), ("torch", formula)):
                if fn is None:
                    continue
                ev_ms, prof_ms = graph_times(fn)
                log(f"  B={b} N={n} {label} {name}: {ev_ms:.4f} ms ev, {prof_ms:.4f} ms prof; "
                    f"bound {bounds[label]:.4f} ms ({100 * bounds[label] / prof_ms:.1f} %)")
    log("glue: passed")
    return 0


def graph_times(fn, calls=20, replays=10):
    """(ms a call by CUDA events, ms a call of profiler device time) of
    ``fn`` recorded ``calls`` times in one CUDA graph, over ``replays``
    replays: the device time alone, without the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    rows = device_time_by_kernel(graph.replay, calls=replays)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (calls * replays), sum(r[1] for r in rows) / calls


def k1_run(root) -> int:
    """``python3 chip_smoke.py k1 [ROOT]``: K1 alone, from the port at ROOT
    (default: this checkout; a parent commit unpacked beside it compares the
    two on one card, run in turn A, B, B, A). Builds ``csrc/admm.cu`` alone
    and prints ptxas's registers and spills and ``k1_occupancy`` (the launch
    plans against the library's, problems an SM); runs phase 2's K1 points
    (``phase_2_k1``: gated bit for bit in this checkout, printed only for
    another); then, each as torch.profiler's device time a launch and by
    CUDA events (median of 5 samples of 20 back-to-back calls, 5 at the
    large sizes; at a small B the events time the wrapper's host work): K1
    on the flagship's first B problems for B in ``K1_SWEEP_B`` (at B=132 one
    problem an SM, so no problem waits on another for the SM's pipes); at
    B=132 and 4096, and on config 6's first 132 and all its 2048 problems
    (the block-wide path at N=96), with every problem running exactly k
    iterations (eps=0, no stall floor, max_iter=k) for k in ``K1_FIXED_K``,
    the set-up against an iteration; the flagship's mean, p99 and maximum
    iterations; K1 at config 5's size (B=65,536 N=8,
    ``sharded_example_problems``, eps=1e-7, max_iter=1000), at B=2048 N=96
    (phase 2e's QCQPs) and at config 6; and ``launches_by_instance`` of a
    staged config-6 step's capture. Prints one JSON line."""
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import diffqcqp_tpu_torch as dqt
    from diffqcqp_tpu_torch.kernels import _build
    from diffqcqp_tpu_torch.kernels import admm_cuda as k1m

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build(["admm"])
    ptxas = ptxas_summary(_build.library_path("admm").with_suffix(".log").read_text())
    log(f"k1 ({root}, {smi}): built admm.cu in {time.perf_counter() - t0:.1f} s; ptxas: {ptxas}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = k1_occupancy(sms, ptxas, gate=False)

    cfg = flagship_cfg(dqt)
    P, q, l_n, mu = cuda(*build_problems(B_FLAG, NC_FLAG))
    radius = (l_n * mu).contiguous()

    def args(b, config=cfg):
        return (P[:b].contiguous(), q[:b].contiguous(), torch.zeros_like(q[:b]),
                k1m.PROX_DISK, (radius[:b].contiguous(),), config, True, False)

    # phase 2's points, gated bit for bit in this checkout, printed for another
    here = pathlib.Path(root).resolve() == pathlib.Path(__file__).resolve().parent
    log(f"phase 2 (K1's points){'' if here else ', not gated'}")
    out = phase_2_k1(dqt, cfg, (P, q, l_n, mu), gate=here)["flagship"][0]
    it = out[1].iterations.double()
    iters = {"mean": float(it.mean()), "p99": float(torch.quantile(it, 0.99)),
             "max": int(it.max())}
    def ms(a, calls=20):
        """(device ms a launch by torch.profiler, ms a call by CUDA events):
        at a small B the wrapper's host work outlasts the kernel, and the
        events time the host."""
        fn = lambda: k1m.admm_solve_cuda(*a)   # noqa: E731
        return (per_launch_ms(device_time_by_kernel(fn, calls=10), "admm_kernel"),
                time_cuda(fn, reps=5, calls=calls)[0])

    sweep = {b: ms(args(b)) for b in K1_SWEEP_B}
    c6 = config6_classes(dqt)["qp"]

    def args6(b, config=c6.cfg):
        return (c6.P[:b].contiguous(), c6.q[:b].contiguous(), torch.zeros_like(c6.q[:b]),
                c6.prox, c6.prox_args, config)

    fixed, fixed_iters = {}, {}
    for label, argf, config, batches in (("", args, cfg, (K1_SWEEP_B[0], B_FLAG)),
                                         ("config 6 ", args6, c6.cfg, (K1_SWEEP_B[0], 2048))):
        for b in batches:
            for k in K1_FIXED_K:
                ak = argf(b, config.replace(eps=0.0, stall_tol=0.0, max_iter=k))
                key = f"{label}B={b} k={k}"
                fixed_iters[key] = float(k1m.admm_solve_cuda(*ak)[1].iterations.double().mean())
                fixed[key] = ms(ak)
    Pc, qc, lc, mc = sharded_example_problems(65536)
    a5 = (Pc, qc, torch.zeros_like(qc), k1m.PROX_DISK, ((lc * mc).contiguous(),),
          dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=1000), True, False)
    P96, q96, ln96, mu96 = cuda(*build_problems(2048, 48, seed=6))
    a96 = (P96, q96, torch.zeros_like(q96), k1m.PROX_DISK, ((ln96 * mu96).contiguous(),), cfg,
           True, False)
    a6 = args6(2048)
    large = {}
    for label, ax in (("config 5 B=65536 N=8", a5), ("QCQP B=2048 N=96", a96),
                      ("config 6 B=2048 N=96", a6)):
        large[label] = ms(ax, calls=5)
        large[label + " mean iterations"] = float(
            k1m.admm_solve_cuda(*ax)[1].iterations.double().mean())
    # the launches a staged config-6 step records at its capture, by the
    # launch plan's instance (a port before the count has none)
    by_instance = None
    if hasattr(k1m.admm_solve_cuda, "launches_by_instance"):
        from diffqcqp_tpu_torch.utils.staging import WARMUP, staged

        step = staged(lambda P_, q_: dqt.solve_qp_with_stats(P_, q_, config=c6.cfg,
                                                             device="cuda"))
        for _ in range(WARMUP):
            step(c6.P, c6.q)
        k1m.admm_solve_cuda.launches_by_instance.clear()
        step(c6.P, c6.q)
        torch.cuda.synchronize()
        by_instance = dict(k1m.admm_solve_cuda.launches_by_instance)
    log(f"  K1 at the flagship's first B problems, (device ms, events ms): {sweep}\n"
        f"  K1 with every problem exactly k iterations, (device ms, events ms): {fixed} "
        f"(mean iterations "
        f"{fixed_iters})\n  flagship iterations: {iters}\n  K1 at the large sizes: {large}\n"
        f"  K1's launches by instance in a staged config-6 step's capture: {by_instance}")
    print(json.dumps({"tree": str(root), "package": dqt.__file__, "card": smi, "ptxas": ptxas,
                      "problems_per_sm": per_sm,
                      "flagship_iterations": iters, "k1_ms_by_b": sweep,
                      "k1_ms_fixed_iterations": fixed, "k1_ms_large": large,
                      "launches_by_instance": by_instance}), flush=True)
    return 0


def launch_profile(label, fn, top=12):
    """What one call of ``fn`` asks of the card, from torch.profiler: its
    device ms, kernels launched and the host's waits on the device
    (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
    ``cudaMemcpyAsync``); logs the ``top`` kernels by launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    evs = trace.key_averages()
    kernels = sorted(((ev.key, ev.device_time_total / 1e3, ev.count) for ev in evs
                      if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0
                      and not getattr(ev, "is_user_annotation", False)), key=lambda r: -r[2])
    api = {ev.key: ev.count for ev in evs if ev.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")}
    for name, dev_ms, n in kernels[:top]:
        log(f"  {label}: {n:6d} x {dev_ms:9.4f} ms  {name[:100]}")
    return {"device_ms": sum(r[1] for r in kernels), "kernels": sum(r[2] for r in kernels),
            **api}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["eager"] and len(sys.argv) == 3:
        return eager_run(sys.argv[2])
    if sys.argv[1:2] == ["k1"] and len(sys.argv) <= 3:
        return k1_run(sys.argv[2] if len(sys.argv) == 3 else pathlib.Path(__file__).parent)
    if sys.argv[1:] == ["glue"]:
        return glue_run()
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
    control_requirements()
    for name in sources:
        log(f"  ptxas ({name}): "
            + ptxas_summary(_build.library_path(name).with_suffix(".log").read_text()))

    # each launch plan as the built library computes it, against the wrappers'
    from diffqcqp_tpu_torch.kernels import qcqp_bwd_cuda as k26, qr_solve_cuda as k5m
    plans = [(f"K2/K6 n={n}", k26.launch_plan(n), k26.c_launch_plan(n)) for n in (24, 34, 96, 142)]
    plans += [(f"K5 m={m}", k5m.launch_plan(m), k5m.c_launch_plan(m)) for m in (5, 33, 36, 72, 88)]
    from diffqcqp_tpu_torch.kernels import eigh_cuda as e1m
    plans += [(f"E1 N={n} {dt}", e1m.launch_plan(n, dt), e1m.c_launch_plan(n, dt))
              for dt in (torch.float32, torch.float64) for n in E1_PLAN_NS]
    for label, py, c in plans:
        log(f"  launch plan {label}: (threads, smem bytes, bound, tile) wrapper {py} library {c}")
    from diffqcqp_tpu_torch.kernels import admm_cuda as k1m
    from diffqcqp_tpu_torch.kernels import coord_bwd_cuda as k4m
    occ96 = {name: k26.c_blocks_per_sm(96, schur) for name, schur in (("K2", False), ("K6", True))}
    occ96["K1"] = k1m.c_blocks_per_sm(96)
    log(f"  blocks per SM at N=96 (occupancy calculator): {occ96}")
    if any(py != c for _, py, c in plans) or min(occ96["K2"], occ96["K6"]) < 3 or occ96["K1"] < 4:
        raise AssertionError("a launch plan disagrees with the library, or N=96 fits fewer "
                             "than three blocks of K2 or K6 or four of K1 on an SM")
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
    k4_occupancy(sms)
    e1_occupancy(sms)
    k1_occupancy(sms, ptxas_summary(_build.library_path("admm").with_suffix(".log").read_text()))
    c6 = config6_classes(dqt)
    if sys.argv[1:] == ["config6"]:
        # config 6's phases alone (2c's block-wide cases, 3k, 4h): K4's
        # block-wide path measured before and after a change to it
        phase_2c(k4_block_cases(dqt, c6), rand_g)
        phase_4h(dqt, c6, phase_3k(dqt, c6)[2], smi)
        log(f"chip_smoke: config-6 phases passed, {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["staged"]:
        return staged_run(dqt, c6, smi, dev_name, t_start)
    if sys.argv[1:] == ["control"]:
        # phases 3o and 4o alone: the engine's loops as conditional nodes
        log("phase 3o: the engine's loops on the card, staged (utils.control)")
        pairs_3o = phase_3o(dqt, kernels_by_name(), flagship_cfg(dqt),
                               qp_families(dqt)["qp"].cfg, (rollout_inputs(), rollout_inputs(seed=12)))
        log("phase 4o: each path of phase 3o eagerly and staged")
        phase_4o(smi, pairs_3o)
        log(f"chip_smoke: control phases passed, {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["eigh"]:
        return eigh_run(dqt, smi, t_start)
    if sys.argv[1:] == ["lockstep"]:
        return lockstep_run(dqt, smi, t_start)
    if sys.argv[1:] == ["k2"]:
        return k2_run(dqt, smi, t_start)
    if sys.argv[1:] == ["sysid"]:
        return sysid_run(dqt, smi, t_start)

    cfg = flagship_cfg(dqt)

    # ---- phase 2: K1 against its plain version on the card
    log("phase 2: K1 against admm_solve_plain on the card")
    P, q, l_n, mu = cuda(*build_problems(B_FLAG, NC_FLAG))
    radius = (l_n * mu).contiguous()
    ws = torch.zeros_like(q)
    args = (P, q, ws, PROX_DISK, (radius,), cfg, True, False)
    k1_2 = phase_2_k1(dqt, cfg, (P, q, l_n, mu))
    out_k, factors_flag, err_flag = k1_2["flagship"]
    Pb, qb, lnb, mub, l96 = k1_2["N=96"]

    # ---- phase 2b: K2 against its plain version on the card
    f32_ulps = 8.0 * torch.finfo(torch.float32).eps
    edge, errs_k2 = phase_2b(cfg, (P, q, out_k[0], radius), (Pb, qb, l96, (lnb * mub).contiguous()))
    torch.cuda.synchronize()

    # ---- phase 2c: K4 against its plain version on the card
    log("phase 2c: K4 against coord_kkt_bwd_fused_plain on the card")
    families = qp_families(dqt)     # the three classes at their benchmark points
    qp_cfg10, box_cfg9 = families["qp"].cfg, families["box_qp"].cfg
    lo9, hi9, v9 = families["signed_box_qp"].params
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
    # K4's block-wide path: config 6 (B=2048, N=96) first, then N=33 and N=168
    err_k4_6 = phase_2c(k4_block_cases(dqt, c6), rand_g)
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

    # ---- phase 2p: E1 against its plain version on the card
    log("phase 2p: E1 (eigh_cuda) against jacobi_eigh_plain on the card")
    errs_e1, rotations_e1 = phase_2p(eigh_points(P))
    e1_dev = e1_device_times(P)

    # ---- phase 2g: G1 and G2 against their plain versions on the card
    log("phase 2g: G1 (symmetrize_cuda) and G2 (grad_p_cuda) against the formulas on the card")
    phase_2g()

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

    kernels = kernels_by_name()
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

    # ---- phase 3k: config 6's step (K1, then K4's block-wide path)
    log("phase 3k: config 6, solve_qp + autograd of sum(l^2) at B=2048 N=96")
    _, launches_k4_6, step6 = phase_3k(dqt, c6)

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
    phase_3f(dqt, kernels, diag_cases(cfg, qp_cfg10, box_cfg9), rand_g)

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
    sysid_cfgs = sysid_configs(dqt)
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

    # ---- phase 3l: config 5's size on one card, K1 and the engine against float64
    log("phase 3l: config 5's size (B=65,536, N=8), four slices: K1, the float32 engine, float64")
    phase_3l(dqt)

    # ---- phase 3m: the solves under torch.func (vmap, grad, jacrev)
    log("phase 3m: torch.func, vmap(grad) of the flagship and config-10 steps, vmap(jacrev) of "
        "solve_qcqp and solve_qp")
    steps_3m = phase_3m(dqt, kernels, (P, q, l_n, mu), cfg, families["qp"])

    # ---- phase 3n: the steps staged as one CUDA graph each
    log("phase 3n: the steps staged as one CUDA graph each (utils.staged)")
    _, pairs_3n = phase_3n(dqt, kernels, (P, q, l_n, mu), cfg, families, c6,
                           (P48, q48, ln48, mu48), sysid_inputs(), sysid_cfgs)

    # ---- phase 3o: the engine's loops on the card (conditional graph nodes)
    log("phase 3o: the engine's loops on the card, staged (utils.control)")
    pairs_3o = phase_3o(dqt, kernels, cfg, qp_cfg10, (rollout, rollout_inputs(seed=12)))

    # ---- phase 3p: the spectral mode's routes staged, E1 their set-up
    log("phase 3p: the spectral mode's routes staged, E1 their set-up")
    pairs_3p, launches_e1 = phase_3p(dqt, kernels, cfg, (P, q, l_n, mu), out_k, l64,
                                     sysid_inputs(), sysid_cfgs[1])

    # ---- phase 4: timing at the flagship point
    args0 = args[:5] + (cfg.replace(max_iter=0),) + args[6:]
    k1 = lambda: admm_solve_cuda(*args)            # noqa: E731
    k1_setup = lambda: admm_solve_cuda(*args0)     # noqa: E731 (set-up only)
    api = lambda: dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg)  # noqa: E731
    dev_k = per_launch_ms(device_time_by_kernel(k1), "admm_kernel")
    dev_setup = per_launch_ms(device_time_by_kernel(k1_setup), "admm_kernel")
    ev_k1, _ = time_cuda(k1, reps=20, calls=1)
    ev_api, _ = time_cuda(api, reps=5, calls=20)
    fmt = lambda x: "not in the trace" if x is None else f"{x:.4f} ms"  # noqa: E731
    log(f"phase 4 ({smi}):\n"
        f"  K1 device time per launch (torch.profiler): {fmt(dev_k)}; "
        f"set-up only, max_iter=0: {fmt(dev_setup)}\n"
        f"  K1 one call at a time (CUDA events): {ev_k1:.4f} ms\n"
        f"  solve_qcqp_with_stats per call, 20 back-to-back: {ev_api:.4f} ms")
    # K1's and K2's numbers in the kernels line (K2 with the main path's
    # cotangent g = 2 l), as ``chip_smoke.py staged`` takes them
    times_k12 = k1_k2_times(P, q, radius, cfg, out_k, factors_flag, smi)
    # K1 at config 5's size (B=65,536 N=8: four problems a warp), phase 2's
    # problems, against its plain version's time there and its bound
    a5, out_k5, _, factors5, ms_p5 = k1_2["config 5"]
    k1_5 = lambda: admm_solve_cuda(*a5)    # noqa: E731
    dev5 = per_launch_ms(device_time_by_kernel(k1_5, calls=5), "admm_kernel")
    ev5, ts5 = time_cuda(k1_5, reps=5, calls=5)
    b5, b5_by, b5_bytes, b5_flops = k1_bound_ms(65536, 8, 4, out_k5[1].iterations, factors5,
                                                a5[5].power_iters)
    log(f"  K1 at config 5's size B=65536 N=8 ({smi}): device time per launch (torch.profiler) "
        f"{fmt(dev5)}; per call, 5 back-to-back (CUDA events) {ev5:.4f} ms (samples "
        f"{[round(t, 4) for t in ts5]}); plain version {ms_p5:.1f} ms (one call, phase 2); bound "
        f"{b5:.5f} ms ({b5_by}: {b5_bytes} bytes, {b5_flops:.4g} FLOP)")
    lk = out_k[0]
    k2_args = (P, q, lk, (2.0 * lk).contiguous(), radius, cfg.eps, cfg.act_eps, f32_ulps)
    # the forward+backward step, as bench.py times it, and its device time
    timed_step(f"flagship forward+backward step B={B_FLAG} N={2 * NC_FLAG}", step, smi,
               calls=20, problems=B_FLAG, top=10)
    k4_times = {name_: phase_4c(c, steps[name_][1], smi) for name_, c in families.items()}
    for label, c in fam96.items():
        _, dev96_k4, (ev96_k4, ts96_k4), (b_, b_by, *_) = time_k4(c)
        log(f"  K4 at {label} ({smi}): device time per launch (torch.profiler) {fmt(dev96_k4)}; "
            f"per call, 20 back-to-back (CUDA events) {ev96_k4:.4f} ms (samples "
            f"{[round(t, 4) for t in ts96_k4]}); bound {b_:.5f} ms ({b_by})")
    log("phase 4h: config 6, K4's block-wide path and the step at B=2048 N=96")
    k4_times_6 = phase_4h(dqt, c6, step6, smi)

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
    phase_4f(dqt, smi, sysid_step, (P, q, l_n, mu), cfg)

    log(f"phase 4g: the sharded, bucketed, resumed and traced paths")
    phase_4g(smi, paths_3j)

    log("phase 4m: the vmapped flagship step beside the flat one")
    phase_4m(smi, steps_3m)

    log("phase 4n: each staged step beside its eager step")
    phase_4n(smi, pairs_3n)

    log("phase 4o: each path of phase 3o eagerly and staged")
    phase_4o(smi, pairs_3o)

    log("phase 4p: the spectral routes eagerly and staged, E1 and torch.linalg.eigh")
    e1_times = phase_4p(smi, pairs_3p, P, (rotations_e1["flagship B=4096 N=24 float32"],
                                           rotations_e1["the float64 referee's P, flagship B=4096 "
                                                        "N=24 float64"]), e1_dev)

    # ---- phases 3q and 4q: the lockstep mode staged, one loop over every shard
    lockstep_phases(dqt, kernels, smi, t_start)

    # the waves of phase 1: K2, K6 and K4 take one at the main path's sizes
    if any(waves24[name] > 1 for name in waves24 if name != "K1"):
        raise AssertionError(f"K2, K6 or K4 takes more than one wave at N=24: {waves24}")

    # ---- phase 5: the kernels line, then the result
    log(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s")
    print(kernels_line(
        {"K1": launches_k1, "K2": launches_k2, "K4": steps["qp"][0], "K4bw": launches_k4_6,
         "K5": launches_3d["K5"], "K6": launches_3d["K6"], "E1": launches_e1["E1"]},
        {"K1": err_flag, "K2": errs_k2[0], "K4": err_k4, "K4bw": err_k4_6,
         "K5": err_k5[k5_points[0][0]], "K6": err_k6,
         "E1": errs_e1["the float64 referee's P, flagship B=4096 N=24 float64"]},
        {**times_k12, "K4": k4_times["qp"], "K4bw": k4_times_6, "K5": k5_times[k5_points[0][0]],
         "K6": k6_times, "E1": e1_times}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
