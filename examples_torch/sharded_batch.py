"""Batch sharding over devices (the JAX package's BASELINE config 5 in
miniature) on the port.

Shards a QCQP batch over every card (or ``shards`` copies of one device),
solves collective-free (each shard stops on its own and keeps the kernel
path), then in lockstep mode (one done-flag MIN an iteration, every shard
the same number of iterations), and checks both against the unsharded
solve of the whole batch. Launched by ``torchrun``, each rank takes one
card and its slice of the global batch, the lockstep MIN runs over the
ranks (NCCL), and each rank checks its slice against the whole batch solved
on its own card. Each mode's time is printed beside the unsharded solve's
(host clock around solves that end in a synchronisation, median of 5 after
a warm-up).

The twin of examples/sharded_batch.py.

Run: python examples_torch/sharded_batch.py           # every card of this host
     torchrun --nproc-per-node=<cards> examples_torch/sharded_batch.py
     python examples_torch/sharded_batch.py cpu       # 2 CPU shards, the plain versions
     python examples_torch/sharded_batch.py cuda 65536   # a global batch of 65,536
                                                     # (BASELINE config 5's size)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.parallel import (
    global_batch_mesh,
    initialize_distributed,
    make_batch_mesh,
    shard_batch,
    shard_host_local_batch,
    solve_qcqp_sharded,
)


def _ms(fn, dev, reps=5):
    """Median wall milliseconds of ``fn`` after one warm-up call."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def main(device="cuda", shards=None, batch=None):
    """``device="cuda"``: one shard a card (``shards`` copies of the first
    card if given); another device: ``shards`` (default 2) copies of it.
    Under ``torchrun`` (or ``initialize_distributed``'s environment) one
    shard a rank. ``batch`` is the global batch (default 128 problems a
    shard). Returns the largest |l - l_single| of the two modes."""
    import torch.distributed as dist

    initialize_distributed()            # a no-op unless a launcher set up a group
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if world > 1:
        mesh = global_batch_mesh(device=None if device == "cuda" else device)
    elif device == "cuda" and shards is None:
        mesh = make_batch_mesh()
    else:
        mesh = make_batch_mesh([device] * (shards or 2))
    k, dev = len(mesh.devices), mesh.devices[0]
    say = print if rank == 0 else (lambda *a, **kw: None)
    say(f"ranks: {world}; shards per rank: {k} on {[str(d) for d in mesh.devices]}")

    nc = 4
    n = 2 * nc
    b = int(batch) if batch else 128 * k * world    # the global batch
    rng = np.random.default_rng(0)
    S = (rng.standard_normal((b, n, n)) / np.sqrt(n)).astype(np.float32)
    t = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    P = t(S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32))
    q = t((rng.standard_normal((b, n)) * 0.5).astype(np.float32))
    l_n = t((rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32))
    mu = t((rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32))
    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=1000)

    # the unsharded solve of the whole batch, on this rank's first device
    single = lambda: dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg, device=dev)  # noqa: E731
    l_ref, _ = single()
    lo, hi = rank * b // world, (rank + 1) * b // world      # this rank's slice
    local = [shard_host_local_batch(x[lo:hi], mesh) for x in (P, q, l_n, mu)]
    args = tuple(shard_batch(x, mesh) for x in local)
    say(f"unsharded solve of B={b}: {_ms(single, dev):.3f} ms")
    worst = 0.0
    for lockstep in (False, True):
        solve = lambda lockstep=lockstep: solve_qcqp_sharded(  # noqa: E731
            *args, mesh=mesh, config=cfg, lockstep=lockstep)
        l, stats = solve()
        it = stats.iterations.reshape(k, -1).float()
        err = float((l - l_ref[lo:hi]).abs().max())
        mode = "lockstep (MIN)" if lockstep else "collective-free"
        print(f"[rank {rank}] {mode:16s} converged={float(stats.converged.float().mean()):.3f}"
              f"  max|l - l_single|={err:.2e}"
              f"  per-shard mean iters={[round(float(x), 1) for x in it.mean(dim=1)]}"
              f"  {_ms(solve, dev):.3f} ms", flush=True)
        assert err < 1e-5
        worst = max(worst, err)
    if dist.is_initialized():
        dist.destroy_process_group()
    say("ok")
    return worst


if __name__ == "__main__":
    main(*sys.argv[1:2], batch=sys.argv[2] if len(sys.argv) > 2 else None)
