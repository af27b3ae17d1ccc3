"""Batch sharding over devices (port of parallel/sharding.py).

The batch of QP/QCQP problems is embarrassingly parallel: it is split along
its leading axis over a 1-D ``BatchMesh`` of devices, and each shard runs
the port's public ``solve_*_with_stats`` on its own device (the JAX
package's ``shard_map`` of ``local``). The sharded solves take whole
tensors, as the JAX ones take a whole array; results come back in batch
order on ``q``'s device, and autograd runs through each shard's ``_Solve``
Function, the ``.to()`` moves and the concatenation.

By default the shards run no collective: each solve stops on its own and
keeps the kernel path (K1 forward, K2 / K4 backward on the card). The
shards are issued in turn from the calling thread, on its current stream
of each device: the kernel route never waits for the card, so shards on
different cards overlap.

``lockstep=True`` sets ``cfg.axis_name`` instead, so every solve takes the
eager engine (as in the JAX package), whose done flag becomes a MIN over
every shard of the axis once per iteration: a ``threading.Barrier`` over
one thread a shard, whose action takes the MIN and, when the mesh holds a
process group, does one ``torch.distributed.all_reduce(MIN)`` over the
ranks (the JAX package's ``lax.pmin``). The engine waits for the card every
iteration, so here the shards need threads of their own; each runs on the
caller's current stream of its device (a thread's current stream is its
own). Every shard then runs the same number of iterations. A shard that
raises aborts the barrier, so the other threads raise too, and the caller
gets the first shard's error, never a partial batch. (Across processes a
rank whose shard failed leaves the other ranks waiting in their all-reduce
until the process group's timeout.)
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from .. import api
from ..config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig
from ..solvers.admm import SolveStats, lockstep_axis

__all__ = [
    "BATCH_AXIS", "BatchMesh", "make_batch_mesh", "shard_batch", "solve_qp_sharded",
    "solve_box_qp_sharded", "solve_signed_box_qp_sharded", "solve_qcqp_sharded",
]

BATCH_AXIS = "batch"


class BatchMesh(NamedTuple):
    devices: tuple[torch.device, ...]   # this process's shards, in batch order
    axis_name: str
    group: Optional[object] = None      # torch.distributed process group, if any


def make_batch_mesh(devices=None, axis_name: str = BATCH_AXIS) -> BatchMesh:
    """1-D mesh over the given devices, or every CUDA device of this process
    (raising without CUDA). A device may appear more than once: each entry
    is one shard. That is the port's stand-in for the JAX package's virtual
    devices (``--xla_force_host_platform_device_count``): the CPU tests run
    several shards on ``["cpu"] * k``, and one card can hold two shards.
    Under an initialised process group the mesh also holds the default
    group, over which lockstep solves reduce their done flag."""
    if devices is None:
        api._device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(api._device(d) for d in devices)
    if not devices:
        raise ValueError("a batch mesh needs at least one device")
    import torch.distributed as dist

    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    return BatchMesh(devices, axis_name, group)


def _check_divides(x: torch.Tensor, k: int) -> None:
    if x.ndim == 0 or x.shape[0] % k:
        raise ValueError(
            f"the batch ({x.shape[0] if x.ndim else 'a scalar'}) must divide by the "
            f"mesh's {k} shards"
        )


def shard_batch(x, mesh: BatchMesh) -> torch.Tensor:
    """Place a whole batch for the sharded solves: check that its leading
    axis divides by the mesh's shard count, and return it on the mesh's
    first device, where the sharded solves then return their results. The
    solves split it into one slice a shard themselves."""
    x = torch.as_tensor(x)
    _check_divides(x, len(mesh.devices))
    return x.to(mesh.devices[0])


class _LockstepDone:
    """The done-flag MIN over this process's k shard threads (one barrier
    round per engine iteration) and, with a process group, over the ranks."""

    def __init__(self, mesh: BatchMesh):
        self._group = mesh.group
        self._device = torch.device("cpu")
        if mesh.group is not None:
            import torch.distributed as dist

            if dist.get_backend(mesh.group) == "nccl":
                self._device = mesh.devices[0]
        self._lock = threading.Lock()
        self._acc, self._done = True, False
        self._barrier = threading.Barrier(len(mesh.devices), action=self._reduce)

    def _reduce(self) -> None:
        # runs once a round, after every thread arrived and before any leaves
        done, self._acc = self._acc, True
        if self._group is not None:
            import torch.distributed as dist

            t = torch.tensor([int(done)], dtype=torch.int32, device=self._device)
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._group)
            done = bool(t.item())
        self._done = done

    def __call__(self, local_done: bool) -> bool:
        with self._lock:
            self._acc = self._acc and local_done
        self._barrier.wait()
        return self._done

    def abort(self) -> None:
        self._barrier.abort()


def _lockstep(shard: Callable[[int], tuple], mesh: BatchMesh) -> list:
    """``shard(i)`` for every shard, one thread each, with the axis bound to
    a done-flag MIN over them; the first shard's error is raised."""
    k = len(mesh.devices)
    reducer = _LockstepDone(mesh)
    streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
               for d in mesh.devices]
    grad = torch.is_grad_enabled()
    results: list = [None] * k
    errors: list = [None] * k

    def run(i: int) -> None:
        try:
            with torch.set_grad_enabled(grad), torch.cuda.stream(streams[i]):
                results[i] = shard(i)
        except BaseException as e:  # handed to the caller below
            errors[i] = e
            reducer.abort()

    with lockstep_axis(mesh.axis_name, reducer):
        threads = [threading.Thread(target=run, args=(i,), name=f"{mesh.axis_name}-shard-{i}")
                   for i in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        # the shard that failed first, not the others' broken barrier
        raise next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                   failed[0])
    return results


def _run(solve, args: Sequence, names: Sequence[str], mesh: Optional[BatchMesh],
         cfg: SolverConfig, axis_name: str, lockstep: bool):
    mesh = mesh if mesh is not None else make_batch_mesh(axis_name=axis_name)
    if mesh.axis_name != axis_name:
        raise ValueError(f"axis_name {axis_name!r} is not the mesh's axis {mesh.axis_name!r}")
    k = len(mesh.devices)
    parts = []
    for a, name in zip(args, names):
        if a is None:
            parts.append(None)
            continue
        a = torch.as_tensor(a)
        try:
            _check_divides(a, k)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
        parts.append(tuple(p.to(d) for p, d in zip(a.split(a.shape[0] // k), mesh.devices)))
    out_dev = torch.as_tensor(args[1]).device
    if lockstep:
        cfg = cfg.replace(axis_name=axis_name)

    def shard(i: int) -> tuple:
        return solve(*(None if p is None else p[i] for p in parts), config=cfg,
                     device=mesh.devices[i])

    results = _lockstep(shard, mesh) if lockstep else [shard(i) for i in range(k)]
    l = torch.cat([r[0].to(out_dev) for r in results])
    stats = SolveStats(*(torch.cat([r[1][f].to(out_dev) for r in results])
                         for f in range(len(SolveStats._fields))))
    return l, stats


def solve_qp_sharded(
    P, q, warm_start=None, *, mesh: Optional[BatchMesh] = None,
    config: Optional[SolverConfig] = None, axis_name: str = BATCH_AXIS,
    lockstep: bool = False,
):
    """Batch-sharded non-negative QP solve. Each argument is a whole tensor
    whose leading batch dimension divides by the mesh's shard count.
    Returns (l, SolveStats) on q's device."""
    return _run(api.solve_qp_with_stats, (P, q, warm_start), ("P", "q", "warm_start"),
                mesh, config or QP_DEFAULTS, axis_name, lockstep)


def solve_box_qp_sharded(
    P, q, l_min, l_max, warm_start=None, *, mesh: Optional[BatchMesh] = None,
    config: Optional[SolverConfig] = None, axis_name: str = BATCH_AXIS,
    lockstep: bool = False,
):
    """Batch-sharded box QP solve; see ``solve_qp_sharded``."""
    return _run(api.solve_box_qp_with_stats, (P, q, l_min, l_max, warm_start),
                ("P", "q", "l_min", "l_max", "warm_start"),
                mesh, config or QP_DEFAULTS, axis_name, lockstep)


def solve_signed_box_qp_sharded(
    P, q, l_min, l_max, v, warm_start=None, *, mesh: Optional[BatchMesh] = None,
    config: Optional[SolverConfig] = None, axis_name: str = BATCH_AXIS,
    lockstep: bool = False,
):
    """Batch-sharded signed-box QP solve; see ``solve_qp_sharded``."""
    return _run(api.solve_signed_box_qp_with_stats, (P, q, l_min, l_max, v, warm_start),
                ("P", "q", "l_min", "l_max", "v", "warm_start"),
                mesh, config or QP_DEFAULTS, axis_name, lockstep)


def solve_qcqp_sharded(
    P, q, l_n, mu, warm_start=None, *, mesh: Optional[BatchMesh] = None,
    config: Optional[SolverConfig] = None, axis_name: str = BATCH_AXIS,
    lockstep: bool = False,
):
    """Batch-sharded friction-cone QCQP solve; see ``solve_qp_sharded``."""
    return _run(api.solve_qcqp_with_stats, (P, q, l_n, mu, warm_start),
                ("P", "q", "l_n", "mu", "warm_start"),
                mesh, config or QCQP_DEFAULTS, axis_name, lockstep)
