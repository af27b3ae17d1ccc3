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
every shard of the axis once per iteration (the JAX package's ``lax.pmin``):

  * each shard's call stack (canonicalise, equilibrate, the engine's
    set-up, ``_Solve``) runs on a thread of its own, on the caller's
    current stream of its device, up to the engine's loop, which it hands
    over to the axis's coordinator (``Lockstep``); the threads are call
    stacks, not concurrency: shard i + 1 starts only once shard i has
    handed over its loop, so one thread works at any moment;
  * the calling thread then runs one ``utils/control.py::while_loop`` over
    the tuple of the shards' states: each iteration runs every shard's body
    in turn, then ANDs their done flags on the first shard's device (a
    device op, no host read) and, when the mesh holds a process group, takes
    one ``torch.distributed.all_reduce(MIN)`` of that flag over the ranks;
  * then each thread gets its final state back and runs its epilogue (the
    stats, the map back, autograd's records), one at a time.

Every shard then runs the same number of iterations: the slowest problem's.
Eagerly the loop reads its predicate on the host once an iteration; inside
a CUDA graph capture it records one WHILE node (with a one-rank NCCL group,
the all-reduce inside its body). A capture refuses, with the guard's error,
shards on more than one card in one process (a node's body is one card's
graph), an NCCL group of more than one rank (NCCL fails to record an
all-reduce inside a node's body across ranks) and a gloo group (its
all-reduce runs on the host); those run eagerly. A shard that raises,
before or after the loop, makes the caller raise that shard's error, never
a partial batch; the shards that handed over their loops are released
without running it. (Across processes a rank
whose shard failed leaves the other ranks waiting in their all-reduce until
the process group's timeout.)

``lockstep(mesh)`` binds the axis of a mesh of one shard a process (one
card a rank, ``global_batch_mesh()``) for a block, so that the solves the
calling thread makes there in the lockstep mode (``axis_name``), a
``SystemID``'s or a trace's, run their loops over the ranks the same way.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import torch

from .. import api
from ..config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig
from ..solvers.admm import ADMMState, SolveStats, lockstep_axis
from ..utils import control
from ..utils.staging import capture_error

__all__ = [
    "BATCH_AXIS", "BatchMesh", "lockstep", "make_batch_mesh", "shard_batch",
    "solve_qp_sharded", "solve_box_qp_sharded", "solve_signed_box_qp_sharded",
    "solve_qcqp_sharded",
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


class _Aborted(Exception):
    """Raised in a shard thread whose loop will not run: another shard
    failed."""


class _Slot:
    """One shard thread's hand-over to the calling thread."""

    def __init__(self):
        self.ready = threading.Event()    # the shard handed over its loop, or ended
        self.resume = threading.Event()   # its final state is set, or it was aborted
        self.loop: Optional[tuple] = None          # (cond, body, initial state)
        self.final: Optional[ADMMState] = None     # None when released: aborted


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class Lockstep:
    """The coordinator of a mesh's lockstep axis (what
    ``solvers/admm.py::lockstep_axis`` binds): it runs the loops the engine
    hands it as one loop over every shard of this process, their done flags
    ANDed and, with the mesh's process group, MINed across the ranks."""

    def __init__(self, mesh: BatchMesh):
        self.mesh = mesh
        self._local = threading.local()   # .slot: the shard thread's hand-over

    def capture_reason(self) -> Optional[str]:
        devices = sorted({str(d) for d in self.mesh.devices})
        if len(devices) > 1:
            return (f"the mesh puts this process's shards on {len(devices)} devices "
                    f"({', '.join(devices)}), and one loop records on one card (one rank a "
                    "card stages, each rank its own graph)")
        backend = self._backend()
        if backend not in (None, "nccl"):
            return (f"the mesh's process group is {backend}, whose all_reduce of the done flag "
                    "runs on the host (a one-rank NCCL group records it in the loop's body)")
        if backend == "nccl":
            import torch.distributed as dist

            ranks = dist.get_world_size(self.mesh.group)
            if ranks > 1:
                # NCCL 2.28 on two H100s: "CUDA error: invalid argument" at the
                # capture of an all_reduce inside a WHILE node's body
                return (f"the mesh's NCCL group spans {ranks} ranks, and an NCCL all_reduce "
                        "inside a WHILE node's body fails to record across ranks")
        return None

    def _backend(self) -> Optional[str]:
        if self.mesh.group is None:
            return None
        import torch.distributed as dist

        return dist.get_backend(self.mesh.group)

    def loop(self, cond: Callable, body: Callable, state: ADMMState) -> ADMMState:
        slot = getattr(self._local, "slot", None)
        if slot is None:            # a solve made by the thread that bound the axis
            return self.run([(cond, body, state)])[0]
        slot.loop = (cond, body, state)
        slot.ready.set()
        slot.resume.wait()
        if slot.final is None:
            raise _Aborted("another shard of the lockstep solve failed")
        return slot.final

    def run(self, loops: Sequence[tuple]) -> tuple:
        """One ``control.while_loop`` over the states of ``loops`` ((cond,
        body, state) each), on the first state's device: ``cond`` is the
        first shard's (every state carries the same iteration count and
        done flag). Returns the final states."""
        conds, bodies, states = zip(*loops)
        return control.while_loop(lambda ss: conds[0](ss[0]),
                                  lambda ss: self._step(bodies, ss), tuple(states))

    def _step(self, bodies: Sequence[Callable], states: tuple) -> tuple:
        """One iteration of the joint loop: every shard's body in turn, each
        on its own device, then the done flag's MIN, a device op: the AND of
        the shards' flags on the first shard's device and, with a process
        group, one ``all_reduce(MIN)`` over the ranks (NCCL on that card;
        gloo on the host, a host read)."""
        new = []
        for body, s in zip(bodies, states):
            with _on(s.it.device):
                new.append(body(s))
        dev = new[0].all_done.device
        done = new[0].all_done
        for s in new[1:]:
            done = done & s.all_done.to(dev)
        backend = self._backend()
        if backend is not None:
            import torch.distributed as dist

            flag = done.to("cpu" if backend != "nccl" else dev, torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.mesh.group)
            done = flag.to(dev, torch.bool)
        return tuple(s._replace(all_done=done.to(s.all_done.device)) for s in new)


def _lockstep(shard: Callable[[int], tuple], mesh: BatchMesh) -> list:
    """``shard(i)`` for every shard, each on a thread of its own, with the
    axis bound to a ``Lockstep`` coordinator; one thread works at a time
    (see the module's docstring). The first failing shard's error is
    raised."""
    k = len(mesh.devices)
    coordinator = Lockstep(mesh)
    # each shard on the caller's current stream of its device
    streams = [torch.cuda.stream(torch.cuda.current_stream(d)) if d.type == "cuda"
               else contextlib.nullcontext() for d in mesh.devices]
    grad = torch.is_grad_enabled()
    slots = [_Slot() for _ in range(k)]
    results: list = [None] * k
    errors: list = [None] * k

    def run(i: int) -> None:
        coordinator._local.slot = slots[i]
        try:
            with torch.set_grad_enabled(grad), streams[i]:
                results[i] = shard(i)
        except BaseException as e:  # handed to the caller below
            errors[i] = e
        finally:
            slots[i].ready.set()

    threads: list = []
    loop_error: Optional[BaseException] = None
    with lockstep_axis(mesh.axis_name, coordinator):
        for i in range(k):      # each shard up to its loop, in turn
            threads.append(threading.Thread(target=run, args=(i,), daemon=True,
                                            name=f"{mesh.axis_name}-shard-{i}"))
            threads[i].start()
            slots[i].ready.wait()
            if errors[i] is not None:
                break
        waiting = [i for i in range(len(threads)) if slots[i].loop is not None]
        finals: Sequence = ()
        if len(threads) == k and errors[k - 1] is None and waiting:
            try:
                finals = coordinator.run([slots[i].loop for i in waiting])
            except BaseException as e:  # raised below, once every thread ended
                loop_error = e
        for j, i in enumerate(waiting):   # the epilogues, in turn (or the aborts)
            slots[i].final = finals[j] if finals else None
            slots[i].resume.set()
            threads[i].join()
        for t in threads:
            t.join()
    if loop_error is not None:
        raise loop_error
    failed = [e for e in errors if e is not None and not isinstance(e, _Aborted)]
    if failed:
        raise failed[0]
    return results


@contextlib.contextmanager
def lockstep(mesh: BatchMesh) -> Iterator[None]:
    """Bind ``mesh.axis_name`` for the block, for the solves the calling
    thread makes there with ``config.axis_name`` set to it (a ``SystemID``'s
    training steps, a trace): each runs its loop in lockstep with the same
    solve on every other rank of the mesh's process group (one all-reduce
    MIN of the done flag an iteration), on the mesh's one device. The mesh
    holds one shard (``global_batch_mesh()``); several shards of one process
    are a sharded call's (``solve_*_sharded(..., lockstep=True)``)."""
    if len(mesh.devices) != 1:
        raise ValueError(f"lockstep(mesh) takes a mesh of one shard a process, got "
                         f"{len(mesh.devices)}; run several shards through solve_*_sharded(..., "
                         "lockstep=True)")
    with lockstep_axis(mesh.axis_name, Lockstep(mesh)):
        yield


def _run(solve, args: Sequence, names: Sequence[str], mesh: Optional[BatchMesh],
         cfg: SolverConfig, axis_name: str, lockstep: bool):
    mesh = mesh if mesh is not None else make_batch_mesh(axis_name=axis_name)
    if mesh.axis_name != axis_name:
        raise ValueError(f"axis_name {axis_name!r} is not the mesh's axis {mesh.axis_name!r}")
    if lockstep and control.capturing():
        reason = Lockstep(mesh).capture_reason()
        if reason is not None:    # before any shard is placed or recorded
            raise capture_error("the lockstep mode (parallel/sharding.py)", reason)
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
