"""Multi-process deployment helpers on ``torch.distributed`` (port of
parallel/multihost.py).

The batch is embarrassingly parallel, so a multi-process run is the
single-process program on every rank: each rank holds its slice of the
global batch (the global batch is the ranks' slices in rank order), solves
it with the same ``solve_*_sharded`` functions on its own card, and gets
back its own slice of ``l`` and of the gradients. That is the torch idiom
for what a global ``jax.Array`` over every host's devices is in the JAX
package. The steps:

  1. ``initialize_distributed()`` on every rank (one rank a card, e.g.
     under ``torchrun --nproc-per-node=<cards>``, whose environment it
     reads, or with explicit arguments),
  2. ``global_batch_mesh()``: this rank's card and the world group,
  3. ``shard_host_local_batch(x_local, mesh)``: this rank's slice on its
     card, checked to be as large as every other rank's.

Nothing else is coordinated: by default the solves run no collective;
``lockstep=True`` (or a lockstep solve inside ``lockstep(mesh)``) adds one
all-reduce MIN of the done flag an iteration (NCCL between cards, gloo
between CPU processes). Which groups stage a lockstep solve as one CUDA
graph (``utils.staged``): an NCCL group of one rank, whose all-reduce is
recorded in the body of the loop's WHILE node; not NCCL across ranks, whose
all-reduce fails to record inside a node's body, nor gloo, whose all-reduce
runs on the host (a capture raises the guard's error naming each). Across
ranks a lockstep solve runs eagerly.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .sharding import BATCH_AXIS, BatchMesh, make_batch_mesh

__all__ = ["initialize_distributed", "global_batch_mesh", "shard_host_local_batch"]

_LAUNCH_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def _local_card(rank: Optional[int] = None) -> str:
    """This rank's card: LOCAL_RANK (set by torchrun), else the rank (the
    group's, or ``rank`` before it is joined) modulo the cards of this host."""
    import torch.distributed as dist

    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", rank))
    return f"cuda:{local % max(torch.cuda.device_count(), 1)}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group (call once per rank, before any sharded
    solve): NCCL when CUDA is present, gloo otherwise. A lockstep solve
    stages over an NCCL group of one rank (its done flag's all-reduce
    recorded in the loop's body), not across ranks and not over gloo. ``coordinator_address``
    ("host:port") becomes ``tcp://host:port`` with ``num_processes`` ranks,
    this one ``process_id``; without it the standard launch environment
    (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, as torchrun sets them).

    A no-op when already initialised, and when nothing asks for a group (no
    argument and none of MASTER_ADDR, WORLD_SIZE or RANK set): a single
    process. An explicit launch that fails raises: swallowing it would turn
    every rank into an independent single process, each quietly solving
    another batch than intended."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None or any(os.environ.get(v) for v in _LAUNCH_ENV))
    if not explicit:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_local_card(process_id))
    dist.init_process_group(
        backend,
        init_method="env://" if coordinator_address is None else f"tcp://{coordinator_address}",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def global_batch_mesh(axis_name: str = BATCH_AXIS, device=None) -> BatchMesh:
    """1-D mesh of this rank's one shard, on ``device`` (by default this
    rank's card, raising without CUDA), and the world group when one is
    initialised: the global batch axis spans every rank."""
    return make_batch_mesh([_local_card() if device is None else device], axis_name)


def shard_host_local_batch(x_local, mesh: BatchMesh) -> torch.Tensor:
    """This rank's slice of the global batch, (B_local, ...), on the mesh's
    first device. Under a process group one all-reduce (MIN and MAX of
    B_local) checks that every rank holds as many problems, which the
    sharded solves' lockstep mode and the rank-order assembly rely on."""
    x = torch.as_tensor(x_local).to(mesh.devices[0])
    if mesh.group is not None:
        import torch.distributed as dist

        dev = mesh.devices[0] if dist.get_backend(mesh.group) == "nccl" else "cpu"
        b = torch.tensor([x.shape[0], -x.shape[0]], dtype=torch.int64, device=dev)
        dist.all_reduce(b, op=dist.ReduceOp.MIN, group=mesh.group)
        lo, hi = int(b[0]), -int(b[1])
        if lo != hi:
            raise ValueError(f"the ranks hold local batches of {lo} to {hi} problems; "
                             "every rank must hold the same number")
    return x
