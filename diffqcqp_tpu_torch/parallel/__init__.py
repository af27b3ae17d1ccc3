"""Batch sharding over devices and processes (port of parallel/)."""

from .multihost import (
    global_batch_mesh,
    initialize_distributed,
    shard_host_local_batch,
)
from .sharding import (
    BATCH_AXIS,
    BatchMesh,
    make_batch_mesh,
    shard_batch,
    solve_box_qp_sharded,
    solve_qcqp_sharded,
    solve_qp_sharded,
    solve_signed_box_qp_sharded,
)
