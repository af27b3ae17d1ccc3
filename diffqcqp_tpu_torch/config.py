"""Solver configuration of the PyTorch port.

The same frozen dataclass as ``diffqcqp_tpu/config.py``: every field, every
default, ``replace``, and the two family presets. The port keeps its own copy
(it imports nothing of the JAX package). ``SolverConfig.from_dict`` carries a
JAX config across: ``SolverConfig.from_dict(dataclasses.asdict(jax_cfg))``.

What the port does with each field that differs from the JAX package:

  * ``pallas_tile_b``, ``pallas_rolled``: accepted and ignored. They shape the
    TPU kernel's lane tiles and its factorisation loop; the CUDA kernel runs
    one thread block per problem and has neither.
  * ``compact_iters``: validated on every path (0, a positive int, or
    ``'auto'`` / -1) and then ignored. Straggler compaction exists because a
    TPU tile pays for its slowest problem; on the card each problem leaves
    its own loop, so there is no tile tail to compact.
  * ``lmax_method`` and ``linsolve``: read by the eager engine
    (``solvers/admm.py``) as in the JAX package; the kernel K1 ignores them,
    as the JAX kernel does (it always estimates L by ``power_iters`` steps
    of power iteration and has its own linear solve).
  * ``backend``: 'auto' (the dispatch of ``api.py::_use_kernel`` and
    ``diff/kkt.py::_use_fused_kernel``), 'pallas' (the kernels, their plain
    versions on CPU tensors) or 'xla' (the eager engine and the generic
    adjoint route).
  * ``axis_name``: the lockstep mode of ``parallel/sharding.py``. The eager
    engine reduces its done flag with a MIN over every shard of that axis,
    through the reducer the sharded call registers under the name
    (``solvers/admm.py::lockstep_axis``); with none registered it raises
    ``NameError``, as the JAX package's ``lax.pmin`` does for an unbound
    axis. 'auto' sends such a solve to the engine, as in the JAX package.

See the JAX package's ``SolverConfig`` docstring for what each knob means;
the semantics are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SolverConfig", "QP_DEFAULTS", "QCQP_DEFAULTS", "check_supported"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static hyper-parameters of the proximal over-relaxed adaptive-rho ADMM.

    Fields, defaults and meaning are those of the JAX package's
    ``SolverConfig``; the module docstring lists what the port ignores or
    does otherwise.
    """

    eps: float = 1e-10
    eps_rel: float = 1e-4
    primal_check: bool = True
    mu_prox: float = 1e-7
    max_iter: int = 1000
    adaptive_rho: bool = True
    alpha_relax: float = 1.5
    mu_thresh: float = 10.0
    tau_damping: float = 0.8
    rho_update_period: int = 5
    power_iters: int = 10
    lmax_method: str = "eigh"
    act_eps: float = 1e-10
    mu_ir: float = 1e-7
    ir_iters: int = 10
    axis_name: Optional[str] = None
    backend: str = "auto"
    linsolve: str = "auto"
    pallas_tile_b: int = 512
    pallas_rolled: str = "auto"
    stall_tol: float = 8.0
    rho_sync: bool = True
    rho0_scale: float = 1.0
    compact_iters: int | str = 0      # validated, no effect on the card
    warm_start_dual: bool = False
    accel: bool = False
    accel_eta: float = 0.999
    equilibrate: bool = False
    ruiz_iters: int = 10

    def __post_init__(self):
        _check_compact_iters(self.compact_iters)

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "SolverConfig":
        """Build from ``dataclasses.asdict`` of a JAX ``SolverConfig`` (or
        any mapping of field names). Unknown keys raise ``ValueError``."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown SolverConfig fields: {unknown}")
        return cls(**d)


def _check_compact_iters(k) -> None:
    if not (
        k in ("auto", -1)
        or (isinstance(k, int) and not isinstance(k, bool) and k >= 0)
    ):
        raise ValueError(
            "SolverConfig.compact_iters must be 0 (off), a positive int K, "
            f"or 'auto' (alias -1); got {k!r}"
        )


def check_supported(cfg: SolverConfig) -> None:
    """Raise ``ValueError`` for an unknown backend."""
    if cfg.backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend {cfg.backend!r}")


# Reference defaults for the two problem families (QCQP: 100 power-iteration
# steps, the QP family 10).
QP_DEFAULTS = SolverConfig()
QCQP_DEFAULTS = SolverConfig(power_iters=100)
