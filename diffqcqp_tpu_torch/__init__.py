"""diffqcqp_tpu_torch: the PyTorch / CUDA port of diffqcqp_tpu.

A batched, differentiable ADMM solver for friction-cone QCQPs whose forward
solve and backward (KKT adjoint) each run in one hand-written CUDA kernel per
batch (``kernels/csrc/admm.cu``, ``kernels/csrc/qcqp_bwd.cu``) on an NVIDIA
Hopper card. The port imports torch and never jax, and nothing of the JAX
package, which stays beside it as the reference.

    import diffqcqp_tpu_torch as dqt
    l, stats = dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg)   # on the card
    (l * l).sum().backward()                                           # grads of P, q, l_n, mu
    l = dqt.solve_qcqp(P, q, l_n, mu, device="cpu")                    # plain version
"""

from .api import solve_qcqp, solve_qcqp_with_stats
from .config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig
from .duals import QCQPDerivatives, qcqp_derivatives, recover_qcqp_duals
from .solvers.admm import SolveStats

__all__ = [
    "solve_qcqp",
    "solve_qcqp_with_stats",
    "recover_qcqp_duals",
    "qcqp_derivatives",
    "QCQPDerivatives",
    "SolverConfig",
    "QP_DEFAULTS",
    "QCQP_DEFAULTS",
    "SolveStats",
]
