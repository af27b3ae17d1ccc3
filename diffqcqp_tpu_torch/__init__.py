"""diffqcqp_tpu_torch: the PyTorch / CUDA port of diffqcqp_tpu.

Batched, differentiable ADMM solvers for the non-negative QP, the box QP,
the signed-box QP and the friction-cone QCQP, whose forward solve and
backward (KKT adjoint) each run in one hand-written CUDA kernel per batch on
an NVIDIA Hopper card: ``kernels/csrc/admm.cu`` forward, and
``kernels/csrc/coord_bwd.cu`` (QP family) or ``kernels/csrc/qcqp_bwd.cu``
(QCQP) backward, for dense float32 problems within the kernels' bounds; the
eager engine (``solvers/admm.py``) and the generic adjoint route take
float64, ``backend='xla'``, ``accel``, larger sizes and a diagonal (B, N) P,
whose adjoints are closed form (``which_backend`` names the forward's
engine). Around them: the raw duals and derivatives (``duals.py``), the full
Jacobians (``diff/jacobian.py``: ``*_jacobian``), the KKT-residual oracle
(``verify``) and the paper's models (``models``: system identification and
a differentiable contact rollout). The port imports torch and never jax,
and nothing of the JAX package, which stays beside it as the reference.

    import diffqcqp_tpu_torch as dqt
    l, stats = dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg)   # on the card
    (l * l).sum().backward()                                           # grads of P, q, l_n, mu
    l = dqt.solve_box_qp(P, q, l_min, l_max, device="cpu")             # plain version
    r = dqt.verify.check_qcqp(P, q, l_n, mu, l)                        # float64 KKT residuals
"""

from .api import (
    solve_box_qp,
    solve_box_qp_with_stats,
    solve_qcqp,
    solve_qcqp_with_stats,
    solve_qp,
    solve_qp_with_stats,
    solve_signed_box_qp,
    solve_signed_box_qp_with_stats,
    which_backend,
)
from .config import QCQP_DEFAULTS, QP_DEFAULTS, SolverConfig
from .diff.jacobian import (
    box_qp_jacobian,
    qcqp_jacobian,
    qp_jacobian,
    signed_box_qp_jacobian,
)
from .duals import (
    BoxDualRecovery,
    BoxQPDerivatives,
    QCQPDerivatives,
    SignedBoxDualRecovery,
    SignedBoxQPDerivatives,
    box_qp_derivatives,
    qcqp_derivatives,
    qp_derivatives,
    recover_box_qp_duals,
    recover_qcqp_duals,
    recover_qp_duals,
    recover_signed_box_qp_duals,
    signed_box_qp_derivatives,
)
from .solvers.admm import SolveStats
from . import verify

__all__ = [
    "SolverConfig",
    "SolveStats",
    "QP_DEFAULTS",
    "QCQP_DEFAULTS",
    "solve_qp",
    "solve_box_qp",
    "solve_signed_box_qp",
    "solve_qcqp",
    "solve_qp_with_stats",
    "solve_box_qp_with_stats",
    "solve_signed_box_qp_with_stats",
    "solve_qcqp_with_stats",
    "which_backend",
    "qp_jacobian",
    "box_qp_jacobian",
    "signed_box_qp_jacobian",
    "qcqp_jacobian",
    "verify",
    "recover_qp_duals",
    "recover_box_qp_duals",
    "recover_signed_box_qp_duals",
    "recover_qcqp_duals",
    "qp_derivatives",
    "box_qp_derivatives",
    "signed_box_qp_derivatives",
    "qcqp_derivatives",
    "BoxDualRecovery",
    "SignedBoxDualRecovery",
    "BoxQPDerivatives",
    "SignedBoxQPDerivatives",
    "QCQPDerivatives",
]
