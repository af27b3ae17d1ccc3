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
(``verify``), the paper's models (``models``: system identification and
a differentiable contact rollout), batch sharding over cards and processes
(``parallel``), per-iteration traces (``debug``) and the ``utils``
(bucketing, warm-started retries, the build directory). The port imports
torch and never jax, and nothing of the JAX package, which stays beside it
as the reference.

    import diffqcqp_tpu_torch as dqt
    l, stats = dqt.solve_qcqp_with_stats(P, q, l_n, mu, config=cfg)   # on the card
    (l * l).sum().backward()                                           # grads of P, q, l_n, mu
    l = dqt.solve_box_qp(P, q, l_min, l_max, device="cpu")             # plain version
    r = dqt.verify.check_qcqp(P, q, l_n, mu, l)                        # float64 KKT residuals

The solves compose with ``torch.func`` as the JAX package's do with its
transforms: ``vmap``, ``grad``, ``vjp``, ``jacrev`` and their nestings
(``vmap(grad(...))``, ``vmap(jacrev(...))``) over ``solve_*`` and
``solve_*_with_stats``, the ``*Fn2`` bindings, ``*_jacobian`` and
``ops.linalg.ns_inverse_shifted``. A vmapped call folds its groups into the
problem batch, so each kernel launches once over the whole folded batch and
the results are the flat call's; ``jacrev``'s n basis cotangents are one
backward launch over n*B problems. Forward mode (``jvp``, ``jacfwd``) and
second derivatives raise, as in the JAX package (a ``custom_vjp`` has no
JVP, and the kernels' backward is not differentiable). A lockstep solve
(``axis_name``) under ``vmap`` raises ``ValueError``.

    g = torch.func.vmap(torch.func.grad(loss))(P, q)     # (G, B, ...) groups: one K1, one K4
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
from . import debug, verify
from .utils.autotune import tune_compact_iters
from .utils.cache import enable_compilation_cache

__version__ = "0.1.0"

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
    "debug",
    "tune_compact_iters",
    "enable_compilation_cache",
    "__version__",
]
