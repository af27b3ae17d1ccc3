"""The paper's use of the solvers (port of models/): system identification
by Adam through the differentiable solves, and a differentiable contact
rollout."""

from .contact_sim import (
    ContactParams,
    ContactState,
    make_system_id_step,
    simulate,
    trajectory_loss,
)
from .system_id import (
    QCQPSystemIDParams,
    QPSystemIDParams,
    SystemID,
    qcqp_params_to_problem,
    qp_params_to_problem,
)
