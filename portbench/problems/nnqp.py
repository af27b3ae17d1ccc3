"""The dense non-negative QP: its input law, the step the window drives,
and how its answers are held against the plain reference.

Inputs follow ``benchmarks/run_benchmarks.py``'s law for its QP configs
(``_spd``, then q ~ N(0, 1)), drawn on the device from the seed: s ~ N(0,
1) / sqrt(N), P = s s' + diag * I (symmetrised), q ~ q_std * N(0, 1). The
step is the package's ``solve_qp_with_stats`` and, where the traffic asks
for a backward, the gradient of sum(l^2) for P and q, as a training step
takes it.
"""

from __future__ import annotations

import torch

from portbench.problems import qcqp
from portbench.reference import nnqp as ref

INPUTS = ("P", "q")


def make_pool(cfg: dict, batches: int, seed: int, device: torch.device) -> list[tuple]:
    """``batches`` distinct input batches (P, q) in the configuration's
    dtype, made on ``device`` from ``seed`` in one draw per input."""
    _, P, q = qcqp.draw_pq(cfg, batches, seed, device)
    return qcqp.split(cfg, batches, P, q)


def make_step(cfg: dict, traffic: dict, device: torch.device):
    """As ``qcqp.make_step``, with the package's ``solve_qp_with_stats``."""
    return qcqp.make_step(cfg, traffic, device, entry="solve_qp_with_stats")


def answers(out, traffic: dict) -> dict:
    """The step's output as named answers, each (B, ...)."""
    return qcqp.answers(out, traffic, inputs=INPUTS)


def reference(inputs: tuple, traffic: dict, precision: str = "float64") -> tuple[dict, dict]:
    """The plain reference's answers to one batch, named as ``answers``
    names the step's, and what it found: the mask of problems whose
    gradients are well posed, the active coordinates, and its worst KKT
    residual."""
    P, q = inputs
    sol = ref.solve(P, q, precision=precision)
    out = {"l": sol.l}
    if traffic["backward"]:
        out.update(zip(("dP", "dq"), ref.gradients(sol, 2.0 * sol.l)))
    info = {"well_posed": well_posed(sol), "active": sol.active,
            "kkt": ref.residuals(sol).max()}
    return out, info


def well_posed(sol) -> torch.Tensor:
    """(B,) problems whose every coordinate is strictly active or strictly
    free by ``qcqp.MARGIN``: its multiplier at least that share of the
    batch's mean multiplier on active coordinates, or its value at least
    that share of the batch's mean value on free ones."""
    act = sol.active
    lam_scale = sol.lam[act].mean() if act.any() else sol.lam.new_tensor(1.0)
    l_scale = sol.l[~act].mean() if (~act).any() else sol.l.new_tensor(1.0)
    clear = torch.where(act, sol.lam >= qcqp.MARGIN * lam_scale, sol.l >= qcqp.MARGIN * l_scale)
    return clear.all(-1)
