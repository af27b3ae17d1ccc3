"""System identification through both solvers (``run_benchmarks.py`` config
4): its input law, the step the window drives, and how its answers are held
against the plain reference.

A pool slot is ``cfg["batch"] // 2`` jobs, drawn on the device from the
seed: S ~ N(0, 1) / sqrt(N), q ~ q_std N(0, 1), log_l_n and logit_mu at
their configured values (config 4 starts both from zeros), the target ~
U(lo, hi), and Adam's state at step ``adam.step``: each parameter's two
moments as ten gradients of its configured scale (``adam.grad_rms``, i.i.d.
N(0, rms^2) entries) leave them, m = sum (1 - b1) b1^(10-k) g_k and v = sum
(1 - b2) b2^(10-k) g_k^2. The step is the package's own
``models/system_id.py::mixed_step`` on copies of the slot's parameters and
state (so that every step of a slot is the same pure function of it): both
staged solves, the loss, every parameter's gradient and the Adam update.
Its answers are l (the QPs' rows, then the QCQPs'), the four gradients and
the four updates (new minus old).
"""

from __future__ import annotations

import importlib

import torch

from portbench.problems import nnqp, qcqp
from portbench.reference import sysid as ref

PARAMS = ("S", "q", "log_l_n", "logit_mu")
ANSWERS = ("l", *("d" + p for p in PARAMS), *("update_" + p for p in PARAMS))


class Slot(tuple):
    """A pool slot's tensors, with the configuration they were drawn under:
    the harness hands ``reference`` a slot alone, and the step's settings
    (reg, Adam's) come with it."""

    def __new__(cls, tensors, cfg: dict):
        slot = super().__new__(cls, tensors)
        slot.cfg = cfg
        return slot


def _moments(g: torch.Generator, x: torch.Tensor, rms: float, steps: int, betas) -> tuple:
    """(m, v) of Adam after ``steps`` gradients of x's shape with i.i.d.
    N(0, rms^2) entries."""
    b1, b2 = betas
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    for _ in range(steps):
        gk = torch.randn(x.shape, dtype=x.dtype, device=x.device, generator=g) * rms
        m = b1 * m + (1.0 - b1) * gk
        v = b2 * v + (1.0 - b2) * gk * gk
    return m, v


def make_pool(cfg: dict, batches: int, seed: int, device: torch.device) -> list[tuple]:
    """``batches`` slots (S, q, log_l_n, logit_mu, target, the four first
    moments, the four second moments, the step count) in the
    configuration's dtype, made on ``device`` from ``seed``."""
    jobs, n, nc = cfg["batch"] // 2, cfg["n"], cfg["contacts"]
    law, adam = cfg["law"], cfg["adam"]
    rows = batches * jobs
    g = torch.Generator(device=device).manual_seed(int(seed))
    draw = dict(dtype=getattr(torch, cfg["dtype"]), device=device, generator=g)
    S = torch.randn(rows, n, n, **draw) / n ** 0.5
    q = torch.randn(rows, n, **draw) * law["q_std"]
    lo, hi = law["target"]
    target = torch.rand(rows, n, **draw) * (hi - lo) + lo
    params = (S, q, torch.full((rows, nc), float(law["log_l_n"]), dtype=S.dtype, device=device),
              torch.full((rows, nc), float(law["logit_mu"]), dtype=S.dtype, device=device))
    ms, vs = zip(*(_moments(g, x, float(adam["grad_rms"][name]), int(adam["step"]),
                            adam["betas"]) for name, x in zip(PARAMS, params)))
    slots = qcqp.split({"batch": jobs}, batches, *params, target, *ms, *vs)
    step = torch.tensor(float(adam["step"]), dtype=torch.float32, device=device)
    return [Slot(s + (step.clone(),), cfg) for s in slots]


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """A copy of x made by a kernel (x * 1 is x, bit for bit), so that the
    step updates copies and leaves its slot as it was. Not ``clone``: in a
    CUDA graph a device-to-device memcpy node may run as a kernel that CUDA
    puts in its place (``memcpy32_post``), which ``portbench/spans.py``
    cannot place against the graph's layout."""
    return x.detach() * 1.0


def make_step(cfg: dict, traffic: dict, device: torch.device):
    """(step, counts): the step as a function of a slot's tensors, and the
    (2,) int64 tensor on ``device`` to which every call adds both solves'
    converged problems and iterations, in place (inside a staged step's
    graph). The step returns the answers in ``ANSWERS``' order."""
    if not traffic["backward"]:
        raise ValueError("the system-identification step is a training step: its traffic "
                         "has a backward")
    sid = importlib.import_module(f"{cfg['package']}.models.system_id")
    mixed_step = sid.mixed_step
    solver = {k: qcqp.solver_config({"package": cfg["package"], "solver": v})
              for k, v in cfg["solver"].items()}
    adam = cfg["adam"]
    counts = torch.zeros(2, dtype=torch.int64, device=device)

    def step(*slot):
        params = sid.QCQPSystemIDParams(*(_fresh(x).requires_grad_() for x in slot[:4]))
        state = sid.AdamState(tuple(_fresh(x) for x in slot[5:9]),
                              tuple(_fresh(x) for x in slot[9:13]),
                              tuple(_fresh(slot[13]) for _ in PARAMS))
        out = mixed_step(params, slot[4], state, qp_config=solver["qp"],
                         qcqp_config=solver["qcqp"], learning_rate=adam["lr"])
        for st in out.stats:
            counts.add_(torch.stack([st.converged.sum(), st.iterations.sum()]))
        updates = tuple(p.detach() - p0 for p, p0 in zip(params, slot[:4]))
        return (out.l, *out.grads, *updates)

    return step, counts


def answers(out, traffic: dict) -> dict:
    """The step's output as named answers: l (2B, N) and each job's (B, ...)."""
    return dict(zip(ANSWERS, out))


def reference(inputs: tuple, traffic: dict, precision: str = "float64") -> tuple[dict, dict]:
    """The plain reference's answers to one ``Slot``, named as ``answers``
    names the step's, and what it found: the jobs whose QP and QCQP are
    both well posed (``qcqp.MARGIN``), the QCQPs' strictly active contacts,
    and the worst KKT residual of either."""
    cfg = inputs.cfg
    adam = cfg["adam"]
    r = ref.step(inputs[:4], inputs[4], inputs[5:9], inputs[9:13], inputs[13],
                 reg=cfg["law"]["reg"], lr=adam["lr"], betas=tuple(adam["betas"]),
                 eps=adam["eps"], precision=precision)
    want = dict(zip(ANSWERS, (r.l, *r.grads, *r.updates)))
    info = {"well_posed": nnqp.well_posed(r.sol_qp) & qcqp.well_posed(r.sol_qc),
            "active": r.sol_qc.active,
            "kkt": torch.maximum(nnqp.ref.residuals(r.sol_qp).max(),
                                 qcqp.ref.residuals(r.sol_qc).max())}
    return want, info
