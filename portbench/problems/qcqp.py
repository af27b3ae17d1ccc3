"""The dense friction-cone QCQP: its input law, the step the window drives,
and how its answers are held against the plain reference.

Inputs follow ``bench.py::_build_problems``'s law, drawn on the device from
the seed: s ~ N(0, 1) / sqrt(N), P = s s' + diag * I (symmetrised), q ~
q_std * N(0, 1), l_n and mu ~ U(low, high). The step is the package's
``solve_qcqp_with_stats`` and, where the traffic asks for a backward, the
gradient of sum(l^2) for P, q, l_n and mu, as a training step takes it.
"""

from __future__ import annotations

import importlib

import torch

from portbench.reference import qcqp as ref

INPUTS = ("P", "q", "l_n", "mu")


def draw_pq(cfg: dict, batches: int, seed: int, device: torch.device):
    """(generator, P, q): ``batches`` x B problems' P and q by the law of
    ``cfg["law"]``, drawn on ``device`` from ``seed`` in one call each;
    the generator goes on to draw any further inputs."""
    B, n = cfg["batch"], cfg["n"]
    law = cfg["law"]
    g = torch.Generator(device=device).manual_seed(int(seed))
    draw = dict(dtype=getattr(torch, cfg["dtype"]), device=device, generator=g)
    s = torch.randn(batches * B, n, n, **draw) / n ** 0.5
    P = torch.bmm(s, s.transpose(1, 2))
    del s
    P = 0.5 * (P + P.transpose(1, 2))
    P.diagonal(dim1=1, dim2=2).add_(law["diag"])
    q = torch.randn(batches * B, n, **draw) * law["q_std"]
    return g, P, q


def split(cfg: dict, batches: int, *xs) -> list[tuple]:
    """The pool: ``batches`` tuples of B-row slices of ``xs``, each contiguous."""
    B = cfg["batch"]
    return [tuple(x[k * B:(k + 1) * B].contiguous() for x in xs) for k in range(batches)]


def make_pool(cfg: dict, batches: int, seed: int, device: torch.device) -> list[tuple]:
    """``batches`` distinct input batches (P, q, l_n, mu) in the
    configuration's dtype, made on ``device`` from ``seed`` in one draw per
    input."""
    g, P, q = draw_pq(cfg, batches, seed, device)
    rows, nc, law = batches * cfg["batch"], cfg["contacts"], cfg["law"]
    draw = dict(dtype=P.dtype, device=device, generator=g)
    lo, hi = law["l_n"]
    l_n = torch.rand(rows, nc, **draw) * (hi - lo) + lo
    lo, hi = law["mu"]
    mu = torch.rand(rows, nc, **draw) * (hi - lo) + lo
    return split(cfg, batches, P, q, l_n, mu)


def solver_config(cfg: dict):
    """The package's SolverConfig that ``cfg["solver"]`` states."""
    dqt = importlib.import_module(cfg["package"])
    over = dict(cfg["solver"])
    base = getattr(dqt, over.pop("base"))
    return base.replace(**over)


def make_step(cfg: dict, traffic: dict, device: torch.device,
              entry: str = "solve_qcqp_with_stats"):
    """(step, counts): the step as a function of the input tensors, and the
    (2,) int64 tensor on ``device`` to which every call adds its batch's
    converged problems and iterations, in place, so that a staged step counts
    inside its graph and the host launches nothing to count. The step
    returns (l,) and, in a traffic with a backward, the gradients of sum(l^2)
    for every input. ``entry`` names the package's entry point; it is
    looked up at each call, so a test can put a broken one in its place."""
    dqt = importlib.import_module(cfg["package"])
    scfg = solver_config(cfg)
    backward = bool(traffic["backward"])
    dev = str(device)
    counts = torch.zeros(2, dtype=torch.int64, device=device)

    def step(*xs):
        if backward:
            xs = [x.detach().requires_grad_() for x in xs]
        l, st = getattr(dqt, entry)(*xs, config=scfg, device=dev)
        counts.add_(torch.stack([st.converged.sum(), st.iterations.sum()]))
        out = (l,)
        if backward:
            out = out + tuple(torch.autograd.grad((l * l).sum(), xs))
        return out

    return step, counts


def answers(out, traffic: dict, inputs=INPUTS) -> dict:
    """The step's output as named answers, each (B, ...)."""
    names = ("l",) + (tuple("d" + name for name in inputs) if traffic["backward"] else ())
    return dict(zip(names, out))


def reference(inputs: tuple, traffic: dict, precision: str = "float64") -> tuple[dict, dict]:
    """The plain reference's answers to one batch, named as ``answers``
    names the step's, and what it found: the mask of problems whose
    gradients are well posed, the strictly active contacts, and its worst
    KKT residual."""
    P, q, l_n, mu = inputs
    sol = ref.solve(P, q, l_n, mu, precision=precision)
    out = {"l": sol.l}
    if traffic["backward"]:
        grads = ref.gradients(sol, 2.0 * sol.l, l_n, mu)
        out.update({"d" + name: g for name, g in zip(INPUTS, grads)})
    info = {"well_posed": well_posed(sol), "active": sol.active,
            "kkt": ref.residuals(sol).max()}
    return out, info


# a problem's gradients are judged where each contact is strictly active or
# strictly inside its disk by this share: its multiplier at least this share
# of the batch's mean multiplier, or its distance to the rim at least this
# share of the radius. Closer, the derivative changes by orders of magnitude
# under float32 rounding of the inputs, and no float32 solver pins it
MARGIN = 1e-3


def well_posed(sol) -> torch.Tensor:
    """(B,) problems whose every contact clears ``MARGIN``."""
    B, n = sol.l.shape
    lam_scale = sol.lam[sol.active].abs().mean() if sol.active.any() else sol.lam.new_tensor(1.0)
    gap = (sol.r - sol.l.reshape(B, n // 2, 2).norm(dim=-1)) / sol.r
    clear = torch.where(sol.active, sol.lam >= MARGIN * lam_scale, gap >= MARGIN)
    return clear.all(-1)
