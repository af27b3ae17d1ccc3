"""The comparison that decides ``correct``: the step's kept answers against
the plain reference's, batch by batch of the pool, once the window has
closed and the program's state is freed.

Each answer is judged per problem: the norm of its gap to the reference over
the larger of the reference's own norm and the mean norm of that answer over
the batch (some problems' gradients of sum(l^2) are all but zero: every
contact on its rim makes sum(l^2) = sum r^2, whatever P and q). A number
compared is the widest such gap over every kept output (``<answer>_err``);
gradients over the problems the reference finds well posed
(``problems/<kind>.py``). Which of them a cell holds to a limit is in its
file under ``portbench/workloads/``.
"""

from __future__ import annotations

import torch

def gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """(B,) each problem's gap, as the module docstring says."""
    B = want.shape[0]
    got = got.detach().reshape(B, -1).double()
    want = want.reshape(B, -1).double()
    norm = want.norm(dim=-1)
    return (got - want).norm(dim=-1) / torch.maximum(norm, norm.mean()).clamp_min(1e-300)


class Comparison:
    """The worst gap of each answer over everything compared so far, and
    what the reference found."""

    def __init__(self):
        self.worst: dict[str, float] = {}
        self.compared = 0
        self.judged_grads = 0
        self.kkt = 0.0

    def add(self, got: dict, want: dict, info: dict) -> None:
        B = want["l"].shape[0]
        self.compared += B
        self.kkt = max(self.kkt, float(info["kkt"]))
        mask = info["well_posed"]
        for name, w in want.items():
            e = gaps(got[name], w)
            if not torch.isfinite(e).all():
                e = torch.full((1,), float("inf"), dtype=torch.float64)  # NaN or inf fails
            elif name != "l":
                e = e[mask]
            if not e.numel():
                continue
            self.worst[name] = max(self.worst.get(name, 0.0), float(e.max()))
        if len(want) > 1:
            self.judged_grads += int(mask.sum())

    def numbers(self) -> dict[str, float]:
        """{compared number's name: value}: ``<answer>_err``."""
        return {f"{k}_err": v for k, v in self.worst.items()}


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct where every number is
    at most its limit, and every limit has its number."""
    table = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        table[name] = {"value": v, "limit": limit}
        if v is None or not (v <= limit):
            ok = False
    return ok, table
