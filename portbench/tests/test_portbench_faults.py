"""The check itself: a run driven on the CPU at a small size (the look for a
card skipped) comes out correct, and comes out not correct with the timed
path broken underneath, once for each fault a cell can have (a step that
returns its state unchanged, half of the batch left out, one answer
altered where it is produced), and with the TF32 control in the program's
place. The cells run on one card, so no exchange between cards can be left
out."""

import pytest
import torch

import diffqcqp_tpu_torch as dqt
from portbench import run

SMALL = {"config": {"batch": 48}, "spec": {"pool": 2}}
CELLS = ["nnqp96.train", "nnqp24.train", "contact12.sim", "nnqp96.sim"]
ENTRY = {"contact12": "solve_qcqp_with_stats", "nnqp24": "solve_qp_with_stats",
         "nnqp96": "solve_qp_with_stats"}


def _run(cell, seed=2 ** 31 + 11):
    return run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2", "--trace", "0"],
                    device=torch.device("cpu"), overrides=SMALL)


def _broken(entry, fault):
    solve = getattr(dqt, entry)

    def wrapped(P, q, *params, **kw):
        if fault == "half":
            h = q.shape[0] // 2
            l_half, st = solve(P[:h], q[:h], *(x[:h] for x in params), **kw)
            return torch.cat([l_half, l_half]), type(st)(*[torch.cat([x, x]) for x in st])
        l, st = solve(P, q, *params, **kw)
        if fault == "unchanged":       # the solver's state as it starts: l = 0
            return l * 0, st
        if fault == "altered":         # one problem's answer moved where it is made
            bump = torch.zeros_like(l)
            bump[1, 0] = 1e-2 * float(l[1].detach().abs().max())
            return l + bump, st
        raise ValueError(fault)

    return wrapped


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    entry = ENTRY[run.load_cell(cell)["cell"]["config"]]
    monkeypatch.setattr(dqt, entry, _broken(entry, fault))
    res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(cell):
    """The reference in TF32 put in the program's place (at a small size;
    ``calibrate.py`` reads it at the cell's size on the card)."""
    import importlib

    from portbench.check import Comparison, verdict

    spec = run.load_cell(cell)
    cfg = {**spec["config"], "batch": 256}
    problem = importlib.import_module(f"portbench.problems.{cfg['problem']}")
    pool = problem.make_pool(cfg, 2, 5, torch.device("cpu"))
    cmp = Comparison()
    for x in pool:
        want, info = problem.reference(x, spec["traffic"])
        got, _ = problem.reference(x, spec["traffic"], precision="tf32")
        cmp.add(got, want, info)
    ok, table = verdict(cmp.numbers(), spec["spec"]["limits"])
    assert not ok, table
