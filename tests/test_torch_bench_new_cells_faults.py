"""The check of the cell with a QCQP backward, ``sysid12.adam``: a run
driven on the CPU at a small size (the look for a card skipped) comes out
correct, and comes out not correct with the timed path broken underneath,
once for each fault the cell can have: a step that leaves its state
unchanged (no Adam update), half of the batch left out, one answer altered
by 1 % where it is produced, and one problem's radius gradients moved where
K2 produces them (its dgamma; dL/dl_n = e2 dgamma and dL/dmu = e1 dgamma).
The last is the fault a float32 K2 makes. It is planted at 2 %: the cell's
radius limits of 1e-2 (between the program's 7.0e-5 and the TF32 control's
0.51, with more room above the lower) a move of 1 % in one job's radius
gradients only reaches (9.6e-3 at this size)."""

import pytest
import torch

from diffqcqp_tpu_torch.diff import kkt
from diffqcqp_tpu_torch.models import system_id as sid
from portbench import run

CELL = "sysid12.adam"
K2_MOVE = 1.02
# 8 jobs, each a QP and a QCQP
SMALL = {"config": {"batch": 16}, "spec": {"pool": 2}}


@pytest.fixture(autouse=True)
def _jax_loaded(monkeypatch):
    # this suite's conftest imports JAX, which a run on the card refuses
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])


def _run(seed=2 ** 31 + 11):
    return run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.2", "--trace", "0"],
                    device=torch.device("cpu"), overrides=SMALL)


def _broken_solve(solve, fault):
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


def _break(fault, monkeypatch):
    if fault == "k2":
        real = kkt.qcqp_kkt_bwd_fused_cuda
        moved = []

        def k2(*args):
            dgamma, dl, gamma = real(*args)
            assert bool((dgamma[1] != 0).any())     # problem 1 has a binding contact
            moved.append(1)
            dgamma = dgamma.clone()
            dgamma[1] = dgamma[1] * K2_MOVE
            return dgamma, dl, gamma

        monkeypatch.setattr(kkt, "qcqp_kkt_bwd_fused_cuda", k2)
        return moved
    if fault == "unchanged":
        real_step = sid.mixed_step
        monkeypatch.setattr(sid, "mixed_step", lambda params, target, state, **kw: real_step(
            params, target, state, **{**kw, "learning_rate": 0.0}))
        return None
    names = ["solve_qcqp_with_stats"] + (["solve_qp_with_stats"] if fault == "half" else [])
    for name in names:
        monkeypatch.setattr(sid, name, _broken_solve(getattr(sid, name), fault))
    return None


def test_a_sound_run_of_a_qcqp_backward_cell_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "k2"])
def test_a_broken_qcqp_backward_step_is_not_correct(fault, monkeypatch):
    moved = _break(fault, monkeypatch)
    res = _run()
    if moved is not None:
        assert moved, "K2 did not run"
    assert not res["correct"], res["checks"]
    if fault == "k2":
        for name in ("dlog_l_n_err", "dlogit_mu_err"):
            assert res["checks"][name]["value"] > res["checks"][name]["limit"], res["checks"]
