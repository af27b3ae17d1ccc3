"""``SystemID``'s mixed kind (config 4: a QP and a QCQP on the same S and q),
on the CPU:

  * its loss and gradients equal the sums of the one-class kinds' (their
    maps at the mixed kind's reg 0.1, ``solve_qp`` and ``solve_qcqp``, each
    one mean squared error) at the same parameters (the two solves share
    nothing but P and q; the loss to one float32 rounding, 1e-7; the
    gradients of S and q to 1e-6 of their scale, since the mixed kind adds
    the two dP before the Gram's backward and the sum of the two kinds
    after it, a few roundings apart);
  * ``train_step`` (``mixed_step``) moves the parameters as
    ``torch.optim.Adam.step`` does on the same gradients, bit for bit, and
    leaves Adam's state where that step leaves it;
  * ``mixed_step`` driven with a caller's parameters and Adam state, as
    ``portbench/problems/sysid.py`` drives it (copies of a pool slot: the
    moments at step 10), against the plain float64 reference
    ``portbench/reference/sysid.py``: l, the four gradients and the four
    updates, per job ||got - want|| / max(||want||, mean ||want||) as the
    benchmark's check. In float64 (the eager engine and the generic
    adjoint, eps 1e-12): 1e-8 (read ~7e-11: the solves' stopping tolerance
    carried through the KKT adjoint and Adam); in float32 (K1's, K4's and
    K2's plain versions, config 4's eps 1e-7): 2e-4 for l, 5e-4 for the
    gradients and 1e-3 for the updates (read 2.6e-5, 4.3e-5 and 2.6e-4:
    float32 solves at eps 1e-7 on P's conditioning, the S update's moments
    taking the gradient's error over a tenth of its own scale).

Sizes: 8 jobs of N = 6 (3 contacts).
"""

import json
from pathlib import Path

import pytest
import torch

import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.models import system_id as sid
from portbench.check import gaps
from portbench.problems import sysid as bench

ROOT = Path(__file__).resolve().parents[1]
B, NC = 8, 3
N = 2 * NC
QP = dqt.QP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0, rho_update_period=24)
QC = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400, rho0_scale=2.0, rho_update_period=24,
                               power_iters=10)


def _params(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    draw = dict(generator=g, dtype=dtype)
    return (torch.randn(B, N, N, **draw) / N ** 0.5, torch.randn(B, N, **draw) * 0.3,
            torch.randn(B, NC, **draw) * 0.1, torch.randn(B, NC, **draw) * 0.1,
            torch.rand(B, N, **draw) * 0.1)


def _model(kind, params, **kw):
    m = sid.SystemID(kind=kind, device="cpu", learning_rate=1e-2, **kw)
    cls = sid.QPSystemIDParams if kind == "qp" else sid.QCQPSystemIDParams
    m.set_params(cls(*(x.clone() for x in params[: len(cls._fields)])))
    return m


def test_mixed_loss_and_gradients_are_the_sums_of_the_two_kinds():
    *params, target = _params()
    mixed = _model("mixed", params, config=QC, qp_config=QP)
    qp = sid.QPSystemIDParams(*(x.clone().requires_grad_() for x in params[:2]))
    qc = sid.QCQPSystemIDParams(*(x.clone().requires_grad_() for x in params))
    # the one-class kinds' solves at the mixed kind's reg 0.1
    l_qp = dqt.solve_qp(*sid.qp_params_to_problem(qp, 0.1), config=QP, device="cpu")
    l_qc = dqt.solve_qcqp(*sid.qcqp_params_to_problem(qc, 0.1), config=QC, device="cpu")
    losses = [mixed.loss(target), torch.mean((l_qp - target) ** 2),
              torch.mean((l_qc - target) ** 2)]
    for loss in losses:
        loss.backward()
    torch.testing.assert_close(losses[0], losses[1] + losses[2], rtol=1e-7, atol=0)
    for name in ("S", "q"):
        want = getattr(qp, name).grad + getattr(qc, name).grad
        torch.testing.assert_close(getattr(mixed, name).grad, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
    for name in ("log_l_n", "logit_mu"):
        assert torch.equal(getattr(mixed, name).grad, getattr(qc, name).grad)
    l = mixed()
    assert l.shape == (2 * B, N)
    assert torch.equal(l[:B], l_qp.detach()) and torch.equal(l[B:], l_qc.detach())


def test_mixed_train_step_is_torch_adams_step():
    *params, target = _params()
    m = _model("mixed", params, config=QC, qp_config=QP)
    ps = [x.clone().requires_grad_() for x in params]
    opt = torch.optim.Adam(ps, lr=1e-2)
    for _ in range(2):          # the second step from the first's state
        ref = _model("mixed", [p.detach() for p in ps], config=QC, qp_config=QP)
        loss = ref.loss(target)
        for p, g in zip(ps, torch.autograd.grad(loss, tuple(ref.params))):
            p.grad = g
        opt.step()
        assert torch.equal(m.train_step(target), loss.detach())
    for got, want in zip(m.params, ps):
        assert torch.equal(got.detach(), want.detach())
    st = m.adam_state()
    assert [float(s) for s in st.step] == [2.0] * 4
    for k, p in enumerate(ps):
        assert torch.equal(st.exp_avg[k], opt.state[p]["exp_avg"])
        assert torch.equal(st.exp_avg_sq[k], opt.state[p]["exp_avg_sq"])


def _bench_cfg(dtype, eps):
    cfg = json.loads((ROOT / "portbench" / "configs" / "sysid12.json").read_text())
    cfg.update(batch=2 * B, contacts=NC, n=N, dtype=dtype)
    for solver in cfg["solver"].values():
        solver["eps"] = eps
        if dtype == "float64":
            solver["max_iter"] = 4000
    return cfg


@pytest.mark.parametrize("dtype, eps, bars", [
    ("float64", 1e-12, {"l": 1e-8, "grad": 1e-8, "update": 1e-8}),
    ("float32", 1e-7, {"l": 2e-4, "grad": 5e-4, "update": 1e-3}),
], ids=["f64", "f32"])
def test_mixed_step_matches_the_plain_reference(dtype, eps, bars):
    cfg = _bench_cfg(dtype, eps)
    cpu = torch.device("cpu")
    (slot,) = bench.make_pool(cfg, 1, 2 ** 31 + 5, cpu)
    before = [x.clone() for x in slot]
    step, counts = bench.make_step(cfg, {"backward": True}, cpu)
    got = bench.answers(step(*slot), {"backward": True})
    assert all(torch.equal(a, b) for a, b in zip(slot, before))     # a pure function of the slot
    assert int(counts[0]) == 2 * B                                   # both solves converged
    want, info = bench.reference(slot, {"backward": True})
    assert set(got) == set(want) == set(bench.ANSWERS)
    mask = info["well_posed"]
    assert int(mask.sum()) >= B - 1
    for name in bench.ANSWERS:
        e = gaps(got[name], want[name])
        kind = "l" if name == "l" else ("update" if name.startswith("update_") else "grad")
        worst = float((e if name == "l" else e[mask]).max())
        assert worst <= bars[kind], (name, worst)


def test_the_sysid_reference_imports_nothing_of_the_port():
    import subprocess
    import sys

    code = ("import sys; import portbench.reference.sysid; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('diffqcqp_tpu_torch', 'diffqcqp_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("fault", [None, "no_update", "one_gradient"])
def test_the_sysid_cells_check_sees_a_broken_step(monkeypatch, fault):
    """``portbench/run.py`` on the CPU at a small size: correct with the
    model's step; not correct where the update is left out (the state
    unchanged) or one job's gradient of S is moved by 1 % where it is made."""
    from portbench import run

    real = sid.mixed_step

    def broken(params, target, state, **kw):
        if fault == "no_update":
            kw["learning_rate"] = 0.0
        out = real(params, target, state, **kw)
        if fault == "one_gradient":
            dS = out.grads.S.clone()
            dS[1] = dS[1] * 1.01
            out = out._replace(grads=out.grads._replace(S=dS))
        return out

    monkeypatch.setattr(sid, "mixed_step", broken)
    # this suite's conftest imports JAX, which a run on the card refuses
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    res = run.main(["--workload", "sysid12.adam", "--seed", str(2 ** 31 + 11), "--seconds", "0.1",
                    "--trace", "0"], device=torch.device("cpu"),
                   overrides={"config": {"batch": 2 * B}, "spec": {"pool": 2}})
    assert res["correct"] is (fault is None), res["checks"]
