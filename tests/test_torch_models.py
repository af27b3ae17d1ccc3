"""The port's models (``diffqcqp_tpu_torch.models``) against the JAX
package's, on the same numpy inputs:

  * ``SystemID`` (qp dense, qp diagonal, qcqp) against the JAX package's
    with ``optax.adam``, parameters carried by ``params_from_numpy``, a
    float64 config at eps=1e-10: forward, loss and gradients within 1e-8;
    the parameters after 3 Adam steps within 1e-6 (Adam's first step moves
    each coordinate by +-lr whatever the gradient's size, so only a
    gradient near zero can tell the two apart);
  * ``simulate`` (warm and cold starts) in float64 with the models' own
    configs (eps=1e-7): positions within 1e-7 (a position moves by dt
    delta_l / m, and the solves stop at eps=1e-7), mean iterations per step
    within 1; the gradient of ``trajectory_loss`` against ``jax.grad``
    within 1e-6 relative; ``make_system_id_step`` against the JAX one with
    ``optax.adam``, 2 steps, the raw parameters within 1e-6; the normal
    QP's dummy coordinate has a zero gradient.

Sizes: B=4, N=6 (QCQP: 3 contacts); the rollout B=4, T=8.
"""

import dataclasses

import numpy as np
import pytest
import torch

optax = pytest.importorskip("optax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffqcqp_tpu as dq  # noqa: E402
from diffqcqp_tpu.models import contact_sim as jcs  # noqa: E402
from diffqcqp_tpu.models import system_id as jsid  # noqa: E402
import diffqcqp_tpu_torch as dqt  # noqa: E402
from diffqcqp_tpu_torch.models import contact_sim as tcs  # noqa: E402
from diffqcqp_tpu_torch.models import system_id as tsid  # noqa: E402

LR = 1e-2


def _port_cfg(cfg):
    return dqt.SolverConfig.from_dict(dataclasses.asdict(cfg))


SID_CASES = {"qp_dense": ("qp", False), "qp_diag": ("qp", True), "qcqp": ("qcqp", False)}


@pytest.mark.parametrize("case", list(SID_CASES))
def test_system_id_matches_jax(case):
    kind, diag = SID_CASES[case]
    base = dq.QP_DEFAULTS if kind == "qp" else dq.QCQP_DEFAULTS
    jcfg = base.replace(eps=1e-10, max_iter=5000)
    jm = jsid.SystemID(kind=kind, config=jcfg, learning_rate=LR)
    key = jax.random.key(5)
    params = jm.init_qp(key, batch=4, n=6, diag=diag) if kind == "qp" else jm.init_qcqp(
        key, batch=4, nc=3)
    target = np.random.default_rng(6).random((4, 6)) * 0.1

    tm = tsid.SystemID(kind=kind, config=_port_cfg(jcfg), learning_rate=LR, device="cpu")
    tm.set_params(tsid.params_from_numpy(params, device="cpu"))
    assert all(isinstance(p, torch.nn.Parameter) for p in tm.params)
    assert [n for n, _ in tm.named_parameters()] == list(tm.params._fields)

    np.testing.assert_allclose(tm().detach().numpy(), np.asarray(jm.forward(params)), atol=1e-8)
    jloss, jgrads = jax.value_and_grad(jm.loss)(params, jnp.asarray(target))
    tloss = tm.loss(torch.tensor(target))
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-8
    for p, g in zip(tm.params, jgrads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=1e-8)

    state = jm.opt.init(params)
    tm.set_params(tsid.params_from_numpy(params, device="cpu"))
    for _ in range(3):
        params, state, jl = jm.train_step(params, state, jnp.asarray(target))
        tl = tm.train_step(torch.tensor(target))
        assert abs(float(tl) - float(jl)) <= 1e-8
    for p, j in zip(tm.params, params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=1e-6)


def test_system_id_init_is_seeded_and_device_independent():
    """init_* draw from the given generator on the CPU: one seed, one set of
    parameters; the problem maps give an SPD P and (0, 1) friction."""
    m = tsid.SystemID(kind="qcqp", device="cpu")
    a = m.init_qcqp(torch.Generator().manual_seed(3), batch=2, nc=2)
    a = [x.detach().clone() for x in a]
    b = m.init_qcqp(torch.Generator().manual_seed(3), batch=2, nc=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    P, _, l_n, mu = tsid.qcqp_params_to_problem(m.params)
    assert bool((torch.linalg.eigvalsh(P) > 0).all()) and bool(((mu > 0) & (mu < 1)).all())
    with pytest.raises(ValueError):
        tsid.SystemID(kind="lp")


def _rollout_inputs(b=4, t=8, seed=11):
    """run_benchmarks.py config 11's generator at a small size, float64."""
    rng = np.random.default_rng(seed)
    mass = rng.random(b) * 2.0 + 0.5
    mu = rng.random(b) * 0.6 + 0.2
    v0 = rng.standard_normal((b, 3))
    v0[:, 2] = 0.0
    steps = rng.standard_normal((t, b, 3)) * 0.15
    steps[:, :, 2] = 0.0
    f = np.cumsum(steps, axis=0) + rng.standard_normal((1, b, 3)) * np.array([2.0, 2.0, 0.0])
    return (jcs.ContactParams(mass=mass, mu=mu),
            jcs.ContactState(x=np.zeros((b, 3)), v=v0), f)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_simulate_matches_jax(warm):
    params, state0, f = _rollout_inputs()
    jfinal, jtraj, jst = jcs.simulate(
        jcs.ContactParams(*map(jnp.asarray, params)), jcs.ContactState(*map(jnp.asarray, state0)),
        jnp.asarray(f), warm_start=warm, return_stats=True)
    tfinal, ttraj, tst = tcs.simulate(
        tcs.params_from_numpy(params, "cpu"), tcs.params_from_numpy(state0, "cpu"),
        torch.tensor(f), warm_start=warm, return_stats=True, device="cpu")
    assert ttraj.x.shape == (8, 4, 3) and ttraj.x.dtype == torch.float64
    np.testing.assert_allclose(ttraj.x.numpy(), np.asarray(jtraj.x), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tfinal.x.numpy(), np.asarray(jfinal.x), rtol=0, atol=1e-7)
    for k in ("qp_iters", "qcqp_iters"):
        assert np.abs(tst[k].numpy() - np.asarray(jst[k])).max() <= 1.0, k


def test_trajectory_loss_grad_matches_jax():
    params, state0, f = _rollout_inputs()
    target = np.random.default_rng(12).standard_normal((8, 4, 3)) * 0.01
    j_state0 = jcs.ContactState(*map(jnp.asarray, state0))

    def jloss(mass, mu):
        return jcs.trajectory_loss(jcs.ContactParams(mass, mu), j_state0, jnp.asarray(f),
                                   jnp.asarray(target))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1))(*map(jnp.asarray, params))
    tp = [x.requires_grad_() for x in tcs.params_from_numpy(params, "cpu")]
    tl = tcs.trajectory_loss(tcs.ContactParams(*tp), tcs.params_from_numpy(state0, "cpu"),
                             torch.tensor(f), torch.tensor(target), device="cpu")
    tg = torch.autograd.grad(tl, tp)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * np.abs(b).max())


def test_make_system_id_step_matches_jax():
    params, state0, f = _rollout_inputs(t=6)
    target = np.asarray(jcs.simulate(jcs.ContactParams(*map(jnp.asarray, params)),
                                     jcs.ContactState(*map(jnp.asarray, state0)),
                                     jnp.asarray(f))[1].x)
    raw0 = {"log_mass": np.zeros(4), "logit_mu": np.zeros(4)}
    opt = optax.adam(0.05)
    jstep, _ = jcs.make_system_id_step(opt, jcs.ContactState(*map(jnp.asarray, state0)),
                                       jnp.asarray(f), jnp.asarray(target))
    jraw = {k: jnp.asarray(v) for k, v in raw0.items()}
    jstate = opt.init(jraw)
    raw = {k: torch.tensor(v, requires_grad=True) for k, v in raw0.items()}
    tstep, raw_to_params = tcs.make_system_id_step(
        raw, tcs.params_from_numpy(state0, "cpu"), torch.tensor(f), torch.tensor(target),
        learning_rate=0.05, device="cpu")
    for _ in range(2):
        jraw, jstate, jl = jstep(jraw, jstate)
        tl = tstep()
        assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    for k in raw:
        np.testing.assert_allclose(raw[k].detach().numpy(), np.asarray(jraw[k]), atol=1e-6)
    assert isinstance(raw_to_params(raw), tcs.ContactParams)


def test_dummy_coordinate_gradient_is_exactly_zero():
    """The normal QP's second coordinate has q = 1, so l = 0 and its
    adjoint is exactly 0: the loss does not see it."""
    P = torch.tensor([[1.0, 1.0], [0.5, 0.5]], requires_grad=True)
    q = torch.tensor([[-0.3, 1.0], [0.2, 1.0]], requires_grad=True)
    l = dqt.solve_qp(P, q, config=_port_cfg(jcs.QP_CFG), device="cpu")
    assert torch.equal(l[:, 1], torch.zeros(2))
    gP, gq = torch.autograd.grad((l * l).sum() + l.sum(), (P, q))
    assert torch.equal(gP[:, 1], torch.zeros(2)) and torch.equal(gq[:, 1], torch.zeros(2))


def test_resting_body_stays_put():
    """tests/test_contact_sim.py's resting probe at T=10: a body at rest on
    the plane stays there (1e-5, ~10x the solver eps)."""
    b = 4
    params = tcs.ContactParams(mass=torch.ones(b, dtype=torch.float64),
                               mu=torch.full((b,), 0.5, dtype=torch.float64))
    s0 = tcs.ContactState(x=torch.zeros(b, 3, dtype=torch.float64),
                          v=torch.zeros(b, 3, dtype=torch.float64))
    final, traj = tcs.simulate(params, s0, torch.zeros(10, b, 3, dtype=torch.float64),
                               device="cpu")
    assert float(final.x.abs().max()) < 1e-5 and float(traj.v[:, :, 2].abs().max()) < 1e-5
