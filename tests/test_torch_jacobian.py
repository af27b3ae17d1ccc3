"""The port's full-Jacobian API (``diffqcqp_tpu_torch.diff.jacobian``,
``dqt.*_jacobian``) against the JAX package's (``diffqcqp_tpu.diff.
jacobian``): every field, float64, for the four classes with dense and
diagonal P, with a precomputed solution l and without one (then each side
solves with its own engine at eps=1e-11), ``include_dP=True``.

Problems: B=4, N=6 (QCQP: 3 contacts), P = S S^T + 0.1 I or a diagonal in
U(0.3, 1.3), the box rows' bounds from U(0.1, 1.0), q ~ N(0, 1) (mixed
active and inactive sets). Bar: atol 1e-9 on every field.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffqcqp_tpu as dq
from diffqcqp_tpu.diff import jacobian as jjac
import diffqcqp_tpu_torch as dqt

B, N = 4, 6
CFG = {"qp": dq.SolverConfig(eps=1e-11, max_iter=20000, backend="xla")}
CFG["box_qp"] = CFG["signed_box_qp"] = CFG["qp"]
CFG["qcqp"] = dq.QCQP_DEFAULTS.replace(eps=1e-11, max_iter=20000, backend="xla")


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(41)
    S = rng.standard_normal((B, N, N)) / np.sqrt(N)
    return dict(
        dense=S @ S.transpose(0, 2, 1) + 0.1 * np.eye(N),
        diag=rng.random((B, N)) + 0.3,
        q=rng.standard_normal((B, N)),
        lo=-(rng.random((B, N)) * 0.9 + 0.1),
        hi=rng.random((B, N)) * 0.9 + 0.1,
        v=rng.standard_normal((B, N)),
        l_n=rng.random((B, N // 2)) * 0.5 + 0.05,
        mu=rng.random((B, N // 2)) * 0.5 + 0.05,
    )


CASES = [(cls, kind, given) for cls in ("qp", "box_qp", "signed_box_qp", "qcqp")
         for kind in ("dense", "diag") for given in ("l_given", "l_solved")]


@pytest.mark.parametrize("cls,kind,given", CASES, ids=["-".join(c) for c in CASES])
def test_jacobian_matches_jax(problems, cls, kind, given):
    pr = problems
    xs = (pr[kind], pr["q"]) + {"qp": (), "box_qp": (pr["lo"], pr["hi"]),
                                "signed_box_qp": (pr["lo"], pr["hi"], pr["v"]),
                                "qcqp": (pr["l_n"], pr["mu"])}[cls]
    jcfg = CFG[cls]
    tcfg = dqt.SolverConfig.from_dict(dataclasses.asdict(jcfg))
    l = None
    if given == "l_given":
        l = np.asarray(getattr(dq, f"solve_{cls}")(*(jnp.asarray(x) for x in xs), config=jcfg))
    jname = f"{cls}_jacobian"
    want = getattr(jjac, jname)(*(jnp.asarray(x) for x in xs), l=l, config=jcfg,
                                include_dP=True)
    got = getattr(dqt, jname)(*(torch.tensor(x) for x in xs), l=l, config=tcfg,
                              include_dP=True, device="cpu")
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for field, a, b in zip(got._fields, got, want):
        assert a.dtype == torch.float64 and tuple(a.shape) == np.shape(b), field
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9, err_msg=field)


def test_jacobian_unbatched_and_default_device(problems, monkeypatch):
    """An unbatched problem gives unbatched Jacobians equal to the batched
    ones' first row; the default device raises without CUDA."""
    P, q = problems["dense"], problems["q"]
    cfg = dqt.SolverConfig.from_dict(dataclasses.asdict(CFG["qp"]))
    batched = dqt.qp_jacobian(P, q, config=cfg, device="cpu")
    single = dqt.qp_jacobian(P[0], q[0], config=cfg, device="cpu")
    assert single.dl_dP is None and single.dl_dq.shape == (N, N)
    np.testing.assert_allclose(single.dl_dq.numpy(), batched.dl_dq[0].numpy(), atol=1e-12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dqt.qp_jacobian(P, q, config=cfg)
