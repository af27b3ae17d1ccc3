"""``torch.func.vmap(torch.func.jacrev(solve))`` over single problems, the
four classes with dense and diagonal P, float64 (``tests/test_torch_vmap.py``'s
problems: B=4, N=6, seed 41, eps=1e-11), against the port's ``*_jacobian``
and the JAX package's ``jax.vmap(jax.jacrev(...))``: atol 1e-9, the bar of
``tests/test_torch_jacobian.py``. For a diagonal P the derivative with
respect to diag(P) is the diagonal of ``*_jacobian``'s dl_dP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev, vmap

import diffqcqp_tpu as dq
import diffqcqp_tpu_torch as dqt

from .test_torch_vmap import CLASSES, JCFG, T, _inputs, _port_cfg, problems  # noqa: F401

JAC_FIELDS = {"qp": ("dl_dP", "dl_dq"), "box_qp": ("dl_dP", "dl_dq", "dl_dl_min", "dl_dl_max"),
              "qcqp": ("dl_dP", "dl_dq", "dl_dl_n", "dl_dmu")}
JAC_FIELDS["signed_box_qp"] = JAC_FIELDS["box_qp"]
JAC_CASES = [(cls, kind) for cls in CLASSES for kind in ("dense", "diag")]


@pytest.mark.parametrize("cls,kind", JAC_CASES, ids=["-".join(c) for c in JAC_CASES])
def test_vmap_jacrev_matches_jacobian_and_jax(problems, cls, kind):
    xs, argnums = _inputs(problems, cls, kind)
    jcfg = JCFG[cls]
    tcfg = _port_cfg(jcfg)
    tsolve = getattr(dqt, f"solve_{cls}")
    jsolve = getattr(dq, f"solve_{cls}")
    got = vmap(jacrev(lambda *a: tsolve(*a, config=tcfg, device="cpu"), argnums=argnums))(
        *(T(x) for x in xs))
    want = jax.vmap(jax.jacrev(lambda *a: jsolve(*a, config=jcfg), argnums=argnums))(
        *(jnp.asarray(x) for x in xs))
    jac = getattr(dqt, f"{cls}_jacobian")(*(T(x) for x in xs), config=tcfg, include_dP=True,
                                         device="cpu")
    for field, a, b in zip(JAC_FIELDS[cls], got, want):
        assert a.dtype == torch.float64 and tuple(a.shape) == np.shape(b), field
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9, err_msg=field)
        ref = getattr(jac, field)
        if field == "dl_dP" and kind == "diag":     # d l / d diag(P): dl_dP's diagonal
            ref = torch.diagonal(ref, dim1=-2, dim2=-1)
        np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=0, atol=1e-9, err_msg=field)
