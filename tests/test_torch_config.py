"""The port's SolverConfig against the JAX package's, and the port's import
boundary (it loads neither jax nor any diffqcqp_tpu module)."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import diffqcqp_tpu.config as jcfg
import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.config import check_supported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "port, ref",
    [
        (dqt.SolverConfig(), jcfg.SolverConfig()),
        (dqt.QP_DEFAULTS, jcfg.QP_DEFAULTS),
        (dqt.QCQP_DEFAULTS, jcfg.QCQP_DEFAULTS),
    ],
    ids=["SolverConfig", "QP_DEFAULTS", "QCQP_DEFAULTS"],
)
def test_defaults_match_field_by_field(port, ref):
    pf = [f.name for f in dataclasses.fields(port)]
    rf = [f.name for f in dataclasses.fields(ref)]
    assert pf == rf
    for name in rf:
        assert getattr(port, name) == getattr(ref, name), name


def test_from_dict_round_trips_a_jax_config():
    ref = jcfg.QCQP_DEFAULTS.replace(
        eps=1e-7, max_iter=400, rho0_scale=2.0, power_iters=10,
        rho_update_period=24, equilibrate=True, compact_iters="auto",
    )
    port = dqt.SolverConfig.from_dict(dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.replace(eps=1e-3).eps == 1e-3 and port.eps == 1e-7


def test_from_dict_rejects_unknown_keys():
    d = dataclasses.asdict(jcfg.SolverConfig())
    d["tile_m"] = 8
    with pytest.raises(ValueError, match="tile_m"):
        dqt.SolverConfig.from_dict(d)


@pytest.mark.parametrize("k", [0, 5, "auto", -1])
def test_compact_iters_valid_values(k):
    assert dqt.SolverConfig(compact_iters=k).compact_iters == k


@pytest.mark.parametrize("k", [-2, 1.5, True, "off", None])
def test_compact_iters_validated_on_every_path(k):
    with pytest.raises(ValueError, match="compact_iters"):
        dqt.SolverConfig(compact_iters=k)
    with pytest.raises(ValueError, match="compact_iters"):
        dqt.QCQP_DEFAULTS.replace(compact_iters=k)


@pytest.mark.parametrize(
    "over, item",
    [({"accel": True, "alpha_relax": 1.0, "adaptive_rho": False}, None),
     ({"axis_name": "b"}, "item 8"), ({"backend": "xla"}, None)],
    ids=["accel", "axis_name", "xla"],
)
def test_unported_settings_raise(over, item):
    """Only axis_name is left unported and raises (ROADMAP Queue 1, item 8).
    accel and backend='xla', which raised until the eager engine was
    ported, now run through it: check_supported passes, which_backend says
    'xla', and the solve returns the closed-form solution of this diagonal
    problem (l = r (-q) / |q| per contact, the cone binding)."""
    cfg = dqt.SolverConfig(**over)
    args = ([[1.0, 0.0], [0.0, 1.0]], [1.0, 1.0], [1.0], [1.0])
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            check_supported(cfg)
        with pytest.raises(NotImplementedError):
            dqt.solve_qcqp(*args, config=cfg, device="cpu")
        return
    check_supported(cfg)
    assert dqt.which_backend(args[0], args[1], cfg) == "xla"
    l = dqt.solve_qcqp(*args, config=cfg.replace(eps=1e-9, max_iter=5000), device="cpu")
    expect = -torch.tensor([1.0, 1.0]) / (2.0 ** 0.5)
    assert torch.allclose(l.to(expect.dtype), expect, atol=1e-6), l


def test_tpu_only_fields_accepted():
    cfg = dqt.SolverConfig(pallas_tile_b=128, pallas_rolled="on",
                           compact_iters=7, lmax_method="eigh", backend="pallas")
    check_supported(cfg)


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys\n"
        "import diffqcqp_tpu_torch, diffqcqp_tpu_torch.api\n"
        "import diffqcqp_tpu_torch.kernels.admm_cuda, diffqcqp_tpu_torch.kernels._build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "       or m == 'diffqcqp_tpu' or m.startswith('diffqcqp_tpu.')\n"
        "       or m == 'triton' or m.startswith('triton.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
