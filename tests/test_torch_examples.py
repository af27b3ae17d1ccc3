"""The torch twins of ``examples/`` (``examples_torch/``), each run at
``device="cpu"`` (the plain versions), checking what the JAX example
asserts: the assembled Jacobian equal to autograd's (1e-10, float64), the
derivatives surface equal to autograd's (1e-6), every sliding contact on
its cone boundary, the sharded solves within 1e-5 of the unsharded one in
both modes. The training loops run fewer steps than the scripts' defaults
and must cut their loss; the bridge example learns mu / mu0 = 0.8 to 2 %.
"""

import importlib
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples_torch"))


def _main(name):
    return importlib.import_module(name).main


def test_readme_example():
    first, last, stats = _main("readme_example")(device="cpu", steps=101)
    assert bool(stats.converged.all())
    assert last < 1e-3 * first


def test_sensitivity_jacobian():
    assert _main("sensitivity_jacobian")(device="cpu") < 1e-10


def test_contact_multipliers():
    sliding, err = _main("contact_multipliers")(device="cpu")
    assert sliding > 0 and err <= 1e-6


def test_contact_system_id():
    losses = _main("contact_system_id")(device="cpu", steps=8, B=8, T=20)
    assert losses[-1] < 0.5 * losses[0]


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_batch(shards):
    assert _main("sharded_batch")(device="cpu", shards=shards) < 1e-5


def test_torch_bridge_example():
    first, last, ratio = _main("torch_bridge_example")(device="cpu", steps=76)
    assert last < 0.1 * first
    assert abs(ratio - 0.8) < 0.02


def test_examples_import_only_the_port():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder = os.path.join(root, "examples_torch")
    names = sorted(f for f in os.listdir(folder) if f.endswith(".py"))
    assert names == sorted(f for f in os.listdir(os.path.join(root, "examples"))
                           if f.endswith(".py"))
    for f in names:
        with open(os.path.join(folder, f)) as fh:
            text = fh.read()
        assert "import jax" not in text and "diffqcqp_tpu " not in text
        assert "import diffqcqp_tpu\n" not in text and "from diffqcqp_tpu." not in text
        assert "def main(device=\"cuda\"" in text, f
