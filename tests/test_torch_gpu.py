"""Tests of the port that need a CUDA card (marker ``gpu``): each skips
without one. They import no JAX; run them on a card with

    python -m pytest --noconftest -o addopts='' -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other
files).
"""

import numpy as np
import pytest
import torch

import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.parallel import make_batch_mesh, solve_qcqp_sharded

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _flagship(b, nc=12, seed=0):
    """bench.py's QCQP generator, float32."""
    n = 2 * nc
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n, n)).astype(np.float32) / np.sqrt(n)
    P = s @ s.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32)
    q = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    l_n = (rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32)
    mu = (rng.random((b, nc)) * 0.5 + 0.05).astype(np.float32)
    return P, q, l_n, mu


@pytest.mark.parametrize("lockstep", [False, True], ids=["independent", "lockstep"])
def test_sharded_solve_runs_on_the_callers_stream(card, lockstep):
    """The inputs are filled on a side stream after ~50 ms of other work on
    it, and the sharded solve is called under that stream: its shards must
    wait for the fill (they run on the caller's stream, also in lockstep's
    shard threads), so l equals the unsharded solve of the same inputs
    (within 1e-5: lockstep runs the engine, which rounds otherwise at
    another batch size). A shard on the default stream would read zeros."""
    cfg = dqt.QCQP_DEFAULTS.replace(eps=1e-7, max_iter=400)
    src = [torch.tensor(x, device=card) for x in _flagship(512)]
    l_ref, _ = dqt.solve_qcqp_with_stats(*src, config=cfg)
    xs = [torch.zeros_like(x) for x in src]
    torch.cuda.synchronize(card)
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        for x, s in zip(xs, src):
            x.copy_(s)
        l, st = solve_qcqp_sharded(*xs, mesh=make_batch_mesh([card, card]), config=cfg,
                                   lockstep=lockstep)
        l = l.clone()
    side.synchronize()
    torch.cuda.synchronize(card)
    assert bool(st.converged.all())
    assert float((l - l_ref).abs().max()) <= 1e-5
