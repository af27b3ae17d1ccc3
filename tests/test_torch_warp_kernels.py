"""The one-warp redesign of K2 / K6 (n <= 32) and of K4, on the CPU.

  * (a) The order of operations that the register factor
    (csrc/ldl.cuh::chol_factor_warp, right-looking) keeps: a right-looking
    factor written out in torch, each entry's subtractions in the order c =
    0, 1, ..., gives ``chol_factor``'s (left-looking) bits, with a per-row
    shift, at n = 12, 24 and 32.
  * (b) The sweeps of all nc + 1 right-hand sides from row 0
    (csrc/ldl.cuh::ldl_solve_warp) give ``ldl_solve`` with column c's
    forward sweep started at row 2c bit for bit, apart from the sign of
    zeros: the rows before 2c only subtract exact zeros.
  * (c) The one-warp launches: the wrappers' shared memory against the
    kernels' formulas, restated here from csrc/qcqp_bwd.cu and
    csrc/coord_bwd.cu, and K2 / K6 at n = 24 and 32 and K4 at n = 24 fit
    32 blocks, the most an SM holds, in an H100 SM's 233,472 bytes (1 KB
    reserved for each block), so the main path's batches (4096 and 2048
    problems) take one wave on 132 SMs.

K4's free-block compaction is pinned in tests/test_torch_coord_bwd.py; the
kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain versions there).
"""

import numpy as np
import pytest
import torch

from diffqcqp_tpu_torch.kernels import coord_bwd_cuda as k4
from diffqcqp_tpu_torch.kernels import qcqp_bwd_cuda as k26
from diffqcqp_tpu_torch.kernels.ldl import TINY, chol_factor, chol_to_unit, ldl_solve

SMEM_SM = 233472             # an H100 SM's shared memory (228 KB)
BLOCKS_SM = 32               # the most blocks an SM holds
SMS = 132


def _spd(n, seed, b=4):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((b, n, n)) / np.sqrt(n)
    P = S @ S.transpose(0, 2, 1) + 0.1 * np.eye(n)
    shift = rng.random((b, n)) * 0.5
    return torch.from_numpy(P.astype(np.float32)), torch.from_numpy(shift.astype(np.float32))


def _right_looking(P, shift):
    """chol_factor's factor by right-looking steps: at step j the column
    L[:, j] = a[:, j] / sqrt(max(a_jj, TINY)) below the diagonal, then the
    rank-one update of every later entry."""
    n = P.shape[-1]
    A = P.clone()
    idx = torch.arange(n)
    A[:, idx, idx] = A[:, idx, idx] + shift
    L = torch.zeros_like(P)
    for j in range(n):
        d = torch.clamp_min(A[:, j, j : j + 1], TINY)
        col = A[:, :, j] * (1.0 / torch.sqrt(d))
        col = torch.where(idx >= j, col, torch.zeros_like(col))
        L[:, :, j] = col
        A = A - col[:, :, None] * col[:, None, :]
    return L


@pytest.mark.parametrize("n", [12, 24, 32])
def test_right_looking_factor_gives_the_left_looking_bits(n):
    P, shift = _spd(n, seed=n)
    assert torch.equal(_right_looking(P, shift), chol_factor(P, shift))


@pytest.mark.parametrize("nc", [6, 12, 16])
def test_one_pair_of_sweeps_gives_the_started_sweeps(nc):
    n = 2 * nc
    P, shift = _spd(n, seed=100 + nc)
    Lh, dinv = chol_to_unit(chol_factor(P, shift))
    rng = np.random.default_rng(nc)
    for c in range(nc):
        rhs = torch.zeros(P.shape[0], n)
        rhs[:, 2 * c : 2 * c + 2] = torch.from_numpy(
            rng.standard_normal((P.shape[0], 2)).astype(np.float32))
        started = ldl_solve(Lh, dinv, rhs, start=2 * c)
        assert torch.equal(ldl_solve(Lh, dinv, rhs) + 0.0, started + 0.0)


@pytest.mark.parametrize("n", [2, 12, 24, 26, 32])
def test_one_warp_shared_memory_matches_the_kernels(n):
    nc, ld, ldm = n // 2, n | 1, (n // 2) | 1
    assert k26.smem_bytes(n) == 4 * (96 + n * ld + (nc + 1) * ldm + 3 * nc)
    assert k26.launch_plan(n) == (32, k26.smem_bytes(n), 32, 0)
    assert k4.smem_bytes(n) == 4 * (2 * n * ld + 128)


@pytest.mark.parametrize("n", [34, 96, 168])
def test_k4_above_one_warp_keeps_its_shared_memory(n):
    assert k4.smem_bytes(n) == 4 * (2 * n * (n | 1) + 6 * n)


@pytest.mark.parametrize("kernel,n", [("K2/K6", 24), ("K2/K6", 32), ("K4", 24)])
def test_one_warp_kernels_take_one_wave(kernel, n):
    smem = (k26 if kernel == "K2/K6" else k4).smem_bytes(n)
    assert BLOCKS_SM * (smem + 1024) <= SMEM_SM
    assert -(-4096 // (BLOCKS_SM * SMS)) == 1
