"""K1's one-warp path (n <= 32, ``csrc/admm.cu::admm_kernel_warp``): its
launch plan, its shared memory and the order of its segment sums.

The kernel itself runs only on the card (``chip_smoke.py`` phase 2 holds it
bit for bit against ``admm_solve_plain``). What the card run rests on and
the CPU can check: which instance takes each n and how many problems share
a warp, the shared-memory layout (its size and the 16-byte alignment of
every float4 and double2 view), and that a butterfly over a segment of 8 or
16 lanes adds in ``_block_sum``'s order, so that two and four problems a
warp keep the plain version's bits.
"""

import numpy as np
import pytest
import torch

from diffqcqp_tpu_torch.kernels import _build
from diffqcqp_tpu_torch.kernels import admm_cuda as tk

# (kN, problems a warp) of each one-warp instance, by the largest n it takes
INSTANCES = {8: (8, 4), 16: (16, 2), 24: (24, 1), 32: (32, 1)}


@pytest.mark.parametrize("n", range(1, 34))
def test_launch_plan_takes_the_smallest_instance(n):
    inst, problems, threads, smem = tk.launch_plan(n)
    if n <= tk.ONE_WARP_MAX_N:
        N, G = INSTANCES[next(k for k in INSTANCES if n <= k)]
        assert (inst, problems, threads) == (N, G, 32)
        assert G * N <= 32                   # a segment of 32 / G lanes holds N rows
    else:      # past one warp, the register instance of row_threads(n) threads
        assert (inst, problems, threads) == (64, 1, _build.row_threads(n))
    assert smem == tk.smem_bytes(n)
    assert tk.fits(n)


def test_launch_plan_refuses_an_empty_problem():
    with pytest.raises(ValueError):
        tk.launch_plan(0)


@pytest.mark.parametrize("n", [1, 8, 9, 12, 16, 17, 24, 25, 32])
def test_one_warp_shared_memory(n):
    # a segment: 4 kN + 4 floats of scratch (rhs and res as floats, l0 as
    # doubles; or kN float4 columns and 4 pivots), 12 for tau_inc, tau_dec,
    # the last rho move and the problem's results, 4 kN for the prox's
    # arguments and q, 5 (32 / kG) for a lane's parked loop state, then P in
    # kN rows of stride kN + 2; kG segments a block
    N, G = INSTANCES[next(k for k in INSTANCES if n <= k)]
    seg, plane, ld = 4 * N + 4 + 12 + 4 * N + 5 * (32 // G), N * (N + 2), N + 2
    assert tk.smem_bytes(n) == 4 * G * (seg + plane)
    # every float4 / double2 view starts on 16 bytes (the segments' scratch
    # and planes, the l0 doubles at 2 kN floats in), P's rows on 8
    assert (4 * seg) % 16 == 0 and (4 * plane) % 16 == 0 and (4 * G * seg) % 16 == 0
    assert (4 * 2 * N) % 16 == 0 and (4 * ld) % 8 == 0
    # a half-warp's float2 loads of sixteen rows fall in distinct bank pairs
    assert len({(r * ld // 2) % 16 for r in range(16)}) == 16
    # the flagship's instance keeps 32 blocks an SM in shared memory (one
    # wave at B=4096 on 132 SMs), under 4 KB
    if N == 24:
        assert 32 * (tk.smem_bytes(n) + 1024) <= 228 * 1024
        assert tk.smem_bytes(n) == 3968


@pytest.mark.parametrize("n", [33, 34, 64, 65, 96, 97, 128, 129, 169])
def test_block_wide_shared_memory_is_unchanged(n):
    # the register instances' layout to n = 128 (kN = row_threads(n): two
    # buffers of 4 kN + 4 floats of scratch, 32 reduction slots, 8 kN of
    # values by row, P in kN rows of stride kN + 2;
    # tests/test_torch_k1_rows.py), and past it the two-plane kernel's,
    # unchanged
    if n <= tk.ROWS_MAX_N:
        N = _build.row_threads(n)
        assert tk.smem_bytes(n) == 4 * (2 * (4 * N + 4) + 32 + 8 * N + N * (N + 2))
    else:
        assert tk.smem_bytes(n) == 4 * (2 * n * (n | 1) + 5 * n + 32)


def _segment_butterfly(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """seg_sum<S> of csrc/admm.cu over a (B, n) batch, n <= S = lanes: lane
    i holds x_i (0 past n) and adds its partner's value at xor distances
    S / 2, ..., 1; lane 0's value."""
    B, n = x.shape
    v = torch.nn.functional.pad(x, (0, lanes - n))
    o = lanes // 2
    while o:
        v = v + v[:, torch.arange(lanes) ^ o]
        o //= 2
    return v[:, 0]


@pytest.mark.parametrize("lanes,n", [(8, 1), (8, 5), (8, 8), (16, 9), (16, 12), (16, 16),
                                     (32, 24), (32, 32)])
def test_segment_butterfly_adds_in_the_block_sums_order(lanes, n):
    rng = np.random.default_rng(100 * lanes + n)
    x = rng.standard_normal((4000, n)) * 10.0 ** rng.integers(-6, 6, (4000, n))
    x[rng.random(x.shape) < 0.2] = 0.0       # zero rows, as the lanes past n add
    x = torch.from_numpy(x.astype(np.float32))
    got = _segment_butterfly(x, lanes)
    want = tk._block_sum(x)
    assert torch.equal(got, want)
    # the order matters: summing in another order changes some bits
    if n >= 8:
        assert not torch.equal(x.sum(dim=1), want) or not torch.equal(x.flip(1).sum(dim=1), want)


def test_every_lane_of_a_segment_ends_with_the_same_bits():
    # the kernel's stopping tests read the sum on every lane of a segment
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((500, 16)).astype(np.float32))
    v = x.clone()
    o = 8
    while o:
        v = v + v[:, torch.arange(16) ^ o]
        o //= 2
    assert torch.equal(v, v[:, :1].expand_as(v))
