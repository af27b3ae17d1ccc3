"""K1's block-wide path (33 <= n <= 169): which kernel takes each n, its
launch plan and shared-memory layout, and the count of launches by instance.

To n = 128 a register instance runs (``csrc/admm.cu::admm_kernel_rows<
RowK1<kN, ...>>``, kN = 64, 96 or 128): one block of kN threads a problem,
thread r keeping row r of the inverse in registers. Past it the two-plane
``admm_kernel`` runs, its shared-memory layout unchanged. The kernels run
only on the card (``chip_smoke.py`` phase 2 holds each instance bit for bit
against ``admm_solve_plain`` at its edges and on every branch). What the
card run rests on and the CPU
can check: the plan (restated here from the source), the 16-byte alignment
of every float4 and double2 view of the layout, and the counter.
"""

import types

import pytest
import torch

import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.kernels import _build
from diffqcqp_tpu_torch.kernels import admm_cuda as tk

# RowK1 in csrc/admm.cu, by the largest n each takes
ROW_INSTANCES = (64, 96, 128)
MAX_WARPS = 8        # kMaxWarps: block_reduce's slots are 4 a warp


def _layout(N):
    """Float offsets of a register instance's shared memory (RowK1<N>):
    the scratch (two buffers of 4 N + 4), block_reduce's slots, the prox's
    arguments and q by row (4 N), the parked loop state (4 N), then P's
    plane of N rows at stride N + 2."""
    scratch = 0
    red = scratch + 2 * (4 * N + 4)
    pargs = red + 4 * MAX_WARPS
    park = pargs + 4 * N
    plane = park + 4 * N
    ld = N + 2
    return {"scratch": scratch, "red": red, "pargs": pargs, "park": park, "plane": plane,
            "ld": ld, "end": plane + N * ld}


def _plan(n):
    """dq_admm_plan past one warp, restated: (instance, problems a block,
    threads, shared bytes)."""
    threads = 32 * -(-n // 32)
    if n <= 128:
        N = next(k for k in ROW_INSTANCES if n <= k)
        assert N == threads
        return N, 1, N, 4 * _layout(N)["end"]
    return 0, 1, threads, 4 * (2 * n * (n | 1) + 5 * n + 32)


@pytest.mark.parametrize("n", range(33, 170))
def test_launch_plan_past_one_warp_takes_the_register_instance_to_128(n):
    assert tk.launch_plan(n) == _plan(n)
    assert tk.smem_bytes(n) == _plan(n)[3]
    assert tk.fits(n)


def test_the_plan_chooses_by_n_alone():
    assert tk.ROWS_MAX_N == ROW_INSTANCES[-1]
    assert [tk.launch_plan(n)[0] for n in (33, 64, 65, 96, 97, 128, 129, 169)] == [
        64, 64, 96, 96, 128, 128, 0, 0]
    assert not tk.fits(170)


@pytest.mark.parametrize("N", ROW_INSTANCES)
def test_register_layout_is_aligned(N):
    at = _layout(N)
    # the scratch's views: the two buffers of published float4 columns (at
    # 0 and 4 N + 4), the float4 broadcasts of rhs (at 0) and res (at N
    # floats), l0 as double2 (at 2 N)
    for off in (0, 4 * N + 4, N, 2 * N):
        assert (4 * (at["scratch"] + off)) % 16 == 0
    # two Gauss-Jordan buffers (N float4 and 4 pivots each) and a solve's
    # three vectors (2 N floats and N doubles) fit the scratch
    assert at["red"] - at["scratch"] == 2 * (4 * N + 4) and 2 * N + 2 * N <= 4 * N + 4
    # P's plane starts on 16 bytes; its rows (stride N + 2) on 8, for the
    # float2 loads, and the float4 rows of P from device memory land as two
    # float2 at columns that are multiples of 4
    assert (4 * at["plane"]) % 16 == 0 and (4 * at["ld"]) % 8 == 0
    # a half-warp's float2 loads of sixteen rows fall in distinct bank pairs
    assert len({(r * at["ld"] // 2) % 16 for r in range(16)}) == 16
    # the reduction slots hold 4 for each warp of the block
    assert N // 32 <= MAX_WARPS


def test_n96_holds_four_problems_an_sm_in_shared_memory():
    # four blocks of config 6's instance fit an SM's 228 KB with the 1 KB a
    # block reserves (the register cap of __launch_bounds__(96, 4) is the
    # other bound, read by the occupancy calculator on the card)
    assert 4 * (tk.smem_bytes(96) + 1024) <= 228 * 1024
    # the two-plane layout held three
    two_plane = 4 * (2 * 96 * 97 + 5 * 96 + 32)
    assert 3 * (two_plane + 1024) <= 228 * 1024 < 4 * (two_plane + 1024)


def test_count_launch_counts_by_instance():
    wrapper = types.SimpleNamespace(launches=0, launches_by_instance={})
    for inst in (96, 96, 0, 24):
        _build.count_launch(wrapper, inst)
    _build.count_launch(wrapper)
    assert wrapper.launches == 5
    assert wrapper.launches_by_instance == {96: 2, 0: 1, 24: 1}


def test_the_cpu_path_counts_no_launch():
    before = (tk.admm_solve_cuda.launches, dict(tk.admm_solve_cuda.launches_by_instance))
    B, n = 2, 40
    P = torch.eye(n).expand(B, n, n).contiguous()
    q = -torch.ones(B, n)
    _, st = tk.admm_solve_cuda(P, q, torch.zeros_like(q), tk.PROX_NONNEG, (), dqt.QP_DEFAULTS)
    assert bool(st.converged.all())
    assert (tk.admm_solve_cuda.launches, tk.admm_solve_cuda.launches_by_instance) == before
