"""The frozen yardstick: the bounds recorded in PERF.md from the recorded
counts (K1 0.00325 / 0.02671 ms at the QCQP flagship and N=96, 0.03221 at
config 6; K2 0.00346 / 0.03333 ms; K4 0.00329 / 0.02348 ms at N=24 and config
6), and a union of device intervals that never reads below 0 idle."""

import pytest
import torch

from portbench import roofline


def _full(B, v):
    return torch.full((B,), float(v), dtype=torch.float64)


def test_k1_bounds_from_the_recorded_counts():
    ms, by, _, _ = roofline.k1_bound_ms(4096, 24, 12, _full(4096, 17.2097), _full(4096, 1), 10)
    assert (round(ms, 5), by) == (0.00325, "bytes")
    ms, by, _, _ = roofline.k1_bound_ms(2048, 96, 48, _full(2048, 17.7925), _full(2048, 1), 10)
    assert (round(ms, 5), by) == (0.02671, "operations")


def test_k1_bound_at_config_6_from_its_recorded_counts():
    ms, by, _, _ = roofline.k1_bound_ms(2048, 96, 0, _full(2048, 26.5728), _full(2048, 1.0010), 10)
    assert (round(ms, 5), by) == (0.03221, "operations")


def test_k4_bounds_of_the_non_negative_qp():
    assert [(round(ms, 5), by) for ms, by, _, _ in (roofline.k4_bound_ms(4096, 24, 0, 0),
                                                   roofline.k4_bound_ms(2048, 96, 0, 0))] == \
        [(0.00329, "bytes"), (0.02348, "bytes")]


def test_k2_bounds_from_the_recorded_active_share():
    ms, by, _, _ = roofline.k2_bound_ms(4096, 24, 12, torch.ones(4096, 12, dtype=torch.bool))
    assert (round(ms, 5), by) == (0.00346, "bytes")
    g = torch.Generator().manual_seed(0)
    active = torch.rand(2048, 48, generator=g) < 0.9763      # strictly active share at N=96
    ms, by, _, _ = roofline.k2_bound_ms(2048, 96, 48, active)
    assert by == "operations" and ms == pytest.approx(0.03333, rel=2e-3)


def test_union_counts_overlaps_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (2.5, 2.6), (5.0, 6.0), (9.0, 12.0)]
    assert roofline.union_seconds(iv, 0.0, 10.0) == pytest.approx(5.0)
    assert roofline.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    # every interval the same: busy is the window, never more
    assert roofline.union_seconds([(0.0, 1.0)] * 5, 0.0, 1.0) == pytest.approx(1.0)
