"""The readers of the program's spans and graph layout (``portbench/spans.py``)
on synthetic Chrome traces with ``correlation`` ids and synthetic spans:

  * a replay's ops matched to the layout, and no split at all where one
    replay differs from it in count, kind or where K1 lies;
  * the staging copies found by correlation (ops tied to no
    ``cudaGraphLaunch``), and the four device readings summing to ``glue_ms``;
  * the host's clock put on the trace's by the marks' ends, and every
    span-dependent number None where the second mark disagrees by more
    than 50 us;
  * idle gaps labelled by the innermost span open on the loop's thread,
    else by the runtime call, and the idle share spent in staging;
  * the cost mode's windows alternate untraced and traced;
  * a ``--trace 0`` run never turns the program's tracing on;
  * on a card (marker ``gpu``), the tool's four windows on each cell: every
    replay matched, the device readings summing to ``glue_ms`` within 1 %,
    the clocks within 50 us, and no capture, eager call or build in a window.
"""

import json
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from diffqcqp_tpu_torch.utils import tracing
from portbench import loop, run, spans, trace
from portbench.metrics import glue_ms

DEVICE = ("stage_copy_ms", "glue_fwd_ms", "glue_bwd_ms", "glue_unspanned_ms")

LAYOUT = [("solve.canon", (("kernel", "add_kernel"), ("memset", None))),
          ("solve.k1", (("kernel", "admm_kernel_warp"),)),
          (None, (("kernel", "sum_kernel"), ("other", None))),
          ("adjoint.vjp", (("kernel", "coord_bwd_kernel_w"),)),
          ("adjoint.grads", (("kernel", "mul_kernel"),))]
# one replay's ops in order: (name, category, microseconds)
REPLAY = [("add_kernel", "kernel", 3.0), ("Memset (Device)", "gpu_memset", 1.0),
          ("admm_kernel_warp", "kernel", 20.0), ("sum_kernel", "kernel", 2.0),
          ("coord_bwd_kernel_w", "kernel", 5.0), ("mul_kernel", "kernel", 4.0)]
STAGING = [("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 1.5)]


def _events(replays, staging=STAGING, marks=((0.0, 10.0), (1000.0, 1010.0))):
    """A Chrome trace: the two marks, then per step the staging ops (each
    with its cudaMemcpyAsync) and a replay (its cudaGraphLaunch, then its
    ops in order); times in microseconds from 0."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": s,
           "dur": e - s, "args": {"correlation": 1 + i}} for i, (s, e) in enumerate(marks)]
    t, corr = 20.0, 100

    def op(name, cat, dur, c):
        nonlocal t
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": t, "dur": dur,
                   "args": {"correlation": c}})
        t += dur + 1.0

    for ops in replays:
        for name, cat, dur in staging:
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": t - 1,
                       "dur": 0.5, "args": {"correlation": corr}})
            op(name, cat, dur, corr)
        corr += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": t - 1,
                   "dur": 1.5, "args": {"correlation": corr}})
        for name, cat, dur in ops:
            op(name, cat, dur, corr)
    return ev


def _ctx(replays, layout=LAYOUT, **kw):
    tr = spans.from_events(_events(replays, **kw), types.SimpleNamespace(steps=len(replays)))
    empty = spans.Recorded(loop.Window(), [], 0, 11, tr)
    return types.SimpleNamespace(trace=tr, layout=layout, steps=len(replays),
                                 untraced=loop.Window(), recorded=empty, recorded_traced=empty)


def _device(ctx):
    r = spans.readings(ctx)
    return {k: r[k] for k in DEVICE}


def _shifted(ops, k, to):
    return ops[:k] + [to] + ops[k + 1:]


def test_every_replay_matches_the_layout():
    split = spans.split_of(_ctx([REPLAY] * 3))
    assert split["replays"] == 3 and "mismatch" not in split
    assert split["by_span"]["solve.k1"] == [pytest.approx(60e-6), 3]
    assert split["by_span"][spans.NO_SPAN] == [pytest.approx(6e-6), 3]
    assert split["by_span"][spans.STAGING] == [pytest.approx(4.5e-6), 3]


@pytest.mark.parametrize("bad", [
    REPLAY[:-1],                                                    # a node short
    _shifted(REPLAY, 1, ("Memcpy DtoD", "gpu_memcpy", 1.0)),       # a copy where a fill was
    _shifted(REPLAY, 0, ("admm_kernel_warp", "kernel", 3.0)),      # K1 under solve.canon
    _shifted(REPLAY, 4, ("other_kernel", "kernel", 5.0)),          # not the kernel K4's node names
], ids=["count", "kind", "k1-place", "kernel-name"])
def test_a_replay_that_differs_gives_no_graph_split(bad):
    ctx = _ctx([REPLAY, bad, REPLAY])
    split = spans.split_of(ctx)
    assert (split["solve"], split["adjoint"], split["unspanned"]) == (None, None, None)
    assert list(split["by_span"]) == [spans.STAGING] and "mismatch" in split
    got = _device(ctx)
    assert (got["glue_fwd_ms"], got["glue_bwd_ms"], got["glue_unspanned_ms"]) == (None,) * 3
    assert got["stage_copy_ms"] == pytest.approx(1.5e-3)


def test_a_replay_launched_in_the_window_keeps_its_ops_past_its_end():
    """The last replay's last op starts after the second mark began: its
    device clock runs a few microseconds late on the host's."""
    events = _events([REPLAY] * 2)
    last = events[-1]
    assert last["name"] == "mul_kernel"
    last["ts"] = 1000.5                      # past the second mark's start
    ctx = _ctx([REPLAY] * 2)
    ctx.trace = spans.from_events(events, ctx.trace.window)
    split = spans.split_of(ctx)
    assert split["replays"] == 2 and "mismatch" not in split
    assert split["adjoint"] == pytest.approx(8e-6)


def test_nameless_nodes_match_where_the_span_holds_the_kernel():
    nameless = [(p, tuple((k, None) for k, _ in nodes)) for p, nodes in LAYOUT]
    assert spans.split_of(_ctx([REPLAY] * 2, layout=nameless))["replays"] == 2


def test_the_four_device_readings_sum_to_glue_ms():
    ctx = _ctx([REPLAY] * 4)
    parts = _device(ctx)
    # per step: staging 1.5 us, forward glue 3 + 1 (K1 out), adjoint glue 4 (K4 out), unspanned 2
    assert parts == pytest.approx({"stage_copy_ms": 1.5e-3, "glue_fwd_ms": 4e-3,
                                   "glue_bwd_ms": 4e-3, "glue_unspanned_ms": 2e-3})
    assert sum(parts.values()) == pytest.approx(glue_ms.read(ctx))


def test_staging_ops_are_those_tied_to_no_graph_launch():
    tr = _ctx([REPLAY] * 2).trace
    assert spans.graph_launches(tr) == 2
    assert spans.device_split(tr, None)["staging"] == pytest.approx(3e-6)
    no_corr = _events([REPLAY])
    del no_corr[-1]["args"]["correlation"]
    assert spans.device_split(spans.from_events(no_corr, None), LAYOUT) is None


def _aligned(host_end_us, marks=((0.0, 10.0), (1000.0, 1010.0))):
    """A trace whose host marks end at ``host_end_us`` on a host clock
    running 5 s behind the trace's."""
    tr = spans.from_events(_events([REPLAY] * 5, marks=marks), types.SimpleNamespace(steps=5))
    tr.host_marks = [int((e - 5e6) * 1e3) for e in host_end_us]
    return tr


@pytest.mark.parametrize("drift_us, ok", [(0.0, True), (30.0, True), (-49.0, True),
                                          (60.0, False), (-51.0, False)])
def test_marks_align_the_clocks_within_50_us(drift_us, ok):
    off, skew = spans.offset(_aligned([10.0, 1010.0 - drift_us]))
    assert skew == pytest.approx(drift_us * 1e-6, abs=1e-9)
    assert (off == pytest.approx(5.0, abs=1e-9)) if ok else off is None


def _recorded(tr, thread=11):
    """Spans on the loop's thread (and one on another), in host ns: for each
    replay but the first, a staged call over its staging copy, its launch
    and its first op, with its key before the copy and its replay part over
    the launch."""
    S = tracing.Span
    host = lambda us: int((us - 5e6) * 1e3)  # noqa: E731
    launches = [s * 1e6 for name, s, _ in tr.calls if name == "cudaGraphLaunch"]
    out = []
    for t in launches[1:]:
        out += [S("staged.key", host(t - 6), host(t - 4), "staged.call", thread),
                S("staged.replay", host(t - 2), host(t + 4), "staged.call", thread),
                S("staged.call", host(t - 6), host(t + 4), None, thread),
                S("adjoint.vjp", host(t - 6), host(t + 4), None, thread + 1)]
    return spans.Recorded(tr.window, out, 0, thread, tr)


def test_idle_gaps_take_the_innermost_span_else_the_runtime_call():
    tr = _aligned([10.0, 1010.0])
    idle = spans.idle_split(_recorded(tr))
    labels = idle["by_label"]
    assert set(labels) == {"staged.call", "staged.replay", "cudaGraphLaunch", trace.BETWEEN}
    # the gap right before a replay's first op falls in staged.replay, or in the graph's
    # launch where no span is open; the gap before the staging copy in the call's own time
    assert labels["staged.replay"] == pytest.approx(4e-6)
    assert labels["cudaGraphLaunch"] == pytest.approx(1e-6)
    assert labels["staged.call"] == pytest.approx(4e-6)
    assert idle["in_staging"] == pytest.approx(sum(v for k, v in labels.items()
                                                   if k.startswith("staged.")))
    assert idle["idle"] == pytest.approx(sum(labels.values()))
    ctx = _ctx([REPLAY] * 5)
    ctx.recorded_traced = _recorded(tr)
    got = spans.readings(ctx)
    assert got["idle_in_staging_pct"] == pytest.approx(100 * idle["in_staging"] / tr.window_s)
    assert got["staging_share_of_idle_pct"] == pytest.approx(
        100 * idle["in_staging"] / idle["idle"])
    drifted = _recorded(_aligned([10.0, 1080.0]))
    assert spans.idle_split(drifted) is None
    ctx.recorded_traced = drifted
    got = spans.readings(ctx)
    assert got["idle_in_staging_pct"] is None and got["staging_share_of_idle_pct"] is None


def test_innermost_pieces_tile_nested_spans():
    S = tracing.Span
    got = spans.innermost([S("a", 0, 100, None, 1), S("b", 10, 30, "a", 1),
                           S("c", 40, 60, "a", 1), S("d", 45, 50, "c", 1),
                           S("e", 200, 210, None, 1)])
    assert got == [(0, 10, "a"), (10, 30, "b"), (30, 40, "a"), (40, 45, "c"), (45, 50, "d"),
                   (50, 60, "c"), (60, 100, "a"), (200, 210, "e")]


def test_trace_0_never_turns_tracing_on(monkeypatch):
    monkeypatch.setattr(tracing, "enable", lambda: pytest.fail("tracing.enable called"))
    res = run.main(["--workload", "contact12.sim", "--seed", str(2 ** 31 + 5), "--seconds", "0.2",
                    "--trace", "0"], device=torch.device("cpu"),
                   overrides={"config": {"batch": 16}, "spec": {"pool": 2}})
    assert res["correct"] and not tracing.enabled


def test_cost_alternates_untraced_and_traced_windows():
    seen = []

    def step(x):
        if not seen or seen[-1] != tracing.enabled:
            seen.append(tracing.enabled)
        return (x,)

    got = spans.cost(step, [(torch.zeros(1),)], torch.zeros(2, dtype=torch.int64), 0.01,
                     torch.device("cpu"), tracing, 3)
    assert seen == [False, True, False, True]           # a c, c a, a c
    assert len(got["untraced_ms"]) == len(got["traced_ms"]) == 3 and not tracing.enabled
    assert set(got) >= {"mean_pct", "median_pct", "pairwise_median_pct"}


ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_tool_splits_each_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/spans.py", "--workload", cell, "--seed",
                          "2147483677", "--seconds", "0.5"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    err = out.stderr
    for m in re.finditer(r"window (\(\w\))[^:]*: (\d+) steps; captures (\S+), eager calls (\S+), "
                         r"kernel builds (\S+), replays (\S+)", err):
        label, steps, *moved, replays = m.groups()
        assert moved == ["0", "0", "0"], m.group(0)
        assert replays == ("-" if label == "(a)" else steps), m.group(0)
    matched = re.search(r"layout: (\d+) replays matched of (\d+)$", err, re.M)
    assert matched and matched.group(1) == matched.group(2), err[-3000:]
    skew = re.search(r"mark ([-+0-9.]+) us off", err)
    assert skew and abs(float(skew.group(1))) <= 50, err[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])["readings"]
    parts = [r[k] or 0.0 for k in DEVICE]
    assert sum(parts) == pytest.approx(r["glue_ms"], rel=0.01), r
    assert all(r[k] is not None for k in ("stage_copy_in_ms", "stage_replay_ms",
                                          "stage_clone_ms", "idle_in_staging_pct"))
