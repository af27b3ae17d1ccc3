"""The recorder of spans and counters (``utils/tracing.py``) and what the
port records with it, on the CPU:

  * the recorder: spans nest per thread, nothing is recorded while it is
    off, and a full buffer drops and counts;
  * ``_build.count_launch`` still bumps a wrapper's ``launches``;
  * ``Staged``: a replay (a stand-in graph on CPU tensors) calls no function
    of the recorder while tracing is off, records ``staged.call`` and its
    four parts while it is on, and makes the same copies, replay and clones
    in the same order either way; a call that is no replay records nothing;
  * a capture's layout, with the capture, the node count and the finished
    graph's nodes patched: the solve's spans come in order, each over the
    nodes recorded inside it, and the layout is None where the graph holds
    a conditional node.

The layout against a device trace is ``portbench/tests/test_portbench_spans.py``'s;
on the card, ``portbench/spans.py`` reads it.
"""

import contextlib
import threading
import types

import pytest
import torch

import diffqcqp_tpu_torch as dqt
from diffqcqp_tpu_torch.kernels import _build
from diffqcqp_tpu_torch.utils import control, staging, tracing


@pytest.fixture
def rec():
    """The recorder on and empty; off and empty after the test."""
    tracing.reset()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.reset()


def _by_name(spans):
    return {s.name: s for s in spans}


def test_spans_nest_per_thread(rec):
    with rec.span("outer"):
        with rec.span("inner"):
            pass
        t = threading.Thread(target=lambda: rec.span("other").__enter__().__exit__(None, None,
                                                                                    None))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    got = _by_name(rec.spans())
    assert [s.name for s in rec.spans()] == ["inner", "other", "outer"]     # in the order they end
    assert (got["inner"].parent, got["outer"].parent, got["other"].parent) == ("outer", None, None)
    assert got["other"].thread != got["outer"].thread == got["inner"].thread
    assert got["outer"].start_ns <= got["inner"].start_ns <= got["inner"].end_ns \
        <= got["outer"].end_ns


@pytest.mark.parametrize("record", ["span", "parts", "bump"])
def test_nothing_is_recorded_while_off(record):
    tracing.reset()
    counter = types.SimpleNamespace(n=0)
    {"span": lambda: tracing.span("x").__enter__(),
     "parts": lambda: tracing.parts("x", ("a",), (1, 2)),
     "bump": lambda: tracing.bump(counter, "n")}[record]()
    assert tracing.span("x") is tracing._OFF
    assert tracing.spans() == [] and tracing.dropped() == 0
    assert counter.n == (record == "bump")          # an object's counter counts whatever


def test_a_full_buffer_drops_and_counts(rec, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    monkeypatch.setattr(tracing, "_buf", [None] * 3)
    rec.reset()
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans()] == ["s0", "s1", "s2"]
    assert rec.dropped() == 2 and len(tracing._buf) == 3
    rec.reset()
    assert rec.spans() == [] and rec.dropped() == 0


@pytest.mark.parametrize("on", [False, True])
def test_count_launch_bumps_the_wrappers_counter(on):
    wrapper = types.SimpleNamespace(launches=4)
    tracing.reset()
    if on:
        tracing.enable()
    try:
        _build.count_launch(wrapper)
        _build.count_launch(wrapper)
    finally:
        tracing.disable()
    assert wrapper.launches == 6 and tracing.spans() == []


class _FakeGraph:
    """A replayed graph's stand-in: its replay computes ``fn`` of its input
    buffers into its output buffers."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        for buf, x in zip(self.outputs, staging._leaves(self.fn(*self.inputs), none_ok=True)[0]):
            if buf is not None:
                buf.copy_(x)


def _replaying(monkeypatch, fn=lambda x: (2 * x,)):
    """A Staged whose signature of a (3,) CPU tensor holds a graph of
    ``fn``, with the card's device guard made a no-op."""
    monkeypatch.setattr(staging, "_cuda_device", lambda leaves: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    s = staging.Staged(fn)
    x = torch.arange(3.0)
    st = s._state[staging.signature(x)] = staging._Graph()
    st.inputs = [torch.zeros(3)]
    leaves, st.out_spec = staging._leaves(fn(x), none_ok=True)
    st.outputs = [None if y is None else torch.zeros_like(y) for y in leaves]
    st.graph = _FakeGraph(fn, st.inputs, st.outputs)
    return s, x


@pytest.mark.parametrize("call", ["replay", "cpu"])
def test_staged_calls_no_recorder_function_while_off(monkeypatch, call):
    if call == "replay":
        s, x = _replaying(monkeypatch)
    else:                                          # CPU tensors: fn as it is
        s, x = staging.Staged(lambda a: (2 * a,)), torch.arange(3.0)
    for name in tracing.__all__:
        if callable(getattr(tracing, name)) and name not in ("Span", "Layout"):
            monkeypatch.setattr(tracing, name, lambda *a, **k: pytest.fail("recorder called"))
    (y,) = s(x)
    assert torch.equal(y, 2 * x) and s.replays == 0


def test_a_traced_replay_records_the_call_and_its_parts(monkeypatch, rec):
    s, x = _replaying(monkeypatch)
    (y,) = s(x)
    (y2,) = s(x + 1)
    assert torch.equal(y, 2 * x) and torch.equal(y2, 2 * x + 2)
    spans = rec.spans()
    assert [r.name for r in spans] == [*staging._REPLAY_PARTS, "staged.call"] * 2
    call, parts = spans[4], spans[:4]
    assert all(r.parent == "staged.call" for r in parts) and call.parent is None
    assert parts[0].start_ns == call.start_ns and parts[-1].end_ns == call.end_ns
    assert all(a.end_ns == b.start_ns for a, b in zip(parts, parts[1:]))    # the parts tile it
    assert s.replays == 2


@pytest.mark.parametrize("fn", [lambda x: (2 * x,),
                                lambda x: {"a": 2 * x, "none": None, "b": [x + 1, x * x]}],
                         ids=["tuple", "nested-with-none"])
def test_traced_and_untraced_replays_make_the_same_calls(monkeypatch, fn):
    """``Staged._traced`` times its own copy of ``_replay``'s steps: both
    copy the same inputs in, replay, and clone the same outputs, in one
    order, and return equal results."""
    s, x = _replaying(monkeypatch, fn)
    (st,) = s._state.values()
    log, in_graph = [], []
    copy_, clone, replay = torch.Tensor.copy_, torch.Tensor.clone, st.graph.replay

    def logged_copy(self, src, *a, **k):
        if not in_graph:
            log.append(("copy", self.data_ptr(), src.data_ptr()))
        return copy_(self, src, *a, **k)

    def logged_clone(self, *a, **k):
        log.append(("clone", self.data_ptr()))
        return clone(self, *a, **k)

    def logged_replay():
        log.append(("replay",))
        in_graph.append(True)           # the stand-in's own work is the graph's
        replay()
        in_graph.pop()

    monkeypatch.setattr(torch.Tensor, "copy_", logged_copy)
    monkeypatch.setattr(torch.Tensor, "clone", logged_clone)
    st.graph.replay = logged_replay
    out = {}
    for on in (False, True):
        tracing.reset()
        if on:
            tracing.enable()
        try:
            log.clear()
            out[on] = (s(x), list(log))
        finally:
            tracing.disable()
    (plain, plain_log), (traced, traced_log) = out[False], out[True]
    assert plain_log == traced_log and ("replay",) in plain_log
    assert [k for k, *_ in plain_log].count("clone") == sum(y is not None for y in st.outputs)
    a, spec_a = staging._leaves(plain, none_ok=True)
    b, spec_b = staging._leaves(traced, none_ok=True)
    assert spec_a == spec_b and all((p is None and q is None) or torch.equal(p, q)
                                    for p, q in zip(a, b))
    assert [r.name for r in tracing.spans()] == [*staging._REPLAY_PARTS, "staged.call"]


def test_a_traced_call_that_is_no_replay_records_nothing(rec):
    s = staging.Staged(lambda a: (2 * a,))          # CPU tensors: fn as it is
    (y,) = s(torch.arange(3.0))
    assert torch.equal(y, 2 * torch.arange(3.0))
    assert rec.spans() == [] and s.replays == 0


def _patched_capture(monkeypatch, kinds_of):
    """Capture on the CPU: the graph, the capture, the stream and the node
    count are stand-ins; every read of the count finds one node more, and
    the finished graph lists ``kinds_of(n)`` for the n it then holds."""
    count = {"n": 0}

    def nodes(stream):
        count["n"] += 1
        return count["n"] - 1

    class Graph:
        def __init__(self, keep_graph=False):
            pass

        def instantiate(self):
            pass

    @contextlib.contextmanager
    def graph(g):
        yield types.SimpleNamespace(recorded={})

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(control, "graph", graph)
    monkeypatch.setattr(control, "capture_nodes", nodes)
    monkeypatch.setattr(control, "graph_nodes", lambda g: kinds_of(count["n"]))


def _qp(b=3, n=4):
    g = torch.Generator().manual_seed(0)
    s = torch.randn(b, n, n, generator=g, dtype=torch.float32)
    return s @ s.transpose(1, 2) + torch.eye(n), torch.randn(b, n, generator=g)


def _train_step(P, q):
    xs = [x.detach().requires_grad_() for x in (P, q)]
    l = dqt.solve_qp(*xs, device="cpu")
    return (l, *torch.autograd.grad((l * l).sum(), xs))


@pytest.mark.parametrize("tracing_on", [False, True])
def test_a_capture_records_the_layout_of_the_solves_spans(monkeypatch, tracing_on):
    _patched_capture(monkeypatch, lambda n: [("kernel", None)] * n)
    s = staging.Staged(_train_step)
    st = staging._Graph()
    leaves, spec = staging._leaves((_qp(), {}))
    tracing.reset()
    if tracing_on:
        tracing.enable()
    try:
        s._capture(st, leaves, spec)
    finally:
        tracing.disable()
    paths = [p for p, _ in st.layout]
    fwd = ["solve.canon", "solve.equilibrate", "solve.k1", "solve.map_back"]
    bwd = ["adjoint.vjp", "adjoint.grads"]
    assert paths == [None, *(x for p in fwd + bwd for x in (p, None))]
    assert all(len(nodes) == 1 for _, nodes in st.layout)          # one node a mark
    assert s.captures == 1 and tracing.active is False
    names = {r.name for r in tracing.spans()}
    assert names == (set(fwd + bwd) if tracing_on else set())


def test_a_capture_with_a_conditional_node_has_no_layout(monkeypatch):
    _patched_capture(monkeypatch, lambda n: [("kernel", None)] * (n - 1) + [("conditional", None)])
    st = staging._Graph()
    leaves, spec = staging._leaves((_qp(), {}))
    staging.Staged(_train_step)._capture(st, leaves, spec)
    assert st.layout is None


def test_layout_segments_place_each_node_under_the_open_path():
    lay = tracing.Layout(iter([0, 2, 2, 5]).__next__)
    lay.mark(["staged.call", "solve.canon"])
    lay.mark(["staged.call", "solve.canon", "solve.k1"])
    lay.mark(["staged.call"])
    nodes = [("kernel", f"k{i}") for i in range(6)]
    assert lay.segments(nodes) == [
        (None, (("kernel", "k0"), ("kernel", "k1"))),
        ("solve.canon/solve.k1", tuple(("kernel", f"k{i}") for i in (2, 3, 4))),
        (None, (("kernel", "k5"),)),
    ]
