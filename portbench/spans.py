#!/usr/bin/env python3
"""Where a staged step's time goes, by the program's own layers: the staged
call's host path split by part, the graph's glue by the program layer that
recorded it, and the card's idle gaps by the span the host was in.

    python3 portbench/spans.py --workload contact12.sim --seed 7 [--pairs 12]

The cell's set-up is ``portbench/run.py``'s (its pool from ``--seed``, the
step staged, warmed and captured); then four windows of ``--seconds`` (1 s
by default), in this order: (a) untraced; (b) under the profiler; (c) with
the program's tracing on (``diffqcqp_tpu_torch/utils/tracing.py``); (d)
with both. Each window's kept outputs are dropped before the next, so that
no window allocates. Standard error gets a line a window with what the
program counted in it (captures, eager calls and kernel builds, each
expected 0; replays, expected equal to the steps), the cost of tracing
((c)'s host ms a call against (a)'s), the layout's match and the clocks'
agreement; the last line of standard output is one JSON object:
``readings`` (below), ``device_by_span`` and ``idle_by_span``, and with
``--pairs K`` the cost of tracing measured again over K pairs of
alternating (a) and (c) windows (``cost``): the reading of the cost, since
(c) alone follows the profiled window, which leaves the host slow for a
while (on an H100's host one (c) against one (a) read +14 to +64 %, K = 12
pairs -3.9 to +4.6 %). The answers are not checked:
``run.py`` does that. Exit codes as ``run.py``'s.

**Device ops by layer (window (b)).** An op whose ``correlation`` id is a
``cudaGraphLaunch``'s belongs to that replay; any other op was launched by
the staged call outside its graph (the input copies, the output clones).
The window's ops are those whose launching call began in it: on an H100 one
replay in some 25 windows had 26 of its 30 ops start up to 154 us past the
second mark's start, and judged by their own start it lost them. A
replay's ops in start order are matched against ``Staged.layout``'s kernel,
memcpy and memset nodes in order: same count, same kind at every place, K1
only where the layout has ``solve.k1`` and K4 or K2 only where it has
``adjoint.vjp`` (and where the layout names a kernel, the same kernel). One
replay that does not match leaves the split None: nothing is guessed.

**Host spans on the trace's clock (window (d)).** The host's
``perf_counter_ns`` is read right after each of the loop's two
``cudaDeviceSynchronize`` marks returns; the offset from the host's clock to
the trace's is taken at the first mark, between the end of the runtime call
and that reading, and must agree with the second's within ``MAX_SKEW_S``,
else every span-dependent number is None. The ends are the close pair: a
reading before a mark also holds PyTorch's own work ahead of the runtime
call, up to ~150 us more at the first mark than at the second on an H100's
host, which put the offsets of the marks' midpoints 51-59 us apart where
those of their ends were 8-12 us apart. The two tracers slow the host in
(d), so ``idle_in_staging_pct`` overstates the untraced idle;
``staging_share_of_idle_pct``, the share of (d)'s idle that falls in the
staged call, is the steadier reading.
"""

import argparse
import bisect
import importlib
import json
import os
import statistics
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import loop, roofline, run, trace as trace_mod  # noqa: E402
from portbench.metrics import glue_ms, k1_ms, k4_ms  # noqa: E402

GRAPH_LAUNCH = "cudaGraphLaunch"
MAX_SKEW_S = 50e-6
CAT_KIND = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
# the hand-written kernels: their tag in a kernel's name, the span the
# layout must have them in
KERNELS = {"K1": (k1_ms.TAG, "solve.k1"), "K4": (k4_ms.TAG, "adjoint.vjp"),
           "K2": (glue_ms.K2_TAG, "adjoint.vjp")}
STAGING = "staging"
NO_SPAN = "(no span)"


class Profiled(trace_mod.Trace):
    """A window under the profiler, as ``trace.Trace`` reads one, with what
    ties its ops to the host: ``op_info`` [(category, correlation id)], one
    for each op; ``launched_by`` {correlation id: (runtime call's name, its
    start_s)}; ``marks`` the two marks' (start_s, end_s) on the trace's
    clock and ``host_marks`` the host's perf_counter_ns right after each
    returned."""

    def __init__(self, ops, calls, lo, hi, window, op_info, launched_by, marks, host_marks):
        super().__init__(ops, calls, lo, hi, window)
        self.op_info, self.launched_by = op_info, launched_by
        self.marks, self.host_marks = list(marks), list(host_marks)

    def idle(self) -> list[tuple[float, float, str]]:
        """The window's idle gaps in order, (start_s, end_s, the runtime call
        the host was inside when the gap began, or ``trace.BETWEEN``), as
        ``Trace.breakdown`` labels them."""
        calls = sorted(self.calls, key=lambda x: x[1])
        out, i = [], 0
        for s, e in roofline.gaps([(a, b) for _, a, b in self.ops], self.lo, self.hi):
            while i < len(calls) and calls[i][2] <= s:
                i += 1
            out.append((s, e, calls[i][0] if i < len(calls) and calls[i][1] <= s
                        else trace_mod.BETWEEN))
        return out


def from_events(events: list, window, host_marks=()) -> Profiled:
    """The window of a Chrome trace's ``events``, bounded by the loop's two
    marks: the consecutive pair of ``cudaDeviceSynchronize`` calls with the
    most device work between them (the profiler may synchronise too,
    outside them)."""
    ops, calls, op_info, launched_by = [], [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in trace_mod.DEVICE_CATS:
            ops.append((ev["name"], s, e))
            op_info.append((cat, corr))
        elif cat == "cuda_runtime":
            calls.append((ev["name"], s, e))
            if corr is not None:
                launched_by[corr] = (ev["name"], s)
    marks = sorted((s, e) for name, s, e in calls if name == trace_mod.MARK)
    starts = sorted(s for _, s, _ in ops)
    best, pair = 0, None
    for m0, m1 in zip(marks, marks[1:]):
        n = bisect.bisect_left(starts, m1[0]) - bisect.bisect_left(starts, m0[1])
        if n > best:
            best, pair = n, (m0, m1)
    if pair is None:
        raise RuntimeError(f"no two {trace_mod.MARK} calls in the trace hold the window's work")
    return Profiled(ops, [c for c in calls if c[0] != trace_mod.MARK], pair[0][1], pair[1][0],
                    window, op_info, launched_by, pair, host_marks)


def profiled(step, pool, counts, seconds, device) -> Profiled:
    """One window of the loop under ``torch.profiler`` (the card's activity
    only, as ``trace.run``), the host's clock read at the marks' ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    host_marks = []

    def marker():
        torch.cuda.synchronize()
        host_marks.append(time.perf_counter_ns())

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w = loop.run(step, pool, counts, seconds, device, marker=marker)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return from_events(events, w, host_marks)


class Recorded:
    """A window run with the program's tracing on: the loop's ``window``,
    the ``spans`` the recorder holds after it and the records it
    ``dropped``, the ``thread`` that drove the loop, and the window's
    ``trace`` where it ran under the profiler."""

    def __init__(self, window, spans, dropped, thread, trace=None):
        self.window, self.spans, self.dropped = window, spans, dropped
        self.thread, self.trace = thread, trace


def record(tracing, run_window, thread: int):
    """``run_window()`` with the program's tracing on, as a ``Recorded``;
    ``run_window`` returns a loop ``Window`` or a ``Profiled``."""
    tracing.reset()
    tracing.enable()
    try:
        out = run_window()
    finally:
        tracing.disable()
    tr = out if isinstance(out, Profiled) else None
    return Recorded(tr.window if tr else out, tracing.spans(), tracing.dropped(), thread, tr)


def tallies(step, package: str) -> dict:
    """The program's counts that a window must not move (captures, eager
    calls, kernel builds) and its replays, which it counts while tracing is
    on."""
    build = importlib.import_module(f"{package}.kernels._build")
    return {"captures": step.captures, "eager calls": step.eager_calls,
            "kernel builds": build.builds, "replays": step.replays}


def tally_line(label: str, before: dict, after: dict, steps: int, replays) -> str:
    """The stderr line of one window: what the program counted in it, each
    expected 0, and the ``replays`` the program or the trace counted,
    expected equal to the steps (None where neither counted them)."""
    parts = [f"{k} {after[k] - before[k]}" for k in ("captures", "eager calls", "kernel builds")]
    return (f"window {label}: {steps} steps; " + ", ".join(parts)
            + f", replays {'-' if replays is None else replays}")


def windows(step, pool, counts, seconds, device, tracing, package: str, log):
    """The four windows, (untraced Window, Profiled, Recorded, Recorded
    under the profiler). Each window's kept outputs are dropped before the
    next, so that no window allocates. Logs what the program counted in
    each."""
    thread = threading.get_ident()

    def run_(label, window, replays):
        before = tallies(step, package)
        out = window()
        after = tallies(step, package)
        w = out if isinstance(out, loop.Window) else out.window
        log(tally_line(label, before, after, w.steps, replays(out, before, after)))
        w.kept = []
        return out

    counted = lambda out, b, a: a["replays"] - b["replays"]  # noqa: E731
    untraced = run_("(a) untraced", lambda: loop.run(step, pool, counts, seconds, device),
                    lambda out, b, a: None)
    tr = run_("(b) profiled", lambda: profiled(step, pool, counts, seconds, device),
              lambda out, b, a: graph_launches(out))
    rec = run_("(c) spans", lambda: record(
        tracing, lambda: loop.run(step, pool, counts, seconds, device), thread), counted)
    rec_tr = run_("(d) spans, profiled", lambda: record(
        tracing, lambda: profiled(step, pool, counts, seconds, device), thread), counted)
    return untraced, tr, rec, rec_tr


def summary(ctx) -> list[str]:
    """Stderr lines: the cost of tracing on the host path, (c) against (a);
    the layout's match in (b); the clocks' agreement in (d)."""
    out = []
    a, c = ctx.untraced.dispatch, ctx.recorded.window.dispatch if ctx.recorded else []
    if a and c:
        ma, mc = 1e3 * sum(a) / len(a), 1e3 * sum(c) / len(c)
        out.append(f"tracing: replay_host_ms {ma:.5f} untraced (a), {mc:.5f} with spans (c), "
                   f"{100 * (mc / ma - 1):+.2f} %; spans {len(ctx.recorded.spans)}, dropped "
                   f"{ctx.recorded.dropped}")
    split = split_of(ctx)
    if split is None:
        out.append("layout: an op of window (b) has no correlation id")
    else:
        why = split.get("mismatch") or ("no layout" if ctx.layout is None else "")
        out.append(f"layout: {split['replays']} replays matched of {graph_launches(ctx.trace)}"
                   + (f" ({why})" if why else ""))
    if ctx.recorded_traced is not None:
        off, skew = offset(ctx.recorded_traced.trace)
        out.append("clocks: " + ("no marks" if skew is None else
                                 f"offset {'-' if off is None else f'{off:.6f}'} s, the second "
                                 f"mark {1e6 * skew:+.2f} us off (limit {1e6 * MAX_SKEW_S:.0f})"))
    return out


def layout_of(step):
    """The staged step's one layout, or None (no such record, several
    signatures, or a graph with conditional nodes)."""
    layouts = getattr(step, "layout", None)
    if not isinstance(layouts, dict) or len(layouts) != 1:
        return None
    return next(iter(layouts.values()))


def _which(name: str | None):
    """K1, K4 or K2 where ``name`` is one of the hand-written kernels."""
    if name:
        for k, (tag, _) in KERNELS.items():
            if tag in name:
                return k
    return None


def flat(layout) -> list[tuple[str | None, str, str | None]]:
    """The layout's nodes that a trace shows work of, in order: (path, kind,
    kernel name or None)."""
    return [(path, kind, name) for path, nodes in layout for kind, name in nodes
            if kind in ("kernel", "memcpy", "memset")]


def mismatch(nodes: list, ops: list) -> str | None:
    """Where one replay's ``ops`` [(name, category)], in start order, differ
    from the layout's ``nodes`` (``flat``), or None where they match."""
    if len(nodes) != len(ops):
        return f"{len(ops)} ops against {len(nodes)} nodes"
    for j, ((path, kind, node_name), (name, cat)) in enumerate(zip(nodes, ops)):
        if CAT_KIND.get(cat) != kind:
            return f"op {j} is a {cat}, the node a {kind}"
        k = _which(name) if cat == "kernel" else None
        if node_name is not None and _which(node_name) != k:
            return f"op {j} {name[:60]!r} against the node {node_name[:60]!r}"
        if k is not None and KERNELS[k][1] not in (path or "").split("/"):
            return f"{k} at op {j}, under {path} and not {KERNELS[k][1]}"
    return None


def graph_launches(trace) -> int:
    """The window's graph replays: the ``cudaGraphLaunch`` calls made in it
    whose ops the trace holds."""
    return len({corr for _, corr in trace.op_info
                if (call := trace.launched_by.get(corr)) and call[0].startswith(GRAPH_LAUNCH)
                and trace.lo <= call[1] < trace.hi})


def device_split(trace, layout) -> dict | None:
    """The window's device seconds of every op but K1, K2 and K4 (those
    ``glue_ms`` sums), split four ways: ``staging`` (launched outside the
    graph), ``solve`` and ``adjoint`` (graph ops under a ``solve.*`` or
    ``adjoint.*`` span) and ``unspanned`` (graph ops under none); with
    ``by_span`` {span or STAGING or NO_SPAN: [seconds, ops]} of every op, K1,
    K2 and K4 included, and the ``replays`` matched. An op is the window's
    where the runtime call that launched it began in the window (a replay's
    last ops can carry device times a few µs past the window's end, which
    cut them from a replay judged by their own start). The graph's parts
    are None where there is no layout or a replay does not match it; the
    whole is None where an op of the window has no correlation id."""
    staging, by_launch = [], {}
    for i, ((_, s, _), (_, corr)) in enumerate(zip(trace.ops, trace.op_info)):
        name, at = trace.launched_by.get(corr, ("", s))
        if not trace.lo <= at < trace.hi:
            continue
        if corr is None:
            return None
        if name.startswith(GRAPH_LAUNCH):
            by_launch.setdefault(corr, []).append(i)
        else:
            staging.append(i)

    def secs(i):
        return trace.ops[i][2] - trace.ops[i][1]

    def glue(i):
        return _which(trace.ops[i][0]) is None

    out = {"staging": sum(secs(i) for i in staging if glue(i)), "solve": None, "adjoint": None,
           "unspanned": None, "replays": 0, "by_span": {STAGING: [sum(map(secs, staging)),
                                                                  len(staging)]}}
    nodes = flat(layout) if layout else None
    if not nodes:
        return out
    parts = {"solve": 0.0, "adjoint": 0.0, "unspanned": 0.0}
    by_span: dict = {}
    differ = []
    for idx in by_launch.values():
        idx.sort(key=lambda i: (trace.ops[i][1], trace.ops[i][2]))
        why = mismatch(nodes, [(trace.ops[i][0], trace.op_info[i][0]) for i in idx])
        if why:
            differ.append(why)
            continue
        for i, (path, _, _) in zip(idx, nodes):
            root = path.split("/")[0].split(".")[0] if path else None
            if glue(i):
                parts[root if root in ("solve", "adjoint") else "unspanned"] += secs(i)
            label = by_span.setdefault(path or NO_SPAN, [0.0, 0])
            label[0] += secs(i)
            label[1] += 1
    if differ:
        out["mismatch"] = f"{len(differ)} differ, the first: {differ[0]}"
        out["replays"] = len(by_launch) - len(differ)
        return out
    out.update(parts, replays=len(by_launch))
    out["by_span"].update(by_span)
    return out


def split_of(ctx) -> dict | None:
    """``device_split`` of the context's window (b), computed once."""
    if not hasattr(ctx, "_device_split"):
        ctx._device_split = device_split(ctx.trace, ctx.layout)
    return ctx._device_split


def offset(trace) -> tuple[float | None, float | None]:
    """(trace clock minus host clock in seconds, from the first mark's ends,
    or None; the second mark's disagreement with it in seconds, or None)."""
    if len(trace.marks) != 2 or len(trace.host_marks) != 2:
        return None, None
    o = [e - h * 1e-9 for (_, e), h in zip(trace.marks, trace.host_marks)]
    skew = o[1] - o[0]
    return (o[0] if abs(skew) <= MAX_SKEW_S else None), skew


def innermost(spans) -> list[tuple[int, int, str]]:
    """Disjoint (start_ns, end_ns, name) pieces of the time that nested
    ``spans`` of one thread cover, each named by the innermost span open
    in it."""
    pieces, stack, t = [], [], 0
    for r in sorted(spans, key=lambda r: (r.start_ns, -r.end_ns)):
        while stack and stack[-1][0] <= r.start_ns:
            end, name = stack.pop()
            if t < end:
                pieces.append((t, end, name))
                t = end
        if stack and t < r.start_ns:
            pieces.append((t, r.start_ns, stack[-1][1]))
        t = r.start_ns
        stack.append((r.end_ns, r.name))
    while stack:
        end, name = stack.pop()
        if t < end:
            pieces.append((t, end, name))
            t = end
    return pieces


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a, b) -> float:
    """Seconds that two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(rec: Recorded) -> dict | None:
    """Window (d)'s idle gaps by what the host was in when each began: the
    innermost span open on the loop's thread, else the runtime call
    (``Profiled.idle``'s label); ``idle``, their seconds; and
    ``in_staging``, the idle seconds during which the loop's thread was
    inside a ``staged.*`` span. None where the clocks do not align."""
    tr = rec.trace
    off, _ = offset(tr) if tr is not None else (None, None)
    if off is None:
        return None
    main = [r for r in rec.spans if r.thread == rec.thread]
    pieces = [(s * 1e-9 + off, e * 1e-9 + off, name) for s, e, name in innermost(main)]
    starts = [p[0] for p in pieces]
    gaps, by_label = tr.idle(), {}
    for s, e, call in gaps:
        k = bisect.bisect_right(starts, s) - 1
        label = pieces[k][2] if k >= 0 and s < pieces[k][1] else call
        by_label[label] = by_label.get(label, 0.0) + (e - s)
    staged = _union((r.start_ns * 1e-9 + off, r.end_ns * 1e-9 + off) for r in main
                    if r.name.startswith("staged."))
    return {"by_label": by_label, "idle": sum(e - s for s, e, _ in gaps),
            "in_staging": _overlap([(s, e) for s, e, _ in gaps], staged)}


def per_call_ms(rec: Recorded | None, name: str) -> float | None:
    """Mean host milliseconds of the span ``name`` a staged call (a
    ``staged.call`` span) on the loop's thread, in a traced window."""
    if rec is None:
        return None
    mine = [r for r in rec.spans if r.thread == rec.thread]
    calls = sum(1 for r in mine if r.name == "staged.call")
    total = sum(r.end_ns - r.start_ns for r in mine if r.name == name)
    return 1e-6 * total / calls if calls and total > 0 else None


def breakdown(ctx, top: int = 10) -> dict:
    """The device's and the idle time by span: ``device_by_span`` [[span,
    device seconds, ops a step]] of window (b), ``idle_by_span`` [[span or
    runtime call, seconds]] of window (d)."""
    split = split_of(ctx)
    dev = []
    if split is not None and ctx.steps:
        dev = [[k, v[0], v[1] / ctx.steps]
               for k, v in sorted(split["by_span"].items(), key=lambda kv: -kv[1][0])]
    idle = idle_split(ctx.recorded_traced) if ctx.recorded_traced is not None else None
    gaps = sorted((idle or {}).get("by_label", {}).items(), key=lambda kv: -kv[1])[:top]
    return {"device_by_span": dev, "idle_by_span": [[k, v] for k, v in gaps]}


def _ms_a_call(window) -> float | None:
    return 1e3 * sum(window.dispatch) / len(window.dispatch) if window.dispatch else None


def readings(ctx) -> dict:
    """The numbers of the four windows, each None where it cannot be read:

    ``replay_host_ms_a``, ``replay_host_ms_c``: the host's mean ms a call of
    the step in (a) and in (c), as ``replay_host_ms`` reads it;
    ``stage_key_ms``, ``stage_copy_in_ms``, ``stage_replay_ms``,
    ``stage_clone_ms``: the mean ms a call of the spans ``staged.key``,
    ``staged.copy_in``, ``staged.replay``, ``staged.clone_out`` in (c);
    ``stage_copy_ms``, ``glue_fwd_ms``, ``glue_bwd_ms``,
    ``glue_unspanned_ms``: device ms a step in (b) of the ops but K1, K2 and
    K4 that staging launched outside the graph, and of the graph's ops under
    a ``solve.*`` span, an ``adjoint.*`` span, or none (the caller's loss
    and counts, autograd's adjoints of the program's torch ops); they sum to
    ``glue_ms``, read in (b) as ``portbench/metrics/glue_ms.py`` reads it;
    ``idle_in_staging_pct``: % of (d) in which the card was idle while the
    loop's thread was inside a ``staged.*`` span, and
    ``staging_share_of_idle_pct`` that idle as a share of (d)'s idle."""
    out = {"replay_host_ms_a": _ms_a_call(ctx.untraced),
           "replay_host_ms_c": _ms_a_call(ctx.recorded.window)}
    for part in ("key", "copy_in", "replay", "clone_out"):
        key = "stage_clone_ms" if part == "clone_out" else f"stage_{part}_ms"
        out[key] = per_call_ms(ctx.recorded, f"staged.{part}")
    split = split_of(ctx)
    for key, part in (("stage_copy_ms", "staging"), ("glue_fwd_ms", "solve"),
                      ("glue_bwd_ms", "adjoint"), ("glue_unspanned_ms", "unspanned")):
        v = None if split is None else split[part]
        out[key] = None if v is None or not ctx.steps else 1e3 * v / ctx.steps
    out["glue_ms"] = glue_ms.read(ctx)
    tr = ctx.recorded_traced.trace
    idle = idle_split(ctx.recorded_traced)
    out["idle_in_staging_pct"] = (None if idle is None or tr.window_s <= 0
                                  else 100.0 * idle["in_staging"] / tr.window_s)
    out["staging_share_of_idle_pct"] = (None if idle is None or idle["idle"] <= 0
                                        else 100.0 * idle["in_staging"] / idle["idle"])
    return out


def cost(step, pool, counts, seconds, device, tracing, pairs: int) -> dict:
    """The cost of tracing on the staged call's host path: ``pairs`` pairs
    of an untraced window (a) and one with tracing on (c), in the order a c,
    c a, a c, ... so that a drift of the host falls on both; each window's
    mean host ms a call, and (c) against (a) in % by the means, by the
    medians, and as the median of the pairs' own differences."""
    thread = threading.get_ident()
    a, c = [], []
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                w = record(tracing, lambda: loop.run(step, pool, counts, seconds, device),
                           thread).window
            else:
                w = loop.run(step, pool, counts, seconds, device)
            w.kept = []
            (c if on else a).append(_ms_a_call(w))
    pct = lambda x, y: 100.0 * (y / x - 1)  # noqa: E731
    return {"untraced_ms": a, "traced_ms": c,
            "mean_pct": pct(statistics.mean(a), statistics.mean(c)),
            "median_pct": pct(statistics.median(a), statistics.median(c)),
            "pairwise_median_pct": statistics.median(pct(x, y) for x, y in zip(a, c))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=trace_mod.TRACE_SECONDS,
                    help="each window's length")
    ap.add_argument("--pairs", type=int, default=0,
                    help="pairs of alternating untraced and traced windows for the cost")
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    cfg, traffic, wl = spec["config"], spec["traffic"], spec["spec"]

    import torch

    if not torch.cuda.is_available():
        raise run.Refused("the windows read the card's activity: they need a CUDA card", 1)
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    dqt = importlib.import_module(cfg["package"])
    tracing = importlib.import_module(f"{cfg['package']}.utils.tracing")
    dqt.enable_compilation_cache(str(run.ROOT / cfg["package"] / "_build"))
    problem = importlib.import_module(f"portbench.problems.{cfg['problem']}")

    t = time.time()
    pool = problem.make_pool(cfg, int(wl["pool"]), args.seed, device)
    fn, counts = problem.make_step(cfg, traffic, device)
    step = importlib.import_module(f"{cfg['package']}.utils").staged(fn)
    for k in range(len(pool) + 4):        # the warm-up calls, the capture, a replay a slot
        step(*pool[k % len(pool)])
    loop.warm_allocator(step, pool)
    torch.cuda.synchronize()
    run.log(f"setup: {time.time() - t:.4f} s")

    untraced, tr, rec, rec_tr = windows(step, pool, counts, args.seconds, device, tracing,
                                        cfg["package"], run.log)
    ctx = types.SimpleNamespace(trace=tr, untraced=untraced, recorded=rec,
                                recorded_traced=rec_tr, layout=layout_of(step),
                                steps=tr.window.steps)
    for line in summary(ctx):
        run.log(line)
    out = {"workload": args.workload, "seed": args.seed, "card": run.power_limit(),
           "readings": readings(ctx), **breakdown(ctx)}
    if args.pairs > 0:
        out["cost"] = c = cost(step, pool, counts, args.seconds, device, tracing, args.pairs)
        run.log(f"cost: {args.pairs} pairs, (c) against (a) {c['mean_pct']:+.2f} % by the means, "
                f"{c['median_pct']:+.2f} % by the medians, {c['pairwise_median_pct']:+.2f} % "
                f"the median pair")
    bad = run.forbidden_modules()
    if bad:
        raise run.Refused(f"JAX modules were loaded in this process: {bad}", 3)
    return out


if __name__ == "__main__":
    try:
        res = main()
    except run.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        sys.exit(e.code)
    print(json.dumps(res))
