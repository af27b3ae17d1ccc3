"""A traced window: ``torch.profiler`` over a short steady stretch of the
step loop, read back from its Chrome trace into the device's work by name
and the host's CUDA calls.

Only the card's activity is traced (kernels, copies, fills and the CUDA
runtime calls that CUPTI sees): recording every CPU op as well slowed the
N=24 host path from ~2840 to ~1330 steps a second, against ~1550 this way.
The window runs from the end of the ``cudaDeviceSynchronize`` right before
the first step to the start of the one right after the last step completed. An
idle gap is labelled by the runtime call the host was inside when the card
went idle, or as host time between CUDA calls (Python, the package's host
work).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch

from portbench import loop, roofline

# the trace's categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "cudaDeviceSynchronize"
# seconds of a traced window, in every cell
TRACE_SECONDS = 1.0
BETWEEN = "host between CUDA calls"


class Trace:
    """One traced window: ``ops`` [(name, start_s, end_s)] on the device,
    ``calls`` [(name, start_s, end_s)] of the host's CUDA runtime calls,
    ``lo``, ``hi`` the window's bounds on the trace's clock, and the loop's
    ``Window``."""

    def __init__(self, ops, calls, lo, hi, window):
        self.ops, self.calls, self.lo, self.hi, self.window = ops, calls, lo, hi, window

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return roofline.union_seconds([(s, e) for _, s, e in self.ops], self.lo, self.hi)

    def device_s(self, match=lambda name: True) -> float:
        """Summed device seconds of the window's ops whose name ``match`` accepts."""
        return sum(e - s for name, s, e in self.ops if match(name) and self.lo <= s < self.hi)

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and idle time by what the
        host was doing when each gap began."""
        by_name: dict[str, float] = {}
        for name, s, e in self.ops:
            if self.lo <= s < self.hi:
                by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        calls = sorted(self.calls, key=lambda x: x[1])
        idle: dict[str, float] = {}
        i = 0
        for s, e in roofline.gaps([(a, b) for _, a, b in self.ops], self.lo, self.hi):
            while i < len(calls) and calls[i][2] <= s:
                i += 1
            label = calls[i][0] if i < len(calls) and calls[i][1] <= s else BETWEEN
            idle[label] = idle.get(label, 0.0) + (e - s)
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps]}


def run(step, pool, counts, seconds, device) -> Trace:
    """The loop for ``seconds`` under the profiler (the card's activity)."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        raise RuntimeError("a traced window reads the card's activity: it needs a CUDA device")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w = loop.run(step, pool, counts, seconds, device, marker=torch.cuda.synchronize)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops, calls = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((ev["name"], s, e))
        elif cat == "cuda_runtime":
            calls.append((ev["name"], s, e))
    # the loop's two marks are the consecutive pair with the most device work
    # between them (the profiler may synchronise too, outside them)
    marks = sorted((s, e) for name, s, e in calls if name == MARK)
    starts = sorted(s for _, s, _ in ops)
    best, lo, hi = 0, None, None
    for (_, a), (b, _) in zip(marks, marks[1:]):
        n = bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
        if n > best:
            best, lo, hi = n, a, b
    if lo is None:
        raise RuntimeError(f"no two {MARK} calls in the trace hold the window's device work")
    return Trace(ops, [c for c in calls if c[0] != MARK], lo, hi, w)
