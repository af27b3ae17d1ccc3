"""The step loop every cell runs: one client, a closed loop with a fixed
number of steps in flight, as a training loop or a vectorised simulator
runs when it reads each step's result.

Step k + 1 is dispatched, then the host waits on the completion event of
the oldest step in flight. Inputs come from the pool in turn. The step
itself adds its converged problems and iterations to a device tensor, read
once after the window. The outputs of the window's first and last pass over
the pool are kept for the comparison with the reference.
"""

from __future__ import annotations

import collections
import gc
import time

import torch

# steps in flight in every cell: step k + 1 is dispatched before the host
# waits on step k
IN_FLIGHT = 2


class Window:
    """What one window did: steps completed, the host-clock latency of each
    (dispatch to the host seeing it complete, seconds) and the host time of
    each call of the step (``dispatch``, seconds), the window's length,
    the converged problems and iterations, and the kept outputs as (pool
    slot, output) pairs."""

    def __init__(self):
        self.steps = 0
        self.latency: list[float] = []
        self.dispatch: list[float] = []
        self.seconds = 0.0
        self.converged = 0
        self.iterations = 0
        self.kept: list[tuple[int, tuple]] = []


def run(step, pool: list[tuple], counts, seconds: float, device: torch.device,
        marker=None) -> Window:
    """Drive ``step`` over ``pool`` for ``seconds`` of the host clock, then
    drain the steps still in flight. ``counts`` is the device tensor that
    every step adds its converged problems and iterations to. ``marker()``,
    where given, is called right before the first step and right after the
    last completes (a trace's bounds)."""
    cuda = device.type == "cuda"
    w = Window()
    counts.zero_()
    first = {}
    last = collections.deque(maxlen=len(pool))
    pending = collections.deque()
    gc.collect()
    gc.disable()
    try:
        if marker:
            marker()
        t0 = time.perf_counter()
        t_end = t0 + seconds
        k = 0
        while True:
            if time.perf_counter() >= t_end:
                break
            slot = k % len(pool)
            t_disp = time.perf_counter()
            out = step(*pool[slot])
            w.dispatch.append(time.perf_counter() - t_disp)
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
            if len(first) < len(pool):
                first[slot] = out
            last.append((slot, out))
            pending.append((t_disp, ev))
            k += 1
            while len(pending) >= IN_FLIGHT:
                _complete(w, pending.popleft())
        while pending:
            _complete(w, pending.popleft())
        w.seconds = time.perf_counter() - t0
        if marker:
            marker()
    finally:
        gc.enable()
    w.converged, w.iterations = (int(x) for x in counts.tolist())
    w.kept = list(first.items()) + list(last)
    return w


def _complete(w: Window, item) -> None:
    t_disp, ev = item
    if ev is not None:
        ev.synchronize()
    w.latency.append(time.perf_counter() - t_disp)
    w.steps += 1


def warm_allocator(step, pool: list[tuple]) -> None:
    """As many steps as a window keeps outputs of, plus those in flight, all
    held at once and then let go: the caching allocator then holds the
    blocks that the window's kept outputs take, and asks the driver for no
    memory inside the window."""
    held = [step(*pool[k % len(pool)]) for k in range(2 * len(pool) + IN_FLIGHT)]
    del held
