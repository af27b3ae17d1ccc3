"""Spans and counters of the port's layers, on the host's clock
(``time.perf_counter_ns``), read in memory.

    from diffqcqp_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    out = step(*inputs)               # a staged replay: staged.call and its parts
    tracing.disable()
    records = tracing.spans()

Off by default, and nothing here writes a file or a log: a reader takes the
records from ``spans()`` (``portbench/spans.py`` reads them against a device
trace). While tracing is off and no capture is open, ``span`` costs one test
of a module-level value and returns a context manager that does nothing.

A span is ``Span(name, start_ns, end_ns, parent, thread)``: ``parent`` is
the name of the span that was open on the same thread when it began (None
at the top), ``thread`` the recording thread's ident; the stack of open
spans is per thread. Records go to a buffer of ``CAPACITY`` slots made at
import, each taken by one ``next`` of a counter (atomic under the
interpreter lock, so recording takes no lock); past it a record is dropped
and counted (``dropped()``), and the buffer never grows. A path that reads
the clock at each of its boundaries can record a span and its consecutive
parts as one record (``parts``), which ``spans()`` unfolds: a staged replay
does, at about a fifth of the cost of a span for each part.

Names are ``<layer>.<part>``: ``staged.*`` for ``utils/staging.py``'s replay
(``staged.call`` and its ``staged.key``, ``staged.copy_in``,
``staged.replay``, ``staged.clone_out``), ``solve.*`` and ``adjoint.*`` for
``api.py``'s forward and backward.

A replay runs no Python of the step, so the spans inside the step are also
recorded as the graph's layout, once, at its capture, whether tracing is on
or not: ``capture(nodes)`` opens a layout (``Layout``) for the capture, and
every span boundary inside it, on any thread (autograd runs the adjoint on
one of its own), notes how many nodes the capturing graph holds
(``nodes()``) and the path of spans then open on the thread that crossed it
(``staged.*`` left out). ``Layout.segments`` then puts each node of the
finished graph, in the order the graph lists them, under the path that was
open when it was recorded.

Counters are kept by the objects they count and stay readable whether
tracing is on or not (a kernel wrapper's ``launches``, a staged function's
``eager_calls`` and ``captures``, ``kernels/_build.py``'s ``builds``);
``bump`` adds one under the recorder's one lock, since a bare ``+= 1`` from
two threads can lose one (the shards of a sharded solve launch from several).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, NamedTuple

__all__ = ["CAPACITY", "Layout", "Span", "bump", "capture", "disable", "dropped", "enable",
           "parts", "reset", "span", "spans"]

CAPACITY = 1 << 18      # span records a window can hold


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    thread: int


# the switch, and whether spans do anything: tracing is on, or a capture's
# layout is open
enabled = False
active = False

_lock = threading.Lock()
# (name, start_ns, end_ns, parent, thread), or a ``parts`` record:
# (name, (time, ...), parent, thread, (part name, ...))
_buf: list = [None] * CAPACITY
_slots = itertools.count()
_dropped = 0
_layout: Layout | None = None
_local = threading.local()


def _refresh() -> None:
    global active
    active = enabled or _layout is not None


def enable() -> None:
    """Record spans from now on."""
    global enabled
    enabled = True
    _refresh()


def disable() -> None:
    """Stop recording; what was recorded stays readable."""
    global enabled
    enabled = False
    _refresh()


def _filled():
    return itertools.takewhile(lambda r: r is not None, _buf)


def reset() -> None:
    """Forget every record and dropped record."""
    global _slots, _dropped
    with _lock:
        for i in range(sum(1 for _ in _filled())):
            _buf[i] = None
        _slots = itertools.count()
        _dropped = 0


def spans() -> list[Span]:
    """The spans recorded since the last ``reset``, in the order they ended
    (a ``parts`` record's parts, then its span)."""
    out = []
    with _lock:
        for r in _filled():
            if type(r[1]) is tuple:
                name, times, parent, thread, names = r
                out += [Span(part, times[i], times[i + 1], name, thread)
                        for i, part in enumerate(names)]
                out.append(Span(name, times[0], times[-1], parent, thread))
            else:
                out.append(Span(*r))
    return out


def dropped() -> int:
    """The spans lost to a full buffer since the last ``reset``."""
    with _lock:
        return _dropped


def bump(obj, attr: str, key=None) -> None:
    """Add one to ``obj.attr``, a counter the object keeps, or with ``key``
    to ``obj.attr[key]`` (a dict of counters; a new key starts at 0), under
    the recorder's lock."""
    with _lock:
        if key is None:
            setattr(obj, attr, getattr(obj, attr) + 1)
        else:
            counts = getattr(obj, attr)
            counts[key] = counts.get(key, 0) + 1


def _thread() -> tuple[list, int]:
    """This thread's stack of open span names and its ident."""
    try:
        return _local.state
    except AttributeError:
        state = _local.state = ([], threading.get_ident())
        return state


def _record(rec: tuple) -> None:
    global _dropped
    i = next(_slots)
    if i < CAPACITY:
        _buf[i] = rec
    else:
        with _lock:
            _dropped += 1


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "start", "state")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        state = self.state = _thread()
        stack = state[0]
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        layout = _layout
        if layout is not None:
            layout.mark(stack)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack, ident = self.state
        stack.pop()
        layout = _layout
        if layout is not None:
            layout.mark(stack)
        if enabled:
            _record((self.name, self.start, end, self.parent, ident))
        return False


def span(name: str):
    """A context manager that records the span ``name`` around its block
    while tracing is on, and marks the open capture's layout at both ends."""
    if not active:
        return _OFF
    return _Span(name)


def parts(root: str, names: tuple, times: tuple) -> None:
    """Record, while tracing is on and as one record, the span ``root`` from
    ``times[0]`` to ``times[-1]`` under the span open on this thread, and
    its consecutive parts, ``names[i]`` from ``times[i]`` to
    ``times[i + 1]``."""
    if not enabled:
        return
    stack, ident = _thread()
    _record((root, times, stack[-1] if stack else None, ident, names))


class Layout:
    """A capture's span boundaries: ``marks`` [(nodes the graph held, path
    of program spans open from then on, or None)], the first taken when the
    capture opened."""

    def __init__(self, nodes: Callable[[], int]):
        self.nodes = nodes
        self.marks: list[tuple[int, str | None]] = [(nodes(), None)]

    def mark(self, stack: list) -> None:
        path = "/".join(n for n in stack if not n.startswith("staged.")) or None
        self.marks.append((self.nodes(), path))

    def segments(self, nodes: list) -> list[tuple[str | None, tuple]] | None:
        """``nodes`` (the finished graph's, in the order it lists them, each
        ``(kind, kernel name or None)``) grouped in runs under the path open
        when each was recorded: [(path or None, (node, ...)), ...]. None for
        a graph that holds a conditional node: its bodies' work is hidden
        from a trace."""
        if any(kind == "conditional" for kind, _ in nodes):
            return None
        out: list[tuple[str | None, list]] = []
        k, path = 0, None
        for i, node in enumerate(nodes):
            while k < len(self.marks) and self.marks[k][0] <= i:
                path = self.marks[k][1]
                k += 1
            if out and out[-1][0] == path:
                out[-1][1].append(node)
            else:
                out.append((path, [node]))
        return [(p, tuple(ns)) for p, ns in out]


@contextlib.contextmanager
def capture(nodes: Callable[[], int]):
    """Open a layout for a capture: ``nodes()`` gives how many nodes the
    capturing graph holds. Yields the ``Layout``."""
    global _layout
    layout = Layout(nodes)
    _layout = layout
    _refresh()
    try:
        yield layout
    finally:
        _layout = None
        _refresh()
