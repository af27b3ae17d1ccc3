"""Staging: a step captured once as a CUDA graph and replayed, the port's
counterpart of the JAX package's ``jax.jit``.

    step = staged(fn)
    out = step(P, q, l_n, mu)       # CUDA tensors: a graph replay per call

The JAX package runs its main path staged: bench.py times ``jax.jit`` of
``value_and_grad``, ``SystemID`` jits its training step. Eagerly, the port's
step is Python, autograd and 20-30 small launches, and at N = 24 the card
idles most of it. ``staged(fn)`` records the whole step, forward, backward
and optimiser update included, in one ``torch.cuda.CUDAGraph``; a call then
costs the input copies, one graph launch and the output copies.

The contract, as ``jax.jit``'s: ``fn`` takes tensors only (a pytree of
them: tuples, lists, dicts, named tuples), returns tensors only (None may
stand for one, as a Jacobian's ``dl_dP`` does), and reads
nothing on the host (no ``.item()``, ``bool(tensor)``, ``nonzero``, no
print of a value): inside a capture such a read fails. The solvers meet it
on every route but one: the kernels K1-K6; the eager engine, whose loop
and inverse recompute become conditional nodes (``utils/control.py``, the
counterparts of ``lax.while_loop`` and ``lax.cond``) and whose spectral
mode's eigendecomposition is the Jacobi kernel E1 (a dense P at N <= 48
off K1: float64, ``backend='xla'``, ``accel``, the traces at their default
``linsolve``; ``linsolve='spectral'`` at any N); the generic adjoint
route's Newton-Schulz loop, Cholesky and LU (``ops/linalg.py``); the
Jacobians, the traces and the contact rollout (``models/contact_sim.py``).
The engine's lockstep mode (``axis_name``) records too, its shards' loops
one WHILE node, where the mesh puts every shard of the process on one card
and holds no process group or a one-rank NCCL one; on more than one card,
over NCCL across ranks or over gloo, it raises a ``RuntimeError`` under a
capture that names the route and the reason (``capture_error``), before
anything is recorded. Nothing falls back to an eager run.

Per signature of the arguments (each tensor's shape, dtype, device and
``requires_grad``, and the pytree's structure; ``signature``), the first
``WARMUP`` calls run ``fn`` eagerly on a side stream, as PyTorch's
whole-network capture recipe does (lazy state such as an optimiser's
moments is made there); the next call captures ``fn`` once on static copies
of its inputs and replays it; every later call copies its inputs into those
buffers, replays, and returns clones of the outputs, detached (the graph's
own outputs are overwritten by the next replay). A new signature gets a
graph of its own, as ``jit`` retraces. The capture is opened by
``control.graph`` and kept (``keep_graph=True``), so that
``control.node_counts`` can read it; ``nodes`` gives the conditional nodes
each signature's capture recorded. Each call is one call of ``fn``: a
warm-up call returns its real result, so an optimiser step taken in
warm-up is a real step, and the capture itself computes nothing (its call
replays once). With CPU tensors ``fn`` runs eagerly and nothing is
captured.

State that ``fn`` reads or writes outside its arguments (a module's
parameters, an optimiser's moments) is captured by address: it must keep
its storage between calls (``torch.optim.Adam(..., capturable=True)``
does), and a replay updates it in place.

The kernels' launch counters (``launches`` on each wrapper) are Python
integers, bumped under the lock of ``utils/tracing.py`` where a wrapper
launches (``_build.count_launch``): they count the eager calls and the
launches recorded at capture, and a replay adds nothing. A staged function
counts its own ``eager_calls`` and ``captures`` the same way, and its
``replays`` while tracing is on, with no lock: a staged function's calls
are one thread's (a replay writes the graph's static input buffers).

With tracing on, a replay records the span ``staged.call`` and its parts:
``staged.key`` (the pytree's flatten, the signature, the device),
``staged.copy_in``, ``staged.replay`` and ``staged.clone_out``
(``_traced``, which takes ``_replay``'s steps in the same order); the
other calls record no ``staged.*`` span. With tracing off a call costs one
test of the switch over the untraced path.

Every capture, traced or not, records the graph's layout (``layout``): its
nodes in order, each under the path of ``api.py``'s spans (``solve.*``,
``adjoint.*``) open when it was recorded, so a trace of a replay, which
runs no Python of the step, can put each of its device ops under a layer of
the program.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from . import control, tracing

__all__ = ["WARMUP", "Staged", "capture_error", "signature", "staged"]

WARMUP = 3      # eager calls of a signature before its capture (PyTorch's recipe)
# the spans a traced replay records under staged.call, in order
_REPLAY_PARTS = ("staged.key", "staged.copy_in", "staged.replay", "staged.clone_out")
_UNTRACED = object()    # _traced's answer for a call that is not a replay


def capture_error(route: str, reason: str) -> RuntimeError:
    """The guard's error for a route that reads the device on the host,
    naming the route and why it was taken; every such route raises it
    where ``control.capturing()``, before it records anything:

        if control.capturing():
            raise capture_error("the lockstep mode", "a gloo group ...")
    """
    return RuntimeError(
        f"{route} cannot run inside a CUDA graph capture: {reason}. Every route of the "
        "solvers can be staged, the lockstep mode (axis_name) on a mesh of one card with no "
        "process group or a one-rank NCCL one; call this solve outside the capture"
    )


def _leaves(tree, none_ok: bool = False) -> tuple[list, Any]:
    leaves, spec = pytree.tree_flatten(tree)
    for x in leaves:
        if not (isinstance(x, torch.Tensor) or (none_ok and x is None)):
            raise TypeError(f"a staged function takes and returns tensors only, got a "
                            f"{type(x).__name__}")
    return leaves, spec


def signature(*args, **kwargs) -> tuple:
    """The key a graph is kept under: the pytree structure of the arguments
    and each tensor's (shape, dtype, device, requires_grad)."""
    return _key(*_leaves((args, kwargs)))


def _key(leaves: list, spec) -> tuple:
    return spec, tuple((tuple(x.shape), x.dtype, x.device, x.requires_grad) for x in leaves)


def _cuda_device(leaves: list) -> torch.device | None:
    """The one CUDA device that every tensor of ``leaves`` lies on, or None
    where they all lie on the CPU."""
    if not leaves:
        raise ValueError("a staged call takes at least one tensor: its device decides between "
                         "a graph and an eager call")
    devices = {x.device for x in leaves}
    if all(d.type == "cpu" for d in devices):
        return None
    if len(devices) != 1:
        raise ValueError(f"a staged call takes its tensors on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


class _Graph:
    """One signature's state: its eager calls so far, then its graph with
    the static input buffers and the graph's outputs."""

    def __init__(self):
        self.calls = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.nodes: dict = {}
        self.layout: list | None = None
        self.inputs: list = []
        self.outputs: list = []
        self.out_spec = None


class Staged:
    """``fn`` staged as one CUDA graph per signature; see the module's
    docstring. ``graphs`` maps each signature captured so far to its
    ``torch.cuda.CUDAGraph``."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.eager_calls = self.captures = self.replays = 0
        self._state: dict[tuple, _Graph] = {}
        self._side: dict[torch.device, torch.cuda.Stream] = {}
        functools.update_wrapper(self, fn)

    @property
    def graphs(self) -> dict:
        return {k: s.graph for k, s in self._state.items() if s.graph is not None}

    @property
    def nodes(self) -> dict:
        """{signature: {(kind, depth): count}} of the conditional nodes each
        capture recorded (``control.Scope.recorded``)."""
        return {k: s.nodes for k, s in self._state.items() if s.graph is not None}

    @property
    def layout(self) -> dict:
        """{signature: [(span path or None, ((kind, kernel name or None),
        ...)), ...]}: each capture's nodes in the order the graph lists them
        (``control.graph_nodes``), in runs under the path of program spans
        open when they were recorded (``tracing.Layout.segments``); None for
        a graph with conditional nodes."""
        return {k: s.layout for k, s in self._state.items() if s.graph is not None}

    def __call__(self, *args, **kwargs):
        if tracing.enabled and (out := self._traced(args, kwargs)) is not _UNTRACED:
            return out
        leaves, spec = _leaves((args, kwargs))
        dev = _cuda_device(leaves)
        if dev is None:
            return self.fn(*args, **kwargs)
        st = self._state.setdefault(_key(leaves, spec), _Graph())
        with torch.cuda.device(dev):
            if st.graph is None and st.calls < WARMUP:
                st.calls += 1
                return self._eager(dev, args, kwargs)
            if st.graph is None:
                self._capture(st, leaves, spec)
            return self._replay(st, leaves)

    def _traced(self, args, kwargs):
        """A replay with tracing on: ``_replay``'s steps with the clock read
        at each boundary, recorded as ``staged.call`` and its four parts at
        once (``tracing.parts``), so that tracing adds little to the path it
        times. Any other call (CPU tensors, a warm-up, the capture) returns
        ``_UNTRACED``, and ``__call__`` runs it as untraced."""
        t0 = time.perf_counter_ns()
        leaves, spec = _leaves((args, kwargs))
        dev = _cuda_device(leaves)
        st = None if dev is None else self._state.get(_key(leaves, spec))
        if st is None or st.graph is None:
            return _UNTRACED
        t1 = time.perf_counter_ns()
        self.replays += 1
        with torch.cuda.device(dev):
            with torch.no_grad():
                for buf, x in zip(st.inputs, leaves):
                    buf.copy_(x)
            t2 = time.perf_counter_ns()
            st.graph.replay()
            t3 = time.perf_counter_ns()
            out = pytree.tree_unflatten([None if x is None else x.detach().clone()
                                         for x in st.outputs], st.out_spec)
        tracing.parts("staged.call", _REPLAY_PARTS, (t0, t1, t2, t3, time.perf_counter_ns()))
        return out

    def _eager(self, dev: torch.device, args, kwargs):
        """One warm-up call on the side stream, ordered after the caller's
        stream and before its next work."""
        tracing.bump(self, "eager_calls")
        cur = torch.cuda.current_stream(dev)
        if dev not in self._side:
            self._side[dev] = torch.cuda.Stream(dev)
        side = self._side[dev]
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*args, **kwargs)
        cur.wait_stream(side)
        for x in _leaves(out, none_ok=True)[0]:
            if x is not None:
                x.record_stream(cur)    # made on the side stream, used on the caller's
        return out

    def _capture(self, st: _Graph, leaves: list, spec) -> None:
        tracing.bump(self, "captures")
        inputs = [x.detach().clone().requires_grad_(x.requires_grad) for x in leaves]
        args, kwargs = pytree.tree_unflatten(inputs, spec)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with control.graph(graph) as scope:
            stream = torch.cuda.current_stream()
            with tracing.capture(lambda: control.capture_nodes(stream)) as layout:
                out = self.fn(*args, **kwargs)
        graph.instantiate()
        st.outputs, st.out_spec = _leaves(out, none_ok=True)
        st.inputs, st.graph, st.nodes = inputs, graph, dict(scope.recorded)
        st.layout = layout.segments(control.graph_nodes(graph))

    @staticmethod
    def _replay(st: _Graph, leaves: list):
        with torch.no_grad():
            for buf, x in zip(st.inputs, leaves):
                buf.copy_(x)
        st.graph.replay()
        return pytree.tree_unflatten([None if x is None else x.detach().clone()
                                      for x in st.outputs], st.out_spec)


def staged(fn: Callable) -> Staged:
    """``fn`` staged as one CUDA graph per signature (``Staged``), the
    counterpart of ``jax.jit``; usable as a decorator:

        @staged
        def step(P, q, l_n, mu):
            xs = [x.detach().requires_grad_() for x in (P, q, l_n, mu)]
            l = solve_qcqp(*xs, config=cfg)
            return l, torch.autograd.grad((l * l).sum(), xs)
    """
    return Staged(fn)
