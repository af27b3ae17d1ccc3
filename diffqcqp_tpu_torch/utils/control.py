"""Control flow on the device: ``while_loop`` and ``cond``, the port's
counterparts of the JAX package's ``lax.while_loop`` and ``lax.cond``.

    s = while_loop(lambda s: s.k < 10, lambda s: s._replace(k=s.k + 1), s0)
    x = cond(pred, lambda a: a + 1, lambda a: a, (a,))

``carry`` is a pytree of tensors (tuples, lists, dicts, named tuples; None
may stand for a leaf); ``cond_fn`` returns a 0-d bool tensor; ``body_fn``
returns a carry of the same structure, shapes and dtypes. ``cond``'s two
branches take ``operands`` and return pytrees of the same structure.

Outside a CUDA graph capture, or with CPU tensors, both are Python: the loop
reads its predicate on the host once an iteration, ``cond`` reads its
predicate once and runs one branch. Inside a capture on the card, where a
read of the device on the host fails, they record conditional nodes instead
(``kernels/csrc/graph_loop.cu``), so the loop's length and the branch are
decided on the card at every replay:

  * ``while_loop``: the carry is copied into buffers of the graph; a
    one-thread kernel sets a WHILE node's handle from ``cond_fn`` of the
    initial carry; the node's body graph runs ``body_fn`` on the buffers,
    copies its result into them and sets the handle again from ``cond_fn``;
  * ``cond``: two IF nodes, on ``pred`` and on its negation (PyTorch's own
    ``if_else_node`` makes the same two), each running its branch; a leaf
    that both branches return as the same tensor (a branch that updates a
    buffer in place, and one that leaves it) is returned as it is, any
    other is chosen after the nodes by ``torch.where(pred, ...)``, so
    neither branch writes into a tensor the other returned.

A node's body is captured on a stream of this module's own (one a nesting
depth: a body may hold nodes of its own) and its allocations are routed into
a memory pool of the capture's own (one a depth), kept as long as the graph.
A capture that holds these nodes is opened by ``graph`` (``utils.staged``
opens its captures so), which keeps those pools; under any other capture
they raise.
They need a CUDA runtime and driver of 12.4 or later (``versions``), and
PyTorch's private pool routing (``torch._C._cuda_beginAllocateCurrentStreamToPool``,
``_cuda_endAllocateToPool``, ``_cuda_releasePool``); without them they raise
under a capture. Nothing falls back to a host loop.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import threading
import weakref
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ["capture_nodes", "capturing", "cond", "graph", "graph_nodes", "node_counts",
           "versions", "while_loop"]

IF, WHILE = 0, 1                # the C interface's node kinds
# CUgraphNodeType: the kinds a trace shows work of, and conditional nodes
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 13: "conditional"}
MIN_CUDA = 12040                # conditional WHILE nodes: CUDA 12.4
POOL_APIS = ("_cuda_beginAllocateCurrentStreamToPool", "_cuda_endAllocateToPool",
             "_cuda_releasePool")

_lock = threading.Lock()
_streams: dict[tuple[int, int], torch.cuda.ExternalStream] = {}
# capture id -> the open capture it belongs to: the graph's own and each
# open node body's, so that any thread finds it (autograd runs a backward
# on a thread of its own, on the forward's stream)
_scopes: dict[int, "Scope"] = {}


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False without
    CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _read(pred: torch.Tensor) -> bool:
    """The host's read of a predicate: the one read a Python loop iteration
    or a Python ``cond`` makes."""
    return bool(pred)


class Scope:
    """A capture opened by ``graph``: its device, the memory pools of its
    nodes' bodies (one a nesting depth: PyTorch's allocator routes one
    stream at a time into a pool, and the capture's own pool is taken by the
    capture) with the times each was entered, and the conditional nodes
    recorded so far, {(kind, depth): count} (depth 0: in the graph itself,
    1: in a node's body, ...)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.depth = 0
        self.pools: list = []
        self.entered: collections.Counter = collections.Counter()
        self.recorded: collections.Counter = collections.Counter()

    def pool(self, depth: int):
        while len(self.pools) <= depth:
            self.pools.append(torch.cuda.graph_pool_handle())
        return self.pools[depth]


def _release(device_index: int, entered: dict) -> None:
    """Give back a graph's body pools: once for every time one was entered
    (each entry took a reference), so the allocator may free them."""
    for pool, times in entered.items():
        for _ in range(times):
            torch._C._cuda_releasePool(device_index, pool)


def _capture_id(stream) -> int:
    lib = _lib()
    cid = ctypes.c_ulonglong()
    _check(lib, lib.dq_capture_id(stream.cuda_stream, ctypes.byref(cid)),
           "cudaStreamGetCaptureInfo")
    return cid.value


@contextlib.contextmanager
def _open(stream, scope: Scope):
    """Let the capture ``stream`` takes part in find ``scope``."""
    cid = _capture_id(stream)
    with _lock:
        _scopes[cid] = scope
    try:
        yield
    finally:
        with _lock:
            _scopes.pop(cid, None)


def _scope() -> Scope | None:
    """The open capture the current stream takes part in, if ``graph``
    opened it."""
    cid = _capture_id(torch.cuda.current_stream())
    with _lock:
        return _scopes.get(cid)


@contextlib.contextmanager
def graph(cuda_graph: torch.cuda.CUDAGraph):
    """``torch.cuda.graph(cuda_graph)`` that lets ``while_loop`` and
    ``cond`` record their nodes. Yields the ``Scope``; the pools of the
    nodes' bodies are given back when ``cuda_graph`` is collected.

    Dead reference cycles are collected before the capture begins, and the
    cyclic garbage collector is off while it runs (PyTorch's own
    ``torch.cuda.graph`` no longer collects): a cycle that holds a graph of
    its own (a card ``SystemID`` and its staged step) collected in the
    middle of a capture destroys that graph and gives back its pools inside
    the capture, and the process died at the capture's end (a segmentation
    fault on an H100)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(cuda_graph):
            scope = Scope(torch.device("cuda", torch.cuda.current_device()))
            try:
                with _open(torch.cuda.current_stream(), scope):
                    yield scope
            finally:
                weakref.finalize(cuda_graph, _release, scope.device.index,
                                 dict(scope.entered)).atexit = False
    finally:
        if enabled:
            gc.enable()


def _lib():
    from ..kernels import _build

    lib = _build.load("graph_loop")
    if not getattr(lib, "_dq_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dq_graph_versions.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.dq_stream_create.argtypes = [ctypes.POINTER(p)]
        lib.dq_capture_id.argtypes = [p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.dq_capture_nodes.argtypes = [p, ctypes.POINTER(ctypes.c_size_t)]
        lib.dq_cond_begin.argtypes = [p, i, p, i, p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.dq_cond_end.argtypes = [p, ctypes.c_ulonglong, p]
        for f in (lib.dq_graph_versions, lib.dq_stream_create, lib.dq_capture_id,
                  lib.dq_capture_nodes, lib.dq_cond_begin, lib.dq_cond_end):
            f.restype = i
        lib._dq_typed = True
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: {lib.dq_cuda_error_string(rc).decode()}")


def versions() -> dict[str, int]:
    """The CUDA versions conditional nodes depend on, as integers (12080 is
    12.8): the runtime ``graph_loop.cu`` was built against, the driver's,
    and PyTorch's runtime (``torch.version.cuda``), which instantiates the
    graph."""
    lib = _lib()
    rt, drv = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.dq_graph_versions(ctypes.byref(rt), ctypes.byref(drv)), "cudaRuntimeGetVersion")
    major, minor = (int(x) for x in (torch.version.cuda or "0.0").split(".")[:2])
    return {"runtime": rt.value, "driver": drv.value, "torch": 1000 * major + 10 * minor}


def _require(scope: Scope | None, what: str) -> None:
    """Raise unless a conditional node can be recorded here."""
    if scope is None:
        raise RuntimeError(
            f"{what} under a CUDA graph capture records a conditional node, which needs the "
            "capture opened by utils.control.graph (utils.staged opens its captures so), which "
            "keeps the pools its nodes' bodies allocate from")
    missing = [name for name in POOL_APIS if not hasattr(torch._C, name)]
    old = {k: v for k, v in versions().items() if v < MIN_CUDA}
    if missing or old:
        raise RuntimeError(
            f"{what} under a CUDA graph capture needs conditional graph nodes: a CUDA runtime "
            f"and driver of 12.4 or later and PyTorch's pool routing; this process has "
            f"{versions()}" + (f" and lacks torch._C.{', '.join(missing)}" if missing else ""))


def _body_stream(device: torch.device, depth: int) -> torch.cuda.ExternalStream:
    """The stream that captures the bodies of nodes at ``depth``."""
    key = (device.index, depth)
    with _lock:
        s = _streams.get(key)
        if s is None:
            lib = _lib()
            ptr = ctypes.c_void_p()
            with torch.cuda.device(device):
                _check(lib, lib.dq_stream_create(ctypes.byref(ptr)), "cudaStreamCreate")
            s = _streams[key] = torch.cuda.ExternalStream(ptr.value, device=device)
        return s


class _Body:
    """An open node's body; a WHILE body sets ``pred`` before it closes."""

    pred: torch.Tensor | None = None


def _as_pred(p: Any, scope: Scope) -> torch.Tensor:
    if not (isinstance(p, torch.Tensor) and p.dtype == torch.bool and p.ndim == 0
            and p.device == scope.device):
        raise TypeError(f"a predicate is a 0-d bool tensor on {scope.device}, got "
                        + (f"{p.dtype} {tuple(p.shape)} on {p.device}"
                           if isinstance(p, torch.Tensor) else type(p).__name__))
    return p


@contextlib.contextmanager
def _node(scope: Scope, kind: int, pred: torch.Tensor, negate: bool = False):
    """Record a conditional node at the current point of the capture and
    capture what the block runs as its body."""
    lib = _lib()
    dev = scope.device
    outer = torch.cuda.current_stream(dev)
    body_stream = _body_stream(dev, scope.depth)
    handle = ctypes.c_ulonglong()
    _check(lib, lib.dq_cond_begin(outer.cuda_stream, kind, pred.data_ptr(), int(negate),
                                  body_stream.cuda_stream, ctypes.byref(handle)),
           "recording a conditional graph node")
    scope.recorded[("while" if kind == WHILE else "if", scope.depth)] += 1
    pool = scope.pool(scope.depth)
    scope.depth += 1
    body, done = _Body(), False
    try:
        with torch.cuda.stream(body_stream), _open(body_stream, scope):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
            scope.entered[pool] += 1
            try:
                yield body
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, pool)
        done = True
    finally:
        scope.depth -= 1
        end_pred = body.pred if done and kind == WHILE else None
        rc = lib.dq_cond_end(body_stream.cuda_stream, handle,
                             None if end_pred is None else end_pred.data_ptr())
    if kind == WHILE and end_pred is None:
        raise RuntimeError("a WHILE node's body closed without its predicate")
    _check(lib, rc, "closing a conditional graph node's body")


def _on_card(leaves: list) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves)


def _matching(out, spec, like: list, what: str) -> list:
    leaves, out_spec = pytree.tree_flatten(out)
    if out_spec != spec:
        raise TypeError(f"{what} returned a pytree of another structure: {out_spec} against "
                        f"{spec}")
    for a, b in zip(leaves, like):
        if (a is None) != (b is None):
            raise TypeError(f"{what} returned None where the carry has a tensor, or a tensor "
                            "where it has None")
        if a is not None and (a.shape != b.shape or a.dtype != b.dtype):
            raise TypeError(f"{what} returned a {a.dtype} {tuple(a.shape)} where the carry has "
                            f"a {b.dtype} {tuple(b.shape)}")
    return leaves


def _assign(bufs: list, new: list) -> None:
    """bufs[i] <- new[i] (None stays None); a new value that is a buffer
    itself is left alone where it is its own, and read before any buffer is
    written otherwise."""
    ptrs = {b.data_ptr() for b in bufs if b is not None}
    new = [x if x is b or x is None else (x.clone() if x.data_ptr() in ptrs else x)
           for x, b in zip(new, bufs)]
    for b, x in zip(bufs, new):
        if x is not b:
            b.copy_(x)


def while_loop(cond_fn: Callable[[Any], torch.Tensor], body_fn: Callable[[Any], Any], carry):
    """``lax.while_loop``: ``carry = body_fn(carry)`` while ``cond_fn(carry)``;
    returns the last carry. See the module's docstring for the two ways it
    runs."""
    leaves, spec = pytree.tree_flatten(carry)
    if not (capturing() and _on_card(leaves)):
        while _read(cond_fn(carry)):
            carry = body_fn(carry)
        return carry
    scope = _scope()
    _require(scope, "while_loop")
    bufs = [None if x is None else x.clone() for x in leaves]
    state = pytree.tree_unflatten(bufs, spec)
    with _node(scope, WHILE, _as_pred(cond_fn(state), scope)) as body:
        _assign(bufs, _matching(body_fn(state), spec, bufs, "while_loop's body_fn"))
        body.pred = _as_pred(cond_fn(state), scope)
    return state


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, operands=()):
    """``lax.cond``: ``true_fn(*operands)`` if ``pred`` else
    ``false_fn(*operands)``. See the module's docstring for the two ways it
    runs."""
    if not (capturing() and _on_card([pred, *pytree.tree_leaves(operands)])):
        return true_fn(*operands) if _read(pred) else false_fn(*operands)
    scope = _scope()
    _require(scope, "cond")
    p = _as_pred(pred, scope)
    with _node(scope, IF, p):
        leaves, spec = pytree.tree_flatten(true_fn(*operands))
    with _node(scope, IF, p, negate=True):
        other = _matching(false_fn(*operands), spec, leaves, "cond's false_fn")
    # neither branch writes into what the other returned: an operand or a
    # tensor of a closure that one branch returns stays as it is
    return pytree.tree_unflatten(
        [a if a is None or _same(a, b) else torch.where(p, a, b) for a, b in zip(leaves, other)],
        spec)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` are one tensor: the same memory, laid out
    alike."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride())


def capture_nodes(stream) -> int:
    """How many nodes the graph that ``stream`` captures holds so far (0
    where it captures nothing)."""
    lib = _lib()
    n = ctypes.c_size_t()
    _check(lib, lib.dq_capture_nodes(stream.cuda_stream, ctypes.byref(n)), "cudaGraphGetNodes")
    return n.value


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_cu = None


def _libcuda():
    global _cu
    if _cu is None:
        _cu = ctypes.CDLL("libcuda.so.1")
    return _cu


def _kernel_name(cu, node) -> str | None:
    """A kernel node's function name as the CUDA driver gives it (mangled),
    or None where this CUDA driver cannot say (``cuFuncGetName`` and
    ``cuKernelGetName`` came with CUDA 12.3 and 12.5)."""
    get = getattr(cu, "cuGraphKernelNodeGetParams_v2", None)
    params = _KernelNodeParams()
    if get is None or get(ctypes.c_void_p(node), ctypes.byref(params)) != 0:
        return None
    name = ctypes.c_char_p()
    for handle, fn in ((params.func, "cuFuncGetName"), (params.kern, "cuKernelGetName")):
        f = getattr(cu, fn, None)
        if handle and f is not None and f(ctypes.byref(name), ctypes.c_void_p(handle)) == 0:
            return name.value.decode(errors="replace") if name.value else None
    return None


def graph_nodes(cuda_graph: torch.cuda.CUDAGraph) -> list[tuple[str, str | None]]:
    """The nodes at the top level of a captured graph that PyTorch keeps
    (``torch.cuda.CUDAGraph(keep_graph=True)``), in the order the CUDA
    driver lists them (the order they were recorded in): (kind, kernel name or
    None), kind one of 'kernel', 'memcpy', 'memset', 'conditional' and
    'other'. Read through the CUDA driver API (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``, ``cuGraphKernelNodeGetParams``): the graph
    belongs to PyTorch's runtime, which is not ``graph_loop.cu``'s."""
    cu = _libcuda()
    g = ctypes.c_void_p(cuda_graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if rc == 0 and n.value:
        rc = cu.cuGraphGetNodes(g, nodes, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    out = []
    for node in nodes:
        t = ctypes.c_int()
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kind = NODE_KINDS.get(t.value, "other")
        out.append((kind, _kernel_name(cu, node) if kind == "kernel" else None))
    return out


def node_counts(cuda_graph: torch.cuda.CUDAGraph) -> dict[str, int]:
    """The nodes at the top level of a captured graph (``graph_nodes``), by
    kind: 'kernel', 'memcpy', 'memset', 'conditional' and 'other'."""
    kinds = collections.Counter(kind for kind, _ in graph_nodes(cuda_graph))
    return {k: kinds[k] for k in ("kernel", "memcpy", "memset", "conditional", "other")}
