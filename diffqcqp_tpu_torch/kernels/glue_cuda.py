"""The QP family's P-sized passes, one pass each: the CUDA kernels G1
(P's symmetrisation and its adjoint) and G2 (the solvers' grad_P), and
their plain versions.

Neither replaces a Pallas kernel: the JAX package leaves both to XLA, which
fuses them into the jitted step. In the port each was a chain of PyTorch
ops writing a B x N x N tensor a link (kernels/csrc/glue.cu's note):

  * ``symmetrize(P)``: 0.5 (P + P^T), which ``utils/shapes.py::
    canon_problem`` applies to every dense (..., N, N) P, since the solvers
    see only P's symmetric part. It is an autograd Function (``_Symmetrize``)
    whose backward is itself applied to the cotangent in its adjoint form,
    0.5 G + 0.5 G^T, so its second derivative is right too; its vmap rule
    maps over any leading dimensions. Forward: (a + b) * 0.5 for a = P_ij,
    b = P_ji, as ``0.5 * (P + P.mT)`` rounds; adjoint: 0.5 a + 0.5 b, as
    autograd's adjoint of that expression rounds (the gradient scaled, then
    added to its transpose).
  * ``grad_p_cuda(dl, l)``: -0.5 (dl l^T + l dl^T), the symmetrised
    gradient of P at the solution (``api.py::_grad_P``), from (B, N) dl and
    l, the products rounded before their sum.

Routes, decided by the device alone: a CUDA tensor launches the kernel,
which takes float32 or float64 (dl and l of one dtype) at any size and
raises on any other dtype; a CPU tensor runs the plain version, the
PyTorch formula the kernel replaces. Both give the same bits: the kernels
round as the plain versions do (built with ``-fmad=false``).
``symmetrize_cuda`` and ``grad_p_cuda`` launch on the current stream with no synchronisation
and no read on the host, so a CUDA graph records them, and count their
launches (``launches``; ``symmetrize_cuda.launches_by_instance`` by
'forward' and 'adjoint').
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["KERNEL_DTYPES", "grad_p_cuda", "grad_p_plain", "symmetrize",
           "symmetrize_cuda", "symmetrize_plain"]

KERNEL_DTYPES = (torch.float32, torch.float64)


def symmetrize_plain(x: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
    """G1's plain version over the last two dimensions: 0.5 (x + x^T), or
    with ``adjoint`` 0.5 x + 0.5 x^T (the adjoint's rounding)."""
    if adjoint:
        h = 0.5 * x
        return h + h.transpose(-1, -2)
    return 0.5 * (x + x.transpose(-1, -2))


def grad_p_plain(dl: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """G2's plain version: -(dl l^T + l dl^T) / 2 of (B, N) dl and l."""
    return -0.5 * (dl[:, :, None] * l[:, None, :] + l[:, :, None] * dl[:, None, :])


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("glue")
    if not getattr(lib, "_dq_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.dq_symmetrize.argtypes = [vp, vp, ll, i, ll, ll, ll, i, i, vp]
        lib.dq_symmetrize.restype = i
        lib.dq_grad_p.argtypes = [vp, vp, vp, ll, i, i, vp]
        lib.dq_grad_p.restype = i
        lib._dq_typed = True
    return lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def symmetrize_cuda(x: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
    """G1 over the last two dimensions of x (..., N, N): 0.5 (x + x^T), or
    with ``adjoint`` 0.5 x + 0.5 x^T, contiguous, in one launch.

    A CPU tensor goes to ``symmetrize_plain``. A CUDA tensor must be float32
    or float64; it is read through its strides where its leading dimensions
    fold into one (a batch-broadcast P is not copied). The kernel launches
    on the current stream or this raises."""
    if x.device.type == "cpu":
        return symmetrize_plain(x, adjoint)
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device or the CPU, got {x.device}")
    if x.ndim < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"x must be (..., N, N), got {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or float64, got {x.dtype}")
    n = x.shape[-1]
    flat = x.reshape(-1, n, n) if x.ndim != 3 else x
    B = flat.shape[0]
    y = torch.empty((B, n, n), dtype=x.dtype, device=x.device)
    lib = _lib()
    sb, sr, sc = flat.stride()
    with torch.cuda.device(x.device):
        rc = lib.dq_symmetrize(flat.data_ptr(), y.data_ptr(), B, n, sb if B > 1 else n * n, sr, sc,
                               x.element_size(), int(adjoint), _stream(x.device))
    _build.check_rc(lib, rc, f"symmetrize (B={B}, N={n}, {x.dtype})")
    _build.count_launch(symmetrize_cuda, "adjoint" if adjoint else "forward")
    return y.reshape(x.shape)


symmetrize_cuda.launches = 0
symmetrize_cuda.launches_by_instance = {}


def grad_p_cuda(dl: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """G2: -(dl l^T + l dl^T) / 2 (B, N, N) of (B, N) dl and l, in one
    launch, with no B x N x N read.

    CPU tensors go to ``grad_p_plain``. CUDA tensors must share one device
    and one dtype, float32 or float64 (they are made contiguous); the kernel
    launches on the current stream or this raises."""
    if dl.ndim != 2 or tuple(dl.shape) != tuple(l.shape):
        raise ValueError(f"dl and l must be one (B, N) shape, got {tuple(dl.shape)} and "
                         f"{tuple(l.shape)}")
    if dl.device.type == "cpu" and l.device.type == "cpu":
        return grad_p_plain(dl, l)
    if dl.device != l.device or dl.device.type != "cuda":
        raise ValueError(f"dl and l must lie on one CUDA device, got {dl.device} and {l.device}")
    if dl.dtype != l.dtype or dl.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or float64 dl and l of one dtype, got "
                        f"{dl.dtype} and {l.dtype}")
    B, n = dl.shape
    dl, l = dl.contiguous(), l.contiguous()
    out = torch.empty((B, n, n), dtype=dl.dtype, device=dl.device)
    lib = _lib()
    with torch.cuda.device(dl.device):
        rc = lib.dq_grad_p(dl.data_ptr(), l.data_ptr(), out.data_ptr(), B, n, dl.element_size(),
                           _stream(dl.device))
    _build.check_rc(lib, rc, f"grad_p (B={B}, N={n}, {dl.dtype})")
    _build.count_launch(grad_p_cuda)
    return out


grad_p_cuda.launches = 0


class _Symmetrize(torch.autograd.Function):
    """``_Symmetrize.apply(x, adjoint)``: G1 (or its plain version) over the
    last two dimensions. The map is linear and self-adjoint, so the backward
    and the forward-mode tangent are the map again, in the adjoint's
    rounding for the backward; the backward being this Function, a second
    derivative is the map once more. The vmap rule moves the vmapped
    dimension in front, where it is one more leading dimension."""

    @staticmethod
    def forward(x, adjoint):
        return symmetrize_cuda(x, adjoint)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.adjoint = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Symmetrize.apply(g, True), None

    @staticmethod
    def jvp(ctx, t, _):
        return symmetrize_cuda(t, ctx.adjoint)

    @staticmethod
    def vmap(info, in_dims, x, adjoint):
        if in_dims[0] is None:
            return _Symmetrize.apply(x, adjoint), None
        return _Symmetrize.apply(x.movedim(in_dims[0], 0), adjoint), 0


def symmetrize(P: torch.Tensor) -> torch.Tensor:
    """0.5 (P + P^T) over the last two dimensions of P (..., N, N),
    differentiable (``_Symmetrize``): G1 for a CUDA P, else its plain
    version."""
    return _Symmetrize.apply(P, False)
