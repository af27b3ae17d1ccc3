"""Input canonicalisation for the public API (port of utils/shapes.py).

Accepted layouts, as in the JAX package:

    q: (B, N), (B, N, 1), (N,), (N, 1)
    P: (B, N, N) dense | (N, N) dense (unbatched, or shared by a batch)
       | (B, N) / (N,) diagonal

Everything is computed over flat batched (B, N) / (B, N, N) tensors, and the
caller's q layout is restored on output. A diagonal P stays (B, N): the
eager engine and the closed-form adjoints take it, the kernels do not (the
JAX kernel path does not either).

``fold_vmapped`` / ``unfold_vmapped`` are the two halves of the port's
``torch.func.vmap`` rules (``api._Solve``, ``api._SolveAdjoint``,
``ops.linalg._NSAdaptive``): the vmapped dimension G is folded into the
leading problem batch, (G, B, ...) -> (G*B, ...), so a vmapped call is one
call over G*B problems in the order of the flat batch, and split off again
on the way out.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.glue_cuda import symmetrize

__all__ = ["Canon", "canon_problem", "canon_like", "fields_from_numpy", "fold_vmapped",
           "unfold_vmapped"]


class Canon(NamedTuple):
    P: torch.Tensor                # (B, N, N) dense or (B, N) diagonal
    q: torch.Tensor                # (B, N)
    batched: bool                  # caller passed a batch dimension
    column: bool                   # caller used trailing (..., 1) columns
    restore: Callable[[torch.Tensor], torch.Tensor]


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()                        # e.g. np.asarray of a JAX array
    return torch.as_tensor(x, device=device)


def _flatten_vec(x: torch.Tensor, name: str) -> tuple[torch.Tensor, bool, bool]:
    """-> (flat (B, M), batched, column)."""
    if x.ndim == 1:
        return x[None, :], False, False
    if x.ndim == 2:
        if x.shape[-1] == 1:  # (N, 1) unbatched column
            return x[None, :, 0], False, True
        return x, True, False
    if x.ndim == 3:
        if x.shape[-1] != 1:
            raise ValueError(f"{name}: 3-D input must be (B, N, 1), got {tuple(x.shape)}")
        return x[:, :, 0], True, True
    raise ValueError(f"{name}: unsupported rank {x.ndim}")


def canon_problem(P, q, device=None) -> Canon:
    P = _as_tensor(P, device)
    q = _as_tensor(q, device)
    # (B, 1) q is ambiguous with an unbatched (N, 1) column; with a matching
    # (B, 1) diagonal P the batched N=1 reading is the only consistent one.
    if (
        q.ndim == 2
        and q.shape[-1] == 1
        and P.ndim == 2
        and P.shape == q.shape
        and q.shape[0] > 1
    ):
        qf, batched, column = q, True, False
    else:
        qf, batched, column = _flatten_vec(q, "q")
    n = qf.shape[-1]

    if P.ndim == 1:                        # (N,) diagonal, unbatched
        if P.shape[0] != n:
            raise ValueError(f"P {tuple(P.shape)} incompatible with q of size {n}")
        Pf = P[None, :]
    elif P.ndim == 3:                      # (B, N, N) dense
        if tuple(P.shape[-2:]) != (n, n):
            raise ValueError(f"P {tuple(P.shape)} incompatible with q of size {n}")
        Pf = P
    elif P.ndim == 2:
        if not batched:                    # (N, N) dense, unbatched
            if tuple(P.shape) != (n, n):
                raise ValueError(f"P {tuple(P.shape)} incompatible with q of size {n}")
            Pf = P[None]
        else:                              # batched: (B, N) diag or (N, N) shared
            if P.shape == qf.shape:
                Pf = P
            elif tuple(P.shape) == (n, n):
                Pf = P[None].expand(qf.shape[0], n, n)
            else:
                raise ValueError(
                    f"P {tuple(P.shape)} incompatible with q {tuple(qf.shape)}"
                )
    else:
        raise ValueError(f"P: unsupported rank {P.ndim}")

    if Pf.ndim == 3 and Pf.shape[0] != qf.shape[0]:
        if Pf.shape[0] == 1:
            Pf = Pf.expand((qf.shape[0],) + tuple(Pf.shape[1:]))
        else:
            raise ValueError(
                f"batch mismatch: P {tuple(Pf.shape)}, q {tuple(qf.shape)}"
            )

    # mixed precision: unify to the promoted dtype
    common = torch.promote_types(Pf.dtype, qf.dtype)
    if not common.is_floating_point:
        common = torch.get_default_dtype()
    Pf = Pf.to(common)
    qf = qf.to(common)

    # the quadratic form only sees the symmetric part of P; the kernel reads
    # P as symmetric, so symmetrise here (as the JAX package does), in one
    # pass on the card (G1), whose adjoint is one pass too
    if Pf.ndim == 3:
        Pf = symmetrize(Pf)

    def restore(x: torch.Tensor) -> torch.Tensor:
        if column:
            x = x[..., None]
        if not batched:
            x = x[0]
        return x

    return Canon(P=Pf, q=qf, batched=batched, column=column, restore=restore)


def canon_like(x, canon: Canon, name: str, width: int | None = None) -> torch.Tensor:
    """Canonicalise an auxiliary vector (warm_start, l_n, mu, ...) to (B, M)
    with the main problem's batch convention. ``width`` disambiguates the
    (B, 1)-batched vs (N, 1)-column reading for width-1 vectors."""
    x = _as_tensor(x, canon.q.device)
    B = canon.q.shape[0]
    if width is not None and canon.batched and x.ndim == 2 and tuple(x.shape) == (B, width):
        xf = x
    else:
        xf, batched, _ = _flatten_vec(x, name)
        if batched and not canon.batched and xf.shape[0] != 1:
            raise ValueError(f"{name} is batched but the problem is not")
        if not batched and canon.batched:
            xf = xf.expand((B,) + tuple(xf.shape[1:]))
    if xf.shape[0] != B:
        if xf.shape[0] == 1:
            xf = xf.expand((B,) + tuple(xf.shape[1:]))
        else:
            raise ValueError(f"{name}: batch {xf.shape[0]} != {B}")
    return xf.to(canon.q.dtype)


def fields_from_numpy(cls, p, device, dtype=None):
    """A ``cls`` (a NamedTuple) from ``p``, any object with the same field
    names holding arrays: each field a tensor on ``device``, in ``dtype``
    (default: the arrays')."""
    return cls(*(torch.as_tensor(np.array(getattr(p, f)), dtype=dtype, device=device)
                 for f in cls._fields))


def fold_vmapped(batch_size: int, in_dims, xs) -> list:
    """The tensors ``xs`` of a vmap rule with their vmapped dimension (at
    ``in_dims``; None for an unbatched input, which is expanded to
    ``batch_size``) folded into the leading batch axis: (G, B, ...) ->
    (G*B, ...), contiguous."""
    out = []
    for x, d in zip(xs, in_dims):
        x = x.movedim(d, 0) if d is not None else x.expand(batch_size, *x.shape)
        out.append(x.flatten(0, 1).contiguous())
    return out


def unfold_vmapped(batch_size: int, xs) -> tuple:
    """The inverse of ``fold_vmapped`` on a rule's outputs: (G*B, ...) ->
    (G, B, ...), the vmapped dimension at 0."""
    return tuple(x.unflatten(0, (batch_size, x.shape[0] // batch_size)) for x in xs)
