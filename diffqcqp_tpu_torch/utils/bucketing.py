"""Batch-size bucketing (port of utils/bucketing.py).

Round a fluctuating batch (e.g. the number of active contacts a simulation
step) up to one of a few bucket sizes and strip the padding afterwards, so a
caller sees a bounded set of batch shapes (buffers, CUDA graphs, timings).

Padded problems are IDENTITY problems (P = I, or ones for a diagonal P;
q = 0) that converge in one iteration to l = 0; each costs one block of K1.

    from diffqcqp_tpu_torch.utils.bucketing import pad_to_bucket, unpad
    padded, info = pad_to_bucket((P, q, l_n, mu), buckets=(512, 1024, 4096))
    l, stats = solve_qcqp_with_stats(*padded, config=CFG)
    l = unpad(l, info)
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

__all__ = ["BucketInfo", "bucket_size", "pad_to_bucket", "unpad"]


class BucketInfo(NamedTuple):
    batch: int          # real batch size
    padded: int         # bucket size used


def bucket_size(batch: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= batch; the largest bucket's multiple if none fits
    (so arbitrarily large batches still hit a bounded set of sizes)."""
    for b in sorted(buckets):
        if batch <= b:
            return b
    top = max(buckets)
    return ((batch + top - 1) // top) * top


def pad_to_bucket(
    args: Sequence[torch.Tensor], buckets: Sequence[int] = (128, 512, 2048, 8192)
) -> tuple[tuple[torch.Tensor, ...], BucketInfo]:
    """Pad each tensor's leading batch dim up to the bucket size.

    args[0] must be P ((B, N, N) dense or (B, N) diagonal): its padding is
    the identity problem; every other tensor pads with zeros. Every tensor
    must carry the SAME leading batch dimension: broadcast conveniences the
    solver API accepts (a shared (N, N) P over a batched q, unbatched
    bounds) must be materialised by the caller first, because a shared dense
    P is indistinguishable from a diagonal batch here.
    """
    B = args[0].shape[0]
    for i, x in enumerate(args):
        if x.shape[0] != B:
            raise ValueError(
                f"pad_to_bucket: args[{i}] has leading dim {x.shape[0]} != "
                f"{B}; all arrays must share one batch dimension "
                "(broadcast/shared inputs must be materialised first)"
            )
    Bp = bucket_size(B, buckets)
    info = BucketInfo(batch=B, padded=Bp)
    if Bp == B:
        return tuple(args), info
    pad = Bp - B
    P = args[0]
    if P.ndim == 3:
        fill = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device).expand(pad, -1, -1)
    else:
        fill = P.new_ones((pad,) + tuple(P.shape[1:]))
    out = [torch.cat([P, fill])]
    out += [torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) for x in args[1:]]
    return tuple(out), info


def unpad(x: torch.Tensor, info: BucketInfo) -> torch.Tensor:
    """Strip the bucket padding from a leading-batch result (any
    ``SolveStats`` field too)."""
    return x[: info.batch]
