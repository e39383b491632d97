"""k-nearest-neighbor mean squared distance.

Port of `egogaussian_tpu/ops/knn.py`, the replacement of the reference's
`simple_knn._C.distCUDA2` (used once per point-cloud init to seed
log-scales). The JAX version takes `lax.approx_min_k` (recall 0.99) on the
TPU; this one is an exact top-k. Squared distances use the same expansion
|b|^2 - 2 b.p + |p|^2 as the JAX version, blockwise, so both packages agree
to float32 rounding.
"""
from __future__ import annotations

import torch

_BIG = 1e30  # stands in for excluded entries (self distance)


def mean_sq_dist_to_knn(
    points: torch.Tensor, k: int = 3, block_size: int = 2048
) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest neighbors.

    Args:
      points: [N, 3] float32
      k: number of neighbors (excluding self), default 3 like distCUDA2
    Returns: [N] mean of the k smallest squared distances (self excluded)
    """
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    cols = torch.arange(n, device=points.device)
    for lo in range(0, n, block_size):
        b = points[lo:lo + block_size]
        d2 = (
            torch.sum(b * b, dim=-1)[:, None]
            - 2.0 * (b @ points.T)
            + sq[None, :]
        )
        rows = torch.arange(lo, lo + b.shape[0], device=points.device)
        d2 = torch.where(rows[:, None] == cols[None, :], _BIG, d2)
        smallest = torch.topk(d2, min(k, n), dim=-1, largest=False).values
        out[lo:lo + b.shape[0]] = torch.mean(smallest, dim=-1)
    return out
