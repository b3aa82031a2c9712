"""k-nearest-neighbour search and batched point gathering.

Counterpart of `puflow_tpu.ops.knn`. Distances use the same expanded form
``|x|^2 + |y|^2 - 2 x.y^T`` clamped at zero, and neighbours come back
sorted by ascending distance, so the first 8 columns of a K=16 graph are
the K=8 graph. Tie order between equal distances may differ from the JAX
package; every consumer is permutation-equivariant over neighbour slots.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[..., N, C]`` x ``[..., M, C]`` -> ``[..., N, M]`` squared
    distances, clamped at zero."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)            # [..., N, 1]
    y2 = torch.sum(y * y, dim=-1, keepdim=True)            # [..., M, 1]
    cross = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp_min(x2 + y2.transpose(-1, -2) - 2.0 * cross, 0.0)


def knn_indices(query: torch.Tensor, points: torch.Tensor, k: int,
                return_dist: bool = False):
    """Indices (into ``points``) of the k nearest neighbours of each query.

    query: ``[B, N, C]``; points: ``[B, M, C]`` -> ``idx [B, N, k]`` int64
    in ascending distance order, and optionally ``sqdist [B, N, k]``.
    """
    d = pairwise_sqdist(query, points)
    kd, idx = torch.topk(d, k, dim=-1, largest=False, sorted=True)
    if return_dist:
        return idx, kd
    return idx


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ..., :] = points[b, idx[b, ...], :]``.

    points: ``[B, M, C]``; idx: ``[B, ...]`` -> ``[B, ..., C]``.
    """
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)
