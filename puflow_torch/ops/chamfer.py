"""Chamfer distances from directed nearest-neighbour distances.

Counterpart of `puflow_tpu.ops.chamfer`: `chamfer_parts` (outlier removal,
`inference.patch.remove_outliers`, reduces them), `chamfer_distance` (the
training loss term of the pugan recipe, pytorch3d convention) and
`chamfer_distance_kaolin` (validation), and `hausdorff_distance` (the
evaluation's convention, per cloud).
"""

from __future__ import annotations

import torch

from puflow_torch.ops.knn import pairwise_sqdist


def chamfer_parts(x: torch.Tensor, y: torch.Tensor):
    """x: ``[B, N, C]``; y: ``[B, M, C]`` ->
    ``(d_xy [B, N], idx_xy [B, N], d_yx [B, M], idx_yx [B, M])`` with
    ``d_xy[b, i] = min_j |x_i - y_j|^2`` and ``idx_xy`` its argmin."""
    d = pairwise_sqdist(x, y)                        # [B, N, M]
    d_xy, idx_xy = torch.min(d, dim=-1)
    d_yx, idx_yx = torch.min(d, dim=-2)
    return d_xy, idx_xy, d_yx, idx_yx


def chamfer_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer distance, mean over points then over the batch:
    the sum of the two directed means (pytorch3d's convention)."""
    d_xy, _, d_yx, _ = chamfer_parts(x, y)
    return torch.mean(torch.mean(d_xy, dim=-1) + torch.mean(d_yx, dim=-1))


def chamfer_distance_kaolin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-cloud chamfer ``[B]`` in kaolin's convention:
    ``mean_i d_xy + mean_j d_yx``; callers pick the batch reduction."""
    d_xy, _, d_yx, _ = chamfer_parts(x, y)
    return torch.mean(d_xy, dim=-1) + torch.mean(d_yx, dim=-1)


def hausdorff_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-cloud symmetric Hausdorff distance ``[B]`` on squared NN
    distances: ``max_i d_xy + max_j d_yx``."""
    d_xy, _, d_yx, _ = chamfer_parts(x, y)
    return torch.amax(d_xy, dim=-1) + torch.amax(d_yx, dim=-1)
