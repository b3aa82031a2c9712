"""Directed nearest-neighbour distances (Chamfer parts).

Counterpart of `puflow_tpu.ops.chamfer.chamfer_parts`; outlier removal
(`inference.patch.remove_outliers`) reduces them.
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
