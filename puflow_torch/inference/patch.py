"""Whole-cloud upsampling by patch decomposition.

Counterpart of `puflow_tpu.inference.patch`, with its default exact-union
merge:

  1. normalise the cloud to the unit sphere
  2. FPS seed centroids, n_patch = N / patch_size * expand_ratio
  3. k-NN patch extraction (k = patch_size)
  4. per-patch normalise -> model over all patches as one batch ->
     denormalise
  5. merge: FPS over the union of the predictions and the covered
     originals, down to npoint
  6. denormalise globally
  7. outlier removal (`remove_outliers`): drop the points farthest
     (nearest-neighbour distance) from the input cloud
"""

from __future__ import annotations

import torch

from puflow_torch.ops.chamfer import chamfer_parts
from puflow_torch.ops.fps import farthest_point_sample
from puflow_torch.ops.knn import gather_points, knn_indices


def normalize_cloud(pc: torch.Tensor):
    """Centre and scale each cloud into the unit sphere.

    pc: [B, N, 3] -> (normalised, centroid [B,1,3], furthest [B,1,1]).
    """
    centroid = torch.mean(pc, dim=1, keepdim=True)
    pc = pc - centroid
    furthest = torch.amax(
        torch.sqrt(torch.sum(pc * pc, dim=-1, keepdim=True)), dim=1,
        keepdim=True)
    return pc / furthest, centroid, furthest


def extract_patches(pc: torch.Tensor, n_patch: int, patch_size: int,
                    return_idx: bool = False):
    """FPS seeds + k-NN membership -> [B, n_patch, patch_size, 3] (and,
    with ``return_idx``, the membership indices [B, n_patch, k])."""
    seed_idx = farthest_point_sample(pc, n_patch)          # [B, n_patch]
    seeds = gather_points(pc, seed_idx)                    # [B, n_patch, 3]
    idx = knn_indices(seeds, pc, patch_size)               # [B, n_patch, k]
    patches = gather_points(pc, idx)                       # [B, n_patch, k, 3]
    return (patches, idx) if return_idx else patches


def merge_patches(points: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS-downsample the union of patch points to the target count."""
    return gather_points(points, farthest_point_sample(points, npoint))


def remove_outliers(sr: torch.Tensor, lr: torch.Tensor,
                    num_outliers: int) -> torch.Tensor:
    """Drop the `num_outliers` sr-points farthest from lr, keeping order.

    sr: [B, N, 3]; lr: [B, M, 3] -> [B, N - num_outliers, 3].
    """
    if num_outliers == 0:
        return sr
    B, N, _ = sr.shape
    d_xy, _, _, _ = chamfer_parts(sr, lr)                  # [B, N]
    _, out_idx = torch.topk(d_xy, num_outliers, dim=-1)
    drop = torch.zeros((B, N), dtype=torch.int8, device=sr.device)
    drop.scatter_(1, out_idx, 1)
    # stable sort puts the kept points first, in their original order
    order = torch.argsort(drop, dim=-1, stable=True)
    return gather_points(sr, order[:, :N - num_outliers])


def upsample_cloud(model, pc: torch.Tensor, npoint: int, upratio: int = 4,
                   patch_size: int = 256,
                   expand_ratio: float = 4.0) -> torch.Tensor:
    """Upsample whole clouds patch-wise.

    Args:
      model: callable ``(patches [M, k, 3], upratio) -> [M, k * upratio, 3]``
        (a `DiscreteModel`).
      pc: ``[B, N, 3]`` input clouds.
      npoint: output points per cloud.

    Returns:
      ``[B, npoint, 3]``.
    """
    B, N, C = pc.shape
    n_patch = int(N / patch_size * expand_ratio)

    pc_n, g_centroid, g_furthest = normalize_cloud(pc)
    patches, idx = extract_patches(pc_n, n_patch, patch_size,
                                   return_idx=True)        # [B, P, k, 3]
    flat = patches.reshape(B * n_patch, patch_size, C)

    flat_n, centroids, furthest = normalize_cloud(flat)
    pred = model(flat_n, upratio)                          # [B*P, k*r, 3]
    pred = pred * furthest + centroids
    pred = pred.reshape(B, -1, C)                          # [B, P*k*r, 3]

    # Exact-union merge: the reference FPS-selects npoint from the union of
    # the predictions and every patch's input copy. Each covered original
    # appears there once per covering patch; FPS selects by coordinates, so
    # once one copy is taken the rest sit at min-distance ~0 and are never
    # taken, and one copy of each covered original gives the same selected
    # set. Uncovered originals (in no patch, hence not in the reference's
    # union either) are replaced by a copy of an existing candidate, which
    # FPS can never re-select.
    cov = torch.zeros((B, N), dtype=torch.bool, device=pc.device)
    cov.scatter_(1, idx.reshape(B, -1), True)
    originals = torch.where(cov[..., None], pc_n, pred[:, :1, :])
    union = torch.cat([pred, originals], dim=1)            # [B, P*k*r+N, 3]
    merged = merge_patches(union.contiguous(), npoint)
    return merged * g_furthest + g_centroid
