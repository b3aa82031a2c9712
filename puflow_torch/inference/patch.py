"""Whole-cloud upsampling by patch decomposition.

Counterpart of `puflow_tpu.inference.patch`:

  1. normalise the cloud to the unit sphere
  2. FPS seed centroids, n_patch = N / patch_size * expand_ratio
  3. k-NN patch extraction (k = patch_size)
  4. per-patch normalise -> model over all patches as one batch ->
     denormalise
  5. merge: by default FPS over the union of the predictions and the
     covered originals, down to npoint; opt-in, as in `puflow_tpu`, the
     seeded merge (every original emitted, seeded FPS over the
     predictions, in Morton cells), the grouped union merge (Morton cells
     of the union) or the voxel pre-reduced union merge
  6. denormalise globally
  7. outlier removal (`remove_outliers`): drop the points farthest
     (nearest-neighbour distance) from the input cloud
"""

from __future__ import annotations

import torch

from puflow_torch.ops.chamfer import chamfer_parts
from puflow_torch.ops.fps import (farthest_point_sample,
                                  farthest_point_sample_morton,
                                  farthest_point_sample_seeded_morton)
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


def _voxel_candidates(pts: torch.Tensor, n_cand: int, grid: int,
                      hash_size: int) -> torch.Tensor:
    """First-in-voxel candidate indices, ``[B, M, 3] -> [B, n_cand]``.

    Voxel ids hash into a table of ``hash_size`` slots that keeps the
    lowest point index per slot (collisions merge voxels, dropping a few
    more candidates); slots beyond the occupied count stay point 0. The
    hash is `puflow_tpu`'s 32-bit multiplicative one: the product wraps at
    2^32 before the modulo.
    """
    B, M, _ = pts.shape
    q = torch.clamp(((pts + 1.5) * (grid / 3.0)).to(torch.int64), 0,
                    grid - 1)
    vid = (q[..., 0] * grid + q[..., 1]) * grid + q[..., 2]
    h = ((vid * 2654435761) & 0xFFFFFFFF) % hash_size        # [B, M]
    arange = torch.arange(M, device=pts.device).expand(B, M)
    table = torch.full((B, hash_size), M, dtype=torch.int64,
                       device=pts.device)
    table.scatter_reduce_(1, h, arange, "amin", include_self=True)
    first = torch.gather(table, 1, h) == arange               # [B, M]
    pos = torch.cumsum(first, dim=1) - 1
    # targets past n_cand go to a spare column that is cut off (JAX's
    # scatter mode="drop")
    tgt = torch.where(first & (pos < n_cand), pos, n_cand)
    out = torch.zeros((B, n_cand + 1), dtype=torch.int64, device=pts.device)
    out.scatter_(1, tgt, arange)
    return out[:, :n_cand].to(torch.int32)


def merge_patches_approx(points: torch.Tensor, npoint: int, n_cand: int,
                         grid: int = 256) -> torch.Tensor:
    """Merge with voxel pre-reduction: one original point per occupied
    voxel of a ``grid``^3 lattice over [-1.5, 1.5]^3, ``n_cand`` of them,
    then exact FPS down to ``npoint`` over those candidates."""
    cand_idx = _voxel_candidates(points, n_cand, grid, 4 * points.shape[1])
    cand = gather_points(points, cand_idx)
    return gather_points(cand, farthest_point_sample(cand, npoint))


def jitter_cloud(generator: torch.Generator, pc: torch.Tensor,
                 sigma: float = 0.010, clip: float = 0.020) -> torch.Tensor:
    """Clipped gaussian perturbation of ``pc``; the generator must live on
    ``pc``'s device."""
    noise = torch.randn(pc.shape, generator=generator, device=pc.device,
                        dtype=pc.dtype)
    return pc + torch.clamp(sigma * noise, -clip, clip)


def auto_merge_groups(n_candidates: int) -> int:
    """Merge-FPS group count for an n-candidate union: exact below 16384
    candidates, else Morton cells of >= 2048 candidates up to G=16,
    snapped down to a divisor of the candidate count.

    >>> auto_merge_groups(8192), auto_merge_groups(32768)
    (1, 16)
    """
    if n_candidates < 16384:
        return 1
    g = min(16, n_candidates // 2048)
    while g > 1 and n_candidates % g:
        g -= 1
    return g


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
                   patch_size: int = 256, expand_ratio: float = 4.0,
                   merge_candidates=None, seeded_merge: bool = False,
                   merge_groups: int = 0, group=None) -> torch.Tensor:
    """Upsample whole clouds patch-wise.

    Args:
      model: callable ``(patches [M, k, 3], upratio) -> [M, k * upratio, 3]``
        (a `DiscreteModel` or `ContinuousModel`).
      pc: ``[B, N, 3]`` input clouds.
      npoint: output points per cloud.
      merge_candidates: voxel pre-reduce the union to this many candidates
        before its FPS (`merge_patches_approx`).
      seeded_merge: emit every original and seeded-FPS the remaining
        ``npoint - N`` from the predictions, in ``merge_groups`` Morton
        cells (0: `auto_merge_groups`, 1: exact). Ignored when
        ``npoint <= N``.
      merge_groups: without ``seeded_merge``, values above 1 run the
        union's FPS in that many Morton cells.
      group: a `parallel.Group` passed on to the model call, where ``pc``
        is this rank's shard of the clouds (`upsample_cloud_sharded`).

    The default (all three off) is the exact union merge.

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
    pred = (model(flat_n, upratio) if group is None
            else model(flat_n, upratio, group=group))      # [B*P, k*r, 3]
    pred = pred * furthest + centroids
    pred = pred.reshape(B, -1, C)                          # [B, P*k*r, 3]

    if seeded_merge and npoint > N:
        G = (merge_groups if merge_groups > 0
             else auto_merge_groups(pred.shape[1]))
        sel = farthest_point_sample_seeded_morton(pred, pc_n, npoint - N, G)
        merged = torch.cat([pc_n, gather_points(pred, sel)], dim=1)
        return merged * g_furthest + g_centroid

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
    if merge_candidates:
        merged = merge_patches_approx(union, npoint, merge_candidates)
    elif merge_groups > 1:
        sel = farthest_point_sample_morton(union, npoint, merge_groups)
        merged = gather_points(union, sel)
    else:
        merged = merge_patches(union.contiguous(), npoint)
    return merged * g_furthest + g_centroid


def upsample_cloud_sharded(model, pc: torch.Tensor, npoint: int,
                           upratio: int = 4, patch_size: int = 256,
                           expand_ratio: float = 4.0,
                           group=None) -> torch.Tensor:
    """Whole-cloud upsampling with the clouds sharded over the ranks of a
    `parallel.Group` (default: `parallel.default_group`, the running group
    or one started from torchrun's environment on ``cuda:LOCAL_RANK``).

    Counterpart of `puflow_tpu.inference.patch.upsample_cloud_sharded`:
    each rank runs `upsample_cloud` (the exact union merge) on its ``B /
    W`` clouds, and every rank gets the whole ``[B, npoint, 3]`` in the
    clouds' order (`parallel.gather_batch`). ``pc`` is the global batch,
    the same on every rank; ``model`` a `DiscreteModel` or
    `ContinuousModel` on the group's device, either BN configuration.

    The discrete family's compute has no collective. A CNF solve's dopri5
    step size is the whole batch's, as under JAX's sharded jit: each of
    the 12 block-solves of a sample exchanges every rank's error sum once
    an attempt (`ops.cnf`'s per-attempt kernel on the card, `models.ode`'s
    plain solver loop elsewhere), so every rank takes the one-process run's
    steps. That costs a collective of two doubles and a host read of the
    solve's finished flag an attempt, some 60 a sample at 4-6 attempts a
    solve: about 0.3 ms of host time each with NCCL, milliseconds each
    with `gloo` on CUDA tensors (measured beside an H100, `PERF.md`).
    """
    from puflow_torch import parallel

    if group is None:
        group = parallel.default_group()
    local = parallel.shard_batch(pc, group).to(group.device)
    out = upsample_cloud(model, local, npoint, upratio, patch_size,
                         expand_ratio, group=group)
    return parallel.gather_batch(out, group)
