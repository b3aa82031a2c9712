"""Point-cloud augmentations, numpy host-side, single implementation.

The reference carries two near-identical copies
(`dataset/pu1k/point_operation.py`, `dataset/pugan/point_operation.py`);
this is the unified one. Semantics match:
  * `nonuniform_sampling` `:5-13` — gaussian-biased index sampling
  * `rotate_point_cloud_and_gt` `:28-70` — random SO(3) (Rz·Ry·Rx), applied
    to input and gt identically
  * `jitter_perturbation_point_cloud` `:73-84` — clipped gaussian jitter,
    channels >= 3 untouched
  * `random_scale_point_cloud_and_gt` `:106-121` — shared per-cloud scale,
    returned so the radius can be rescaled

All functions take an explicit `np.random.RandomState` (the reference used
the global seed); none mutate their inputs.

The port's copy of `puflow_tpu.data.augment` (numpy only).
"""

from __future__ import annotations

import numpy as np


def nonuniform_sampling(rng: np.random.RandomState, num: int,
                        sample_num: int) -> np.ndarray:
    """Gaussian-biased subset of indices (simulates nonuniform scans)."""
    sample = set()
    loc = rng.rand() * 0.8 + 0.1
    while len(sample) < sample_num:
        a = int(rng.normal(loc=loc, scale=0.3) * num)
        if 0 <= a < num:
            sample.add(a)
    return np.asarray(list(sample), dtype=np.int64)


def rotate_point_cloud_and_gt(rng: np.random.RandomState,
                              batch: np.ndarray,
                              gt: np.ndarray | None = None,
                              z_rotated: bool = False):
    """Random per-cloud rotation R = Rz @ Ry @ Rx applied as x @ R."""
    B = batch.shape[0]
    ang = rng.uniform(size=(B, 3)).astype(np.float32) * 2 * np.pi
    cx, cy, cz = np.cos(ang[:, 0]), np.cos(ang[:, 1]), np.cos(ang[:, 2])
    sx, sy, sz = np.sin(ang[:, 0]), np.sin(ang[:, 1]), np.sin(ang[:, 2])
    one, zero = np.ones(B, np.float32), np.zeros(B, np.float32)

    Rz = np.stack([np.stack([cz, -sz, zero], 1),
                   np.stack([sz, cz, zero], 1),
                   np.stack([zero, zero, one], 1)], axis=1)
    if z_rotated:
        R = Rz
    else:
        Rx = np.stack([np.stack([one, zero, zero], 1),
                       np.stack([zero, cx, -sx], 1),
                       np.stack([zero, sx, cx], 1)], axis=1)
        Ry = np.stack([np.stack([cy, zero, sy], 1),
                       np.stack([zero, one, zero], 1),
                       np.stack([-sy, zero, cy], 1)], axis=1)
        R = np.einsum("imj,ijk,ikl->iml", Rz, Ry, Rx)

    batch = batch.copy()
    batch[..., :3] = np.einsum("ijk,ikl->ijl", batch[..., :3], R)
    if gt is not None:
        gt = gt.copy()
        gt[..., :3] = np.einsum("ijk,ikl->ijl", gt[..., :3], R)
    return batch, gt


def jitter_perturbation_point_cloud(rng: np.random.RandomState,
                                    batch: np.ndarray, sigma: float = 0.005,
                                    clip: float = 0.02) -> np.ndarray:
    assert clip > 0
    noise = np.clip(sigma * rng.randn(*batch.shape).astype(np.float32),
                    -clip, clip)
    noise[..., 3:] = 0
    return batch + noise


def random_scale_point_cloud_and_gt(rng: np.random.RandomState,
                                    batch: np.ndarray,
                                    gt: np.ndarray | None = None,
                                    scale_low: float = 0.5,
                                    scale_high: float = 2.0):
    B = batch.shape[0]
    scales = rng.uniform(scale_low, scale_high, (B, 1, 1)).astype(np.float32)
    batch = batch.copy()
    batch[..., :3] *= scales
    if gt is not None:
        gt = gt.copy()
        gt[..., :3] *= scales
    return batch, gt, np.squeeze(scales)
