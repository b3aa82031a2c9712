"""Synthetic patch-pair generator for tests, benches, and smoke training.

No dataset files ship with the reference repo (only a download manifest,
`data/filelist.txt`), so the framework carries a parametric-surface sampler
that produces (sparse, dense) patch pairs with the same contract as the PU1K
fetcher: dense is a superset-quality resampling of the same local surface,
both normalised to the unit sphere by the sparse cloud's frame.

The port's copy of `puflow_tpu.data.synthetic` (numpy only).
"""

from __future__ import annotations

import numpy as np


def _surface_points(rng: np.random.RandomState, n: int, kind: int):
    """Sample n points from a random smooth parametric surface patch."""
    u, v = rng.rand(n), rng.rand(n)
    if kind == 0:        # bumpy plane z = a sin + b cos
        a, b = rng.randn(2) * 0.3
        pts = np.stack([u, v, a * np.sin(3 * u) + b * np.cos(3 * v)], axis=1)
    elif kind == 1:      # sphere cap
        theta = u * np.pi * 0.6
        phi = v * 2 * np.pi
        pts = np.stack([np.sin(theta) * np.cos(phi),
                        np.sin(theta) * np.sin(phi),
                        np.cos(theta)], axis=1)
    else:                # cylinder segment
        phi = u * np.pi
        pts = np.stack([np.cos(phi), np.sin(phi), v * 2 - 1], axis=1)
    return pts.astype(np.float32)


def synthetic_pairs(rng: np.random.RandomState, batch: int, num_point: int,
                    up_ratio: int):
    """(sparse [B, n, 3], dense [B, n*r, 3]) from shared surfaces."""
    sparse, dense = [], []
    for _ in range(batch):
        kind = rng.randint(3)
        seed = rng.randint(1 << 31)
        r1 = np.random.RandomState(seed)
        all_pts = _surface_points(r1, num_point * (up_ratio + 1), kind)
        idx = np.arange(len(all_pts))
        r1.shuffle(idx)
        s = all_pts[idx[:num_point]]
        d = all_pts[idx[num_point:num_point * (up_ratio + 1)]]
        # normalise by the sparse frame (PU1K convention)
        c = s.mean(0, keepdims=True)
        f = np.linalg.norm(s - c, axis=1).max()
        sparse.append((s - c) / f)
        dense.append((d - c) / f)
    return np.stack(sparse), np.stack(dense)


def synthetic_epoch(seed: int, steps: int, batch: int, num_point: int = 256,
                    up_ratio: int = 4):
    """Generator factory matching the PU1KDataset.epoch contract."""
    def gen():
        rng = np.random.RandomState(seed)
        for _ in range(steps):
            yield synthetic_pairs(rng, batch, num_point, up_ratio)
    return gen
