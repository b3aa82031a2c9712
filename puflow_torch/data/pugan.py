"""PU-GAN dataset: map-style h5 patch pairs, normalised by the GT frame.

Parity target: reference `dataset/pugan/dataset2.py` (`PUGANdatasetDataset`):
  * h5 keys ``poisson_{patch}`` / ``poisson_{patch*4}`` (non-uniform input)
    and ``poisson_{patch*ratio}`` gt;
  * normalisation by the **GT** centroid/furthest distance (`:47-55`) —
    note the difference from PU1K's input-frame normalisation;
  * per item: optional random subset (non-uniform input, `:66-68`), jitter
    (input only) + shared scale [0.8, 1.2] when augmenting, and a shared
    z-axis rotation ALWAYS (also for validation, `:73,86,111`).

The port's copy of `puflow_tpu.data.pugan` (numpy only; `h5py` is imported
when a file is loaded).
"""

from __future__ import annotations

import numpy as np


def load_h5_gt_normalised(path: str, patch_size: int, up_ratio: int,
                          use_non_uniform: bool):
    import h5py

    with h5py.File(path, "r") as f:
        key_in = (f"poisson_{patch_size * 4}" if use_non_uniform
                  else f"poisson_{patch_size}")
        inp = f[key_in][:].astype(np.float32)
        gt = f[f"poisson_{patch_size * up_ratio}"][:].astype(np.float32)
    assert len(inp) == len(gt)

    centroid = np.mean(gt[:, :, :3], axis=1, keepdims=True)
    gt[:, :, :3] -= centroid
    furthest = np.amax(np.sqrt(np.sum(gt[:, :, :3] ** 2, axis=-1)), axis=1,
                       keepdims=True)
    gt[:, :, :3] /= furthest[..., None]
    inp[:, :, :3] = (inp[:, :, :3] - centroid) / furthest[..., None]
    radius = np.ones(len(inp), dtype=np.float32)
    return inp, gt, radius


def _rotate_z(rng, pi, pg):
    a = rng.uniform(size=3) * 2 * np.pi
    c, s = np.cos(a[2]), np.sin(a[2])
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
    return pi @ R, pg @ R


class PUGANDataset:
    """Epoch iterator yielding augmented (sparse, dense) batches."""

    def __init__(self, data_path: str, batch_size: int = 32,
                 patch_num_point: int = 256, up_ratio: int = 4,
                 use_non_uniform: bool = False, augment: bool = True,
                 jitter_sigma: float = 0.01, jitter_max: float = 0.03,
                 seed: int = 2021, num_batches: int | None = None):
        self.inp, self.gt, self.radius = load_h5_gt_normalised(
            data_path, patch_num_point, up_ratio, use_non_uniform)
        self.batch_size = batch_size
        self.patch_num_point = patch_num_point
        self.use_non_uniform = use_non_uniform
        self.augment = augment
        self.jitter_sigma = jitter_sigma
        self.jitter_max = jitter_max
        self.rng = np.random.RandomState(seed)
        self.num_batches = num_batches or len(self.inp) // batch_size

    def _item(self, i):
        rng = self.rng
        pi, pg = self.inp[i].copy(), self.gt[i].copy()
        if self.use_non_uniform:
            sel = rng.permutation(pi.shape[0])[: self.patch_num_point]
            pi = pi[sel]
        if self.augment:
            noise = np.clip(
                self.jitter_sigma * rng.randn(*pi.shape),
                -self.jitter_max, self.jitter_max).astype(np.float32)
            pi = pi + noise
            scale = rng.uniform(0.8, 1.2)
            pi, pg = pi * scale, pg * scale
        pi, pg = _rotate_z(rng, pi, pg)  # always, reference `:73`
        return pi[:, :3], pg[:, :3]

    def epoch(self):
        order = self.rng.permutation(len(self.inp))
        for b in range(self.num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idx) < self.batch_size:
                break
            items = [self._item(i) for i in idx]
            yield (np.stack([a for a, _ in items]),
                   np.stack([g for _, g in items]))


def make_loaders(cfg):
    train = PUGANDataset(
        cfg["data_path"], cfg.get("batch_size", 32),
        cfg.get("patch_num_point", 256), cfg.get("up_ratio", 4),
        use_non_uniform=cfg.get("use_non_uniform", False),
        augment=True, jitter_sigma=cfg.get("jitter_sigma", 0.01),
        jitter_max=cfg.get("jitter_max", 0.03),
        seed=cfg.get("seed", 2021))
    val = PUGANDataset(
        cfg["data_path"], cfg.get("batch_size", 32),
        cfg.get("patch_num_point", 256), cfg.get("up_ratio", 4),
        use_non_uniform=False, augment=False, seed=2022,
        num_batches=cfg.get("val_batches", 100))
    return train.epoch, val.epoch
