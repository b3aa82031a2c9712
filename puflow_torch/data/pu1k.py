"""PU1K dataset: h5 patch pairs with shuffle + augmentation + prefetch.

Parity target: reference `dataset/pu1k/fetcher.py` + `dataset.py`.
  * h5 keys ``poisson_{n}`` (input; ``poisson_{4n}`` when random-input) and
    ``poisson_{n*ratio}`` (gt), normalised by the INPUT centroid/furthest
    distance (`fetcher.py:32-40`)
  * per-epoch shuffle, fixed-size batches, optional nonuniform resampling,
    jitter (input only) + shared rotation + shared scale (`fetcher.py:71-101`)
  * background-thread prefetch queue (`fetcher.py:53-56`) — here a daemon
    thread keeps a bounded queue of ready numpy batches so host augmentation
    overlaps device compute.

The validation iterator mirrors the reference's un-augmented fetcher with a
fixed batch budget (`dataset.py:75-76`).

The port's copy of `puflow_tpu.data.pu1k` (numpy only; `h5py` is imported
when a file is loaded).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from puflow_torch.data.augment import (
    jitter_perturbation_point_cloud,
    nonuniform_sampling,
    random_scale_point_cloud_and_gt,
    rotate_point_cloud_and_gt,
)


def load_h5_pairs(path: str, num_point: int, up_ratio: int,
                  use_random_input: bool = False):
    """Load + input-normalise the PU1K patch pairs (`fetcher.py:11-48`)."""
    import h5py

    num_out = num_point * up_ratio
    with h5py.File(path, "r") as f:
        key_in = f"poisson_{num_point * 4 if use_random_input else num_point}"
        inp = f[key_in][:].astype(np.float32)
        gt = f[f"poisson_{num_out}"][:].astype(np.float32)
    assert len(inp) == len(gt)

    centroid = np.mean(inp[:, :, :3], axis=1, keepdims=True)
    inp[:, :, :3] -= centroid
    furthest = np.amax(
        np.sqrt(np.sum(inp[:, :, :3] ** 2, axis=-1)), axis=1, keepdims=True)
    inp[:, :, :3] /= furthest[..., None]
    gt[:, :, :3] = (gt[:, :, :3] - centroid) / furthest[..., None]
    radius = np.ones(len(inp), dtype=np.float32)
    return inp, gt, radius


class PU1KDataset:
    """Epoch iterator over augmented [B, N, 3] / [B, N*r, 3] batches."""

    def __init__(self, data_path: str, batch_size: int = 32,
                 num_point: int = 256, up_ratio: int = 4,
                 use_random_input: bool = False, augment: bool = True,
                 jitter_sigma: float = 0.01, jitter_max: float = 0.03,
                 seed: int = 2021, num_batches: int | None = None,
                 prefetch: int = 16):
        self.inp, self.gt, self.radius = load_h5_pairs(
            data_path, num_point, up_ratio, use_random_input)
        self.batch_size = batch_size
        self.num_point = num_point
        self.use_random_input = use_random_input
        self.augment = augment
        self.jitter_sigma = jitter_sigma
        self.jitter_max = jitter_max
        self.rng = np.random.RandomState(seed)
        self.num_batches = num_batches or len(self.inp) // batch_size
        self.prefetch = prefetch

    def _make_batch(self, idx: np.ndarray):
        rng = self.rng
        inp = self.inp[idx].copy()
        gt = self.gt[idx].copy()
        radius = self.radius[idx].copy()
        if self.use_random_input:
            sub = np.stack([
                inp[i][nonuniform_sampling(rng, inp.shape[1],
                                           self.num_point)]
                for i in range(len(inp))])
            inp = sub
        if self.augment:
            inp = jitter_perturbation_point_cloud(
                rng, inp, sigma=self.jitter_sigma, clip=self.jitter_max)
            inp, gt = rotate_point_cloud_and_gt(rng, inp, gt)
            inp, gt, scales = random_scale_point_cloud_and_gt(
                rng, inp, gt, scale_low=0.8, scale_high=1.2)
            radius = radius * scales
        return inp[:, :, :3], gt[:, :, :3], radius

    def epoch(self):
        """Generator of (sparse, dense) batches with background prefetch."""
        order = self.rng.permutation(len(self.inp))
        q: queue.Queue = queue.Queue(self.prefetch)
        stop = object()

        def producer():
            for b in range(self.num_batches):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                if len(idx) < self.batch_size:
                    break
                inp, gt, _r = self._make_batch(idx)
                q.put((inp, gt))
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


def make_loaders(cfg) -> tuple:
    """(train_iter_fn, val_iter_fn) from a config namespace/dict."""
    train = PU1KDataset(
        cfg["data_path"], cfg.get("batch_size", 32),
        cfg.get("num_point_patch", 256), cfg.get("up_ratio", 4),
        use_random_input=cfg.get("is_random_input", False),
        augment=cfg.get("is_augment", True),
        jitter_sigma=cfg.get("jitter_sigma", 0.01),
        jitter_max=cfg.get("jitter_max", 0.03),
        seed=cfg.get("seed", 2021))
    val = PU1KDataset(
        cfg["data_path"], cfg.get("batch_size", 32),
        cfg.get("num_point_patch", 256), cfg.get("up_ratio", 4),
        use_random_input=False, augment=False,
        seed=cfg.get("seed", 2021) + 1,
        num_batches=cfg.get("val_batches", 400))
    return train.epoch, val.epoch
