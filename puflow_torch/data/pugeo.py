"""PUGeo / Sketchfab dataset: tfrecord shapes -> on-the-fly k-NN patches.

Parity target: reference `dataset/pugeo/fetcher.py` (`Fetcher`, `:195-337`),
rebuilt without tensorflow:
  * shard names encode resolutions and patch size
    (e.g. ``res_5000_res_20000_..._p256_...tfrecord``); features are
    fixed-length float lists ``<tag>_<n>`` of shape [n, 3] (`:205-225`);
  * per batch: one random seed point per shape, k-NN patch of
    ``num_in_point`` around it from the input resolution and
    ``num_in_point * ratio`` from the label resolution, both normalised by
    the LABEL patch frame (`shape_to_patch`, `:299-319`);
  * augmentation: shared rotation + scale [0.8, 1.2], optional input jitter
    (`augment_data`, `:321-337`);
  * 300 batches per epoch (`:237`).

The port's copy of `puflow_tpu.data.pugeo` (numpy only).
"""

from __future__ import annotations

import os
import re
from glob import glob

import numpy as np

from puflow_torch.data.augment import (
    jitter_perturbation_point_cloud,
    random_scale_point_cloud_and_gt,
    rotate_point_cloud_and_gt,
)
from puflow_torch.data.tfrecord import parse_example_floats, read_records


def shard_metadata(path: str):
    """Parse resolutions/tag/patch-size from a shard filename (`:205-218`)."""
    base = os.path.basename(path)
    patch = int(re.match(r".*_p(\d+)_.*", base).groups()[0])
    nums = sorted(int(x) for x in re.findall(r"_(\d+)_", base))
    tag = re.match(r"^([A-Za-z]+)_\d+", base).groups()[0]
    return tag, np.asarray(nums), patch


class PUGeoDataset:
    def __init__(self, records_glob: str, batch_size: int = 32,
                 num_in_point: int = 256, up_ratio: int = 4,
                 step_ratio: int = 4, num_shape_point: int = 5000,
                 jitter: bool = True, jitter_sigma: float = 0.01,
                 jitter_max: float = 0.03, seed: int = 2021,
                 num_batches: int = 300, augment: bool = True):
        paths = sorted(glob(records_glob))
        if not paths:
            raise FileNotFoundError(f"no tfrecord shards match {records_glob}")
        tag, nums, _patch = shard_metadata(paths[0])
        self.num_shape_point = int(nums[np.searchsorted(nums,
                                                        num_shape_point)])
        n_levels = int(np.log2(up_ratio) / np.log2(step_ratio)) + 1
        self.feature_names = [
            f"{tag}_{self.num_shape_point * step_ratio ** i}"
            for i in range(n_levels)
        ]
        self.num_in_point = num_in_point
        self.up_ratio = up_ratio
        self.jitter = jitter
        self.jitter_sigma = jitter_sigma
        self.jitter_max = jitter_max
        self.augment = augment
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.rng = np.random.RandomState(seed)

        # load every shape into memory (shapes x [n, 3]); the full Sketchfab
        # set is ~90 shapes x 20K points = tens of MB
        self.inputs, self.labels = [], []
        for p in paths:
            for payload in read_records(p):
                feats = parse_example_floats(payload)
                inp = feats[self.feature_names[0]].reshape(-1, 3)
                lab = np.concatenate(
                    [feats[n].reshape(-1, 3)
                     for n in self.feature_names[1:]], axis=0)
                self.inputs.append(inp)
                self.labels.append(lab)

    def _patch(self, idx: int):
        """Seed + k-NN patch extraction, label-frame normalisation."""
        rng = self.rng
        inp, lab = self.inputs[idx], self.labels[idx]
        seed_pt = lab[rng.randint(len(lab))]

        d_lab = ((lab - seed_pt) ** 2).sum(-1)
        lab_idx = np.argpartition(
            d_lab, self.num_in_point * self.up_ratio - 1
        )[: self.num_in_point * self.up_ratio]
        lab_patch = lab[lab_idx]

        d_in = ((inp - seed_pt) ** 2).sum(-1)
        in_idx = np.argpartition(d_in, self.num_in_point - 1
                                 )[: self.num_in_point]
        in_patch = inp[in_idx]

        centroid = lab_patch.mean(0, keepdims=True)
        lab_patch = lab_patch - centroid
        furthest = np.sqrt((lab_patch ** 2).sum(-1)).max()
        lab_patch /= furthest
        in_patch = (in_patch - centroid) / furthest
        return in_patch.astype(np.float32), lab_patch.astype(np.float32)

    def epoch(self):
        rng = self.rng
        for _ in range(self.num_batches):
            idxs = rng.randint(len(self.inputs), size=self.batch_size)
            items = [self._patch(i) for i in idxs]
            pi = np.stack([a for a, _ in items])
            pg = np.stack([g for _, g in items])
            if self.augment:
                pi, pg = rotate_point_cloud_and_gt(rng, pi, pg)
                pi, pg, _ = random_scale_point_cloud_and_gt(
                    rng, pi, pg, scale_low=0.8, scale_high=1.2)
                if self.jitter:
                    pi = jitter_perturbation_point_cloud(
                        rng, pi, sigma=self.jitter_sigma,
                        clip=self.jitter_max)
            yield pi, pg


def make_loaders(cfg):
    train = PUGeoDataset(
        cfg["records"], cfg.get("batch_size", 32),
        cfg.get("num_in_point", 256), cfg.get("up_ratio", 4),
        seed=cfg.get("seed", 2021),
        num_batches=cfg.get("num_batches", 300))
    val = PUGeoDataset(
        cfg["records"], cfg.get("batch_size", 32),
        cfg.get("num_in_point", 256), cfg.get("up_ratio", 4),
        jitter=False, augment=False, seed=2022,
        num_batches=cfg.get("val_batches", 40))
    return train.epoch, val.epoch
