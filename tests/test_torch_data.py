"""The port's copies of the data modules against puflow_tpu's: the same
seeds give the same arrays."""

import numpy as np
import pytest

from puflow_torch.data import augment as t_augment
from puflow_torch.data import pu1k as t_pu1k
from puflow_torch.data import synthetic as t_synthetic
from puflow_tpu.data import augment as j_augment
from puflow_tpu.data import pu1k as j_pu1k
from puflow_tpu.data import synthetic as j_synthetic
from torch_threads import one_torch_thread  # noqa: F401


def test_synthetic_epochs_match():
    got = list(t_synthetic.synthetic_epoch(3, steps=2, batch=4,
                                           num_point=32)())
    want = list(j_synthetic.synthetic_epoch(3, steps=2, batch=4,
                                            num_point=32)())
    for (sp, de), (jsp, jde) in zip(got, want, strict=True):
        np.testing.assert_array_equal(sp, jsp)
        np.testing.assert_array_equal(de, jde)


def test_augmentations_match():
    batch = np.random.RandomState(0).rand(4, 16, 3).astype(np.float32)
    gt = np.random.RandomState(1).rand(4, 64, 3).astype(np.float32)
    cases = [
        lambda m, r: m.rotate_point_cloud_and_gt(r, batch, gt),
        lambda m, r: (m.jitter_perturbation_point_cloud(r, batch),),
        lambda m, r: m.random_scale_point_cloud_and_gt(r, batch, gt),
        lambda m, r: (m.nonuniform_sampling(r, 64, 16),),
    ]
    for case in cases:
        got = case(t_augment, np.random.RandomState(5))
        want = case(j_augment, np.random.RandomState(5))
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)


def test_pu1k_loaders_match(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(0)
    path = str(tmp_path / "pu1k.h5")
    with h5py.File(path, "w") as f:
        base = rng.rand(24, 256, 3).astype(np.float32) * 2 + 1
        f["poisson_64"] = base[:, :64]
        f["poisson_256"] = base
    cfg = {"data_path": path, "batch_size": 8, "num_point_patch": 64,
           "up_ratio": 4, "seed": 7, "val_batches": 2}
    for t_iter, j_iter in zip(t_pu1k.make_loaders(cfg),
                              j_pu1k.make_loaders(cfg), strict=True):
        got, want = list(t_iter()), list(j_iter())
        assert len(got) == len(want) > 0
        for (sp, de), (jsp, jde) in zip(got, want):
            np.testing.assert_array_equal(sp, jsp)
            np.testing.assert_array_equal(de, jde)
