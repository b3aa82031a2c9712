"""The port's copies of the PU-GAN, tfrecord and PUGeo data modules against
puflow_tpu's: the same files and seeds give the same bytes and arrays."""

import numpy as np
import pytest

from puflow_torch.data import pugan as t_pugan
from puflow_torch.data import pugeo as t_pugeo
from puflow_torch.data import tfrecord as t_tfrecord
from puflow_tpu.data import pugan as j_pugan
from puflow_tpu.data import pugeo as j_pugeo
from puflow_tpu.data import tfrecord as j_tfrecord
from torch_threads import one_torch_thread  # noqa: F401


def _assert_loaders_equal(got_loaders, want_loaders):
    for t_iter, j_iter in zip(got_loaders, want_loaders, strict=True):
        got, want = list(t_iter()), list(j_iter())
        assert len(got) == len(want) > 0
        for (sp, de), (jsp, jde) in zip(got, want):
            assert sp.dtype == jsp.dtype and de.dtype == jde.dtype
            np.testing.assert_array_equal(sp, jsp)
            np.testing.assert_array_equal(de, jde)


@pytest.mark.parametrize("non_uniform", [False, True])
def test_pugan_loaders_match(tmp_path, non_uniform):
    """GT-frame normalisation, jitter, scale and the always-on z rotation:
    equal batches for train and validation, with and without the
    non-uniform input subset."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(0)
    path = str(tmp_path / "pugan.h5")
    with h5py.File(path, "w") as f:
        base = rng.rand(24, 256, 3).astype(np.float32) * 2 + 1
        f["poisson_64"] = base[:, :64]
        f["poisson_256"] = base      # the 4x input and the gt
    cfg = {"data_path": path, "batch_size": 8, "patch_num_point": 64,
           "up_ratio": 4, "seed": 7, "val_batches": 2,
           "use_non_uniform": non_uniform}
    _assert_loaders_equal(t_pugan.make_loaders(cfg),
                          j_pugan.make_loaders(cfg))


def test_tfrecord_bytes_match():
    """crc32c, the record framing and `build_example_floats` write the bytes
    the JAX package's codec writes, and the parse round-trips."""
    rng = np.random.RandomState(1)
    feats = {"res_100": rng.rand(300).astype(np.float32),
             "res_400": rng.rand(1200).astype(np.float32)}
    payload = t_tfrecord.build_example_floats(feats)
    assert payload == j_tfrecord.build_example_floats(feats)
    for data in (b"", b"123456789", payload):
        assert t_tfrecord.crc32c(data) == j_tfrecord.crc32c(data)
    # the Castagnoli check value
    assert t_tfrecord.crc32c(b"123456789") == 0xE3069283
    parsed = t_tfrecord.parse_example_floats(payload)
    assert parsed.keys() == feats.keys()
    for k, v in feats.items():
        np.testing.assert_array_equal(parsed[k], v)


def test_tfrecord_files_match(tmp_path):
    payloads = [t_tfrecord.build_example_floats(
        {"res_8": np.arange(24, dtype=np.float32) * k}) for k in range(3)]
    got, want = str(tmp_path / "t.tfrecord"), str(tmp_path / "j.tfrecord")
    t_tfrecord.write_records(got, payloads)
    j_tfrecord.write_records(want, payloads)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert list(t_tfrecord.read_records(got)) == payloads
    assert list(j_tfrecord.read_records(got)) == payloads


def _pugeo_shards(tmp_path, n_shapes=4, res=500):
    """The shards of `tests/test_data.py::TestPugeo` at input resolution
    ``res`` (labels 4 x ``res``)."""
    rng = np.random.RandomState(2)
    payloads = []
    for _ in range(n_shapes):
        lo = rng.rand(res, 3).astype(np.float32)
        hi = np.repeat(lo, 4, axis=0) + 0.01 * rng.randn(4 * res, 3).astype(
            np.float32)
        payloads.append(t_tfrecord.build_example_floats({
            f"res_{res}": lo.ravel(), f"res_{4 * res}": hi.ravel()}))
    path = str(tmp_path / f"res_{res}_res_{4 * res}_p64_shard.tfrecord")
    t_tfrecord.write_records(path, payloads)
    return path


def test_pugeo_shard_metadata_matches(tmp_path):
    path = _pugeo_shards(tmp_path)
    tag, nums, patch = t_pugeo.shard_metadata(path)
    j_tag, j_nums, j_patch = j_pugeo.shard_metadata(path)
    assert (tag, patch) == (j_tag, j_patch) == ("res", 64)
    np.testing.assert_array_equal(nums, j_nums)


@pytest.mark.parametrize("augment", [True, False])
def test_pugeo_datasets_match(tmp_path, augment):
    """k-NN patches in the label frame, with and without rotation, scale
    and jitter, on `TestPugeo`'s shards: equal batches."""
    path = _pugeo_shards(tmp_path)
    kw = dict(batch_size=4, num_in_point=64, up_ratio=4,
              num_shape_point=500, num_batches=3, augment=augment, seed=7)
    got = list(t_pugeo.PUGeoDataset(path, **kw).epoch())
    want = list(j_pugeo.PUGeoDataset(path, **kw).epoch())
    _assert_loaders_equal([lambda: got], [lambda: want])
    sp, de = got[0]
    assert sp.shape == (4, 64, 3) and de.shape == (4, 256, 3)


def test_pugeo_loaders_match(tmp_path):
    """`make_loaders` at the default resolutions (5,000 input points, 20,000
    labels a shape): equal train and validation batches."""
    path = _pugeo_shards(tmp_path, n_shapes=2, res=5000)
    cfg = {"records": path, "batch_size": 4, "num_in_point": 64,
           "up_ratio": 4, "seed": 7, "num_batches": 3, "val_batches": 2}
    _assert_loaders_equal(t_pugeo.make_loaders(cfg),
                          j_pugeo.make_loaders(cfg))
