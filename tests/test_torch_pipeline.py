"""The whole slice: puflow_torch's `upsample_cloud` + `remove_outliers`
against puflow_tpu's, on the same numpy parameters and cloud.

512-point cloud on the unit sphere, patch_size 64 (32 patches), x4, 24
outliers. Gate: Chamfer distance to the JAX output below 1.5e-3, the
repo's host-robust pipeline gate (tests/test_pipeline_parity.py:177-199).
Measured on a CPU host: CD 8.6e-11, i.e. both pipelines select the same
points and differ only in float rounding.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.cli import upsample as t_cli
from puflow_torch.inference import patch as t_patch
from puflow_torch.models import discrete as t_discrete
from puflow_torch.ops.fps import farthest_point_sample
from puflow_torch.ops.knn import gather_points
from puflow_torch.utils import io as t_io
from puflow_tpu.checkpoint import save_checkpoint
from puflow_tpu.checkpoint import _discrete_sample_fn
from puflow_tpu.inference import patch as j_patch
from puflow_tpu.models import discrete as j_discrete
from torch_threads import one_torch_thread  # noqa: F401

N, PATCH, R, OUTLIERS = 512, 64, 4, 24
NPOINT = N * R + OUTLIERS


def test_upsample_cloud_matches_jax():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 3)
    rng = np.random.RandomState(0)
    pts = rng.randn(1, N, 3).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)

    cloud = jnp.asarray(pts)
    ref = j_patch.upsample_cloud(jax.tree.map(jnp.asarray, (params, state)),
                                 cloud, _discrete_sample_fn, NPOINT, R,
                                 PATCH, 4.0, None, False, 0)
    ref = np.asarray(j_patch.remove_outliers(ref, cloud, OUTLIERS))

    model = t_checkpoint.from_numpy_tree(params, state, "cpu")
    pc = torch.from_numpy(pts)
    got = t_patch.upsample_cloud(model, pc, NPOINT, R, PATCH, 4.0)
    got = t_patch.remove_outliers(got, pc, OUTLIERS).numpy()

    assert got.shape == ref.shape == (1, N * R, 3)
    assert np.isfinite(got).all()
    d = ((got[0][:, None, :] - ref[0][None, :, :]) ** 2).sum(-1)
    cd = d.min(1).mean() + d.min(0).mean()
    assert cd < 1.5e-3, f"port pipeline diverges from JAX: CD={cd}"


def test_remove_outliers_keeps_order():
    rng = np.random.RandomState(1)
    lr = rng.rand(2, 50, 3).astype(np.float32)
    sr = np.concatenate([lr + 0.001, rng.rand(2, 10, 3) + 5.0],
                        axis=1).astype(np.float32)
    perm = rng.permutation(60)
    sr = sr[:, perm]
    got = t_patch.remove_outliers(torch.from_numpy(sr), torch.from_numpy(lr),
                                  10).numpy()
    ref = np.asarray(j_patch.remove_outliers(jnp.asarray(sr),
                                             jnp.asarray(lr), 10))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, sr[:, perm < 50])


def _union_merge_as_before(model, pc, npoint, upratio, patch_size):
    """The pipeline as it was before the opt-in merges were ported: the
    exact union merge only."""
    B, N, C = pc.shape
    n_patch = int(N / patch_size * 4.0)
    pc_n, g_centroid, g_furthest = t_patch.normalize_cloud(pc)
    patches, idx = t_patch.extract_patches(pc_n, n_patch, patch_size,
                                           return_idx=True)
    flat_n, centroids, furthest = t_patch.normalize_cloud(
        patches.reshape(B * n_patch, patch_size, C))
    pred = (model(flat_n, upratio) * furthest + centroids).reshape(B, -1, C)
    cov = torch.zeros((B, N), dtype=torch.bool)
    cov.scatter_(1, idx.reshape(B, -1), True)
    originals = torch.where(cov[..., None], pc_n, pred[:, :1, :])
    union = torch.cat([pred, originals], dim=1).contiguous()
    merged = gather_points(union, farthest_point_sample(union, npoint))
    return merged * g_furthest + g_centroid


def test_default_union_merge_is_unchanged():
    """Without the new arguments, with their defaults spelled out, with
    ``merge_groups=1`` and with ``seeded_merge`` where ``npoint <= N``,
    `upsample_cloud` is the exact union merge, bit for bit."""
    params, state = t_discrete.init(torch.Generator().manual_seed(0),
                                    device="cpu")
    model = t_discrete.DiscreteModel(params, state)
    rng = np.random.RandomState(2)
    pc = torch.from_numpy(rng.randn(2, 128, 3).astype(np.float32))
    with torch.no_grad():
        ref = _union_merge_as_before(model, pc, 4 * 128, 4, 32)
        for kwargs in ({}, dict(merge_candidates=None, seeded_merge=False,
                                merge_groups=0), dict(merge_groups=1)):
            got = t_patch.upsample_cloud(model, pc, 4 * 128, 4, 32, 4.0,
                                         **kwargs)
            assert torch.equal(got, ref), kwargs
        few = _union_merge_as_before(model, pc, 100, 4, 32)
        got = t_patch.upsample_cloud(model, pc, 100, 4, 32, 4.0,
                                     seeded_merge=True)
        assert torch.equal(got, few)


def test_cli_pipeline_writes_the_same_files(tmp_path, monkeypatch):
    """The CLI's one-deep pipeline: batch i's files are written after
    batch i+1 is queued, and every file holds what upsampling that batch
    alone gives (the clouds permuted by the same seeded generator)."""
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    ckpt = str(tmp_path / "model.npz")
    save_checkpoint(ckpt, params, state)
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.RandomState(3)
    sizes = {"a": 128, "b": 128, "c": 128, "d": 64}
    for name, n in sizes.items():
        np.savetxt(src / f"{name}.xyz", rng.randn(n, 3), fmt="%.6f")

    events = []
    upsample, save = t_patch.upsample_cloud, t_io.save_xyz

    def spy_upsample(model, clouds, *args):
        events.append(("queue", clouds.shape[1]))
        return upsample(model, clouds, *args)

    def spy_save(path, pts):
        events.append(("write", Path(path).name))
        save(path, pts)

    monkeypatch.setattr(t_patch, "upsample_cloud", spy_upsample)
    monkeypatch.setattr(t_io, "save_xyz", spy_save)
    t_cli.main(["--source", str(src), "--target", str(tmp_path / "out"),
                "--checkpoint", ckpt, "--num_patch", "32", "--batch", "2",
                "--device", "cpu"])
    # sizes 64 (d), then 128 (a, b | c padded): three batches
    assert events == [("queue", 64), ("queue", 128), ("write", "d.xyz"),
                      ("queue", 128), ("write", "a.xyz"), ("write", "b.xyz"),
                      ("write", "c.xyz")]

    model = t_checkpoint.load_checkpoint(ckpt, "cpu", fold=True)
    perm = np.random.RandomState(2021)
    batches = [["d"], ["a", "b"], ["c"]]
    for names in batches:
        n = sizes[names[0]]
        clouds = np.stack([t_io.load_xyz(str(src / f"{k}.xyz"))[
            perm.permutation(n)] for k in names])
        if len(names) < 2:        # the CLI pads a short batch with its last
            clouds = np.concatenate([clouds, clouds[-1:]])
        pc = torch.from_numpy(clouds.astype(np.float32))
        with torch.no_grad():
            pred = t_patch.remove_outliers(
                upsample(model, pc, n * R + OUTLIERS, R, 32, 4.0), pc,
                OUTLIERS).numpy()
        for k, out in zip(names, pred):
            ref = tmp_path / f"ref_{k}.xyz"
            save(ref, out)
            assert (tmp_path / "out" / f"{k}.xyz").read_text() == \
                ref.read_text(), k

