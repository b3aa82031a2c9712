"""The whole slice: puflow_torch's `upsample_cloud` + `remove_outliers`
against puflow_tpu's, on the same numpy parameters and cloud.

512-point cloud on the unit sphere, patch_size 64 (32 patches), x4, 24
outliers. Gate: Chamfer distance to the JAX output below 1.5e-3, the
repo's host-robust pipeline gate (tests/test_pipeline_parity.py:177-199).
Measured on a CPU host: CD 8.6e-11, i.e. both pipelines select the same
points and differ only in float rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.inference import patch as t_patch
from puflow_torch.models import discrete as t_discrete
from puflow_tpu.checkpoint import _discrete_sample_fn
from puflow_tpu.inference import patch as j_patch
from puflow_tpu.models import discrete as j_discrete

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
