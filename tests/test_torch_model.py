"""puflow_torch's discrete model against puflow_tpu's, on the same numpy
parameters (JAX seeded init plus seeded perturbation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import encoder as t_encoder
from puflow_torch.ops.knn import knn_indices as t_knn
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models import encoder as j_encoder
from puflow_tpu.ops.knn import knn_indices
from torch_threads import one_torch_thread  # noqa: F401

B, N, R = 2, 64, 4
ATOL = 1e-4   # elementwise on whole-model outputs, both sides f32


@pytest.fixture(scope="module")
def models():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 2)
    return (jax.tree.map(jnp.asarray, (params, state)),
            t_checkpoint.from_numpy_tree(params, state, "cpu"))


def _cloud(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, 3) * 0.3).astype(np.float32)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


def test_init_tree_matches_jax():
    jp, js = j_discrete.init(jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tp, ts = t_discrete.init(gen, device="cpu")
    assert _shapes((tp, ts)) == _shapes((jp, js))
    model = t_discrete.DiscreteModel(tp, ts)
    assert sum(p.numel() for p in model.parameters()) == 806_103
    # the zero-initialised identity pieces match the JAX init exactly
    for tb, jb in zip(tp["flow_blocks"], jp["flow_blocks"]):
        np.testing.assert_array_equal(tb["actnorm"]["logs"].numpy(),
                                      np.asarray(jb["actnorm"]["logs"]))
        w = tb["inv1x1"]["W"].numpy()
        np.testing.assert_allclose(w @ w.T, np.eye(3), atol=1e-5)


def test_sample_on_same_graph_matches_jax(models):
    """Whole `discrete.sample`, both sides fed the same K=16 graph."""
    (jp, js), model = models
    tp, ts = model.trees()
    x = _cloud(3)
    idx = knn_indices(jnp.asarray(x), jnp.asarray(x), 16)
    cs, _ = j_discrete.feat_extract(jp, js, jnp.asarray(x), idx, train=False)
    z, _ = j_discrete.f_transform(jp, jnp.asarray(x), cs)
    fz, _ = j_encoder.interpolation_apply(jp["interp"], js["interp"], z,
                                          jnp.asarray(x), R, False,
                                          knn_idx=idx)
    ref = np.asarray(j_discrete.g_transform(jp, fz, cs, R))

    xt = torch.from_numpy(x)
    idx_t = torch.tensor(np.asarray(idx)).long()
    cs_t, _ = t_discrete.feat_extract(tp, ts, xt, idx_t)
    for c_t, c_j in zip(cs_t, cs):
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    z_t, ld_t = t_discrete.f_transform(tp, xt, cs_t)
    # log-dets are sums of N * C terms of magnitude ~50: relative 2e-5
    np.testing.assert_allclose(
        ld_t.numpy(), np.asarray(j_discrete.f_transform(jp, jnp.asarray(x),
                                                        cs)[1]), atol=1e-3)
    fz_t, _ = t_encoder.interpolation_apply(tp["interp"], ts["interp"], z_t,
                                            xt, R, knn_idx=idx_t)
    got = t_discrete.g_transform(tp, fz_t, cs_t, R).numpy()
    assert got.shape == (B, N * R, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_model_call_matches_jax_sample(models):
    """`DiscreteModel(x, r)` (the entry `upsample_cloud` calls) against
    `puflow_tpu.models.discrete.sample`, each with its own k-NN."""
    (jp, js), model = models
    x = _cloud(4)
    j_idx = np.sort(np.asarray(knn_indices(jnp.asarray(x), jnp.asarray(x),
                                           16)), axis=-1)
    t_idx = np.sort(t_knn(torch.from_numpy(x), torch.from_numpy(x),
                          16).numpy(), axis=-1)
    np.testing.assert_array_equal(t_idx, j_idx)   # same graphs, no ties
    ref = np.asarray(j_discrete.sample(jp, js, jnp.asarray(x), R))
    got = model(torch.from_numpy(x), R).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_f_g_roundtrip(models):
    """g inverts f at upratio 1 with the identity interpolation."""
    _, model = models
    tp, ts = model.trees()
    x = torch.from_numpy(_cloud(5))
    idx = t_knn(x, x, 16)
    cs, _ = t_discrete.feat_extract(tp, ts, x, idx)
    z, _ = t_discrete.f_transform(tp, x, cs)
    back = t_discrete.g_transform(tp, z[..., None], cs, 1)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-4)
