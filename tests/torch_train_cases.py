"""Cases shared by the discrete training path's tests
(tests/test_torch_train*.py, split by fixture so that each file runs on its
own worker): the batch's sizes, tree comparisons at the JAX package's
tolerances, the first training step's weights with the JAX step's outputs
(`case`) and the perturbed weights (`perturbed`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.models import discrete as t_discrete
from puflow_torch.train import trainer as t_trainer
from puflow_tpu.data.synthetic import synthetic_pairs
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.ops.emd import emd_auction as j_emd_auction

B, N, R, EMD_ITERS = 4, 40, 4, 5


def _leaf_items(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        path = f"{prefix}/{key}"
        if isinstance(val, (dict, list, tuple)):
            yield from _leaf_items(val, path)
        else:
            yield path, np.asarray(val)


def _assert_trees_close(got, want, atol):
    got, want = dict(_leaf_items(got)), dict(_leaf_items(want))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol,
                                   err_msg=path)


@pytest.fixture(scope="module")
def case():
    """Numpy weights, one batch, and the JAX train step's loss, gradients,
    new BN state, prediction and assignment.

    The weights are those of a first training step: seeded init, then the
    ActNorm warm-up, the state the JAX package's own gradient test runs
    in (`tests/test_train.py`). Heavier perturbed weights make the f32
    gradient of the whole graph ill-conditioned in both frameworks: a
    rounding-level difference that moves a LeakyReLU input across 0, or
    flips the maximum of the K-slot pool, reroutes a gradient term, and
    the two packages then differ by far more than rounding although each
    computes the same function. The module tests below hold the encoder
    and flow gradients at perturbed weights, where such flips stay out.
    """
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    sparse, dense = synthetic_pairs(np.random.RandomState(3), B, N, R)
    params = j_discrete.actnorm_warmup(params, state, jnp.asarray(sparse))
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)

    def loss_fn(p, s, sp, de):
        pred, logpx, new_bn = j_discrete.forward(p, s, sp, R, train=True)
        dist, assign = j_emd_auction(pred, de, 0.005, EMD_ITERS)
        loss = logpx * 1e-4 + jnp.sum(dist) * 5e-2
        return loss, (new_bn, logpx, pred, assign)

    (loss, (new_bn, logpx, pred, assign)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        params, state, jnp.asarray(sparse), jnp.asarray(dense))
    jax_out = jax.tree.map(np.asarray, {
        "loss": loss, "grads": grads, "new_bn": new_bn, "logpx": logpx,
        "pred": pred, "assign": assign})
    return params, state, sparse, dense, jax_out


@pytest.fixture(scope="module")
def perturbed():
    """Seeded init moved far from the identity (`perturb_init`)."""
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    return t_discrete.perturb_init(jax.tree.map(np.array, params),
                                   jax.tree.map(np.array, state), 7)


def _assert_grads_close(got, want):
    """Per leaf within ``5e-4 * scale + 1e-6`` (`tests/test_train.py`)."""
    got, want = dict(_leaf_items(got)), dict(_leaf_items(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(got[path], w, atol=5e-4 * scale + 1e-6,
                                   err_msg=path)


def _torch_tree(tree, grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=grad), tree)


def _trainer(params, state, **kw):
    cfg = t_trainer.TrainConfig(emd_iters=EMD_ITERS, **kw)
    return t_trainer.Trainer(cfg, params, state, device="cpu")
