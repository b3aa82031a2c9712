"""Cases shared by the CNF family's tests (tests/test_torch_cnf*.py):
numpy-seeded inputs, the JAX-initialised 3-64-64-3 field at condition
width 32, and the perturbed whole model with its folded trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import fold_bn as t_fold
from puflow_tpu.models import continuous as j_cont
from puflow_tpu.models import fold_bn as j_fold

KEY = jax.random.PRNGKey(0)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _inputs(seed, b, n, cdim):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, n, cdim) * 0.5).astype(np.float32),
            (rng.randn(b, n, 3) * 0.5).astype(np.float32))


@pytest.fixture(scope="module")
def net32():
    """JAX-initialised 3-64-64-3 net at cdim 32 with moved biases and time
    rows, and inputs of `tests/test_cnf.py`'s kernel test's shape."""
    layers = jax.tree.map(np.array, j_cont.odenet_init(KEY, 3, 32))
    rng = np.random.RandomState(5)
    for p in layers:
        p["layer"]["b"] += rng.normal(0, 0.1, p["layer"]["b"].shape)
        p["hyper_gate"]["b"] += rng.normal(0, 0.1, p["hyper_gate"]["b"].shape)
        for k in ("hyper_gate", "hyper_bias"):
            p[k]["w"][0] = rng.normal(0, 8.0 if p[k]["w"].shape[1] > 3
                                      else 1.0, p[k]["w"].shape[1])
    c, y = _inputs(4, 2, 100, 32)
    return layers, _to_torch(layers), c, y


B, N, R = 2, 64, 4


@pytest.fixture(scope="module")
def case():
    params, state = j_cont.init(KEY)
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 7)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    model = t_checkpoint.from_numpy_tree(params, state, "cpu", model="cnf")
    tp, ts = model.trees()
    x = (np.random.RandomState(7).randn(B, N, 3) * 0.3).astype(np.float32)
    return dict(params=params, state=state, jp=jp, js=js, model=model,
                jf=j_fold.fold_bn_inference(jp, js),
                tf=t_fold.fold_bn_inference(tp, ts), tp=tp, ts=ts, x=x,
                xt=torch.from_numpy(x))
