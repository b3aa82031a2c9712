"""The discrete model's encoder and flow gradients against puflow_tpu's at
perturbed weights (`perturbed`), on the CPU, per leaf within the JAX
package's ``5e-4 * scale + 1e-6`` (`tests/test_train.py`). Shared cases:
tests/torch_train_cases.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from puflow_torch.models import discrete as t_discrete
from puflow_torch.models import encoder as t_encoder
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models import encoder as j_encoder
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import (B, N, R, _assert_grads_close,  # noqa: F401
                               _torch_tree, perturbed)


def test_encoder_block_gradients_match_jax(perturbed):
    """One train-mode EdgeConv block and its merge MLP at perturbed
    weights: gradients of a fixed projection of the condition (a mean, so
    the analytically zero gradients of the biases before train-mode BN
    stay at rounding noise)."""
    params, state = perturbed
    rng = np.random.RandomState(5)
    x = (rng.randn(B, N, 32) * 0.5).astype(np.float32)
    idx = rng.randint(0, N, (B, N, 16))
    fp, fs, mp = (params["feat_convs"][1], state["feat_convs"][1],
                  params["merge_convs"][1])
    proj = rng.randn(B, N, mp["conv2"]["w"].shape[1]).astype(np.float32)

    def j_loss(p):
        f, _ = j_encoder.feature_extract_apply(
            p["f"], fs, jnp.asarray(x), jnp.asarray(idx), True)
        return jnp.mean(j_encoder.feat_merge_apply(p["m"], f) * proj)

    want = jax.grad(j_loss)({"f": fp, "m": mp})
    tp = _torch_tree({"f": fp, "m": mp}, grad=True)
    f, _ = t_encoder.feature_extract_apply(
        tp["f"], _torch_tree(fs), torch.from_numpy(x),
        torch.from_numpy(idx), train=True)
    torch.mean(t_encoder.feat_merge_apply(tp["m"], f)
               * torch.from_numpy(proj)).backward()
    _assert_grads_close(jax.tree.map(lambda t: t.grad.numpy(), tp), want)


def test_flow_gradients_match_jax(perturbed):
    """f with its log-density and the inverse flow g at perturbed
    weights, on fixed conditions: gradients of NLL + a projection of g."""
    params, _ = perturbed
    rng = np.random.RandomState(6)
    x = (rng.randn(B, N, 3) * 0.5).astype(np.float32)
    fz = (rng.randn(B, N, 3, R) * 0.5).astype(np.float32)
    cs = [(rng.randn(B, N, c) * 0.3).astype(np.float32)
          for c in t_discrete.COND_CHANNELS]
    proj = rng.randn(B, N * R, 3).astype(np.float32)
    blocks = {"flow_blocks": params["flow_blocks"]}

    def j_loss(p):
        j_cs = [jnp.asarray(c) for c in cs]
        _, nll = j_discrete.log_prob(p, jnp.asarray(x), j_cs)
        out = j_discrete.g_transform(p, jnp.asarray(fz), j_cs, R)
        return nll * 1e-2 + jnp.sum(out * proj)

    want = jax.grad(j_loss)(blocks)
    tp = _torch_tree(blocks, grad=True)
    t_cs = [torch.from_numpy(c) for c in cs]
    _, nll = t_discrete.log_prob(tp, torch.from_numpy(x), t_cs)
    out = t_discrete.g_transform(tp, torch.from_numpy(fz), t_cs, R)
    (nll * 1e-2 + torch.sum(out * torch.from_numpy(proj))).backward()
    _assert_grads_close(jax.tree.map(lambda t: t.grad.numpy(), tp), want)
