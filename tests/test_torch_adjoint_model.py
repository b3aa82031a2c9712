"""The port's `continuous.forward(train=True)` against puflow_tpu on the CPU.

The whole model's training forward and its gradients, at the size of
`tests/test_torch_cnf.py:test_forward_eval_matches_jax`, against
`jax.value_and_grad` of the same loss on the same numpy-seeded inputs.
Kept apart from `tests/test_torch_adjoint.py`: the JAX side compiles for
about 75 s, and the test runner spreads files over its workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from puflow_torch.models import continuous as t_cont
from puflow_tpu.models import continuous as j_cont
from torch_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)


def _to_torch(tree, grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)).requires_grad_(grad), tree)


def _maxrel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-8))


def _rounding_zero(names, grads) -> set:
    """The bias leaves whose largest gradient entry is below
    ``ROUNDING_ZERO`` times that of the same layer's weight."""
    peak = {n: float(np.abs(np.asarray(g)).max())
            for n, g in zip(names, grads)}
    return {n for n in names if n.endswith("/b") and n[:-1] + "w" in peak
            and peak[n] < ROUNDING_ZERO * peak[n[:-1] + "w"]}


B, N, R = 2, 64, 4
ROUNDING_ZERO = 1e-4


def test_forward_train_matches_jax():
    """`continuous.forward(train=True)` at seeded (first-step) weights, the
    size of `test_forward_eval_matches_jax`: the NLL and the dense cloud
    within 1e-4 (relative for the NLL), and the gradient of a smooth loss
    (the NLL plus the mean square of the dense cloud) in every parameter
    leaf within 2e-2 max-relative of `jax.value_and_grad`."""
    params, state = j_cont.init(KEY)
    params, state = (jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, state))
    x = (np.random.RandomState(7).randn(B, N, 3) * 0.3).astype(
        np.float32)

    def j_loss(p):
        dense, nll, _ = j_cont.forward(p, state, jnp.asarray(x), R,
                                       train=True)
        return nll + jnp.mean(dense ** 2), (nll, dense)

    # one jitted program compiles in about half the time of the eager
    # solves
    (_, (rnll, rdense)), rg = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    tp, ts = _to_torch(params, grad=True), _to_torch(state)
    leaves = jax.tree.leaves(tp)
    dense, nll, new_state = t_cont.forward(tp, ts, torch.tensor(x), R,
                                           train=True)
    grads = torch.autograd.grad(nll + torch.mean(dense ** 2), leaves)
    assert dense.shape == (B, N * R, 3)
    np.testing.assert_allclose(float(nll.detach()), float(rnll), rtol=1e-4)
    np.testing.assert_allclose(dense.detach().numpy(), np.asarray(rdense),
                               atol=1e-4)
    assert set(new_state) == {"interp", "feat_convs"}
    flat, _ = jax.tree_util.tree_flatten_with_path(rg)
    names = ["".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                     for k in path) for path, _ in flat]
    ref = [np.asarray(r) for _, r in flat]
    assert len(ref) == len(grads)
    assert all(np.isfinite(g.numpy()).all() for g in grads)
    # the biases of the convs before train-mode BN have a gradient of
    # exactly zero, which each framework rounds to its own noise: those
    # leaves are held to be zero to rounding against their own layer's
    # weight in both, and none of them is a CNF block's
    zero = _rounding_zero(names, ref)
    assert zero == _rounding_zero(names, [g.numpy() for g in grads])
    assert not [n for n in zero if n.startswith("/flow_blocks/")]
    rels = [_maxrel(g.numpy(), r)
            for n, g, r in zip(names, grads, ref) if n not in zero]
    assert len(rels) > len(ref) // 2
    assert max(rels) < 2e-2, max(rels)
