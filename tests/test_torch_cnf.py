"""The port's CNF layers and fields against puflow_tpu on the CPU: the
layer zoo, the nonlinearities, `odenet_apply`, the plain field and the
fields with exact and Hutchinson divergence.

The parameters come from the JAX package as numpy trees and go through
`from_numpy_tree` or plain `torch.tensor`; inputs are numpy-seeded. The
shared cases are in tests/torch_cnf_cases.py; tests/test_torch_cnf*.py
split the CNF family's tests by what they hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.models import continuous as t_cont
from puflow_tpu.models import continuous as j_cont

from torch_cnf_cases import KEY, _inputs, _to_torch, net32  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


# --------------------------------------------------------------------------
# layer zoo, nonlinearities, fields
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layer_type", sorted(j_cont.DIFFEQ_LAYERS))
def test_zoo_layer_matches_jax(layer_type):
    init_fn, apply_fn = j_cont.DIFFEQ_LAYERS[layer_type]
    p = jax.tree.map(np.array, init_fn(KEY, 5, 7, 4))
    rng = np.random.RandomState(1)
    for leaf in jax.tree.leaves(p):     # move the zero biases
        leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    ctx = rng.randn(2, 6, 5).astype(np.float32)          # [t, c]
    x = rng.randn(2, 6, 5).astype(np.float32)
    ref = np.asarray(apply_fn(p, jnp.asarray(ctx), jnp.asarray(x)))
    got = t_cont.DIFFEQ_LAYERS[layer_type][1](
        _to_torch(p), torch.from_numpy(ctx), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 6, 7)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the port's own init gives the same tree
    tp = t_cont.DIFFEQ_LAYERS[layer_type][0](
        torch.Generator().manual_seed(0), 5, 7, 4)
    assert (jax.tree.structure(jax.tree.map(np.asarray, tp))
            == jax.tree.structure(p))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, tp)),
                    jax.tree.leaves(p)):
        assert a.shape == b.shape


@pytest.mark.parametrize("name", j_cont.NONLINEARITIES)
def test_odenet_nonlinearity_matches_jax(name):
    layers = jax.tree.map(np.array, j_cont.odenet_init(
        KEY, 3, 6, nonlinearity=name))
    assert isinstance(layers, dict) == (name == "swish")
    if name == "swish":
        layers["swish_beta"] = np.float32(1.3)
    c, y = _inputs(2, 2, 9, 6)
    ref = np.asarray(j_cont.odenet_apply(layers, 0.3, jnp.asarray(c),
                                         jnp.asarray(y), nonlinearity=name))
    got = t_cont.odenet_apply(_to_torch(layers), 0.3, torch.from_numpy(c),
                              torch.from_numpy(y), nonlinearity=name).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    tl = t_cont.odenet_init(torch.Generator().manual_seed(0), 3, 6,
                            nonlinearity=name)
    assert (jax.tree.structure(jax.tree.map(np.asarray, tl))
            == jax.tree.structure(layers))
    with pytest.raises(ValueError, match="unknown nonlinearity"):
        t_cont._apply_nonlinearity("gelu", torch.zeros(1))


@pytest.mark.parametrize("layer_type", ["concatsquash", "concat", "squash"])
def test_odenet_apply_matches_jax(layer_type):
    layers = jax.tree.map(np.array, j_cont.odenet_init(
        KEY, 3, 8, layer_type=layer_type))
    c, y = _inputs(3, 2, 11, 8)
    ref = np.asarray(j_cont.odenet_apply(layers, jnp.asarray(0.7),
                                         jnp.asarray(c), jnp.asarray(y),
                                         layer_type))
    got = t_cont.odenet_apply(_to_torch(layers), torch.tensor(0.7),
                              torch.from_numpy(c), torch.from_numpy(y),
                              layer_type).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)



def test_field_plain_csl_matches_jax(net32):
    layers, tl, c, y = net32
    ref = np.asarray(j_cont.field_plain_csl(layers, jnp.asarray(c))(
        0.4, jnp.asarray(y)))
    tc, ty = torch.from_numpy(c), torch.from_numpy(y)
    got = t_cont.field_plain_csl(tl, tc)(0.4, ty)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the hoisted field is the net itself
    np.testing.assert_allclose(
        got.numpy(), t_cont.odenet_apply(tl, 0.4, tc, ty).numpy(), atol=1e-5)


def test_fields_with_divergence_match_jax(net32):
    layers, tl, c, y = net32
    c, y = c[:, :7], y[:, :7]
    logp = np.zeros((2, 7, 1), np.float32)
    rdy, rdiv = j_cont.field_with_exact_div(layers, jnp.asarray(c))(
        0.2, (jnp.asarray(y), jnp.asarray(logp)))
    tc, ty = torch.from_numpy(c), torch.from_numpy(y)
    with torch.no_grad():   # forward-mode AD works without grad mode
        gdy, gdiv = t_cont.field_with_exact_div(tl, tc)(
            0.2, (ty, torch.from_numpy(logp)))
    np.testing.assert_allclose(gdy.numpy(), np.asarray(rdy), atol=1e-5)
    np.testing.assert_allclose(gdiv.numpy(), np.asarray(rdiv), atol=1e-5)
    # against a dense Jacobian of the port's own net
    jac = torch.autograd.functional.jacobian(
        lambda v: t_cont.odenet_apply(tl, 0.2, tc[:1, :1], v), ty[:1, :1])
    trace = torch.trace(jac.reshape(3, 3))
    np.testing.assert_allclose(float(-gdiv[0, 0, 0]), float(trace), atol=1e-5)

    e = np.random.RandomState(6).randn(2, 7, 3).astype(np.float32)
    rdy, rdiv = j_cont.field_with_hutchinson_div(
        layers, jnp.asarray(c), jnp.asarray(e))(
            0.2, (jnp.asarray(y), jnp.asarray(logp)))
    gdy, gdiv = t_cont.field_with_hutchinson_div(
        tl, tc, torch.from_numpy(e))(0.2, (ty, torch.from_numpy(logp)))
    np.testing.assert_allclose(gdy.numpy(), np.asarray(rdy), atol=1e-5)
    np.testing.assert_allclose(gdiv.numpy(), np.asarray(rdiv), atol=1e-5)
