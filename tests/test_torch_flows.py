"""puflow_torch flow primitives against puflow_tpu, forward and inverse.

Tolerance: atol 1e-5, the bound of tests/test_flows.py. Inputs and
parameters are numpy, handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.flows import coupling as t_coupling
from puflow_torch.flows import normalize as t_normalize
from puflow_torch.flows import permutate as t_permutate
from puflow_torch.ops import flow as t_flow
from puflow_tpu.flows import coupling as j_coupling
from puflow_tpu.flows import normalize as j_normalize
from puflow_tpu.flows import permutate as j_permutate
from puflow_tpu.models import discrete as j_discrete
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
B, N, C, CDIM, H = 2, 17, 3, 32, 64


def _mlp(rng, dim_in, dim_out, dim_c=0):
    """A LinearA1D with every layer non-zero (seeded init zeroes w2/b2)."""
    c_in = dim_in + dim_c
    return {
        "w0": (rng.randn(c_in, H) / np.sqrt(c_in)).astype(np.float32),
        "w1": (rng.randn(H, H) / np.sqrt(H)).astype(np.float32),
        "b1": (rng.randn(H) * 0.1).astype(np.float32),
        "w2": (rng.randn(H, dim_out) * 0.2).astype(np.float32),
        "b2": (rng.randn(dim_out) * 0.1).astype(np.float32),
    }


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def _data(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, C).astype(np.float32)
    c = (rng.randn(B, N, CDIM) * 0.5).astype(np.float32)
    return rng, x, c


def test_actnorm_matches_jax_and_inverts():
    rng, x, _ = _data(0)
    p = {"logs": (rng.randn(1, 1, C) * 0.3).astype(np.float32),
         "bias": rng.randn(1, 1, C).astype(np.float32)}
    zt, ldt = t_normalize.actnorm_forward(_t(p), _t(x))
    zj, ldj = j_normalize.actnorm_forward(_j(p), jnp.asarray(x))
    _close(zt, zj)
    np.testing.assert_allclose(float(ldt), float(ldj), atol=ATOL)
    xt, _ = t_normalize.actnorm_inverse(_t(p), zt)
    xj, _ = j_normalize.actnorm_inverse(_j(p), zj)
    _close(xt, xj)
    np.testing.assert_allclose(xt.numpy(), x, atol=ATOL)


def test_inv1x1_matches_jax_and_inverts():
    rng, x, _ = _data(1)
    w, _ = np.linalg.qr(rng.randn(C, C))
    p = {"W": w.astype(np.float32)}
    zt, ldt = t_permutate.inv1x1_forward(_t(p), _t(x))
    zj, ldj = j_permutate.inv1x1_forward(_j(p), jnp.asarray(x))
    _close(zt, zj)
    np.testing.assert_allclose(float(ldt), float(ldj), atol=ATOL)
    xt, ldi = t_permutate.inv1x1_inverse(_t(p), zt)
    xj, _ = j_permutate.inv1x1_inverse(_j(p), zj)
    _close(xt, xj)
    np.testing.assert_allclose(xt.numpy(), x, atol=ATOL)
    np.testing.assert_allclose(float(ldt + ldi), 0.0, atol=ATOL)


def test_reverse_permute_matches_jax():
    _, x, _ = _data(2)
    _close(t_permutate.reverse_permute(_t(x), (2, 1, 0)),
           j_permutate.reverse_permute(jnp.asarray(x), (2, 1, 0)))


@pytest.mark.parametrize("split", [1, 2])
def test_additive_coupling_matches_jax_and_inverts(split):
    rng, x, c = _data(3 + split)
    p = {"bias_net": _mlp(rng, split, C - split, CDIM)}
    zt, _ = t_coupling.additive_coupling_forward(_t(p), _t(x), _t(c), split)
    zj, _ = j_coupling.additive_coupling_forward(_j(p), jnp.asarray(x),
                                                 jnp.asarray(c), split)
    _close(zt, zj)
    assert np.abs(zt.numpy() - x).max() > 0.1   # the MLP moves the output
    xt, _ = t_coupling.additive_coupling_inverse(_t(p), zt, _t(c), split)
    xj, _ = j_coupling.additive_coupling_inverse(_j(p), zj, jnp.asarray(c),
                                                 split)
    _close(xt, xj)
    np.testing.assert_allclose(xt.numpy(), x, atol=ATOL)


def test_affine_injector_matches_jax_and_inverts():
    rng, x, c = _data(6)
    p = {"scale_net": _mlp(rng, CDIM, C), "bias_net": _mlp(rng, CDIM, C)}
    zt, ldt = t_coupling.affine_injector_forward(_t(p), _t(x), _t(c))
    zj, ldj = j_coupling.affine_injector_forward(_j(p), jnp.asarray(x),
                                                 jnp.asarray(c))
    _close(zt, zj)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=1e-4)
    xt, ldi = t_coupling.affine_injector_inverse(_t(p), zt, _t(c))
    xj, _ = j_coupling.affine_injector_inverse(_j(p), zj, jnp.asarray(c))
    _close(xt, xj)
    np.testing.assert_allclose(xt.numpy(), x, atol=ATOL)
    np.testing.assert_allclose((ldt + ldi).numpy(), 0.0, atol=1e-4)


@pytest.mark.parametrize("is_even", [True, False])
def test_flow_block_matches_jax_and_inverts(is_even):
    rng, x, c = _data(7 + int(is_even))
    split = 1 if is_even else 2
    w, _ = np.linalg.qr(rng.randn(C, C))
    p = {
        "actnorm": {"logs": (rng.randn(1, 1, C) * 0.1).astype(np.float32),
                    "bias": (rng.randn(1, 1, C) * 0.1).astype(np.float32)},
        "inv1x1": {"W": w.astype(np.float32)},
        "coupling1": {"bias_net": _mlp(rng, split, C - split, CDIM)},
        "coupling2": {"scale_net": _mlp(rng, CDIM, C),
                      "bias_net": _mlp(rng, CDIM, C)},
    }
    zt, ldt = t_flow.flow_block_forward(_t(p), _t(x), _t(c), is_even)
    zj, ldj = j_discrete.flow_block_forward(_j(p), jnp.asarray(x),
                                            jnp.asarray(c), is_even)
    _close(zt, zj)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=1e-4)
    xt = t_flow.flow_block_inverse(_t(p), zt, _t(c), is_even)
    _close(xt, j_discrete.flow_block_inverse(_j(p), zj, jnp.asarray(c),
                                             is_even))
    np.testing.assert_allclose(xt.numpy(), x, atol=ATOL)
