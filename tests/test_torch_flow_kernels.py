"""The port's plain flow f and g against both JAX forms.

The JAX forms are the TPU kernels in interpret mode (`flow_f_pallas`,
`flow_g_pallas`, with FLOW_PASSES=3, the exact matmul split, set and
restored as tests/test_fused_kernels.py does) and the XLA formulations
(`f_transform`, `g_transform(fast=False)`). Inputs are real encoder
conditions and interpolated latents of a perturbed seeded model at B=2,
n=64, r=4. Tolerance: atol 1e-5 * max(1, max|ref|), the JAX package's own
3-pass g bound (tests/test_fused_kernels.py:263-264).

On CPU tensors the wrappers `flow_f` / `flow_g` run these plain versions;
their CUDA kernels are compared with them on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.models import discrete as t_discrete
from puflow_torch.ops import flow as t_flow
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.models.encoder import interpolation_apply
from puflow_tpu.ops.knn import knn_indices
from puflow_tpu.ops.pallas import flow_pallas
from torch_threads import one_torch_thread  # noqa: F401

B, N, R = 2, 64, 4


@pytest.fixture(scope="module")
def case():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 1)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    rng = np.random.RandomState(1)
    x = (rng.randn(B, N, 3) * 0.3).astype(np.float32)
    idx = knn_indices(jnp.asarray(x), jnp.asarray(x), 16)
    cs, _ = j_discrete.feat_extract(jp, js, jnp.asarray(x), idx, train=False)
    z, _ = j_discrete.f_transform(jp, jnp.asarray(x), cs)
    fz, _ = interpolation_apply(jp["interp"], js["interp"], z,
                                jnp.asarray(x), R, False, knn_idx=idx)
    model = t_checkpoint.from_numpy_tree(params, state, "cpu")
    blocks = model.trees()[0]["flow_blocks"]
    return dict(jp=jp, x=x, cs=cs, z=z, fz=fz, blocks=blocks,
                t_cs=[torch.tensor(np.asarray(c)) for c in cs])


def _tol(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def test_plain_flow_f_matches_jax_forms(case):
    x = torch.from_numpy(case["x"])
    got = t_flow.flow_f_plain(case["blocks"], x, case["t_cs"]).numpy()
    z_xla = np.asarray(case["z"])
    z_kernel = np.asarray(flow_pallas.flow_f_pallas(
        case["jp"]["flow_blocks"], jnp.asarray(case["x"]), case["cs"], True))
    # the perturbed flows do work, and stay at a sane latent scale
    assert np.abs(z_xla - case["x"]).max() > 0.1
    assert np.abs(z_xla).max() < 50
    np.testing.assert_allclose(got, z_xla, atol=_tol(z_xla))
    np.testing.assert_allclose(got, z_kernel, atol=_tol(z_kernel))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        t_flow.flow_f(case["blocks"], x, case["t_cs"]).numpy(), got)


def test_plain_flow_g_matches_jax_forms(case):
    fz = torch.tensor(np.asarray(case["fz"]))
    got = t_flow.flow_g_plain(case["blocks"], fz, case["t_cs"]).numpy()
    g_xla = np.asarray(j_discrete.g_transform(case["jp"], case["fz"],
                                              case["cs"], R, fast=False))
    old = flow_pallas.FLOW_PASSES
    try:
        # FLOW_PASSES is read at trace time: clear the jit cache around it
        flow_pallas.FLOW_PASSES = 3
        flow_pallas.flow_g_pallas.clear_cache()
        g_kernel = np.asarray(flow_pallas.flow_g_pallas(
            case["jp"]["flow_blocks"], case["fz"], case["cs"], True))
    finally:
        flow_pallas.FLOW_PASSES = old
        flow_pallas.flow_g_pallas.clear_cache()
    assert got.shape == (B, N * R, 3)
    np.testing.assert_allclose(got, g_xla, atol=_tol(g_xla))
    np.testing.assert_allclose(got, g_kernel, atol=_tol(g_kernel))
    np.testing.assert_array_equal(
        t_flow.flow_g(case["blocks"], fz, case["t_cs"]).numpy(), got)


def test_flow_blocks_move_output(case):
    """The perturbation makes every block's MLPs move its output by at
    least 10% of its scale (seeded init leaves them near the identity)."""
    x = torch.from_numpy(case["x"])
    for i, (bp, c) in enumerate(zip(case["blocks"], case["t_cs"])):
        out, _ = t_flow.flow_block_forward(bp, x, c, i % 2 == 0)
        bare = {**bp, "coupling1": {"bias_net": _no_last(
                    bp["coupling1"]["bias_net"])},
                "coupling2": {k: _no_last(v)
                              for k, v in bp["coupling2"].items()}}
        out0, _ = t_flow.flow_block_forward(bare, x, c, i % 2 == 0)
        assert (out - out0).abs().max() >= 0.1 * out.abs().max(), i
        x = out


def _no_last(net):
    return {**net, "w2": torch.zeros_like(net["w2"]),
            "b2": torch.zeros_like(net["b2"])}
