"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without a CUDA card. Run them on the
card with ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from puflow_torch import checkpoint
from puflow_torch.models import discrete
from puflow_torch.models.encoder import interpolation_apply
from puflow_torch.models.fold_bn import fold_bn_inference
from puflow_torch.ops import encoder, flow, interp
from puflow_torch.ops.fps import (farthest_point_sample,
                                  farthest_point_sample_plain)
from puflow_torch.ops.knn import knn_indices, knn_self, knn_self_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,scratch", [(300, 40, False), (5000, 700, False),
                                         (60000, 64, True)])
def test_fps_kernel_matches_plain(card, n, m, scratch):
    # n = 60000 exceeds shared memory: the cache lives in global scratch
    rng = np.random.RandomState(n)
    for pts in (rng.randint(0, 11, (3, n, 3)), rng.rand(3, n, 3)):
        x = torch.from_numpy(pts.astype(np.float32)).to(card)
        before = farthest_point_sample.launches
        got = farthest_point_sample(x, m)
        assert farthest_point_sample.launches == before + 1
        np.testing.assert_array_equal(
            got.cpu().numpy(), farthest_point_sample_plain(x, m).cpu().numpy())


@pytest.mark.parametrize("r", [1, 4, 5])
def test_flow_kernels_match_plain(card, r):
    gen = torch.Generator().manual_seed(0)
    params, state = checkpoint.to_numpy_tree(
        discrete.DiscreteModel(*discrete.init(gen, device="cpu")))
    discrete.perturb_init(params, state, 0)
    tp, ts = checkpoint.from_numpy_tree(params, state, card).trees()
    rng = np.random.RandomState(r)
    # 37 patches: the last tile of each kernel is partial
    x = torch.from_numpy((rng.randn(37, 64, 3) * 0.3).astype(np.float32))
    x = x.to(card)
    idx = knn_indices(x, x, 16)
    cs = discrete.feat_extract(tp, ts, x, idx)
    blocks = tp["flow_blocks"]
    z = flow.flow_f(blocks, x, cs)
    z_ref = flow.flow_f_plain(blocks, x, cs)
    tol = 1e-5 * max(1.0, float(z_ref.abs().max()))
    assert float((z - z_ref).abs().max()) <= tol
    fz = interpolation_apply(tp["interp"], ts["interp"], z_ref, x, r,
                             knn_idx=idx).contiguous()
    g = flow.flow_g(blocks, fz, cs)
    g_ref = flow.flow_g_plain(blocks, fz, cs)
    tol = 1e-5 * max(1.0, float(g_ref.abs().max()))
    assert float((g - g_ref).abs().max()) <= tol


@pytest.fixture(scope="module")
def folded(card):
    """Perturbed seeded params, folded, and 37 patches of 64 points (the
    last tile of each kernel is partial) with their K=16 graph."""
    gen = torch.Generator().manual_seed(1)
    params, state = checkpoint.to_numpy_tree(
        discrete.DiscreteModel(*discrete.init(gen, device="cpu")))
    discrete.perturb_init(params, state, 1)
    tp, ts = checkpoint.from_numpy_tree(params, state, card).trees()
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(37, 64, 3) * 0.3).astype(np.float32))
    x = x.to(card)
    return fold_bn_inference(tp, ts), x, knn_self_plain(x, 16)


@pytest.mark.parametrize("grid", [False, True])
def test_knn_self_kernel_matches_plain(card, grid):
    rng = np.random.RandomState(2)
    pts = rng.randint(0, 5, (5, 300, 3)) if grid else rng.rand(5, 300, 3)
    x = torch.from_numpy(pts.astype(np.float32)).to(card)
    before = knn_self.launches
    got = knn_self(x, 16)
    assert knn_self.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  knn_self_plain(x, 16).cpu().numpy())


def test_encoder_kernel_matches_plain(card, folded):
    params, x, idx = folded
    got = encoder.encoder_conditions(params, x, idx)
    ref = encoder.encoder_conditions_plain(params, x, idx)
    for a, b in zip(got, ref):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) < 5e-5 * scale + 1e-4


@pytest.mark.parametrize("mode,bound", [("logits", 2e-3), ("weights", 5e-4),
                                        ("latents", 5e-4)])
def test_interp_kernel_matches_plain(card, folded, mode, bound):
    params, x, idx = folded
    z = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    z = z.to(card)
    idx8 = idx[..., :8]
    got = interp.interp_head(params["interp"], x, idx8, 4, mode, z)
    ref = interp.interp_head_plain(params["interp"], x, idx8, 4, mode, z)
    assert float((got - ref).abs().max()) < bound


@pytest.mark.parametrize("r", [1, 4, 5])
def test_flow_g_blend_kernel_matches_plain(card, folded, r):
    params, x, idx = folded
    cs = encoder.encoder_conditions_plain(params, x, idx)
    blocks = params["flow_blocks"]
    z = flow.flow_f_plain(blocks, x, cs)
    idx8 = idx[..., :8]
    ws = interp.interp_head_plain(params["interp"], x, idx8, r)
    got = flow.flow_g_blend(blocks, z, ws, idx8, cs)
    ref = flow.flow_g_blend_plain(blocks, z, ws, idx8, cs)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol


def test_folded_sample_runs_every_kernel(card, folded):
    params, x, idx = folded
    wrappers = (knn_self, encoder.encoder_conditions, interp.interp_head,
                flow.flow_f, flow.flow_g_blend)
    before = [w.launches for w in wrappers]
    got = discrete.sample(params, None, x, 4)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1] * 5
    ref = flow.flow_g_blend_plain(
        params["flow_blocks"], flow.flow_f_plain(
            params["flow_blocks"], x,
            encoder.encoder_conditions_plain(params, x, idx)),
        interp.interp_head_plain(params["interp"], x, idx[..., :8], 4),
        idx[..., :8], encoder.encoder_conditions_plain(params, x, idx))
    assert float((got - ref).abs().max()) < 1e-4
