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
from puflow_torch.ops import emd, encoder, flow, interp
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
    cs, _ = discrete.feat_extract(tp, ts, x, idx)
    blocks = tp["flow_blocks"]
    z = flow.flow_f(blocks, x, cs)
    z_ref = flow.flow_f_plain(blocks, x, cs)
    tol = 1e-5 * max(1.0, float(z_ref.abs().max()))
    assert float((z - z_ref).abs().max()) <= tol
    fz, _ = interpolation_apply(tp["interp"], ts["interp"], z_ref, x, r,
                                knn_idx=idx)
    fz = fz.contiguous()
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


@pytest.mark.parametrize("b,n,m", [(4, 1024, 1024), (3, 300, 301),
                                   (2, 100, 257), (1, 9000, 9000)])
def test_emd_kernel_matches_plain(card, b, n, m):
    """Same assignments bit for bit; m = 301 and 257 take the scalar
    sweep, n = m = 9000 keeps the auction state in global memory."""
    rng = np.random.RandomState(n + m)
    x1 = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32)).to(card)
    x2 = torch.from_numpy(rng.rand(b, m, 3).astype(np.float32)).to(card)
    before = emd.emd_auction.launches
    dist, assign = emd.emd_auction(x1, x2, 0.005, 50)
    assert emd.emd_auction.launches == before + 1
    ref_dist, ref_assign = emd.emd_auction_plain(x1, x2, 0.005, 50)
    np.testing.assert_array_equal(assign.cpu().numpy(),
                                  ref_assign.cpu().numpy())
    tol = 1e-6 * max(1.0, float(ref_dist.abs().max()))
    assert float((dist - ref_dist).abs().max()) <= tol


def test_emd_kernel_non_finite_input(card):
    x1 = torch.rand((2, 256, 3), device=card)
    x2 = torch.rand((2, 256, 3), device=card)
    x1[0, 5] = float("nan")
    x2[1] = float("inf")
    dist, assign = emd.emd_auction(x1, x2, 0.005, 50)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(dist[0, 5]))
    assert not bool(torch.isfinite(dist[1]).any())
    assert int(assign.max()) < 256 and int(assign.min()) >= -1
    # the plain version skips non-finite values as the kernel does
    _, ref_assign = emd.emd_auction_plain(x1, x2, 0.005, 50)
    np.testing.assert_array_equal(assign.cpu().numpy(),
                                  ref_assign.cpu().numpy())


def test_train_step_kernel_emd_matches_plain(card):
    """One train step's gradients with the kernel EMD against the same
    step with the plain EMD (gather backward uses atomics: tolerance, not
    equality)."""
    from puflow_torch.data.synthetic import synthetic_pairs
    from puflow_torch.train import trainer

    gen = torch.Generator(device=card).manual_seed(0)
    params, state = discrete.init(gen, device=card)
    sparse, dense = (torch.from_numpy(a).to(card) for a in
                     synthetic_pairs(np.random.RandomState(0), 8, 256, 4))
    params = discrete.actnorm_warmup(params, state, sparse)
    layout, s_layout = trainer.TreeLayout(params), trainer.TreeLayout(state)
    grads = []
    for emd_fn in (emd.emd_auction, emd.emd_auction_plain):
        leaf = layout.flatten(params).requires_grad_()
        bn_state = s_layout.unflatten(s_layout.flatten(state))
        pred, logpx, _ = discrete.forward(layout.unflatten(leaf), bn_state,
                                          sparse, 4, train=True)
        dist, assign = emd_fn(pred, dense, 0.005, 50)
        loss = logpx * 1e-4 + torch.sum(dist) * 5e-2
        grads.append(torch.autograd.grad(loss, leaf)[0])
    for path, a, b in zip(layout.paths, grads[0].split(layout.sizes),
                          grads[1].split(layout.sizes)):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) <= 5e-4 * scale + 1e-6, path
