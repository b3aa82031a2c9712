"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without a CUDA card. Run them on the
card with ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import ctypes
import functools
import subprocess

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from puflow_torch import checkpoint
from puflow_torch.models import continuous, discrete
from puflow_torch.models.encoder import interpolation_apply
from puflow_torch.models.fold_bn import fold_bn_inference
from puflow_torch.ops import _build, cnf, emd, encoder, flow, interp
from puflow_torch.ops import fps as fps_ops
from puflow_torch.ops import knn as knn_ops
from puflow_torch.ops.fps import (farthest_point_sample,
                                  farthest_point_sample_plain,
                                  farthest_point_sample_seeded,
                                  farthest_point_sample_seeded_plain)
from puflow_torch.ops.knn import (knn_indices, knn_self, knn_self_plain,
                                  knn_self_stream)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # `import puflow_torch` pins exact float32
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


# every plan at a ragged n (no multiple of C x threads), one block a cloud
# included; forced through the wrapper's private keyword
PLANS = [fps_ops.ONE_BLOCK] + [fps_ops.FpsPlan(c, t)
                               for c in (2, 3, 5, 8, 12, 16)
                               for t in (128, 256)]


def _repeated_half(rng, b, n):
    # the second half repeats the first: exact ties between blocks of a
    # cluster, where the lower index must win
    half = rng.randint(0, 64, (b, n // 2, 3))
    return np.concatenate([half, half, half[:, :n % 2]], 1)


# (clouds, points, picks, plan): the first three keep the wrapper's plan
# (n = 60000 exceeds shared memory: the cache lives in global scratch);
# then the merge's 34,816 candidates at 1, 8 and 32 clouds, and each plan
@pytest.mark.parametrize("b,n,m,plan", [
    (3, 300, 40, None), (3, 5000, 700, None), (3, 60000, 64, None),
    (1, 34816, 2000, None), (8, 34816, 2000, None), (32, 34816, 2000, None),
    *((2, 8001, 1500, plan) for plan in PLANS)])
def test_fps_kernel_matches_plain(card, b, n, m, plan):
    rng = np.random.RandomState(n)
    for pts in (rng.randint(0, 11, (b, n, 3)), rng.rand(b, n, 3),
                _repeated_half(rng, b, n)):
        x = torch.from_numpy(pts.astype(np.float32)).to(card)
        before = farthest_point_sample.launches
        got = farthest_point_sample(x, m, _plan=plan)
        assert farthest_point_sample.launches == before + 1
        np.testing.assert_array_equal(
            got.cpu().numpy(), farthest_point_sample_plain(x, m).cpu().numpy())


def test_fps_merge_plan_takes_a_cluster(card):
    capacity = functools.partial(fps_ops.cluster_capacity, card, 34816)
    for b in (1, 8, 32):
        plan = fps_ops._fps_plan(b, 34816, capacity)
        assert plan.cluster > 1 and capacity(plan) >= b


# (rows, candidates, seed sets, seeds, picks): the seeded merge's Morton
# cells at one cloud (auto G = 16: 16 rows share one seed set) and its
# G = 1 row; a PU-GAN 5,000-point cloud's union (cache in global scratch);
# a ragged case
@pytest.mark.parametrize("rows,n,sets,s,m", [
    (16, 2048, 1, 2048, 386), (1, 32768, 1, 2048, 6168),
    (1, 79872, 1, 5000, 300), (3, 150, 3, 33, 20)])
def test_fps_seeded_kernel_matches_plain(card, rows, n, sets, s, m):
    rng = np.random.RandomState(n)
    for label, make in (("integer", lambda *sh: rng.randint(0, 11, sh)),
                        ("float", lambda *sh: rng.rand(*sh))):
        x = torch.from_numpy(make(rows, n, 3).astype(np.float32)).to(card)
        sd = torch.from_numpy(make(sets, s, 3).astype(np.float32)).to(card)
        before = farthest_point_sample_seeded.launches
        got = farthest_point_sample_seeded(x, sd, m)
        assert farthest_point_sample_seeded.launches == before + 1
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            farthest_point_sample_seeded_plain(x, sd, m).cpu().numpy(),
            err_msg=label)
        assert torch.equal(got, farthest_point_sample_seeded(x, sd, m))


def test_fps_seeded_kernel_ties(card):
    # every candidate twice and the seeds among them: ties everywhere
    rng = np.random.RandomState(9)
    base = rng.rand(2, 700, 3).astype(np.float32)
    x = torch.from_numpy(np.concatenate([base, base[:, ::-1]], 1)).to(card)
    sd = x[:, ::50].contiguous()
    got = farthest_point_sample_seeded(x, sd, 900)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        farthest_point_sample_seeded_plain(x, sd, 900).cpu().numpy())


# r = 32 (the head's most) and 5 as well as the path's 4; 37 patches of
# 61 points leave the last tile of each kernel partial. Every call runs
# the model's condition widths 32, 64 and 128 (one a flow block).
@pytest.mark.parametrize("r", [1, 4, 5, 32])
def test_flow_kernels_match_plain(card, r):
    gen = torch.Generator().manual_seed(0)
    params, state = checkpoint.to_numpy_tree(
        discrete.DiscreteModel(*discrete.init(gen, device="cpu")))
    discrete.perturb_init(params, state, 0)
    tp, ts = checkpoint.from_numpy_tree(params, state, card).trees()
    rng = np.random.RandomState(r)
    x = torch.from_numpy((rng.randn(37, 61, 3) * 0.3).astype(np.float32))
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
    before = flow.flow_g.launches
    g = flow.flow_g(blocks, fz, cs)
    assert flow.flow_g.launches == before + 1
    g_ref = flow.flow_g_plain(blocks, fz, cs)
    tol = 1e-5 * max(1.0, float(g_ref.abs().max()))
    assert float((g - g_ref).abs().max()) <= tol
    # one fixed order, no atomics: a rerun is bit-equal
    assert torch.equal(g, flow.flow_g(blocks, fz, cs))


def test_flow_g_kernel_other_condition_widths(card):
    """Condition widths no model block has (40 and 8, padded to whole k
    chunks; 128): the kernel matches its plain version. It reads a
    condition's columns in pairs, so an odd width or rows 4-byte aligned
    only raise."""
    gen = torch.Generator().manual_seed(5)
    cdims = (40, 8, 128)
    blocks = [discrete.flow_block_init(gen, cd, i % 2 == 0, device="cpu")
              for i, cd in enumerate(cdims)]
    # noise on every weight: seeded init leaves the nets' last layers zero
    blocks = tree_map(
        lambda t: (t + 0.1 * torch.randn(t.shape, generator=gen)).to(card),
        blocks)
    rng = np.random.RandomState(5)
    n, r = 333, 4
    fz = torch.from_numpy(rng.randn(1, n, 3, r).astype(np.float32)).to(card)
    cs = [torch.from_numpy(rng.randn(1, n, cd).astype(np.float32)).to(card)
          for cd in cdims]
    got = flow.flow_g(blocks, fz, cs)
    ref = flow.flow_g_plain(blocks, fz, cs)
    assert float((got - ref).abs().max()) <= 1e-5 * max(
        1.0, float(ref.abs().max()))
    odd = [discrete.flow_block_init(gen, 33, True, device="cpu")]
    odd = tree_map(lambda t: t.to(card), odd)
    with pytest.raises(ValueError, match="even width"):
        flow.flow_g(odd, fz, [torch.zeros(1, n, 33, device=card)])
    shifted = torch.zeros(n * 128 + 1, device=card)[1:].view(1, n, 128)
    with pytest.raises(ValueError, match="even width"):
        flow.flow_g(blocks, fz, cs[:2] + [shifted])


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


# (patches, points, k): ragged n (no multiple of a block's queries or of
# the lanes' streams), k 1 / 5 / 8 / 16 (lists of 1, 8, 8, 16 keys), one
# patch and the main path's 1,024 (4 and 2 lanes a query)
@pytest.mark.parametrize("b,n,k", [
    (5, 17, 16), (5, 300, 1), (5, 300, 5), (3, 300, 8), (5, 300, 16),
    (1, 256, 16), (1024, 256, 16)])
@pytest.mark.parametrize("kind", ["float", "grid", "repeated"])
def test_knn_self_kernel_cases(card, b, n, k, kind):
    rng = np.random.RandomState(n + k)
    if kind == "grid":
        pts = rng.randint(0, 5, (b, n, 3))
    elif kind == "repeated":
        # the second half repeats the first: slot 0 of a copy is the first
        pts = rng.rand(b, n - n // 2, 3)
        pts = np.concatenate([pts, pts[:, :n // 2]], 1)
    else:
        pts = rng.rand(b, n, 3)
    x = torch.from_numpy(pts.astype(np.float32)).to(card)
    got = knn_self(x, k)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  knn_self_plain(x, k).cpu().numpy())
    assert torch.equal(got, knn_self(x, k))


def test_knn_self_kernel_largest_patch(card):
    """The largest patch shared memory holds takes the shared-memory
    kernel, one point more the streaming kernel; both give the plain
    version's indices."""
    rng = np.random.RandomState(3)
    for n, stream in ((knn_ops.KNN_MAX_N, 0), (knn_ops.KNN_MAX_N + 1, 1)):
        x = torch.from_numpy(rng.rand(1, n, 3).astype(np.float32)).to(card)
        before = knn_self.launches, knn_self_stream.launches
        got = knn_self(x, 16)
        assert (knn_self.launches - before[0],
                knn_self_stream.launches - before[1]) == (1 - stream, stream)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      knn_self_plain(x, 16).cpu().numpy())


# the shared-memory kernel's cases through the streaming kernel, and
# patches of several chunks (2,048 points) with a ragged last one
@pytest.mark.parametrize("b,n,k", [
    (5, 17, 16), (5, 300, 1), (5, 300, 5), (3, 300, 8), (5, 300, 16),
    (1, 256, 16), (1024, 256, 16), (2, 4099, 16), (1, 10433, 8)])
@pytest.mark.parametrize("kind", ["float", "grid", "repeated"])
def test_knn_self_stream_kernel_cases(card, b, n, k, kind):
    rng = np.random.RandomState(n + k)
    if kind == "grid":
        pts = rng.randint(0, 5, (b, n, 3))
    elif kind == "repeated":
        pts = rng.rand(b, n - n // 2, 3)
        pts = np.concatenate([pts, pts[:, :n // 2]], 1)
    else:
        pts = rng.rand(b, n, 3)
    x = torch.from_numpy(pts.astype(np.float32)).to(card)
    before = knn_self_stream.launches
    got = knn_self_stream(x, k)
    assert knn_self_stream.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  knn_self_plain(x, k).cpu().numpy())
    assert torch.equal(got, knn_self_stream(x, k))


def test_encoder_kernel_matches_plain(card, folded):
    params, x, idx = folded
    got = encoder.encoder_conditions(params, x, idx)
    ref = encoder.encoder_conditions_plain(params, x, idx)
    for a, b in zip(got, ref):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) < 5e-5 * scale + 1e-4


# (patches, points, K): 67 x 61 points leave the persistent grid's last
# round ragged (no multiple of a block's warps, a point each); K = 8 and 24
# come padded to 16 and 32 slots; every graph is a slice of a 24-neighbour
# one (row stride 24)
@pytest.mark.parametrize("b,n,k", [(67, 61, 16), (37, 64, 8), (37, 64, 24)])
def test_encoder_kernel_ragged_and_padded(card, folded, b, n, k):
    params = folded[0]
    rng = np.random.RandomState(b * n + k)
    x = torch.from_numpy((rng.randn(b, n, 3) * 0.3).astype(np.float32))
    x = x.to(card)
    idx = knn_indices(x, x, 24)[..., :k]
    before = encoder.encoder_conditions.launches
    got = encoder.encoder_conditions(params, x, idx)
    assert encoder.encoder_conditions.launches == before + 1
    ref = encoder.encoder_conditions_plain(params, x, idx)
    for a, r in zip(got, ref):
        scale = float(r.abs().max())
        assert float((a - r).abs().max()) < 5e-5 * scale + 1e-4


def test_encoder_kernel_rerun_is_bit_equal(card, folded):
    params, x, idx = folded
    first = encoder.encoder_conditions(params, x, idx)
    again = encoder.encoder_conditions(params, x, idx)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# the JAX package's gates for the exact head (tests/test_fused_kernels.py:
# 149, 125, 183); k = 8 is the path's (the softmax in registers), 5 and 16
# stage the logits in shared memory; every graph is a slice of a
# 24-neighbour one (row stride 24); 61 points a patch leave the last round
# ragged
@pytest.mark.parametrize("mode,bound", [("logits", 2e-3), ("weights", 5e-4),
                                        ("latents", 5e-4)])
@pytest.mark.parametrize("k", [8, 5, 16])
@pytest.mark.parametrize("n", [64, 61])
def test_interp_kernel_matches_plain(card, folded, mode, bound, k, n):
    params, x, _ = folded
    x = x[:, :n].contiguous()
    idx = knn_indices(x, x, 24)[..., :k]
    z = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    z = z.to(card)
    for r in (1, 4, 32):
        before = interp.interp_head.launches
        got = interp.interp_head(params["interp"], x, idx, r, mode, z)
        assert interp.interp_head.launches == before + 1
        ref = interp.interp_head_plain(params["interp"], x, idx, r, mode, z)
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) < bound, r
        # one fixed order, no atomics: a rerun is bit-equal
        assert torch.equal(got, interp.interp_head(params["interp"], x, idx,
                                                   r, mode, z))


def test_interp_repacks_after_an_in_place_update(card, folded):
    """The head's weights are packed once per parameters; an in-place
    update of a head weight makes a fresh packing."""
    params, x, idx = folded
    head = tree_map(lambda t: t.clone(), params["interp"])
    idx8 = idx[..., :8]
    first = interp.interp_head(head, x, idx8, 4)
    head["knn_context"]["feat_conv"]["conv_out"]["w"].mul_(1.25)
    got = interp.interp_head(head, x, idx8, 4)
    ref = interp.interp_head_plain(head, x, idx8, 4)
    assert not torch.equal(got, first)
    assert float((got - ref).abs().max()) < 5e-4


# as test_flow_kernels_match_plain: r up to 32, and patches of 61 points
# (the last tile partial) beside the fixture's 64
@pytest.mark.parametrize("r", [1, 4, 5, 32])
@pytest.mark.parametrize("n", [64, 61])
def test_flow_g_blend_kernel_matches_plain(card, folded, r, n):
    params, x, idx = folded
    if n != x.shape[1]:
        x = x[:, :n].contiguous()
        idx = knn_self_plain(x, 16)
    cs = encoder.encoder_conditions_plain(params, x, idx)
    blocks = params["flow_blocks"]
    z = flow.flow_f_plain(blocks, x, cs)
    idx8 = idx[..., :8]
    ws = interp.interp_head_plain(params["interp"], x, idx8, r)
    got = flow.flow_g_blend(blocks, z, ws, idx8, cs)
    ref = flow.flow_g_blend_plain(blocks, z, ws, idx8, cs)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol
    assert torch.equal(got, flow.flow_g_blend(blocks, z, ws, idx8, cs))


def test_flow_g_repacks_after_an_in_place_update(card, folded):
    """The kernel's weights are packed once per parameters; an in-place
    update of a flow weight (an MLP's and inv1x1's W, whose inverse the
    pack holds) makes a fresh packing."""
    params, x, idx = folded
    blocks = [{k: {kk: (vv.clone() if torch.is_tensor(vv) else
                        {m: t.clone() for m, t in vv.items()})
                   for kk, vv in v.items()}
               for k, v in bp.items()} for bp in params["flow_blocks"]]
    cs = encoder.encoder_conditions_plain(params, x, idx)
    z = flow.flow_f_plain(blocks, x, cs)
    idx8 = idx[..., :8]
    ws = interp.interp_head_plain(params["interp"], x, idx8, 4)
    first = flow.flow_g_blend(blocks, z, ws, idx8, cs)
    blocks[3]["coupling2"]["scale_net"]["w1"].mul_(1.25)
    blocks[1]["inv1x1"]["W"].add_(0.01)
    got = flow.flow_g_blend(blocks, z, ws, idx8, cs)
    ref = flow.flow_g_blend_plain(blocks, z, ws, idx8, cs)
    assert not torch.equal(got, first)
    assert float((got - ref).abs().max()) <= 1e-5 * max(
        1.0, float(ref.abs().max()))


# 17, 63 and 2,257 rows: each leaves the last 16-row tile partial
@pytest.mark.parametrize("b,n", [(1, 17), (3, 21), (37, 61)])
def test_flow_f_kernel_ragged_rows(card, folded, b, n):
    """The forward flow on row counts no multiple of 16 matches its plain
    version, and a rerun is bit-equal (one fixed order, no atomics)."""
    params, x, _ = folded
    x = x[:b, :n].contiguous()
    cs = encoder.encoder_conditions_plain(params, x, knn_self_plain(x, 16))
    blocks = params["flow_blocks"]
    before = flow.flow_f.launches
    got = flow.flow_f(blocks, x, cs)
    assert flow.flow_f.launches == before + 1
    ref = flow.flow_f_plain(blocks, x, cs)
    assert float((got - ref).abs().max()) <= 1e-5 * max(
        1.0, float(ref.abs().max()))
    assert torch.equal(got, flow.flow_f(blocks, x, cs))


def test_flow_f_repacks_after_an_in_place_update(card, folded):
    """As for flow g: an in-place update of a flow weight (an MLP's, and
    ActNorm's logs, whose exp the pack holds) makes a fresh packing."""
    params, x, idx = folded
    blocks = [{k: {kk: (vv.clone() if torch.is_tensor(vv) else
                        {m: t.clone() for m, t in vv.items()})
                   for kk, vv in v.items()}
               for k, v in bp.items()} for bp in params["flow_blocks"]]
    cs = encoder.encoder_conditions_plain(params, x, idx)
    first = flow.flow_f(blocks, x, cs)
    blocks[2]["coupling1"]["bias_net"]["w1"].mul_(1.25)
    blocks[4]["actnorm"]["logs"].add_(0.01)
    got = flow.flow_f(blocks, x, cs)
    ref = flow.flow_f_plain(blocks, x, cs)
    assert not torch.equal(got, first)
    assert float((got - ref).abs().max()) <= 1e-5 * max(
        1.0, float(ref.abs().max()))


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


def test_folded_sample_over_the_knn_limit(card, folded):
    """Patches of `KNN_MAX_N` + 1 points: the folded branch takes the
    streaming self k-NN kernel and its other four kernels, and matches the
    plain composition."""
    params = folded[0]
    rng = np.random.RandomState(4)
    x = torch.from_numpy((rng.randn(1, knn_ops.KNN_MAX_N + 1, 3) * 0.3)
                         .astype(np.float32)).to(card)
    wrappers = (knn_self, knn_self_stream, encoder.encoder_conditions,
                interp.interp_head, flow.flow_f, flow.flow_g_blend)
    before = [w.launches for w in wrappers]
    got = discrete.sample(params, None, x, 4)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [0] + [1] * 5
    idx = knn_self_plain(x, 16)
    cs = encoder.encoder_conditions_plain(params, x, idx)
    ref = flow.flow_g_blend_plain(
        params["flow_blocks"], flow.flow_f_plain(params["flow_blocks"], x, cs),
        interp.interp_head_plain(params["interp"], x, idx[..., :8], 4),
        idx[..., :8], cs)
    assert float((got - ref).abs().max()) < 1e-4


# (clouds, n, m): the first three and the training shape at 32 clouds and
# at 1 (the extremes of `_emd_plan`'s cluster size) take the cluster
# kernel; EMD_MAX_M on one cloud is the largest it takes, EMD_MAX_M + 1 and
# 9000 take the global-scratch path
EMD_SHAPES = [(4, 1024, 1024), (3, 300, 301), (2, 100, 257), (1, 9000, 9000),
              (32, 1024, 1024), (1, 1024, 1024),
              (1, emd.EMD_MAX_M, emd.EMD_MAX_M),
              (1, emd.EMD_MAX_M + 1, emd.EMD_MAX_M + 1)]


@pytest.mark.parametrize("b,n,m", EMD_SHAPES)
def test_emd_kernel_matches_plain(card, b, n, m):
    """Same assignments bit for bit, on either path and either side of the
    shared-memory limit; two runs bit-equal."""
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
    again, again_assign = emd.emd_auction(x1, x2, 0.005, 50)
    assert torch.equal(again, dist) and torch.equal(again_assign, assign)


def test_emd_plan_takes_a_cluster(card):
    """A cluster of more than one block at the training shape at 1, 8 and
    32 clouds, the global-scratch path over the shared-memory limit."""
    def plan(b, n):
        return emd._emd_plan(b, n, n, functools.partial(
            emd.cluster_capacity, card, n, n))

    for b in (1, 8, 32):
        assert plan(b, 1024) > 1, b
    assert plan(1, emd.EMD_MAX_M) > 1
    assert plan(1, emd.EMD_MAX_M + 1) == emd.GLOBAL_SCRATCH


@pytest.mark.parametrize("b,n", [(8, 1024), (32, 1024), (3, 300)])
def test_emd_kernel_ties(card, b, n):
    """Clouds on a coarse integer grid, each point repeated: exact ties in
    value and in increment, where the lowest column and the lowest row
    must win in every block of the cluster."""
    rng = np.random.RandomState(b + n)
    half = rng.randint(0, 6, (2, b, (n + 1) // 2, 3)).astype(np.float32)
    x1, x2 = (torch.from_numpy(np.concatenate([h, h], 1)[:, :n] / 5.0)
              .to(card) for h in half)
    dist, assign = emd.emd_auction(x1, x2, 0.005, 50)
    ref_dist, ref_assign = emd.emd_auction_plain(x1, x2, 0.005, 50)
    np.testing.assert_array_equal(assign.cpu().numpy(),
                                  ref_assign.cpu().numpy())
    assert float((dist - ref_dist).abs().max()) <= 1e-6 * max(
        1.0, float(ref_dist.abs().max()))


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


def _cnf_layers(card, cdim, seed, time_scale):
    """A seeded 3-64-64-3 net on the card; ``time_scale`` > 0 gives its
    time rows that scale (solves of several steps, some rejected)."""
    gen = torch.Generator().manual_seed(seed)
    layers = continuous.odenet_init(gen, 3, cdim, device="cpu")
    for p in layers:
        for k in ("hyper_gate", "hyper_bias"):
            w = p[k]["w"]
            if time_scale:
                w[0] = torch.randn(w.shape[1], generator=gen) * (
                    time_scale if w.shape[1] > 3 else time_scale / 10)
    return [{k: {kk: t.to(card) for kk, t in v.items()} for k, v in p.items()}
            for p in layers]


def _rk4_float64(layers, c, y, t0, t1, steps):
    """Classical RK4 on the plain field in float64, ``steps`` equal steps:
    a witness independent of the adaptive solver."""
    layers = [{k: {kk: t.double() for kk, t in v.items()}
               for k, v in p.items()} for p in layers]
    c = torch.repeat_interleave(c, y.shape[1] // c.shape[1], dim=1)
    f = continuous.field_plain_csl(layers, c.double())
    y, h = y.double(), (t1 - t0) / steps
    for i in range(steps):
        t = t0 + i * h
        k1 = f(t, y)
        k2 = f(t + h / 2, y + (h / 2) * k1)
        k3 = f(t + h / 2, y + (h / 2) * k2)
        k4 = f(t + h, y + h * k3)
        y = y + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
    return y


SIGMOID_SWEEP = r"""
#include "cnf_field.cuh"

// every finite float x: cnf_field::sigmoid against 1 / (1 + e^-x) by IEEE
// division, bit for bit where that is normal, else 0
__global__ void sweep(unsigned long long* bad, unsigned* first) {
  const unsigned long long step = 1ull * gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += step) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    if (!isfinite(x)) continue;
    const float got = puflow::cnf_field::sigmoid(x);
    const float ref = 1.f / (1.f + expf(-x));
    const bool ok = ref >= 0x1p-126f
                        ? __float_as_uint(got) == __float_as_uint(ref)
                        : got == 0.f;
    if (!ok && atomicAdd(bad, 1ull) == 0) *first = static_cast<unsigned>(i);
  }
}

extern "C" int run(void* bad, void* first) {
  sweep<<<4096, 256>>>(static_cast<unsigned long long*>(bad),
                       static_cast<unsigned*>(first));
  return cudaDeviceSynchronize();
}
"""


def _sweep_every_float(card, tmp_path, source):
    """Build ``source`` (a sweep over every 32-bit pattern, with `csrc/` on
    the include path) and run it: (inputs that differ, one of them)."""
    src, lib = tmp_path / "sweep.cu", tmp_path / "libsweep.so"
    src.write_text(source)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-I", str(_build.CSRC), str(src), "-o", str(lib)],
                   check=True, capture_output=True, timeout=600)
    bad = torch.zeros(1, dtype=torch.int64, device=card)
    first = torch.zeros(1, dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    assert run(bad.data_ptr(), first.data_ptr()) == 0
    return int(bad.item()), first.cpu().view(torch.float32).item()


def test_cnf_sigmoid_is_the_division_over_every_float(card, tmp_path):
    """The CNF kernels' sigmoid (`cnf_field.cuh`: the reciprocal without
    the division's range check) gives the IEEE division's bits at every
    finite input where the result is normal, -104 to -87.3 and large
    positive inputs included, and 0 where it would be subnormal."""
    bad, x = _sweep_every_float(card, tmp_path, SIGMOID_SWEEP)
    assert bad == 0, f"{bad} inputs differ, one {x!r}"


EMD_ROOT_SWEEP = r"""
#include "emd.cu"

// every float d2: the auction kernels' three_minus_root against
// 3 - __fsqrt_rn(max(d2, 0)): the same bits where that is finite, and
// non-finite where it is not
__global__ void sweep(unsigned long long* bad, unsigned* first) {
  const unsigned long long step = 1ull * gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += step) {
    const float d2 = __uint_as_float(static_cast<unsigned>(i));
    const float got = three_minus_root(d2);
    const float ref = __fsub_rn(3.0f, __fsqrt_rn(d2 < 0.0f ? 0.0f : d2));
    const bool ok = isfinite(ref)
                        ? __float_as_uint(got) == __float_as_uint(ref)
                        : !isfinite(got);
    if (!ok && atomicAdd(bad, 1ull) == 0) *first = static_cast<unsigned>(i);
  }
}

extern "C" int run(void* bad, void* first) {
  sweep<<<4096, 256>>>(static_cast<unsigned long long*>(bad),
                       static_cast<unsigned*>(first));
  return cudaDeviceSynchronize();
}
"""


def test_emd_root_is_fsqrt_rn_over_every_float(card, tmp_path):
    """The auction kernels' base value without sqrt.rn's range check
    (`csrc/emd.cu:three_minus_root`) has __fsqrt_rn's bits wherever
    3 - sqrt(max(d2, 0)) is finite, at every float d2, and is non-finite
    wherever that is."""
    bad, d2 = _sweep_every_float(card, tmp_path, EMD_ROOT_SWEEP)
    assert bad == 0, f"{bad} inputs differ, one {d2!r}"


# the last two have more rows than the card's warps take as tiles of 8
# (8,448 on an H100's 132 SMs): tiles of 16 rows, the second ragged
CNF_SHAPES = [(2, 100, 1, 32), (32, 256, 1, 128), (3, 333, 1, 64),
              (5, 231, 3, 128), (8, 1024, 4, 32), (9, 1024, 4, 128),
              (5, 1999, 1, 64)]


@pytest.mark.parametrize("b,n,r,cdim", CNF_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_scale,tol", [(0.0, 5e-6), (20.0, 5e-5)])
def test_cnf_solve_kernel_matches_plain(card, b, n, r, cdim, reverse,
                                        time_scale, tol):
    """The whole-solve kernel against `cnf_solve_plain`: the same step
    counts, two runs bit-equal. 333 and 231 rows a cloud leave a partial
    last tile; r > 1 indexes the conditions by ``row // r``.

    A seeded net takes three steps whose sizes are all set by a clip:
    within 5e-6, the JAX package's bound for its kernel (tests/test_cnf.py).
    With time rows of scale 20 the step sizes follow the error estimate and
    two correct solvers differ by up to 1.1e-5 (measured): 5e-5, five times
    the solver's tolerance, and both are held against a float64 fixed-step
    RK4 solve, from which the kernel may lie at most 1.25 times as far as
    the plain version (plus 1e-6 of rounding)."""
    layers = _cnf_layers(card, cdim, b + n, time_scale)
    rng = np.random.RandomState(n + cdim)
    c = torch.from_numpy((rng.randn(b, n // r, cdim) * 0.3)
                         .astype(np.float32)).to(card)
    y = torch.from_numpy((rng.randn(b, n, 3) * 0.5).astype(np.float32))
    y = y.to(card)
    T = torch.tensor(0.36, device=card)
    before = cnf.cnf_solve.launches
    got, stats = cnf.cnf_solve(layers, c, y, T, reverse, return_stats=True)
    again = cnf.cnf_solve(layers, c, y, T, reverse)
    assert cnf.cnf_solve.launches == before + 2
    zero = torch.zeros_like(T)
    t0, t1 = (T, zero) if reverse else (zero, T)
    ref, ref_stats = cnf.cnf_solve_plain(layers, c, y, t0, t1,
                                         return_stats=True)
    assert stats.tolist() == [ref_stats["steps"], ref_stats["accepted"]]
    assert (ref_stats["steps"] > 3) == (time_scale > 0)
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) < tol
    if time_scale:
        truth = _rk4_float64(layers, c, y, float(t0), float(t1), 1024)
        err_kernel = float((got.double() - truth).abs().max())
        err_plain = float((ref.double() - truth).abs().max())
        assert err_kernel <= 1.25 * err_plain + 1e-6


def test_cnf_solve_kernel_step_budget_and_zero_span(card):
    layers = _cnf_layers(card, 32, 0, 20.0)
    c = torch.zeros((1, 70, 32), device=card)
    y = torch.randn((1, 70, 3), generator=torch.Generator().manual_seed(0))
    y = y.to(card)
    out, stats = cnf.cnf_solve(layers, c, y, 0.0, return_stats=True)
    assert stats.tolist() == [0, 0] and torch.equal(out, y)
    out, stats = cnf.cnf_solve(layers, c, y, 0.4, max_steps=2,
                               return_stats=True)
    ref, ref_stats = cnf.cnf_solve_plain(layers, c, y, 0.0, 0.4, max_steps=2,
                                         return_stats=True)
    assert stats.tolist() == [2, ref_stats["accepted"]]
    # an unconverged solve keeps its last state; its time follows the step
    # sizes, which carry the error estimate's rounding (about 1e-5)
    assert float((out - ref).abs().max()) < 5e-4


@pytest.mark.parametrize("fold", [False, True])
def test_cnf_sample_launches_twelve_solves(card, fold):
    gen = torch.Generator().manual_seed(2)
    params, state = checkpoint.to_numpy_tree(
        continuous.ContinuousModel(*continuous.init(gen, device="cpu")))
    discrete.perturb_init(params, state, 2)
    model = checkpoint.from_numpy_tree(params, state, card, model="cnf")
    tp, ts = model.trees()
    if fold:
        tp = fold_bn_inference(tp, ts)
    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.randn(5, 64, 3) * 0.3).astype(np.float32))
    x = x.to(card)
    wrappers = (cnf.cnf_solve, encoder.encoder_conditions, interp.interp_head)
    before = [w.launches for w in wrappers]
    log = []
    cnf.cnf_solve.stats_log = log
    try:
        got = continuous.sample(tp, ts, x, 4)
    finally:
        cnf.cnf_solve.stats_log = None
    assert [w.launches - b for w, b in zip(wrappers, before)] == (
        [12, 1, 1] if fold else [12, 0, 0])
    steps = torch.stack(log).cpu()
    assert steps.shape == (12, 2) and int(steps[:, 0].max()) < 128
    # the same pipeline on plain versions (the model on the CPU)
    cpu_model = checkpoint.from_numpy_tree(params, state, "cpu", model="cnf")
    ref = cpu_model(x.cpu(), 4)
    assert float((got.cpu() - ref).abs().max()) < 1e-4


def _rk4_logp_float64(layers, c, y, logp, t0, t1, steps):
    """Classical RK4 of (y, logp) on the exact-trace field in float64."""
    layers = [{k: {kk: t.double() for kk, t in v.items()}
               for k, v in p.items()} for p in layers]
    c = torch.repeat_interleave(c, y.shape[1] // c.shape[1], dim=1)
    f = continuous.field_with_exact_div(layers, c.double())
    s, h = (y.double(), logp.double()), (t1 - t0) / steps

    def axpy(a, x, z):
        return tuple(u + a * v for u, v in zip(x, z))

    for i in range(steps):
        t = t0 + i * h
        k1 = f(t, s)
        k2 = f(t + h / 2, axpy(h / 2, s, k1))
        k3 = f(t + h / 2, axpy(h / 2, s, k2))
        k4 = f(t + h, axpy(h, s, k3))
        s = tuple(u + (h / 6) * (a + 2 * b + 2 * cc + d)
                  for u, a, b, cc, d in zip(s, k1, k2, k3, k4))
    return s


@pytest.mark.parametrize("b,n,r,cdim", CNF_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_scale,tol", [(0.0, 5e-6), (20.0, 5e-5)])
def test_cnf_solve_logp_kernel_matches_plain(card, b, n, r, cdim, reverse,
                                             time_scale, tol):
    """The log-density solve kernel against `cnf_solve_logp_plain`: equal
    step counts, two runs bit-equal, y and logp within 5e-6 at seeded
    weights (every step size set by a clip) and 5e-5 with time rows of
    scale 20, where both are held against a float64 RK4 solve as in
    `test_cnf_solve_kernel_matches_plain`. 333, 231 and 1,999 rows a cloud
    leave a partial last tile; r > 1 indexes the conditions by ``row //
    r``."""
    layers = _cnf_layers(card, cdim, b + n, time_scale)
    rng = np.random.RandomState(n + cdim)
    c = torch.from_numpy((rng.randn(b, n // r, cdim) * 0.3)
                         .astype(np.float32)).to(card)
    y = torch.from_numpy((rng.randn(b, n, 3) * 0.5).astype(np.float32))
    logp = torch.from_numpy((rng.randn(b, n, 1) * 0.1).astype(np.float32))
    y, logp = y.to(card), logp.to(card)
    T = torch.tensor(0.36, device=card)
    zero = torch.zeros_like(T)
    t0, t1 = (T, zero) if reverse else (zero, T)
    before = cnf.cnf_solve_logp.launches
    got, stats = cnf.cnf_solve_logp(layers, c, y, logp, t0, t1,
                                    return_stats=True)
    again = cnf.cnf_solve_logp(layers, c, y, logp, t0, t1)
    assert cnf.cnf_solve_logp.launches == before + 2
    ref, ref_stats = cnf.cnf_solve_logp_plain(layers, c, y, logp, t0, t1,
                                              return_stats=True)
    assert stats.tolist() == [ref_stats["steps"], ref_stats["accepted"]]
    for g, a, f in zip(got, again, ref):
        assert torch.equal(g, a)
        assert float((g - f).abs().max()) < tol
    if time_scale:
        truth = _rk4_logp_float64(layers, c, y, logp, float(t0), float(t1),
                                  512)
        err_kernel = max(float((g.double() - w).abs().max())
                         for g, w in zip(got, truth))
        err_plain = max(float((f.double() - w).abs().max())
                        for f, w in zip(ref, truth))
        assert err_kernel <= 1.25 * err_plain + 1e-6


def _maxrel(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-8))


def _adjoint_leaves(out):
    """y0, a0, dc and every parameter gradient of an adjoint result."""
    return [*out[:3], *[t for p in out[3] for v in p.values()
                        for t in v.values()]]


def _float32_spread(args, kw, r, plain, truth, orders=5):
    """Per leaf, the farthest (max-relative) the plain version in float32
    lies from ``truth``: ``plain``, its leaves in the given order of the
    rows, and ``orders`` seeded permutations of each cloud's condition
    rows (each with its r rows of y), the same math summed in other
    orders: the noise floor of float32 on these inputs."""
    layers, c, y1, a1, ap, t0, t1 = args
    spread = [_maxrel(g.double(), w) for g, w in zip(plain, truth)]
    for seed in range(orders):
        pc = torch.randperm(c.shape[1],
                            generator=torch.Generator().manual_seed(seed))
        py = (pc[:, None] * r + torch.arange(r)).reshape(-1)
        pc, py = pc.to(c.device), py.to(c.device)
        logp1 = kw["logp1"]
        out = cnf.cnf_adjoint_bwd_plain(
            layers, c[:, pc], y1[:, py], a1[:, py], ap[:, py], t0, t1,
            with_trace=kw["with_trace"],
            logp1=None if logp1 is None else logp1[:, py])
        leaves = _adjoint_leaves(out)
        leaves[0] = leaves[0][:, torch.argsort(py)]
        leaves[1] = leaves[1][:, torch.argsort(py)]
        leaves[2] = leaves[2][:, torch.argsort(pc)]
        spread = [max(s, _maxrel(g.double(), w))
                  for s, g, w in zip(spread, leaves, truth)]
    return spread


@pytest.mark.parametrize("with_trace", [False, True])
@pytest.mark.parametrize("b,n,r,cdim,time_scale", [
    (1, 60, 1, 32, 0.0), (2, 333, 1, 128, 20.0), (4, 231, 3, 64, 20.0),
    (8, 256, 4, 128, 0.0), (2, 40, 1, 6, 0.0), (2, 40, 1, 6, 20.0),
    (1, 1, 1, 32, 0.0), (8, 2048, 4, 128, 0.0), (4, 4096, 1, 32, 0.0),
    (2, 77, 1, 40, 20.0), (2, 50, 1, 144, 0.0)])
def test_cnf_adjoint_kernel_matches_plain(card, with_trace, b, n, r, cdim,
                                          time_scale):
    """The adjoint's backward-solve kernel against `cnf_adjoint_bwd_plain`
    with and without the trace: equal step counts, two runs bit-equal, y0,
    a0, dc and every parameter gradient within 2e-3 max-relative (the JAX
    package's gate for its kernel, tests/test_cnf.py:216-336), the field
    and its trace at t1 within 5e-5. 333, 231 and 77 rows a cloud leave a
    partial tile (16 rows with the trace, 32 without), one row a tile of
    one; r > 1 indexes the
    conditions in place, and at r = 3 a condition row's repeats straddle
    two blocks' rows; condition widths 6 and 40 are padded to the kernel's
    multiple of 16, and 144 takes two chunks of Wc's 128 staged columns;
    8 x 2,048 rows give each block about 8 tiles, and 4 x 4,096 rows at
    r = 1 about 124 condition rows, two chunks of the staged c^T Q.

    With time rows of scale 20 both are also held against the plain
    version in float64: in every leaf the kernel may lie at most 1.25
    times as far from it (plus 1e-6) as the plain version in float32 does
    in the worst of six row orders. Where that float32 spread itself
    reaches 2e-3 in a leaf, 2e-3 between two float32 solvers is below
    what float32 can hold, and the leaf's gate against the plain version
    is twice the spread (the width-6 case: a first-layer gate gradient of
    2e-4 against 0.7 for the largest leaf, a few 1e-3 from float64 in any
    order)."""
    layers = _cnf_layers(card, cdim, b + n, time_scale)
    rng = np.random.RandomState(n + cdim + 1)

    def rand(*shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32)).to(card)

    c = rand(b, n // r, cdim, scale=0.3)
    y1, a1 = rand(b, n, 3, scale=0.5), rand(b, n, 3, scale=0.3)
    ap = rand(b, n, 1, scale=0.3) if with_trace else torch.zeros(
        (b, n, 1), device=card)
    logp1 = rand(b, n, 1, scale=0.1) if with_trace else None
    args = (layers, c, y1, a1, ap, 0.0, 0.36)
    kw = dict(with_trace=with_trace, logp1=logp1)
    before = cnf.cnf_adjoint_bwd.launches
    got = cnf.cnf_adjoint_bwd(*args, **kw, return_stats=True)
    again = cnf.cnf_adjoint_bwd(*args, **kw)
    assert cnf.cnf_adjoint_bwd.launches == before + 2
    ref = cnf.cnf_adjoint_bwd_plain(*args, **kw, return_stats=True)
    stats, ref_stats = got[-1].tolist(), ref[-1]
    assert stats == [ref_stats["steps"], ref_stats["accepted"]]
    got_leaves, ref_leaves = _adjoint_leaves(got), _adjoint_leaves(ref)
    for g, a, f in zip(got_leaves, _adjoint_leaves(again), ref_leaves):
        assert g.shape == f.shape
        assert torch.equal(g, a)
    rels = [_maxrel(g, f) for g, f in zip(got_leaves, ref_leaves)]
    gates = [2e-3] * len(rels)
    if time_scale:
        f64 = [{k: {kk: t.double() for kk, t in v.items()}
                for k, v in p.items()} for p in layers]
        truth = _adjoint_leaves(cnf.cnf_adjoint_bwd_plain(
            f64, c.double(), y1.double(), a1.double(), ap.double(), 0.0,
            0.36, with_trace=with_trace,
            logp1=None if logp1 is None else logp1.double()))
        err = [_maxrel(g.double(), w) for g, w in zip(got_leaves, truth)]
        spread = _float32_spread(args, kw, r, ref_leaves, truth)
        print(f"adjoint cdim {cdim} trace {with_trace}: max-relative over "
              f"the leaves, kernel vs plain {max(rels):.3e}, kernel vs "
              f"float64 {max(err):.3e}, float32 spread {max(spread):.3e}; "
              f"worst kernel / spread "
              f"{max(e / s for e, s in zip(err, spread)):.3f}")
        for e, s in zip(err, spread):
            assert e <= 1.25 * s + 1e-6
        gates = [2e-3 if s < 2e-3 else 2 * s for s in spread]
    for rel, gate in zip(rels, gates):
        assert rel < gate, (rels, gates)
    f1, div1 = got[4][:2]
    assert _maxrel(f1, ref[4][0]) < 5e-5
    if with_trace:
        assert _maxrel(div1, ref[4][1]) < 5e-5
    else:
        assert float(div1.abs().max()) == 0.0
