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
from puflow_torch.ops import flow
from puflow_torch.ops.fps import (farthest_point_sample,
                                  farthest_point_sample_plain)
from puflow_torch.ops.knn import knn_indices

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
        discrete.DiscreteModel(*discrete.init(gen)))
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
