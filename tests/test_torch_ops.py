"""puflow_torch geometry ops and checkpoints against puflow_tpu.

The same numpy inputs go through the JAX function and its port; the
port's FPS wrapper takes its plain version on CPU tensors, so these tests
check that plain version (its CUDA kernel is compared with it on the card
by chip_smoke.py and tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.models import discrete as t_discrete
from puflow_torch.ops import chamfer as t_chamfer
from puflow_torch.ops import fps as t_fps
from puflow_torch.ops import knn as t_knn
from puflow_tpu import checkpoint as j_checkpoint
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.ops import chamfer as j_chamfer
from puflow_tpu.ops import fps as j_fps
from puflow_tpu.ops import knn as j_knn
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("k", [8, 16])
def test_knn_indices_match_jax(k):
    rng = np.random.RandomState(k)
    q = rng.rand(2, 40, 3).astype(np.float32)
    p = rng.rand(2, 70, 3).astype(np.float32)
    j_idx, j_d = j_knn.knn_indices(jnp.asarray(q), jnp.asarray(p), k,
                                   return_dist=True)
    t_idx, t_d = t_knn.knn_indices(torch.from_numpy(q), torch.from_numpy(p),
                                   k, return_dist=True)
    # sets compared sorted: tie order may differ between the packages
    np.testing.assert_array_equal(np.sort(np.asarray(j_idx), axis=-1),
                                  np.sort(t_idx.numpy(), axis=-1))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), atol=1e-6)
    # ascending order: the first 8 columns of K=16 are the K=8 graph
    assert (np.diff(t_d.numpy(), axis=-1) >= 0).all()


def test_self_knn_prefix_is_smaller_graph():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(2, 64, 3).astype(np.float32))
    idx16 = t_knn.knn_indices(x, x, 16)
    idx8 = t_knn.knn_indices(x, x, 8)
    np.testing.assert_array_equal(idx16[..., :8].numpy(), idx8.numpy())
    np.testing.assert_array_equal(idx8[..., 0].numpy(),
                                  np.broadcast_to(np.arange(64), (2, 64)))


def test_gather_points_and_chamfer_parts_match_jax():
    rng = np.random.RandomState(4)
    x = rng.rand(2, 50, 3).astype(np.float32)
    y = rng.rand(2, 30, 3).astype(np.float32)
    idx = rng.randint(0, 30, (2, 7, 5))
    np.testing.assert_allclose(
        t_knn.gather_points(torch.from_numpy(y), torch.from_numpy(idx)),
        np.asarray(j_knn.gather_points(jnp.asarray(y), jnp.asarray(idx))),
        atol=1e-6)
    j_parts = j_chamfer.chamfer_parts(jnp.asarray(x), jnp.asarray(y))
    t_parts = t_chamfer.chamfer_parts(torch.from_numpy(x),
                                      torch.from_numpy(y))
    for j, t in zip(j_parts, t_parts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


@pytest.mark.parametrize("shape,m", [((2, 150, 3), 40), ((1, 600, 3), 200)])
def test_fps_plain_matches_xla_on_integer_clouds(shape, m):
    # integer coordinates make every distance exact, and the 11^3 grid
    # forces duplicates, so indices must agree position by position,
    # first-occurrence ties included
    rng = np.random.RandomState(m)
    pts = rng.randint(0, 11, shape).astype(np.float32)
    ref = np.asarray(j_fps.farthest_point_sample_xla(jnp.asarray(pts), m))
    got = t_fps.farthest_point_sample_plain(torch.from_numpy(pts), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fps_plain_coverage_matches_xla_on_floats():
    # on random floats the XLA reduction order may round a near-tie the
    # other way, so the invariant is the FPS objective: the coverage radius
    rng = np.random.RandomState(5)
    pts = rng.rand(2, 300, 3).astype(np.float32)
    m = 64
    ref = np.asarray(j_fps.farthest_point_sample_xla(jnp.asarray(pts), m))
    got = t_fps.farthest_point_sample_plain(torch.from_numpy(pts), m).numpy()

    def coverage(sel, b):
        d = ((pts[b][:, None] - pts[b][sel][None]) ** 2).sum(-1)
        return d.min(1).max()

    for b in range(2):
        np.testing.assert_allclose(coverage(got[b], b), coverage(ref[b], b),
                                   rtol=1e-6)


def test_fps_plain_matches_xla_on_repeated_half():
    # the card tests' tie cloud at the merge's size: every point ties
    # exactly with its copy N / 2 later, and the lower index must win
    rng = np.random.RandomState(34816)
    half = rng.randint(0, 64, (1, 34816 // 2, 3))
    pts = np.concatenate([half, half], 1).astype(np.float32)
    ref = np.asarray(j_fps.farthest_point_sample_xla(jnp.asarray(pts), 600))
    got = t_fps.farthest_point_sample_plain(torch.from_numpy(pts), 600)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref < 34816 // 2).all()


MERGE_N = 34816          # 32 patches x 256 x 4 + the 2,048 originals
# Clusters of each plan at MERGE_N that an H100 holds at once
# (cudaOccupancyMaxActiveClusters, as chip_smoke.py's compare_fps logs it
# on an NVIDIA H100 80GB HBM3 at 700 W); a plan that does not hold the
# cloud is not listed
H100_CLUSTERS = {
    (3, 256): 39, (4, 256): 30, (5, 256): 22, (6, 128): 39, (6, 256): 17,
    (7, 128): 32, (7, 256): 15, (8, 128): 30, (8, 256): 30, (9, 128): 23,
    (9, 256): 23, (10, 128): 21, (10, 256): 21, (11, 128): 16,
    (11, 256): 16, (12, 128): 28, (12, 256): 16, (13, 128): 23,
    (13, 256): 14, (14, 128): 21, (14, 256): 14, (15, 128): 21,
    (15, 256): 14, (16, 128): 28, (16, 256): 21}


def h100_capacity(plan):
    return H100_CLUSTERS.get(tuple(plan), 0)


# (clouds, candidates, plan): the seed pick, the merge, and the grouped
# union's 16 Morton cells a cloud at 1 and 32 clouds; the merges' plans
# are the ones the card chose in chip_smoke.py's run
@pytest.mark.parametrize("b,n,expected", [
    (1, 2048, (1, 1024)), (8, 2048, (1, 1024)), (32, 2048, (1, 1024)),
    (1, MERGE_N, (16, 128)), (8, MERGE_N, (16, 128)), (32, MERGE_N, (7, 128)),
    (16, 2176, (1, 1024)), (512, 2176, (1, 1024))])
def test_fps_plan_by_shape(b, n, expected):
    plan = t_fps._fps_plan(b, n, h100_capacity)
    assert plan == expected
    assert 1 <= plan.cluster <= 16
    assert t_fps._plan_covers(plan, n)
    if plan.cluster > 1:    # all the batch's clusters at once, in registers
        assert h100_capacity(plan) >= b
        per = -(-(-(-n // plan.cluster)) // plan.threads)
        assert per <= t_fps._CLUSTER_PER_THREAD[plan.threads]
    else:
        assert plan == t_fps.ONE_BLOCK


def test_fps_plan_keeps_one_block_where_a_cluster_cannot_help():
    # no cluster holds the batch at once; the cache needs the global scratch
    assert t_fps._fps_plan(100, MERGE_N, h100_capacity) == t_fps.ONE_BLOCK
    assert t_fps._fps_plan(1, 60000, h100_capacity) == t_fps.ONE_BLOCK
    # plans that no kernel takes
    assert not t_fps._plan_covers(t_fps.FpsPlan(17, 256), 10000)
    assert not t_fps._plan_covers(t_fps.FpsPlan(2, 256), 60000)
    assert not t_fps._plan_covers(t_fps.FpsPlan(4, 64), 1000)


def test_fps_wrapper_runs_plain_version_on_cpu():
    rng = np.random.RandomState(6)
    pts = torch.from_numpy(rng.rand(3, 100, 3).astype(np.float32))
    before = t_fps.farthest_point_sample.launches
    np.testing.assert_array_equal(
        t_fps.farthest_point_sample(pts, 20).numpy(),
        t_fps.farthest_point_sample_plain(pts, 20).numpy())
    assert t_fps.farthest_point_sample.launches == before


def _jax_numpy_init(seed):
    params, state = j_discrete.init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.array, params), jax.tree.map(np.array, state)


def test_npz_roundtrip_between_packages(tmp_path):
    params, state = _jax_numpy_init(0)
    t_discrete.perturb_init(params, state, 0)
    path = str(tmp_path / "jax.npz")
    j_checkpoint.save_checkpoint(path, params, state)
    model = t_checkpoint.load_checkpoint(path, "cpu")
    p2, s2 = t_checkpoint.to_numpy_tree(model)
    jax.tree.map(np.testing.assert_array_equal, (p2, s2), (params, state))

    path2 = str(tmp_path / "port.npz")
    t_checkpoint.save_checkpoint(path2, p2, s2)
    p3, s3 = j_checkpoint.load_npz_checkpoint(path2)
    jax.tree.map(np.testing.assert_array_equal, (p3, s3), (params, state))
