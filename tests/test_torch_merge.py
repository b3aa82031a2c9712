"""The opt-in merges of the port against puflow_tpu's: seeded FPS and its
grouped, partitioned and Morton-cell variants, the unseeded Morton merge,
the voxel candidates, and the whole pipeline with each merge.

The same numpy inputs go through the JAX function (XLA on the CPU, or the
Pallas kernel in interpret mode) and its port, whose wrappers take their
plain versions on CPU tensors. The CUDA kernel is held to the same plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch import checkpoint as t_checkpoint
from puflow_torch.inference import patch as t_patch
from puflow_torch.models import discrete as t_discrete
from puflow_torch.ops import fps as t_fps
from puflow_tpu.checkpoint import _discrete_sample_fn
from puflow_tpu.inference import patch as j_patch
from puflow_tpu.models import discrete as j_discrete
from puflow_tpu.ops import fps as j_fps
from puflow_tpu.ops.pallas.fps_pallas import (
    farthest_point_sample_seeded_pallas,
)
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(a)


def _j(a):
    return jnp.asarray(a)


# --------------------------------------------------------------------------
# seeded FPS
# --------------------------------------------------------------------------

def test_seeded_plain_matches_greedy_oracle():
    # the numpy oracle of tests/test_ops.py:85-101: cache = distance to the
    # nearest seed, then select-then-update; indices exactly equal
    rng = np.random.RandomState(1)
    pts = rng.rand(60, 3).astype(np.float32)
    seeds = rng.rand(17, 3).astype(np.float32)
    m = 12
    dist = ((pts[:, None, :] - seeds[None, :, :]) ** 2).sum(-1).min(1)
    sel = []
    for _ in range(m):
        nxt = int(np.argmax(dist))
        sel.append(nxt)
        dist = np.minimum(dist, ((pts - pts[nxt]) ** 2).sum(-1))
    got = t_fps.farthest_point_sample_seeded_plain(_t(pts)[None],
                                                   _t(seeds)[None], m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[0], np.array(sel))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_plain_matches_xla_on_floats(seed):
    # both compute the delta form in the same order and XLA:CPU rounds it
    # the same way: indices exactly equal on random floats
    rng = np.random.RandomState(seed)
    pts = rng.rand(2, 160, 3).astype(np.float32)
    seeds = rng.rand(2, 33, 3).astype(np.float32)
    ref = np.asarray(j_fps.farthest_point_sample_seeded_xla(
        _j(pts), _j(seeds), 40))
    got = t_fps.farthest_point_sample_seeded_plain(_t(pts), _t(seeds), 40)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_seeded_plain_matches_pallas_interpret_on_integers():
    # tests/test_ops.py:103-122: integer coordinates make the kernel's
    # expanded-form seeding exact too; ragged N = 150, S = 33, and the
    # 11^3 grid forces duplicates (first-index ties)
    rng = np.random.RandomState(2)
    pts = rng.randint(0, 11, (2, 150, 3)).astype(np.float32)
    seeds = rng.randint(0, 11, (2, 33, 3)).astype(np.float32)
    ker = np.asarray(farthest_point_sample_seeded_pallas(
        _j(pts), _j(seeds), 20, interpret=True))
    got = t_fps.farthest_point_sample_seeded_plain(_t(pts), _t(seeds), 20)
    np.testing.assert_array_equal(got.numpy(), ker)


def test_seeded_plain_coverage_matches_pallas_interpret_on_floats():
    # tests/test_ops.py:124-157: on floats the kernel's expanded-form
    # seeding rounds near-ties differently, so the gates are the FPS
    # objective (coverage radius within 1.15x) and set overlap >= 0.7
    rng = np.random.RandomState(3)
    pts = rng.rand(2, 150, 3).astype(np.float32)
    seeds = rng.rand(2, 33, 3).astype(np.float32)
    m = 40
    ker = np.asarray(farthest_point_sample_seeded_pallas(
        _j(pts), _j(seeds), m, interpret=True))
    got = t_fps.farthest_point_sample_seeded_plain(_t(pts), _t(seeds),
                                                   m).numpy()

    def coverage(sel, b):
        chosen = np.concatenate([seeds[b], pts[b][sel]])
        d = ((pts[b][:, None] - chosen[None]) ** 2).sum(-1)
        return d.min(1).max()

    for b in range(2):
        overlap = len(set(got[b]) & set(ker[b])) / m
        assert overlap >= 0.7, f"cloud {b}: set overlap {overlap}"
        assert coverage(got[b], b) <= coverage(ker[b], b) * 1.15 + 1e-7


def test_seeded_wrapper_runs_plain_version_on_cpu_and_shares_seeds():
    # a CPU tensor takes the plain version (no launch); G rows a seed set
    # equal the seeds repeated G times
    rng = np.random.RandomState(4)
    pts = _t(rng.rand(6, 50, 3).astype(np.float32))
    seeds = _t(rng.rand(2, 9, 3).astype(np.float32))
    before = t_fps.farthest_point_sample_seeded.launches
    got = t_fps.farthest_point_sample_seeded(pts, seeds, 60)   # m > M
    assert t_fps.farthest_point_sample_seeded.launches == before
    rep = seeds.repeat_interleave(3, dim=0)
    np.testing.assert_array_equal(
        got.numpy(),
        t_fps.farthest_point_sample_seeded_plain(pts, rep, 60).numpy())
    ref = np.asarray(j_fps.farthest_point_sample_seeded_xla(
        _j(pts.numpy()), _j(rep.numpy()), 60))
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="seed sets"):
        t_fps.farthest_point_sample_seeded(pts, seeds[:, :0], 4)


# --------------------------------------------------------------------------
# grouped variants: exactly equal, each shape fallback where JAX takes it
# --------------------------------------------------------------------------

# M = 256: G = 3 does not divide M; G = 64 exceeds n_samples = 40;
# G = 6 does not divide M and is no power of two
GROUPS = [0, 1, 2, 3, 4, 6, 8, 64]


@pytest.mark.parametrize("variant", ["grouped", "partitioned", "morton"])
def test_seeded_grouped_variants_match_jax(variant):
    rng = np.random.RandomState(5)
    pts = rng.randn(2, 256, 3).astype(np.float32)
    seeds = rng.randn(2, 33, 3).astype(np.float32)
    j_fn = getattr(j_fps, f"farthest_point_sample_seeded_{variant}")
    t_fn = getattr(t_fps, f"farthest_point_sample_seeded_{variant}")
    exact = t_fps.farthest_point_sample_seeded_plain(_t(pts), _t(seeds), 40)
    for G in GROUPS:
        ref = np.asarray(j_fn(_j(pts), _j(seeds), 40, G, use_pallas=False))
        got = t_fn(_t(pts), _t(seeds), 40, G)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"G={G}")
        # the fallbacks return the exact seeded FPS
        falls_back = bool(G <= 1 or 256 % G or 40 < G or (
            variant == "partitioned" and G & (G - 1)))
        assert falls_back == np.array_equal(got.numpy(), exact.numpy()), G


def test_seeded_morton_keeps_duplicates_in_one_cell():
    # duplicated points (each twice) must land in one cell: the cell's FPS
    # then never returns both copies of a point
    rng = np.random.RandomState(6)
    base = rng.rand(1, 64, 3).astype(np.float32)
    pts = np.concatenate([base, base[:, ::-1]], axis=1)        # [1, 128, 3]
    seeds = rng.rand(1, 5, 3).astype(np.float32)
    ref = np.asarray(j_fps.farthest_point_sample_seeded_morton(
        _j(pts), _j(seeds), 48, 4, use_pallas=False))
    got = t_fps.farthest_point_sample_seeded_morton(_t(pts), _t(seeds), 48,
                                                    4).numpy()
    np.testing.assert_array_equal(got, ref)
    picked = pts[0][got[0]]
    assert len(np.unique(picked, axis=0)) == 48


@pytest.mark.parametrize("n_samples", [40, 300])
def test_unseeded_morton_matches_jax(n_samples):
    # n_samples = 300 > M = 256: ceil(n / G) exceeds a cell's candidates,
    # the last fallback, whole-cloud FPS
    rng = np.random.RandomState(7)
    pts = rng.randn(2, 256, 3).astype(np.float32)
    whole = t_fps.farthest_point_sample_plain(_t(pts), n_samples).numpy()
    for G in GROUPS:
        ref = np.asarray(j_fps.farthest_point_sample_morton(
            _j(pts), n_samples, G, use_pallas=False))
        got = t_fps.farthest_point_sample_morton(_t(pts), n_samples, G)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"G={G}")
        falls_back = bool(G <= 1 or 256 % G or n_samples < G
                          or -(-n_samples // G) > 256 // G)
        assert falls_back == np.array_equal(got.numpy(), whole), G


def test_morton_key_matches_jax():
    rng = np.random.RandomState(8)
    pts = np.concatenate([rng.randn(2, 500, 3),
                          rng.randint(0, 4, (2, 100, 3))], axis=1)
    pts = pts.astype(np.float32)
    pts[1] = 0.25                        # a flat cloud: hi - lo = 0
    ref = np.asarray(j_fps._morton_key(_j(pts)))
    got = t_fps._morton_key(_t(pts)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


# --------------------------------------------------------------------------
# voxel pre-reduction, auto grouping
# --------------------------------------------------------------------------

def _overlapped_union(seed=0):
    """5x overlapped union of 1,024 sphere points, and its reverse, like
    the patch-merge input (tests/test_inference.py:145-172)."""
    rng = np.random.RandomState(seed)
    base = rng.randn(1024, 3).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    pts = np.concatenate(
        [base + rng.randn(1024, 3).astype(np.float32) * 1e-3
         for _ in range(5)], 0)
    return np.stack([pts, pts[::-1]])                        # [2, 5120, 3]


@pytest.mark.parametrize("n_cand,grid", [(2560, 256), (6000, 256),
                                         (1000, 64)])
def test_voxel_candidates_match_jax(n_cand, grid):
    # n_cand = 6000 exceeds the occupied voxels: the tail stays point 0
    clouds = _overlapped_union()
    hash_size = 4 * clouds.shape[1]
    ref = np.asarray(jax.vmap(lambda p: j_patch._voxel_candidates(
        p, n_cand, grid, hash_size))(_j(clouds)))
    got = t_patch._voxel_candidates(_t(clouds), n_cand, grid, hash_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_merge_patches_approx_invariants():
    """tests/test_inference.py:145-172 on the port: outputs are original
    points (nothing snapped), all distinct, and within CD 5e-4 of the
    exact merge; and equal to JAX's."""
    clouds = _overlapped_union()
    exact = t_patch.merge_patches(_t(clouds), 1024).numpy()
    approx = t_patch.merge_patches_approx(_t(clouds), 1024, 2560).numpy()
    ref = np.asarray(j_patch.merge_patches_approx(_j(clouds), 1024, 2560))
    np.testing.assert_array_equal(approx, ref)
    for b in range(2):
        d = np.abs(approx[b][:, None, :] - clouds[b][None]).sum(-1).min(1)
        assert d.max() == 0.0
        assert len(np.unique(approx[b], axis=0)) == approx[b].shape[0]
        dd = ((approx[b][:, None] - exact[b][None]) ** 2).sum(-1)
        cd = dd.min(1).mean() + dd.min(0).mean()
        assert cd < 5e-4, cd


def test_auto_merge_groups_rule():
    # tests/test_inference.py:175-190
    cases = {8192: 1, 16383: 1, 16384: 8, 32768: 16, 79872: 16, 20480: 10}
    for m, g in cases.items():
        assert t_patch.auto_merge_groups(m) == g == j_patch.auto_merge_groups(m)
        assert m % g == 0


# --------------------------------------------------------------------------
# the whole pipeline with each merge
# --------------------------------------------------------------------------

N, PATCH, R, OUTLIERS = 512, 64, 4, 24
NPOINT = N * R + OUTLIERS


@pytest.fixture(scope="module")
def pipeline_inputs():
    params, state = j_discrete.init(jax.random.PRNGKey(0))
    params, state = t_discrete.perturb_init(jax.tree.map(np.array, params),
                                            jax.tree.map(np.array, state), 3)
    rng = np.random.RandomState(0)
    pts = rng.randn(1, N, 3).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    return (jax.tree.map(jnp.asarray, (params, state)),
            t_checkpoint.from_numpy_tree(params, state, "cpu"), pts)


@pytest.mark.parametrize("merge", [
    dict(seeded_merge=True, merge_groups=1),
    dict(seeded_merge=True, merge_groups=4),
    dict(merge_groups=4),
    dict(merge_candidates=4096)])
def test_opt_in_merges_match_jax(pipeline_inputs, merge):
    """`upsample_cloud` + `remove_outliers` on the 512-point cloud of
    tests/test_torch_pipeline.py with each opt-in merge, against JAX's on
    the same parameters. Gate: CD below 1.5e-3, the repo's pipeline gate
    (tests/test_pipeline_parity.py:177-199); the union merge measures
    8.6e-11."""
    jax_params, model, pts = pipeline_inputs
    args = (merge.get("merge_candidates"), merge.get("seeded_merge", False),
            merge.get("merge_groups", 0))
    cloud = jnp.asarray(pts)
    ref = j_patch.upsample_cloud(jax_params, cloud, _discrete_sample_fn,
                                 NPOINT, R, PATCH, 4.0, *args)
    ref = np.asarray(j_patch.remove_outliers(ref, cloud, OUTLIERS))
    pc = _t(pts)
    got = t_patch.upsample_cloud(model, pc, NPOINT, R, PATCH, 4.0, *args)
    got = t_patch.remove_outliers(got, pc, OUTLIERS).numpy()
    assert got.shape == ref.shape == (1, N * R, 3)
    assert np.isfinite(got).all()
    d = ((got[0][:, None, :] - ref[0][None, :, :]) ** 2).sum(-1)
    cd = d.min(1).mean() + d.min(0).mean()
    print(f"{merge}: CD to JAX {cd:.3e}")
    assert cd < 1.5e-3, f"port pipeline diverges from JAX: CD={cd}"
    if merge.get("seeded_merge"):
        # every original is emitted (before outlier removal)
        full = t_patch.upsample_cloud(model, pc, NPOINT, R, PATCH, 4.0,
                                      *args).numpy()
        d = ((full[0][:, None, :] - pts[0][None]) ** 2).sum(-1).min(0)
        assert d.max() < 1e-10
