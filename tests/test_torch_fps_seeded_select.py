"""The seeded-FPS selection of `csrc/fps.cu`, emulated on the CPU, against
the port's plain version and puflow_tpu's.

The kernel spreads a row over threads. A block of T threads a row
(`fps_seeded_block_kernel`): thread t holds the candidates t + k T. A
cluster of C blocks a row (`fps_cluster_kernel`, seeded start): block r
owns [r chunk, (r + 1) chunk), chunk = ceil(n / C), and its thread t holds
r chunk + t + k T. A thread keeps its candidates' cache (the distance to
the nearest seed, then to every pick) and takes its best in ascending
order with a strict '>' (the first on ties). A value's key is the bits of
max(v, +0) (a thread with no candidate: key 0, index INT_MAX); a warp
takes the largest key, then the lowest index among its holders (two
redux); the block does the same over its warps' slots, the cluster over
its blocks' slots. Each step selects first, then folds the pick in with
(dx*dx + dy*dy) + dz*dz. `emulate` runs that partition in numpy float32;
the tests hold it to `farthest_point_sample_seeded_plain`, to the Pallas
kernel in interpret mode on integer grids (every step has ties; its
expanded-form seeding is exact there) and to the XLA version on floats,
as tests/test_torch_merge.py splits them, including rows that run out of
distinct candidates, whose cache ends all zeros. The plan's choice is
tested with fake capacities.
"""

import functools

import numpy as np
import pytest
import torch

from puflow_torch.ops import fps as t_fps
from puflow_tpu.ops import fps as j_fps
from puflow_tpu.ops.pallas.fps_pallas import (
    farthest_point_sample_seeded_pallas,
)
from torch_threads import one_torch_thread  # noqa: F401

NONE = np.iinfo(np.int32).max
F32 = np.float32
FpsPlan = t_fps.FpsPlan
# (cluster, threads): a block a row at T = 128 and 256, clusters of 2 and 16
PLANS = [(1, 128), (1, 256), (2, 256), (16, 128)]


def sqdist(p, c):
    d = p - c
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return (x * x + y * y) + z * z


def thread_grid(n: int, cluster: int, threads: int) -> np.ndarray:
    """``[C, warps, 32, kK]``: the candidate each block, warp, lane and
    register slot holds (NONE past the block's range)."""
    chunk = -(-n // cluster)
    kk = max(1, -(-chunk // threads))
    rank = np.arange(cluster)[:, None, None]
    j = np.arange(threads)[None, :, None] + np.arange(kk)[None, None] * threads
    idx = rank * chunk + j
    idx = np.where((j < chunk) & (idx < n), idx, NONE)
    return idx.reshape(cluster, threads // 32, 32, kk)


def lowest_of_max(keys, idx, axis):
    """Largest key over ``axis``, then the lowest index among its holders
    (`fps.cu:warp_argmax_key`)."""
    best = keys.max(axis=axis, keepdims=True)
    return best.squeeze(axis), np.where(keys == best, idx, NONE).min(axis=axis)


def select(cache: np.ndarray, grid: np.ndarray) -> int:
    v = np.where(grid != NONE, cache[np.minimum(grid, len(cache) - 1)],
                 F32(-np.inf))
    k = np.argmax(v, axis=-1)[..., None]          # each thread's first best
    bv = np.take_along_axis(v, k, -1)[..., 0]
    bi = np.where(bv > -np.inf, np.take_along_axis(grid, k, -1)[..., 0], NONE)
    keys = np.maximum(bv, F32(0)).view(np.uint32)
    keys, bi = lowest_of_max(keys, bi, 2)         # warps
    keys, bi = lowest_of_max(keys, bi, 1)         # a block's slots
    _, bi = lowest_of_max(keys, bi, 0)            # the cluster's slots
    return int(bi)


def emulate(pts: np.ndarray, seeds: np.ndarray, m: int, cluster: int,
            threads: int) -> np.ndarray:
    """The kernel's selection for rows ``[R, n, 3]`` seeded by ``[R / G, S,
    3]`` -> ``[R, m]`` int32."""
    rows, n, _ = pts.shape
    groups = rows // len(seeds)
    grid = thread_grid(n, cluster, threads)
    out = np.zeros((rows, m), np.int32)
    for r in range(rows):
        p = pts[r]
        cache = sqdist(p[:, None], seeds[r // groups][None]).min(axis=1)
        for step in range(m):
            i = select(cache, grid)
            out[r, step] = i
            cache = np.fmin(cache, sqdist(p, p[i]))
    return out


def make_case(kind: str):
    """Two rows of 150 candidates, two seed sets of 33, as
    tests/test_torch_merge.py: integer grids (ties at every step), floats,
    and 27 distinct candidates with more picks than that."""
    rng = np.random.RandomState(
        {"integer": 2, "float": 3, "exhausted": 4}[kind])
    make = {"integer": lambda *s: rng.randint(0, 11, s),
            "float": lambda *s: rng.rand(*s),
            "exhausted": lambda *s: rng.randint(0, 3, s)}[kind]
    pts = make(2, 150, 3).astype(F32)
    seeds = make(2, 33, 3).astype(F32)
    return pts, seeds, {"integer": 20, "float": 40, "exhausted": 40}[kind]


@functools.lru_cache(maxsize=None)
def plain(kind: str) -> np.ndarray:
    pts, seeds, m = make_case(kind)
    return t_fps.farthest_point_sample_seeded_plain(
        torch.from_numpy(pts), torch.from_numpy(seeds), m).numpy()


@functools.lru_cache(maxsize=None)
def pallas(kind: str) -> np.ndarray:
    pts, seeds, m = make_case(kind)
    return np.asarray(farthest_point_sample_seeded_pallas(
        pts, seeds, m, interpret=True))


@pytest.mark.parametrize("kind", ["integer", "float", "exhausted"])
@pytest.mark.parametrize("cluster,threads", PLANS)
def test_emulation_is_plain(cluster, threads, kind):
    pts, seeds, m = make_case(kind)
    np.testing.assert_array_equal(emulate(pts, seeds, m, cluster, threads),
                                  plain(kind))


@pytest.mark.parametrize("kind", ["integer", "exhausted"])
@pytest.mark.parametrize("cluster,threads", PLANS)
def test_emulation_is_pallas_on_integers(cluster, threads, kind):
    pts, seeds, m = make_case(kind)
    np.testing.assert_array_equal(emulate(pts, seeds, m, cluster, threads),
                                  pallas(kind))


@pytest.mark.parametrize("cluster,threads", PLANS)
def test_emulation_is_xla_on_floats(cluster, threads):
    pts, seeds, m = make_case("float")
    ref = np.asarray(j_fps.farthest_point_sample_seeded_xla(pts, seeds, m))
    np.testing.assert_array_equal(emulate(pts, seeds, m, cluster, threads),
                                  ref)


def test_exhausted_rows_repeat_the_first_candidate():
    # once every cache value is +0 the lowest index wins every step
    pts, seeds, m = make_case("exhausted")
    got = plain("exhausted")
    assert len(np.unique(pts[0], axis=0)) < m
    assert (got[:, -5:] == 0).all()


def test_emulation_shares_seeds_across_rows():
    # six rows, two seed sets: rows 0-2 seeded by set 0, rows 3-5 by set 1
    rng = np.random.RandomState(5)
    pts = rng.rand(6, 70, 3).astype(F32)
    seeds = rng.rand(2, 9, 3).astype(F32)
    ref = t_fps.farthest_point_sample_seeded_plain(
        torch.from_numpy(pts), torch.from_numpy(seeds), 30).numpy()
    for cluster, threads in PLANS:
        np.testing.assert_array_equal(
            emulate(pts, seeds, 30, cluster, threads), ref)


def fake_capacity(plan: FpsPlan) -> int:
    """Rows at once on a card of 132 SMs: blocks of 512 threads three an SM,
    of 256 or 128 four; 16 clusters of 16 blocks, more of fewer."""
    if plan.cluster == 1:
        return 132 * (3 if plan.threads == 512 else 4)
    return 264 // plan.cluster


@pytest.mark.parametrize("rows,n,want", [
    (16, 2048, FpsPlan(1, 128)),      # auto G = 16, one cloud
    (512, 2048, FpsPlan(1, 128)),     # 32 clouds: 512 blocks of 128 at once
    (3, 150, FpsPlan(1, 128)),        # ragged
    (16, 4096, FpsPlan(1, 256)),      # 16 a thread at most
    (2, 8192, FpsPlan(1, 512)),       # the block kernel's largest row
    (1, 32768, FpsPlan(16, 128)),     # G = 1
    (32, 32768, FpsPlan(8, 128)),     # G = 1, 32 clouds
    (1, 79872, FpsPlan(16, 128)),     # the PU-GAN union
    (1, 188416, FpsPlan(16, 256)),    # the cluster kernel's largest row
    (1, 188417, t_fps.SEEDED_GLOBAL),
    (1, 200000, t_fps.SEEDED_GLOBAL)])
def test_seeded_plan_by_shape(rows, n, want):
    assert t_fps._fps_seeded_plan(rows, n, fake_capacity) == want


def test_seeded_plan_takes_a_larger_block_that_holds_every_row():
    def capacity(plan):     # three blocks of 128 an SM, four of 256
        return {128: 396, 256: 528, 512: 264}[plan.threads]

    assert t_fps._fps_seeded_plan(512, 2048, capacity) == FpsPlan(1, 256)
    assert t_fps._fps_seeded_plan(396, 2048, capacity) == FpsPlan(1, 128)


def test_seeded_plan_takes_the_fewest_waves():
    # 4,000 rows: no block size holds them all; 128 and 256 threads take
    # eight waves, 512 eleven
    assert t_fps._fps_seeded_plan(4000, 2048, fake_capacity) == FpsPlan(1, 128)
    # 600 rows of 32,768: every cluster takes waves; C = 2 cannot hold the
    # row in registers, C = 3 of 256 threads (88 at once) takes the fewest
    assert t_fps._fps_seeded_plan(600, 32768, fake_capacity) == FpsPlan(3, 256)


@pytest.mark.parametrize("plan,n", [
    (FpsPlan(1, 64), 2048), (FpsPlan(1, 1024), 2048), (FpsPlan(1, 128), 2049),
    (FpsPlan(2, 128), 32768), (FpsPlan(17, 128), 32768),
    (FpsPlan(16, 512), 32768), (FpsPlan(16, 256), 188417),
    (FpsPlan(-1, 128), 100)])
def test_forced_seeded_plan_the_kernels_do_not_take_raises(plan, n):
    with pytest.raises(ValueError, match="no kernel runs"):
        t_fps._fps_seeded_plan(1, n, fake_capacity, plan)


def test_forced_seeded_plan_is_taken_as_it_is():
    def never(plan):
        raise AssertionError("a forced plan needs no capacity")

    for plan, n in ((FpsPlan(1, 128), 2048), (FpsPlan(2, 128), 8192),
                    (t_fps.SEEDED_GLOBAL, 200000), (t_fps.SEEDED_GLOBAL, 5)):
        assert t_fps._fps_seeded_plan(1, n, never, plan) == plan
