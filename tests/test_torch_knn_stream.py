"""The streaming self k-NN (`csrc/knn.cu`: `knn_cells_kernel`,
`knn_scatter_kernel`, `knn_stream_kernel`), emulated in torch (`test_torch_knn_select.py:
emulate_stream`), on what makes it exact: the box bound never exceeds a
member's distance, the indices do not depend on the spatial order or on
the order in which tiles are walked, and clustered and ragged patches give
`knn_self_plain`'s indices at 1, 4 and 8 lanes a query.
"""

import numpy as np
import pytest
import torch
from test_torch_knn_select import (bound_bits, emulate_stream, keys_of,
                                   morton_order)

from puflow_torch.ops import knn as t_knn
from torch_threads import one_torch_thread  # noqa: F401


def _members_and_queries(kind, rng):
    """Boxes of 1-24 members each ``[boxes, m, 3]`` and queries
    ``[boxes, queries, 3]`` of one kind."""
    boxes, m, nq = 64, int(rng.randint(1, 25)), 16
    if kind == "grid":
        pts = rng.randint(-3, 4, (boxes, m, 3)).astype(np.float32)
        qs = rng.randint(-5, 6, (boxes, nq, 3)).astype(np.float32)
        return pts, qs
    if kind == "magnitudes":
        # both signs, each axis at its own scale from 1e-6 to 1e6
        scale = 10.0 ** rng.randint(-6, 7, (boxes, 1, 3))
        pts = (rng.randn(boxes, m, 3) * scale).astype(np.float32)
        qs = (rng.randn(boxes, nq, 3) * scale * 3).astype(np.float32)
        return pts, qs
    pts = rng.randn(boxes, m, 3).astype(np.float32)
    lo, hi = pts.min(1, keepdims=True), pts.max(1, keepdims=True)
    if kind == "inside":
        qs = lo + rng.rand(boxes, nq, 3) * (hi - lo)
    elif kind == "on":
        # each coordinate on a face, an edge or a corner of the box
        qs = np.where(rng.rand(boxes, nq, 3) < 0.5, lo, hi)
        inner = lo + rng.rand(boxes, nq, 3) * (hi - lo)
        qs = np.where(rng.rand(boxes, nq, 3) < 0.3, inner, qs)
    elif kind == "outside":
        qs = np.where(rng.rand(boxes, nq, 3) < 0.5,
                      lo - rng.rand(boxes, nq, 3) * 2,
                      hi + rng.rand(boxes, nq, 3) * 2)
    else:
        qs = rng.randn(boxes, nq, 3) * 2
    return pts, qs.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "inside", "on", "outside",
                                  "grid", "magnitudes"])
def test_box_bound_never_exceeds_a_members_distance(kind):
    """For boxes made from their members' own coordinates, the bound of a
    query, and of a box of queries, is at most the delta-form distance of
    every member to every query, bit for bit as the kernel rounds."""
    rng = np.random.RandomState(["random", "inside", "on", "outside",
                                 "grid", "magnitudes"].index(kind))
    for _ in range(20):
        pts, qs = _members_and_queries(kind, rng)
        p, q = torch.from_numpy(pts), torch.from_numpy(qs)
        lo, hi = p.amin(1, keepdim=True), p.amax(1, keepdim=True)
        # each query against each member: distance bits [boxes, nq, m]
        cand = torch.cat([p, torch.zeros_like(p[..., :1])], -1)[:, None]
        dist = keys_of(q[:, :, None], cand) >> 32
        point = bound_bits(q, q, lo, hi)                     # [boxes, nq]
        assert bool((point[..., None] <= dist).all())
        qlo, qhi = q.amin(1, keepdim=True), q.amax(1, keepdim=True)
        group = bound_bits(qlo, qhi, lo, hi)                 # [boxes, 1]
        assert bool((group <= point).all())
        if kind == "inside":
            assert bool((point == 0).all())


def _clustered(rng, b, n):
    pts = 0.5 + 1e-3 * rng.randn(b, n, 3)
    far = rng.rand(b, n, 1) < 0.03
    return np.where(far, rng.rand(b, n, 3) * 4 - 2, pts).astype(np.float32)


@pytest.mark.parametrize("lanes", [1, 4, 8])
def test_walk_is_order_independent(lanes):
    """Another spatial order (the shared-memory kernel's Morton order), no
    spatial order at all, and tiles walked in a shuffled order all give
    the plain version's indices; the sorted walk skips tiles."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.rand(1, 600, 3).astype(np.float32))
    ref = t_knn.knn_self_plain(x, 16)
    stats = {}
    assert torch.equal(emulate_stream(x, 16, lanes, tile=8, stats=stats),
                       ref)
    # (at 600 points a query's 16 neighbours are 3% of the patch)
    assert float(stats["walked"].double().mean()) < 0.6 * stats["tiles"]
    gen = torch.Generator().manual_seed(3)
    for kw in ({"order": morton_order(x)},
               {"order": torch.randperm(600, generator=gen)[None]},
               {"shuffle": gen}):
        assert torch.equal(emulate_stream(x, 16, lanes, tile=8, **kw), ref)


@pytest.mark.parametrize("lanes", [1, 4, 8])
@pytest.mark.parametrize("n,k,tile", [(300, 16, 32), (301, 16, 8),
                                      (263, 5, 4), (90, 16, 64)])
def test_clustered_and_ragged_patches(n, k, tile, lanes):
    """A dense cluster with a few far points, and float and integer-grid
    patches whose last tile is ragged, give the plain version's indices."""
    rng = np.random.RandomState(n + tile)
    for x in (_clustered(rng, 2, n), rng.rand(2, n, 3).astype(np.float32),
              rng.randint(0, 4, (2, n, 3)).astype(np.float32)):
        xt = torch.from_numpy(x)
        np.testing.assert_array_equal(
            emulate_stream(xt, k, lanes, tile=tile).numpy(),
            t_knn.knn_self_plain(xt, k).numpy())
