"""The self k-NN kernel's selection (`csrc/knn.cu`), emulated in torch,
against JAX's `knn_self_pallas` in interpret mode and `knn_self_plain`.

The emulation follows the kernel where its choices could change a value:
packed keys ``bits(d) << 32 | index`` from delta-form float32 distances;
the patch's Morton order (bounding box, as many code bits an axis as a
32-bit word leaves beside the index, the code | index words sorted); each
warp's outward walk from its centre, split into streams over L lanes a
query (1 or 4), a full step for every stream then one partial step; a
lane's first KL keys sorted into its list (KL the power of two at least
k) when its streams are that long; the insertion chain of 64-bit min /
max over the list; the lanes' bitonic merge with their xor partners; rows
written at each query's own index. At one lane a query and k = 16 the
kernel first walks on narrow 32-bit keys (distance bits with the low ones
replaced by the place): `emulate_narrow` follows it, and where a warp's
lists decide the 16 nearest its indices must be exact. The warp vote only skips chains that
change nothing, so it is not emulated. Inputs: float patches, integer
grids (many exact ties), and patches whose second half repeats the first
(distance-0 ties: slot 0 is the lower index, not always the point
itself). The streaming kernels for patches over shared memory
(`knn_cells_kernel`, `knn_scatter_kernel`, `knn_stream_kernel`) share
the keys, the chain and the merge; their order, tile boxes, bound tests
and bars: `emulate_stream`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.ops import knn as t_knn
from puflow_tpu.ops.pallas import knn_pallas
from torch_threads import one_torch_thread  # noqa: F401

NONE = torch.iinfo(torch.int64).max     # above every key: an empty slot
THREADS = 256                            # a block of the kernel


def _spread3(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_order(x):
    """``[B, n, 3]`` -> ``[B, n]``: each patch's indices in the kernel's
    walk order (`stage_sorted`)."""
    B, n, _ = x.shape
    lo, hi = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
    ib = n.bit_length()
    cb = min(10, (32 - ib) // 3)
    top = torch.tensor(float((1 << cb) - 1))
    extent = (hi - lo).amax(-1, keepdim=True)               # [B, 1, 1]
    scale = torch.where(extent > 0, top / extent, torch.zeros(()))
    q = torch.clamp((x - lo) * scale, min=0.0).minimum(top).to(torch.int64)
    code = sum(_spread3(q[..., c]) << (2 - c) for c in range(3))
    words = code << ib | torch.arange(n)
    return torch.argsort(words, dim=1)


def keys_of(q, c):
    """Packed keys of candidates ``c`` ``[B, Q, 4]`` (x, y, z, index) for
    queries ``q`` ``[B, Q, 3]``."""
    d = None
    for a in range(3):
        delta = c[..., a] - q[..., a]
        sq = delta * delta
        d = sq if d is None else d + sq
    bits = d.contiguous().view(torch.int32).to(torch.int64)
    return bits << 32 | c[..., 3].to(torch.int64)


def chain(lists, key):
    """The insertion chain over ``lists`` ``[B, Q, KL]`` (in place)."""
    for j in range(lists.shape[-1]):
        lo = torch.minimum(key, lists[..., j])
        key = torch.maximum(key, lists[..., j])
        lists[..., j] = lo


def bitonic_clean(lists):
    KL = lists.shape[-1]
    s = KL // 2
    while s:
        for j in range(KL):
            if j & s == 0:
                lo = torch.minimum(lists[..., j], lists[..., j + s])
                lists[..., j + s] = torch.maximum(lists[..., j],
                                                  lists[..., j + s])
                lists[..., j] = lo
        s //= 2


def merge_lanes(lists):
    """The lanes' bitonic merge with their xor partners: the list every
    lane of a query ends with."""
    lanes, m = len(lists), 1
    while m < lanes:
        merged = []
        for s in range(lanes):
            a, b = lists[s], lists[s ^ m]
            c = torch.minimum(a, b.flip(-1))
            bitonic_clean(c)
            merged.append(c)
        lists = merged
        m *= 2
    for lst in lists[1:]:                    # every lane ends with the list
        assert torch.equal(lst, lists[0])
    return lists[0]


def emulate(x, k, lanes):
    """The kernel's indices for ``x`` ``[B, n, 3]`` with ``lanes`` lanes a
    query."""
    B, n, _ = x.shape
    KL = 1 << (k - 1).bit_length()
    warp_q = 32 // lanes
    D = max(lanes, 2)                    # streams a query
    S = D // lanes                       # streams a lane
    order = morton_order(x)
    pts = torch.cat([torch.gather(x, 1, order[..., None].expand(-1, -1, 3)),
                     order[..., None].to(x.dtype)], -1)     # [B, n, 4]
    p = torch.arange(n)
    centre = torch.clamp(p // warp_q * warp_q + warp_q // 2, max=n - 1)
    q = pts[..., :3]
    full = n // D
    lists, seen = [], torch.zeros(n, n, dtype=torch.int64)
    # the first KL keys of a lane fill its list, sorted, when every
    # stream has that many
    first = KL // S if full >= KL // S else 0
    for s in range(lanes):
        lst = torch.full((B, n, KL), NONE, dtype=torch.int64)
        fill = []
        for i in range(full + (full * D < n)):
            for u in range(S):
                t = s * S + u + D * i
                if t >= n:                   # the partial step's idle lane
                    chain(lst, torch.full((B, n), NONE, dtype=torch.int64))
                    continue
                off = (t + 1) // 2 if t & 1 else -(t // 2)
                pos = (centre + off) % n
                seen[p, pos] += 1
                key = keys_of(q, pts[:, pos])
                if i < first:
                    fill.append(key)
                else:
                    chain(lst, key)
            if first and i == first - 1:
                lst = torch.sort(torch.stack(fill, -1), -1).values
        lists.append(lst)
    # every query meets every candidate once
    assert bool((seen == 1).all())
    idx = merge_lanes(lists)[..., :k] & 0xFFFFFFFF
    out = torch.empty_like(idx)
    out.scatter_(1, order[..., None].expand(-1, -1, k), idx)
    return out


def emulate_narrow(x):
    """The kernel's walk on narrow keys (one lane a query, k = 16):
    ``(indices [B, n, 16], the warps [B, n // 32] (ragged: ceil) whose
    lists decide nothing, which the exact walk redoes)``."""
    B, n, _ = x.shape
    ib = n.bit_length()
    place_bits = (1 << ib) - 1
    order = morton_order(x)
    pts = torch.cat([torch.gather(x, 1, order[..., None].expand(-1, -1, 3)),
                     order[..., None].to(x.dtype)], -1)
    p = torch.arange(n)
    centre = torch.clamp(p // 32 * 32 + 16, max=n - 1)
    q = pts[..., :3]

    def narrow(pos):
        exact = keys_of(q, pts[:, pos])
        return (exact >> 32) & ~place_bits | pos

    a = []
    for t in range(16):                  # down 0, up 1, down 2, ...
        off = (t + 1) // 2 if t & 1 else -(t // 2)
        a.append(narrow((centre + off) % n))
    a = torch.sort(torch.stack(a, -1), -1).values
    a = torch.cat([a, torch.full((B, n, 2), NONE, dtype=torch.int64)], -1)
    for t in range(16, n):
        off = (t + 1) // 2 if t & 1 else -(t // 2)
        chain(a, narrow((centre + off) % n))
    part = a >> ib
    same = part[..., 1:] == part[..., :-1]                 # [B, n, 17]
    tie3 = (same[..., 1:] & same[..., :-1]).any(-1)        # [B, n]
    warps = -(-n // 32)
    pad = torch.zeros(B, warps * 32 - n, dtype=torch.bool)
    undecided = torch.cat([tie3, pad], 1).reshape(B, warps, 32).any(-1)
    place = a & place_bits
    for j in range(17):
        ej = keys_of(q, torch.gather(pts, 1, place[..., j, None].expand(
            -1, -1, 4)))
        ek = keys_of(q, torch.gather(pts, 1, place[..., j + 1, None].expand(
            -1, -1, 4)))
        swap = same[..., j] & (ek < ej)
        pj, pk = place[..., j].clone(), place[..., j + 1].clone()
        place[..., j] = torch.where(swap, pk, pj)
        place[..., j + 1] = torch.where(swap, pj, pk)
    idx = torch.gather(order, 1, place[..., :16].reshape(B, -1)).reshape(
        B, n, 16)
    out = torch.empty_like(idx)
    out.scatter_(1, order[..., None].expand(-1, -1, 16), idx)
    # a query's warp is that of its place in the walk order
    warp_of = torch.empty_like(order)
    warp_of.scatter_(1, order, (p // 32).expand(B, -1))
    return out, undecided, torch.gather(undecided, 1, warp_of)


STREAM_TILE = 32                         # csrc/knn.cu:kTile
STREAM_CELL_BITS = 5                     # csrc/knn.cu:kMaxCellBits


def stream_order(x):
    """``[B, n, 3]`` -> ``[B, n]``: the streaming kernels' order
    (`knn_cells_kernel`, `knn_scatter_kernel`), the Morton code of each
    point's cell in a grid of 2^g cells an axis over the patch's box (g
    from n), by index within a cell (the kernels' order within a cell is
    whatever their atomics give: only the keys decide)."""
    B, n, _ = x.shape
    g = 1
    while g < STREAM_CELL_BITS and (1 << (3 * g)) < n:
        g += 1
    lo = x.amin(1, keepdim=True)
    extent = (x.amax(1, keepdim=True) - lo).amax(-1, keepdim=True)
    scale = torch.where(extent > 0, float(1 << g) / extent, torch.zeros(()))
    v = ((x - lo) * scale).to(torch.int64).clamp(max=(1 << g) - 1)
    code = sum(_spread3(v[..., c]) << (2 - c) for c in range(3))
    return torch.argsort(code * n + torch.arange(n), dim=1)


def bound_bits(qlo, qhi, lo, hi):
    """`csrc/knn.cu:bound_bits`: the float32 bits (as int64) of the lower
    bound of the delta-form distance between a point of the box [qlo, qhi]
    and one of [lo, hi], in the kernel's order and rounding."""
    zero = torch.zeros((), dtype=lo.dtype)
    g = torch.where(qhi < lo, lo - qhi, torch.where(qlo > hi, qlo - hi, zero))
    d = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    return d.contiguous().view(torch.int32).to(torch.int64)


def outward(centre, tiles):
    """``[W]`` centres -> ``[W, tiles]``: each warp's tiles in the walk's
    order: its own, then +1, -1, +2, -2, ..., then on along the longer
    side."""
    t = torch.arange(tiles)
    below, above = centre[:, None], tiles - 1 - centre[:, None]
    both = torch.minimum(below, above)
    e = t - 2 * both
    near = torch.where(t % 2 == 1, below + (t + 1) // 2, below - t // 2)
    far = torch.where(below > above, below - both - e, below + both + e)
    return torch.where(e <= 0, near, far)


def bar_of(lists, lanes):
    """`csrc/knn.cu:bar_of`: each lane's bar ``[..., L]`` from its list
    ``[..., L, KL]``: its last key, at L > 1 also the largest of the J-th
    keys of the query's lanes (J = KL / L, at least 1)."""
    KL = lists.shape[-1]
    if lanes == 1:
        return lists[..., KL - 1]
    j = max(KL // lanes, 1)
    top = lists[..., j - 1].amax(-1, keepdim=True)
    return torch.minimum(top, lists[..., KL - 1])


def emulate_stream(x, k, lanes, tile=STREAM_TILE, order=None, shuffle=None,
                   stats=None):
    """`puflow_knn_self_stream`'s indices: the patch in ``order`` (default
    `stream_order`), a box a tile of ``tile`` points from its members; a
    warp of 32 / L consecutive queries walks its own tile into its lists,
    then the others outwards (``shuffle``, a generator: in a random order
    instead), 32 at a time: a tile is walked unless the lower bound of the
    warp's query box exceeds every lane's bar, or each query's bound its
    lanes' bars; lane s takes candidates s, s + L, ... of a tile, each
    held to its bar at L > 1; then the lanes' merge. ``stats``, a dict,
    gets the tiles walked per query."""
    B, n, _ = x.shape
    KL = 1 << (k - 1).bit_length()
    wq = 32 // lanes                         # queries a warp
    if order is None:
        order = stream_order(x)
    pts = torch.cat([torch.gather(x, 1, order[..., None].expand(-1, -1, 3)),
                     order[..., None].to(x.dtype)], -1)     # [B, n, 4]
    tiles = -(-n // tile)
    pad = tiles * tile - n
    inf = torch.full((B, pad, 3), float("inf"))
    lo = torch.cat([pts[..., :3], inf], 1).reshape(B, tiles, tile, 3).amin(2)
    hi = torch.cat([pts[..., :3], -inf], 1).reshape(B, tiles, tile, 3).amax(2)
    warps = -(-n // wq)
    place = torch.arange(warps * wq).clamp(max=n - 1)
    q = pts[:, place].reshape(B, warps, wq, 1, 4)            # a lane's query
    wlo, whi = q[..., :3].amin((2, 3)), q[..., :3].amax((2, 3))
    centre = (torch.arange(warps) * wq + wq // 2).clamp(max=n - 1) // tile
    seq = outward(centre, tiles)                             # [W, tiles]
    if shuffle is not None:
        for w in range(warps):
            rest = seq[w, 1:]
            seq[w, 1:] = rest[torch.randperm(tiles - 1, generator=shuffle)]
    lists = torch.full((B, warps, wq, lanes, KL), NONE, dtype=torch.int64)
    lane = torch.arange(lanes)
    walked = torch.zeros(B, warps, dtype=torch.int64)

    def walk(tiles_now, go, held):
        # tiles_now [W]: each warp's tile; go [B, W]: whether it walks
        nonlocal bar
        base = tiles_now * tile
        m = (n - base).clamp(max=tile)
        for f in range(-(-tile // lanes)):
            j = f * lanes + lane                             # [L]
            pos = (base[:, None] + j).clamp(max=n - 1)       # [W, L]
            cand = pts[:, pos][:, :, None]                   # [B, W, 1, L, 4]
            key = keys_of(q[..., :3], cand)
            ok = (j < m[:, None])[None, :, None] & go[:, :, None, None]
            if held:
                ok = ok & (key < bar)
            chain(lists, torch.where(ok, key, NONE))
        bar = bar_of(lists, lanes)

    bar = None
    walk(seq[:, 0], torch.ones(B, warps, dtype=torch.bool), False)
    walked += 1
    for t0 in range(0, tiles, 32):
        most = (bar >> 32).amax((2, 3))                      # [B, W]
        group = seq[:, t0:t0 + 32]
        valid = group != seq[:, :1]                          # not its own
        need = valid & (bound_bits(wlo[:, :, None], whi[:, :, None],
                                   lo[:, group], hi[:, group])
                        <= most[..., None])                  # [B, W, 32]
        for i in range(group.shape[1]):
            tl = group[:, i]
            skip = (bound_bits(q[..., :3], q[..., :3],
                               lo[:, tl][:, :, None, None],
                               hi[:, tl][:, :, None, None])
                    > bar >> 32).all(-1).all(-1)             # [B, W]
            go = need[..., i] & ~skip
            walked += go
            walk(tl, go, lanes > 1)
    if stats is not None:
        stats["tiles"] = tiles
        stats["walked"] = walked
    out = merge_lanes([lists[..., s, :] for s in range(lanes)])
    idx = out.reshape(B, warps * wq, KL)[:, :n, :k] & 0xFFFFFFFF
    res = torch.empty_like(idx)
    res.scatter_(1, order[..., None].expand(-1, -1, k), idx)
    return res


def _patches(kind, n):
    rng = np.random.RandomState(n)
    if kind == "grid":
        return rng.randint(0, 4, (2, n, 3)).astype(np.float32)
    if kind == "repeated":
        half = rng.randn(2, n - n // 2, 3)
        return np.concatenate([half, half[:, :n // 2]], 1).astype(np.float32)
    return rng.randn(2, n, 3).astype(np.float32)


@pytest.mark.parametrize("kind", ["float", "grid", "repeated"])
@pytest.mark.parametrize("n,k", [(n, k) for n in (16, 64, 300)
                                 for k in (1, 5, 8, 16)])
def test_selection_matches_jax_kernel(n, k, kind):
    x = _patches(kind, n)
    ref = np.asarray(knn_pallas.knn_self_pallas(jnp.asarray(x), k, True))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(t_knn.knn_self_plain(xt, k).numpy(), ref)
    if kind == "repeated":
        # a repeated point's slot 0 is its first copy
        second = np.arange(n - n // 2, n)
        np.testing.assert_array_equal(ref[:, second, 0],
                                      np.broadcast_to(second - (n - n // 2),
                                                      (2, n // 2)))
    for lanes in (1, 4):
        np.testing.assert_array_equal(emulate(xt, k, lanes).numpy(), ref)
    if k == 16 and n >= 18:
        # where the narrow keys decide, they give the exact indices
        out, undecided, redo = emulate_narrow(xt)
        got = out.numpy()
        keep = ~redo.numpy()
        np.testing.assert_array_equal(got[keep], ref[keep])
        if kind == "float":
            assert not bool(undecided.any())


@pytest.mark.parametrize("kind", ["float", "grid", "repeated"])
@pytest.mark.parametrize("n,k", [(64, 5), (64, 16), (300, 1), (300, 16)])
def test_stream_selection_matches_jax_kernel(n, k, kind):
    """The streaming kernels' order and walk (tiles of the sorted patch
    walked outwards, skipped by the box bound, candidates held to the
    lanes' bar) give JAX's indices at 1, 4 and 8 lanes a query."""
    x = _patches(kind, n)
    ref = np.asarray(knn_pallas.knn_self_pallas(jnp.asarray(x), k, True))
    for lanes in (1, 4, 8):
        np.testing.assert_array_equal(
            emulate_stream(torch.from_numpy(x), k, lanes).numpy(), ref)


def test_shared_memory_limit():
    """`KNN_MAX_N` is the largest patch the shared-memory kernel takes, and
    the main path's patch of 256 points takes 36 KB."""
    f = t_knn.knn_smem_bytes
    assert f(t_knn.KNN_MAX_N) <= t_knn._SMEM_BYTES < f(t_knn.KNN_MAX_N + 1)
    assert f(256) == 16 * 256 + 8 * THREADS * 16
