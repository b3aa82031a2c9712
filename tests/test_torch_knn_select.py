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
itself). The streaming kernel for patches over shared memory
(`knn_stream_kernel`) shares the keys, the chain and the merge and walks
the candidates in index order: `emulate_stream`.
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


STREAM_CHUNK = 2048                      # csrc/knn.cu:kChunk


def emulate_stream(x, k, lanes):
    """`knn_stream_kernel`'s indices (patches over shared memory): the
    candidates in index order, chunk by chunk, lane s of a query's
    ``lanes`` taking every lanes-th of a chunk into its list from empty,
    then the lanes' merge."""
    B, n, _ = x.shape
    KL = 1 << (k - 1).bit_length()
    pts = torch.cat([x, torch.arange(n, dtype=x.dtype).expand(B, n)[
        ..., None]], -1)                                     # [B, n, 4]
    lists = []
    for s in range(lanes):
        lst = torch.full((B, n, KL), NONE, dtype=torch.int64)
        for c0 in range(0, n, STREAM_CHUNK):
            for j in range(s, min(STREAM_CHUNK, n - c0), lanes):
                cand = pts[:, c0 + j, None].expand(-1, n, -1)
                chain(lst, keys_of(x, cand))
        lists.append(lst)
    return merge_lanes(lists)[..., :k] & 0xFFFFFFFF


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
    """The streaming kernel's walk (index order, no Morton order, lists
    filled from empty) gives JAX's indices at 1 and 4 lanes a query."""
    x = _patches(kind, n)
    ref = np.asarray(knn_pallas.knn_self_pallas(jnp.asarray(x), k, True))
    for lanes in (1, 4):
        np.testing.assert_array_equal(
            emulate_stream(torch.from_numpy(x), k, lanes).numpy(), ref)


def test_shared_memory_limit():
    """`KNN_MAX_N` is the largest patch the shared-memory kernel takes, and
    the main path's patch of 256 points takes 36 KB."""
    f = t_knn.knn_smem_bytes
    assert f(t_knn.KNN_MAX_N) <= t_knn._SMEM_BYTES < f(t_knn.KNN_MAX_N + 1)
    assert f(256) == 16 * 256 + 8 * THREADS * 16
