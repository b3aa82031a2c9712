"""The cluster auction of `csrc/emd.cu:emd_cluster_kernel`, emulated on the
CPU, against the port's `auction_from_value` and puflow_tpu's.

The kernel spreads a cloud over C blocks: block r owns the rows [r rchunk,
(r + 1) rchunk) and is the home of the columns [r cchunk, (r + 1)
cchunk), every block keeps a replica of every column's price and owner,
a warp sweeps a row (lane l the columns l + 32 t, a running top-3, then a
butterfly over the lanes for the top-2, the lowest column on ties), and a
swept row keeps a cache, each lane's best two columns and theta, the
largest value of every other column; when it bids again, the top-2 of
those 64 candidates is its bid if their second exceeds theta (prices only
rise, so every other column is still at most theta), else it is swept in
full again. `emulate` runs that
partitioned auction step by step in float32 and checks that the replicas
stay equal; the tests hold it to `auction_from_value` at C = 1, 2, 4 and
16, and `auction_from_value` to the JAX package's on the same value
matrices. The JAX package leaves non-finite values undefined (its top_k
orders a NaN above every number), so the NaN row and the `inf` column are
held to the port's semantics only: a non-finite value never bids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puflow_torch.ops import emd as t_emd
from puflow_tpu.ops.emd import auction_from_value as j_auction_from_value
from torch_threads import one_torch_thread  # noqa: F401

NONE = np.iinfo(np.int32).max
F32 = np.float32


def order_key(f) -> int:
    b = int(np.array(f, dtype=F32).view(np.int32))
    return b if b >= 0 else b ^ 0x7FFFFFFF


def key_value(k: int):
    return np.array(k if k >= 0 else k ^ 0x7FFFFFFF, np.int32).view(F32)[()]


def merge(o1, o2, oj, b1, b2, j1):
    """`emd.cu:merge` on arrays: the top-2 of the union of two top-2s."""
    take = (o1 > b1) | ((o1 == b1) & (oj < j1))
    return (np.where(take, o1, b1), np.where(take, np.fmax(b1, o2),
                                             np.fmax(b2, o1)),
            np.where(take, oj, j1))


def butterfly(b1, b2, j1):
    """`emd.cu:warp_top2`: the lanes' top-2s merged over xor offsets."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        b1, b2, j1 = merge(b1[lanes ^ off], b2[lanes ^ off],
                           j1[lanes ^ off], b1, b2, j1)
    assert (b1 == b1[0]).all() and (j1 == j1[0]).all()
    return b1[0], b2[0], int(j1[0])


def lane_top3(value, price):
    """`emd.cu:sweep` of one row: each lane's running top-3 of its columns
    (in increasing order: the first of equal values stays ahead, a
    non-finite value never counts) -> [32] arrays (b1, b2, b3, j1, j2)."""
    m = len(value)
    cols = np.arange(32 * max(1, -(-m // 32))).reshape(-1, 32).T
    v = np.full(cols.shape, -np.inf, F32)
    inside = cols < m
    v[inside] = value[cols[inside]] - price[cols[inside]]
    v = np.where(np.isfinite(v), v, F32(-np.inf))
    lanes = np.arange(32)
    top = []
    for _ in range(3):
        at = np.argmax(v, axis=1)                   # first maximum
        b = v[lanes, at].copy()
        top.append((b, np.where(b > -np.inf, cols[lanes, at], NONE)))
        v[lanes, at] = -np.inf
    (b1, j1), (b2, j2), (b3, _) = top
    return b1, b2, b3, j1, j2


def emulate(value: np.ndarray, eps: float, iters: int, cluster: int):
    """The kernel's auction on a value matrix ``[n, m]`` over ``cluster``
    blocks -> assignment ``[n]`` (int64, -1 where a row got no column)."""
    n, m = value.shape
    rchunk, cchunk = -(-n // cluster), -(-m // cluster)
    blocks = [range(r * rchunk, min(n, (r + 1) * rchunk))
              for r in range(cluster)]
    home = np.arange(m) // cchunk
    price = np.zeros((cluster, m), F32)             # every block's replica
    owner = np.full((cluster, m), -1)
    assign = np.full(n, -1)
    bidcol, bidinc = np.full(n, -1), np.zeros(n, F32)
    cand = np.full((n, 64), NONE)                  # each row's cache
    theta = np.full(n, np.inf, F32)
    hits = 0
    colkey = np.full((2, m), np.iinfo(np.int32).min, np.int64)
    winner = np.full((2, m), NONE, np.int64)
    eps = F32(eps)
    for it in range(iters):
        par, last = it & 1, it == iters - 1
        lists = [[i for i in rows if assign[i] < 0] for rows in blocks]
        for r, listed in enumerate(lists):
            bids, full = [], []
            for i in listed:                            # the caches first
                if theta[i] < np.inf:
                    b1 = np.full(32, -np.inf, F32)
                    b2, j1 = b1.copy(), np.full(32, NONE)
                    for c in (cand[i, :32], cand[i, 32:]):   # lane by lane
                        v = np.full(32, -np.inf, F32)
                        v[c < m] = value[i, c[c < m]] - price[r, c[c < m]]
                        v = np.where(np.isfinite(v), v, F32(-np.inf))
                        b1, b2, j1 = merge(v, np.full(32, -np.inf, F32),
                                           np.where(v > -np.inf, c, NONE),
                                           b1, b2, j1)
                    top = butterfly(b1, b2, j1)
                    if top[1] > theta[i]:
                        bids.append((i, *top))
                        hits += 1
                        continue
                full.append(i)
            for i in full:
                b1, b2, b3, j1, j2 = lane_top3(value[i], price[r])
                cand[i], theta[i] = np.concatenate([j1, j2]), b3.max()
                bids.append((i, *butterfly(b1, b2, j1)))
            for i, b1, b2, j1 in bids:
                j1 = int(j1)
                with np.errstate(invalid="ignore"):   # no column: unused
                    inc = F32(b1 - b2) + eps
                bidcol[i], bidinc[i] = (j1 if j1 < m else -1), inc
                if j1 < m and not last:                 # atomicMax, home
                    colkey[par, j1] = max(colkey[par, j1], order_key(inc))
        if last:
            for listed in lists:
                assign[listed] = bidcol[listed]
            break
        if sum(map(len, lists)) == 0:
            break
        for listed in lists:                            # contenders
            for i in listed:
                j = bidcol[i]
                if j >= 0 and bidinc[i] >= key_value(colkey[par, j]) - F32(
                        1e-6):
                    winner[par, j] = min(winner[par, j], i)   # atomicMin
        winner[par ^ 1] = NONE
        got = np.nonzero(winner[par] != NONE)[0]
        win = winner[par, got]
        moved = assign.copy()
        for r, rows in enumerate(blocks):               # each block's moves
            old = owner[r, got]
            owner[r, got] = win
            price[r, got] = price[r, got] + bidinc[win]
            mine = (old >= rows.start) & (old < rows.stop)
            moved[old[mine]] = -1
            mine = (win >= rows.start) & (win < rows.stop)
            moved[win[mine]] = got[mine]
        assign = moved
        colkey[par] = np.iinfo(np.int32).min
        assert (price == price[0]).all() and (owner == owner[0]).all()
        assert all(home[j] == j // cchunk for j in range(m))
    emulate.cache_hits = hits
    return assign


def _clouds(kind: str, n: int, m: int, seed: int):
    rng = np.random.RandomState(seed)
    if kind == "duplicates":
        # a coarse grid, every point twice: equal values (best == second)
        # and equal increments from several rows on one column
        x1, x2 = (np.repeat(rng.randint(0, 5, (1, -(-k // 2), 3)), 2, axis=1)
                  [:, :k] / 4.0 for k in (n, m))
    else:
        x1, x2 = rng.rand(1, n, 3), rng.rand(1, m, 3)
    x1, x2 = x1.astype(F32), x2.astype(F32)
    if kind == "nan_row":
        x1[0, 5] = np.nan
    if kind == "inf_column":
        x2[0, 7] = np.inf
    return torch.from_numpy(x1), torch.from_numpy(x2)


CASES = [("uniform", 96, 96, 50), ("uniform", 70, 300, 50),
         ("uniform", 150, 130, 50), ("duplicates", 100, 140, 50),
         ("duplicates", 64, 64, 9), ("nan_row", 90, 150, 50),
         ("inf_column", 90, 150, 50), ("uniform", 200, 260, 12)]


@pytest.mark.parametrize("cluster", [1, 2, 4, 16])
@pytest.mark.parametrize("kind,n,m,iters", CASES)
def test_cluster_auction_is_auction_from_value(kind, n, m, iters, cluster):
    x1, x2 = _clouds(kind, n, m, n * m + iters)
    value = t_emd.base_value(x1, x2)[0]
    ref = t_emd.auction_from_value(value, 0.005, iters).numpy()
    got = emulate(value.numpy(), 0.005, iters, cluster)
    np.testing.assert_array_equal(got, ref)
    if kind == "nan_row":
        assert ref[5] == -1
    if kind == "inf_column":
        assert not (ref == 7).any()


@pytest.mark.parametrize("kind,n,m,iters", [c for c in CASES
                                            if c[0] in ("uniform",
                                                        "duplicates")])
def test_auction_from_value_is_jax(kind, n, m, iters):
    """Through `auction_from_value`, the emulation is the JAX package's
    auction on the same value matrix (finite values)."""
    x1, x2 = _clouds(kind, n, m, n * m + iters)
    value = t_emd.base_value(x1, x2)[0]
    ref = t_emd.auction_from_value(value, 0.005, iters).numpy()
    theirs = np.asarray(jax.jit(
        lambda v: j_auction_from_value(v, 0.005, iters))(
            jnp.asarray(value.numpy())))
    np.testing.assert_array_equal(ref, theirs)


def test_the_cache_serves_bids():
    """Rows that one warp swept bid again from their 32 candidates, and
    the auction stays `auction_from_value`'s."""
    x1, x2 = _clouds("uniform", 150, 130, 7)
    value = t_emd.base_value(x1, x2)[0]
    ref = t_emd.auction_from_value(value, 0.005, 50).numpy()
    np.testing.assert_array_equal(emulate(value.numpy(), 0.005, 50, 4), ref)
    assert emulate.cache_hits > 100


# cudaOccupancyMaxActiveClusters of the cluster kernel at [*, 1024] x
# [*, 1024] on an NVIDIA H100 80GB HBM3 (C -> clusters at once)
H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
        **{c: 7 for c in range(10, 17)}}


@pytest.mark.parametrize("batch,capacity,want", [
    (1, H100, 16), (8, H100, 9), (32, H100, 3), (65535, H100, 1),
    (1, None, 16), (8, None, 16), (32, None, 4), (65535, None, 1)])
def test_plan_cluster_size(batch, capacity, want):
    """The largest C whose clusters the card holds all at once: at the
    H100's capacities, and where every GPC took any C (132 // C)."""
    cap = capacity.get if capacity else (lambda c: 132 // c)
    assert t_emd._emd_plan(batch, 1024, 1024, cap) == want


def test_plan_path_at_the_shared_memory_limit():
    def cap(c):
        return H100[c]

    limit = t_emd.EMD_MAX_M
    assert t_emd.emd_smem_bytes(limit, limit, 16) <= t_emd._SMEM_BYTES
    assert t_emd.emd_smem_bytes(limit + 1, limit + 1, 16) > t_emd._SMEM_BYTES
    assert t_emd._emd_plan(1, limit, limit, cap) == 16
    assert t_emd._emd_plan(32, limit, limit, cap) == 16   # in waves
    assert t_emd._emd_plan(1, limit + 1, limit + 1,
                           cap) == t_emd.GLOBAL_SCRATCH
    # few rows, many columns: the columns decide
    assert t_emd._emd_plan(1, 2, 9200, cap) == 16
    assert t_emd._emd_plan(1, 2, 9250, cap) == t_emd.GLOBAL_SCRATCH
    # the smallest clouds the kernel takes
    assert t_emd._emd_plan(3, 1, 2, cap) == 16
    # the training shape: 24 bytes a column, 184 a block's row and column
    assert t_emd.emd_smem_bytes(1024, 1024, 3) == 24 * 1024 + 184 * 342
