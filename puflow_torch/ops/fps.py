"""Farthest point sampling: the CUDA kernels and their plain PyTorch
versions, and the grouped merges built on them.

Counterpart of `puflow_tpu.ops.fps`: `farthest_point_sample` (dispatch),
`farthest_point_sample_xla` (plain version) and the TPU kernel
`ops/pallas/fps_pallas.py:farthest_point_sample_pallas` (here
`csrc/fps.cu`: `puflow_fps_cluster`, a cloud over a thread-block cluster,
or `puflow_fps`, a block a cloud, as `_fps_plan` chooses from the shape);
`farthest_point_sample_seeded` with
`farthest_point_sample_seeded_xla` and the TPU kernel
`farthest_point_sample_seeded_pallas` (here `csrc/fps.cu:puflow_fps_seeded`,
its selection a block a row, a cluster a row or a block over a global
cache, as `_fps_seeded_plan` chooses from the shape);
and the grouped, partitioned and Morton-cell variants, which only reshape,
sort and regroup around those two. Greedy FPS, delta-form distances
``(dx*dx + dy*dy) + dz*dz``, first index on ties: each kernel and its
plain version return the same indices.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from puflow_torch.ops import _build

# Largest cloud whose min-distance cache fits the kernel's shared memory
# (232,448 bytes a block, less the reduction scratch); larger clouds keep
# the cache in a global scratch buffer.
_FPS_SMEM_POINTS = 57344
# Candidate-seed pairs the plain seeding holds in one temporary
_PLAIN_PAIRS = 1 << 24


def _sqdist(x, y, z, cx, cy, cz) -> torch.Tensor:
    """Delta-form squared distance in the kernels' order:
    (dx*dx + dy*dy) + dz*dz."""
    dx, dy, dz = x - cx, y - cy, z - cz
    return dx * dx + dy * dy + dz * dz


def farthest_point_sample_plain(xyz: torch.Tensor,
                                n_samples: int) -> torch.Tensor:
    """Greedy farthest-point subset of each cloud, as tensor ops.

    xyz: ``[B, N, 3]`` -> ``[B, n_samples]`` int32 indices into the N axis.
    """
    B, N, _ = xyz.shape
    px, py, pz = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    sel = torch.zeros((B, n_samples), dtype=torch.int32, device=xyz.device)
    mind = torch.full((B, N), float("inf"), device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    for i in range(1, n_samples):
        mind = torch.minimum(mind, _sqdist(
            px, py, pz, px[rows, last][:, None], py[rows, last][:, None],
            pz[rows, last][:, None]))
        last = torch.argmax(mind, dim=1)      # first index among ties
        sel[:, i] = last.to(torch.int32)
    return sel


class FpsPlan(NamedTuple):
    """How `farthest_point_sample` runs a batch on the card: each cloud
    over a cluster of ``cluster`` blocks of ``threads`` threads
    (`csrc/fps.cu:fps_cluster_kernel`), or, with ``cluster == 1``, over one
    block of 1024 threads (`fps_kernel`)."""
    cluster: int
    threads: int


ONE_BLOCK = FpsPlan(1, 1024)
# Most points a thread of the cluster kernel holds in registers, by block
# size: the largest kK that `csrc/fps.cu:cluster_kernel` instantiates
_CLUSTER_PER_THREAD = {128: 46, 256: 46}
# Below this many candidates a step is mostly its argmax, which a cluster
# does not shorten: one block a cloud
_CLUSTER_MIN_POINTS = 8192


def _plan_covers(plan: FpsPlan, n: int) -> bool:
    """Whether ``plan`` is one the kernels take, for clouds of ``n``."""
    if plan == ONE_BLOCK:
        return True
    c, t = plan
    if not 2 <= c <= 16 or t not in _CLUSTER_PER_THREAD:
        return False
    return -(-(-(-n // c)) // t) <= _CLUSTER_PER_THREAD[t]


def _fps_plan(batch: int, n: int,
              capacity: Callable[[FpsPlan], int]) -> FpsPlan:
    """The plan for ``batch`` clouds of ``n`` points. ``capacity(plan)``:
    how many of the plan's clusters the card holds at once.

    A cluster a cloud where the clouds are large enough that a step's pass
    over them outweighs its argmax: the largest cluster, then the smallest
    block, that holds the cloud in registers and of which the card holds
    all ``batch`` at once (clusters in a second wave would double the
    time). One block a cloud where no cluster fits the batch, the clouds
    are small, or their cache needs the global scratch."""
    if _CLUSTER_MIN_POINTS <= n <= _FPS_SMEM_POINTS:
        for c in range(16, 1, -1):
            for t in sorted(_CLUSTER_PER_THREAD):
                plan = FpsPlan(c, t)
                if _plan_covers(plan, n) and capacity(plan) >= batch:
                    return plan
    return ONE_BLOCK


@functools.lru_cache(maxsize=None)
def cluster_capacity(device: torch.device, n: int, plan: FpsPlan) -> int:
    """How many clusters of ``plan``'s kernel, for clouds of ``n`` points,
    the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int()
    with torch.cuda.device(device):
        code = _build.library().puflow_fps_cluster_occupancy(
            n, plan.cluster, plan.threads, ctypes.addressof(count))
    _build.check(code, "puflow_fps_cluster_occupancy")
    return count.value


def _launch(xyz: torch.Tensor, n_samples: int,
            plan: FpsPlan | None = None) -> torch.Tensor:
    """Launch `csrc/fps.cu` on a checked CUDA tensor under ``plan`` (default:
    `_fps_plan`'s, chosen here from the batch and the card)."""
    B, N, _ = xyz.shape
    plan = plan or _fps_plan(
        B, N, functools.partial(cluster_capacity, xyz.device, N))
    out = torch.empty((B, n_samples), dtype=torch.int32, device=xyz.device)
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        stream = _build.stream_ptr(xyz.device)
        if plan == ONE_BLOCK:
            scratch = (None if N <= _FPS_SMEM_POINTS else torch.empty(
                (B, N), dtype=torch.float32, device=xyz.device))
            code = lib.puflow_fps(
                xyz.data_ptr(), B, N, n_samples, out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), stream)
            _build.check(code, "puflow_fps")
        else:
            code = lib.puflow_fps_cluster(
                xyz.data_ptr(), B, N, n_samples, out.data_ptr(),
                plan.cluster, plan.threads, stream)
            _build.check(code, "puflow_fps_cluster")
    return out


def _plan_of(cluster: int, threads: int) -> FpsPlan | None:
    """An op's plan arguments -> the plan; -1 lets the kernel's own
    chooser take it (inside the op, where the batch is known)."""
    return None if cluster < 0 else FpsPlan(cluster, threads)


@torch.library.custom_op("puflow::fps", mutates_args=(), device_types="cuda")
def _fps_op(xyz: torch.Tensor, n_samples: int, cluster: int,
            threads: int) -> torch.Tensor:
    _check_cloud("farthest_point_sample", "xyz", xyz)
    N = xyz.shape[1]
    if not 1 <= n_samples <= N:
        raise ValueError(f"farthest_point_sample: n_samples={n_samples} "
                         f"outside [1, {N}]")
    plan = _plan_of(cluster, threads)
    if plan is not None and not _plan_covers(plan, N):
        raise ValueError(f"farthest_point_sample: no kernel runs {plan} on "
                         f"clouds of {N} points")
    out = _launch(xyz, n_samples, plan)
    farthest_point_sample.launches += 1
    return out


@_fps_op.register_kernel("cpu")
def _(xyz, n_samples, cluster, threads):
    return farthest_point_sample_plain(xyz, n_samples)


@_fps_op.register_fake
def _(xyz, n_samples, cluster, threads):
    return xyz.new_empty((xyz.shape[0], n_samples), dtype=torch.int32)


def farthest_point_sample(xyz: torch.Tensor, n_samples: int, *,
                          _plan: FpsPlan | None = None) -> torch.Tensor:
    """FPS ``[B, N, 3] -> [B, n_samples]`` int32 through the op
    ``puflow::fps``: the CUDA kernel that `_fps_plan` chooses for a CUDA
    tensor, the plain version for a CPU tensor. ``_plan`` forces a plan
    (the card tests reach each one so)."""
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"farthest_point_sample: no kernel for {xyz.device}")
    cluster, threads = _plan or (-1, -1)
    return torch.ops.puflow.fps(xyz, n_samples, cluster, threads)


farthest_point_sample.launches = 0


def _check_cloud(fn: str, what: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.ndim != 3 or t.shape[2] != 3:
        raise ValueError(f"{fn}: expects {what} float32 [B, N, 3], got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {what} must be contiguous")


def _seed_groups(xyz: torch.Tensor, seeds: torch.Tensor) -> int:
    """Rows of ``xyz`` per seed set: row r of ``xyz`` is seeded by
    ``seeds[r // groups]`` (the grouped merges' seeds repeated, without
    the copy)."""
    R, Bs = xyz.shape[0], seeds.shape[0]
    if Bs < 1 or R % Bs or seeds.shape[1] < 1:
        raise ValueError(f"farthest_point_sample_seeded: {Bs} seed sets of "
                         f"{seeds.shape[1]} for {R} candidate rows; need at "
                         "least one seed and a row count divisible by the "
                         "number of seed sets")
    return R // Bs


def _nearest_seed_sqdist_plain(xyz: torch.Tensor,
                              seeds: torch.Tensor) -> torch.Tensor:
    """Squared distance of every candidate to its nearest seed, ``[R, M]``
    (the seeded FPS's starting cache), seeds taken in chunks so that one
    temporary holds at most ``_PLAIN_PAIRS`` pairs."""
    R, M, _ = xyz.shape
    G = _seed_groups(xyz, seeds)
    sd = seeds.repeat_interleave(G, dim=0) if G > 1 else seeds
    px, py, pz = (xyz[..., None, i] for i in range(3))        # [R, M, 1]
    mind = torch.full((R, M), float("inf"), device=xyz.device)
    chunk = max(1, _PLAIN_PAIRS // max(1, R * M))
    for s0 in range(0, sd.shape[1], chunk):
        s = sd[:, None, s0:s0 + chunk]                          # [R, 1, c, 3]
        d = _sqdist(px, py, pz, s[..., 0], s[..., 1], s[..., 2])
        mind = torch.minimum(mind, d.amin(dim=2))
    return mind


def farthest_point_sample_seeded_plain(xyz: torch.Tensor, seeds: torch.Tensor,
                                       n_samples: int) -> torch.Tensor:
    """Seeded FPS as tensor ops.

    xyz: ``[R, M, 3]`` candidates; seeds: ``[R / G, S, 3]``, row r seeded
    by ``seeds[r // G]``. The min-distance cache starts at each
    candidate's distance to its nearest seed; each of the ``n_samples``
    steps takes the argmax first (lowest index on ties), then applies the
    pick's distance update. -> ``[R, n_samples]`` int32 indices.
    """
    R, M, _ = xyz.shape
    mind = _nearest_seed_sqdist_plain(xyz, seeds)
    px, py, pz = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    sel = torch.zeros((R, n_samples), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(R, device=xyz.device)
    for i in range(n_samples):
        nxt = torch.argmax(mind, dim=1)       # first index among ties
        sel[:, i] = nxt.to(torch.int32)
        mind = torch.minimum(mind, _sqdist(
            px, py, pz, px[rows, nxt][:, None], py[rows, nxt][:, None],
            pz[rows, nxt][:, None]))
    return sel


# The seeded selection's plans (`csrc/fps.cu:puflow_fps_seeded`), as
# FpsPlan(cluster, threads): cluster 1 is a block of ``threads`` a row
# (`fps_seeded_block_kernel`), 2-16 a cluster a row (`fps_cluster_kernel`,
# seeded start), and `SEEDED_GLOBAL` one 1024-thread block a row working
# on the cache in device memory (`fps_seeded_kernel`).
SEEDED_GLOBAL = FpsPlan(0, 1024)
# the block kernel's sizes, smallest first, and the most candidates a thread
# holds in registers: its largest kK
_SEEDED_BLOCK_THREADS = (128, 256, 512)
_SEEDED_BLOCK_PER_THREAD = 16
# the largest row a cluster holds in registers: 16 blocks of 256 threads
# of 46 candidates
_SEEDED_CLUSTER_POINTS = 16 * 256 * _CLUSTER_PER_THREAD[256]


def _seeded_plan_covers(plan: FpsPlan, n: int) -> bool:
    """Whether the seeded selection takes ``plan`` for rows of ``n``."""
    if plan == SEEDED_GLOBAL:
        return True
    if plan.cluster == 1:
        return (plan.threads in _SEEDED_BLOCK_THREADS and
                -(-n // plan.threads) <= _SEEDED_BLOCK_PER_THREAD)
    return plan.cluster > 1 and _plan_covers(plan, n)


def _fps_seeded_plan(rows: int, n: int, capacity: Callable[[FpsPlan], int],
                     forced: FpsPlan | None = None) -> FpsPlan:
    """The seeded selection's plan for ``rows`` rows of ``n`` candidates.
    ``capacity(plan)``: how many rows of the plan the card holds at once
    (blocks or clusters). ``forced``: a plan to take instead; one the
    kernels do not take raises.

    Rows a block holds in registers (``n`` up to 512 x 16) take a block a
    row: the smallest block that holds the row, of which the card holds
    all ``rows`` at once (a step's work an SM is the same at every block
    size; fewer warps make its reductions shorter). Rows a cluster holds
    take a cluster a row: the largest cluster, then the smallest block, of
    which the card holds all ``rows`` at once. Where no plan holds them
    all, the one with the fewest waves, in that order of preference.
    Larger rows: `SEEDED_GLOBAL`."""
    if forced is not None:
        if not _seeded_plan_covers(forced, n):
            raise ValueError(f"farthest_point_sample_seeded: no kernel runs "
                             f"{forced} on rows of {n} candidates")
        return forced
    if n <= max(_SEEDED_BLOCK_THREADS) * _SEEDED_BLOCK_PER_THREAD:
        plans = [FpsPlan(1, t) for t in _SEEDED_BLOCK_THREADS]
    elif n <= _SEEDED_CLUSTER_POINTS:
        plans = [FpsPlan(c, t) for c in range(16, 1, -1)
                 for t in sorted(_CLUSTER_PER_THREAD)]
    else:
        return SEEDED_GLOBAL
    plans = [p for p in plans if _seeded_plan_covers(p, n)]
    caps = [capacity(p) for p in plans]
    return plans[min(range(len(plans)),
                     key=lambda k: -(-rows // max(1, caps[k])))]


@functools.lru_cache(maxsize=None)
def seeded_capacity(device: torch.device, n: int, plan: FpsPlan) -> int:
    """How many rows of ``n`` candidates the seeded selection's ``plan``
    holds on the card at once (`puflow_fps_seeded_occupancy`)."""
    count = ctypes.c_int()
    with torch.cuda.device(device):
        code = _build.library().puflow_fps_seeded_occupancy(
            n, plan.cluster, plan.threads, ctypes.addressof(count))
    _build.check(code, "puflow_fps_seeded_occupancy")
    return count.value


def _seeded_launch(xyz: torch.Tensor, seeds: torch.Tensor, out: torch.Tensor,
                   mind: torch.Tensor, phases: int = 3,
                   plan: FpsPlan | None = None) -> None:
    """Launch `csrc/fps.cu:puflow_fps_seeded` on checked CUDA tensors:
    ``out`` ``[R, m]`` int32, ``mind`` ``[R, M]`` float32 scratch (the
    seeded cache). ``phases``: 1 seeds the cache, 2 selects from it, 3
    both; the wrapper runs both, the split lets a caller time them apart.
    ``plan``: the selection's plan (default: `_fps_seeded_plan`'s)."""
    R, M, _ = xyz.shape
    if plan is None:
        plan = _fps_seeded_plan(R, M, functools.partial(
            seeded_capacity, xyz.device, M))
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        code = lib.puflow_fps_seeded(
            xyz.data_ptr(), seeds.data_ptr(), R, M, seeds.shape[1],
            _seed_groups(xyz, seeds), out.shape[1], out.data_ptr(),
            mind.data_ptr(), plan.cluster, plan.threads, phases,
            _build.stream_ptr(xyz.device))
    _build.check(code, "puflow_fps_seeded")


def _launch_seeded(xyz: torch.Tensor, seeds: torch.Tensor, n_samples: int,
                   plan: FpsPlan | None = None) -> torch.Tensor:
    """`_seeded_launch` of both phases into new tensors; the selection's
    plan ``plan`` or `_fps_seeded_plan`'s."""
    R, M, _ = xyz.shape
    plan = _fps_seeded_plan(R, M, functools.partial(
        seeded_capacity, xyz.device, M), plan)
    out = torch.empty((R, n_samples), dtype=torch.int32, device=xyz.device)
    mind = torch.empty((R, M), dtype=torch.float32, device=xyz.device)
    _seeded_launch(xyz, seeds, out, mind, plan=plan)
    return out


@torch.library.custom_op("puflow::fps_seeded", mutates_args=(),
                         device_types="cuda")
def _fps_seeded_op(xyz: torch.Tensor, seeds: torch.Tensor, n_samples: int,
                   cluster: int, threads: int) -> torch.Tensor:
    _check_cloud("farthest_point_sample_seeded", "xyz", xyz)
    _check_cloud("farthest_point_sample_seeded", "seeds", seeds)
    if seeds.device != xyz.device:
        raise ValueError("farthest_point_sample_seeded: seeds on "
                         f"{seeds.device}, candidates on {xyz.device}")
    if xyz.shape[1] < 1 or n_samples < 1:
        raise ValueError("farthest_point_sample_seeded: needs candidates and "
                         f"n_samples >= 1, got {tuple(xyz.shape)}, "
                         f"{n_samples}")
    _seed_groups(xyz, seeds)
    out = _launch_seeded(xyz, seeds, n_samples, _plan_of(cluster, threads))
    farthest_point_sample_seeded.launches += 1
    return out


@_fps_seeded_op.register_kernel("cpu")
def _(xyz, seeds, n_samples, cluster, threads):
    return farthest_point_sample_seeded_plain(xyz, seeds, n_samples)


@_fps_seeded_op.register_fake
def _(xyz, seeds, n_samples, cluster, threads):
    return xyz.new_empty((xyz.shape[0], n_samples), dtype=torch.int32)


def farthest_point_sample_seeded(xyz: torch.Tensor, seeds: torch.Tensor,
                                 n_samples: int, *,
                                 _plan: FpsPlan | None = None
                                 ) -> torch.Tensor:
    """Seeded FPS ``[R, M, 3]``, seeds ``[R / G, S, 3]`` -> ``[R,
    n_samples]`` int32 candidate indices (the seeds are not returned)
    through the op ``puflow::fps_seeded``: the CUDA kernel for CUDA
    tensors, its selection as `_fps_seeded_plan` chooses, the plain
    version for CPU tensors. ``_plan`` forces a plan of the selection (the
    card tests reach each one so)."""
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError("farthest_point_sample_seeded: no kernel for "
                         f"{xyz.device}")
    cluster, threads = _plan or (-1, -1)
    return torch.ops.puflow.fps_seeded(xyz, seeds, n_samples, cluster,
                                       threads)


farthest_point_sample_seeded.launches = 0


def _interleave(sel: torch.Tensor, B: int, G: int,
                n_samples: int) -> torch.Tensor:
    """``[B * G, mg]`` group picks -> ``[B, n_samples]`` in step order
    (pick 0 of every group first)."""
    mg = sel.shape[-1]
    return sel.reshape(B, G, mg).transpose(1, 2).reshape(
        B, G * mg)[:, :n_samples]


def farthest_point_sample_seeded_grouped(
        xyz: torch.Tensor, seeds: torch.Tensor, n_samples: int, groups: int,
        sample=farthest_point_sample_seeded) -> torch.Tensor:
    """Grouped seeded FPS over strided subsets (candidate j in group
    ``j % groups``), all groups advancing as extra rows of one seeded FPS;
    picks interleaved in step order. Shapes that do not divide fall back
    to the exact seeded FPS. ``sample`` is the seeded FPS to run
    (`puflow_tpu`'s ``use_pallas`` choice)."""
    B, M, C = xyz.shape
    G = groups
    if G <= 1 or M % G != 0 or n_samples < G:
        return sample(xyz, seeds, n_samples)
    mg = -(-n_samples // G)
    grouped = xyz.reshape(B, M // G, G, C).transpose(1, 2)
    grouped = grouped.reshape(B * G, M // G, C).contiguous()
    sel = sample(grouped, seeds, mg)
    sel = sel.reshape(B, G, mg) * G + torch.arange(
        G, dtype=sel.dtype, device=sel.device)[None, :, None]
    return _interleave(sel, B, G, n_samples)


def farthest_point_sample_seeded_partitioned(
        xyz: torch.Tensor, seeds: torch.Tensor, n_samples: int, groups: int,
        sample=farthest_point_sample_seeded) -> torch.Tensor:
    """Grouped seeded FPS over spatially compact cells from a kd-style
    recursive median split (``log2(groups)`` levels, each segment halved
    at the median of its widest axis). ``groups`` must be a power of two
    dividing M; otherwise the exact seeded FPS runs."""
    B, M, C = xyz.shape
    G = groups
    if G <= 1 or (G & (G - 1)) != 0 or M % G != 0 or n_samples < G:
        return sample(xyz, seeds, n_samples)
    perm = torch.arange(M, dtype=torch.int64,
                        device=xyz.device).expand(B, M)
    pts = xyz
    for lvl in range(G.bit_length() - 1):
        n_seg = 1 << lvl
        shaped = pts.reshape(B * n_seg, M // n_seg, C)
        flat_perm = perm.reshape(B * n_seg, M // n_seg)
        ext = shaped.amax(dim=1) - shaped.amin(dim=1)           # [S, C]
        ax = torch.argmax(ext, dim=-1)                           # [S]
        key = torch.gather(shaped, 2, ax[:, None, None].expand(
            -1, shaped.shape[1], 1))[..., 0]                     # [S, seg]
        order = torch.argsort(key, dim=-1, stable=True)
        shaped = torch.gather(shaped, 1, order[..., None].expand(-1, -1, C))
        flat_perm = torch.gather(flat_perm, 1, order)
        pts = shaped.reshape(B, M, C)
        perm = flat_perm.reshape(B, M)
    mg = -(-n_samples // G)
    sel = sample(pts.reshape(B * G, M // G, C).contiguous(), seeds, mg)
    sel = torch.gather(perm.reshape(B, G, M // G), 2,
                       sel.reshape(B, G, mg).long())
    return _interleave(sel.to(torch.int32), B, G, n_samples)


def _morton_key(xyz: torch.Tensor) -> torch.Tensor:
    """30-bit Morton (Z-order) key per point, ``[B, M, 3] -> [B, M]``
    int64 (values below 2^30). Coordinates quantize to 10 bits per axis
    against each cloud's own bounding box (truncating, as JAX's
    ``astype(uint32)``); bits interleave x2 y1 z0."""
    lo = xyz.amin(dim=1, keepdim=True)
    hi = xyz.amax(dim=1, keepdim=True)
    q = (xyz - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0
    q = torch.clamp(q, 0.0, 1023.0).to(torch.int64)

    def spread(v):  # 10 bits -> every 3rd bit of 30
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return ((spread(q[..., 0]) << 2) | (spread(q[..., 1]) << 1)
            | spread(q[..., 2]))


def _morton_cells(xyz: torch.Tensor, groups: int):
    """Points stably sorted by Morton key and cut into ``groups`` equal
    contiguous cells: (cells ``[B * G, M / G, 3]``, sort order ``[B, M]``).
    Equal keys stay adjacent, so duplicate points share a cell."""
    B, M, C = xyz.shape
    _, order = torch.sort(_morton_key(xyz), dim=-1, stable=True)
    pts = torch.gather(xyz, 1, order[..., None].expand(-1, -1, C))
    return pts.reshape(B * groups, M // groups, C), order


def _from_cells(sel: torch.Tensor, order: torch.Tensor, B: int, G: int,
                n_samples: int) -> torch.Tensor:
    mg = sel.shape[-1]
    sel = torch.gather(order.reshape(B, G, -1), 2,
                       sel.reshape(B, G, mg).long())
    return _interleave(sel.to(torch.int32), B, G, n_samples)


def farthest_point_sample_seeded_morton(
        xyz: torch.Tensor, seeds: torch.Tensor, n_samples: int, groups: int,
        sample=farthest_point_sample_seeded) -> torch.Tensor:
    """Grouped seeded FPS over point-level Morton cells: one stable sort by
    Morton key, ``groups`` equal contiguous chunks, each a row of one
    seeded FPS with the cloud's seeds. Falls back to the exact seeded FPS
    when ``groups`` does not divide M, ``n_samples < groups`` or C != 3."""
    B, M, C = xyz.shape
    G = groups
    if G <= 1 or M % G != 0 or n_samples < G or C != 3:
        return sample(xyz, seeds, n_samples)
    cells, order = _morton_cells(xyz, G)
    sel = sample(cells, seeds, -(-n_samples // G))
    return _from_cells(sel, order, B, G, n_samples)


def farthest_point_sample_morton(xyz: torch.Tensor, n_samples: int,
                                 groups: int,
                                 sample=farthest_point_sample) -> torch.Tensor:
    """Grouped unseeded FPS over point-level Morton cells (the grouped
    union merge): every cell runs FPS for ``ceil(n / groups)`` points as
    one row of the FPS kernel. Falls back to whole-cloud FPS where the
    seeded variant does, and also when a cell holds fewer candidates than
    its share of picks (a cell would return duplicates)."""
    B, M, C = xyz.shape
    G = groups
    if (G <= 1 or M % G != 0 or n_samples < G or C != 3
            or -(-n_samples // G) > M // G):
        return sample(xyz, n_samples)
    cells, order = _morton_cells(xyz, G)
    sel = sample(cells, -(-n_samples // G))
    return _from_cells(sel, order, B, G, n_samples)
