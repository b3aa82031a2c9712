"""k-nearest-neighbour search and batched point gathering.

Counterpart of `puflow_tpu.ops.knn`. Distances use the same expanded form
``|x|^2 + |y|^2 - 2 x.y^T`` clamped at zero, and neighbours come back
sorted by ascending distance, so the first 8 columns of a K=16 graph are
the K=8 graph. Tie order between equal distances may differ from the JAX
package; every consumer is permutation-equivariant over neighbour slots.

`knn_self` is the counterpart of the TPU kernel
`ops/pallas/knn_pallas.py:knn_self_pallas` (here `csrc/knn.cu`): each
point's neighbours within its own patch, from delta-form distances with
first-occurrence ties; the kernel and `knn_self_plain` return the same
indices. Patches over `KNN_MAX_N` points take `knn_self_stream`: three
more kernels of `csrc/knn.cu` sort each patch spatially in device memory,
then walk its tiles outwards from each warp's place, skipping the tiles
whose box lies farther than every lane's current neighbours.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from puflow_torch.ops import _build

KNN_MAX_K = 16            # the kernel's longest register list
_SMEM_BYTES = 232448      # shared memory a block may use
KNN_MAX_N = 10432         # the largest patch `knn_smem_bytes` lets in


def knn_smem_bytes(n: int) -> int:
    """Shared memory of `csrc/knn.cu` for a patch of ``n`` points at its
    widest launch: the patch as float4 (16 bytes a point), then the larger
    of its Morton sort words (4 bytes each, a power of two of them) and a
    block's output rows (at most 256 rows of 16 int64)."""
    return 16 * n + max(4 * (1 << max(n - 1, 0).bit_length()), 8 * 256 * 16)


def knn_self_in_smem(n: int) -> bool:
    """Whether `knn_self` takes patches of ``n`` points with its shared-memory
    kernel (n <= `KNN_MAX_N`), else with the streaming one
    (`knn_self_stream`)."""
    return knn_smem_bytes(n) <= _SMEM_BYTES


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[..., N, C]`` x ``[..., M, C]`` -> ``[..., N, M]`` squared
    distances, clamped at zero."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)            # [..., N, 1]
    y2 = torch.sum(y * y, dim=-1, keepdim=True)            # [..., M, 1]
    cross = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp_min(x2 + y2.transpose(-1, -2) - 2.0 * cross, 0.0)


def knn_indices(query: torch.Tensor, points: torch.Tensor, k: int,
                return_dist: bool = False):
    """Indices (into ``points``) of the k nearest neighbours of each query.

    query: ``[B, N, C]``; points: ``[B, M, C]`` -> ``idx [B, N, k]`` int64
    in ascending distance order, and optionally ``sqdist [B, N, k]``.
    """
    d = pairwise_sqdist(query, points)
    kd, idx = torch.topk(d, k, dim=-1, largest=False, sorted=True)
    if return_dist:
        return idx, kd
    return idx


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ..., :] = points[b, idx[b, ...], :]``.

    points: ``[B, M, C]``; idx: ``[B, ...]`` -> ``[B, ..., C]``.
    """
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def check_patches(name: str, xyz: torch.Tensor) -> None:
    """Raise unless ``xyz`` is what the kernels take: contiguous float32
    patches ``[B, n, 3]``."""
    if (xyz.dtype != torch.float32 or xyz.ndim != 3 or xyz.shape[2] != 3
            or not xyz.is_contiguous()):
        raise ValueError(f"{name}: expects contiguous float32 [B, n, 3], "
                         f"got {xyz.dtype} {tuple(xyz.shape)}")


def check_graph(name: str, knn_idx: torch.Tensor,
                points: torch.Tensor) -> int:
    """Raise unless ``knn_idx`` is a K-NN graph the kernels take for
    ``points`` ``[B, n, C]``: int64 ``[B, n, K]`` on the same device with
    unit last stride and rows ``n * stride(1)`` apart per patch (a slice
    ``idx[..., :8]`` qualifies). Returns K."""
    B, n = points.shape[:2]
    if (knn_idx.dtype != torch.int64 or knn_idx.device != points.device
            or knn_idx.ndim != 3 or knn_idx.shape[:2] != (B, n)
            or knn_idx.stride(2) != 1
            or knn_idx.stride(0) != n * knn_idx.stride(1)):
        raise ValueError(f"{name}: expects an int64 graph [{B}, {n}, K] "
                         f"with unit last stride on {points.device}, got "
                         f"{knn_idx.dtype} {tuple(knn_idx.shape)}")
    k = knn_idx.shape[2]
    if not 1 <= k <= 128:
        raise ValueError(f"{name}: K={k} outside [1, 128]")
    return k


def knn_self_plain(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, n, 3] -> [B, n, k]`` int64: ascending self k-NN within each
    patch, slot 0 the point itself, first index on ties.

    Distances are the delta form ``(dx*dx + dy*dy) + dz*dz`` of
    `knn_pallas.py:64-67`, which the kernel computes in the same order.
    """
    d = None
    for c in range(3):
        delta = xyz[:, None, :, c] - xyz[:, :, None, c]    # [B, query, cand]
        sq = delta * delta
        d = sq if d is None else d + sq
    _, idx = torch.sort(d, dim=-1, stable=True)
    return idx[..., :k].contiguous()


def _check_self(name: str, xyz: torch.Tensor, k: int) -> None:
    check_patches(name, xyz)
    if not 1 <= k <= min(KNN_MAX_K, xyz.shape[1]):
        raise ValueError(f"{name}: k={k} outside [1, min({KNN_MAX_K}, n)]")


def _launch_self(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Launch `csrc/knn.cu:puflow_knn_self` on checked CUDA patches."""
    B, n, _ = xyz.shape
    out = torch.empty((B, n, k), dtype=torch.int64, device=xyz.device)
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        code = lib.puflow_knn_self(xyz.data_ptr(), B, n, k, out.data_ptr(),
                                   _build.stream_ptr(xyz.device))
    _build.check(code, "puflow_knn_self")
    return out


@functools.lru_cache(maxsize=64)
def _stream_scratch_bytes(batch: int, n: int) -> int:
    """Bytes of `puflow_knn_self_stream`'s scratch for ``batch`` patches of
    ``n`` points (`puflow_knn_self_stream_scratch`)."""
    size = ctypes.c_longlong()
    code = _build.library().puflow_knn_self_stream_scratch(
        batch, n, ctypes.addressof(size))
    _build.check(code, "puflow_knn_self_stream_scratch")
    return size.value


def _launch_stream(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Launch `csrc/knn.cu:puflow_knn_self_stream` on checked CUDA patches,
    with a scratch of its own."""
    B, n, _ = xyz.shape
    out = torch.empty((B, n, k), dtype=torch.int64, device=xyz.device)
    scratch = torch.empty(_stream_scratch_bytes(B, n), dtype=torch.uint8,
                          device=xyz.device)
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        code = lib.puflow_knn_self_stream(
            xyz.data_ptr(), B, n, k, out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), _build.stream_ptr(xyz.device))
    _build.check(code, "puflow_knn_self_stream")
    return out


# One `torch.library` op a kernel: the CUDA implementation checks the
# tensors (also those a loaded artifact is given), launches the kernel and
# counts the launch, the CPU one runs the plain version, the fake one only
# allocates the output (what `torch.export` traces).
@torch.library.custom_op("puflow::knn_self", mutates_args=(),
                         device_types="cuda")
def _knn_self_op(xyz: torch.Tensor, k: int) -> torch.Tensor:
    _check_self("knn_self", xyz, k)
    out = _launch_self(xyz, k)
    knn_self.launches += 1
    return out


@torch.library.custom_op("puflow::knn_self_stream", mutates_args=(),
                         device_types="cuda")
def _knn_self_stream_op(xyz: torch.Tensor, k: int) -> torch.Tensor:
    _check_self("knn_self_stream", xyz, k)
    out = _launch_stream(xyz, k)
    knn_self_stream.launches += 1
    return out


for _op in (_knn_self_op, _knn_self_stream_op):
    _op.register_kernel("cpu")(knn_self_plain)

    @_op.register_fake
    def _(xyz, k):
        return xyz.new_empty((xyz.shape[0], xyz.shape[1], k),
                             dtype=torch.int64)


def knn_self(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Self k-NN ``[B, n, 3] -> [B, n, k]`` int64 through the op
    ``puflow::knn_self``: for a CUDA tensor the shared-memory kernel where
    it holds the patch (`knn_self_in_smem`), else `knn_self_stream`;
    `knn_self_plain` for a CPU tensor."""
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"knn_self: no kernel for {xyz.device}")
    if xyz.device.type == "cuda" and not knn_self_in_smem(xyz.shape[1]):
        return knn_self_stream(xyz, k)
    return torch.ops.puflow.knn_self(xyz, k)


def knn_self_stream(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """`knn_self` for patches of any size, through the op
    ``puflow::knn_self_stream``: for a CUDA tensor one call of
    `csrc/knn.cu:puflow_knn_self_stream` (`knn_cells_kernel` and
    `knn_scatter_kernel` sort each patch into a scratch of its own,
    `knn_stream_kernel` walks it), `knn_self_plain` for a CPU tensor; the
    same indices."""
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"knn_self_stream: no kernel for {xyz.device}")
    return torch.ops.puflow.knn_self_stream(xyz, k)


knn_self.launches = 0
knn_self_stream.launches = 0
