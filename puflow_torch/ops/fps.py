"""Farthest point sampling: the CUDA kernel and its plain PyTorch version.

Counterpart of `puflow_tpu.ops.fps.farthest_point_sample` (dispatch),
`farthest_point_sample_xla` (plain version) and the TPU kernel
`ops/pallas/fps_pallas.py:farthest_point_sample_pallas` (here
`csrc/fps.cu`). Greedy FPS starting at index 0, delta-form distances,
first index on ties: the kernel and the plain version return the same
indices.
"""

from __future__ import annotations

import torch

from puflow_torch.ops import _build

# Largest cloud whose min-distance cache fits the kernel's shared memory
# (232,448 bytes a block, less the reduction scratch); larger clouds keep
# the cache in a global scratch buffer.
_FPS_SMEM_POINTS = 57344


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
        dx = px - px[rows, last][:, None]
        dy = py - py[rows, last][:, None]
        dz = pz - pz[rows, last][:, None]
        # written out in the kernel's order: (dx*dx + dy*dy) + dz*dz
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(mind, dim=1)      # first index among ties
        sel[:, i] = last.to(torch.int32)
    return sel


def farthest_point_sample(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """FPS ``[B, N, 3] -> [B, n_samples]`` int32: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, n_samples)
    if xyz.device.type != "cuda":
        raise ValueError(f"farthest_point_sample: no kernel for {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.ndim != 3 or xyz.shape[2] != 3:
        raise ValueError("farthest_point_sample: expects float32 [B, N, 3], "
                         f"got {xyz.dtype} {tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError("farthest_point_sample: xyz must be contiguous")
    B, N, _ = xyz.shape
    if not 1 <= n_samples <= N:
        raise ValueError(f"farthest_point_sample: n_samples={n_samples} "
                         f"outside [1, {N}]")
    out = torch.empty((B, n_samples), dtype=torch.int32, device=xyz.device)
    scratch = (None if N <= _FPS_SMEM_POINTS else
               torch.empty((B, N), dtype=torch.float32, device=xyz.device))
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        code = lib.puflow_fps(
            xyz.data_ptr(), B, N, n_samples, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _build.stream_ptr(xyz.device))
    _build.check(code, "puflow_fps")
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0
