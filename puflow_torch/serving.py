"""Deployment surface: inference entry points as `torch.export` artifacts.

Counterpart of `puflow_tpu.serving`. The traced computation, with the
model's weights as the program's parameters, round-trips through one
``.pt2`` file (`torch.export.save` / `torch.export.load`):

  * `export_patch_sampler`   -- the per-patch upsampler
    ``patches [B, k, 3] -> [B, k*r, 3]`` (the unit a patch-parallel server
    schedules). The batch may be symbolic (any B at run time, one
    artifact).
  * `export_cloud_upsampler` -- the whole-cloud pipeline
    ``clouds [B, N, 3] -> [B, npoint, 3]`` (normalise -> FPS seeds -> k-NN
    patches -> model -> exact union merge, no outlier removal), shapes
    fixed at export time.
  * `save_exported` / `load_exported` -- the file round trip; the loaded
    object is directly callable.

Every hand-written kernel of these paths is a `torch.library` op
(``torch.ops.puflow.*``, registered beside its wrapper in `ops`), which
the exported graph holds as one opaque node a launch. The op dispatches
by the device of its tensors: an artifact exported on the card launches
the CUDA kernels, one exported on the CPU runs their plain versions.

What a server needs: torch, the `puflow_torch` package (its op
registrations and wrappers, imported by `load_exported`) and, on a card,
the kernels built from `puflow_torch/csrc` (by `nvcc`, at the artifact's
first launch, as every launch of the port builds them). A JAX artifact
needs jax alone; a Python-free artifact (AOTInductor) would need the
kernels registered from C++, which this package does not do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from puflow_torch import checkpoint
from puflow_torch.inference.patch import upsample_cloud
# the modules that register the ``puflow::`` ops
from puflow_torch.ops import cnf, encoder, flow, fps, interp, knn
from puflow_torch.utils.device import resolve_device

# each kernel's wrapper, which counts the kernel's launches in `.launches`
# (also those of a loaded artifact)
WRAPPERS = {"knn_self": knn.knn_self, "knn_self_stream": knn.knn_self_stream,
            "encoder": encoder.encoder_conditions,
            "interp_head": interp.interp_head, "flow_f": flow.flow_f,
            "flow_g": flow.flow_g, "flow_g_blend": flow.flow_g_blend,
            "cnf_solve": cnf.cnf_solve,
            "fps": fps.farthest_point_sample,
            "fps_seeded": fps.farthest_point_sample_seeded}


def _module(params, state, model: str, device) -> nn.Module:
    """The model of family ``model`` on ``device`` from (params, state)
    trees of numpy arrays or tensors, each leaf a contiguous copy with
    storage of its own (what `torch.export.save` writes whole)."""
    if model not in checkpoint.MODELS:
        raise ValueError(f"unknown model family: {model}")
    device = resolve_device(device)

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [tree(v) for v in t]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.asarray(t))
        return t.to(device=device, dtype=torch.float32).clone(
            memory_format=torch.contiguous_format)

    return checkpoint.MODELS[model](tree(params), tree(state))


class _PatchSampler(nn.Module):
    def __init__(self, net: nn.Module, upratio: int):
        super().__init__()
        self.net, self.upratio = net, upratio

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.net(patches, self.upratio)


class _CloudUpsampler(nn.Module):
    def __init__(self, net: nn.Module, npoint: int, upratio: int,
                 patch_size: int, expand_ratio: float):
        super().__init__()
        self.net = net
        self.args = (npoint, upratio, patch_size, expand_ratio)

    @torch.no_grad()
    def forward(self, clouds: torch.Tensor) -> torch.Tensor:
        return upsample_cloud(self.net, clouds, *self.args)


def export_patch_sampler(params, state, model: str = "discrete",
                         upratio: int = 4, patch_size: int = 256,
                         batch: int | None = None,
                         device="cuda") -> torch.export.ExportedProgram:
    """Export ``patches [B, patch_size, 3] -> [B, patch_size*upratio, 3]``.

    ``batch=None`` exports with a symbolic batch dimension (one artifact
    serves every request size); a concrete ``batch`` pins it. The model
    family is ``"discrete"`` or ``"cnf"`` / ``"continuous"``; its
    parameters go to ``device``.
    """
    sampler = _PatchSampler(_module(params, state, model, device), upratio)
    example = torch.zeros((2 if batch is None else int(batch), patch_size,
                           3), device=resolve_device(device))
    dims = None
    if batch is None:
        dims = ({0: torch.export.Dim("batch", min=1)},)
    return torch.export.export(sampler, (example,), dynamic_shapes=dims,
                               strict=False)


def export_cloud_upsampler(params, state, model: str = "discrete",
                           cloud_points: int = 2048,
                           npoint: int | None = None, upratio: int = 4,
                           patch_size: int = 256, expand_ratio: float = 4.0,
                           batch: int = 8,
                           device="cuda") -> torch.export.ExportedProgram:
    """Export the whole pipeline ``clouds [batch, cloud_points, 3] ->
    [batch, npoint, 3]`` (default npoint = cloud_points*upratio + 24, the
    reference CLI's count before its outlier removal) with the exact union
    merge.

    The batch must be concrete, as in the JAX package.
    """
    if npoint is None:
        npoint = cloud_points * upratio + 24
    upsampler = _CloudUpsampler(_module(params, state, model, device),
                                npoint, upratio, patch_size, expand_ratio)
    example = torch.zeros((int(batch), cloud_points, 3),
                          device=resolve_device(device))
    return torch.export.export(upsampler, (example,), strict=False)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write an export artifact (conventional suffix: ``.pt2``)."""
    torch.export.save(exported, path)


def load_exported(path: str, device="cuda"):
    """Load an artifact -> a directly-callable function, with the
    `ExportedProgram` as ``.exported``. ``device`` is where the artifact
    was exported for: a CUDA request raises without a card, and an
    artifact of another device raises."""
    device = resolve_device(device)
    exported = torch.export.load(path)
    held = {t.device.type for t in exported.state_dict.values()}
    if held != {device.type}:
        raise ValueError(f"{path} holds tensors on {sorted(held)}, not on "
                         f"{device.type}")
    module = exported.module()

    @functools.wraps(module.forward)
    def call(*args):
        return module(*args)

    call.exported = exported
    return call
