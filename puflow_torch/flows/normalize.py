"""ActNorm: per-channel scale/bias with exact log-determinant.

Counterpart of `puflow_tpu.flows.normalize` (channel-last):

  forward:  z = x * exp(logs) + bias,        logdet = sum(logs) * N
  inverse:  x = (z - bias) * exp(-logs),     logdet = -sum(logs) * N

`actnorm_init_from_data` is the data-dependent init that
`discrete.actnorm_warmup` runs once before training.
"""

from __future__ import annotations

import torch


def actnorm_init(channel: int, device=None) -> dict:
    """Identity-initialised ActNorm parameters ``[1, 1, C]``."""
    return {"logs": torch.zeros((1, 1, channel), device=device),
            "bias": torch.zeros((1, 1, channel), device=device)}


def actnorm_init_from_data(x: torch.Tensor, eps: float = 1e-6) -> dict:
    """Data-dependent init from a representative batch ``[B, N, C]``:
    bias = -mean, logs = -log(std + eps) over all non-channel axes, with
    the unbiased std (torch's ``Tensor.std``), as the reference's first
    forward does."""
    mean = torch.mean(x, dim=(0, 1), keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=(0, 1), keepdim=True)
    n = x.shape[0] * x.shape[1]
    std = torch.sqrt(var * n / max(n - 1, 1))
    return {"bias": -mean, "logs": -torch.log(std + eps)}


def actnorm_forward(params: dict, x: torch.Tensor):
    """x: [B, N, C] -> (z, scalar logdet). logdet scales with N (points)."""
    z = x * torch.exp(params["logs"]) + params["bias"]
    return z, torch.sum(params["logs"]) * x.shape[1]


def actnorm_inverse(params: dict, z: torch.Tensor):
    x = (z - params["bias"]) * torch.exp(-params["logs"])
    return x, -torch.sum(params["logs"]) * z.shape[1]
