"""Channel permutations: invertible 1x1 convolution and the reverse shuffle.

Counterpart of `puflow_tpu.flows.permutate`.
"""

from __future__ import annotations

import torch


def inv1x1_init(generator: torch.Generator, channel: int,
                device=None) -> dict:
    """Random-orthogonal (QR) weight."""
    w = torch.randn((channel, channel), generator=generator, device=device)
    q, _ = torch.linalg.qr(w)
    return {"W": q}


def inv1x1_forward(params: dict, x: torch.Tensor):
    """x: [B, N, C] -> (x @ W^T, slogdet(W) * N)."""
    w = params["W"]
    z = torch.einsum("ij,bnj->bni", w, x)
    return z, torch.linalg.slogdet(w)[1] * x.shape[1]


def inv1x1_inverse(params: dict, z: torch.Tensor):
    w = params["W"]
    x = torch.einsum("ij,bnj->bni", torch.linalg.inv(w), z)
    return x, -torch.linalg.slogdet(w)[1] * z.shape[1]


def reverse_permute(x: torch.Tensor, idx: tuple) -> torch.Tensor:
    """Apply a static channel permutation on the last axis."""
    return x[..., list(idx)]
