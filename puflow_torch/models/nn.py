"""Functional NN primitives: channel-last linear map and eval-mode BatchNorm.

All tensors are channel-last (``[B, N, K, C]`` / ``[B, N, C]``) and linear
weights are ``[in, out]``, as in `puflow_tpu.models.nn`, so a parameter tree
moves between the two packages unchanged. Inference only: BatchNorm uses
its running statistics.
"""

from __future__ import annotations

import torch

BN_EPS = 1e-5


def linear_init(generator: torch.Generator, cin: int, cout: int,
                bias: bool = True, device=None) -> dict:
    """Kaiming-uniform fan-in weight ``[cin, cout]`` and a zero bias."""
    bound = (1.0 / cin) ** 0.5
    w = torch.rand((cin, cout), generator=generator, device=device)
    p = {"w": (w * 2.0 - 1.0) * bound}
    if bias:
        p["b"] = torch.zeros((cout,), device=device)
    return p


def channel_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., i] @ w [i, o]``."""
    return torch.matmul(x, w)


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = channel_matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


def bn_init(channel: int, device=None):
    params = {"scale": torch.ones((channel,), device=device),
              "bias": torch.zeros((channel,), device=device)}
    state = {"mean": torch.zeros((channel,), device=device),
             "var": torch.ones((channel,), device=device)}
    return params, state


def bn_apply(params: dict, state: dict, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis."""
    inv = torch.rsqrt(state["var"] + BN_EPS) * params["scale"]
    return (x - state["mean"]) * inv + params["bias"]
