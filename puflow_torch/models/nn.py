"""Functional NN primitives: channel-last linear map and BatchNorm.

All tensors are channel-last (``[B, N, K, C]`` / ``[B, N, C]``) and linear
weights are ``[in, out]``, as in `puflow_tpu.models.nn`, so a parameter tree
moves between the two packages unchanged. BatchNorm is functional: its
scale and bias are parameters, its running statistics a separate state
tree.
"""

from __future__ import annotations

import torch

from puflow_torch.parallel.mesh import all_reduce_sum, is_distributed

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


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


def bn_apply(params: dict, state: dict, x: torch.Tensor,
             train: bool = False, group=None):
    """BatchNorm over the last axis. Returns ``(y, new_state)``.

    Eval mode normalises with the running statistics and returns ``state``
    unchanged. Train mode normalises with the batch statistics over every
    other axis (biased variance) and moves the running statistics towards
    them (unbiased variance, momentum 0.1), as torch's BatchNorm does.

    With a `parallel.Group` of more than one rank, ``x`` is this rank's
    shard and the statistics are the global batch's, as `jnp.mean` /
    `jnp.var` give them under a sharded jit: the mean from an all-reduced
    sum, then the variance from an all-reduced sum of ``(x - mean)^2``
    (the one-device formula, not ``E[x^2] - E[x]^2``), both through the
    differentiable all-reduce; ``n`` is the global row count.
    """
    if train:
        axes = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        if is_distributed(group):
            n *= group.world_size
            mean = all_reduce_sum(torch.sum(x, dim=axes)) / n
            var = all_reduce_sum(
                torch.sum(torch.square(x - mean), dim=axes)) / n  # biased
        else:
            mean = torch.mean(x, dim=axes)
            var = torch.mean(torch.square(x - mean), dim=axes)   # biased
        unbiased = var * n / max(n - 1, 1)
        new_state = {
            "mean": (1 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean,
            "var": (1 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * unbiased,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + BN_EPS) * params["scale"]
    return (x - mean) * inv + params["bias"], new_state
