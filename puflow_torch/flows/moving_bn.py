"""Invertible moving-average BatchNorm with exact log-det.

Counterpart of `puflow_tpu.flows.moving_bn`. The shipped CNF model builds
its blocks with ``batch_norm=False``, so this is library surface
(`models.continuous.build_model` with ``cfg.batch_norm``).

Semantics:
  forward (train): normalise with batch statistics (optionally blended
    with the running statistics by ``bn_lag``), move the running
    statistics with decay 0.1;
  forward (eval): normalise with the running statistics;
  reverse: always uses the running statistics;
  logdet per element = ``-0.5 log(var + eps) + weight``, subtracted from
    logpx on forward and added on reverse.

Data parallel (``group=`` a `parallel.Group` of more than one rank): the
batch statistics are the global batch's, as the JAX function computes
them under a sharded jit (its ``axis_name=None`` branch): the mean from an
all-reduced sum, then the unbiased variance from an all-reduced sum of
``(x - mean)^2``, both through the differentiable all-reduce.
"""

from __future__ import annotations

import torch

from puflow_torch.parallel.mesh import all_reduce_sum, is_distributed

EPS = 1e-4
DECAY = 0.1


def moving_bn_init(num_features: int, device=None):
    params = {"weight": torch.zeros((num_features,), device=device),
              "bias": torch.zeros((num_features,), device=device)}
    state = {"mean": torch.zeros((num_features,), device=device),
             "var": torch.ones((num_features,), device=device),
             "step": torch.zeros((1,), device=device)}
    return params, state


def moving_bn_forward(params, state, x: torch.Tensor, logpx=None,
                      train: bool = False, bn_lag: float = 0.0, group=None):
    """x: ``[..., C]`` -> (y, logpx', new_state); with a ``group``, ``x``
    is this rank's shard (module docstring)."""
    used_mean, used_var = state["mean"], state["var"]
    new_state = state
    if train:
        axes = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        if is_distributed(group):
            n *= group.world_size
            batch_mean = all_reduce_sum(torch.sum(x, dim=axes)) / n
            batch_var = all_reduce_sum(torch.sum(
                torch.square(x - batch_mean), dim=axes)) / max(n - 1, 1)
        else:
            batch_mean = torch.mean(x, dim=axes)
            batch_var = (torch.var(x, dim=axes, unbiased=False)
                         * n / max(n - 1, 1))                # unbiased
        used_mean, used_var = batch_mean, batch_var
        if bn_lag > 0:
            step = state["step"][0]
            used_mean = batch_mean - (1 - bn_lag) * (batch_mean
                                                     - state["mean"])
            used_mean = used_mean / (1.0 - bn_lag ** (step + 1))
            used_var = batch_var - (1 - bn_lag) * (batch_var - state["var"])
            used_var = used_var / (1.0 - bn_lag ** (step + 1))
        new_state = {
            "mean": state["mean"] - DECAY * (state["mean"] - batch_mean),
            "var": state["var"] - DECAY * (state["var"] - batch_var),
            "step": state["step"] + 1,
        }

    y = (x - used_mean) * torch.exp(-0.5 * torch.log(used_var + EPS))
    y = y * torch.exp(params["weight"]) + params["bias"]

    if logpx is None:
        return y, None, new_state
    ld = (-0.5 * torch.log(used_var + EPS) + params["weight"]).expand_as(x)
    return y, logpx - torch.sum(ld, dim=-1, keepdim=True), new_state


def moving_bn_reverse(params, state, y: torch.Tensor, logpy=None):
    """Inverse pass; always uses the running statistics.

    Divides by the same factors the forward multiplies with (rather than
    multiplying by separately computed reciprocals), which keeps the round
    trip at about 1 ULP.
    """
    y = (y - params["bias"]) / torch.exp(params["weight"])
    x = y / torch.exp(-0.5 * torch.log(state["var"] + EPS)) + state["mean"]
    if logpy is None:
        return x, None
    ld = (-0.5 * torch.log(state["var"] + EPS) + params["weight"]).expand_as(x)
    return x, logpy + torch.sum(ld, dim=-1, keepdim=True)
