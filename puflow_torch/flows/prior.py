"""Latent prior distributions.

Counterpart of `puflow_tpu.flows.prior` (the reference's
`GaussianDistribution.standard_logp` / `standard_sample`).
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def standard_gaussian_logp(z: torch.Tensor) -> torch.Tensor:
    """Standard-normal log-density summed over all non-batch axes -> [B]."""
    ll = -0.5 * (z * z + _LOG_2PI)
    return torch.sum(ll.reshape(z.shape[0], -1), dim=1)


def standard_gaussian_sample(generator: torch.Generator, shape,
                             temperature: float = 1.0,
                             device=None) -> torch.Tensor:
    """Temperature-scaled standard-normal sample on ``device``.

    The reference squares the temperature before use; so does this.
    """
    z = torch.randn(shape, generator=generator, device=device)
    return z * (temperature * temperature)
