"""Coupling layers (additive / affine / affineEx / injector) and their
transform MLP (LinearA1D).

Counterpart of `puflow_tpu.flows.coupling`, with the same sign conventions:

  forward additive: h2 = h2 - bias                  (logdet = 0)
  forward affine:   h2 = (h2 - bias) * exp(-scale), logdet = -sum(scale)
  inverse affine:   h2 = h2 * exp(scale) + bias
  forward injector: x = (x - bias) * exp(-scale),   logdet = -sum(scale)
  inverse injector: z = z * exp(scale) + bias

The discrete model ships the additive coupling and the injector; the
affine and affineEx couplings are library surface.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from puflow_torch.models.nn import channel_matmul

_LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU default, used by LinearA1D


def linear_a1d_init(generator: torch.Generator, dim_in: int, dim_h: int,
                    dim_out: int, dim_c: int = 0, device=None) -> dict:
    """Init the coupling MLP. Weight layout is [in, out] (x @ W + b); the
    last layer is zero so each flow step starts as the identity."""
    c_in = dim_in + dim_c
    b0 = (1.0 / c_in) ** 0.5
    b1 = (1.0 / dim_h) ** 0.5

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=device)
        return (u * 2.0 - 1.0) * bound

    return {
        "w0": uniform((c_in, dim_h), b0),
        "w1": uniform((dim_h, dim_h), b1),
        "b1": torch.zeros((dim_h,), device=device),
        "w2": torch.zeros((dim_h, dim_out), device=device),
        "b2": torch.zeros((dim_out,), device=device),
    }


def linear_a1d_apply(params: dict, h: torch.Tensor,
                     c: torch.Tensor | None = None) -> torch.Tensor:
    """h: [..., dim_in]; c: [..., dim_c] or None -> [..., dim_out]."""
    if c is not None:
        h = torch.cat([h, c], dim=-1)
    h = channel_matmul(h, params["w0"])       # no bias on w0
    h = F.leaky_relu(h, _LEAKY_SLOPE)
    h = F.leaky_relu(channel_matmul(h, params["w1"]) + params["b1"],
                     _LEAKY_SLOPE)
    return channel_matmul(h, params["w2"]) + params["b2"]


def additive_coupling_forward(params: dict, x: torch.Tensor,
                              c: torch.Tensor | None, split: int):
    """Split x -> (h1 [.. :split], h2 [.. split:]); h2 -= bias_net(h1, c)."""
    h1, h2 = x[..., :split], x[..., split:]
    h2 = h2 - linear_a1d_apply(params["bias_net"], h1, c)
    return torch.cat([h1, h2], dim=-1), None


def additive_coupling_inverse(params: dict, z: torch.Tensor,
                              c: torch.Tensor | None, split: int):
    h1, h2 = z[..., :split], z[..., split:]
    h2 = h2 + linear_a1d_apply(params["bias_net"], h1, c)
    return torch.cat([h1, h2], dim=-1), None


def affine_coupling_forward(params: dict, x: torch.Tensor,
                            c: torch.Tensor | None, split: int):
    h1, h2 = x[..., :split], x[..., split:]
    scale = linear_a1d_apply(params["scale_net"], h1, c)
    bias = linear_a1d_apply(params["bias_net"], h1, c)
    h2 = (h2 - bias) * torch.exp(-scale)
    return (torch.cat([h1, h2], dim=-1),
            -torch.sum(scale.reshape(scale.shape[0], -1), dim=1))


def affine_coupling_inverse(params: dict, z: torch.Tensor,
                            c: torch.Tensor | None, split: int):
    h1, h2 = z[..., :split], z[..., split:]
    scale = linear_a1d_apply(params["scale_net"], h1, c)
    bias = linear_a1d_apply(params["bias_net"], h1, c)
    h2 = h2 * torch.exp(scale) + bias
    return (torch.cat([h1, h2], dim=-1),
            torch.sum(scale.reshape(scale.shape[0], -1), dim=1))


# affineEx: h1 receives an additive update from h2, then h2 is affinely
# transformed. As in the JAX package (and unlike the reference, whose
# forward takes scale and bias from the pre-update h1), scale and bias come
# from the post-update h1 in both directions, so the layer is a bijection.
def affine_ex_coupling_forward(params: dict, x: torch.Tensor,
                               c: torch.Tensor | None, split: int):
    h1, h2 = x[..., :split], x[..., split:]
    h1 = h1 + linear_a1d_apply(params["g1"], h2)
    scale = linear_a1d_apply(params["g2"], h1, c)
    bias = linear_a1d_apply(params["g3"], h1, c)
    h2 = torch.exp(scale) * h2 + bias
    return (torch.cat([h1, h2], dim=-1),
            torch.sum(scale.reshape(scale.shape[0], -1), dim=1))


def affine_ex_coupling_inverse(params: dict, z: torch.Tensor,
                               c: torch.Tensor | None, split: int):
    h1, h2 = z[..., :split], z[..., split:]
    scale = linear_a1d_apply(params["g2"], h1, c)
    bias = linear_a1d_apply(params["g3"], h1, c)
    h2 = (h2 - bias) * torch.exp(-scale)
    h1 = h1 - linear_a1d_apply(params["g1"], h2)
    return (torch.cat([h1, h2], dim=-1),
            -torch.sum(scale.reshape(scale.shape[0], -1), dim=1))


def affine_injector_forward(params: dict, x: torch.Tensor, c: torch.Tensor):
    scale = linear_a1d_apply(params["scale_net"], c)
    bias = linear_a1d_apply(params["bias_net"], c)
    x = (x - bias) * torch.exp(-scale)
    return x, -torch.sum(scale.reshape(scale.shape[0], -1), dim=1)


def affine_injector_inverse(params: dict, z: torch.Tensor, c: torch.Tensor):
    scale = linear_a1d_apply(params["scale_net"], c)
    bias = linear_a1d_apply(params["bias_net"], c)
    z = z * torch.exp(scale) + bias
    return z, torch.sum(scale.reshape(scale.shape[0], -1), dim=1)
