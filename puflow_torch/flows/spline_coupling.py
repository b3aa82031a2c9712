"""Spline coupling layer: an alternative to the affine couplings.

Counterpart of `puflow_tpu.flows.spline_coupling`: channel split, a
conditioner MLP (`LinearA1D`) emits per-dimension spline parameters
(64 bins, linear tails, tail bound 5), the width and height logits scaled
by 1/sqrt(hidden width). Part of the library surface; the shipped models
do not use it.
"""

from __future__ import annotations

import math

import torch

from puflow_torch.flows.coupling import linear_a1d_apply, linear_a1d_init
from puflow_torch.flows.spline import (cubic_spline, rational_linear_spline,
                                       rational_quadratic_spline)
from puflow_torch.utils.device import resolve_device

NUM_BINS = 64
TAIL_BOUND = 5.0
MIN_BIN = 1e-3
MIN_DERIV = 1e-3


def param_multiplier(spline: str, num_bins: int = NUM_BINS) -> int:
    return {
        "cubic": num_bins * 2 + 2,
        "quadratic": num_bins * 3 - 1,
        "linear-rational": num_bins * 4 - 1,
    }[spline]


def spline_coupling_init(generator: torch.Generator, dim_in: int, dim_h: int,
                         dim_out: int, dim_c: int = 0,
                         spline: str = "quadratic", device="cuda") -> dict:
    """The generator must live on ``device``."""
    device = resolve_device(device)
    return {"transform_net": linear_a1d_init(
        generator, dim_in, dim_h, dim_out * param_multiplier(spline), dim_c,
        device=device)}


def _piecewise(h2, raw, spline: str, inverse: bool, hidden: int,
               num_bins: int = NUM_BINS):
    """Apply the selected spline to h2 given raw params [..., mult]."""
    uw = raw[..., :num_bins] / math.sqrt(hidden)
    uh = raw[..., num_bins: 2 * num_bins] / math.sqrt(hidden)
    if spline == "quadratic":
        ud = raw[..., 2 * num_bins:]
        return rational_quadratic_spline(
            h2, uw, uh, ud, inverse, "linear", TAIL_BOUND, num_bins,
            MIN_BIN, MIN_BIN, MIN_DERIV)
    if spline == "linear-rational":
        ul = raw[..., 2 * num_bins: 3 * num_bins]
        ud = raw[..., 3 * num_bins:]
        return rational_linear_spline(
            h2, uw, uh, ud, ul, inverse, "linear", TAIL_BOUND, num_bins,
            MIN_BIN, MIN_BIN, MIN_DERIV)
    if spline == "cubic":
        dl = raw[..., 2 * num_bins: 2 * num_bins + 1]
        dr = raw[..., 2 * num_bins + 1: 2 * num_bins + 2]
        return cubic_spline(h2, uw, uh, dl, dr, inverse, "linear",
                            TAIL_BOUND, num_bins, MIN_BIN, MIN_BIN)
    raise ValueError(f"unknown spline {spline}")


def _coupling(params, x, c, split: int, spline: str, inverse: bool):
    h1, h2 = x[..., :split], x[..., split:]
    raw = linear_a1d_apply(params["transform_net"], h1, c)
    raw = raw.reshape(h2.shape + (-1,))
    hidden = params["transform_net"]["w1"].shape[0]
    h2_t, ld = _piecewise(h2, raw, spline, inverse, hidden)
    logdet = torch.sum(ld.reshape(ld.shape[0], -1), dim=1)
    return torch.cat([h1, h2_t], dim=-1), logdet


def spline_coupling_forward(params, x, c, split: int,
                            spline: str = "quadratic"):
    """x: [B, ..., C] -> (y, logdet [B])."""
    return _coupling(params, x, c, split, spline, inverse=False)


def spline_coupling_inverse(params, z, c, split: int,
                            spline: str = "quadratic"):
    return _coupling(params, z, c, split, spline, inverse=True)
