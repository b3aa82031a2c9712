"""Monotone piecewise spline transforms with analytic inverses and log-dets.

Counterpart of `puflow_tpu.flows.spline`:
  * `rational_quadratic_spline` (Durkan et al. neural spline flows),
  * `rational_linear_spline` (Dolatabadi et al., with learned lambdas),
  * `cubic_spline` (Steffen construction, Blinn-style root solving).

All transforms: identity linear tails outside [-tail_bound, tail_bound],
softmax-normalised bin widths/heights with minimum sizes, mask selects (no
boolean indexing). Inputs are clipped to the tails before the bin maths, so
the lanes that `torch.where` discards stay finite and so do their
gradients. Elementwise: ``inputs [...]``, parameters ``[..., k]``.

Four deviations from the JAX package, all in the cubic inverse, all the
same function in exact arithmetic:
  * its square roots go through `_safe_sqrt`, whose gradient is 0 where
    the argument is clipped to 0; the JAX function's is ``0 * inf`` there,
    which makes every gradient of its inverse NaN;
  * in the one-root case the smaller of Cardano's two terms comes from
    their product, not from the cube root of a difference that cancels
    (in float32 the JAX function's inverse is up to 4e-4 from its float64
    value on such lanes);
  * one Newton step on the bin's cubic polishes the chosen root, which the
    closed forms give to about eps * |b / a| (8e-5 in float32 on nearly
    quadratic bins of a coupling at the discrete flow's widths);
  * below the quadratic threshold, where both take the quadratic's root
    in place of the cubic's, that root comes in the form that does not
    cancel, as in the rational-quadratic inverse.
The root is chosen by the same comparisons in the same order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations, inputs, eps: float = 1e-6):
    """Index of the bin containing each input: the count of edges at or
    below it, the last edge raised by ``eps``."""
    locs = torch.cat([bin_locations[..., :-1], bin_locations[..., -1:] + eps],
                     dim=-1)
    return torch.sum(inputs[..., None] >= locs, dim=-1) - 1


def _cbrt(x):
    return torch.sign(x) * torch.exp(torch.log(torch.abs(x) + 1e-38) / 3.0)


def _clip(x, lo: float, hi: float):
    """`jnp.clip`: max then min, so an input on a bound gets half its
    gradient, as there."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _safe_sqrt(u):
    """``sqrt(max(u, 0))`` with gradient 0 where ``u <= 0``."""
    pos = u > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, u, torch.ones_like(u))),
                       torch.zeros_like(u))


def _normalise_bins(unnormalized, num_bins, min_size, left, right):
    """softmax bins -> (cum_edges [..., n+1], sizes [..., n])."""
    w = torch.softmax(unnormalized, dim=-1)
    w = min_size + (1 - min_size * num_bins) * w
    cum = (right - left) * torch.cumsum(w, dim=-1) + left
    edge = cum[..., :1]
    cum = torch.cat([torch.full_like(edge, left), cum[..., :-1],
                     torch.full_like(edge, right)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def _take(arr, idx):
    arr = arr.expand(*idx.shape, arr.shape[-1])
    return torch.gather(arr, -1, idx[..., None])[..., 0]


def _pad_derivatives(unnormalized_derivatives, min_derivative):
    """Interior derivatives padded with the constant whose softplus makes
    the boundary derivative 1 (linear tails)."""
    const = math.log(math.expm1(1 - min_derivative))
    return F.pad(unnormalized_derivatives, (1, 1), value=const)


def rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse: bool, tails: str = "linear",
        tail_bound: float = 5.0, num_bins: int = 64,
        min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
        min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
        min_derivative: float = DEFAULT_MIN_DERIVATIVE):
    """Monotone RQ spline. Shapes: inputs [...], params [..., num_bins(+1)];
    `unnormalized_derivatives` carries the num_bins - 1 interior values."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented")

    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    left, right = -tail_bound, tail_bound
    cumwidths, widths = _normalise_bins(unnormalized_widths, num_bins,
                                        min_bin_width, left, right)
    cumheights, heights = _normalise_bins(unnormalized_heights, num_bins,
                                          min_bin_height, left, right)
    derivatives = min_derivative + F.softplus(
        _pad_derivatives(unnormalized_derivatives, min_derivative))

    x = _clip(inputs, left, right)
    bin_idx = torch.clamp(
        _searchsorted(cumheights if inverse else cumwidths, x),
        0, num_bins - 1)

    in_cw = _take(cumwidths, bin_idx)
    in_w = _take(widths, bin_idx)
    in_ch = _take(cumheights, bin_idx)
    in_h = _take(heights, bin_idx)
    delta = _take(heights / widths, bin_idx)
    d0 = _take(derivatives, bin_idx)
    d1 = _take(derivatives[..., 1:], bin_idx)
    s = d0 + d1 - 2 * delta

    if inverse:
        y_rel = x - in_ch
        a = y_rel * s + in_h * (delta - d0)
        b = in_h * d0 - y_rel * s
        c = -delta * y_rel
        disc = torch.abs(b * b - 4 * a * c)
        theta = (2 * c) / (-b - torch.sqrt(disc))   # the stable root form
        out = theta * in_w + in_cw
        sign = -1.0
    else:
        theta = (x - in_cw) / in_w
        t1m = theta * (1 - theta)
        out = in_ch + (in_h * (delta * theta**2 + d0 * t1m)) / (delta + s * t1m)
        sign = 1.0

    t1m = theta * (1 - theta)
    denom = delta + s * t1m
    deriv_num = delta**2 * (d1 * theta**2 + 2 * delta * t1m
                            + d0 * (1 - theta) ** 2)
    logabsdet = sign * (torch.log(deriv_num) - 2 * torch.log(denom))

    out = torch.where(inside, out, inputs)
    logabsdet = torch.where(inside, logabsdet, 0.0)
    return out, logabsdet


def rational_linear_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, unnormalized_lambdas, inverse: bool,
        tails: str = "linear", tail_bound: float = 5.0, num_bins: int = 64,
        min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
        min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
        min_derivative: float = DEFAULT_MIN_DERIVATIVE):
    """Monotone rational-linear spline with a learned lambda vertex."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented")

    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    left, right = -tail_bound, tail_bound
    cumwidths, widths = _normalise_bins(unnormalized_widths, num_bins,
                                        min_bin_width, left, right)
    cumheights, heights = _normalise_bins(unnormalized_heights, num_bins,
                                          min_bin_height, left, right)
    derivatives = min_derivative + F.softplus(
        _pad_derivatives(unnormalized_derivatives, min_derivative))

    x = _clip(inputs, left, right)
    bin_idx = torch.clamp(
        _searchsorted(cumheights if inverse else cumwidths, x),
        0, num_bins - 1)

    in_cw = _take(cumwidths, bin_idx)
    in_w = _take(widths, bin_idx)
    in_ch = _take(cumheights, bin_idx)
    in_h = _take(heights, bin_idx)
    delta = _take(heights / widths, bin_idx)
    d0 = _take(derivatives, bin_idx)
    d1 = _take(derivatives[..., 1:], bin_idx)
    lam = _take(0.95 * torch.sigmoid(unnormalized_lambdas) + 0.025, bin_idx)

    wa = 1.0
    wb = torch.sqrt(d0 / d1) * wa
    wc = (lam * wa * d0 + (1 - lam) * wb * d1) / delta
    ya = in_ch
    yb = in_h + in_ch
    yc = ((1 - lam) * wa * ya + lam * wb * yb) / ((1 - lam) * wa + lam * wb)

    if inverse:
        low = x <= yc
        numerator = torch.where(low, lam * wa * (ya - x),
                                (wc - lam * wb) * x + lam * wb * yb - wc * yc)
        denominator = torch.where(low, (wc - wa) * x + wa * ya - wc * yc,
                                  (wc - wb) * x + wb * yb - wc * yc)
        theta = numerator / denominator
        out = theta * in_w + in_cw
        deriv_num = torch.where(low, wa * wc * lam * (yc - ya),
                                wb * wc * (1 - lam) * (yb - yc)) * in_w
    else:
        theta = (x - in_cw) / in_w
        low = theta <= lam
        numerator = torch.where(low, wa * ya * (lam - theta) + wc * yc * theta,
                                wc * yc * (1 - theta) + wb * yb * (theta - lam))
        denominator = torch.where(low, wa * (lam - theta) + wc * theta,
                                  wc * (1 - theta) + wb * (theta - lam))
        out = numerator / denominator
        deriv_num = torch.where(low, wa * wc * lam * (yc - ya),
                                wb * wc * (1 - lam) * (yb - yc)) / in_w

    logabsdet = torch.log(deriv_num) - 2 * torch.log(torch.abs(denominator))
    out = torch.where(inside, out, inputs)
    logabsdet = torch.where(inside, logabsdet, 0.0)
    return out, logabsdet


def _unit_cumsum(unnormalized, num_bins, min_size):
    """softmax bins -> cumulative edges [..., n+1] over [0, 1]."""
    w = torch.softmax(unnormalized, dim=-1)
    w = min_size + (1 - min_size * num_bins) * w
    cum = torch.cumsum(w, dim=-1)
    edge = cum[..., :1]
    return torch.cat([torch.zeros_like(edge), cum[..., :-1],
                      torch.ones_like(edge)], dim=-1)


def cubic_spline(inputs, unnormalized_widths, unnormalized_heights,
                 unnorm_derivatives_left, unnorm_derivatives_right,
                 inverse: bool, tails: str = "linear",
                 tail_bound: float = 5.0, num_bins: int = 64,
                 min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
                 eps: float = 1e-5, quadratic_threshold: float = 1e-3):
    """Monotone cubic spline (Steffen construction, Blinn root solving)."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented")

    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    left = bottom = -tail_bound
    right = top = tail_bound

    x = _clip(inputs, left, right)
    x01 = (x - (bottom if inverse else left)) / (top - bottom)

    cumw = _unit_cumsum(unnormalized_widths, num_bins, min_bin_width)
    cumh = _unit_cumsum(unnormalized_heights, num_bins, min_bin_height)

    widths = cumw[..., 1:] - cumw[..., :-1]
    slopes = (cumh[..., 1:] - cumh[..., :-1]) / widths
    min1 = torch.minimum(torch.abs(slopes[..., :-1]),
                         torch.abs(slopes[..., 1:]))
    min2 = (0.5 * (widths[..., 1:] * slopes[..., :-1]
                   + widths[..., :-1] * slopes[..., 1:])
            / (widths[..., :-1] + widths[..., 1:]))
    interior = torch.minimum(min1, min2) * (
        torch.sign(slopes[..., :-1]) + torch.sign(slopes[..., 1:]))
    d_left = torch.sigmoid(unnorm_derivatives_left) * 3 * slopes[..., :1]
    d_right = torch.sigmoid(unnorm_derivatives_right) * 3 * slopes[..., -1:]
    derivs = torch.cat([d_left, interior, d_right], dim=-1)

    a = (derivs[..., :-1] + derivs[..., 1:] - 2 * slopes) / widths**2
    b = (3 * slopes - 2 * derivs[..., :-1] - derivs[..., 1:]) / widths
    c = derivs[..., :-1]
    d = cumh[..., :-1]

    bin_idx = torch.clamp(_searchsorted(cumh if inverse else cumw, x01),
                          0, num_bins - 1)
    ia, ib, ic, idd = (_take(v, bin_idx) for v in (a, b, c, d))
    lcw = _take(cumw, bin_idx)
    rcw = _take(cumw[..., 1:], bin_idx)

    if inverse:
        # depressed cubic + Blinn root selection
        b_ = (ib / ia) / 3.0
        c_ = (ic / ia) / 3.0
        d_ = (idd - x01) / ia
        delta1 = -b_**2 + c_
        delta2 = -c_ * b_ + d_
        delta3 = b_ * d_ - c_**2
        disc = 4.0 * delta1 * delta3 - delta2**2
        dep1 = -2.0 * b_ * delta1 + delta2
        dep2 = delta1

        # one real root (disc < 0): Cardano's p + q with p q = -dep2. The
        # cube root of the sum without cancellation gives the larger term,
        # the product the other (the difference loses every digit in
        # float32 where sq is close to |dep1|)
        sq = _safe_sqrt(-disc)
        p = _cbrt((-dep1 + torch.where(dep1 <= 0, sq, -sq)) / 2.0)
        nonzero = p != 0
        q = torch.where(nonzero, -dep2 / torch.where(nonzero, p, 1.0), 0.0)
        one_root = (p + q) - b_ + lcw

        # three real roots (disc >= 0)
        theta3 = torch.atan2(_safe_sqrt(disc), -dep1) / 3.0
        cr1, cr2 = torch.cos(theta3), torch.sin(theta3)
        scale = 2 * _safe_sqrt(-dep2)
        shift = -b_ + lcw
        r1 = cr1 * scale + shift
        r2 = (-0.5 * cr1 - 0.5 * math.sqrt(3) * cr2) * scale + shift
        r3 = (-0.5 * cr1 + 0.5 * math.sqrt(3) * cr2) * scale + shift

        def in_bin(r):
            return ((lcw - eps) < r) & (r < (rcw + eps))

        three_root = torch.where(in_bin(r1), r1,
                                 torch.where(in_bin(r2), r2, r3))
        out01 = torch.where(disc < 0, one_root, three_root)

        # one Newton step on the bin's cubic: the roots above lose digits
        # in float32 where the bin is nearly quadratic (|b / a| large)
        shifted = out01 - lcw
        f = ((ia * shifted + ib) * shifted + ic) * shifted + idd - x01
        fp = (3 * ia * shifted + 2 * ib) * shifted + ic
        rising = fp > 0
        out01 = out01 - torch.where(
            rising, f / torch.where(rising, fp, torch.ones_like(fp)), 0.0)

        # nearly-quadratic bins: the quadratic's root, in the
        # 2c / (-b - sqrt(disc)) form (b = ic > 0 in a rising bin)
        qa, qb, qc = ib, ic, idd - x01
        quad = (-2 * qc) / (qb + _safe_sqrt(qb**2 - 4 * qa * qc))
        out01 = torch.where(torch.abs(ia) < quadratic_threshold, quad + lcw,
                            out01)

        shifted = out01 - lcw
        logabsdet = -torch.log(3 * ia * shifted**2 + 2 * ib * shifted + ic)
        out = out01 * (right - left) + left
        logabsdet = logabsdet - math.log(top - bottom) + math.log(
            right - left)
    else:
        shifted = x01 - lcw
        out01 = ia * shifted**3 + ib * shifted**2 + ic * shifted + idd
        logabsdet = torch.log(3 * ia * shifted**2 + 2 * ib * shifted + ic)
        out = out01 * (top - bottom) + bottom
        logabsdet = logabsdet + math.log(top - bottom) - math.log(
            right - left)

    out = torch.where(inside, out, inputs)
    logabsdet = torch.where(inside, logabsdet, 0.0)
    return out, logabsdet
