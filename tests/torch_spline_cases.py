"""Spline-coupling cases on the card against the CPU, without jax.

`tests/test_torch_cuda.py` and `chip_smoke.py:phase_library` import this
module. A case is the spline coupling at the discrete flow's widths (3
channels split 1 and 2, hidden width 64, conditions of 128) with a
transform net whose every layer is non-zero (seeded init zeroes its head,
which makes every spline the same). The card runs it in float32; the
reference is the same call on the CPU in float64, which
`tests/test_torch_spline.py` holds to the JAX function's float64 values to
1e-9. The gates are that file's: outputs atol 2e-5; a lane's log-det 5e-4
plus its slope times two float32 ulps of the tail bound (the log-det is
steep next to the knots of narrow bins, and a float32 bin edge is rounded
by up to an ulp of the bound).
"""

import math

import numpy as np
import torch

from puflow_torch.flows import spline_coupling as sc
from puflow_torch.flows.coupling import linear_a1d_apply

OUT_ATOL, LD_ATOL = 2e-5, 5e-4
KINDS = ("quadratic", "linear-rational", "cubic")
CHANNELS, HIDDEN, COND = 3, 64, 128     # models/discrete.py: HDIM, widths


def coupling_case(seed: int, kind: str, split: int, patches: int,
                  points: int, device):
    """(params, x [patches, points, 3], c [patches, points, 128]) on
    ``device``; x ~ N(0, 2), so some lanes lie outside the tails."""
    rng = np.random.RandomState(seed)
    mult = sc.param_multiplier(kind)
    c_in = split + COND
    out = (CHANNELS - split) * mult
    net = {"w0": rng.randn(c_in, HIDDEN) / np.sqrt(c_in),
           "w1": rng.randn(HIDDEN, HIDDEN) / np.sqrt(HIDDEN),
           "b1": rng.randn(HIDDEN) * 0.1,
           "w2": rng.randn(HIDDEN, out) * 0.1,
           "b2": rng.randn(out) * 0.1}
    x = rng.randn(patches, points, CHANNELS) * 2
    c = rng.randn(patches, points, COND)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {"transform_net": {k: t(v) for k, v in net.items()}}, t(x), t(c)


def lanes(params, x, c, split: int, kind: str, inverse: bool):
    """Each lane's (out, logdet): the coupling's spline before its sum."""
    h1, h2 = x[..., :split], x[..., split:]
    raw = linear_a1d_apply(params["transform_net"], h1, c)
    raw = raw.reshape(h2.shape + (-1,))
    hidden = params["transform_net"]["w1"].shape[0]
    return sc._piecewise(h2, raw, kind, inverse, hidden)


def _cpu64(tree):
    return {k: _cpu64(v) if isinstance(v, dict) else v.detach().cpu().double()
            for k, v in tree.items()}


def logdet_gate(params64, x64, c64, split, kind, inverse, h=1e-7):
    """A lane's log-det gate: LD_ATOL plus |d logdet / dx| (central
    differences in float64; 0 within 2h of the tails, where the log-det
    jumps) times two float32 ulps of the tail bound."""
    step = torch.zeros_like(x64)
    step[..., split:] = h
    plus = lanes(params64, x64 + step, c64, split, kind, inverse)[1]
    minus = lanes(params64, x64 - step, c64, split, kind, inverse)[1]
    slope = (plus - minus).abs() / (2 * h)
    tb = sc.TAIL_BOUND
    slope = torch.where(x64[..., split:].abs() < tb - 2 * h, slope, 0.0)
    edge_ulp = 2.0 ** (math.floor(math.log2(tb)) - 23)
    return LD_ATOL + 2 * edge_ulp * slope


def check_direction(params, inp, c, split: int, kind: str,
                    inverse: bool) -> dict:
    """One direction of the coupling on ``inp``'s device in float32
    against the CPU in float64: each lane and the coupling's output.
    Raises past a gate; returns the largest errors and log-det gate."""
    p64 = _cpu64(params)
    inp64, c64 = inp.detach().cpu().double(), c.detach().cpu().double()
    out, ld = lanes(params, inp, c, split, kind, inverse)
    out64, ld64 = lanes(p64, inp64, c64, split, kind, inverse)
    gate = logdet_gate(p64, inp64, c64, split, kind, inverse)
    err_out = (out.cpu().double() - out64).abs()
    err_ld = (ld.cpu().double() - ld64).abs()
    name = f"{kind} split {split} {'inverse' if inverse else 'forward'}"
    if not (torch.isfinite(out).all() and torch.isfinite(ld).all()):
        raise AssertionError(f"{name}: not finite")
    if err_out.max() > OUT_ATOL:
        raise AssertionError(f"{name}: outputs {float(err_out.max()):.3g} "
                             f"from the CPU's float64 > {OUT_ATOL}")
    if (err_ld > gate).any():
        raise AssertionError(f"{name}: log-dets {float(err_ld.max()):.3g} "
                             "from the CPU's float64 past their gates")
    fn = sc.spline_coupling_inverse if inverse else sc.spline_coupling_forward
    err_full = float((fn(params, inp, c, split, kind)[0].cpu().double()
                      - fn(p64, inp64, c64, split, kind)[0]).abs().max())
    if err_full > OUT_ATOL:
        raise AssertionError(f"{name}: coupling outputs {err_full:.3g} from "
                             f"the CPU's float64 > {OUT_ATOL}")
    return {"out": max(float(err_out.max()), err_full),
            "logdet": float(err_ld.max()), "gate": float(gate.max())}


def check_against_cpu(params, x, c, split: int, kind: str) -> dict:
    """`check_direction` forward on ``x`` and inverse on its output; the
    largest errors and log-det gate of both."""
    z = sc.spline_coupling_forward(params, x, c, split, kind)[0]
    both = [check_direction(params, inp, c, split, kind, inverse)
            for inverse, inp in ((False, x), (True, z))]
    return {k: max(w[k] for w in both) for k in both[0]}
