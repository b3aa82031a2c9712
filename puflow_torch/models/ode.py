"""Adaptive Dormand-Prince (dopri5) ODE integration as plain tensor code.

Counterpart of `puflow_tpu.models.ode.odeint_dopri5`, the early-exit
loop (``differentiable=False``):

  * classic DP(4)5 tableau with FSAL, error = RK5 - RK4 embedded estimate,
    elementwise tolerance ``atol + rtol * max(|y|, |y_new|)``, RMS error
    norm over the whole state (every leaf of a tuple state together);
  * step-size controller ``h *= clip(0.9 * err^(-1/5), 0.1, 10)``, first
    step ``span / 16``;
  * at most ``max_steps`` attempts, accepted or rejected; an unconverged
    solve keeps its last state.

Integration runs backward when ``t1 < t0``. The controller's scalars are
0-dim float32 tensors on the state's device, so the arithmetic is the JAX
solver's; the loop reads one flag pair from the device per step, which is
what makes this the plain version: `ops.cnf` runs the same solve for the
shipped field as one kernel with no host read. The masked fixed-trip
loop and the continuous adjoint (`make_adjoint_odeint`) are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

# Dormand-Prince coefficients.
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
       187 / 2100, 1 / 40)
# error weights: the difference of the float32 tableau rows, taken in
# float32 as the JAX solver takes it (`csrc/cnf_solve.cu` does the same)
_E = tuple(float(np.float32(b5) - np.float32(b4))
           for b5, b4 in zip(_B5, _B4))

_SAFETY = 0.9
_MIN_FACTOR = 0.1
_MAX_FACTOR = 10.0
_ORDER = 5.0


def _weighted_sum(ks, w):
    """``sum_i w[i] * ks[i]`` over a list of leaf lists."""
    out = [x * w[0] for x in ks[0]]
    for i in range(1, len(ks)):
        out = [o + w[i] * x for o, x in zip(out, ks[i])]
    return out


def _error_ratio(err, y0, y1, rtol: float, atol: float) -> torch.Tensor:
    sums, count = 0.0, 0
    for e, a, b in zip(err, y0, y1):
        tol = atol + rtol * torch.maximum(a.abs(), b.abs())
        r = e / tol
        sums = sums + torch.sum(r * r)
        count += e.numel()
    return torch.sqrt(sums / count + 1e-24)


def _dp_step(func, t, y, h, k1):
    """One DP45 step on leaf lists -> (y5, err, k7); k7 is the field at
    ``(t + h, y_7)``, the next step's first stage (FSAL)."""
    ks = [k1]
    for i in range(1, 7):
        acc = [k * (_A[i][0] * h) for k in ks[0]]
        for j in range(1, i):
            acc = [a + k * (_A[i][j] * h) for a, k in zip(acc, ks[j])]
        y_i = [y_ + a for y_, a in zip(y, acc)]
        ks.append(func(t + _C[i] * h, y_i))
    y5 = [y_ + h * s for y_, s in zip(y, _weighted_sum(ks, _B5))]
    err = [h * s for s in _weighted_sum(ks, _E)]
    return y5, err, ks[6]


def odeint_dopri5(func, y0, t0, t1, rtol: float = 1e-5, atol: float = 1e-5,
                  max_steps: int = 128, differentiable: bool = True,
                  return_stats: bool = False):
    """Integrate ``dy/dt = func(t, y)`` from t0 to t1.

    Args:
      func: ``(t, y) -> dy`` with y a tensor, or a tuple of tensors when
        ``y0`` is one.
      y0: initial state, a tensor or a tuple of tensors.
      t0, t1: floats or 0-dim tensors; ``t1 < t0`` integrates backward.
      differentiable: only ``False`` (the early-exit loop) is ported; the
        default, as in the JAX package, is the masked fixed-trip loop.
      return_stats: also return ``{"steps": attempts, "accepted": accepted
        steps, "nfe": 1 + 6 * attempts}`` as Python ints.

    Returns:
      ``y(t1)`` in the structure of ``y0`` (the last state reached if
      ``max_steps`` attempts did not get there).
    """
    if differentiable:
        raise NotImplementedError(
            "odeint_dopri5(differentiable=True): the masked fixed-trip "
            "loop and the continuous adjoint are not ported yet "
            "(ROADMAP.md: CNF training)")
    single = isinstance(y0, torch.Tensor)
    y = [y0] if single else list(y0)
    dev = y[0].device

    def field(t, leaves):
        out = func(t, leaves[0] if single else tuple(leaves))
        return [out] if single else list(out)

    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
    direction = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)
    t, h = t0, direction * span / 16.0  # simple, robust initial step
    k1 = field(t0, y)
    done = bool(span <= 1e-12)
    n = accepted = 0
    while not done and n < max_steps:
        remaining = t1 - t
        # never step past t1
        h_c = torch.where(h.abs() > remaining.abs(), remaining, h)
        y5, err, k7 = _dp_step(field, t, y, h_c, k1)
        ratio = _error_ratio(err, y, y5, rtol, atol)
        accept = ratio <= 1.0
        factor = torch.clamp(
            _SAFETY * torch.clamp_min(ratio, 1e-10) ** (-1.0 / _ORDER),
            _MIN_FACTOR, _MAX_FACTOR)
        new_h = h_c * factor
        h = torch.where(new_h.abs() < 1e-12, h_c, new_h)
        t_n = torch.where(accept, t + h_c, t)
        done_n = torch.abs(t_n - t0) >= span - 1e-9
        took, done = torch.stack([accept, done_n]).tolist()
        if took:
            t, y, k1 = t_n, y5, k7
            accepted += 1
        n += 1
    out = y[0] if single else tuple(y)
    if return_stats:
        return out, {"steps": n, "accepted": accepted, "nfe": 1 + 6 * n}
    return out
