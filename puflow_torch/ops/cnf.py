"""Whole-solve dopri5 of one CNF block: the CUDA kernel and its plain version.

Counterpart of the TPU kernels `ops/pallas/cnf_pallas.py:cnf_solve_pallas`
and `cnf_solve_pallas_t` (here one kernel, `csrc/cnf_solve.cu`): the
adaptive Dormand-Prince integration of the plain (divergence-free)
ConcatSquashLinear + tanh field 3 -> 64 -> 64 -> 3 for every row of
``y [B, N, 3]`` from t0 to t1 in either direction, with one step size
shared by every row of the call (RMS error norm over all rows), FSAL, at
most ``max_steps`` attempts. t0 and t1 are tensors and stay on the device.

The condition enters each layer only through ``c @ w[1:]``, constant
during a solve: the wrapper computes those projections once (one matrix
product for all three layers, 262 floats a condition row) and the kernel
computes the field's own three products. ``c`` may have fewer rows than
``y``: ``[B, N / r, cdim]``, each condition row serving r consecutive rows
of ``y`` (the inverse pass on upsampled latents); the kernel indexes the
projections by ``row // r`` instead of repeating them.

Unlike the TPU dispatch there is no cap on rows: the kernel walks over
tiles of rows and keeps the state in device memory between steps.
"""

from __future__ import annotations

import torch

from puflow_torch.models.continuous import field_plain_csl
from puflow_torch.models.ode import odeint_dopri5
from puflow_torch.ops import _build

IDIM, HDIM = 3, 64                 # the field the kernel is built for
_PROJ = 4 * HDIM + 2 * IDIM        # projections of one condition row
_MAX_GRID = 1024                   # blocks the partial-sum scratch holds


def kernel_takes(layers) -> bool:
    """Whether a net is the kernel's: a plain list (no shared swish beta)
    of three ConcatSquashLinear layers 3 -> 64 -> 64 -> 3."""
    if isinstance(layers, dict) or len(layers) != 3:
        return False
    dims = [(IDIM, HDIM), (HDIM, HDIM), (HDIM, IDIM)]
    return all(
        set(p) == {"layer", "hyper_gate", "hyper_bias"}
        and tuple(p["layer"]["w"].shape) == d
        and p["hyper_gate"]["w"].shape[1] == d[1]
        and p["hyper_bias"]["w"].shape == p["hyper_gate"]["w"].shape
        for p, d in zip(layers, dims))


def _check(name: str, layers, c: torch.Tensor, y: torch.Tensor) -> int:
    """Validate shapes; returns r, the rows of ``y`` per condition row."""
    if y.ndim != 3 or y.shape[2] != IDIM or c.ndim != 3:
        raise ValueError(f"{name}: expects y [B, N, {IDIM}] and c "
                         f"[B, N / r, cdim], got {tuple(y.shape)} and "
                         f"{tuple(c.shape)}")
    if (c.shape[0] != y.shape[0] or c.shape[1] == 0
            or y.shape[1] % c.shape[1] != 0):
        raise ValueError(f"{name}: conditions {tuple(c.shape)} do not divide "
                         f"the rows of y {tuple(y.shape)}")
    if not kernel_takes(layers):
        raise ValueError(f"{name}: built for three ConcatSquashLinear layers "
                         f"{IDIM} -> {HDIM} -> {HDIM} -> {IDIM}")
    if layers[0]["hyper_gate"]["w"].shape[0] != c.shape[2] + 1:
        raise ValueError(f"{name}: the layers do not match the condition "
                         f"width {c.shape[2]}")
    return y.shape[1] // c.shape[1]


def cnf_solve_plain(layers, c: torch.Tensor, y: torch.Tensor, t0, t1,
                    rtol: float = 1e-5, atol: float = 1e-5,
                    max_steps: int = 128, return_stats: bool = False):
    """The solve as tensor ops on any device: `odeint_dopri5` on
    `field_plain_csl`, the conditions repeated where they serve r rows.
    With ``return_stats`` also ``{"steps", "accepted", "nfe"}``."""
    r = y.shape[1] // c.shape[1]
    if r != 1:
        c = torch.repeat_interleave(c, r, dim=1)
    return odeint_dopri5(field_plain_csl(layers, c), y, t0, t1, rtol, atol,
                         max_steps, differentiable=False,
                         return_stats=return_stats)


def _pack(layers):
    """What a launch needs of a net, in `csrc/cnf_solve.cu`'s order ->
    (weights, proj_w, proj_b): the layers' own weights (per layer W [in,
    out], b, gate_t, bias_t) as one vector, and the matrix and bias that
    project a condition row to its 262 values gate_c | bias_c of the three
    layers (gate1 | bias1 | gate2 | bias2 | gate3 | bias3)."""
    own, w, b = [], [], []
    for p in layers:
        gate, bias = p["hyper_gate"], p["hyper_bias"]
        own += [p["layer"]["w"], p["layer"]["b"], gate["w"][0], bias["w"][0]]
        w += [gate["w"][1:], bias["w"][1:]]
        b += [gate["b"], torch.zeros_like(gate["b"])]
    with torch.no_grad():
        return (torch.cat([t.reshape(-1) for t in own]).to(torch.float32)
                .contiguous(),
                torch.cat(w, dim=1).contiguous(), torch.cat(b))


# A net is packed once, not once a launch: id()s of its tensors -> (the
# tensors, which keeps the ids theirs; their versions, which an in-place
# update moves; the pack). A sample launches 12 solves on 6 nets.
_PACKS: dict = {}
_MAX_PACKS = 64


def _packed(layers):
    tensors = [t for p in layers
               for t in (p["layer"]["w"], p["layer"]["b"],
                         p["hyper_gate"]["w"], p["hyper_gate"]["b"],
                         p["hyper_bias"]["w"])]
    key = tuple(map(id, tensors))
    versions = tuple(t._version for t in tensors)
    hit = _PACKS.get(key)
    if hit is not None and hit[1] == versions:
        return hit[2]
    if len(_PACKS) >= _MAX_PACKS:
        _PACKS.clear()
    pack = _pack(layers)
    _PACKS[key] = (tensors, versions, pack)
    return pack


def _cnf_kernel(layers, c: torch.Tensor, y: torch.Tensor, t0, t1, r: int,
                rtol: float, atol: float, max_steps: int):
    """Launch `csrc/cnf_solve.cu` on CUDA tensors -> (y(t1), stats int32
    [2]: steps attempted, steps accepted; on the device)."""
    dev = y.device
    if (y.dtype != torch.float32 or c.dtype != torch.float32
            or c.device != dev):
        raise ValueError("cnf_solve: the kernel takes float32 y and c on one "
                         "device")
    if layers[0]["layer"]["w"].device != dev:
        raise ValueError(f"cnf_solve: the layers are not on {dev}")
    y = y.contiguous()
    n_rows = y.shape[0] * y.shape[1]
    out = torch.empty_like(y)
    stats = torch.zeros((2,), dtype=torch.int32, device=dev)
    if n_rows == 0:
        return out, stats
    t01 = torch.stack([
        torch.as_tensor(t0, dtype=torch.float32, device=dev).reshape(()),
        torch.as_tensor(t1, dtype=torch.float32, device=dev).reshape(())])
    weights, proj_w, proj_b = _packed(layers)
    proj = torch.addmm(proj_b, c.reshape(-1, c.shape[-1]), proj_w)
    state = torch.empty((4 * n_rows * IDIM,), dtype=torch.float32, device=dev)
    partials = torch.empty((2 * _MAX_GRID,), dtype=torch.float64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.puflow_cnf_solve(
            y.data_ptr(), proj.data_ptr(), weights.data_ptr(),
            t01.data_ptr(), n_rows, r, float(rtol), float(atol),
            int(max_steps), state.data_ptr(), partials.data_ptr(), _MAX_GRID,
            out.data_ptr(), stats.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "puflow_cnf_solve")
    cnf_solve.launches += 1
    if cnf_solve.stats_log is not None:
        cnf_solve.stats_log.append(stats)
    return out, stats


def cnf_solve_t(layers, c: torch.Tensor, y: torch.Tensor, t0, t1,
                rtol: float = 1e-5, atol: float = 1e-5, max_steps: int = 128,
                return_stats: bool = False):
    """Integrate the block's plain field from t0 to t1 (floats or 0-dim
    tensors; ``t1 < t0`` runs backward): the CUDA kernel for CUDA tensors,
    `cnf_solve_plain` for CPU tensors.

    Args:
      layers: the block's three ConcatSquashLinear param dicts.
      c: conditions ``[B, N / r, cdim]``, r >= 1.
      y: state ``[B, N, 3]``.
      return_stats: also return the step counts: from the kernel an int32
        tensor ``[attempted, accepted]`` on the device, from the plain
        version its stats dict.

    Returns:
      ``y(t1)`` ``[B, N, 3]``; the last state reached if ``max_steps``
      attempts did not get there.
    """
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cnf_solve: no kernel for {y.device}")
    r = _check("cnf_solve", layers, c, y)
    if y.device.type == "cpu":
        return cnf_solve_plain(layers, c, y, t0, t1, rtol, atol, max_steps,
                               return_stats)
    out, stats = _cnf_kernel(layers, c, y, t0, t1, r, rtol, atol, max_steps)
    return (out, stats) if return_stats else out


def cnf_solve(layers, c: torch.Tensor, y: torch.Tensor, T,
              reverse: bool = False, rtol: float = 1e-5, atol: float = 1e-5,
              max_steps: int = 128, return_stats: bool = False):
    """`cnf_solve_t` from 0 to the end time ``T`` (a float or a 0-dim
    tensor), or from ``T`` to 0 with ``reverse``."""
    t0, t1 = (T, 0.0) if reverse else (0.0, T)
    return cnf_solve_t(layers, c, y, t0, t1, rtol, atol, max_steps,
                       return_stats)


# Both entry points launch the one kernel and share its count. A caller
# that wants every launch's step counts sets `stats_log` to a list, which
# then receives each launch's stats tensor (on the device, not read here).
cnf_solve.launches = 0
cnf_solve.stats_log = None
