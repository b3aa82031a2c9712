"""Whole-solve dopri5 of one CNF block: CUDA kernels and plain versions.

Three kernels, each with its plain version beside it:

  * `cnf_solve` / `cnf_solve_t` (`csrc/cnf_solve.cu`), counterpart of the
    TPU kernels `ops/pallas/cnf_pallas.py:cnf_solve_pallas` and
    `cnf_solve_pallas_t`;
  * `cnf_solve_logp` (`csrc/cnf_solve.cu:puflow_cnf_solve_logp`),
    counterpart of `cnf_pallas.py:cnf_solve_logp_pallas`: the same solve
    of the field with its exact-trace log-density channel, the forward
    solve of the f path's adjoint in training;
  * `cnf_adjoint_bwd` (`csrc/cnf_adjoint.cu`), counterpart of
    `ops/pallas/cnf_adjoint_pallas.py:cnf_adjoint_bwd_pallas`: the backward
    solve of the continuous adjoint, with or without the trace.

`cnf_solve` is the adaptive Dormand-Prince integration of the plain
(divergence-free) ConcatSquashLinear + tanh field 3 -> 64 -> 64 -> 3 for
every row of ``y [B, N, 3]`` from t0 to t1 in either direction, with one
step size shared by every row of the call (RMS error norm over all rows),
FSAL, at most ``max_steps`` attempts. t0 and t1 are tensors and stay on
the device. The other two share this design.

The condition enters each layer only through ``c @ w[1:]``, constant
during a solve: the wrappers compute those projections once (one matrix
product for all three layers, 262 floats a condition row) and the kernel
computes the field's own three products. ``c`` may have fewer rows than
``y``: ``[B, N / r, cdim]``, each condition row serving r consecutive rows
of ``y`` (the inverse pass on upsampled latents); the kernel indexes the
projections by ``row // r`` instead of repeating them.

Unlike the TPU dispatch there is no cap on rows: the kernel walks over
tiles of rows and keeps the state in device memory between steps.

Data parallel (``group=`` a `parallel.Group` of more than one rank): each
rank holds its shard of the batch and every step is decided on the
global batch's error norm. The plain versions pass the group to
`odeint_dopri5`; on CUDA tensors both solves run the kernel's per-attempt
mode (`_attempt_solve`): a launch an attempt, this rank's error sum and
entry count exchanged exactly between launches (`parallel.gather_batch`)
and added in rank order by the next launch, so every rank takes the same
steps. ``per_attempt=True`` runs that mode at any world size (with a
group of one rank, or no group and no exchange): at world size 1 it is
the one-launch kernel bit for bit. The exchange is a collective per
attempt: it does not go through the ``puflow::cnf_solve`` op.
`cnf_adjoint_bwd` takes a group the same way (its per-attempt mode,
`csrc/cnf_adjoint_attempt.cu`), where the parameters' cotangent G is
replicated: the ranks exchange every G entry's two quadrature sums each
attempt, so that each entry's tolerance is the global G's, and each rank
returns its own part of G.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from puflow_torch.models.continuous import (exact_div_field, field_plain_csl,
                                            field_with_exact_div, plain_field)
from puflow_torch.models.ode import adjoint_backward, odeint_dopri5
from puflow_torch.ops import _build
from puflow_torch.ops.encoder import b_fragments
from puflow_torch.parallel.mesh import gather_batch, is_distributed

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
                    max_steps: int = 128, return_stats: bool = False,
                    group=None):
    """The solve as tensor ops on any device: `odeint_dopri5` on
    `field_plain_csl`, the conditions repeated where they serve r rows.
    With ``return_stats`` also ``{"steps", "accepted", "nfe"}``; with a
    ``group`` of more than one rank, ``y`` is this rank's shard and the
    steps are the global batch's."""
    r = y.shape[1] // c.shape[1]
    if r != 1:
        c = torch.repeat_interleave(c, r, dim=1)
    return odeint_dopri5(field_plain_csl(layers, c), y, t0, t1, rtol, atol,
                         max_steps, differentiable=False,
                         return_stats=return_stats, group=group)


def _pack(layers):
    """A net in `csrc/cnf_field.cuh`'s order -> (weights, proj_w, proj_b):
    the layers' own weights (per layer W [in, out], b, gate_t, bias_t) as
    one vector, and the matrix and bias that project a condition row to
    its 262 values gate_c | bias_c of the three layers (gate1 | bias1 |
    gate2 | bias2 | gate3 | bias3)."""
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


def _field_weights(layers):
    """What every CNF kernel reads of a net -> (weights, proj_w, proj_b):
    `_pack`'s, the weights followed by zeros to a multiple of 4 floats and
    the B fragments (`ops/encoder.py:fragment_order`, f32 pairs) of W2 and
    of W2^T, the operands of the kernels' 64 x 64 products."""
    own, proj_w, proj_b = _pack(layers)
    w2 = layers[1]["layer"]["w"].to(torch.float32)
    with torch.no_grad():
        weights = torch.cat([own, own.new_zeros(-own.numel() % 4),
                             b_fragments(w2, False),
                             b_fragments(w2.t().contiguous(), False)])
    return weights.contiguous(), proj_w, proj_b


def _net_tensors(layers) -> list:
    return [t for p in layers
            for t in (p["layer"]["w"], p["layer"]["b"],
                      p["hyper_gate"]["w"], p["hyper_gate"]["b"],
                      p["hyper_bias"]["w"])]


def _packed(layers):
    """`_field_weights` once a net, for all three kernels (a sample
    launches 12 solves on 6 nets)."""
    return _build.packed(_net_tensors(layers),
                         lambda: _field_weights(layers))


def _t01(t0, t1, dev) -> torch.Tensor:
    return torch.stack([
        torch.as_tensor(t0, dtype=torch.float32, device=dev).reshape(()),
        torch.as_tensor(t1, dtype=torch.float32, device=dev).reshape(())])


def _on_card(name: str, layers, dev, *tensors) -> None:
    if any(t.dtype != torch.float32 or t.device != dev for t in tensors):
        raise ValueError(f"{name}: the kernel takes float32 tensors on one "
                         "device")
    if layers[0]["layer"]["w"].device != dev:
        raise ValueError(f"{name}: the layers are not on {dev}")


def _cnf_kernel(layers, c: torch.Tensor, y: torch.Tensor, t0, t1, r: int,
                rtol: float, atol: float, max_steps: int):
    """Launch `csrc/cnf_solve.cu` on CUDA tensors -> (y(t1), stats int32
    [2]: steps attempted, steps accepted; on the device)."""
    dev = y.device
    _on_card("cnf_solve", layers, dev, c, y)
    y = y.contiguous()
    n_rows = y.shape[0] * y.shape[1]
    out = torch.empty_like(y)
    stats = torch.zeros((2,), dtype=torch.int32, device=dev)
    if n_rows == 0:
        return out, stats
    t01 = _t01(t0, t1, dev)
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
    return out, stats


@torch.library.custom_op("puflow::cnf_solve", mutates_args=(),
                         device_types="cuda")
def _cnf_solve_op(c: torch.Tensor, y: torch.Tensor, t0: torch.Tensor,
                  t1: torch.Tensor, leaves: list[torch.Tensor], tree: str,
                  rtol: float, atol: float,
                  max_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    out, stats = _cnf_kernel(_build.unflatten(leaves, tree), c, y, t0, t1,
                             y.shape[1] // c.shape[1], rtol, atol, max_steps)
    cnf_solve.launches += 1
    return out, stats


@_cnf_solve_op.register_kernel("cpu")
def _(c, y, t0, t1, leaves, tree, rtol, atol, max_steps):
    out, st = cnf_solve_plain(_build.unflatten(leaves, tree), c, y, t0, t1,
                              rtol, atol, max_steps, return_stats=True)
    # no step taken: `odeint_dopri5` hands back y itself, which an op's output
    # may not be
    out = out.clone() if out is y else out
    return out, torch.tensor([st["steps"], st["accepted"]],
                             dtype=torch.int32)


@_cnf_solve_op.register_fake
def _(c, y, t0, t1, leaves, tree, rtol, atol, max_steps):
    return torch.empty_like(y), y.new_empty((2,), dtype=torch.int32)


def _time(t, dev) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _attempt_solve(name, layers, c, y, logp0, t0, t1, r, rtol, atol,
                   max_steps, group):
    """A solve in the per-attempt mode (`csrc/cnf_solve_attempt.cu`) on
    CUDA tensors (``logp0`` None: the plain field) -> (y(t1), logp(t1) or
    None, stats int32 [2] on the device). One launch an attempt; after each, the host
    reads the finished flag and, with a group, the ranks exchange their
    (error sum, entry count) pairs, which the next launch adds in rank
    order. Every rank makes the same launches and exchanges, a rank with
    no rows too. Counts its launches in `attempt_launches` of the
    solve's wrapper."""
    dev = y.device
    _on_card(name, layers, dev, c, y, *(() if logp0 is None else (logp0,)))
    y = y.contiguous()
    n_rows = y.shape[0] * y.shape[1]
    out_y = torch.empty_like(y)
    out_lp = None if logp0 is None else torch.empty_like(logp0)
    ch = IDIM if logp0 is None else IDIM + 1
    weights, proj_w, proj_b = _packed(layers)
    proj = torch.addmm(proj_b, c.reshape(-1, c.shape[-1]), proj_w)
    state = torch.empty((max(4 * ch * n_rows, 1),), dtype=torch.float32,
                        device=dev)
    partials = torch.empty((_MAX_GRID,), dtype=torch.float64, device=dev)
    stats = torch.zeros((2,), dtype=torch.int32, device=dev)
    ctrl = torch.zeros((17,), dtype=torch.int32, device=dev)
    local = torch.zeros((2,), dtype=torch.float64, device=dev)
    exchange, world = local, 1
    t01 = _t01(t0, t1, dev)
    counter = cnf_solve if logp0 is None else cnf_solve_logp
    lib = _build.library()
    solve_args = (_ptr(y), _ptr(logp0), _ptr(proj), _ptr(weights), _ptr(t01),
                  n_rows, r, float(rtol), float(atol), int(max_steps),
                  _ptr(state), _ptr(partials), _MAX_GRID, _ptr(out_y),
                  _ptr(out_lp), _ptr(stats))
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)
        for attempt in range(max_steps + 1):
            code = lib.puflow_cnf_solve_attempt(
                *solve_args, attempt, exchange.data_ptr(), world,
                ctrl.data_ptr(), local.data_ptr(), stream)
            _build.check(code, "puflow_cnf_solve_attempt")
            counter.attempt_launches += 1
            if int(ctrl[8 * (attempt & 1) + 5]):
                break
            if group is not None:
                exchange = gather_batch(local.view(1, 2), group)
                world = group.world_size
        else:
            raise RuntimeError(f"{name}: the per-attempt solve did not finish "
                               f"within {max_steps} attempts")
    return out_y, out_lp, stats


def _per_attempt(y: torch.Tensor, group, per_attempt: bool) -> bool:
    if per_attempt and y.device.type != "cuda":
        raise ValueError("per_attempt: the per-attempt kernel takes CUDA "
                         "tensors")
    return y.device.type == "cuda" and (per_attempt or is_distributed(group))


def cnf_solve_t(layers, c: torch.Tensor, y: torch.Tensor, t0, t1,
                rtol: float = 1e-5, atol: float = 1e-5, max_steps: int = 128,
                return_stats: bool = False, group=None,
                per_attempt: bool = False):
    """Integrate the block's plain field from t0 to t1 (floats or 0-dim
    tensors; ``t1 < t0`` runs backward) through the op
    ``puflow::cnf_solve``: the CUDA kernel for CUDA tensors,
    `cnf_solve_plain` for CPU tensors.

    Args:
      layers: the block's three ConcatSquashLinear param dicts.
      c: conditions ``[B, N / r, cdim]``, r >= 1.
      y: state ``[B, N, 3]``.
      return_stats: also return the step counts: from the kernel an int32
        tensor ``[attempted, accepted]`` on the device, from the plain
        version its stats dict.
      group: a `parallel.Group`; with more than one rank ``y`` is this
        rank's shard and every step is the global batch's: the kernel's
        per-attempt mode on CUDA tensors, `cnf_solve_plain` with the group
        on CPU tensors (module docstring), not through the op.
      per_attempt: run the per-attempt mode (CUDA tensors) at any world
        size, exchanging through ``group`` if one is given.

    Returns:
      ``y(t1)`` ``[B, N, 3]``; the last state reached if ``max_steps``
      attempts did not get there.
    """
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cnf_solve: no kernel for {y.device}")
    r = _check("cnf_solve", layers, c, y)
    if _per_attempt(y, group, per_attempt):
        out, _, stats = _attempt_solve("cnf_solve", layers, c, y, None, t0,
                                       t1, r, rtol, atol, max_steps, group)
        cnf_solve.launches += 1
    elif is_distributed(group):
        return cnf_solve_plain(layers, c, y, t0, t1, rtol, atol, max_steps,
                               return_stats, group)
    else:
        leaves, tree = _build.flatten(list(layers))
        out, stats = torch.ops.puflow.cnf_solve(
            c, y, _time(t0, y.device), _time(t1, y.device), leaves, tree,
            float(rtol), float(atol), int(max_steps))
    if y.device.type == "cuda" and cnf_solve.stats_log is not None:
        cnf_solve.stats_log.append(stats)
    if not return_stats:
        return out
    if y.device.type == "cpu":
        steps, accepted = stats.tolist()
        stats = {"steps": steps, "accepted": accepted, "nfe": 1 + 6 * steps}
    return out, stats


def cnf_solve(layers, c: torch.Tensor, y: torch.Tensor, T,
              reverse: bool = False, rtol: float = 1e-5, atol: float = 1e-5,
              max_steps: int = 128, return_stats: bool = False, group=None,
              per_attempt: bool = False):
    """`cnf_solve_t` from 0 to the end time ``T`` (a float or a 0-dim
    tensor), or from ``T`` to 0 with ``reverse``."""
    t0, t1 = (T, 0.0) if reverse else (0.0, T)
    return cnf_solve_t(layers, c, y, t0, t1, rtol, atol, max_steps,
                       return_stats, group, per_attempt)


# Both entry points launch the one kernel and share its count: one a
# solve, in either mode; `attempt_launches` counts the per-attempt mode's
# launches (one an attempt and one to finish). A caller that wants every
# solve's step counts sets `stats_log` to a list, which then receives each
# solve's stats tensor (on the device, not read here).
cnf_solve.launches = 0
cnf_solve.attempt_launches = 0
cnf_solve.stats_log = None


# --------------------------------------------------------------------------
# The log-density solve
# --------------------------------------------------------------------------
def _repeat(c: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The conditions with each row repeated for the r rows of y it
    serves."""
    r = y.shape[1] // c.shape[1]
    return c if r == 1 else torch.repeat_interleave(c, r, dim=1)


def cnf_solve_logp_plain(layers, c: torch.Tensor, y: torch.Tensor,
                         logp0: torch.Tensor, t0, t1, rtol: float = 1e-5,
                         atol: float = 1e-5, max_steps: int = 128,
                         return_stats: bool = False, group=None):
    """The log-density solve as tensor ops on any device: `odeint_dopri5`
    on `field_with_exact_div`, state ``(y, logp)``, one error norm over
    both. With ``return_stats`` also ``{"steps", "accepted", "nfe"}``;
    ``group`` as `cnf_solve_plain`'s."""
    return odeint_dopri5(field_with_exact_div(layers, _repeat(c, y)),
                         (y, logp0), t0, t1, rtol, atol, max_steps,
                         differentiable=False, return_stats=return_stats,
                         group=group)


def _logp_kernel(layers, c, y, logp0, t0, t1, r, rtol, atol, max_steps):
    """Launch `csrc/cnf_solve.cu:puflow_cnf_solve_logp` -> (y(t1), logp(t1),
    stats int32 [2] on the device)."""
    dev = y.device
    _on_card("cnf_solve_logp", layers, dev, c, y, logp0)
    y = y.contiguous()
    logp0 = logp0.contiguous()
    n_rows = y.shape[0] * y.shape[1]
    out_y, out_lp = torch.empty_like(y), torch.empty_like(logp0)
    stats = torch.zeros((2,), dtype=torch.int32, device=dev)
    if n_rows == 0:
        return out_y, out_lp, stats
    weights, proj_w, proj_b = _packed(layers)
    proj = torch.addmm(proj_b, c.reshape(-1, c.shape[-1]), proj_w)
    state = torch.empty((16 * n_rows,), dtype=torch.float32, device=dev)
    partials = torch.empty((2 * _MAX_GRID,), dtype=torch.float64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.puflow_cnf_solve_logp(
            y.data_ptr(), logp0.data_ptr(), proj.data_ptr(),
            weights.data_ptr(), _t01(t0, t1, dev).data_ptr(), n_rows, r,
            float(rtol), float(atol), int(max_steps), state.data_ptr(),
            partials.data_ptr(), _MAX_GRID, out_y.data_ptr(),
            out_lp.data_ptr(), stats.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "puflow_cnf_solve_logp")
    cnf_solve_logp.launches += 1
    if cnf_solve_logp.stats_log is not None:
        cnf_solve_logp.stats_log.append(stats)
    return out_y, out_lp, stats


def cnf_solve_logp(layers, c: torch.Tensor, y: torch.Tensor,
                   logp0: torch.Tensor, t0, t1, rtol: float = 1e-5,
                   atol: float = 1e-5, max_steps: int = 128,
                   return_stats: bool = False, group=None,
                   per_attempt: bool = False):
    """Integrate the block's field with its exact-trace log-density
    channel, ``d(y, logp)/dt = (f, -div f)``, from t0 to t1: the CUDA
    kernel for CUDA tensors, `cnf_solve_logp_plain` for CPU tensors.

    Args:
      layers: the block's three ConcatSquashLinear param dicts.
      c: conditions ``[B, N / r, cdim]``, r >= 1.
      y, logp0: state ``[B, N, 3]`` and ``[B, N, 1]``.
      return_stats: also return the step counts, as `cnf_solve_t` does.
      group, per_attempt: as `cnf_solve_t`'s.

    Returns:
      ``(y(t1), logp(t1))``.
    """
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cnf_solve_logp: no kernel for {y.device}")
    r = _check("cnf_solve_logp", layers, c, y)
    if logp0.shape != y.shape[:-1] + (1,):
        raise ValueError(f"cnf_solve_logp: logp0 {tuple(logp0.shape)} is not "
                         f"[B, N, 1] of y {tuple(y.shape)}")
    if _per_attempt(y, group, per_attempt):
        out_y, out_lp, stats = _attempt_solve(
            "cnf_solve_logp", layers, c, y, logp0.contiguous(), t0, t1, r,
            rtol, atol, max_steps, group)
        cnf_solve_logp.launches += 1
        if cnf_solve_logp.stats_log is not None:
            cnf_solve_logp.stats_log.append(stats)
    elif y.device.type == "cpu":
        return cnf_solve_logp_plain(layers, c, y, logp0, t0, t1, rtol, atol,
                                    max_steps, return_stats, group)
    else:
        out_y, out_lp, stats = _logp_kernel(layers, c, y, logp0, t0, t1, r,
                                            rtol, atol, max_steps)
    return ((out_y, out_lp), stats) if return_stats else (out_y, out_lp)


# One a solve in either mode; `attempt_launches` as `cnf_solve`'s.
cnf_solve_logp.launches = 0
cnf_solve_logp.attempt_launches = 0
cnf_solve_logp.stats_log = None


# --------------------------------------------------------------------------
# The backward solve of the continuous adjoint
# --------------------------------------------------------------------------
def _like(layers, grads):
    """Per-layer gradient dicts in the key order of ``layers``, so that the
    gradient tree flattens as the parameter tree does."""
    return [{k: {kk: g[k][kk] for kk in p[k]} for k in p}
            for p, g in zip(layers, grads)]


def _sum_repeats(dc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The cotangent of repeated conditions summed back onto ``c``'s rows
    (the backward of `_repeat`)."""
    B, n, cdim = c.shape
    return dc.reshape(B, n, -1, cdim).sum(dim=2)


def cnf_adjoint_bwd_plain(layers, c: torch.Tensor, y1: torch.Tensor,
                          a1: torch.Tensor, ap: torch.Tensor, t0, t1,
                          rtol: float = 1e-5, atol: float = 1e-5,
                          max_steps: int = 128, with_trace: bool = True,
                          logp1: torch.Tensor | None = None,
                          return_stats: bool = False, group=None):
    """The backward solve as tensor ops on any device: `adjoint_backward`
    of the exact-trace field (state ``((y, logp), (a, ap), {"layers",
    "c"})``) or, without the trace, of the plain field (state ``(y, a,
    {"layers", "c"})``), from t1 to t0, the conditions repeated where they
    serve r rows, as `make_adjoint_odeint`'s backward solves them. ``logp1``
    (zeros if None) enters only the error norm. With a ``group`` of more
    than one rank the rows are this rank's shard, every step is the global
    batch's, the layers' cotangent enters the error norm as one replicated
    leaf (`adjoint_backward`) and comes back as this rank's part of it.

    Returns ``(y0, a0, dc, dlayers, (f1, div1, f0, div0))``: the start
    state, its cotangent, the cotangent of ``c`` (summed over repeats),
    that of each layer's parameters, and the field and its trace at both
    ends (the trace zero without ``with_trace``); with ``return_stats``
    also the driver's stats.
    """
    p = {"layers": layers, "c": _repeat(c, y1)}
    zeros = torch.zeros(y1.shape[:-1] + (1,), dtype=y1.dtype,
                        device=y1.device)
    if with_trace:
        func = exact_div_field()
        state1 = (y1, zeros if logp1 is None else logp1)
        bar1 = (a1, ap)
    else:
        func, state1, bar1 = plain_field(), y1, a1
    replicated = {"layers": tree_map(lambda _: True, layers), "c": False}
    out = adjoint_backward(func, p, state1, bar1, t1, t0, rtol, atol,
                           max_steps, return_stats=True, group=group,
                           replicated=replicated)
    (state0, bar0, g), stats = out
    with torch.no_grad():
        f1, f0 = func(p, t1, state1), func(p, t0, state0)
    if with_trace:
        y0, a0 = state0[0], bar0[0]
        bnd = (f1[0], -f1[1], f0[0], -f0[1])
    else:
        y0, a0 = state0, bar0
        bnd = (f1, zeros, f0, zeros)
    res = (y0, a0, _sum_repeats(g["c"], c), _like(layers, g["layers"]), bnd)
    return res + (stats,) if return_stats else res


# the packed gradient `csrc/cnf_adjoint.cu` writes: per layer W [in, out],
# then db, dgate_t, dbias_t, dgate_b [out] each (5,004 floats), then the
# gradient of the projection matrix `_pack` makes, [cdim, 264] (its last
# two columns padding)
_G_OWN = 5004
_LD_PROJ = 264
# per row: y, a and the FSAL stage (two copies each), q of the FSAL stage
# (two copies); per condition row and block, the stage sums Q5, QE of q
_ROW_FLOATS = 32 + 2 * _LD_PROJ
_ADJ_CDIM = 16                       # the kernel's condition widths' multiple


def _wct(proj_w: torch.Tensor, cpad: int) -> torch.Tensor:
    """The projection matrix transposed, zero-padded to [264, cpad], as B
    fragments (f32 pairs)."""
    with torch.no_grad():
        wct = F.pad(proj_w.t(), (0, cpad - proj_w.shape[0],
                                 0, _LD_PROJ - proj_w.shape[1]))
        return b_fragments(wct, False).contiguous()


def _adjoint_pack(layers, cpad: int):
    """What `csrc/cnf_adjoint.cu` reads of a net -> (weights, wct):
    `_field_weights`' weights, and `_wct` of its projection matrix."""
    weights, proj_w, _ = _field_weights(layers)
    return weights, _wct(proj_w, cpad)


def _adjoint_packed(layers, cpad: int):
    """`_adjoint_pack` once a net and condition width: the weights are the
    solves' pack (`_packed`)."""
    weights, proj_w, _ = _packed(layers)
    return weights, _build.packed(_net_tensors(layers),
                                  lambda: _wct(proj_w, cpad),
                                  f"cnf_adjoint_{cpad}")


def _unpack_grads(layers, g: torch.Tensor, cdim: int):
    """The kernel's packed gradient -> one dict per layer, the params'
    shapes."""
    gc = g[_G_OWN:].view(-1, _LD_PROJ)[:cdim]
    grads, off, col = [], 0, 0
    for p in layers:
        din, dout = p["layer"]["w"].shape
        w = g[off:off + din * dout].view(din, dout)
        off += din * dout
        db, dgt, dbt, dgb = g[off:off + 4 * dout].view(4, dout)
        off += 4 * dout
        gate_c = gc[:, col:col + dout]
        bias_c = gc[:, col + dout:col + 2 * dout]
        col += 2 * dout
        grads.append({
            "layer": {"w": w, "b": db},
            "hyper_gate": {"w": torch.cat([dgt[None], gate_c]), "b": dgb},
            "hyper_bias": {"w": torch.cat([dbt[None], bias_c])}})
    return _like(layers, grads)


# floats after the two G vectors of an exchange of the per-attempt
# adjoint: the row terms' sum and count (doubles), the grid, padding
_EXCHANGE_TAIL = 6


def _adjoint_kernel(layers, c, y1, a1, ap, logp1, t0, t1, r, rtol, atol,
                    max_steps, with_trace, group=None, per_attempt=False):
    """Launch `csrc/cnf_adjoint.cu` (``per_attempt``: its per-attempt mode,
    `_adjoint_attempts`) -> (y0, a0, dc, dlayers, bnd, stats int32 [2] on
    the device)."""
    dev = y1.device
    if logp1 is None:
        logp1 = torch.zeros_like(ap)
    _on_card("cnf_adjoint_bwd", layers, dev, c, y1, a1, ap, logp1)
    B, N, _ = y1.shape
    n_rows, cdim = B * N, c.shape[-1]
    y1, a1, ap, logp1 = (t.contiguous() for t in (y1, a1, ap, logp1))
    _, proj_w, proj_b = _packed(layers)
    c2 = c.reshape(c.shape[0] * c.shape[1], cdim)
    proj = torch.addmm(proj_b, c2, proj_w)
    # the kernel's condition products take whole m16 tiles of c's columns:
    # zero columns pad c and the projection matrix to a multiple of 16
    pad = -cdim % _ADJ_CDIM
    weights, wct = _adjoint_packed(layers, cdim + pad)
    c2 = F.pad(c2, (0, pad)).contiguous()
    ng = _G_OWN + (cdim + pad) * _LD_PROJ
    grid = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    rows = torch.empty((n_rows * (_ROW_FLOATS + 2 * (cdim + pad))
                        + 2 * _LD_PROJ * (n_rows // r + grid),), **f32)
    per_grid = torch.empty((grid * (2 * ng + 2 * _G_OWN) + 2 * ng,), **f32)
    partials = torch.empty((4 * grid,), dtype=torch.float64, device=dev)
    y0, a0 = torch.empty_like(y1), torch.empty_like(a1)
    dc = torch.empty((B, N, cdim + pad), **f32)
    g = torch.empty((ng,), **f32)
    bnd = torch.empty((B, N, 8), **f32)
    stats = torch.zeros((2,), dtype=torch.int32, device=dev)
    # every tensor a launch reads stays referenced until the last launch
    t01 = _t01(t0, t1, dev)
    args = (y1.data_ptr(), logp1.data_ptr(), a1.data_ptr(), ap.data_ptr(),
            c2.data_ptr(), proj.data_ptr(), weights.data_ptr(),
            wct.data_ptr(), t01.data_ptr(), n_rows, r,
            cdim + pad, cdim, int(with_trace), float(rtol), float(atol),
            int(max_steps), rows.data_ptr(), rows.numel(),
            per_grid.data_ptr(), per_grid.numel(), partials.data_ptr(),
            partials.numel(), grid, y0.data_ptr(), a0.data_ptr(),
            dc.data_ptr(), g.data_ptr(), bnd.data_ptr(), stats.data_ptr())
    with torch.cuda.device(dev):
        if per_attempt:
            _adjoint_attempts(args, ng, max_steps, group, dev)
        else:
            code = _build.library().puflow_cnf_adjoint(
                *args, _build.stream_ptr(dev))
            _build.check(code, "puflow_cnf_adjoint")
    cnf_adjoint_bwd.launches += 1
    if cnf_adjoint_bwd.stats_log is not None:
        cnf_adjoint_bwd.stats_log.append(stats)
    bnd = (bnd[..., 0:3], bnd[..., 3:4], bnd[..., 4:7], bnd[..., 7:8])
    return (y0, a0, _sum_repeats(dc[..., :cdim], c),
            _unpack_grads(layers, g, cdim), bnd, stats)


def _adjoint_attempts(args, ng: int, max_steps: int, group, dev) -> None:
    """The backward solve in the per-attempt mode
    (`csrc/cnf_adjoint_attempt.cu:puflow_cnf_adjoint_attempt`) on
    `_adjoint_kernel`'s arguments: one launch an attempt; after each the
    host reads the finished flag and, with a group (of any size), the
    ranks exchange their sums (every G entry's two quadratures, the row
    terms and their count) by one all-reduce of a zero-filled int32 view
    of them, which carries the bits exactly; the next launch adds them in
    rank order. Every rank's grid must be the same (the same rows on the
    same card model), as every rank's G terms must be summed alike: checked
    at the first exchange. Counts the launches in `attempt_launches`."""
    f32 = dict(dtype=torch.float32, device=dev)
    local = torch.zeros((2 * ng + _EXCHANGE_TAIL,), **f32)
    ctrl = torch.zeros((16,), dtype=torch.int32, device=dev)
    distributed = is_distributed(group)
    gloc = torch.empty((2 * ng,), **f32) if distributed else None
    exchange, world = local, 1
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    for attempt in range(max_steps + 1):
        code = lib.puflow_cnf_adjoint_attempt(
            *args, attempt, exchange.data_ptr(), world, ctrl.data_ptr(),
            local.data_ptr(), _ptr(gloc), stream)
        _build.check(code, "puflow_cnf_adjoint_attempt")
        cnf_adjoint_bwd.attempt_launches += 1
        if int(ctrl[8 * (attempt & 1) + 5]):
            return
        if group is not None:
            exchange = gather_batch(local.view(torch.int32).view(1, -1),
                                    group).view(torch.float32).reshape(-1)
            world = group.world_size
            if attempt == 0:
                grids = exchange.view(world, -1)[:, 2 * ng + 4].tolist()
                if len(set(grids)) != 1:
                    raise RuntimeError(
                        f"cnf_adjoint_bwd: the ranks' grids {grids} differ: "
                        "every rank must hold as many rows on the same card "
                        "model")
    raise RuntimeError(f"cnf_adjoint_bwd: the per-attempt solve did not "
                       f"finish within {max_steps} attempts")


def cnf_adjoint_bwd(layers, c: torch.Tensor, y1: torch.Tensor,
                    a1: torch.Tensor, ap: torch.Tensor, t0, t1,
                    rtol: float = 1e-5, atol: float = 1e-5,
                    max_steps: int = 128, with_trace: bool = True,
                    logp1: torch.Tensor | None = None,
                    return_stats: bool = False, group=None,
                    per_attempt: bool = False):
    """The backward solve of one block's continuous adjoint from t1 to t0:
    the CUDA kernel for CUDA tensors, `cnf_adjoint_bwd_plain` for CPU
    tensors.

    Args:
      layers: the block's three ConcatSquashLinear param dicts.
      c: conditions ``[B, N / r, cdim]``, r >= 1.
      y1, a1: the end state ``[B, N, 3]`` and its cotangent.
      ap: the cotangent of the log-density ``[B, N, 1]``, constant along
        the solve (zeros without the trace).
      with_trace: the exact-trace field (the f path); without, the plain
        field (the g path, whose log-density is discarded).
      logp1: the log-density at t1 (``with_trace`` only; zeros if None),
        which enters only the error norm.
      return_stats: also return the step counts, as `cnf_solve_t` does.
      group: a `parallel.Group`; with more than one rank the rows are this
        rank's shard, every step is the global batch's (the layers'
        cotangent judged as one replicated leaf) and ``dlayers`` is this
        rank's part of it: the kernel's per-attempt mode on CUDA tensors,
        `cnf_adjoint_bwd_plain` with the group on CPU tensors.
      per_attempt: run the per-attempt mode (CUDA tensors) at any world
        size, exchanging through ``group`` if one is given.

    Returns:
      ``(y0, a0, dc, dlayers, (f1, div1, f0, div0))`` as
      `cnf_adjoint_bwd_plain`.
    """
    if y1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cnf_adjoint_bwd: no kernel for {y1.device}")
    r = _check("cnf_adjoint_bwd", layers, c, y1)
    if a1.shape != y1.shape or ap.shape != y1.shape[:-1] + (1,):
        raise ValueError(f"cnf_adjoint_bwd: cotangents {tuple(a1.shape)}, "
                         f"{tuple(ap.shape)} do not match y1 "
                         f"{tuple(y1.shape)}")
    split = _per_attempt(y1, group, per_attempt)
    if y1.device.type == "cpu":
        return cnf_adjoint_bwd_plain(layers, c, y1, a1, ap, t0, t1, rtol,
                                     atol, max_steps, with_trace, logp1,
                                     return_stats, group)
    *out, stats = _adjoint_kernel(layers, c, y1, a1, ap, logp1, t0, t1, r,
                                  rtol, atol, max_steps, with_trace, group,
                                  split)
    return (*out, stats) if return_stats else tuple(out)


# One a solve in either mode; `attempt_launches` as `cnf_solve`'s.
cnf_adjoint_bwd.launches = 0
cnf_adjoint_bwd.attempt_launches = 0
cnf_adjoint_bwd.stats_log = None
