"""Adaptive Dormand-Prince (dopri5) ODE integration as plain tensor code.

Counterpart of `puflow_tpu.models.ode`:

  * classic DP(4)5 tableau with FSAL, error = RK5 - RK4 embedded estimate,
    elementwise tolerance ``atol + rtol * max(|y|, |y_new|)``, RMS error
    norm over the whole state (every leaf of a pytree state together);
  * step-size controller ``h *= clip(0.9 * err^(-1/5), 0.1, 10)``, first
    step ``span / 16``;
  * at most ``max_steps`` attempts, accepted or rejected; an unconverged
    solve keeps its last state;
  * two drivers sharing the step function: ``differentiable=True``, a loop
    of exactly ``max_steps`` masked steps that autograd differentiates
    (no host read), and ``differentiable=False``, the early-exit loop;
  * `make_adjoint_odeint`: gradients by the continuous adjoint, the
    augmented system solved backward with the early-exit driver.

Integration runs backward when ``t1 < t0``. The controller's scalars are
0-dim float32 tensors on the state's device, so the arithmetic is the JAX
solver's; the early-exit loop reads one flag pair from the device per
step, which is what makes it the plain version: `ops.cnf` runs the same
solves for the shipped field as kernels with no host read.

Data parallel (``group=`` a `parallel.Group` of more than one rank): each
rank holds its shard of the batch, and every step is decided on the
error norm of the global batch, as a sharded jit of the JAX solver
decides it. Each rank sums its own entries' squared error ratios, the
ranks' sums are added in rank order (`rank_order_sum`, the same bits on
every rank) and divided by the global count of entries, so every rank
takes the same steps, accepts the same ones and stops after the same
attempt. A rank with no rows adds 0 and still joins every exchange.
A leaf marked ``replicated`` (the parameter cotangent of the adjoint,
which every rank accumulates over its own rows) is one global leaf, the
sum of the ranks' parts: its start value, candidate and error are added
in rank order, the per-entry ratio is formed from those sums alike on
every rank, and its entries are counted once. Both drivers take a group;
the masked loop's exchange is differentiable.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from puflow_torch.parallel.mesh import is_distributed, rank_order_sum

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


def _squared_ratios(e, a, b, rtol: float, atol: float) -> torch.Tensor:
    r = e / (atol + rtol * torch.maximum(a.abs(), b.abs()))
    return torch.sum(r * r)


def _error_ratio(err, y0, y1, rtol: float, atol: float, group=None,
                 replicated=None, differentiable: bool = False
                 ) -> torch.Tensor:
    """The RMS of ``err / (atol + rtol max(|y0|, |y1|))`` over every entry;
    with a group of more than one rank, over every rank's entries: this
    rank's sum and count, and the leaves ``replicated`` marks (a list of
    bools, one a leaf) whole, exchanged as float64 (exactly) in one gather
    and added in rank order; the row sum is then rounded to float32, each
    replicated leaf's sums too, whose ratios are formed from them and
    counted once; the total is divided as one process divides it.
    ``differentiable``: the exchange passes gradients (the masked loop)."""
    if not is_distributed(group):
        sums, count = 0.0, 0
        for e, a, b in zip(err, y0, y1):
            sums = sums + _squared_ratios(e, a, b, rtol, atol)
            count += e.numel()
        return torch.sqrt(sums / count + 1e-24)
    replicated = replicated or [False] * len(err)
    f64 = dict(dtype=torch.float64, device=err[0].device)
    sums, count, whole = 0.0, 0, []
    for e, a, b, rep in zip(err, y0, y1, replicated):
        if rep:
            whole += [a, b, e]
        else:
            sums = sums + _squared_ratios(e, a, b, rtol, atol)
            count += e.numel()
    local = torch.cat([torch.as_tensor(sums, **f64).reshape(1),
                       torch.tensor([float(count)], **f64),
                       *(t.reshape(-1).to(**f64) for t in whole)])
    total = rank_order_sum(local, group, differentiable).to(torch.float32)
    sums, count, at = total[0], total[1], 2
    for a in whole[::3]:
        n = a.numel()
        g0, g1, e = (total[at + i * n:at + (i + 1) * n] for i in range(3))
        sums = sums + _squared_ratios(e, g0, g1, rtol, atol)
        count = count + n
        at += 3 * n
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


def _masked_loop(field, y, k1, t0, t1, span, h, rtol, atol, max_steps,
                 group, replicated):
    """The masked fixed-trip driver: ``max_steps`` steps, each computed and
    then kept only while the solve is not done, so that the graph is the
    same whatever the data and autograd differentiates it (with a group,
    through the exchange of the error norm too)."""
    t, n = t0, torch.zeros((), dtype=torch.int32, device=t0.device)
    done = span <= 1e-12
    for _ in range(max_steps):
        remaining = t1 - t
        h_c = torch.where(h.abs() > remaining.abs(), remaining, h)
        y5, err, k7 = _dp_step(field, t, y, h_c, k1)
        ratio = _error_ratio(err, y, y5, rtol, atol, group, replicated,
                             differentiable=True)
        accept = ratio <= 1.0
        # the floor keeps err == 0 (a step of size 0 once done) from
        # giving 0^(-1/5) = inf and NaN gradients
        factor = torch.clamp(
            _SAFETY * torch.clamp_min(ratio, 1e-10) ** (-1.0 / _ORDER),
            _MIN_FACTOR, _MAX_FACTOR)
        new_h = h_c * factor
        new_h = torch.where(new_h.abs() < 1e-12, h_c, new_h)
        t_n = torch.where(accept, t + h_c, t)
        y_n = [torch.where(accept, b, a) for a, b in zip(y, y5)]
        k1_n = [torch.where(accept, b, a) for a, b in zip(k1, k7)]
        done_n = torch.abs(t_n - t0) >= span - 1e-9
        t = torch.where(done, t, t_n)
        h = torch.where(done, h, new_h)
        y = [torch.where(done, a, b) for a, b in zip(y, y_n)]
        k1 = [torch.where(done, a, b) for a, b in zip(k1, k1_n)]
        n = torch.where(done, n, n + 1)
        done = done | done_n
    return y, n


def odeint_dopri5(func, y0, t0, t1, rtol: float = 1e-5, atol: float = 1e-5,
                  max_steps: int = 128, differentiable: bool = True,
                  return_stats: bool = False, group=None, replicated=None):
    """Integrate ``dy/dt = func(t, y)`` from t0 to t1.

    Args:
      func: ``(t, y) -> dy`` with y in the structure of ``y0``.
      y0: initial state, a tensor or a pytree (tuples, lists, dicts) of
        tensors.
      t0, t1: floats or 0-dim tensors; ``t1 < t0`` integrates backward.
      differentiable: the masked fixed-trip loop, which autograd
        differentiates (gradients reach ``y0``, ``t0``, ``t1`` and whatever
        ``func`` closes over), or the early-exit loop.
      return_stats: also return ``{"steps": attempts, "nfe": 1 + 6 *
        attempts}`` as Python ints, and ``"accepted"`` from the early-exit
        loop.
      group: a `parallel.Group`; with more than one rank, ``y0`` is this
        rank's shard and every step is decided on the global batch's error
        norm (module docstring), in either loop.
      replicated: with a group, a pytree of bools in ``y0``'s structure
        marking the leaves every rank holds a part of that sum to one
        global leaf (module docstring); None: every leaf is sharded.

    Returns:
      ``y(t1)`` in the structure of ``y0`` (the last state reached if
      ``max_steps`` attempts did not get there).
    """
    y, spec = tree_flatten(y0)
    if replicated is not None:
        replicated = tree_flatten(replicated)[0]
    dev = y[0].device

    def field(t, leaves):
        return tree_flatten(func(t, tree_unflatten(leaves, spec)))[0]

    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
    direction = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)
    t, h = t0, direction * span / 16.0  # simple, robust initial step
    k1 = field(t0, y)
    if differentiable:
        y, n = _masked_loop(field, y, k1, t0, t1, span, h, rtol, atol,
                            max_steps, group, replicated)
        out = tree_unflatten(y, spec)
        if return_stats:
            n = int(n)
            return out, {"steps": n, "nfe": 1 + 6 * n}
        return out
    done = bool(span <= 1e-12)
    n = accepted = 0
    while not done and n < max_steps:
        remaining = t1 - t
        # never step past t1
        h_c = torch.where(h.abs() > remaining.abs(), remaining, h)
        y5, err, k7 = _dp_step(field, t, y, h_c, k1)
        ratio = _error_ratio(err, y, y5, rtol, atol, group, replicated)
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
    out = tree_unflatten(y, spec)
    if return_stats:
        return out, {"steps": n, "accepted": accepted, "nfe": 1 + 6 * n}
    return out


# ---------------------------------------------------------------------------
# Continuous adjoint: gradients by integrating the augmented system backward
# with the early-exit driver, so no solver step enters the autograd graph.
# ---------------------------------------------------------------------------
def _vdot(a, b) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(tree_flatten(a)[0],
                                                 tree_flatten(b)[0]))


def adjoint_backward(func, params, y1, y1_bar, t1, t0, rtol: float = 1e-5,
                     atol: float = 1e-5, max_steps: int = 128,
                     return_stats: bool = False, group=None,
                     replicated=None):
    """Solve ``d/dt [y, a, g] = [f, -a^T df/dy, -a^T df/dparams]`` from t1
    back to t0 with the early-exit driver, one `torch.func.vjp` of
    ``func(params, t, y)`` per field evaluation.

    With a ``group`` of more than one rank, ``y1`` and ``y1_bar`` are this
    rank's shard and every step is the global batch's: the cotangent of
    each parameter ``replicated`` marks (a pytree of bools in ``params``'
    structure; None: all of them) enters the error norm as one global
    leaf, the sum of the ranks' parts (module docstring); a parameter not
    marked (a per-row condition) is sharded like the rows.

    Returns ``(y0, a0, g)``: the reconstructed start state, the cotangent
    of ``y0`` and that of ``params`` (both in their structures; with a
    group, this rank's part of the parameters' cotangent: the trainer's
    gradient all-reduce adds the parts), and with ``return_stats`` the
    driver's stats.
    """
    params = tree_map(torch.Tensor.detach, params)

    def aug_field(t, state):
        y, a, _ = state
        dy, vjp_fn = torch.func.vjp(lambda pp, yy: func(pp, t, yy), params,
                                    y)
        p_bar, y_bar = vjp_fn(a)
        return dy, tree_map(torch.neg, y_bar), tree_map(torch.neg, p_bar)

    g0 = tree_map(torch.zeros_like, params)
    if replicated is None:
        replicated = tree_map(lambda _: True, params)
    rows = tree_map(lambda _: False, (y1, y1_bar))
    return odeint_dopri5(aug_field, (y1, y1_bar, g0), t1, t0, rtol, atol,
                         max_steps, differentiable=False,
                         return_stats=return_stats, group=group,
                         replicated=(*rows, replicated))


class _AdjointSolve(torch.autograd.Function):
    """The solve of `make_adjoint_odeint` on flat leaves: ``(solver, t0, t1,
    *params, *y0) -> y(t1)`` leaves."""

    @staticmethod
    def forward(ctx, solver, t0, t1, *leaves):
        params, y0 = solver.split(leaves)
        y1 = solver.forward_solve(params, y0, t0, t1)
        y1_leaves = tree_flatten(y1)[0]
        ctx.solver = solver
        ctx.save_for_backward(t0, t1, *leaves[:solver.n_params], *y1_leaves)
        return tuple(y1_leaves)

    @staticmethod
    def backward(ctx, *y1_bar):
        solver = ctx.solver
        t0, t1, *saved = ctx.saved_tensors
        params = tree_unflatten(saved[:solver.n_params], solver.p_spec)
        y1 = tree_unflatten(saved[solver.n_params:], solver.y_spec)
        y1_bar = tree_unflatten(list(y1_bar), solver.y_spec)
        g, a0, t0_bar, t1_bar = solver.backward_solve(params, y1, y1_bar,
                                                      t0, t1)
        return (None, t0_bar.reshape(t0.shape), t1_bar.reshape(t1.shape),
                *tree_flatten(g)[0], *tree_flatten(a0)[0])


class _AdjointSolver:
    """What one call of a `make_adjoint_odeint` solve needs to know."""

    def __init__(self, func, rtol, atol, max_steps, fwd_solver, bwd_solver,
                 p_spec, y_spec, n_params, group, replicated):
        self.func, self.rtol, self.atol = func, rtol, atol
        self.max_steps = max_steps
        self.fwd_solver, self.bwd_solver = fwd_solver, bwd_solver
        self.p_spec, self.y_spec, self.n_params = p_spec, y_spec, n_params
        self.group, self.replicated = group, replicated
        # the hooks get the group only where there is one, so that hooks
        # without a group argument still serve one process
        self.kw = {} if group is None else {"group": group}

    def split(self, leaves):
        return (tree_unflatten(list(leaves[:self.n_params]), self.p_spec),
                tree_unflatten(list(leaves[self.n_params:]), self.y_spec))

    def forward_solve(self, params, y0, t0, t1):
        if self.fwd_solver is not None:
            return self.fwd_solver(params, y0, t0, t1, **self.kw)
        return odeint_dopri5(lambda t, y: self.func(params, t, y), y0, t0,
                             t1, self.rtol, self.atol, self.max_steps,
                             differentiable=False, group=self.group)

    def backward_solve(self, params, y1, y1_bar, t0, t1):
        """-> (params cotangent, y0 cotangent, t0 cotangent, t1 cotangent)."""
        if self.bwd_solver is None:
            y0, a0, g = adjoint_backward(self.func, params, y1, y1_bar, t1,
                                         t0, self.rtol, self.atol,
                                         self.max_steps, group=self.group,
                                         replicated=self.replicated)
        else:
            solved = self.bwd_solver(params, y1, y1_bar, t0, t1, **self.kw)
            if len(solved) == 5:
                # the solver gave the boundary cotangents too
                _, a0, g, t0_bar, t1_bar = solved
                return g, a0, t0_bar, t1_bar
            y0, a0, g = solved
        with torch.no_grad():
            t1_bar = _vdot(y1_bar, self.func(params, t1, y1))
            t0_bar = -_vdot(a0, self.func(params, t0, y0))
        return g, a0, t0_bar, t1_bar


def make_adjoint_odeint(func, rtol: float = 1e-5, atol: float = 1e-5,
                        max_steps: int = 128, fwd_solver=None,
                        bwd_solver=None):
    """Build ``solve(params, y0, t0, t1) -> y(t1)`` with adjoint gradients.

    ``func(params, t, y) -> dy`` where ``params`` and ``y`` are pytrees of
    tensors. Gradients reach ``params``, ``y0``, ``t0`` and ``t1`` (a
    CNF's trainable end time ``T = sqrt_end_time^2`` differentiates
    through them): the backward pass solves the augmented system with
    `adjoint_backward` from t1 to t0, with the boundary terms
    ``dL/dt1 = a(t1) . f(t1, y1)`` and ``dL/dt0 = -a(t0) . f(t0, y0)``.

    ``fwd_solver(params, y0, t0, t1) -> y1`` may replace the forward
    integration (for example the whole-solve kernel of `ops.cnf`); the
    backward re-solves from its y1, so it needs no gradient of its own.
    ``bwd_solver(params, y1, y1_bar, t0, t1)`` may replace the backward
    integration and return ``(y0, a0, g)`` or, with the boundary
    cotangents it can form from its own field evaluations, ``(y0, a0, g,
    t0_bar, t1_bar)``.

    ``solve(..., group=, replicated=)`` (data parallel, a `parallel.Group`
    of more than one rank): ``y0`` is this rank's shard, both solves take
    the global batch's steps and the parameters' cotangents are this
    rank's parts (`adjoint_backward`; ``replicated`` marks the replicated
    parameters, default all). The hooks then get ``group=`` too.
    """
    def solve(params, y0, t0, t1, group=None, replicated=None):
        p_leaves, p_spec = tree_flatten(params)
        y_leaves, y_spec = tree_flatten(y0)
        dev = y_leaves[0].device
        t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
        t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
        solver = _AdjointSolver(func, rtol, atol, max_steps, fwd_solver,
                                bwd_solver, p_spec, y_spec, len(p_leaves),
                                group, replicated)
        out = _AdjointSolve.apply(solver, t0, t1, *p_leaves, *y_leaves)
        return tree_unflatten(list(out), y_spec)

    return solve
