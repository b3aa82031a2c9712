"""PointInterpFlow (continuous): conditional CNF blocks + latent interpolation.

Counterpart of `puflow_tpu.models.continuous`:

  * the same EdgeConv encoder, interpolation head and merge units as the
    discrete model (`models.discrete.feat_extract`, `models.encoder`);
  * 6 flow blocks, each a conditional CNF integrated with dopri5
    (atol = rtol = 1e-5, at most 128 steps), end time
    ``T = sqrt_end_time ** 2``;
  * vector field: 3 x ConcatSquashLinear(64) with tanh between, context
    ``[t, cond]``; the other conditional layers and nonlinearities of the
    reference are library surface.

`sample` integrates the plain (divergence-free) field in both directions:
for the shipped configuration through `ops.cnf.cnf_solve`, one CUDA kernel
per block-solve on the card (`csrc/cnf_solve.cu`, 12 launches a call), and
with BN-folded params (`models.fold_bn`) the encoder and the interpolation
head are kernels too (`ops.encoder`, `ops.interp` mode ``latents``).
`forward(train=False)` adds the NLL through the exact-trace field: for the
shipped configuration its six f solves run `ops.cnf.cnf_solve_logp`, one
kernel launch each on the card, and its six g solves `ops.cnf.cnf_solve`.
``train=True`` (and every ``differentiable=True`` solve) takes gradients
by the continuous adjoint (`models.ode.make_adjoint_odeint`): for the
shipped field the forward solves of f run `ops.cnf.cnf_solve_logp` (the
exact-trace log-density solve), those of g `ops.cnf.cnf_solve_t`, and
every backward solve `ops.cnf.cnf_adjoint_bwd`: kernels on the card, 24
launches a loss's gradient, their plain versions on the CPU.

Data parallel (``group=`` a `parallel.Group`): `sample` and `forward` on
this rank's shard of the batch take every solve's steps from the global
batch's error norm (`ops.cnf`'s per-attempt kernels on the card,
`models.ode`'s drivers with the group elsewhere), and the NLL is the
global batch's mean. In training every backward solve judges the layers'
cotangent as one replicated leaf of the global batch and returns this
rank's part of it, which the trainer's gradient all-reduce adds.

Parameters are the JAX package's (params, state) trees, keys unchanged
(``flow_blocks[i].sqrt_end_time``, ``.layers[j].layer / hyper_gate /
hyper_bias``), held as `ContinuousModel`'s parameters and buffers.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from puflow_torch.flows.moving_bn import (moving_bn_forward, moving_bn_init,
                                          moving_bn_reverse)
from puflow_torch.flows.prior import standard_gaussian_logp
from puflow_torch.models import discrete as _discrete
from puflow_torch.models.encoder import (feat_merge_init,
                                         feature_extract_init,
                                         interpolation_apply,
                                         interpolation_init)
from puflow_torch.models.ode import make_adjoint_odeint, odeint_dopri5
from puflow_torch.ops.knn import knn_indices
from puflow_torch.parallel.mesh import all_reduce_sum, is_distributed
from puflow_torch.utils.device import resolve_device

NUM_BLOCKS = 6
T_INIT = 0.5
HDIMS = (64, 64)
ATOL = RTOL = 1e-5
# Step budget of the early-exit solves: a safety net well above the steps
# a block takes at tolerance 1e-5.
MAX_STEPS_EVAL = 128


# --------------------------------------------------------------------------
# Conditional diffeq layer zoo
#
# Every layer maps (ctx = [t, c], x) -> out with its own conditioning
# scheme; `odenet_apply` selects among them by `layer_type` and among the
# nonlinearities by name. The shipped checkpoints use only 'concatsquash'
# + 'tanh' (a plain list of layer dicts); the rest is library surface.
# --------------------------------------------------------------------------
def _linear_init(generator, din: int, dout: int, bias: bool = True,
                 device=None):
    b = (1.0 / din) ** 0.5
    u = torch.rand((din, dout), generator=generator, device=device)
    p = {"w": (u * 2.0 - 1.0) * b}
    if bias:
        p["b"] = torch.zeros((dout,), device=device)
    return p


def _ignore_init(generator, dim_in, dim_out, dim_c, device=None):
    return {"layer": _linear_init(generator, dim_in, dim_out, device=device)}


def _ignore_apply(p, ctx, x):
    """IgnoreLinear: condition unused."""
    return x @ p["layer"]["w"] + p["layer"]["b"]


def _concat_init(generator, dim_in, dim_out, dim_c, device=None):
    return {"layer": _linear_init(generator, dim_in + 1 + dim_c, dim_out,
                                  device=device)}


def _concat_apply(p, ctx, x):
    """ConcatLinear: linear over [x, t, c]."""
    return torch.cat([x, ctx], -1) @ p["layer"]["w"] + p["layer"]["b"]


def _concat_v2_init(generator, dim_in, dim_out, dim_c, device=None):
    return {"layer": _linear_init(generator, dim_in, dim_out, device=device),
            "hyper_bias": _linear_init(generator, dim_c + 1, dim_out,
                                       bias=False, device=device)}


def _concat_v2_apply(p, ctx, x):
    """ConcatLinear_v2: hyper bias only."""
    return x @ p["layer"]["w"] + p["layer"]["b"] + ctx @ p["hyper_bias"]["w"]


def _squash_init(generator, dim_in, dim_out, dim_c, device=None):
    return {"layer": _linear_init(generator, dim_in, dim_out, device=device),
            "hyper": _linear_init(generator, dim_c + 1, dim_out,
                                  device=device)}


def _squash_apply(p, ctx, x):
    """SquashLinear: sigmoid hyper gate."""
    gate = torch.sigmoid(ctx @ p["hyper"]["w"] + p["hyper"]["b"])
    return (x @ p["layer"]["w"] + p["layer"]["b"]) * gate


def _scale_apply(p, ctx, x):
    """ScaleLinear: linear (un-squashed) gate."""
    gate = ctx @ p["hyper"]["w"] + p["hyper"]["b"]
    return (x @ p["layer"]["w"] + p["layer"]["b"]) * gate


def _csl_init(generator, dim_in, dim_out, dim_c, device=None):
    return {
        "layer": _linear_init(generator, dim_in, dim_out, device=device),
        "hyper_bias": _linear_init(generator, dim_c + 1, dim_out, bias=False,
                                   device=device),
        "hyper_gate": _linear_init(generator, dim_c + 1, dim_out,
                                   device=device),
    }


def _csl_apply(p, ctx, x):
    """ConcatSquashLinear."""
    gate = torch.sigmoid(ctx @ p["hyper_gate"]["w"] + p["hyper_gate"]["b"])
    bias = ctx @ p["hyper_bias"]["w"]
    return (x @ p["layer"]["w"] + p["layer"]["b"]) * gate + bias


def _concatscale_apply(p, ctx, x):
    """ConcatScaleLinear: ConcatSquashLinear without the sigmoid."""
    gate = ctx @ p["hyper_gate"]["w"] + p["hyper_gate"]["b"]
    bias = ctx @ p["hyper_bias"]["w"]
    return (x @ p["layer"]["w"] + p["layer"]["b"]) * gate + bias


DIFFEQ_LAYERS = {
    "ignore": (_ignore_init, _ignore_apply),
    "squash": (_squash_init, _squash_apply),
    "scale": (_squash_init, _scale_apply),
    "concat": (_concat_init, _concat_apply),
    "concat_v2": (_concat_v2_init, _concat_v2_apply),
    "concatsquash": (_csl_init, _csl_apply),
    "concatscale": (_csl_init, _concatscale_apply),
}

# 'swish' carries a trainable beta, one per ODEnet.
NONLINEARITIES = ("tanh", "relu", "softplus", "elu", "swish", "square",
                  "identity")


def _apply_nonlinearity(name: str, x: torch.Tensor, beta=None):
    if name == "tanh":
        return torch.tanh(x)
    if name == "relu":
        return F.relu(x)
    if name == "softplus":
        return F.softplus(x)
    if name == "elu":
        return F.elu(x)
    if name == "swish":
        return x * torch.sigmoid(beta * x)
    if name == "square":
        return x * x
    if name == "identity":
        return x
    raise ValueError(f"unknown nonlinearity: {name}")


def odenet_init(generator, idim: int, cdim: int, hdims=HDIMS,
                layer_type: str = "concatsquash",
                nonlinearity: str = "tanh", device=None):
    """ODEnet params. The default configuration returns the
    checkpoint-compatible plain list of layer dicts; a 'swish' net wraps
    it in ``{"layers": ..., "swish_beta": ...}``."""
    init_fn = DIFFEQ_LAYERS[layer_type][0]
    dims = (idim,) + tuple(hdims) + (idim,)
    layers = [init_fn(generator, dims[i], dims[i + 1], cdim, device=device)
              for i in range(len(dims) - 1)]
    if nonlinearity == "swish":
        return {"layers": layers,
                "swish_beta": torch.ones((), device=device)}
    return layers


def _split_net(layers):
    """A net's (layer list, shared swish beta or None)."""
    if isinstance(layers, dict):
        return layers["layers"], layers["swish_beta"]
    return layers, None


def odenet_apply(layers, t, c: torch.Tensor, y: torch.Tensor,
                 layer_type: str = "concatsquash",
                 nonlinearity: str = "tanh") -> torch.Tensor:
    """``dy/dt = net([t, c], y)`` with the chosen nonlinearity between
    layers (the shipped CNF uses concatsquash + tanh)."""
    layers, beta = _split_net(layers)
    apply_fn = DIFFEQ_LAYERS[layer_type][1]
    t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
    ctx = torch.cat([t.expand(y.shape[:-1] + (1,)), c], dim=-1)
    dx = y
    for i, p in enumerate(layers):
        dx = apply_fn(p, ctx, dx)
        if i < len(layers) - 1:
            dx = _apply_nonlinearity(nonlinearity, dx, beta)
    return dx


# --------------------------------------------------------------------------
# Inference fast path: plain (divergence-free) field with the condition
# projections hoisted out of the solver loop. Every conditional layer
# consumes the context only through ``ctx @ w`` with ctx = [t, c]; c is
# constant during a solve, so ``ctx @ w == t * w[0] + c @ w[1:]`` and the
# second term is computed once per block-solve.
# --------------------------------------------------------------------------
def _csl_precompute(p, c: torch.Tensor) -> dict:
    return {
        "gate_c": c @ p["hyper_gate"]["w"][1:] + p["hyper_gate"]["b"],
        "gate_t": p["hyper_gate"]["w"][0],
        "bias_c": c @ p["hyper_bias"]["w"][1:],
        "bias_t": p["hyper_bias"]["w"][0],
        "w": p["layer"]["w"],
        "b": p["layer"]["b"],
    }


def field_plain_csl(layers, c: torch.Tensor, nonlinearity: str = "tanh"):
    """``(t, y) -> dy`` for a 'concatsquash' net with hoisted conditions:
    the math of `odenet_apply` with the c-projections factored out of the
    loop. Inference only."""
    layers, beta = _split_net(layers)
    pre = [_csl_precompute(p, c) for p in layers]

    def fn(t, y):
        t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
        dx = y
        for i, q in enumerate(pre):
            gate = torch.sigmoid(t * q["gate_t"] + q["gate_c"])
            bias = t * q["bias_t"] + q["bias_c"]
            dx = (dx @ q["w"] + q["b"]) * gate + bias
            if i < len(pre) - 1:
                dx = _apply_nonlinearity(nonlinearity, dx, beta)
        return dx

    return fn


# --------------------------------------------------------------------------
# Divergence
#
# Both fields take their Jacobian-vector products from `torch.func.jvp`
# (forward mode), as the JAX package takes them from `jax.jvp`: it covers
# every layer type and nonlinearity of the zoo, where the closed-form
# tangent chain of the TPU log-density kernel covers concatsquash + tanh
# only.
# --------------------------------------------------------------------------
def field_with_exact_div(layers, c: torch.Tensor,
                         layer_type: str = "concatsquash",
                         nonlinearity: str = "tanh"):
    """``(t, (y, logp)) -> (dy, -div)`` with the exact trace from one JVP
    per state channel."""
    def fn(t, state):
        y, _ = state

        def f_only(yy):
            return odenet_apply(layers, t, c, yy, layer_type, nonlinearity)

        dy = f_only(y)
        div = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
        for i in range(y.shape[-1]):
            e = torch.zeros_like(y)
            e[..., i] = 1.0
            _, je = torch.func.jvp(f_only, (y,), (e,))
            div = div + je[..., i]
        return dy, -div[..., None]

    return fn


def field_with_hutchinson_div(layers, c: torch.Tensor, e: torch.Tensor,
                              layer_type: str = "concatsquash",
                              nonlinearity: str = "tanh"):
    """The reference's stochastic estimator: one JVP with fixed noise e,
    ``div ~= e^T (df/dy) e``."""
    def fn(t, state):
        y, _ = state

        def f_only(yy):
            return odenet_apply(layers, t, c, yy, layer_type, nonlinearity)

        dy, je = torch.func.jvp(f_only, (y,), (e,))
        div = torch.sum(je * e, dim=-1, keepdim=True)
        return dy, -div

    return fn


def exact_div_field(layer_type: str = "concatsquash",
                    nonlinearity: str = "tanh"):
    """`field_with_exact_div` with explicit params ``p = {"layers", "c"}``:
    ``(p, t, (y, logp)) -> (dy, -div)``, the field the adjoint of the f
    path differentiates."""
    def fn(p, t, state):
        return field_with_exact_div(p["layers"], p["c"], layer_type,
                                    nonlinearity)(t, state)

    return fn


def plain_field(layer_type: str = "concatsquash",
                nonlinearity: str = "tanh"):
    """The plain field with explicit params: ``(p, t, y) -> dy``."""
    def fn(p, t, y):
        return odenet_apply(p["layers"], t, p["c"], y, layer_type,
                            nonlinearity)

    return fn


# --------------------------------------------------------------------------
# Continuous adjoints of the two differentiable solves. With ``solves``, a
# (log-density solve, plain solve, adjoint backward) triple, the net is the
# shipped one (`ops.cnf.kernel_takes`) and its solves go through those
# functions; without, both solves are `models.ode`'s, for every layer type
# and nonlinearity. The builders are cached; a data-parallel call gives its
# group to the solve (``group=``), which passes it to the hooks and from
# them to the solves.
# --------------------------------------------------------------------------
_TRAINING_SOLVES = contextvars.ContextVar("training_solves", default=None)


@contextlib.contextmanager
def training_solves(solve_logp, solve, adjoint_bwd):
    """Inside the block, every solve of the shipped field (the
    differentiable ones of ``forward(train=True)``, and the f solves with
    the log-density and the g solves of ``forward(train=False)`` and
    `sample`) goes through these functions in place of `ops.cnf`'s kernel
    wrappers (for example through the wrappers' plain versions on the
    card: the reference the kernels are held to). A graph built inside
    keeps them for its backward."""
    token = _TRAINING_SOLVES.set((solve_logp, solve, adjoint_bwd))
    try:
        yield
    finally:
        _TRAINING_SOLVES.reset(token)


@functools.lru_cache(maxsize=None)
def _adjoint_for(layer_type: str, nonlinearity: str, solves=None):
    """The adjoint of the exact-trace field (the f path): ``solve(p, (y,
    logp0), t0, t1) -> (y1, logp1)`` with ``p = {"layers", "c"}``."""
    fwd_solver = bwd_solver = None
    if solves is not None:
        solve_logp, _, adjoint_bwd = solves

        def fwd_solver(p, y0, t0, t1, **kw):
            y, logp0 = y0
            return solve_logp(p["layers"], p["c"], y, logp0, t0, t1, RTOL,
                              ATOL, MAX_STEPS_EVAL, **kw)

        def bwd_solver(p, y1, y1_bar, t0, t1, **kw):
            y, logp1 = y1
            a_y, a_p = y1_bar
            y0, a0, dc, dlayers, bnd = adjoint_bwd(
                p["layers"], p["c"], y, a_y, a_p, t0, t1, RTOL, ATOL,
                MAX_STEPS_EVAL, with_trace=True, logp1=logp1, **kw)
            # the field at both ends is (f, -div), so dL/dt1 = <a1, f1> -
            # <ap, div1> and dL/dt0 = -(<a0, f0> - <ap, div0>)
            f1, div1, f0, div0 = bnd
            t1_bar = torch.sum(a_y * f1) - torch.sum(a_p * div1)
            t0_bar = -(torch.sum(a0 * f0) - torch.sum(a_p * div0))
            # the logp channel never feeds the field: its start value is
            # not needed
            return ((y0, torch.zeros_like(logp1)), (a0, a_p),
                    {"layers": dlayers, "c": dc}, t0_bar, t1_bar)

    return make_adjoint_odeint(exact_div_field(layer_type, nonlinearity),
                               RTOL, ATOL, MAX_STEPS_EVAL,
                               fwd_solver=fwd_solver, bwd_solver=bwd_solver)


@functools.lru_cache(maxsize=None)
def _adjoint_plain_for(layer_type: str, nonlinearity: str, solves=None):
    """The adjoint of the plain field (the g path, whose log-density is
    discarded): ``solve(p, y0, t0, t1) -> y1``. With ``solves`` the
    conditions ``p["c"]`` may be un-repeated, ``[B, N / r, cdim]``."""
    fwd_solver = bwd_solver = None
    if solves is not None:
        _, solve, adjoint_bwd = solves

        def fwd_solver(p, y0, t0, t1, **kw):
            return solve(p["layers"], p["c"], y0, t0, t1, RTOL, ATOL,
                         MAX_STEPS_EVAL, **kw)

        def bwd_solver(p, y1, y1_bar, t0, t1, **kw):
            ap = torch.zeros(y1.shape[:-1] + (1,), dtype=y1.dtype,
                             device=y1.device)
            y0, a0, dc, dlayers, bnd = adjoint_bwd(
                p["layers"], p["c"], y1, y1_bar, ap, t0, t1, RTOL, ATOL,
                MAX_STEPS_EVAL, with_trace=False, **kw)
            f1, _, f0, _ = bnd
            t1_bar = torch.sum(y1_bar * f1)
            t0_bar = -torch.sum(a0 * f0)
            return y0, a0, {"layers": dlayers, "c": dc}, t0_bar, t1_bar

    return make_adjoint_odeint(plain_field(layer_type, nonlinearity), RTOL,
                               ATOL, MAX_STEPS_EVAL, fwd_solver=fwd_solver,
                               bwd_solver=bwd_solver)


# --------------------------------------------------------------------------
# CNF flow block
# --------------------------------------------------------------------------
def flow_block_init(generator, cdim: int, idim: int = 3, T: float = T_INIT,
                    layer_type: str = "concatsquash",
                    nonlinearity: str = "tanh", device=None) -> dict:
    return {
        "sqrt_end_time": torch.tensor(math.sqrt(T), dtype=torch.float32,
                                      device=device),
        "layers": odenet_init(generator, idim, cdim, layer_type=layer_type,
                              nonlinearity=nonlinearity, device=device),
    }


def _integrate(block, y: torch.Tensor, c: torch.Tensor, reverse: bool,
               differentiable: bool, max_steps: int | None = None,
               layer_type: str = "concatsquash",
               nonlinearity: str = "tanh", with_logp: bool = True,
               group=None):
    """One block-solve -> (y(t1), accumulated delta-logp ``[B, N, 1]``).

    ``c`` is ``[B, N, cdim]``, or ``[B, N / r, cdim]`` when each condition
    row serves r consecutive rows of ``y`` (the inverse pass on upsampled
    latents): the kernel path indexes it in place, the others repeat it.
    ``differentiable`` solves take gradients by the continuous adjoint.
    Every solve of the shipped field goes through `ops.cnf`'s wrappers, or
    through the functions `training_solves` gives. With a ``group`` ``y``
    is this rank's shard and the solve's steps the global batch's; a
    ``differentiable`` solve then gives this rank's part of the layers'
    gradient (`models.ode.adjoint_backward`, the layers replicated and the
    conditions sharded).
    """
    # ops.cnf builds its plain version from this module's field
    from puflow_torch.ops import cnf as cnf_ops

    T = block["sqrt_end_time"] * block["sqrt_end_time"]
    zero = torch.zeros_like(T)
    t0, t1 = (T, zero) if reverse else (zero, T)
    logp0 = torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype, device=y.device)
    steps = max_steps or MAX_STEPS_EVAL
    # the shared-beta zoo variant and the other layers take `models.ode`'s
    # solves on every device, as in the JAX package
    solves = None
    if (layer_type == "concatsquash" and nonlinearity == "tanh"
            and cnf_ops.kernel_takes(block["layers"])):
        solves = _TRAINING_SOLVES.get() or (
            cnf_ops.cnf_solve_logp, cnf_ops.cnf_solve_t,
            cnf_ops.cnf_adjoint_bwd)
    # the group goes only where there is one, so that `training_solves`
    # functions without a group argument still serve one process
    kw = {} if group is None else {"group": group}
    if differentiable:
        if solves is None and c.shape[1] != y.shape[1]:
            c = torch.repeat_interleave(c, y.shape[1] // c.shape[1], dim=1)
        p = {"layers": block["layers"], "c": c}
        if group is not None:
            kw["replicated"] = {"layers": tree_map(lambda _: True,
                                                   block["layers"]),
                                "c": False}
        if not with_logp:
            # the log-density is discarded (the inverse pass): the adjoint
            # of the plain field, first order only
            yf = _adjoint_plain_for(layer_type, nonlinearity, solves)(
                p, y, t0, t1, **kw)
            return yf, logp0
        return _adjoint_for(layer_type, nonlinearity, solves)(
            p, (y, logp0), t0, t1, **kw)
    if solves is not None:
        solve_logp, solve, _ = solves
        if with_logp:
            # the NLL's solve: the log-density kernel on the card
            return solve_logp(block["layers"], c, y, logp0, t0, t1, RTOL,
                              ATOL, steps, **kw)
        # sampling: no divergence channel (the caller discards logp), one
        # whole-solve kernel on the card
        return solve(block["layers"], c, y, t0, t1, RTOL, ATOL,
                     steps, **kw), logp0
    if c.shape[1] != y.shape[1]:
        c = torch.repeat_interleave(c, y.shape[1] // c.shape[1], dim=1)
    if not with_logp and layer_type == "concatsquash":
        fn = field_plain_csl(block["layers"], c, nonlinearity)
        yf = odeint_dopri5(fn, y, t0, t1, RTOL, ATOL, max_steps=steps,
                           differentiable=False, group=group)
        return yf, logp0
    fn = field_with_exact_div(block["layers"], c, layer_type, nonlinearity)
    return odeint_dopri5(fn, (y, logp0), t0, t1, RTOL, ATOL, max_steps=steps,
                         differentiable=False, group=group)


def flow_block_forward(block, x: torch.Tensor, c: torch.Tensor,
                       differentiable: bool = True,
                       layer_type: str = "concatsquash",
                       nonlinearity: str = "tanh", group=None):
    """x -> z with the accumulated delta-logp summed per cloud."""
    z, logp = _integrate(block, x, c, reverse=False,
                         differentiable=differentiable,
                         layer_type=layer_type, nonlinearity=nonlinearity,
                         group=group)
    return z, torch.sum(logp, dim=(1, 2))


def flow_block_inverse(block, z: torch.Tensor, c: torch.Tensor,
                       differentiable: bool = False,
                       layer_type: str = "concatsquash",
                       nonlinearity: str = "tanh",
                       group=None) -> torch.Tensor:
    """z -> x; the inverse pass never consumes the log-density channel, so
    it integrates the plain field."""
    x, _ = _integrate(block, z, c, reverse=True,
                      differentiable=differentiable, layer_type=layer_type,
                      nonlinearity=nonlinearity, with_logp=False,
                      group=group)
    return x


def count_nfe(params, x: torch.Tensor, cs) -> int:
    """Solver-cost introspection: total field evaluations across the
    forward blocks, through the exact-trace field."""
    total = 0
    for block, c in zip(params["flow_blocks"], cs):
        T = block["sqrt_end_time"] * block["sqrt_end_time"]
        logp0 = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype,
                            device=x.device)
        fn = field_with_exact_div(block["layers"], c)
        (x, _), stats = odeint_dopri5(fn, (x, logp0), 0.0, T, RTOL, ATOL,
                                      differentiable=False,
                                      return_stats=True)
        total += stats["nfe"]
    return total


def count_total_time(params_or_chain) -> torch.Tensor:
    """Sum of the end times ``T = sqrt_end_time^2`` over the CNF blocks of
    full model params (a dict with "flow_blocks") or a `build_model`
    chain."""
    if isinstance(params_or_chain, dict):
        blocks = params_or_chain["flow_blocks"]
    else:
        blocks = [p for kind, p in params_or_chain if kind == "cnf"]
    total = torch.zeros((), dtype=torch.float32,
                        device=blocks[0]["sqrt_end_time"].device)
    for b in blocks:
        total = total + b["sqrt_end_time"] * b["sqrt_end_time"]
    return total


# --------------------------------------------------------------------------
# Args-driven construction surface (the reference's `build_model` and
# `SequentialFlow`)
# --------------------------------------------------------------------------
class CNFChainConfig(NamedTuple):
    """The ``args`` surface of the reference's `build_model`.

    ``solver`` / ``use_adjoint`` are recorded for parity: the runtime
    always integrates with dopri5."""
    layer_type: str = "concatsquash"
    nonlinearity: str = "tanh"
    time_length: float = 0.5
    train_T: bool = True
    solver: str = "dopri5"
    use_adjoint: bool = True
    atol: float = 1e-5
    rtol: float = 1e-5
    batch_norm: bool = False
    bn_lag: float = 0.0
    sync_bn: bool = False


def build_model(generator, input_dim: int, hidden_dims, context_dim: int,
                num_blocks: int, conditional: bool = True,
                cfg: CNFChainConfig = CNFChainConfig(), device="cuda"):
    """Construct a CNF chain -> (chain, chain_state).

    ``chain[i] = ("cnf", block_params)`` or ``("bn", moving_bn_params)``;
    with ``cfg.batch_norm`` the layout is bn, (cnf, bn) x num_blocks.
    ``conditional=False`` builds context-free nets (callers pass a
    zero-width condition). ``hidden_dims`` is recorded only: as in the JAX
    package, every net has the hidden widths `HDIMS`. As with `init`, the
    generator must live on ``device``; ``device="cpu"`` builds on the host."""
    device = resolve_device(device)
    cdim = context_dim if conditional else 0
    chain = [("cnf", flow_block_init(generator, cdim, idim=input_dim,
                                     T=cfg.time_length,
                                     layer_type=cfg.layer_type,
                                     nonlinearity=cfg.nonlinearity,
                                     device=device))
             for _ in range(num_blocks)]
    chain_state = [None] * num_blocks
    if cfg.batch_norm:
        p0, s0 = moving_bn_init(input_dim, device=device)
        bn_chain, bn_state = [("bn", p0)], [s0]
        for blk, st in zip(chain, chain_state):
            p, s = moving_bn_init(input_dim, device=device)
            bn_chain.extend([blk, ("bn", p)])
            bn_state.extend([st, s])
        chain, chain_state = bn_chain, bn_state
    return chain, chain_state


def sequential_flow_apply(chain, chain_state, x: torch.Tensor, c=None,
                          logpx=None, reverse: bool = False,
                          train: bool = False,
                          cfg: CNFChainConfig = CNFChainConfig(),
                          group=None):
    """Run a `build_model` chain: forward applies the layers in order,
    reverse applies them backwards with each layer inverted; logpx
    accumulates additively through CNFs and moving-BNs alike. Returns
    ``(x, logpx', new_state)``; ``train=True`` solves each CNF block with
    the continuous adjoint. With a ``group`` (a `parallel.Group`) ``x`` is
    this rank's shard: every CNF solve takes the global batch's steps and
    the moving-BNs the global batch's statistics."""
    inds = range(len(chain) - 1, -1, -1) if reverse else range(len(chain))
    new_state = list(chain_state)
    lp = (torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
          if logpx is None else logpx)
    for i in inds:
        kind, p = chain[i]
        if kind == "cnf":
            cc = (c if c is not None else
                  torch.zeros(x.shape[:-1] + (0,), dtype=x.dtype,
                              device=x.device))
            x, dlp = _integrate(p, x, cc, reverse=reverse,
                                differentiable=train,
                                layer_type=cfg.layer_type,
                                nonlinearity=cfg.nonlinearity, group=group)
            lp = lp + dlp
        elif reverse:
            x, lp = moving_bn_reverse(p, chain_state[i], x, lp)
        else:
            x, lp, new_state[i] = moving_bn_forward(
                p, chain_state[i], x, lp, train=train, bn_lag=cfg.bn_lag,
                group=group)
    return x, lp, new_state


# --------------------------------------------------------------------------
# Full model (encoder topology shared with the discrete family)
# --------------------------------------------------------------------------
def init(generator: torch.Generator, device="cuda"):
    """Seeded (params, state): the same tree and shapes as the JAX `init`.

    The generator must live on ``device`` (a CUDA generator for CUDA);
    pass ``device="cpu"`` with a CPU generator to build on the host.
    """
    device = resolve_device(device)
    interp_p, interp_s = interpolation_init(generator, _discrete.PC_CHANNEL,
                                            device=device)
    feat_p, feat_s, merge_p, flow_p = [], [], [], []
    for i in range(NUM_BLOCKS):
        fp, fs = feature_extract_init(
            generator, _discrete.FEAT_CHANNELS[i],
            _discrete.FEAT_CHANNELS[i + 1], _discrete.GROWTH_WIDTHS[i],
            device=device)
        feat_p.append(fp)
        feat_s.append(fs)
        merge_p.append(feat_merge_init(
            generator, _discrete.FEAT_CHANNELS[i + 1],
            _discrete.COND_CHANNELS[i], device=device))
    for i in range(NUM_BLOCKS):
        flow_p.append(flow_block_init(generator, _discrete.COND_CHANNELS[i],
                                      idim=_discrete.PC_CHANNEL,
                                      device=device))
    params = {"interp": interp_p, "feat_convs": feat_p,
              "merge_convs": merge_p, "flow_blocks": flow_p}
    state = {"interp": interp_s, "feat_convs": feat_s}
    return params, state


def f_transform(params, x: torch.Tensor, cs, differentiable: bool = True,
                need_logp: bool = True, group=None):
    """Points -> (latents, total delta-logp per cloud; zero when
    ``need_logp`` is off, where the plain field is integrated). With a
    ``group``, ``x`` is this rank's shard (`_integrate`)."""
    log_det = torch.zeros((x.shape[0],), dtype=torch.float32,
                          device=x.device)
    for bp, c in zip(params["flow_blocks"], cs):
        if not need_logp and not differentiable:
            x, _ = _integrate(bp, x, c, reverse=False, differentiable=False,
                              with_logp=False, group=group)
            continue
        x, ld = flow_block_forward(bp, x, c, differentiable, group=group)
        log_det = log_det + ld
    return x, log_det


def g_transform(params, z: torch.Tensor, cs, upratio: int,
                differentiable: bool = False, group=None) -> torch.Tensor:
    """Latents ``[B, N, C, r]`` -> points ``[B, N * r, C]``, point-major,
    with the un-repeated conditions: each condition row serves its point's
    r consecutive rows. ``group`` as `f_transform`'s."""
    B, N, C, r = z.shape
    if r != upratio:
        raise ValueError(f"latents carry {r} samples, not {upratio}")
    z = z.transpose(2, 3).reshape(B, N * r, C)
    for i in reversed(range(len(params["flow_blocks"]))):
        z = flow_block_inverse(params["flow_blocks"][i], z, cs[i],
                               differentiable, group=group)
    return z


def _bn_state(state, key: str):
    return None if state is None else state[key]


def forward(params, state, xyz: torch.Tensor, upratio: int,
            train: bool = False, group=None):
    """``[B, N, 3] -> ([B, N * r, 3], scalar NLL, new state)``; the NLL is
    ``-mean(logp_z - log_det)`` through the exact-trace field.

    ``train=False``: no gradients; the shipped field's solves are the
    kernels' (`ops.cnf.cnf_solve_logp` for f, `cnf_solve_t` for g; their
    plain versions inside `training_solves`). ``train=True``: BN on
    batch statistics (the new state carries the moved running statistics)
    and differentiable solves by the continuous adjoint, six f solves with
    the log-density and six g solves without.

    ``group`` (a `parallel.Group`): ``xyz`` is this rank's shard, every
    solve's steps are the global batch's and the NLL is the global batch's
    mean (the sum through `all_reduce_sum`, over B x W clouds), the same
    on every rank; in training the BN layers take the global batch's
    statistics and the gradients this rank's part of the global loss's
    (the trainer's all-reduce adds the parts).
    """
    knn_idx = knn_indices(xyz, xyz, _discrete.NUM_NEIGHBORS)
    cs, feat_s = _discrete.feat_extract(params, state, xyz, knn_idx, train,
                                        group)
    z, log_det = f_transform(params, xyz, cs, differentiable=train,
                             group=group)
    logp_z = standard_gaussian_logp(z)
    if is_distributed(group):
        total = all_reduce_sum(torch.sum(logp_z - log_det))
        logp_x = -total / (xyz.shape[0] * group.world_size)
    else:
        logp_x = -torch.mean(logp_z - log_det)
    # K=16 sorted -> its first 8 columns ARE the K=8 graph
    fz, interp_s = interpolation_apply(
        params["interp"], _bn_state(state, "interp"), z.contiguous(), xyz,
        upratio, train, knn_idx=knn_idx, group=group)
    x = g_transform(params, fz, cs, upratio, differentiable=train,
                    group=group)
    new_state = None if state is None else {"interp": interp_s,
                                            "feat_convs": feat_s}
    return x, logp_x, new_state


def sample(params, state, sparse: torch.Tensor, upratio: int = 4,
           group=None) -> torch.Tensor:
    """Inference entry, the dense cloud only: both integration directions
    run the divergence-free hoisted-condition field (the log-density is
    never consumed when sampling). With a ``group`` (a `parallel.Group`),
    ``sparse`` is this rank's shard of the patches and every solve's steps
    are the global batch's, as one process over all of them takes them."""
    xyz = sparse.contiguous()
    knn_idx = knn_indices(xyz, xyz, _discrete.NUM_NEIGHBORS)
    cs, _ = _discrete.feat_extract(params, state, xyz, knn_idx)
    z, _ = f_transform(params, xyz, cs, differentiable=False,
                       need_logp=False, group=group)
    fz, _ = interpolation_apply(
        params["interp"], _bn_state(state, "interp"), z.contiguous(), xyz,
        upratio, knn_idx=knn_idx)
    return g_transform(params, fz, cs, upratio, group=group)


class ContinuousModel(_discrete.DiscreteModel):
    """The CNF model's (params, state) trees as one module, with
    `DiscreteModel`'s layout (parameters ``params....``, buffers
    ``state....``) and call signature ``(patches, upratio)``, so
    `inference.patch.upsample_cloud` takes either. Calling the module runs
    this module's `sample` (with ``group``, on this rank's shard)."""

    @torch.no_grad()
    def forward(self, sparse: torch.Tensor, upratio: int = 4,
                group=None) -> torch.Tensor:
        params, state = self.trees()
        return sample(params, state, sparse, upratio, group)
