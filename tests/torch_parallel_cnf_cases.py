"""Rank bodies of the CNF family's data-parallel tests
(tests/test_torch_parallel_cnf.py, tests/test_torch_parallel_cnf_train.py,
tests/test_torch_cuda.py) and of `chip_smoke.py:phase_cnf_data_parallel`
and `phase_cnf_train_data_parallel`, run by
`torch_parallel_cases.run_ranks`. Imports numpy, torch and `puflow_torch`
only: the ranks never import jax.

Every CNF solve is recorded through `continuous.training_solves` with
`recording_solves`, which calls `ops.cnf`'s wrappers themselves with
``return_stats=True``: the same solves as without it (the kernels on the
card, their plain versions on the CPU), and each solve's [attempted,
accepted] steps in call order (a train step's backward solves after its
forward ones).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from puflow_torch import checkpoint, parallel
from puflow_torch.flows.moving_bn import moving_bn_forward
from puflow_torch.inference.patch import upsample_cloud, upsample_cloud_sharded
from puflow_torch.models import continuous
from puflow_torch.models.fold_bn import empty_bn_state, fold_bn_inference
from puflow_torch.models.ode import (_error_ratio, adjoint_backward,
                                     odeint_dopri5)
from puflow_torch.ops import cnf as cnf_ops
from puflow_torch.train.trainer import TrainConfig, Trainer

# the per-attempt mode's wrappers and their per-attempt launch counts
SOLVES = {"cnf_solve": cnf_ops.cnf_solve, "cnf_solve_logp":
          cnf_ops.cnf_solve_logp}


def steps_of(stats) -> list:
    """[attempted, accepted] of a wrapper's stats (a dict from a plain
    version, an int32 tensor from a kernel)."""
    if isinstance(stats, dict):
        return [stats["steps"], stats["accepted"]]
    return [int(v) for v in stats.tolist()]


def recording_solves(log: list):
    """`continuous.training_solves`' functions: `ops.cnf`'s wrappers with
    each solve's stats appended to ``log`` (as returned: a tensor on the
    card is read only by `steps_of`)."""
    def solve_logp(*args, **kw):
        out, stats = cnf_ops.cnf_solve_logp(*args, return_stats=True, **kw)
        log.append(stats)
        return out

    def solve(*args, **kw):
        out, stats = cnf_ops.cnf_solve_t(*args, return_stats=True, **kw)
        log.append(stats)
        return out

    def adjoint_bwd(*args, **kw):
        *out, stats = cnf_ops.cnf_adjoint_bwd(*args, return_stats=True, **kw)
        log.append(stats)
        return tuple(out)

    return solve_logp, solve, adjoint_bwd


@contextlib.contextmanager
def recorded(log: list):
    with continuous.training_solves(*recording_solves(log)):
        yield


def cnf_model(params, state, device, folded: bool):
    """The CNF model of numpy trees on ``device``, BN folded or not."""
    model = checkpoint.from_numpy_tree(params, state, device, model="cnf")
    if not folded:
        return model
    tp, ts = model.trees()
    return continuous.ContinuousModel(fold_bn_inference(tp, ts),
                                      empty_bn_state(ts))


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class RecordingModel:
    """A model whose calls' outputs (the patches' predictions, before the
    merge) are kept in ``preds``."""

    def __init__(self, model):
        self.model, self.preds = model, []

    def __call__(self, patches, upratio, group=None):
        out = (self.model(patches, upratio) if group is None
               else self.model(patches, upratio, group=group))
        self.preds.append(out)
        return out


# --------------------------------------------------------------------------
# the plain solver
# --------------------------------------------------------------------------
def decay_field(k: torch.Tensor):
    """``dy/dt = -k y`` with one rate a row: rows of large k are stiff and
    set the step size where they are in the error norm."""
    return lambda t, y: -k[:, None] * y


def decay_solve(k, y0, t1, group=None):
    """`odeint_dopri5` of `decay_field` from 0 to ``t1`` (numpy inputs) ->
    (y(t1) numpy, [attempted, accepted])."""
    k, y0 = torch.from_numpy(k), torch.from_numpy(y0)
    y, stats = odeint_dopri5(decay_field(k), y0, 0.0, t1, 1e-5, 1e-5,
                             differentiable=False, return_stats=True,
                             group=group)
    return _numpy(y), steps_of(stats)


def plain_solver_rank(group, k, y0, t1, bounds):
    """The plain solver on this rank's rows ``bounds[r]:bounds[r + 1]`` of
    each (k, y0) pair, with the group; and `rank_order_sum` of a value
    that differs by rank. -> {"solves": [(y, steps)], "sum": numpy}."""
    solves = []
    for b in bounds:
        lo, hi = b[group.rank], b[group.rank + 1]
        solves.append(decay_solve(k[lo:hi], y0[lo:hi], t1, group))
    x = torch.tensor([0.1 * (group.rank + 1), 1e-8 * (group.rank + 3)],
                     dtype=torch.float32)
    return {"solves": solves,
            "sum": _numpy(parallel.rank_order_sum(x, group))}


def masked_decay_rank(group, k, y0, w, t1):
    """The masked loop (``differentiable=True``) of `decay_field` on this
    rank's rows of (k, y0), with the group: -> {"y", "steps", "grad"}, the
    gradient of this rank's ``sum(y * w)`` with respect to the whole k
    (its own rows directly, every row through the exchanged error norm),
    whose sum over the ranks is the gradient of the global sum."""
    k = torch.from_numpy(k).requires_grad_()
    rows = slice(*_bounds(len(y0), group))
    y, stats = odeint_dopri5(decay_field(k[rows]),
                             torch.from_numpy(y0[rows]), 0.0, t1, 1e-5,
                             1e-5, max_steps=32, differentiable=True,
                             return_stats=True, group=group)
    (grad,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(w[rows])),
                                  k)
    return {"y": _numpy(y), "steps": stats["steps"], "grad": _numpy(grad)}


def _bounds(n: int, group) -> tuple:
    """This rank's rows of n, as `parallel.shard_batch` takes them."""
    if group is None:
        return 0, n
    b = n // group.world_size
    return group.rank * b, (group.rank + 1) * b


def error_ratio_rank(group, rows, parts):
    """`models.ode._error_ratio` of a state of a row leaf (``rows``: the
    global (err, y0, y1) arrays, this rank's shard taken) and a replicated
    leaf (``parts[rank]``: this rank's part of its (err, y0, y1), which
    the ranks' parts sum to), with the group: -> {"ratio": the leaf marked
    replicated, "unmarked": taken as sharded, the count trap}."""
    mine = [torch.from_numpy(parallel.shard_batch(a, group)) for a in rows]
    part = [torch.from_numpy(a) for a in parts[group.rank]]
    err, y0, y1 = ([m, p] for m, p in zip(mine, part))
    return {"ratio": float(_error_ratio(err, y0, y1, 1e-5, 1e-5, group,
                                        [False, True])),
            "unmarked": float(_error_ratio(err, y0, y1, 1e-5, 1e-5,
                                           group))}


def decay_adjoint(k, scale, y1, a1, t1, group=None):
    """`adjoint_backward` of ``dy/dt = -s k y`` from ``t1`` back to 0 on
    this rank's rows of (y1, a1), with the parameters ``{"k": k, "s": s}``
    (one rate a row and a shared scale) replicated: -> {"y0", "a0", "g"
    (this rank's part of the parameters' cotangent), "steps", "g_sum"
    (the ranks' parts added in rank order; the part itself without a
    group)}."""
    params = {"k": torch.from_numpy(k), "s": torch.tensor(scale)}
    lo, hi = _bounds(len(y1), group)

    def func(p, t, y):
        return -p["s"] * p["k"][lo:hi, None] * y

    (y0, a0, g), stats = adjoint_backward(
        func, params, torch.from_numpy(y1[lo:hi]),
        torch.from_numpy(a1[lo:hi]), t1, 0.0, return_stats=True,
        group=group)
    flat = torch.cat([g["k"], g["s"].reshape(1)])
    total = flat if group is None else parallel.rank_order_sum(flat, group)
    return {"y0": _numpy(y0), "a0": _numpy(a0),
            "g": {k: _numpy(v) for k, v in g.items()},
            "steps": [stats["steps"], stats["accepted"]],
            "g_sum": _numpy(total)}


def decay_adjoint_rank(group, k, scale, y1, a1, t1):
    return decay_adjoint(k, scale, y1, a1, t1, group)


def moving_bn_rank(group, params, state, x, cot):
    """`moving_bn_forward` in train mode on this rank's shard of ``x``:
    its output, log-density, new state and the gradient of ``sum((y +
    logpx) * cot)`` with respect to the shard."""
    xs = torch.from_numpy(parallel.shard_batch(x, group)).requires_grad_()
    cs = torch.from_numpy(parallel.shard_batch(cot, group))
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    s = {k: torch.from_numpy(v) for k, v in state.items()}
    lp0 = torch.zeros(xs.shape[:-1] + (1,))
    y, lp, new = moving_bn_forward(p, s, xs, lp0, train=True, group=group)
    (g,) = torch.autograd.grad(torch.sum((y + lp) * cs), xs)
    return {"y": _numpy(y), "logpx": _numpy(lp),
            "state": {k: _numpy(v) for k, v in new.items()},
            "grad": _numpy(g)}


def chain_rank(group, seed, x, c, cot):
    """`sequential_flow_apply(train=True)` of a seeded `build_model` chain
    with moving-BNs (bn, (cnf, bn) x 2; the plain solves) on this rank's
    shard of (x, c): -> {"x", "logpx", "state", "grads"} (the gradient of
    ``sum(x' * cot) + sum(logpx')`` over the ranks, this rank's part of
    each parameter's, with respect to the chain's parameters in order)."""
    cfg = continuous.CNFChainConfig(batch_norm=True)
    gen = torch.Generator().manual_seed(seed)
    chain, state = continuous.build_model(gen, 3, (64, 64), c.shape[-1], 2,
                                          cfg=cfg, device="cpu")
    leaves = [t for _, p in chain for t in _leaves(p)]
    for t in leaves:
        t.requires_grad_()
    xs, cs, ts = (torch.from_numpy(parallel.shard_batch(a, group))
                  for a in (x, c, cot))
    y, lp, new = continuous.sequential_flow_apply(
        chain, state, xs, cs, train=True, cfg=cfg, group=group)
    grads = torch.autograd.grad(torch.sum(y * ts) + torch.sum(lp), leaves)
    return {"x": _numpy(y), "logpx": _numpy(lp),
            "state": [None if st is None else {k: _numpy(v) for k, v in
                                               st.items()} for st in new],
            "grads": [_numpy(g) for g in grads]}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# the CNF model
# --------------------------------------------------------------------------
def cnf_upsample_rank(group, params, state, pc, npoint, upratio, patch_size,
                      expand_ratio, folded=True):
    """`upsample_cloud_sharded` of the CNF model of the numpy trees, every
    solve recorded -> {"out", "pred" (this rank's patches' predictions),
    "steps"}."""
    model = RecordingModel(cnf_model(params, state, group.device, folded))
    log = []
    with torch.no_grad(), recorded(log):
        out = upsample_cloud_sharded(model, torch.from_numpy(pc), npoint,
                                     upratio, patch_size, expand_ratio,
                                     group=group)
    return {"out": _numpy(out), "pred": _numpy(model.preds[0]),
            "steps": [steps_of(s) for s in log]}


def cnf_upsample_one_process(params, state, pc, npoint, upratio, patch_size,
                             expand_ratio, device="cpu", folded=True):
    """`upsample_cloud` of all the clouds in this process, every solve
    recorded -> {"out", "pred", "steps"}."""
    model = RecordingModel(cnf_model(params, state, device, folded))
    log = []
    with torch.no_grad(), recorded(log):
        out = upsample_cloud(model, torch.from_numpy(pc).to(device), npoint,
                             upratio, patch_size, expand_ratio)
    return {"out": _numpy(out), "pred": _numpy(model.preds[0]),
            "steps": [steps_of(s) for s in log]}


def cnf_eval_rank(group, params, state, x, upratio, folded=False):
    """`continuous.forward(train=False)` on this rank's shard of ``x``
    with the group, every solve recorded -> {"x" (the rank's dense
    clouds), "nll", "steps"}."""
    tp, ts = cnf_model(params, state, group.device, folded).trees()
    xs = torch.from_numpy(parallel.shard_batch(x, group)).to(group.device)
    log = []
    with torch.no_grad(), recorded(log):
        dense, nll, _ = continuous.forward(tp, ts, xs, upratio, group=group)
    return {"x": _numpy(dense), "nll": float(nll),
            "steps": [steps_of(s) for s in log]}


def cnf_eval_one_process(params, state, x, upratio, device="cpu",
                         folded=False):
    """`continuous.forward(train=False)` of the whole batch in this
    process, every solve recorded -> {"x", "nll", "steps"}."""
    tp, ts = cnf_model(params, state, device, folded).trees()
    log = []
    with torch.no_grad(), recorded(log):
        dense, nll, _ = continuous.forward(tp, ts,
                                           torch.from_numpy(x).to(device),
                                           upratio)
    return {"x": _numpy(dense), "nll": float(nll),
            "steps": [steps_of(s) for s in log]}


def cnf_forward_train(params, state, x, upratio, group=None):
    """`continuous.forward(train=True)` of the numpy trees on this rank's
    shard of ``x`` (the whole batch without a group), and the gradient of
    its NLL: -> {"nll", "bn" (the new BN state's leaves), "grads" (this
    rank's part of the NLL's gradient, the parameters' leaves in
    order)}."""
    device = "cpu" if group is None else group.device
    tp, ts = cnf_model(params, state, device, False).trees()
    leaves = [t.detach().requires_grad_() for t in _leaves(tp)]
    it = iter(leaves)
    tp = _rebuild(tp, it)
    xs = torch.from_numpy(parallel.shard_batch(x, group)).to(device)
    _, nll, new = continuous.forward(tp, ts, xs, upratio, train=True,
                                     group=group)
    # every rank holds the global NLL: its gradient over W ranks is the
    # sum of their parts of NLL / W, as the trainer weights it; the
    # interpolation head does not reach the NLL
    w = 1 if group is None else group.world_size
    grads = torch.autograd.grad(nll / w, leaves, allow_unused=True)
    return {"nll": float(nll.detach()),
            "bn": [_numpy(t) for t in _leaves(new)],
            "grads": [np.zeros(t.shape, np.float32) if g is None
                      else _numpy(g) for t, g in zip(leaves, grads)]}


def cnf_forward_train_rank(group, params, state, x, upratio):
    return cnf_forward_train(params, state, x, upratio, group)


def _rebuild(tree, it):
    """``tree`` with its leaves taken in order from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def cnf_trainer(params, state, group=None, device="cpu", **cfg):
    """`Trainer(..., forward_fn=continuous.forward)` of the numpy trees,
    data parallel over ``group`` if one is given."""
    return Trainer(TrainConfig(**cfg), params, state,
                   forward_fn=continuous.forward, device=device, group=group)


def cnf_grad(tr, sparse, dense, emd=None):
    """The trainer's gradient (flat, the trainer's layout; the global
    batch's with a group) and loss on a batch, every solve recorded; with
    ``emd`` (a function with `ops.emd.emd_auction`'s signature) in place
    of the auction -> {"grads", "loss", "steps"}."""
    from torch_parallel_cases import trainer_emd

    log = []
    with recorded(log), (trainer_emd(emd) if emd is not None
                         else contextlib.nullcontext()):
        grads, loss = tr.gradient(sparse, dense)
    return {"grads": _numpy(grads), "loss": float(loss),
            "steps": [steps_of(s) for s in log]}


def cnf_grad_rank(group, params, state, sparse, dense, iters):
    """The CNF loss's data-parallel gradient on the global batch
    (`cnf_grad` of a data-parallel trainer, ``iters`` auction
    iterations)."""
    return cnf_grad(cnf_trainer(params, state, group, group.device,
                                emd_iters=iters), sparse, dense)


def cnf_trainer_rank(group, params, state, batches, val, iters):
    """The data-parallel CNF `Trainer`: a step on each global batch, each
    step's parameters and metrics, then `validate` on ``val``."""
    tr = cnf_trainer(params, state, group, group.device, emd_iters=iters)
    steps = []
    for sparse, dense in batches:
        m = tr.step(sparse, dense)
        steps.append({"params": _numpy(tr.params),
                      "bn_state": _numpy(tr.bn_state),
                      "metrics": {k: float(v) for k, v in m.items()}})
    return {"steps": steps, "validate": tr.validate(val)}


# --------------------------------------------------------------------------
# Card cases (chip_smoke.py, tests/test_torch_cuda.py)
# --------------------------------------------------------------------------
def _sync(group):
    torch.cuda.synchronize(group.device)
    parallel.all_reduce_(torch.zeros(1, device=group.device))
    torch.cuda.synchronize(group.device)


def card_cnf_rank(group, weights, pc, npoint, x, reps: int = 0):
    """The CNF family's data-parallel paths on the card, on each rank, for
    each ``(label, params, state)`` of ``weights`` (numpy trees):

      * `upsample_cloud_sharded` of the folded model (patches of 256, x4),
        every solve recorded (`cnf_upsample_rank`);
      * `continuous.forward(train=False)` of the unfolded model on this
        rank's shard of ``x``, every solve recorded (`cnf_eval_rank`);
      * each once more unrecorded, with the solve wrappers' counts
        (`SOLVES`: solves and per-attempt launches) set to 0 just before
        and read just after;
      * ``reps`` timed calls of the sharded upsample (host ms a call,
        every rank started together).
    -> label -> {"upsample", "eval", "launches", "ms"}."""
    out = {}
    for label, params, state in weights:
        res = {"upsample": cnf_upsample_rank(group, params, state, pc, npoint,
                                             4, 256, 4.0),
               "eval": cnf_eval_rank(group, params, state, x, 4)}
        model = cnf_model(params, state, group.device, True)
        tp, ts = cnf_model(params, state, group.device, False).trees()
        xs = torch.from_numpy(parallel.shard_batch(x, group)).to(group.device)
        pcs = torch.from_numpy(pc)
        launches = {}
        with torch.no_grad():
            for name, fn in (
                    ("upsample", lambda: upsample_cloud_sharded(
                        model, pcs, npoint, group=group)),
                    ("eval", lambda: continuous.forward(tp, ts, xs, 4,
                                                        group=group))):
                _sync(group)
                for w in SOLVES.values():
                    w.launches = w.attempt_launches = 0
                fn()
                torch.cuda.synchronize(group.device)
                launches[name] = {k: [w.launches, w.attempt_launches]
                                  for k, w in SOLVES.items()}
            ms = []
            for _ in range(reps):
                _sync(group)
                t0 = time.perf_counter()
                upsample_cloud_sharded(model, pcs, npoint, group=group)
                torch.cuda.synchronize(group.device)
                ms.append((time.perf_counter() - t0) * 1e3)
        res.update(launches=launches, ms=ms)
        out[label] = res
    return out


def _case_tensors(layers, arrays, dev):
    """A case's numpy layers and arrays, and its float end times, as
    tensors on ``dev`` (times on the device, as a model's are: a float
    would be copied to the card at every solve)."""
    layers = [{k: {kk: torch.from_numpy(v).to(dev) for kk, v in p.items()}
               for k, p in q.items()} for q in layers]
    return layers, [torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                    else torch.tensor(a, dtype=torch.float32, device=dev)
                    for a in arrays]


# tiny kernels that open a profiled window: on the H100 machine a trace
# loses its first kernel records, one for each CUDA child process this
# process has run (`chip_smoke.py:library_trace`)
TRACE_PAD = 1000


def device_ms(fn, reps: int, kernel: str = "solve_kernel") -> tuple:
    """Mean device ms a call of ``fn`` spends in launches of ``kernel``
    (`solve_kernel` or `cnf_adjoint_kernel`) in the one-launch and in the
    per-attempt mode (the kernel's last template argument true), from
    torch.profiler over ``reps`` calls after a warm-up (the window opened
    by `TRACE_PAD` tiny kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PAD):
            pad.add_(1.0)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    one = split = 0.0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.name):
            ms = (e.time_range.end - e.time_range.start) / 1e3
            # demangled "...<..., true>(SolveArgs)" or mangled "...Lb1EEEv..."
            if "true>(" in e.name or "Lb1EEEv" in e.name:
                split += ms
            else:
                one += ms
    return one / reps, split / reps


def _solve(name, layers, args, **kw):
    """A case's solve through its wrapper -> (outputs as one tensor, the
    channels concatenated; stats)."""
    fn = cnf_ops.cnf_solve_logp if name == "cnf_solve_logp" else \
        cnf_ops.cnf_solve_t
    out, stats = fn(layers, *args, return_stats=True, **kw)
    return (torch.cat(out, -1) if isinstance(out, tuple) else out), stats


def uneven_attempt_rank(group, cases):
    """Each case ``(name, layers, c, y[, logp0], t0, t1)`` (numpy) with
    the group: rank 0 solves the whole batch, every other rank none of it
    (the arrays cut to 0 clouds), which adds 0 to every exchange. -> per
    case {"out", "steps"} and on rank 0 also the one-launch kernel's
    {"one", "one_steps"}."""
    results = []
    for name, layers, *arrays in cases:
        if group.rank:
            arrays = [a[:0] if isinstance(a, np.ndarray) else a
                      for a in arrays]
        layers, args = _case_tensors(layers, arrays, group.device)
        out, stats = _solve(name, layers, args, group=group)
        res = {"out": _numpy(out), "steps": steps_of(stats)}
        if group.rank == 0:
            one, one_stats = _solve(name, layers, args)
            res.update(one=_numpy(one), one_steps=steps_of(one_stats))
        results.append(res)
    return results


def attempt_solves_rank(group, cases, reps: int = 0):
    """World size 1 (NCCL or gloo): each case ``(name, layers, c, y[,
    logp0], t0, t1)`` (numpy; layers a list of numpy trees) solved twice
    in the per-attempt mode with the group (``per_attempt=True``) and once
    by the one-launch kernel. -> per case {"attempt", "again", "one",
    "steps", "one_steps", "attempt_launches"}: the outputs (numpy), the
    stats and the per-attempt launches of one solve; with ``reps`` also ms
    a solve (CUDA events, in turns one-launch, per-attempt, per-attempt
    with no exchange, each twice): "one_ms", "ms" and "local_ms" (the
    per-attempt mode without a group: no exchange), and the `solve_kernel`
    launches' device ms a solve (torch.profiler), "one_device_ms" and
    "device_ms"."""
    dev = group.device
    results = []
    for name, layers, *arrays in cases:
        layers, args = _case_tensors(layers, arrays, dev)

        def run(per_attempt, exchange=True, name=name, layers=layers,
                args=args):
            kw = {}
            if per_attempt:
                kw = dict(group=group if exchange else None, per_attempt=True)
            return _solve(name, layers, args, **kw)

        before = SOLVES[name].attempt_launches
        got, stats = run(True)
        launches = SOLVES[name].attempt_launches - before
        again, _ = run(True)
        one, one_stats = run(False)
        res = {"attempt": _numpy(got), "again": _numpy(again),
               "one": _numpy(one), "steps": steps_of(stats),
               "one_steps": steps_of(one_stats),
               "attempt_launches": launches}
        if reps:
            modes = {"one_ms": (False, True), "ms": (True, True),
                     "local_ms": (True, False)}
            times = {k: [] for k in modes}
            for _ in range(2):
                for key, (per_attempt, exchange) in modes.items():
                    run(per_attempt, exchange)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize(dev)
                    start.record()
                    for _ in range(reps):
                        run(per_attempt, exchange)
                    end.record()
                    torch.cuda.synchronize(dev)
                    times[key].append(start.elapsed_time(end) / reps)
            res.update({k: sum(v) / len(v) for k, v in times.items()})
            res["one_device_ms"] = device_ms(lambda: run(False), reps)[0]
            res["device_ms"] = device_ms(lambda: run(True), reps)[1]
        results.append(res)
    return results


def _adjoint_case(case, dev):
    """An adjoint case (a dict of numpy arrays: "layers", "args" = c, y1,
    a1, ap, t0, t1; "with_trace", "logp1") on ``dev`` -> (args, keywords)
    of `ops.cnf.cnf_adjoint_bwd`."""
    layers, arrays = _case_tensors(case["layers"], case["args"], dev)
    logp1 = case["logp1"]
    kw = {"with_trace": case["with_trace"],
          "logp1": None if logp1 is None else torch.from_numpy(logp1).to(
              dev)}
    return (layers, *arrays), kw


def adjoint_outputs(out) -> np.ndarray:
    """Every output of a backward solve but its stats (y0, a0, dc, each
    parameter gradient, the boundary fields), flattened into one array."""
    y0, a0, dc, dlayers, bnd = out[:5]
    leaves = [y0, a0, dc] + [t for p in dlayers for v in p.values()
                             for t in v.values()] + list(bnd)
    return torch.cat([t.reshape(-1) for t in leaves]).cpu().numpy()


def attempt_adjoint_rank(group, cases, reps: int = 0):
    """World size 1 (NCCL): each adjoint case (`_adjoint_case`) solved
    twice by the per-attempt mode with the group (the exchange through the
    group's backend) and once by the one-launch kernel. -> per case
    {"attempt", "again", "one" (`adjoint_outputs`), "steps", "one_steps",
    "attempt_launches"}; with ``reps`` also ms a solve (CUDA events, in
    turns one-launch, per-attempt, per-attempt with no group, each twice):
    "one_ms", "ms", "local_ms", and the device ms a solve of the kernel's
    launches (torch.profiler), "one_device_ms" and "device_ms"."""
    dev = group.device
    wrapper = cnf_ops.cnf_adjoint_bwd
    results = []
    for case in cases:
        args, kw = _adjoint_case(case, dev)

        def run(per_attempt, exchange=True, args=args, kw=kw):
            extra = {}
            if per_attempt:
                extra = dict(group=group if exchange else None,
                             per_attempt=True)
            return wrapper(*args, **kw, return_stats=True, **extra)

        before = wrapper.attempt_launches
        got = run(True)
        launches = wrapper.attempt_launches - before
        again, one = run(True), run(False)
        res = {"attempt": adjoint_outputs(got), "again": adjoint_outputs(again),
               "one": adjoint_outputs(one), "steps": steps_of(got[-1]),
               "one_steps": steps_of(one[-1]), "attempt_launches": launches}
        if reps:
            modes = {"one_ms": (False, True), "ms": (True, True),
                     "local_ms": (True, False)}
            times = {k: [] for k in modes}
            for _ in range(2):
                for key, (per_attempt, exchange) in modes.items():
                    run(per_attempt, exchange)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize(dev)
                    start.record()
                    for _ in range(reps):
                        run(per_attempt, exchange)
                    end.record()
                    torch.cuda.synchronize(dev)
                    times[key].append(start.elapsed_time(end) / reps)
            res.update({k: sum(v) / len(v) for k, v in times.items()})
            res["one_device_ms"] = device_ms(lambda: run(False), reps,
                                             "cnf_adjoint_kernel")[0]
            res["device_ms"] = device_ms(lambda: run(True), reps,
                                         "cnf_adjoint_kernel")[1]
        results.append(res)
    return results


def sharded_adjoint_rank(group, case):
    """An adjoint case (`_adjoint_case`) on this rank's clouds with the
    group (the per-attempt mode on the card, the plain version with the
    group on the CPU) -> {"rows": y0, a0 and dc (this rank's rows,
    flattened), "g": this rank's part of the layers' gradient (flat),
    "steps"}."""
    case = dict(case, args=[parallel.shard_batch(a, group)
                            if isinstance(a, np.ndarray) else a
                            for a in case["args"]],
                logp1=None if case["logp1"] is None
                else parallel.shard_batch(case["logp1"], group))
    args, kw = _adjoint_case(case, group.device)
    return split_adjoint(cnf_ops.cnf_adjoint_bwd(
        *args, **kw, return_stats=True, group=group))


def split_adjoint(out) -> dict:
    """A backward solve's outputs as {"rows": y0, a0, dc flattened, "g":
    the layers' gradient flattened, "steps"}."""
    y0, a0, dc, dlayers = out[:4]
    grads = [t for p in dlayers for v in p.values() for t in v.values()]
    return {"rows": torch.cat([t.reshape(-1) for t in (y0, a0, dc)])
            .cpu().numpy(),
            "g": torch.cat([t.reshape(-1) for t in grads]).cpu().numpy(),
            "steps": steps_of(out[-1])}


# the CNF training step's kernel wrappers: solves and per-attempt launches
TRAIN_WRAPPERS = {"cnf_solve": cnf_ops.cnf_solve,
                  "cnf_solve_logp": cnf_ops.cnf_solve_logp,
                  "cnf_adjoint_bwd": cnf_ops.cnf_adjoint_bwd}


@contextlib.contextmanager
def timed_exchanges(ms: list):
    """`ops.cnf`'s per-attempt exchanges (`gather_batch`) timed on the
    host inside the block, each call's ms appended to ``ms`` (the stream is
    idle when one starts: the wrapper has just read the finished flag)."""
    gather = cnf_ops.gather_batch

    def timed(x, group):
        t0 = time.perf_counter()
        out = gather(x, group)
        torch.cuda.synchronize(group.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    cnf_ops.gather_batch = timed
    try:
        yield
    finally:
        cnf_ops.gather_batch = gather


def card_cnf_train_rank(group, params, state, grad_batch, assign, batch,
                        steps: int):
    """The CNF family's data-parallel training on the card, on each rank:

      * the gradient on ``grad_batch`` (the global batch) with the auction
        (`cnf_grad`: every solve recorded) and its assignment, and at the
        one-process run's assignment ``assign`` (the global batch's);
      * ``steps`` train steps on ``batch`` with the solve wrappers' counts
        (solves and per-attempt launches) and the EMD's set to 0 just
        before each and read just after, each step split by CUDA events
        (forward, emd, backward, allreduce, optimizer) with the host ms of
        its per-attempt exchanges, and rank 0's parameters, BN state and
        Adam moments broadcast after each to hold this rank's bit-equal to
        them.
    """
    from puflow_torch.ops import emd as emd_ops
    from torch_parallel_cases import fixed_emd, recording_emd

    tr = cnf_trainer(params, state, group, group.device)
    seen = []
    out = cnf_grad(tr, *grad_batch, emd=recording_emd(seen))
    out["assign"] = _numpy(seen[0])
    out["fixed"] = cnf_grad(tr, *grad_batch, emd=fixed_emd(torch.from_numpy(
        parallel.shard_batch(assign, group))))["grads"]
    out["steps_run"] = []
    sparse, dense = batch
    for _ in range(steps):
        marks, exchanges = [], []

        def mark(stage, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        _sync(group)
        for w in TRAIN_WRAPPERS.values():
            w.launches = w.attempt_launches = 0
        emd_ops.emd_auction.launches = 0
        t0 = time.perf_counter()
        mark("start")
        with timed_exchanges(exchanges):
            m = tr.step(sparse, dense, mark)
        torch.cuda.synchronize(group.device)
        wall = (time.perf_counter() - t0) * 1e3
        launches = {k: [w.launches, w.attempt_launches]
                    for k, w in TRAIN_WRAPPERS.items()}
        launches["emd"] = emd_ops.emd_auction.launches
        mine = torch.cat([tr.params, tr.bn_state, tr.opt_state.mu,
                          tr.opt_state.nu])
        ref = parallel.broadcast_(mine.clone())
        out["steps_run"].append({
            "split": {stage: a.elapsed_time(b) for (_, a), (stage, b)
                      in zip(marks, marks[1:])},
            "wall_ms": wall, "exchange_ms": sum(exchanges),
            "exchanges": len(exchanges), "launches": launches,
            "bit_equal": bool(torch.equal(mine, ref)),
            "loss": float(m["loss"]), "nan_step": bool(m["nan_step"])})
    return out
