"""Rank bodies of the CNF family's data-parallel tests
(tests/test_torch_parallel_cnf.py, tests/test_torch_cuda.py) and of
`chip_smoke.py:phase_cnf_data_parallel`, run by
`torch_parallel_cases.run_ranks`. Imports numpy, torch and `puflow_torch`
only: the ranks never import jax.

Every CNF solve is recorded through `continuous.training_solves` with
`recording_solves`, which calls `ops.cnf`'s wrappers themselves with
``return_stats=True``: the same solves as without it (the kernels on the
card, their plain versions on the CPU), and each solve's [attempted,
accepted] steps in call order.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from puflow_torch import checkpoint, parallel
from puflow_torch.inference.patch import upsample_cloud, upsample_cloud_sharded
from puflow_torch.models import continuous
from puflow_torch.models.fold_bn import empty_bn_state, fold_bn_inference
from puflow_torch.models.ode import odeint_dopri5
from puflow_torch.ops import cnf as cnf_ops

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

    return solve_logp, solve, cnf_ops.cnf_adjoint_bwd


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


def device_ms(fn, reps: int) -> tuple:
    """Mean device ms a call of ``fn`` spends in `solve_kernel` launches of
    the one-launch and of the per-attempt mode (its last template argument
    true), from torch.profiler over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    one = split = 0.0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "solve_kernel" in e.name):
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
