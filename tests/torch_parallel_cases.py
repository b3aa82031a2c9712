"""Rank bodies of the port's data-parallel tests
(tests/test_torch_parallel*.py, tests/test_torch_cuda.py) and of
`chip_smoke.py:phase_data_parallel`.

`run_ranks` spawns one process a rank, each with one torch thread (spawned
processes do not inherit a test module's `one_torch_thread`), starts the
group with a ``file://`` rendezvous under a fresh directory (no TCP port,
so concurrent test workers never collide), runs ``fn(group, *args)`` and
returns every rank's result. A rank that raises fails the whole run (the
others are ended). Imports numpy, torch and `puflow_torch` only: the
children never import jax; the tests compute the JAX side in the parent.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import statistics
import tempfile
import time

import torch
import torch.multiprocessing as mp

from puflow_torch import checkpoint, parallel
from puflow_torch.inference.patch import upsample_cloud, upsample_cloud_sharded
from puflow_torch.models import discrete
from puflow_torch.models.fold_bn import empty_bn_state, fold_bn_inference
from puflow_torch.models.nn import bn_apply
from puflow_torch.ops import emd as emd_ops
from puflow_torch.ops import encoder as enc_ops
from puflow_torch.ops import flow as flow_ops
from puflow_torch.ops import fps as fps_ops
from puflow_torch.ops import interp as interp_ops
from puflow_torch.ops import knn as knn_ops
from puflow_torch.train import trainer as trainer_mod
from puflow_torch.train.trainer import TrainConfig, Trainer

EMD_ITERS = 5          # the JAX package's gradient test (tests/test_train.py)
# the wrappers of the folded path's six kernels (launches an upsample_cloud:
# FPS twice, the others once)
FOLDED = {"fps": fps_ops.farthest_point_sample, "knn_self": knn_ops.knn_self,
          "encoder": enc_ops.encoder_conditions,
          "interp_head": interp_ops.interp_head, "flow_f": flow_ops.flow_f,
          "flow_g_blend": flow_ops.flow_g_blend}


def _rank_main(rank, fn, world_size, backend, devices, store, out, threads,
               args):
    torch.set_num_threads(threads)
    group = parallel.init_group(backend, rank, world_size, devices[rank],
                                init_method=f"file://{store}",
                                timeout_s=300.0)
    try:
        result = fn(group, *args)
    finally:
        parallel.destroy_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world_size: int, *args, backend: str = "gloo",
              devices=None, threads: int = 1, tmp=None,
              timeout_s: float = 600.0) -> list:
    """``fn(group, *args)`` on ``world_size`` spawned ranks -> the ranks'
    results in rank order. ``devices``: one a rank (default the CPU);
    ``fn`` and ``args`` must pickle (a module-level function, numpy).
    Raises if a rank fails or the ranks outlast ``timeout_s`` (every rank
    is then ended)."""
    devices = devices or ["cpu"] * world_size
    with tempfile.TemporaryDirectory(dir=tmp) as out:
        ctx = mp.spawn(_rank_main, nprocs=world_size, join=False, args=(
            fn, world_size, backend, devices, os.path.join(out, "store"),
            out, threads, args))
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                   f"ran over {timeout_s} s")
        results = []
        for rank in range(world_size):
            with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


# --------------------------------------------------------------------------
# CPU cases
# --------------------------------------------------------------------------
def bn_rank(group, params, state, x, cot):
    """`bn_apply` in train mode on this rank's shard of ``x``: its output,
    the new running statistics and the gradient of ``sum(y * cot)`` (the
    global sum of the ranks' terms) with respect to the shard."""
    xs = torch.from_numpy(parallel.shard_batch(x, group)).requires_grad_()
    cs = torch.from_numpy(parallel.shard_batch(cot, group))
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    s = {k: torch.from_numpy(v) for k, v in state.items()}
    y, new_state = bn_apply(p, s, xs, train=True, group=group)
    (g,) = torch.autograd.grad(torch.sum(y * cs), xs)
    return {"y": _numpy(y), "state": _numpy(new_state), "grad": _numpy(g)}


def grad_rank(group, params, state, sparse, dense):
    """The discrete loss's data-parallel gradient (flat, the trainer's
    layout) and loss on the global batch."""
    tr = Trainer(TrainConfig(emd_iters=EMD_ITERS), params, state,
                 group=group)
    grads, loss = tr.gradient(sparse, dense)
    return {"grads": _numpy(grads), "loss": float(loss)}


def trainer_rank(group, params, state, nan_batch, batches, val):
    """A NaN batch (non-finite in one rank's shard), then the batches, on
    the data-parallel `Trainer`; each step's parameters, BN state and
    metrics, and `validate` on ``val``."""
    tr = Trainer(TrainConfig(emd_iters=EMD_ITERS), params, state,
                 group=group)
    steps = []
    for sparse, dense in [nan_batch, *batches]:
        m = tr.step(sparse, dense)
        steps.append({"params": _numpy(tr.params),
                      "bn_state": _numpy(tr.bn_state),
                      "metrics": {k: float(v) for k, v in m.items()}})
    return {"steps": steps, "validate": tr.validate(val)}


def upsample_rank(group, params, state, pc, npoint, upratio, patch_size,
                  expand_ratio):
    """`upsample_cloud_sharded` of the model of the numpy trees."""
    model = checkpoint.from_numpy_tree(params, state, group.device)
    with torch.no_grad():
        out = upsample_cloud_sharded(model, torch.from_numpy(pc), npoint,
                                     upratio, patch_size, expand_ratio,
                                     group=group)
    return _numpy(out)


# --------------------------------------------------------------------------
# Card cases (chip_smoke.py, tests/test_torch_cuda.py)
# --------------------------------------------------------------------------
def _sync(group):
    """Wait for this rank's card, then for every rank (a scalar
    all-reduce), so that a timer starts with every rank at the same
    place."""
    torch.cuda.synchronize(group.device)
    parallel.all_reduce_(torch.zeros(1, device=group.device))
    torch.cuda.synchronize(group.device)


def folded_model(params, state, device):
    """The BN-folded model of the numpy trees on ``device``."""
    tp, ts = checkpoint.from_numpy_tree(params, state, device).trees()
    return discrete.DiscreteModel(fold_bn_inference(tp, ts),
                                  empty_bn_state(ts))


def sharded_upsample_rank(group, params, state, pc, npoint, reps: int = 0):
    """`upsample_cloud_sharded` of the folded model on the card with the
    folded path's six launch counts set to 0 just before and read just
    after; then ``reps`` timed calls (ms a call, every rank started
    together); and `upsample_cloud` of this rank's clouds alone. -> {"out",
    "launches", "ms", "alone"}."""
    model = folded_model(params, state, group.device)
    x = torch.from_numpy(pc)
    with torch.no_grad():
        upsample_cloud_sharded(model, x, npoint, group=group)    # warm-up
        _sync(group)
        for fn in FOLDED.values():
            fn.launches = 0
        out = upsample_cloud_sharded(model, x, npoint, group=group)
        torch.cuda.synchronize(group.device)
        launches = {k: fn.launches for k, fn in FOLDED.items()}
        ms = []
        for _ in range(reps):
            _sync(group)
            t0 = time.perf_counter()
            upsample_cloud_sharded(model, x, npoint, group=group)
            torch.cuda.synchronize(group.device)
            ms.append((time.perf_counter() - t0) * 1e3)
        alone = upsample_cloud(model, parallel.shard_batch(x, group).to(
            group.device), npoint)
    return {"out": _numpy(out), "launches": launches, "ms": ms,
            "alone": _numpy(alone)}


@contextlib.contextmanager
def trainer_emd(emd_fn):
    """The trainer's EMD replaced by ``emd_fn`` (the signature of
    `ops.emd.emd_auction`) inside the block."""
    saved = trainer_mod.emd_auction
    trainer_mod.emd_auction = emd_fn
    try:
        yield
    finally:
        trainer_mod.emd_auction = saved


def recording_emd(seen: list):
    """The auction, appending each call's assignment to ``seen``."""
    def emd(pred, dense, eps, iters):
        dist, assign = emd_ops.emd_auction(pred, dense, eps, iters)
        seen.append(assign)
        return dist, assign
    return emd


def fixed_emd(assign: torch.Tensor):
    """The EMD at a given assignment: the matched squared distances,
    whose gradient is the auction's backward for that assignment. Two runs
    that differ by rounding can take other auction assignments (the
    auction is not continuous in its input); at one assignment their
    gradients differ by rounding only."""
    def emd(pred, dense, eps, iters):
        a = assign.to(pred.device)
        return emd_ops.matched_sqdist(pred, dense, a), a
    return emd


def gradients(tr, sparse, dense, assign=None):
    """The trainer's gradient on a batch with the auction (and the
    assignment it took) and, given the reference ``assign`` of the global
    batch, at that assignment: -> {"auction", "assign", "loss", "fixed"}."""
    seen = []
    with trainer_emd(recording_emd(seen)):
        g, loss = tr.gradient(sparse, dense)
    out = {"auction": _numpy(g), "assign": _numpy(seen[0]),
           "loss": float(loss)}
    if assign is not None:
        with trainer_emd(fixed_emd(torch.from_numpy(
                parallel.shard_batch(assign, tr.group)))):
            out["fixed"] = _numpy(tr.gradient(sparse, dense)[0])
    return out


def card_train_rank(group, params, state, grad_batch, assign, batch,
                    steps: int, sharded=None):
    """The data-parallel path on the card, on each rank:

      * the first-step gradient on ``grad_batch`` (one cloud a rank), with
        the auction and at the one-process run's assignment ``assign``
        (`gradients`);
      * ``steps`` train steps on the global ``batch``, with the EMD's
        launch count set to 0 just before each and read just after, each
        step split by CUDA events (forward, emd, backward, allreduce,
        optimizer), and rank 0's parameters, BN state and Adam moments
        broadcast after each to hold this rank's bit-equal to them;
      * the host ms of an all-reduce of 64 floats (mean of 20), the size
        of a BN layer's statistics;
      * with ``sharded`` (``(folded params, state, clouds, npoint)``),
        `sharded_upsample_rank` with 5 timed calls.
    """
    tr = Trainer(TrainConfig(), params, state, group=group)
    out = {"grads": gradients(tr, *grad_batch, assign), "steps": []}
    sparse, dense = batch
    for _ in range(steps):
        marks = []

        def mark(stage, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        emd_ops.emd_auction.launches = 0
        _sync(group)
        t0 = time.perf_counter()
        mark("start")
        m = tr.step(sparse, dense, mark)
        torch.cuda.synchronize(group.device)
        wall = (time.perf_counter() - t0) * 1e3
        launches = emd_ops.emd_auction.launches
        mine = torch.cat([tr.params, tr.bn_state, tr.opt_state.mu,
                          tr.opt_state.nu])
        ref = parallel.broadcast_(mine.clone())
        out["steps"].append({
            "split": {stage: a.elapsed_time(b) for (_, a), (stage, b)
                      in zip(marks, marks[1:])},
            "wall_ms": wall, "emd_launches": launches,
            "bit_equal": bool(torch.equal(mine, ref)),
            "loss": float(m["loss"]), "nan_step": bool(m["nan_step"])})
    out["split_median"] = {
        stage: statistics.median(s["split"][stage] for s in out["steps"])
        for stage in out["steps"][0]["split"]}
    small = torch.zeros(64, device=group.device)
    _sync(group)
    t0 = time.perf_counter()
    for _ in range(20):
        parallel.all_reduce_(small)
    torch.cuda.synchronize(group.device)
    out["small_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    if sharded is not None:
        out["sharded"] = sharded_upsample_rank(group, *sharded, reps=5)
    return out


def nccl_one_rank(group, params, state, batches):
    """World size 1: the data-parallel `Trainer` (its gradient all-reduce
    through the group's backend) against the plain one, step by step.
    -> each step's (parameters bit-equal, BN state bit-equal, max |diff|).
    PyTorch's deterministic algorithms are on (and cuBLAS's fixed
    workspace), as without them the plain trainer is not bit-equal to
    itself on the card: the gather's backward adds with atomics."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    dp = Trainer(TrainConfig(), params, state, group=group)
    plain = Trainer(TrainConfig(), params, state, device=group.device)
    rows = []
    for sparse, dense in batches:
        dp.step(sparse, dense)
        plain.step(sparse, dense)
        rows.append((bool(torch.equal(dp.params, plain.params)),
                     bool(torch.equal(dp.bn_state, plain.bn_state)),
                     float((dp.params - plain.params).abs().max())))
    return rows


def seeded_first_step(sparse, device="cpu"):
    """Seeded init (a CPU torch generator, seed 2021) and the ActNorm
    warm-up on the ``sparse`` clouds, on ``device``: the weights of a first
    training step, as numpy trees."""
    gen = torch.Generator(device="cpu").manual_seed(2021)
    params, state = checkpoint.from_numpy_tree(
        *_numpy(discrete.init(gen, device="cpu")), device).trees()
    params = discrete.actnorm_warmup(
        params, state, torch.from_numpy(sparse).to(device))
    return _numpy(params), _numpy(state)


def perturbed_trees(seed: int = 2021):
    """Seeded init (a CPU torch generator) moved far from the identity by
    `discrete.perturb_init`, as numpy trees (the folded path's model once
    `folded_model` folds it)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params, state = _numpy(discrete.init(gen, device="cpu"))
    return discrete.perturb_init(params, state, seed)


def upsample_one_process(params, state, pc, npoint, device):
    """`upsample_cloud` of the folded model in this process, the sharded
    run's reference."""
    model = folded_model(params, state, device)
    with torch.no_grad():
        return upsample_cloud(model, torch.from_numpy(pc).to(device),
                              npoint)



def cli_twin_rank(group, seed: int, steps: int, batch_size: int):
    """What `python -m puflow_torch.cli.train_pu1k --synthetic <steps>
    --batch_size <batch_size> --max_epochs 1` trains under torchrun, in
    process: the seeded init, the ActNorm warm-up on the global first
    batch, one epoch of the data-parallel `Trainer` -> numpy trees."""
    from puflow_torch.data.synthetic import synthetic_epoch

    train_iter = synthetic_epoch(seed, steps, batch_size)
    gen = torch.Generator(device=group.device).manual_seed(seed)
    params, state = discrete.init(gen, device=group.device)
    first = next(iter(train_iter()))
    params = discrete.actnorm_warmup(params, state,
                                     torch.from_numpy(first[0]))
    tr = Trainer(TrainConfig(), params, state, group=group)
    tr.train_epoch(train_iter())
    return tr.numpy_params()
