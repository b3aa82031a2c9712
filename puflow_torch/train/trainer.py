"""Training loop of either model family on one device.

Counterpart of `puflow_tpu.train.trainer` (the reference's
`modules/discrete/train_pu1k.py`; `forward_fn` picks the family,
`discrete.forward` by default, `continuous.forward` for the CNF model of
`modules/continuous/train_interp.py`):
  * loss = logpx * 1e-4 + EMD * 5e-2 (+ CD * cd_weight for pugan);
  * optax's ``chain(clip_by_global_norm(1e-2), adam(1e-3))`` written out
    (`ClipAdam`): optax clips by ``t / g_norm * max_norm`` where
    ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``;
  * ReduceLROnPlateau(factor .5, patience 10, min_lr 1e-4) between epochs;
  * the NaN guard: on a non-finite loss the gradients become zeros and
    the optimizer still steps (its count and moment decay advance), and
    the BN running statistics keep their old values;
  * validation chamfer in the kaolin convention.

The parameters and the BN state are each held as one flat float32 vector
(`TreeLayout`), so a step runs a handful of optimizer kernels instead of
a few per leaf; the model functions get trees of views into it, and
checkpoints use the `.npz` keys of the trees. Metrics stay on the device
until an epoch ends.

Data parallel (``Trainer(..., group=...)``, a `parallel.Group`): the JAX
package's semantics under its sharded jit. Every rank takes the same
global batch and trains on its shard (`parallel.shard_batch`); train-mode
BN normalises with the global batch's statistics and the NLL is the
global batch's mean, both through the differentiable all-reduce, so each
rank's gradient holds the cross-rank terms; each rank's loss term is
weighted by how its global value is reduced (the NLL, a global mean that
every rank holds, and the chamfer mean over ``W``; the EMD sum as it
is), and one all-reduce of the flat gradient vector (with the loss and
the EMD) a step gives the global loss's gradient. The NaN guard, the
clip and Adam then run on identical inputs on every rank, so the
parameters stay bit-equal; rank 0's parameters, BN state and Adam state
are broadcast at construction and after a restore, and only rank 0
writes files and logs. Either family trains so: in the continuous one
every dopri5 solve of the step (forward and adjoint) takes the global
batch's steps and each backward solve gives this rank's part of the
layers' gradient, which the one all-reduce adds; its validation passes
the group to `continuous.forward(train=False)` too, whose solves then take
the global batch's steps and whose NLL is the global mean. The discrete
family's validation runs each rank's shard alone (it has no adaptive
solve).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable

import numpy as np
import torch

from puflow_torch.checkpoint import (_flatten, _unflatten,
                                     load_npz_checkpoint, save_checkpoint)
from puflow_torch.models import discrete
from puflow_torch.ops.chamfer import chamfer_distance, chamfer_distance_kaolin
from puflow_torch.ops.emd import emd_auction
from puflow_torch.parallel.mesh import (all_reduce_, broadcast_,
                                        is_distributed, shard_batch)
from puflow_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    min_lr: float = 1e-4
    sched_factor: float = 0.5
    sched_patience: int = 10
    grad_clip: float = 1e-2
    max_epochs: int = 100
    logpx_weight: float = 1e-4
    emd_weight: float = 5e-2
    cd_weight: float = 0.0          # 1e-1 for pugan
    emd_eps: float = 0.005
    emd_iters: int = 50
    upratio: int = 4
    seed: int = 2021


# --------------------------------------------------------------------------
# Trees as flat vectors
# --------------------------------------------------------------------------
def _lookup(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


class TreeLayout:
    """The leaf paths and shapes of a tree, to hold it as one flat float32
    vector: `flatten` packs a tree (of arrays or tensors) in path order,
    `unflatten` gives the tree of views into a vector (autograd flows from
    the views to the vector)."""

    def __init__(self, tree):
        items = list(discrete._leaves(tree))
        self.paths = [p for p, _ in items]
        self.shapes = [tuple(np.shape(a)) for _, a in items]
        self.sizes = [int(np.prod(s)) for s in self.shapes]

    def flatten(self, tree, device=None) -> torch.Tensor:
        return torch.cat([
            torch.as_tensor(_lookup(tree, p), dtype=torch.float32,
                            device=device).reshape(-1)
            for p in self.paths])

    def unflatten(self, flat: torch.Tensor):
        views = flat.split(self.sizes)
        return _unflatten({p: v.view(s) for p, v, s in
                           zip(self.paths, views, self.shapes)})

    def numpy_tree(self, flat: torch.Tensor):
        """The tree of numpy copies of a vector's leaves."""
        flat = flat.detach().cpu()
        return _unflatten({p: np.array(v.numpy()).reshape(s) for p, v, s in
                           zip(self.paths, flat.split(self.sizes),
                               self.shapes)})


# --------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, inject_hyperparams(adam))
# --------------------------------------------------------------------------
@dataclasses.dataclass
class AdamState:
    count: int                 # steps taken, NaN-guarded ones included
    mu: torch.Tensor
    nu: torch.Tensor
    learning_rate: float       # set between epochs by the plateau control


class ClipAdam:
    """Global-norm clipping then Adam, with optax's arithmetic: updates
    ``t`` when ``|g| < max_norm`` else ``t / |g| * max_norm``; Adam with
    bias-corrected moments and ``m_hat / (sqrt(v_hat) + eps)``, scaled by
    ``-learning_rate``."""

    def __init__(self, max_norm: float, learning_rate: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.max_norm = max_norm
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(params), torch.zeros_like(params),
                         self.learning_rate)

    def update(self, grads: torch.Tensor, state: AdamState):
        """-> (updates to add to the params, new state)."""
        g_norm = torch.linalg.vector_norm(grads)
        grads = torch.where(g_norm < self.max_norm, grads,
                            grads / g_norm * self.max_norm)
        mu = (1 - self.b1) * grads + self.b1 * state.mu
        nu = (1 - self.b2) * (grads * grads) + self.b2 * state.nu
        count = state.count + 1
        # the bias corrections in float32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        updates = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return (updates * -state.learning_rate,
                AdamState(count, mu, nu, state.learning_rate))


def make_optimizer(cfg: TrainConfig) -> ClipAdam:
    return ClipAdam(cfg.grad_clip, cfg.learning_rate)


# --------------------------------------------------------------------------
# Steps
# --------------------------------------------------------------------------
def _no_mark(stage: str) -> None:
    pass


def make_loss_and_grad(cfg: TrainConfig, param_layout: TreeLayout,
                       state_layout: TreeLayout,
                       forward_fn: Callable = discrete.forward, group=None):
    """The loss's gradient ``(params, bn_state, sparse, dense) -> (grads,
    loss, logpx, emd, new_bn)`` on flat vectors, before the NaN guard.
    With ``group`` the batch is this rank's shard and every output is the
    global batch's, the same on every rank (module docstring); ``mark``
    as in `make_train_step`, with an ``allreduce`` stage."""
    w = 1 if group is None else group.world_size
    kw = {"group": group} if is_distributed(group) else {}

    def loss_and_grad(params, bn_state, sparse, dense,
                      mark: Callable = _no_mark):
        leaf = params.detach().requires_grad_()
        pred, logpx, new_bn = forward_fn(
            param_layout.unflatten(leaf), state_layout.unflatten(bn_state),
            sparse, cfg.upratio, train=True, **kw)
        mark("forward")
        emd_dist, _ = emd_auction(pred, dense, cfg.emd_eps, cfg.emd_iters)
        emd = torch.sum(emd_dist)
        loss = logpx * (cfg.logpx_weight / w) + emd * cfg.emd_weight
        if cfg.cd_weight:
            loss = loss + chamfer_distance(pred, dense) * (cfg.cd_weight / w)
        mark("emd")
        (grads,) = torch.autograd.grad(loss, leaf)
        mark("backward")
        loss, logpx, emd = loss.detach(), logpx.detach(), emd.detach()
        if group is not None:
            # one all-reduce: the gradient, the loss and the EMD
            flat = torch.cat([grads, loss.reshape(1), emd.reshape(1)])
            all_reduce_(flat)
            grads, loss, emd = flat[:-2], flat[-2], flat[-1]
            mark("allreduce")
        return grads, loss, logpx, emd, new_bn

    return loss_and_grad


def make_train_step(optimizer: ClipAdam, cfg: TrainConfig,
                    param_layout: TreeLayout, state_layout: TreeLayout,
                    forward_fn: Callable = discrete.forward, group=None):
    """The train step ``(params, bn_state, opt_state, sparse, dense) ->
    (params, bn_state, opt_state, metrics)`` on flat vectors (the layouts
    give their trees); ``forward_fn`` selects the model family; ``group``
    (a `parallel.Group`) makes it data parallel over this rank's shard.
    ``mark(stage)``, if given, is called after the forward, the EMD and
    loss, the backward, the gradient's all-reduce (with a group) and the
    optimizer update (for timing)."""
    loss_and_grad = make_loss_and_grad(cfg, param_layout, state_layout,
                                       forward_fn, group)

    def train_step(params, bn_state, opt_state, sparse, dense,
                   mark: Callable = _no_mark):
        grads, loss, logpx, emd, new_bn = loss_and_grad(
            params, bn_state, sparse, dense, mark)
        with torch.no_grad():
            # NaN guard: zero gradients, and the optimizer still steps
            ok = torch.isfinite(loss)
            grads = torch.where(ok, grads, 0.0)
            updates, opt_state = optimizer.update(grads, opt_state)
            params = params + updates
            bn_state = torch.where(ok, state_layout.flatten(new_bn), bn_state)
        mark("optimizer")
        metrics = {"loss": loss, "logpx": logpx, "emd": emd, "nan_step": ~ok}
        return params, bn_state, opt_state, metrics

    return train_step


@torch.no_grad()
def eval_step(params, bn_state, sparse, dense, upratio: int,
              forward_fn: Callable = discrete.forward, group=None) -> dict:
    """Validation on trees: the NLL (``vloss``) and the summed kaolin
    chamfer (``CD``), as tensors. ``group`` goes to ``forward_fn`` where it
    is given (the continuous family's, whose validation solves then take
    the global batch's steps)."""
    kw = {} if group is None else {"group": group}
    pred, logpx, _ = forward_fn(params, bn_state, sparse, upratio,
                                train=False, **kw)
    return {"vloss": logpx, "CD": torch.sum(chamfer_distance_kaolin(pred,
                                                                     dense))}


def _stack(step_metrics: list, device, group=None) -> dict:
    """Per-step metric tensors -> numpy arrays, with one device read;
    with ``group``, each summed over the ranks first (one all-reduce)."""
    keys = list(step_metrics[0])
    rows = torch.stack([
        torch.stack([m[k].to(device, torch.float32).reshape(()) for k in keys])
        for m in step_metrics])
    if group is not None:
        all_reduce_(rows)
    rows = rows.cpu().numpy()
    return {k: rows[:, i] for i, k in enumerate(keys)}


class Trainer:
    """Epochs, plateau LR, validation and checkpoints around the step.

    ``params`` and ``bn_state`` are trees of numpy arrays or tensors (the
    JAX package's trees after ``jax.tree.map(np.asarray, ...)`` work); they
    are copied onto ``device`` (default ``cuda``). ``forward_fn`` selects
    the model family: `discrete.forward` or `continuous.forward`.

    ``group`` (a `parallel.Group` from `parallel.init_group`) makes it data
    parallel on the group's device (module docstring): `step`,
    `train_epoch` and `validate` take the global batches, the same on
    every rank, and train on this rank's shard.
    """

    def __init__(self, cfg: TrainConfig, params, bn_state,
                 forward_fn: Callable = discrete.forward, device=None,
                 group=None):
        if group is not None:
            if device is not None and resolve_device(device) != group.device:
                raise ValueError(f"device {device} is not the group's "
                                 f"{group.device}")
            device = group.device
        self.cfg = cfg
        self.forward_fn = forward_fn
        self.group = group
        # the group reaches validation's forward in the continuous family
        self._eval_group = (group if is_distributed(group)
                            and forward_fn is not discrete.forward else None)
        self.device = resolve_device("cuda" if device is None else device)
        self.param_layout = TreeLayout(params)
        self.state_layout = TreeLayout(bn_state)
        self.params = self.param_layout.flatten(params, self.device)
        self.bn_state = self.state_layout.flatten(bn_state, self.device)
        self.optimizer = make_optimizer(cfg)
        self.opt_state = self.optimizer.init(self.params)
        self._broadcast_state()
        self._loss_and_grad = make_loss_and_grad(
            cfg, self.param_layout, self.state_layout, forward_fn, group)
        self._train_step = make_train_step(
            self.optimizer, cfg, self.param_layout, self.state_layout,
            forward_fn, group)

        # ReduceLROnPlateau state
        self._lr = cfg.learning_rate
        self._best = float("inf")
        self._bad_epochs = 0
        self.history: list[dict] = []
        self.interrupted = False

    # -- LR plateau controller (between epochs, on the host) ---------------
    def _plateau_update(self, monitored: float):
        if monitored < self._best - 1e-12:
            self._best = monitored
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.cfg.sched_patience:
                self._lr = max(self._lr * self.cfg.sched_factor,
                               self.cfg.min_lr)
                self._bad_epochs = 0

    def _set_lr(self):
        self.opt_state.learning_rate = self._lr

    @property
    def is_writer(self) -> bool:
        """Whether this process logs and writes files (rank 0)."""
        return self.group is None or self.group.is_writer

    def _broadcast_state(self):
        """With a group: rank 0's parameters, BN state and Adam state
        (moments and step count) on every rank, in one broadcast."""
        if self.group is None:
            return
        st = self.opt_state
        count = torch.tensor([float(st.count)], device=self.device)
        flat = broadcast_(torch.cat([self.params, self.bn_state, st.mu,
                                     st.nu, count]))
        n, m = self.params.numel(), self.bn_state.numel()
        self.params, self.bn_state, mu, nu, count = flat.split(
            [n, m, n, n, 1])
        self.opt_state = AdamState(int(count), mu, nu, st.learning_rate)

    def trees(self):
        """The (params, bn_state) trees of views into the flat vectors."""
        return (self.param_layout.unflatten(self.params),
                self.state_layout.unflatten(self.bn_state))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _shard(self, a) -> torch.Tensor:
        """This rank's shard of a global batch, on the device."""
        return self._tensor(shard_batch(a, self.group))

    def step(self, sparse, dense, mark: Callable = _no_mark) -> dict:
        """One train step on a batch; returns its metrics as tensors."""
        self.params, self.bn_state, self.opt_state, m = self._train_step(
            self.params, self.bn_state, self.opt_state, self._shard(sparse),
            self._shard(dense), mark)
        return m

    def gradient(self, sparse, dense):
        """The loss's gradient at the current parameters on a batch, as a
        flat vector (the global batch's with a group), and the loss; no
        update."""
        grads, loss, _, _, _ = self._loss_and_grad(
            self.params, self.bn_state, self._shard(sparse),
            self._shard(dense))
        return grads, loss

    def train_epoch(self, batches) -> dict:
        """batches: iterable of (sparse [B,N,3], dense [B,N*r,3]) numpy.

        Metrics stay on the device until the epoch ends: one read at the
        end instead of a host sync per step.
        """
        self._set_lr()
        step_metrics = [self.step(sparse, dense) for sparse, dense in batches]
        agg = {}
        if step_metrics:
            agg = {k: float(v.mean())
                   for k, v in _stack(step_metrics, self.device).items()}
        return agg | {"steps": len(step_metrics), "lr": self._lr}

    def validate(self, batches) -> dict:
        params, bn_state = self.trees()
        step_metrics = [
            eval_step(params, bn_state, self._shard(sparse),
                      self._shard(dense), self.cfg.upratio, self.forward_fn,
                      self._eval_group)
            for sparse, dense in batches]
        if not step_metrics:
            return {"CD": 0.0, "vloss": 0.0}
        # with a group: CD summed over the ranks, the NLL their mean (in
        # the continuous family every rank's is the global batch's already)
        stacked = _stack(step_metrics, self.device, self.group)
        if self.group is not None:
            stacked["vloss"] = stacked["vloss"] / self.group.world_size
        # the reference sums CD over validation batches
        return {"CD": float(stacked["CD"].sum()),
                "vloss": float(stacked["vloss"].sum()) * 1e-5}

    def fit(self, train_iter_fn, val_iter_fn, max_epochs=None,
            log_fn=print, checkpoint_fn=None):
        """Epoch loop. A KeyboardInterrupt stops cleanly and sets
        `self.interrupted` (the reference then skips the final save).
        With a group only rank 0 calls ``log_fn`` and ``checkpoint_fn``."""
        max_epochs = max_epochs or self.cfg.max_epochs
        if not self.is_writer:
            log_fn = checkpoint_fn = None
        self.interrupted = False
        try:
            for epoch in range(max_epochs):
                t0 = time.time()
                tr = self.train_epoch(train_iter_fn())
                va = self.validate(val_iter_fn()) if val_iter_fn else {}
                self._plateau_update(va.get("CD", tr["loss"]))
                row = {"epoch": epoch, **tr, **va,
                       "time_s": round(time.time() - t0, 2)}
                self.history.append(row)
                if log_fn:
                    log_fn(f"[epoch {epoch:3d}] " + "  ".join(
                        f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in row.items() if k != "epoch"))
                if checkpoint_fn:
                    checkpoint_fn(epoch, *self.numpy_params())
        except KeyboardInterrupt:
            self.interrupted = True
            if log_fn:
                log_fn(f"interrupted at epoch {len(self.history)}")
        return self.history

    def numpy_params(self):
        return (self.param_layout.numpy_tree(self.params),
                self.state_layout.numpy_tree(self.bn_state))

    # -- full train-state checkpoint / resume ------------------------------
    # The reference ships only weights; resume here also restores the Adam
    # moments, the step count and the plateau controller.
    def save_train_state(self, path: str):
        """``path``: the weights (`checkpoint.save_checkpoint`);
        ``path + ".opt.npz"``: the Adam moments in the params' keys under
        ``mu/`` and ``nu/`` and the step count; ``path + ".meta.json"``:
        the plateau controller and the history. With a group only rank 0
        writes."""
        if not self.is_writer:
            return
        save_checkpoint(path, *self.numpy_params())
        opt = {"count": np.asarray(self.opt_state.count, np.int64)}
        _flatten("mu", self.param_layout.numpy_tree(self.opt_state.mu), opt)
        _flatten("nu", self.param_layout.numpy_tree(self.opt_state.nu), opt)
        np.savez(path + ".opt.npz", **opt)
        meta = {"lr": self._lr, "best": self._best,
                "bad_epochs": self._bad_epochs,
                "epochs_done": len(self.history), "history": self.history}
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)

    def restore_train_state(self, path: str) -> int:
        """Inverse of `save_train_state`; returns the epochs done. With a
        group every rank reads the files and then takes rank 0's
        parameters, BN state and Adam state."""
        params, bn_state = load_npz_checkpoint(path)
        self.params = self.param_layout.flatten(params, self.device)
        self.bn_state = self.state_layout.flatten(bn_state, self.device)
        with np.load(path + ".opt.npz") as data:
            opt = _unflatten({k: data[k] for k in data.files})
        self.opt_state = AdamState(
            int(opt["count"]),
            self.param_layout.flatten(opt["mu"], self.device),
            self.param_layout.flatten(opt["nu"], self.device), self._lr)
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        self._lr = meta["lr"]
        self._best = meta["best"]
        self._bad_epochs = meta["bad_epochs"]
        self.history = meta["history"]
        self._set_lr()
        self._broadcast_state()
        return meta["epochs_done"]
