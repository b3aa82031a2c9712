"""Shared body of the train CLIs (pu1k / pugan / pugeo / cnf).

The port's counterpart of `puflow_tpu.cli._train_common`, with the same
flags plus ``--device`` (default ``cuda``). ``--synthetic N`` trains on N
synthetic steps per epoch and needs no data file; ``--begin_checkpoint``
takes a checkpoint of the family trained, a native ``.npz`` or a
reference ``.pt``, as the JAX CLIs do.

Under torchrun (``WORLD_SIZE`` over 1) either family trains data
parallel, as the JAX CLIs do over all devices: each rank starts the
process group (`parallel.init_group`, backend ``--dist_backend``: by
default ``nccl`` on CUDA, ``gloo`` on the CPU; device ``cuda:LOCAL_RANK``
with ``--device cuda``), reads the same global batches from the same
seed and trains on its shard; the discrete family's ActNorm warm-up runs
on the global first batch, the CNF family's dopri5 solves take the global
batch's steps (the solve and adjoint kernels' per-attempt mode on the
card), and only rank 0 prints and saves:

    torchrun --nproc_per_node 4 -m puflow_torch.cli.train_pu1k --data ...
    torchrun --nproc_per_node 2 -m puflow_torch.cli.train_cnf --synthetic 4
"""

from __future__ import annotations

import argparse
import os


def build_parser(defaults: dict) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default=defaults.get("data"))
    p.add_argument("--checkpoint", type=str,
                   default=defaults.get("checkpoint"))
    p.add_argument("--begin_checkpoint", type=str, default=None)
    p.add_argument("--learning_rate", type=float,
                   default=defaults.get("learning_rate", 1e-3))
    p.add_argument("--sched_patience", type=int, default=10)
    p.add_argument("--sched_factor", type=float, default=0.5)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_epochs", type=int,
                   default=defaults.get("max_epochs", 100))
    p.add_argument("--seed", type=int, default=2021)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic steps/epoch instead of data")
    p.add_argument("--val_batches", type=int, default=400)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda; under "
                        "torchrun cuda:LOCAL_RANK)")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=("nccl", "gloo"),
                   help="collectives under torchrun (default nccl on "
                        "cuda, gloo on cpu)")
    return p


def run_training(args, model_family: str, make_data_loaders,
                 cd_weight: float = 0.0):
    """model_family: 'discrete' | 'cnf'; make_data_loaders(args) ->
    (train_iter_fn, val_iter_fn)."""
    import torch

    from puflow_torch import parallel

    if model_family == "cnf":
        from puflow_torch.models import continuous as model
    else:
        from puflow_torch.models import discrete as model

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return _train(args, model_family, model, make_data_loaders,
                      cd_weight, None)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = None                            # cuda:LOCAL_RANK
    group = parallel.init_group(args.dist_backend, device=device)
    try:
        return _train(args, model_family, model, make_data_loaders,
                      cd_weight, group)
    finally:
        parallel.destroy_group()


def _train(args, model_family, model, make_data_loaders, cd_weight, group):
    import torch

    from puflow_torch.checkpoint import load_numpy_checkpoint, save_checkpoint
    from puflow_torch.train.trainer import TrainConfig, Trainer
    from puflow_torch.utils.device import resolve_device

    device = group.device if group is not None else resolve_device(
        args.device)
    writer = group is None or group.is_writer
    cfg = TrainConfig(
        learning_rate=args.learning_rate,
        sched_patience=args.sched_patience,
        sched_factor=args.sched_factor,
        max_epochs=args.max_epochs,
        cd_weight=cd_weight,
        seed=args.seed,
    )

    if args.synthetic:
        from puflow_torch.data.synthetic import synthetic_epoch

        train_iter = synthetic_epoch(args.seed, args.synthetic,
                                     args.batch_size)
        val_iter = synthetic_epoch(args.seed + 1,
                                   max(args.synthetic // 4, 1),
                                   args.batch_size)
    else:
        train_iter, val_iter = make_data_loaders(args)

    if args.begin_checkpoint:
        params, state = load_numpy_checkpoint(args.begin_checkpoint,
                                              model_family)
    else:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        params, state = model.init(gen, device=device)
        if model_family == "discrete":
            # on the global first batch, on every rank
            first = next(iter(train_iter()))
            params = model.actnorm_warmup(
                params, state, torch.as_tensor(first[0], device=device))

    trainer = Trainer(cfg, params, state, forward_fn=model.forward,
                      device=device, group=group)
    if writer:
        os.makedirs(os.path.dirname(args.checkpoint) or ".", exist_ok=True)

    def save(epoch, p, s, path=None):
        save_checkpoint(path or args.checkpoint, p, s)

    trainer.fit(train_iter, val_iter, checkpoint_fn=save)
    # the final save is skipped on interruption, as in the reference
    if not trainer.interrupted and writer:
        final = args.checkpoint.replace(".npz",
                                        f"-epoch{args.max_epochs}.npz")
        save(args.max_epochs, *trainer.numpy_params(), path=final)
        print(f"Model saved to {final}")
    return trainer
