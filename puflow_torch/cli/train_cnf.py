"""Train the continuous (CNF) model on PU1K patches on a CUDA card.

The port's counterpart of `puflow_tpu.cli.train_cnf` (the reference's
`modules/continuous/train_interp.py`): the optimizer, schedule and loss
weights of the discrete PU1K run, the flow blocks replaced by conditional
CNFs (dopri5, trainable T), no ActNorm warm-up; plus ``--device``:

    python -m puflow_torch.cli.train_cnf --data <pu1k.h5> \
        [--checkpoint runs/ckpt/puflow-cnf-pu1k.npz] \
        [--begin_checkpoint ck.npz] [--synthetic N] [--device cuda]
"""

from __future__ import annotations

from puflow_torch.cli._train_common import build_parser, run_training

DEFAULTS = {
    "data": "data/pu1k_poisson_256_poisson_1024_pc_2500_patch50_addpugan.h5",
    "checkpoint": "runs/ckpt/puflow-cnf-pu1k.npz",
    "learning_rate": 1e-3,
    "max_epochs": 100,
}


def _loaders(args):
    from puflow_torch.data.pu1k import make_loaders

    return make_loaders({
        "data_path": args.data, "batch_size": args.batch_size,
        "num_point_patch": 256, "up_ratio": 4, "is_random_input": False,
        "is_augment": True, "jitter_sigma": 0.01, "jitter_max": 0.03,
        "seed": args.seed, "val_batches": args.val_batches,
    })


def main(argv=None):
    args = build_parser(DEFAULTS).parse_args(argv)
    return run_training(args, "cnf", _loaders)


if __name__ == "__main__":
    main()
