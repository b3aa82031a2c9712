"""Train the discrete model on PU1K patches on a CUDA card.

The port's counterpart of `puflow_tpu.cli.train_pu1k`, with the same
defaults (batch 32, patch 256 -> 1024 (x4), 100 epochs, Adam 1e-3,
ReduceLROnPlateau(0.5, patience 10, min_lr 1e-4), grad clip 1e-2, loss
logpx*1e-4 + EMD*5e-2) plus ``--device``:

    python -m puflow_torch.cli.train_pu1k --data <pu1k.h5> \
        [--checkpoint runs/ckpt/puflow-pu1k.npz] [--begin_checkpoint ck.npz] \
        [--synthetic N]  # N synthetic steps/epoch when no h5 is available
        [--device cuda]
"""

from __future__ import annotations

from puflow_torch.cli._train_common import build_parser, run_training

DEFAULTS = {
    "data": "data/pu1k_poisson_256_poisson_1024_pc_2500_patch50_addpugan.h5",
    "checkpoint": "runs/ckpt/puflow-pu1k.npz",
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
    return run_training(args, _loaders)


if __name__ == "__main__":
    main()
