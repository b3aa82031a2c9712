"""Train the discrete model on PU-GAN patches on a CUDA card.

The port's counterpart of `puflow_tpu.cli.train_pugan` (the reference's
`modules/discrete/train_pugan.py`): Adam 1e-4, 300 epochs, loss logpx*1e-4
+ EMD*5e-2 + CD*1e-1; data normalised by the GT frame with an always-on z
rotation (`data/pugan.py`); plus ``--device``:

    python -m puflow_torch.cli.train_pugan --data <PUGAN.h5> \
        [--checkpoint runs/ckpt/puflow-pugan.npz] [--synthetic N] \
        [--device cuda]
"""

from __future__ import annotations

from puflow_torch.cli._train_common import build_parser, run_training

DEFAULTS = {
    "data": "data/PUGAN_poisson_256_poisson_1024.h5",
    "checkpoint": "runs/ckpt/puflow-pugan.npz",
    "learning_rate": 1e-4,
    "max_epochs": 300,
}


def _loaders(args):
    from puflow_torch.data.pugan import make_loaders

    return make_loaders({
        "data_path": args.data, "batch_size": args.batch_size,
        "patch_num_point": 256, "up_ratio": 4,
        "seed": args.seed, "val_batches": args.val_batches,
    })


def main(argv=None):
    args = build_parser(DEFAULTS).parse_args(argv)
    return run_training(args, "discrete", _loaders, cd_weight=1e-1)


if __name__ == "__main__":
    main()
