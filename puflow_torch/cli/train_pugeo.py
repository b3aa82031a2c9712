"""Train the discrete model on PUGeo / Sketchfab tfrecord shapes on a CUDA
card.

The port's counterpart of `puflow_tpu.cli.train_pugeo` (the reference's
`modules/discrete/train_pugeo.py` + `dataset/pugeo/fetcher.py`): shapes
stream from tfrecord shards (`data/tfrecord.py`, no tensorflow), patches
are cut by k-NN around random seeds and normalised in the label frame; 300
batches an epoch; plus ``--device``:

    python -m puflow_torch.cli.train_pugeo \
        --data 'data/tfrecord_x4_normal/*.tfrecord' [--device cuda]
"""

from __future__ import annotations

from puflow_torch.cli._train_common import build_parser, run_training

DEFAULTS = {
    "data": "data/tfrecord_x4_normal/*.tfrecord",
    "checkpoint": "runs/ckpt/puflow-pugeo.npz",
    "learning_rate": 1e-3,
    "max_epochs": 100,
}


def _loaders(args):
    from puflow_torch.data.pugeo import make_loaders

    return make_loaders({
        "records": args.data, "batch_size": args.batch_size,
        "num_in_point": 256, "up_ratio": 4, "seed": args.seed,
        "val_batches": min(args.val_batches, 40),
    })


def main(argv=None):
    args = build_parser(DEFAULTS).parse_args(argv)
    return run_training(args, "discrete", _loaders)


if __name__ == "__main__":
    main()
