"""Upsample .xyz point clouds with a PU-Flow checkpoint on a CUDA card.

The port's counterpart of `puflow_tpu.cli.upsample`, with the same flags
plus ``--device``:

    python -m puflow_torch.cli.upsample --source <dir> --target <dir> \
        --checkpoint <ckpt> --up_ratio 4 [--num_patch 256] \
        [--num_out N] [--seed 2021] [--model discrete|cnf] [--exact] \
        [--seeded_merge] [--merge_groups G] [--device cuda]

Accepts either a reference torch ``.pt`` state_dict (converted on the fly
by `puflow_torch.convert`) or a native ``.npz`` checkpoint and, unless
``--exact`` is given, folds BatchNorm into the convs as
`puflow_tpu.cli.upsample` does.
``--model cnf`` serves the continuous family (`models.continuous`): six
CNF blocks, each block-solve one CUDA kernel launch.
``--seeded_merge`` and ``--merge_groups`` select the opt-in merges of
`inference.patch.upsample_cloud`. Clouds are grouped by point count and
batched ``--batch`` at a time, the tail batch padded so every batch has
the same shape. One batch's copy to the host and its file writes overlap
the next batch's work on the card. Outputs are written with '%.6f'.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--source", type=str, required=True)
    parser.add_argument("--target", type=str, required=True)
    parser.add_argument("--seed", type=int, default=2021)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="reference .pt state_dict or native .npz")
    parser.add_argument("--up_ratio", type=int, default=4)
    parser.add_argument("--num_patch", type=int, default=256,
                        help="points per patch")
    parser.add_argument("--num_out", type=int, default=None,
                        help="output points per cloud (default N*ratio)")
    parser.add_argument("--num_outlier", type=int, default=24)
    parser.add_argument("--model", choices=["discrete", "cnf"],
                        default="discrete")
    parser.add_argument("--exact", action="store_true",
                        help="keep BatchNorm unfolded: the encoder, the "
                             "k-NN and the interpolation head run as plain "
                             "tensor ops, while FPS and the flows (f and g, "
                             "or the CNF solves) still run as CUDA kernels. "
                             "Default: BN folded into the convs, the "
                             "encoder and the head CUDA kernels too")
    parser.add_argument("--batch", type=int, default=1,
                        help="clouds per device batch")
    parser.add_argument("--seeded_merge", action="store_true",
                        help="opt-in fast merge: emit all originals and "
                             "seeded-FPS only the remainder. ~25%% fewer "
                             "selection steps but measured ~2x uniformity "
                             "vs the reference at protocol scale "
                             "(QUALITY.md round-4b) - default is the "
                             "reference-identical union merge. Ignored "
                             "with --exact")
    parser.add_argument("--merge_groups", type=int, default=0,
                        help="grouped merge-FPS parallelism. With "
                             "--seeded_merge: 0 = auto by candidate count, "
                             "1 = exact seeded FPS. Without it, values > 1 "
                             "select the approximate grouped-UNION merge "
                             "(Morton cells; quality-affecting - see "
                             "QUALITY.md round-4b before using)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda)")
    args = parser.parse_args(argv)

    import torch

    from puflow_torch.checkpoint import load_checkpoint
    from puflow_torch.inference.patch import remove_outliers, upsample_cloud
    from puflow_torch.utils.device import resolve_device
    from puflow_torch.utils.io import load_xyz, save_xyz

    device = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    model = load_checkpoint(args.checkpoint, device, fold=not args.exact,
                            model=args.model)

    os.makedirs(args.target, exist_ok=True)
    paths = []
    for root, _dirs, files in os.walk(args.source):
        paths.extend(os.path.join(root, f) for f in files if ".xyz" in f)
    paths.sort()
    if not paths:
        raise SystemExit(f"no .xyz files under {args.source}")

    by_n = defaultdict(list)
    for p in paths:
        pts = load_xyz(p)[:, :3]
        by_n[pts.shape[0]].append((p, pts))

    t_start = time.time()
    n_done = 0
    pending = None   # (chunk, host copy, its event): a one-deep pipeline

    def drain(p):
        # waits for this batch's copy only: the next batch is already
        # queued on the card behind it
        nonlocal n_done
        chunk, host, copied = p
        if copied is not None:
            copied.synchronize()
        for (path, _), out in zip(chunk, host.numpy()):
            save_xyz(Path(args.target) / os.path.basename(path), out)
            n_done += 1

    for n, items in sorted(by_n.items()):
        npoint = (args.num_out or n * args.up_ratio) + args.num_outlier
        seeded = args.seeded_merge and not args.exact and npoint > n
        bsz = max(1, args.batch)
        for start in range(0, len(items), bsz):
            chunk = items[start:start + bsz]
            clouds = np.stack([pts[rng.permutation(n)] for _, pts in chunk])
            pad = bsz - len(chunk)
            if pad:
                clouds = np.concatenate(
                    [clouds, np.repeat(clouds[-1:], pad, axis=0)])
            clouds = torch.from_numpy(clouds).to(device)
            with torch.no_grad():
                pred = upsample_cloud(model, clouds, npoint, args.up_ratio,
                                      args.num_patch, 4.0, None, seeded,
                                      args.merge_groups)
                if args.num_outlier > 0:
                    pred = remove_outliers(pred, clouds, args.num_outlier)
            copied = None
            if pred.device.type == "cuda":
                host = torch.empty(pred.shape, dtype=pred.dtype,
                                   pin_memory=True)
                host.copy_(pred, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
            else:
                host = pred
            prev, pending = pending, (chunk, host, copied)
            if prev is not None:
                drain(prev)
    if pending is not None:
        drain(pending)
    dt = time.time() - t_start
    print(f"upsampled {n_done} clouds in {dt:.1f}s "
          f"({n_done / dt:.2f} clouds/s)")


if __name__ == "__main__":
    main()
