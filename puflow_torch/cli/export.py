"""Export a checkpoint as a serving artifact (a `torch.export` ``.pt2``).

The port's counterpart of `puflow_tpu.cli.export`, with the same flags and
``--device`` in place of ``--platforms``. The checkpoint (BN folded, as
the upsample CLI serves it) becomes one file that a server loads with
`puflow_torch.serving.load_exported`; on the card its graph launches the
port's hand-written kernels (`torch.ops.puflow.*`).

  # per-patch sampler, any batch size at run time:
  python -m puflow_torch.cli.export --checkpoint puflow-x4-pu1k.pt \
      --out sampler.pt2

  # whole-cloud pipeline at fixed shapes:
  python -m puflow_torch.cli.export --checkpoint puflow-x4-pu1k.pt \
      --kind cloud --cloud_points 2048 --batch 8 --out cloud.pt2
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help=".pt / .ckpt / .npz checkpoint")
    p.add_argument("--model", default="discrete",
                   choices=["discrete", "continuous", "cnf"])
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--kind", default="patch", choices=["patch", "cloud"],
                   help="patch: [B, patch_size, 3] sampler; cloud: the "
                        "full fixed-shape pipeline")
    p.add_argument("--up_ratio", type=int, default=4)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--batch", type=int, default=0,
                   help="batch dim; 0 = symbolic (patch kind only)")
    p.add_argument("--cloud_points", type=int, default=2048)
    p.add_argument("--npoint", type=int, default=0,
                   help="cloud output points; 0 = cloud_points*ratio + 24")
    p.add_argument("--expand_ratio", type=float, default=4.0)
    p.add_argument("--device", default="cuda",
                   help="device the artifact runs on (cuda or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.kind == "cloud" and not args.batch:
        raise SystemExit("--kind cloud requires a concrete --batch")

    from puflow_torch import serving
    from puflow_torch.checkpoint import load_checkpoint

    params, state = load_checkpoint(args.checkpoint, args.device, fold=True,
                                    model=args.model).trees()
    if args.kind == "patch":
        ep = serving.export_patch_sampler(
            params, state, model=args.model, upratio=args.up_ratio,
            patch_size=args.patch_size, batch=args.batch or None,
            device=args.device)
    else:
        ep = serving.export_cloud_upsampler(
            params, state, model=args.model,
            cloud_points=args.cloud_points, npoint=args.npoint or None,
            upratio=args.up_ratio, patch_size=args.patch_size,
            expand_ratio=args.expand_ratio, batch=args.batch,
            device=args.device)
    serving.save_exported(ep, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB, "
          f"device={args.device})")


if __name__ == "__main__":
    main()
