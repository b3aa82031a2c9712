"""Evaluate predicted clouds against ground truth -> evaluation.csv.

The port's counterpart of `puflow_tpu.cli.evaluate`, with the same flags
and `evaluation.csv` schema (reference `evaluation/evaluate.py`) plus
``--device``:

    python -m puflow_torch.cli.evaluate --pred <dir> --gt <dir> \
        --save_path <dir> [--device cuda]

Per (gt, pred) pair (matched by file stem):
  * a pred cloud with fewer points than its GT is padded to the GT's
    count with points of its own drawn at random (unseeded, as the
    reference's `load_xyz` does, `evaluate.py:31-46`)
  * both clouds normalised to the unit sphere independently
  * CD  = mean(fwd NN sqdist) + mean(bwd NN sqdist)
  * HD  = max(fwd) + max(bwd)
  * EMD = approxmatch transport cost / n (annealed softassign)
  * JSD = occupancy-grid Jensen-Shannon on 0.5-scaled clouds
  * P2F = stats of column 3 of `<pred>_point2mesh_distance.xyz` if present
    (written by the native P2F tool, `puflow_torch.eval.p2f`)
  * uniformity columns if the disk side-files exist

CD, HD and EMD run on ``--device`` (default ``cuda``; a host without a
card raises, there is no fallback to the CPU); JSD, P2F and uniformity
are numpy on the host. Writes per-file rows plus a trailing nanmean
aggregate row, exactly the reference schema (`evaluate.py:174,214-289`).
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from collections import OrderedDict
from glob import glob


def load(path):
    import numpy as np

    return np.loadtxt(path).astype(np.float32)


def load_xyz_count(path, count=None):
    """Reference `load_xyz` (`evaluate.py:31-46`): pad/downsample to count."""
    import numpy as np

    points = load(path)
    if count is not None:
        if count > points.shape[0]:
            tmp = np.zeros((count, points.shape[1]), dtype=points.dtype)
            tmp[: points.shape[0]] = points
            tmp[points.shape[0]:] = points[np.random.choice(
                points.shape[0], count - points.shape[0])]
            points = tmp
    return points


def np_normalize(pts):
    import numpy as np

    centroid = np.mean(pts, axis=1, keepdims=True)
    pts = pts - centroid
    furthest = np.amax(np.sqrt(np.sum(pts**2, axis=-1)), axis=1,
                       keepdims=True)
    return pts / np.expand_dims(furthest, axis=-1) * 0.5


def cd_emd(pred, gt):
    """Directed chamfer distances ``[n]``, ``[m]`` and the EMD of one
    pair ``[1, n, 3]``, ``[1, m, 3]``, each cloud normalised alone."""
    from puflow_torch.inference.patch import normalize_cloud
    from puflow_torch.ops.approx_match import earth_mover
    from puflow_torch.ops.chamfer import chamfer_parts

    pred_n, _, _ = normalize_cloud(pred)
    gt_n, _, _ = normalize_cloud(gt)
    d_fwd, _, d_bwd, _ = chamfer_parts(pred_n, gt_n)
    emd = earth_mover(pred_n, gt_n)
    return d_fwd[0], d_bwd[0], emd


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pred", type=str, required=True)
    parser.add_argument("--gt", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of CD, HD and EMD (default cuda)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from puflow_torch.eval.jsd import jsd_between_point_cloud_sets
    from puflow_torch.eval.uniformity import PERCENTAGES, analyze_uniform
    from puflow_torch.utils.device import resolve_device

    device = resolve_device(args.device)

    gt_paths = sorted(glob(os.path.join(os.path.abspath(args.gt), "*.xyz")))
    gt_names = [os.path.basename(p)[:-4] for p in gt_paths]
    pred_paths = sorted(glob(os.path.join(os.path.abspath(args.pred),
                                          "*.xyz")))
    pairs = []
    for p in pred_paths:
        name = os.path.splitext(os.path.basename(p))[0]
        if name in gt_names:
            pairs.append((gt_paths[gt_names.index(name)], p))
    if not pairs:
        raise SystemExit("no matching (gt, pred) pairs found")

    fieldnames = ["name", "CD", "EMD", "hausdorff", "p2f avg", "p2f std",
                  "JSD"]
    fieldnames += [f"uniform_{d}" for d in range(len(PERCENTAGES))]

    g_cd, g_emd, g_hd, g_jsd, g_p2f, g_uniform = [], [], [], [], [], []
    # host-clock seconds a file of CD/HD/EMD (on the device), JSD, and
    # P2F with uniformity
    t_start, spans = time.perf_counter(), ([], [], [])
    os.makedirs(args.save_path, exist_ok=True)
    with open(os.path.join(args.save_path, "evaluation.csv"), "w") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames, restval="-",
                                extrasaction="ignore")
        writer.writeheader()
        for gt_path, pred_path in pairs:
            row = {"name": os.path.basename(pred_path)}
            gt = load(gt_path)[:, :3][None]
            pred = load_xyz_count(pred_path, count=gt.shape[1])[:, :3][None]

            t0 = time.perf_counter()
            with torch.no_grad():
                d_fwd, d_bwd, emd = cd_emd(
                    torch.from_numpy(pred).to(device),
                    torch.from_numpy(gt).to(device))
                d_fwd, d_bwd = d_fwd.cpu().numpy(), d_bwd.cpu().numpy()
                emd = float(emd)
            t1 = time.perf_counter()
            cd = float(d_fwd.mean() + d_bwd.mean())
            hd = float(d_fwd.max() + d_bwd.max())
            jsd = jsd_between_point_cloud_sets(np_normalize(pred),
                                               np_normalize(gt))
            t2 = time.perf_counter()
            row.update(CD=cd, EMD=emd, hausdorff=hd)
            g_cd.append(cd)
            g_hd.append(hd)
            g_emd.append(emd)
            g_jsd.append(jsd)

            p2f_file = pred_path[:-4] + "_point2mesh_distance.xyz"
            if os.path.isfile(p2f_file):
                p2f = load(p2f_file)
                if p2f.size > 0:
                    p2f = p2f[:, 3]
                    row["p2f avg"] = np.nanmean(p2f)
                    row["p2f std"] = np.nanstd(p2f)
                    row["JSD"] = jsd
                    g_p2f.append(p2f)
                    idx_file = pred_path[:-4] + "_disk_idx.txt"
                    if os.path.isfile(idx_file):
                        measure = analyze_uniform(
                            idx_file, pred_path[:-4] + "_radius.txt",
                            pred_path[:-4] + "_point2mesh_distance.txt")
                        g_uniform.append(measure)
                        for i in range(len(PERCENTAGES)):
                            row[f"uniform_{i}"] = measure[i, 0]
            for span, (a, b) in zip(spans, ((t0, t1), (t1, t2),
                                            (t2, time.perf_counter()))):
                span.append(b - a)
            writer.writerow(row)
            f.flush()   # protocol runs take seconds a file at PU-GAN
            # sizes; keep per-file rows visible for progress monitoring

        row = OrderedDict()
        row["CD"] = np.nanmean(g_cd)
        row["EMD"] = np.nanmean(g_emd)
        row["hausdorff"] = np.nanmean(g_hd)
        if g_p2f:
            allp = np.concatenate(g_p2f, axis=0)
            row["p2f avg"] = np.nanmean(allp)
            row["p2f std"] = np.nanstd(allp)
        row["JSD"] = np.nanmean(g_jsd)
        if g_uniform:
            um = np.mean(np.asarray(g_uniform), axis=0)
            for i in range(len(PERCENTAGES)):
                row[f"uniform_{i}"] = um[i, 0]
        writer.writerow(row)

    total = time.perf_counter() - t_start
    print(f"evaluated {len(pairs)} files in {total:.3f} s: "
          f"{total / len(pairs) * 1e3:.1f} ms a file")
    for label, span in zip((f"CD/HD/EMD on {device}", "JSD",
                            "P2F and uniformity"), spans):
        print(f"  ms of each file, {label}: "
              + " ".join(f"{t * 1e3:.1f}" for t in span))
    metrics = []
    print(f"Evaluation: {args.save_path}")
    for key in ["CD", "EMD", "hausdorff", "p2f avg", "p2f std", "JSD"]:
        if key in row:
            metrics.append(f"[{key}]{row[key]:>.8f}")
    print("\t" + "  ".join(metrics))
    return row


if __name__ == "__main__":
    main()
