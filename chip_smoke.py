"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Drives `puflow_torch`'s whole-cloud x4 upsampling (2048 -> 8192 points per
cloud, 32 patches of 256 points each, the full-width discrete model with
seeded, perturbed weights) and its three hand-written CUDA kernels:

  1. checks the card, prints its name and power limit, turns TF32 off;
  2. builds the kernels from `puflow_torch/csrc` and prints the build time;
  3. compares each kernel with its plain PyTorch version on the card at
     the main path's shapes, and times both;
  4. runs `upsample_cloud` + `remove_outliers` on 8 clouds, checks the
     output, that every kernel was launched by that run, and that the
     result agrees with the same pipeline on the plain versions;
  5. times the main path per stage with CUDA events at B=8 and B=32, and
     traces one run of each with torch.profiler for the card's idle share
     and its top kernels;
  6. prints one JSON line of kernel results and, last, the device line.

Any failed check raises, and the script exits non-zero. It needs CUDA and
refuses to run without it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from puflow_torch import checkpoint
from puflow_torch.inference.patch import (normalize_cloud, remove_outliers,
                                          upsample_cloud)
from puflow_torch.models import discrete
from puflow_torch.models.encoder import interpolation_apply
from puflow_torch.ops import _build
from puflow_torch.ops import flow as flow_ops
from puflow_torch.ops.chamfer import chamfer_parts
from puflow_torch.ops.fps import (farthest_point_sample,
                                  farthest_point_sample_plain)
from puflow_torch.ops.knn import gather_points, knn_indices

SEED = 2021
N_POINTS = 2048
PATCH = 256
UPRATIO = 4
EXPAND = 4.0
N_OUTLIERS = 24
NPOINT = N_POINTS * UPRATIO + N_OUTLIERS
N_PATCH = int(N_POINTS / PATCH * EXPAND)                   # 32 per cloud
MERGE_N = N_PATCH * PATCH * UPRATIO + N_POINTS             # 34816

KERNELS = {
    "fps": {"route": "cuda", "source": "puflow_torch/csrc/fps.cu",
            "replaces": "puflow_tpu/ops/pallas/fps_pallas.py:254"},
    "flow_f": {"route": "cuda", "source": "puflow_torch/csrc/flow_f.cu",
               "replaces": "puflow_tpu/ops/pallas/flow_pallas.py:394"},
    "flow_g": {"route": "cuda", "source": "puflow_torch/csrc/flow_g.cu",
               "replaces": "puflow_tpu/ops/pallas/flow_pallas.py:458"},
}
WRAPPERS = {"fps": farthest_point_sample, "flow_f": flow_ops.flow_f,
            "flow_g": flow_ops.flow_g}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synthetic_clouds(batch: int, seed: int) -> torch.Tensor:
    """Seeded surfaces: points on ellipsoids with random axes and a
    low-frequency radial bump, made with numpy and moved to the card."""
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, N_POINTS, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    axes = rng.uniform(0.5, 1.5, (batch, 1, 3))
    bump = 1.0 + 0.2 * np.sin(3.0 * v[..., :1]) * np.cos(2.0 * v[..., 1:2])
    return torch.from_numpy((v * axes * bump).astype(np.float32)).cuda()


def seeded_model():
    """Full-width model from a torch.Generator seed, perturbed as in the
    tests so the flows are far from the identity."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    params, state = discrete.init(gen)
    params, state = checkpoint.to_numpy_tree(
        discrete.DiscreteModel(params, state))
    discrete.perturb_init(params, state, SEED)
    return checkpoint.from_numpy_tree(params, state, "cuda")


def sample_staged(model, patches, f_fn, g_fn, mark):
    """`discrete.sample` written out stage by stage, calling ``mark`` after
    each stage; f_fn / g_fn pick the kernels or the plain versions."""
    params, state = model.trees()
    knn_idx = knn_indices(patches, patches, discrete.NUM_NEIGHBORS)
    cs = discrete.feat_extract(params, state, patches, knn_idx)
    mark("encoder")
    z = f_fn(params["flow_blocks"], patches, cs)
    mark("flow_f")
    fz = interpolation_apply(params["interp"], state["interp"], z, patches,
                             UPRATIO, knn_idx=knn_idx).contiguous()
    mark("interpolation")
    x = g_fn(params["flow_blocks"], fz, cs)
    mark("flow_g")
    return x


def pipeline_staged(model, pc, fps_fn=farthest_point_sample,
                    f_fn=flow_ops.flow_f, g_fn=flow_ops.flow_g,
                    mark=lambda stage: None):
    """`upsample_cloud` + `remove_outliers`, written out stage by stage."""
    B = pc.shape[0]
    pc_n, g_centroid, g_furthest = normalize_cloud(pc)
    seed_idx = fps_fn(pc_n, N_PATCH)
    mark("seed_fps")
    seeds = gather_points(pc_n, seed_idx)
    idx = knn_indices(seeds, pc_n, PATCH)
    patches = gather_points(pc_n, idx).reshape(B * N_PATCH, PATCH, 3)
    flat_n, centroids, furthest = normalize_cloud(patches)
    mark("patch_knn")
    pred = sample_staged(model, flat_n, f_fn, g_fn, mark)
    pred = (pred * furthest + centroids).reshape(B, -1, 3)
    cov = torch.zeros((B, N_POINTS), dtype=torch.bool, device=pc.device)
    cov.scatter_(1, idx.reshape(B, -1), True)
    originals = torch.where(cov[..., None], pc_n, pred[:, :1, :])
    union = torch.cat([pred, originals], dim=1).contiguous()
    merged = gather_points(union, fps_fn(union, NPOINT))
    merged = merged * g_furthest + g_centroid
    mark("merge_fps")
    out = remove_outliers(merged, pc, N_OUTLIERS)
    mark("outliers")
    return out, flat_n


def check_fps(name, xyz, m, results):
    got = farthest_point_sample(xyz, m)
    ref = farthest_point_sample_plain(xyz, m)
    torch.cuda.synchronize()
    bad = (got != ref).any(dim=0).nonzero()
    if bad.numel():
        step = int(bad[0])
        raise AssertionError(
            f"FPS {name}: indices differ first at step {step}: kernel "
            f"{got[:, step].tolist()} plain {ref[:, step].tolist()}")
    log(f"fps {name} {tuple(xyz.shape)} -> {m}: indices equal")
    results["fps"]["max_abs_err"] = max(
        results["fps"].get("max_abs_err", 0.0),
        float((got - ref).abs().max()))


def phase_compare(model, results):
    """Each kernel against its plain version at the main path's shapes."""
    rng = np.random.RandomState(SEED)
    for B, N, m, label in ((8, N_POINTS, N_PATCH, "seed pick"),
                           (8, MERGE_N, NPOINT, "merge")):
        grid = rng.randint(0, 11, (B, N, 3)).astype(np.float32)
        check_fps(f"{label} integer grid", torch.from_numpy(grid).cuda(), m,
                  results)
        cloud = rng.rand(B, N, 3).astype(np.float32)
        check_fps(f"{label} float", torch.from_numpy(cloud).cuda(), m,
                  results)
    seed_cloud = torch.from_numpy(
        rng.rand(8, N_POINTS, 3).astype(np.float32)).cuda()
    merge_cloud = torch.from_numpy(
        rng.rand(8, MERGE_N, 3).astype(np.float32)).cuda()
    seed_ms = time_ms(lambda: farthest_point_sample(seed_cloud, N_PATCH), 20)
    seed_plain = time_ms(
        lambda: farthest_point_sample_plain(seed_cloud, N_PATCH), 5)
    merge_ms = time_ms(lambda: farthest_point_sample(merge_cloud, NPOINT), 3)
    merge_plain = time_ms(
        lambda: farthest_point_sample_plain(merge_cloud, NPOINT), 1)
    log(f"fps seed pick [8, {N_POINTS}] -> {N_PATCH}: kernel {seed_ms:.4f} "
        f"ms, plain {seed_plain:.4f} ms")
    log(f"fps merge [8, {MERGE_N}] -> {NPOINT}: kernel {merge_ms:.4f} ms, "
        f"plain {merge_plain:.4f} ms")
    results["fps"].update(ms=merge_ms, plain_ms=merge_plain)

    # flows on 256 patches of 256 points with the port's own conditions
    params, state = model.trees()
    blocks = params["flow_blocks"]
    pc_n, _, _ = normalize_cloud(synthetic_clouds(8, SEED + 1))
    seeds = gather_points(pc_n, farthest_point_sample_plain(pc_n, N_PATCH))
    patches = gather_points(pc_n, knn_indices(seeds, pc_n, PATCH))
    x, _, _ = normalize_cloud(patches.reshape(8 * N_PATCH, PATCH, 3))
    knn_idx = knn_indices(x, x, discrete.NUM_NEIGHBORS)
    cs = discrete.feat_extract(params, state, x, knn_idx)
    z_ref = flow_ops.flow_f_plain(blocks, x, cs)
    fz = interpolation_apply(params["interp"], state["interp"], z_ref, x,
                             UPRATIO, knn_idx=knn_idx).contiguous()
    g_ref = flow_ops.flow_g_plain(blocks, fz, cs)
    for name, got, ref in (("flow_f", flow_ops.flow_f(blocks, x, cs), z_ref),
                           ("flow_g", flow_ops.flow_g(blocks, fz, cs),
                            g_ref)):
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        # exact f32 on both sides; summation order differs
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        log(f"{name} {tuple(got.shape)}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
        results[name]["max_abs_err"] = err
    timings = {
        "flow_f": (lambda: flow_ops.flow_f(blocks, x, cs),
                   lambda: flow_ops.flow_f_plain(blocks, x, cs)),
        "flow_g": (lambda: flow_ops.flow_g(blocks, fz, cs),
                   lambda: flow_ops.flow_g_plain(blocks, fz, cs)),
    }
    for name, (kernel, plain) in timings.items():
        # plain, kernel, kernel, plain: compare within one call
        p1 = time_ms(plain, 10)
        k1 = time_ms(kernel, 10)
        k2 = time_ms(kernel, 10)
        p2 = time_ms(plain, 10)
        results[name].update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
        log(f"{name} [256 patches x {PATCH}]: kernel {k1:.4f} / {k2:.4f} ms,"
            f" plain {p1:.4f} / {p2:.4f} ms")


def chamfer(a, b) -> float:
    d_ab, _, d_ba, _ = chamfer_parts(a, b)
    return float((d_ab.mean(dim=1) + d_ba.mean(dim=1)).max())


def phase_main_path(model, results):
    pc = synthetic_clouds(8, SEED)
    for fn in WRAPPERS.values():
        fn.launches = 0
    with torch.no_grad():
        out = upsample_cloud(model, pc, NPOINT, UPRATIO, PATCH, EXPAND)
        out = remove_outliers(out, pc, N_OUTLIERS)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    log(f"main path: output {tuple(out.shape)}, launches {launches}")
    for name, n in launches.items():
        results[name]["launches"] = n
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "main path")
    if tuple(out.shape) != (8, N_POINTS * UPRATIO, 3):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("output has non-finite values")

    with torch.no_grad():
        staged, patches = pipeline_staged(model, pc)
        plain, _ = pipeline_staged(model, pc, farthest_point_sample_plain,
                                   flow_ops.flow_f_plain,
                                   flow_ops.flow_g_plain)
        one = patches[:N_PATCH].contiguous()
        got = model(one, UPRATIO)
        params, state = model.trees()
        knn_idx = knn_indices(one, one, discrete.NUM_NEIGHBORS)
        cs = discrete.feat_extract(params, state, one, knn_idx)
        z = flow_ops.flow_f_plain(params["flow_blocks"], one, cs)
        fz = interpolation_apply(params["interp"], state["interp"], z, one,
                                 UPRATIO, knn_idx=knn_idx)
        ref = flow_ops.flow_g_plain(params["flow_blocks"], fz, cs)
    torch.cuda.synchronize()
    # the staged copy runs the same ops as upsample_cloud
    d_staged = float((staged - out).abs().max())
    log(f"staged pipeline vs upsample_cloud: max_abs_diff {d_staged:.3e}")
    if not d_staged <= 1e-5:
        raise AssertionError("the staged pipeline is not the main path")
    err = float((got - ref).abs().max())
    log(f"discrete.sample on {N_PATCH} patches vs plain composition: "
        f"max_abs_err {err:.3e} (atol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"sample: max_abs_err {err} > 1e-4")
    # the plain pipeline can differ only by FPS near-tie flips that the
    # 1e-6-level model differences cause
    cd = chamfer(out, plain)
    log(f"pipeline on kernels vs on plain versions: chamfer {cd:.3e} "
        "(gate 1e-4)")
    if not cd < 1e-4:
        raise AssertionError(f"pipeline chamfer {cd} >= 1e-4")


def traced_run(model, pc):
    """One pipeline run under torch.profiler: prints the card's idle share
    (1 - union of device activity / host wall time) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline_staged(model, pc)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if start >= end:
            busy_us += stop - start
        elif stop > end:
            busy_us += stop - end
        end = max(end, stop)
    log(f"B={pc.shape[0]} traced run: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms, idle share "
        f"{1.0 - busy_us / wall_us:.4f}")
    log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=12, max_name_column_width=60))


def phase_timing(model, card):
    for B in (8, 32):
        pc = synthetic_clouds(B, SEED + B)
        stages: dict[str, list[float]] = {}
        totals = []
        with torch.no_grad():
            pipeline_staged(model, pc)                      # warm-up
            torch.cuda.synchronize()
            for _ in range(3):
                events = [("start", torch.cuda.Event(enable_timing=True))]
                events[0][1].record()

                def mark(stage):
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    events.append((stage, ev))

                t0 = time.perf_counter()
                pipeline_staged(model, pc, mark=mark)
                torch.cuda.synchronize()
                totals.append(time.perf_counter() - t0)
                for (_, a), (stage, b) in zip(events, events[1:]):
                    stages.setdefault(stage, []).append(a.elapsed_time(b))
        total = statistics.median(totals)
        split = ", ".join(f"{k} {statistics.median(v):.3f}"
                          for k, v in stages.items())
        log(f"B={B} per-stage ms (median of 3): {split}")
        log(f"B={B} end to end {total * 1e3:.2f} ms: {B / total:.2f} "
            f"clouds/s, {B * N_PATCH / total:.1f} patches/s on {card}")
        with torch.no_grad():
            traced_run(model, pc)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib, compile_s = _build.build()
    _build.library()
    log(f"kernel build: {compile_s:.2f} s nvcc, {time.perf_counter() - t0:.2f}"
        f" s with load ({lib.name})")

    results = {name: dict(name=name, **meta) for name, meta in KERNELS.items()}
    model = seeded_model()
    with torch.no_grad():
        phase_compare(model, results)
    phase_main_path(model, results)
    phase_timing(model, card)

    log(json.dumps({"kernels": [results[name] for name in KERNELS]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
