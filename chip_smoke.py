"""Smoke run of the PyTorch port's main paths on one CUDA card.

    python3 chip_smoke.py

Drives `puflow_torch`'s whole-cloud x4 upsampling (2048 -> 8192 points per
cloud, 32 patches of 256 points each, the full-width discrete model with
seeded, perturbed weights) in both of the upsample CLI's configurations:
the default, with BatchNorm folded into the convs, where every model stage
is a hand-written CUDA kernel (k-NN, encoder, interpolation head, flow f,
blend plus flow g), and `--exact`, with BN unfolded, where FPS, flow f and
flow g are kernels. Then it trains the same model at the reference PU1K
configuration (batch 32, 256 -> 1024 points, loss 1e-4 NLL + 5e-2 EMD with
the 50-iteration auction, Adam with clip 1e-2), whose auction EMD is a
hand-written CUDA kernel, and runs the train CLI and serves the model it
saved. Last it serves the CNF family (`--model cnf`: six continuous flow
blocks, dopri5 at tolerance 1e-5), full width, in the same two
configurations: every block-solve is one launch of the hand-written
whole-solve kernel, twelve a `continuous.sample`, and with BN folded the
encoder and the interpolation head (mode `latents`) are kernels too.
Last it runs the opt-in merges of the folded discrete model: the
seeded merge (`--seeded_merge`: every original emitted, the rest picked by
the hand-written seeded-FPS kernel over 16 Morton cells a cloud) and the
grouped union merge (`--merge_groups 16`: the FPS kernel over 16 Morton
cells of the union). Last it takes one training loss's gradients through
the full-width CNF model (`continuous.forward(train=True)` at batch 32,
256 -> 1024 points, loss 1e-4 NLL + 5e-2 EMD): the six forward solves of f
run the hand-written log-density solve kernel, the six of g the
whole-solve kernel, and the twelve backward solves of the continuous
adjoint the hand-written adjoint kernel, with and without the trace.
Phases:

  1. checks the card, prints its name and power limit, checks that
     `import puflow_torch` turned TF32 off;
  2. builds the kernels from `puflow_torch/csrc` and prints the build time;
  3. compares each kernel with its plain PyTorch version on the card at
     the main path's shapes (256 patches of 256 points, r=4), times both,
     and works out each kernel's bound from the work these inputs need
     (the encoder's, the interpolation head's and flow g's products at the
     TF32 peak as three TF32 products an f32 one, their FP32 bounds
     printed beside; two runs of each of these kernels bit-equal, the head
     in each of its three modes at K = 8, 5 and 16);
     the merge FPS at 1, 8 and 32 clouds under every plan of `SWEEP`
     (one block a cloud, clusters of C blocks), ties between blocks
     included, with each plan's time a step and the chosen plan timed in
     turns with one block a cloud;
  4. runs `upsample_cloud` + `remove_outliers` on 8 clouds in each
     configuration, with every launch count set to 0 just before and read
     just after; checks the output, that each kernel of the path was
     launched, that the result agrees with the same pipeline on the plain
     versions, and that the merge's FPS kernel picks the same points as
     its plain version on the path's own predictions;
  5. times each path per stage with CUDA events at B=8 and B=32, and
     traces one run of each with torch.profiler for the card's idle share
     and its top kernels;
  6. compares the EMD kernel with its plain version at the training shape
     ([32, 1024] vs [32, 1024]): equal assignments, two runs bit-equal, a
     NaN-input run, the cluster size `_emd_plan` chose, the unassigned
     rows per iteration, times at 1, 8 and 32 clouds beside the plain
     version's, and the bound from the work the plain version counts;
  7. trains: the first step's gradients with the kernel EMD against the
     plain EMD, then 10 warm-up steps and 5 timed windows of 10 steps with
     every launch count set to 0 before and read after (steps/s, a split
     per step, peak memory), and one traced step;
  8. runs `python -m puflow_torch.cli.train_pu1k --synthetic 2` on the
     card, loads the checkpoint it saved (BN folded) and upsamples one
     2048-point cloud with it; then holds the streaming self k-NN kernel
     (patches over the shared-memory kernel's `KNN_MAX_N`) to its plain
     version, runs the folded path on one patch of `KNN_MAX_N` + 1 points
     with the launch counts set to 0 before and read after, against the
     plain composition, and serves a 12,000-point cloud in such patches
     with `cli/upsample.py --num_patch`;
  9. compares the CNF whole-solve kernel with its plain version (both
     directions, condition widths 32 and 128, R = 8,192, R = 32,768 with
     the conditions of 8,192 points, and an R that leaves a partial tile):
     error, equal step counts, two runs bit-equal, times and the bound
     from the field evaluations the solve made;
 10. runs the CNF main path on 8 clouds in each configuration with the
     launch counts set to 0 before and read after (12 solves a sample, no
     solve at the step limit), against the same pipeline on plain versions;
 11. times `continuous.sample` at 32 patches and the whole CNF pipeline at
     1 and 8 clouds per stage, with the steps of every block-solve, and
     traces one run of each;
 12. saves a seeded CNF checkpoint and runs `python -m
     puflow_torch.cli.upsample --model cnf` on it;
 13. compares the seeded-FPS kernel with its plain version (equal indices,
     two runs bit-equal) at the seeded merge's shapes and more, and times
     its seeding and selection apart;
 14. runs the seeded-merge and grouped-union paths at 1 and 32 clouds,
     and the seeded merge once on the CNF folded model, each as phase 4
     runs a path;
 15. times the merge stage and the whole pipeline at 1 and 32 clouds for
     the union merge, the seeded merge (auto G and G = 1) and the grouped
     union merge (G = 16), and runs the upsample CLI with the merge flags;
 16. compares the log-density solve kernel and the adjoint kernel (with and
     without the trace) with their plain versions at the training path's
     shapes (R = 8,192 for f, R = 32,768 with the conditions of 8,192
     points for g; condition widths 32 and 128; seeded and perturbed
     weights): equal step counts, two runs bit-equal, the JAX package's
     gates, times and bounds;
 17. runs the CNF gradient path (`cnf_grad`) at seeded weights with the
     launch counts set to 0 before and read after (6 log-density solves,
     6 plain solves, 12 adjoint solves, 1 EMD a loss; no solve at the step
     limit; finite gradients), holds the gradients of a smooth loss on the
     kernels to those on the plain versions, times the loss's forward and
     backward on both, and traces one run for the card's idle share;
 18. prints one JSON line of kernel results and, last, the device line.

Any failed check raises, and the script exits non-zero. It needs CUDA and
refuses to run without it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_map

from puflow_torch import checkpoint
from puflow_torch.data.synthetic import synthetic_pairs
from puflow_torch.inference.patch import (auto_merge_groups, normalize_cloud,
                                          remove_outliers, upsample_cloud)
from puflow_torch.models import continuous, discrete
from puflow_torch.models.encoder import INTERP_K, interpolation_apply
from puflow_torch.models.fold_bn import empty_bn_state, fold_bn_inference
from puflow_torch.ops import _build
from puflow_torch.ops import cnf as cnf_ops
from puflow_torch.ops import emd as emd_ops
from puflow_torch.ops import encoder as enc_ops
from puflow_torch.ops import flow as flow_ops
from puflow_torch.ops import fps as fps_ops
from puflow_torch.ops import interp as interp_ops
from puflow_torch.ops.chamfer import chamfer_parts
from puflow_torch.ops.emd import emd_auction, emd_auction_plain
from puflow_torch.ops.fps import (farthest_point_sample,
                                  farthest_point_sample_morton,
                                  farthest_point_sample_plain,
                                  farthest_point_sample_seeded,
                                  farthest_point_sample_seeded_morton,
                                  farthest_point_sample_seeded_plain)
from puflow_torch.ops.knn import (KNN_MAX_N, gather_points, knn_indices,
                                  knn_self, knn_self_plain, knn_self_stream)
from puflow_torch.train.trainer import TrainConfig, Trainer, TreeLayout

SEED = 2021
N_POINTS = 2048
PATCH = 256
UPRATIO = 4
EXPAND = 4.0
N_OUTLIERS = 24
NPOINT = N_POINTS * UPRATIO + N_OUTLIERS
N_PATCH = int(N_POINTS / PATCH * EXPAND)                   # 32 per cloud
MERGE_N = N_PATCH * PATCH * UPRATIO + N_POINTS             # 34816
K = discrete.NUM_NEIGHBORS
MERGE_BATCHES = (1, 8, 32)
# the merge FPS's plans timed side by side: one block a cloud, and
# clusters of 2-16 blocks of 128 or 256 threads that hold the cloud
SWEEP = [fps_ops.ONE_BLOCK] + [fps_ops.FpsPlan(c, t)
                               for c in (2, 3, 4, 6, 8, 12, 16)
                               for t in (128, 256)]
TRAIN_B, TRAIN_N = 32, 256          # bench.py:bench_train, 256 -> 1024 points
TRAIN_WARMUP, TRAIN_WINDOWS, TRAIN_STEPS = 10, 5, 10
ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, FP32 flop/s outside
# the tensor cores, dense TF32 flop/s on them. A kernel's bound is the
# larger of its bytes (inputs read once, outputs written once) over the
# first and its flops over the peak of the arithmetic it uses.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12

PALLAS = "puflow_tpu/ops/pallas/"
KERNELS = {
    "fps": {"route": "cuda", "source": "puflow_torch/csrc/fps.cu",
            "replaces": PALLAS + "fps_pallas.py:254"},
    "knn_self": {"route": "cuda", "source": "puflow_torch/csrc/knn.cu",
                 "replaces": PALLAS + "knn_pallas.py:81"},
    "knn_self_stream": {"route": "cuda",
                        "source": "puflow_torch/csrc/knn.cu",
                        "replaces": PALLAS + "knn_pallas.py:81"},
    "encoder": {"route": "cuda", "source": "puflow_torch/csrc/encoder.cu",
                "replaces": PALLAS + "encoder_pallas.py:411"},
    "interp_head": {"route": "cuda", "source": "puflow_torch/csrc/interp.cu",
                    "replaces": PALLAS + "encoder_pallas.py:893"},
    "flow_f": {"route": "cuda", "source": "puflow_torch/csrc/flow_f.cu",
               "replaces": PALLAS + "flow_pallas.py:394"},
    "flow_g": {"route": "cuda", "source": "puflow_torch/csrc/flow_g.cu",
               "replaces": PALLAS + "flow_pallas.py:458"},
    "flow_g_blend": {"route": "cuda", "source": "puflow_torch/csrc/flow_g.cu",
                     "replaces": PALLAS + "flow_pallas.py:515"},
    "emd": {"route": "cuda", "source": "puflow_torch/csrc/emd.cu",
            "replaces": PALLAS + "emd_pallas.py:149"},
    "cnf_solve": {"route": "cuda", "source": "puflow_torch/csrc/cnf_solve.cu",
                  "replaces": PALLAS + "cnf_pallas.py:372"},
    "fps_seeded": {"route": "cuda", "source": "puflow_torch/csrc/fps.cu",
                   "replaces": PALLAS + "fps_pallas.py:165"},
    "cnf_solve_logp": {"route": "cuda",
                       "source": "puflow_torch/csrc/cnf_solve.cu",
                       "replaces": PALLAS + "cnf_pallas.py:281"},
    "cnf_adjoint_bwd": {"route": "cuda",
                        "source": "puflow_torch/csrc/cnf_adjoint.cu",
                        "replaces": PALLAS + "cnf_adjoint_pallas.py:378"},
}
WRAPPERS = {"fps": farthest_point_sample, "knn_self": knn_self,
            "knn_self_stream": knn_self_stream,
            "encoder": enc_ops.encoder_conditions,
            "interp_head": interp_ops.interp_head, "flow_f": flow_ops.flow_f,
            "flow_g": flow_ops.flow_g, "flow_g_blend": flow_ops.flow_g_blend,
            "emd": emd_auction, "cnf_solve": cnf_ops.cnf_solve,
            "fps_seeded": farthest_point_sample_seeded,
            "cnf_solve_logp": cnf_ops.cnf_solve_logp,
            "cnf_adjoint_bwd": cnf_ops.cnf_adjoint_bwd}
# the kernels each configuration's main path must launch
PATHS = {"folded": ("fps", "knn_self", "encoder", "interp_head", "flow_f",
                    "flow_g_blend"),
         "exact": ("fps", "flow_f", "flow_g"),
         "train": ("emd",),
         "cnf_folded": ("fps", "encoder", "interp_head", "cnf_solve"),
         "cnf_exact": ("fps", "cnf_solve"),
         "seeded_merge": ("fps", "knn_self", "encoder", "interp_head",
                          "flow_f", "flow_g_blend", "fps_seeded"),
         "union_groups": ("fps", "knn_self", "encoder", "interp_head",
                          "flow_f", "flow_g_blend"),
         "cnf_grad": ("cnf_solve_logp", "cnf_solve", "cnf_adjoint_bwd",
                      "emd"),
         # the folded path on patches over the k-NN's shared memory
         "large_patch": ("knn_self_stream", "encoder", "interp_head",
                         "flow_f", "flow_g_blend")}
# the seeded merge once more, behind the CNF folded model
PATHS["cnf_seeded_merge"] = PATHS["cnf_folded"] + ("fps_seeded",)
# the merge each path runs (`upsample_cloud` keywords; none: the union)
MERGES = {"seeded_merge": dict(seeded_merge=True, merge_groups=0),
          "union_groups": dict(merge_groups=16)}
MERGES["cnf_seeded_merge"] = MERGES["seeded_merge"]
# the path whose run gives each kernel's count in the kernel line
COUNT_FROM = {"fps": "folded", "knn_self": "folded", "encoder": "folded",
              "interp_head": "folded", "flow_f": "folded",
              "flow_g_blend": "folded", "flow_g": "exact", "emd": "train",
              "cnf_solve": "cnf_folded", "fps_seeded": "seeded_merge",
              "cnf_solve_logp": "cnf_grad", "cnf_adjoint_bwd": "cnf_grad",
              "knn_self_stream": "large_patch"}
KERNEL_OPS = dict(WRAPPERS, knn=knn_indices, cnf_solve_t=cnf_ops.cnf_solve_t)
PLAIN_OPS = {"fps": farthest_point_sample_plain, "knn_self": knn_self_plain,
             "knn": knn_indices,
             "encoder": enc_ops.encoder_conditions_plain,
             "interp_head": interp_ops.interp_head_plain,
             "flow_f": flow_ops.flow_f_plain, "flow_g": flow_ops.flow_g_plain,
             "flow_g_blend": flow_ops.flow_g_blend_plain,
             "cnf_solve_t": cnf_ops.cnf_solve_plain,
             "fps_seeded": farthest_point_sample_seeded_plain}
CNF_SOLVES = 2 * continuous.NUM_BLOCKS      # block-solves a `sample`
FIELD_MACS = 3 * 64 + 64 * 64 + 64 * 3      # multiply-adds, row x evaluation
TC_MACS = 64 * 64                           # of those, the 64 x 64 product
# the three tangent chains of the exact trace: v2 = u1 W2 for each, and
# the diagonal of v3
TANGENT_MACS = 3 * 64 * 64 + 3 * 64
# the vjp of the field: dh W^T of the three layers and the gradients of
# the three weight matrices; with the trace also the tangents' cv2 W2^T and
# the weight gradients of the three tangents through W2 and W3
VJP_MACS = 2 * FIELD_MACS
VJP_TRACE_MACS = 3 * 64 * 64 + 3 * 64 * 64 + 64
# of those, the 64 x 64 layer's products, which the adjoint kernel takes on
# the tensor cores: x1 W2, dh2 W2^T and W2's gradient; with the trace u1_k
# W2, cv2_k W2^T and the tangents' part of W2's gradient
ADJ_TC_MACS = 3 * 64 * 64
ADJ_TC_TRACE_MACS = 9 * 64 * 64
# the training loss's launches of each kernel (6 blocks: f forward solves,
# g forward solves, their 12 backward solves, the EMD)
GRAD_LAUNCHES = {"cnf_solve_logp": continuous.NUM_BLOCKS,
                 "cnf_solve": continuous.NUM_BLOCKS,
                 "cnf_adjoint_bwd": 2 * continuous.NUM_BLOCKS, "emd": 1}


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return nbytes(tree)


def set_bound(entry, n_bytes: float, flops: float, peak: float = PEAK_F32):
    """The least time the card could take: bytes over HBM bandwidth or
    flops over ``peak`` (the FP32 peak unless the kernel computes on the
    tensor cores), whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    entry.update(bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")


def set_bound_3xtf32(entry, n_bytes: float, flops: float,
                     fma_flops: float = 0.0):
    """The bound of a kernel that computes the exact f32 function as 3xTF32
    products: three TF32 products for each f32 product of ``flops``, at
    the tensor cores' dense TF32 peak, plus ``fma_flops`` at the FP32 peak
    (work outside the products); the FP32 bound of all of it is printed
    beside it."""
    fp32 = {}
    set_bound(fp32, n_bytes, flops + fma_flops)
    set_bound(entry, n_bytes,
              (3 * flops / PEAK_TF32 + fma_flops / PEAK_F32) * PEAK_TF32,
              PEAK_TF32)
    log(f"{entry['name']} bound: 3xTF32 {entry['bound_ms']:.4f} ms (3 x "
        f"{flops / 1e9:.1f} GFLOP at {PEAK_TF32 / 1e12:.0f} TFLOP/s, "
        f"{fma_flops / 1e9:.3f} GFLOP at {PEAK_F32 / 1e12:.0f}), FP32 "
        f"{fp32['bound_ms']:.4f} ms")


def check_rerun(name, first, again):
    """Raise unless two runs of a kernel gave the same bits."""
    torch.cuda.synchronize()
    pairs = zip(first, again) if isinstance(first, list) else [(first, again)]
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{name}: two runs differ")
    log(f"{name}: two runs bit-equal")


def encoder_macs(params, rows: int, k: int) -> int:
    """Multiply-adds of the six EdgeConv blocks and their merge MLPs on
    ``rows`` points with ``k`` neighbours each (projections once per
    point, the layers once per edge row)."""
    macs = 0
    for fp, mp in zip(params["feat_convs"], params["merge_convs"]):
        layers = [c["lin"]["w"] for c in fp["convs"]] + [fp["conv_out"]["w"]]
        c = layers[0].shape[0] // 3
        gt = sum(w.shape[1] for w in layers)
        macs += 2 * rows * c * gt
        macs += rows * k * sum((w.shape[0] - 3 * c) * w.shape[1]
                               for w in layers)
        macs += rows * (mp["conv1"]["w"].numel() + mp["conv2"]["w"].numel())
    return macs


def interp_macs(ip, rows: int) -> int:
    """Multiply-adds of the head over ``rows`` (point, slot) rows."""
    kc = ip["knn_context"]
    mats = [kc["distance_encoder"][f"lin{i}"]["w"] for i in range(3)]
    mats += [c["lin"]["w"] for c in kc["feat_conv"]["convs"]]
    mats += [kc["feat_conv"]["conv_out"]["w"]]
    mats += [ip["weight_unit"][f"lin{i}"]["w"] for i in range(3)]
    return rows * sum(w.numel() for w in mats)


def flow_macs(blocks, points: int, r: int | None) -> int:
    """Multiply-adds of the flow blocks: forward over ``points`` rows (r
    None), or inverse with the condition-only MLPs once per point and the
    coupling's h1 part for each of its r rows."""
    macs = 0
    for i, bp in enumerate(blocks):
        split = 1 if i % 2 == 0 else 2
        c1 = bp["coupling1"]["bias_net"]
        cond = sum(net["w0"].numel() + net["w1"].numel() + net["w2"].numel()
                   for net in bp["coupling2"].values())
        cdim = bp["coupling2"]["scale_net"]["w0"].shape[0]
        proj = cdim * c1["w0"].shape[1]
        tail = split * c1["w0"].shape[1] + c1["w1"].numel() + c1["w2"].numel()
        if r is None:
            macs += points * (cond + proj + tail + 9)
        else:
            macs += points * (cond + proj) + points * r * (tail + 9)
    return macs


def flow_fma_macs(blocks, rows: int) -> int:
    """The flows' multiply-adds outside their products over ``rows`` rows:
    the h1 term of the coupling's first layer and W (f) or W^-1 (g), which
    `csrc/flow_f.cu` and `csrc/flow_g.cu` take as f32 FMAs (part of
    `flow_macs`)."""
    return sum(rows * ((1 if i % 2 == 0 else 2)
                       * bp["coupling1"]["bias_net"]["w0"].shape[1] + 9)
               for i, bp in enumerate(blocks))


def synthetic_clouds(batch: int, seed: int,
                     n: int = N_POINTS) -> torch.Tensor:
    """Seeded surfaces of ``n`` points: points on ellipsoids with random
    axes and a low-frequency radial bump, made with numpy and moved to the
    card."""
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    axes = rng.uniform(0.5, 1.5, (batch, 1, 3))
    bump = 1.0 + 0.2 * np.sin(3.0 * v[..., :1]) * np.cos(2.0 * v[..., 1:2])
    return torch.from_numpy((v * axes * bump).astype(np.float32)).cuda()


def seeded_models(family: str = "discrete"):
    """Full-width models of a family ("discrete" or "cnf") from a
    torch.Generator seed, perturbed as in the tests so the flows are far
    from the identity (and the CNF solves take more than the minimum of
    steps): (unfolded, folded)."""
    init = continuous.init if family == "cnf" else discrete.init
    cls = checkpoint.MODELS[family]
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    params, state = checkpoint.to_numpy_tree(cls(*init(gen, device="cpu")))
    discrete.perturb_init(params, state, SEED)
    model = checkpoint.from_numpy_tree(params, state, "cuda", model=family)
    tp, ts = model.trees()
    return model, cls(fold_bn_inference(tp, ts), empty_bn_state(ts))


def cnf_sample_staged(model, patches, ops, mark):
    """`continuous.sample` written out stage by stage."""
    params, state = model.trees()
    folded = discrete.is_folded(params)
    knn_idx = knn_indices(patches, patches, K)
    idx8 = knn_idx[..., :INTERP_K]
    mark("knn")
    if folded:
        cs = ops["encoder"](params, patches, knn_idx)
    else:
        cs = enc_ops.encoder_conditions_plain(params, patches, knn_idx, state)
    mark("encoder")
    blocks = params["flow_blocks"]
    ends = [bp["sqrt_end_time"] * bp["sqrt_end_time"] for bp in blocks]
    zero = torch.zeros_like(ends[0])
    z = patches
    for bp, c, T in zip(blocks, cs, ends):
        z = ops["cnf_solve_t"](bp["layers"], c, z, zero, T)
    mark("f_solves")
    if folded:
        fz = ops["interp_head"](params["interp"], patches, idx8, UPRATIO,
                                "latents", z)
    else:
        fz = interp_ops.interp_head_plain(params["interp"], patches, idx8,
                                          UPRATIO, "latents", z,
                                          state["interp"])
    mark("head")
    B, N, C, r = fz.shape
    x = fz.transpose(2, 3).reshape(B, N * r, C)
    for bp, c, T in reversed(list(zip(blocks, cs, ends))):
        x = ops["cnf_solve_t"](bp["layers"], c, x, T, zero)
    mark("g_solves")
    return x


def sample_staged(model, patches, ops, mark):
    """The model's `sample` written out stage by stage, calling ``mark``
    after each stage; ``ops`` picks the kernels or the plain versions."""
    if isinstance(model, continuous.ContinuousModel):
        return cnf_sample_staged(model, patches, ops, mark)
    params, state = model.trees()
    if discrete.is_folded(params):
        idx = ops["knn_self"](patches, K)
        idx8 = idx[..., :INTERP_K]
        mark("knn_self")
        cs = ops["encoder"](params, patches, idx)
        mark("encoder")
        ws = ops["interp_head"](params["interp"], patches, idx8, UPRATIO,
                                "weights")
        mark("interp_head")
        z = ops["flow_f"](params["flow_blocks"], patches, cs)
        mark("flow_f")
        x = ops["flow_g_blend"](params["flow_blocks"], z, ws, idx8, cs)
        mark("flow_g_blend")
        return x
    knn_idx = ops["knn"](patches, patches, K)
    cs, _ = discrete.feat_extract(params, state, patches, knn_idx)
    mark("encoder")
    z = ops["flow_f"](params["flow_blocks"], patches, cs)
    mark("flow_f")
    fz, _ = interpolation_apply(params["interp"], state["interp"], z,
                                patches, UPRATIO, knn_idx=knn_idx)
    fz = fz.contiguous()
    mark("interpolation")
    x = ops["flow_g"](params["flow_blocks"], fz, cs)
    mark("flow_g")
    return x


def pipeline_staged(model, pc, ops=KERNEL_OPS, mark=lambda stage: None,
                    merge=None):
    """`upsample_cloud` + `remove_outliers`, written out stage by stage;
    ``merge`` holds `upsample_cloud`'s merge keywords (none: the union).
    -> (output, the normalised patches, `merge_select`'s inputs)."""
    merge = merge or {}
    B = pc.shape[0]
    pc_n, g_centroid, g_furthest = normalize_cloud(pc)
    seed_idx = ops["fps"](pc_n, N_PATCH)
    mark("seed_fps")
    seeds = gather_points(pc_n, seed_idx)
    idx = knn_indices(seeds, pc_n, PATCH)
    patches = gather_points(pc_n, idx).reshape(B * N_PATCH, PATCH, 3)
    flat_n, centroids, furthest = normalize_cloud(patches)
    mark("patch_knn")
    pred = sample_staged(model, flat_n, ops, mark)
    pred = (pred * furthest + centroids).reshape(B, -1, 3)
    merge_in = (pc_n, idx, pred)
    source, sel = merge_select(*merge_in, ops, merge)
    merged = gather_points(source, sel)
    if merge.get("seeded_merge"):
        merged = torch.cat([pc_n, merged], dim=1)
    merged = merged * g_furthest + g_centroid
    mark("merge_fps")
    out = remove_outliers(merged, pc, N_OUTLIERS)
    mark("outliers")
    return out, flat_n, merge_in


def merge_select(pc_n, idx, pred, ops, merge):
    """The merge's FPS as `upsample_cloud` runs it on the normalised cloud
    ``pc_n``, its patches' point indices ``idx`` and the predictions
    ``pred``: (the points picked from, the picks)."""
    groups = merge.get("merge_groups", 0)
    if merge.get("seeded_merge"):
        return pred, farthest_point_sample_seeded_morton(
            pred, pc_n, NPOINT - N_POINTS,
            groups or auto_merge_groups(pred.shape[1]),
            sample=ops["fps_seeded"])
    B = pred.shape[0]
    cov = torch.zeros((B, N_POINTS), dtype=torch.bool, device=pred.device)
    cov.scatter_(1, idx.reshape(B, -1), True)
    originals = torch.where(cov[..., None], pc_n, pred[:, :1, :])
    union = torch.cat([pred, originals], dim=1).contiguous()
    if groups > 1:
        return union, farthest_point_sample_morton(union, NPOINT, groups,
                                                   sample=ops["fps"])
    return union, ops["fps"](union, NPOINT)


def check_fps(name, xyz, m, results, plan=None, ref=None):
    """The FPS kernel (``plan``, or the wrapper's own) against the plain
    version's indices (``ref``, or computed here)."""
    got = farthest_point_sample(xyz, m, _plan=plan)
    if ref is None:
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


def check_close(results, name, got, ref, tol):
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    log(f"{name} {tuple(got.shape)}: max_abs_err {err:.3e} (tol {tol:.3e}, "
        f"{err / tol:.1%} of it)")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    results[name]["max_abs_err"] = max(
        results[name].get("max_abs_err", 0.0), err)


def time_pair(results, name, kernel, plain, reps=10, plain_reps=None):
    """plain, kernel, kernel, plain: compare within one call."""
    plain_reps = plain_reps or reps
    p1 = time_ms(plain, plain_reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, plain_reps)
    e = results[name]
    e.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=None)
    log(f"{name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
        f"{p2:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']})")


def main_path_patches(batch: int) -> torch.Tensor:
    """batch * 32 normalised patches of 256 points, cut from seeded clouds
    as the main path cuts them."""
    pc_n, _, _ = normalize_cloud(synthetic_clouds(batch, SEED + 1))
    seeds = gather_points(pc_n, farthest_point_sample_plain(pc_n, N_PATCH))
    patches = gather_points(pc_n, knn_indices(seeds, pc_n, PATCH))
    x, _, _ = normalize_cloud(patches.reshape(batch * N_PATCH, PATCH, 3))
    return x.contiguous()


def repeated_half(rng, batch: int, n: int) -> torch.Tensor:
    """Integer-grid clouds whose second half repeats the first: every point
    ties exactly with its copy in another block of a cluster, and the lower
    index must win."""
    half = rng.randint(0, 64, (batch, n // 2, 3))
    return torch.from_numpy(
        np.concatenate([half, half], 1).astype(np.float32)).cuda()


def fps_step_us(ms: float, m: int) -> float:
    return ms * 1e3 / (m - 1)


def compare_fps(results, rng):
    """`csrc/fps.cu` against the plain version: the seed pick and the
    union's 16 Morton cells (`--merge_groups 16`) at 1 and 32 clouds (one
    block a cloud), then the merge at 1, 8 and 32 clouds under every plan
    of the sweep (`SWEEP`; one block a cloud is C = 1), each timed, and the
    plan `_fps_plan` chooses timed against one block a cloud in turns."""
    cells = (MERGE_N // 16, -(-NPOINT // 16))              # 2176 -> 514
    for B, N, m, label in ((8, N_POINTS, N_PATCH, "seed pick"),
                           (8, MERGE_N, NPOINT, "merge"),
                           (16, *cells, "Morton cells, 1 cloud"),
                           (512, *cells, "Morton cells, 32 clouds")):
        grid = rng.randint(0, 11, (B, N, 3)).astype(np.float32)
        check_fps(f"{label} integer grid", torch.from_numpy(grid).cuda(), m,
                  results)
        cloud = rng.rand(B, N, 3).astype(np.float32)
        check_fps(f"{label} float", torch.from_numpy(cloud).cuda(), m,
                  results)
    capacity = functools.partial(fps_ops.cluster_capacity,
                                 torch.device("cuda"), MERGE_N)
    log("fps clusters the card holds at once at the merge, by C and T: "
        + "; ".join(f"C={c} " + " ".join(
            f"{t}:{capacity(fps_ops.FpsPlan(c, t))}"
            for t in sorted(fps_ops._CLUSTER_PER_THREAD)
            if fps_ops._plan_covers(fps_ops.FpsPlan(c, t), MERGE_N))
            for c in range(2, 17)))
    for B in MERGE_BATCHES:
        clouds = {"float": torch.from_numpy(
                      rng.rand(B, MERGE_N, 3).astype(np.float32)).cuda(),
                  "repeated half": repeated_half(rng, B, MERGE_N)}
        refs = {k: farthest_point_sample_plain(x, NPOINT)
                for k, x in clouds.items()}
        chosen = fps_ops._fps_plan(B, MERGE_N, capacity)
        shape = f"[{B}, {MERGE_N}] -> {NPOINT}"
        for plan in SWEEP:
            if not fps_ops._plan_covers(plan, MERGE_N):
                continue
            occupancy = ("-" if plan == fps_ops.ONE_BLOCK
                         else capacity(plan))
            for label, x in clouds.items():
                check_fps(f"merge {label}, C={plan.cluster} T="
                          f"{plan.threads}", x, NPOINT, results, plan=plan,
                          ref=refs[label])
            ms = time_ms(lambda: farthest_point_sample(
                clouds["float"], NPOINT, _plan=plan), 3)
            log(f"fps sweep {shape} C={plan.cluster} T={plan.threads}: "
                f"{ms:.4f} ms, {fps_step_us(ms, NPOINT):.4f} us a step, "
                f"{occupancy} clusters at once"
                + (" (chosen)" if plan == chosen else ""))
        x = clouds["float"]
        one = functools.partial(farthest_point_sample, x, NPOINT,
                                _plan=fps_ops.ONE_BLOCK)
        own = functools.partial(farthest_point_sample, x, NPOINT)
        o1, c1, c2, o2 = (time_ms(one, 3), time_ms(own, 3), time_ms(own, 3),
                          time_ms(one, 3))
        ms, one_ms = (c1 + c2) / 2, (o1 + o2) / 2
        log(f"fps merge {shape}: chosen C={chosen.cluster} T="
            f"{chosen.threads} {c1:.4f} / {c2:.4f} ms "
            f"({fps_step_us(ms, NPOINT):.4f} us a step), one block a cloud "
            f"{o1:.4f} / {o2:.4f} ms ({fps_step_us(one_ms, NPOINT):.4f} us "
            f"a step): {one_ms / ms:.2f}x")
        if ms > one_ms:
            raise AssertionError(f"fps merge {shape}: the chosen plan is "
                                 "slower than one block a cloud")
        if B == 8:
            results["fps"].update(ms=ms, library_ms=None)
            merge_cloud = x
    seed_cloud = torch.from_numpy(
        rng.rand(8, N_POINTS, 3).astype(np.float32)).cuda()
    seed_ms = time_ms(lambda: farthest_point_sample(seed_cloud, N_PATCH), 20)
    seed_plain = time_ms(
        lambda: farthest_point_sample_plain(seed_cloud, N_PATCH), 5)
    merge_plain = time_ms(
        lambda: farthest_point_sample_plain(merge_cloud, NPOINT), 1)
    log(f"fps seed pick [8, {N_POINTS}] -> {N_PATCH}: kernel {seed_ms:.4f} "
        f"ms, plain {seed_plain:.4f} ms")
    # each step: 3 sub, 3 mul, 2 add, a min and a compare per point
    set_bound(results["fps"], nbytes(merge_cloud) + 8 * NPOINT * 4,
              10 * 8 * MERGE_N * (NPOINT - 1))
    results["fps"].update(plain_ms=merge_plain)
    log(f"fps merge [8, {MERGE_N}] -> {NPOINT}: kernel "
        f"{results['fps']['ms']:.4f} ms, plain {merge_plain:.4f} ms, bound "
        f"{results['fps']['bound_ms']:.4f} ms "
        f"({results['fps']['bound_by']})")


def compare_folded(folded, x, results, rng):
    """The folded path's four kernels on 256 patches of 256 points."""
    M, n = x.shape[:2]
    grid = torch.from_numpy(
        rng.randint(0, 7, (M, n, 3)).astype(np.float32)).cuda()
    x32 = main_path_patches(32)                  # 1,024 patches
    for label, pts in (("float", x), ("integer grid", grid),
                       ("repeated half",
                        repeated_half(np.random.RandomState(n), M, n)),
                       ("float, 1,024 patches", x32)):
        got, ref = knn_self(pts, K), knn_self_plain(pts, K)
        torch.cuda.synchronize()
        if not bool((got == ref).all()):
            raise AssertionError(f"knn_self {label}: {int((got != ref).sum())}"
                                 " indices differ from the plain version")
        log(f"knn_self {label} {tuple(pts.shape)} -> {K}: indices equal")
        check_rerun(f"knn_self {label}", got, knn_self(pts, K))
    results["knn_self"]["max_abs_err"] = 0.0

    def knn_bound(entry, pts):
        # per patch: n^2 distances (8 flops each) and as many compares
        m = pts.shape[0]
        set_bound(entry, nbytes(pts) + m * n * K * 8, 9 * m * n * n)

    knn_bound(results["knn_self"], x)
    time_pair(results, "knn_self", lambda: knn_self(x, K),
              lambda: knn_self_plain(x, K))
    at32 = {"name": "knn_self"}
    knn_bound(at32, x32)
    time_pair({"knn_self": at32}, "knn_self", lambda: knn_self(x32, K),
              lambda: knn_self_plain(x32, K))
    card = card_line()
    for m, e in ((M, results["knn_self"]), (x32.shape[0], at32)):
        log(f"knn_self [{m}, {n}] -> {K}: kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}) on {card}")
    del x32

    fp, _ = folded.trees()
    idx = knn_self_plain(x, K)
    idx8 = idx[..., :INTERP_K]
    # the main path's K = 16, then K = 8 and 24 (padded to 16 and 32
    # slots), each a slice of a 24-neighbour graph; 65,536 points leave the
    # persistent grid's last round ragged
    idx24 = knn_indices(x, x, 24)
    for label, graph in (("K=16", idx), ("K=8 sliced", idx24[..., :8]),
                         ("K=24", idx24)):
        cs = enc_ops.encoder_conditions(fp, x, graph)
        cs_ref = enc_ops.encoder_conditions_plain(fp, x, graph)
        torch.cuda.synchronize()
        for b, (got, ref) in enumerate(zip(cs, cs_ref)):
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            log(f"encoder {label} block {b} {tuple(got.shape)}: max_abs_err "
                f"{err:.3e}, relative {err / scale:.3e} (tol 5e-5 * "
                f"{scale:.4f} + 1e-4)")
            if not err < 5e-5 * scale + 1e-4:
                raise AssertionError(f"encoder {label} block {b}: {err} "
                                     f"(scale {scale})")
            results["encoder"]["max_abs_err"] = max(
                results["encoder"].get("max_abs_err", 0.0), err)
    cs = enc_ops.encoder_conditions(fp, x, idx)
    cs_ref = enc_ops.encoder_conditions_plain(fp, x, idx)
    check_rerun("encoder", cs, enc_ops.encoder_conditions(fp, x, idx))
    set_bound_3xtf32(results["encoder"],
                     nbytes(x, idx, *cs) + tree_bytes(fp["feat_convs"])
                     + tree_bytes(fp["merge_convs"]),
                     2 * encoder_macs(fp, M * n, K))
    time_pair(results, "encoder",
              lambda: enc_ops.encoder_conditions(fp, x, idx),
              lambda: enc_ops.encoder_conditions_plain(fp, x, idx),
              plain_reps=3)

    blocks, ip = fp["flow_blocks"], fp["interp"]
    z = flow_ops.flow_f_plain(blocks, x, cs_ref)
    # the JAX package's gates for the exact head; k = 8 (the path's, the
    # softmax in registers), then 5 and 16 (logits staged in shared memory),
    # slices of the 24-neighbour graph
    for mode, tol in (("logits", 2e-3), ("weights", 5e-4),
                      ("latents", 5e-4)):
        for label, graph in (("K=8", idx8), ("K=5 sliced", idx24[..., :5]),
                             ("K=16 sliced", idx24[..., :16])):
            log(f"interp_head mode {mode} {label}:")
            got = interp_ops.interp_head(ip, x, graph, UPRATIO, mode, z)
            check_close(results, "interp_head", got,
                        interp_ops.interp_head_plain(ip, x, graph, UPRATIO,
                                                     mode, z), tol)
            check_rerun(f"interp_head mode {mode} {label}", got,
                        interp_ops.interp_head(ip, x, graph, UPRATIO, mode,
                                               z))
    ws = interp_ops.interp_head_plain(ip, x, idx8, UPRATIO)
    set_bound_3xtf32(results["interp_head"],
                     nbytes(x, idx8, ws) + tree_bytes(ip),
                     2 * interp_macs(ip, M * n * INTERP_K))
    time_pair(results, "interp_head",
              lambda: interp_ops.interp_head(ip, x, idx8, UPRATIO),
              lambda: interp_ops.interp_head_plain(ip, x, idx8, UPRATIO))
    for mode in ("logits", "latents"):   # the other two epilogues
        k_ms = time_ms(
            lambda: interp_ops.interp_head(ip, x, idx8, UPRATIO, mode, z), 10)
        p_ms = time_ms(lambda: interp_ops.interp_head_plain(
            ip, x, idx8, UPRATIO, mode, z), 10)
        log(f"interp_head mode {mode}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms")

    ref = flow_ops.flow_g_blend_plain(blocks, z, ws, idx8, cs_ref)
    got = flow_ops.flow_g_blend(blocks, z, ws, idx8, cs_ref)
    check_close(results, "flow_g_blend", got, ref,
                1e-5 * max(1.0, float(ref.abs().max())))
    check_rerun("flow_g_blend", got,
                flow_ops.flow_g_blend(blocks, z, ws, idx8, cs_ref))
    # the blend, the h1 terms and W^-1 are f32 FMAs
    fma = flow_fma_macs(blocks, M * n * UPRATIO)
    set_bound_3xtf32(results["flow_g_blend"],
                     nbytes(z, ws, idx8, ref, *cs_ref) + tree_bytes(blocks),
                     2 * (flow_macs(blocks, M * n, UPRATIO) - fma),
                     2 * (fma + M * n * UPRATIO * 3 * INTERP_K))
    time_pair(results, "flow_g_blend",
              lambda: flow_ops.flow_g_blend(blocks, z, ws, idx8, cs_ref),
              lambda: flow_ops.flow_g_blend_plain(blocks, z, ws, idx8,
                                                  cs_ref))


def compare_flows(model, x, results):
    """Flow f and g with the unfolded model's own conditions."""
    M, n = x.shape[:2]
    params, state = model.trees()
    blocks = params["flow_blocks"]
    knn_idx = knn_indices(x, x, K)
    cs, _ = discrete.feat_extract(params, state, x, knn_idx)
    z_ref = flow_ops.flow_f_plain(blocks, x, cs)
    fz, _ = interpolation_apply(params["interp"], state["interp"], z_ref, x,
                                UPRATIO, knn_idx=knn_idx)
    fz = fz.contiguous()
    g_ref = flow_ops.flow_g_plain(blocks, fz, cs)
    # both kernels 3xTF32 (the exact function's bound); the summation
    # order differs from the plain version's
    z = flow_ops.flow_f(blocks, x, cs)
    g = flow_ops.flow_g(blocks, fz, cs)
    for name, got, ref in (("flow_f", z, z_ref), ("flow_g", g, g_ref)):
        check_close(results, name, got, ref,
                    1e-5 * max(1.0, float(ref.abs().max())))
    check_rerun("flow_f", z, flow_ops.flow_f(blocks, x, cs))
    check_rerun("flow_g", g, flow_ops.flow_g(blocks, fz, cs))
    # the h1 terms and W (f) or W^-1 (g) are f32 FMAs
    fma = flow_fma_macs(blocks, M * n)
    set_bound_3xtf32(results["flow_f"],
                     nbytes(x, z_ref, *cs) + tree_bytes(blocks),
                     2 * (flow_macs(blocks, M * n, None) - fma), 2 * fma)
    fma = flow_fma_macs(blocks, M * n * UPRATIO)
    set_bound_3xtf32(results["flow_g"],
                     nbytes(fz, g_ref, *cs) + tree_bytes(blocks),
                     2 * (flow_macs(blocks, M * n, UPRATIO) - fma), 2 * fma)
    time_pair(results, "flow_f", lambda: flow_ops.flow_f(blocks, x, cs),
              lambda: flow_ops.flow_f_plain(blocks, x, cs))
    time_pair(results, "flow_g", lambda: flow_ops.flow_g(blocks, fz, cs),
              lambda: flow_ops.flow_g_plain(blocks, fz, cs))


def chamfer(a, b) -> float:
    d_ab, _, d_ba, _ = chamfer_parts(a, b)
    return float((d_ab.mean(dim=1) + d_ba.mean(dim=1)).max())


def solve_steps(stats_log) -> list:
    """[attempted, accepted] of each logged block-solve; raises if one
    used its whole step budget."""
    steps = torch.stack(stats_log).tolist()
    worst = max(s[0] for s in steps)
    if worst >= continuous.MAX_STEPS_EVAL:
        raise AssertionError(f"a block-solve used {worst} steps: it did not "
                             "converge within the step budget")
    return steps


def phase_main_path(name, model, results, batch=8):
    """One path's main path on ``batch`` clouds, with its launch counts:
    `MERGES` gives its merge, `PATHS` the kernels it must launch,
    `COUNT_FROM` which path's count goes into the kernel line."""
    merge = MERGES.get(name, {})
    kernels = PATHS[name]
    pc = synthetic_clouds(batch, SEED)
    for fn in WRAPPERS.values():
        fn.launches = 0
    cnf_ops.cnf_solve.stats_log = []
    with torch.no_grad():
        out = upsample_cloud(model, pc, NPOINT, UPRATIO, PATCH, EXPAND,
                             **merge)
        out = remove_outliers(out, pc, N_OUTLIERS)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in WRAPPERS.items()}
    stats_log, cnf_ops.cnf_solve.stats_log = cnf_ops.cnf_solve.stats_log, None
    log(f"{name} main path, {batch} clouds, merge {merge or 'union'}: "
        f"output {tuple(out.shape)}, launches {launches}")
    for k in kernels:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched by the {name} "
                                 "main path")
        if COUNT_FROM[k] == name:
            results[k]["launches"] = launches[k]
    if "cnf_solve" in kernels:
        if launches["cnf_solve"] != CNF_SOLVES:
            raise AssertionError(f"{launches['cnf_solve']} cnf_solve launches "
                                 f"in one sample, not {CNF_SOLVES}")
        log(f"{name} main path: [attempted, accepted] steps of the "
            f"{CNF_SOLVES} block-solves (f then g): {solve_steps(stats_log)}")
    if tuple(out.shape) != (batch, N_POINTS * UPRATIO, 3):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("output has non-finite values")

    with torch.no_grad():
        staged, patches, merge_in = pipeline_staged(model, pc, merge=merge)
        plain, _, _ = pipeline_staged(model, pc, PLAIN_OPS, merge=merge)
        # the merge's kernel and its plain version on this path's own
        # predictions: the same picks
        _, sel = merge_select(*merge_in, KERNEL_OPS, merge)
        _, sel_plain = merge_select(*merge_in, PLAIN_OPS, merge)
        one = patches[:N_PATCH].contiguous()
        got = model(one, UPRATIO)
        ref = sample_staged(model, one, PLAIN_OPS, lambda stage: None)
    torch.cuda.synchronize()
    # the staged copy runs the same ops as upsample_cloud
    d_staged = float((staged - out).abs().max())
    log(f"{name} staged pipeline vs upsample_cloud: max_abs_diff "
        f"{d_staged:.3e}")
    if not d_staged <= 1e-5:
        raise AssertionError("the staged pipeline is not the main path")
    err = float((got - ref).abs().max())
    log(f"{name} model sample on {N_PATCH} patches vs plain composition: "
        f"max_abs_err {err:.3e} (atol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"sample: max_abs_err {err} > 1e-4")
    differ = int((sel != sel_plain).sum())
    log(f"{name} merge FPS on the path's own predictions {tuple(sel.shape)},"
        f" kernel vs plain: {differ} indices differ")
    if differ:
        raise AssertionError(f"{name}: the merge's kernel picks {differ} "
                             "other points than its plain version")
    # the plain pipeline can differ only by FPS near-tie flips that the
    # 1e-6-level model differences cause
    cd = chamfer(out, plain)
    log(f"{name} pipeline on kernels vs on plain versions: chamfer "
        f"{cd:.3e} (gate 1e-4)")
    if not cd < 1e-4:
        raise AssertionError(f"pipeline chamfer {cd} >= 1e-4")


def trace_idle(label, fn, untraced_s: float):
    """One call of ``fn`` under torch.profiler: prints the card's busy
    time (the union of its activity) and the top kernels. The profiler
    slows the host, so the idle share is given against ``untraced_s``, the
    median wall time of ``fn`` timed without it, and beside it against the
    traced call's own wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    untraced_us = untraced_s * 1e6
    log(f"{label}: device busy {busy_us / 1e3:.3f} ms (traced); idle share "
        f"{1.0 - busy_us / untraced_us:.4f} of the untraced "
        f"{untraced_us / 1e3:.3f} ms (median), "
        f"{1.0 - busy_us / wall_us:.4f} of the traced {wall_us / 1e3:.3f} ms")
    log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=12, max_name_column_width=60))


def traced_run(name, model, pc, untraced_s):
    """One pipeline run under torch.profiler (`trace_idle`)."""
    trace_idle(f"{name} B={pc.shape[0]}", lambda: pipeline_staged(model, pc),
               untraced_s)


def phase_timing(name, model, card, batches=(8, 32)):
    for B in batches:
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
        log(f"{name} B={B} per-stage ms (median of 3): {split}")
        log(f"{name} B={B} end to end {total * 1e3:.2f} ms: {B / total:.2f} "
            f"clouds/s, {B * N_PATCH / total:.1f} patches/s on {card}")
        with torch.no_grad():
            if "cnf_solve" in PATHS[name]:
                cnf_ops.cnf_solve.stats_log = []
                pipeline_staged(model, pc)
                stats_log = cnf_ops.cnf_solve.stats_log
                cnf_ops.cnf_solve.stats_log = None
                log(f"{name} B={B} [attempted, accepted] steps of the "
                    f"block-solves (f then g): {solve_steps(stats_log)}")
            traced_run(name, model, pc, total)


def training_inputs(model):
    """The perturbed model's trees after the ActNorm warm-up, and
    bench.py's synthetic batch (32 patches, 256 -> 1024 points) on the
    card."""
    sp, de = synthetic_pairs(np.random.RandomState(0), TRAIN_B, TRAIN_N,
                             UPRATIO)
    sparse, dense = torch.from_numpy(sp).cuda(), torch.from_numpy(de).cuda()
    params, state = model.trees()
    params = discrete.actnorm_warmup(params, state, sparse)
    return params, state, sparse, dense


def phase_emd(results, params, state, sparse, dense):
    """The auction kernel against its plain version at the training shape:
    uniform clouds in [0, 1], and the model's own training prediction
    against its target."""
    cfg = TrainConfig()
    eps, iters = cfg.emd_eps, cfg.emd_iters
    rng = np.random.RandomState(SEED + 2)
    uniform = tuple(torch.from_numpy(rng.rand(TRAIN_B, TRAIN_N * UPRATIO, 3)
                                     .astype(np.float32)).cuda()
                    for _ in range(2))
    with torch.no_grad():
        pred, _, _ = discrete.forward(params, state, sparse, UPRATIO,
                                      train=True)
    pred = pred.contiguous()
    for label, (x1, x2) in (("uniform [0, 1]", uniform),
                            ("training prediction", (pred, dense))):
        dist, assign = emd_auction(x1, x2, eps, iters)
        ref_dist, ref_assign = emd_auction_plain(x1, x2, eps, iters)
        torch.cuda.synchronize()
        differ = int((assign != ref_assign).sum())
        if differ:
            raise AssertionError(f"emd {label}: {differ} assignments differ "
                                 "from the plain version")
        log(f"emd {label} {tuple(x1.shape)} vs {tuple(x2.shape)}: "
            "assignments equal to the plain version")
        check_close(results, "emd", dist, ref_dist,
                    1e-6 * max(1.0, float(ref_dist.abs().max())))
        check_rerun(f"emd {label}", [dist, assign],
                    list(emd_auction(x1, x2, eps, iters)))
    bad = pred.clone()
    bad[0, 7] = float("nan")
    dist, assign = emd_auction(bad, dense, eps, iters)
    torch.cuda.synchronize()
    if bool(torch.isfinite(dist[0, 7])) or not bool(
            torch.isfinite(dist[1:]).all()):
        raise AssertionError("emd: a NaN row must give a non-finite dist "
                             "and leave the other clouds finite")
    if int(assign.min()) < -1 or int(assign.max()) >= dense.shape[1]:
        raise AssertionError("emd: assignment out of range on NaN input")
    _, ref_assign = emd_auction_plain(bad, dense, eps, iters)
    differ = int((assign != ref_assign).sum())
    if differ or int(assign[0, 7]) != -1:
        raise AssertionError(f"emd NaN input: {differ} assignments differ "
                             "from the plain version, or the NaN row got a "
                             "column")
    log("emd NaN input: no CUDA error, dist non-finite on the NaN row "
        "(assign -1), the other clouds finite, assignments equal to the "
        "plain version")

    # the bound: coordinates in, dist and assign out; the base matrix
    # (12 flops and a square root a pair) and 4 flops per (unassigned row,
    # column) per iteration, counted by the plain version on these inputs
    unassigned = []
    emd_auction_plain(pred, dense, eps, iters, unassigned)
    per_iter = torch.stack(unassigned).sum(dim=1).tolist()
    rows = sum(per_iter)
    B, n = pred.shape[:2]
    m = dense.shape[1]
    log(f"emd auction work: {rows} unassigned row sweeps over {iters} "
        f"iterations ({rows / B / n:.3f} full sweeps a cloud)")
    under = next((i for i, r in enumerate(per_iter) if r < 64 * B), None)
    log("emd unassigned rows a cloud, training prediction: iterations 0-4 "
        + ", ".join(f"{r / B:.2f}" for r in per_iter[:5])
        + (f"; first under 64 at iteration {under} ({per_iter[under] / B:.2f})"
           if under is not None else "; never under 64")
        + f"; iteration {iters - 1} {per_iter[-1] / B:.2f}")
    set_bound(results["emd"], nbytes(pred, dense) + B * n * (4 + 8),
              13 * B * n * m + 4 * m * rows)
    time_pair(results, "emd", lambda: emd_auction(pred, dense, eps, iters),
              lambda: emd_auction_plain(pred, dense, eps, iters))
    # the training prediction's first 1, 8 and 32 clouds: the cluster size
    # the plan takes for each, kernel and plain version in turns
    for b in (1, 8, B):
        x1, x2 = pred[:b].contiguous(), dense[:b].contiguous()
        cluster = emd_ops._emd_plan(b, n, m, functools.partial(
            emd_ops.cluster_capacity, x1.device, n, m))
        _, assign = emd_auction(x1, x2, eps, iters)
        _, ref_assign = emd_auction_plain(x1, x2, eps, iters)
        if not torch.equal(assign, ref_assign):
            raise AssertionError(f"emd B={b}: assignments differ from the "
                                 "plain version")

        def kernel(x1=x1, x2=x2):
            return emd_auction(x1, x2, eps, iters)

        def plain(x1=x1, x2=x2):
            return emd_auction_plain(x1, x2, eps, iters)

        p1, k1, k2, p2 = (time_ms(plain, 5), time_ms(kernel, 10),
                          time_ms(kernel, 10), time_ms(plain, 5))
        log(f"emd B={b} [{b}, {n}] vs [{b}, {m}]: a cloud over a cluster of "
            f"{cluster} blocks, assignments equal to the plain version; "
            f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")


def step_grads(trainer, sparse, dense, emd_fn):
    """The gradient the train step takes, with the EMD ``emd_fn``."""
    cfg = trainer.cfg
    leaf = trainer.params.detach().requires_grad_()
    pred, logpx, _ = discrete.forward(
        trainer.param_layout.unflatten(leaf),
        trainer.state_layout.unflatten(trainer.bn_state), sparse,
        cfg.upratio, train=True)
    dist, _ = emd_fn(pred, dense, cfg.emd_eps, cfg.emd_iters)
    loss = logpx * cfg.logpx_weight + torch.sum(dist) * cfg.emd_weight
    return torch.autograd.grad(loss, leaf)[0], float(loss.detach())


ROUNDING_ZERO = 1e-4


def rounding_zero(paths, grads) -> dict:
    """The bias leaves whose gradient is zero to rounding: the largest
    entry is below ``ROUNDING_ZERO`` times that of the same layer's weight
    gradient. (A bias that train-mode BN follows has an exactly zero
    gradient, BN removes the mean, and holds rounding noise of the batch
    sums, about 1e-6 of the weight's; a bias with a real gradient has more
    than 1e-2 of it.) -> {path: that ratio}."""
    peak = {p: float(g.abs().max()) for p, g in zip(paths, grads)}
    ratios = {p: peak[p] / max(peak[p[:-1] + "w"], 1e-30)
              for p in paths
              if p.endswith("/b") and p[:-1] + "w" in peak}
    return {p: r for p, r in ratios.items() if r < ROUNDING_ZERO}


def phase_train(results, params, state, sparse, dense, card):
    """The training main path: TrainConfig() defaults at batch 32."""
    trainer = Trainer(TrainConfig(), params, state, device="cuda")
    layout = trainer.param_layout
    g_kernel, loss_kernel = step_grads(trainer, sparse, dense, emd_auction)
    g_plain, loss_plain = step_grads(trainer, sparse, dense,
                                     emd_auction_plain)
    # leaves whose true gradient is zero hold only rounding noise: there
    # both sides must be zero to rounding, and every other leaf is held to
    # the bound
    zero_plain = rounding_zero(layout.paths, g_plain.split(layout.sizes))
    zero_kernel = rounding_zero(layout.paths, g_kernel.split(layout.sizes))
    if set(zero_plain) != set(zero_kernel):
        raise AssertionError(
            "train gradients: the leaves zero to rounding differ between "
            f"kernel EMD and plain EMD: {sorted(set(zero_plain) ^ set(zero_kernel))}")
    worst = 0.0
    for path, a, b in zip(layout.paths, g_kernel.split(layout.sizes),
                          g_plain.split(layout.sizes)):
        if path in zero_plain:
            continue
        scale = max(float(b.abs().max()), 1e-3)
        err, tol = float((a - b).abs().max()), 5e-4 * scale + 1e-6
        if not err <= tol:
            raise AssertionError(f"train gradients {path}: kernel EMD vs "
                                 f"plain EMD {err} > {tol}")
        worst = max(worst, err / tol)
    log(f"train step 1 gradients, kernel EMD vs plain EMD: "
        f"{len(layout.paths) - len(zero_plain)} leaves within 5e-4 * scale + "
        f"1e-6 (worst {worst:.3e} of the bound); loss {loss_kernel:.6f} vs "
        f"{loss_plain:.6f}")
    log(f"train step 1 gradients zero to rounding on both sides (largest "
        f"entry / the layer weight's, below {ROUNDING_ZERO:g}), kernel vs "
        f"plain: " + ", ".join(f"{p} {zero_kernel[p]:.2e} vs {r:.2e}"
                               for p, r in zero_plain.items()))

    for fn in WRAPPERS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = [trainer.step(sparse, dense) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    windows, splits = [], {}
    for _ in range(TRAIN_WINDOWS):
        marks_per_step = []
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            marks = [("start", torch.cuda.Event(enable_timing=True))]
            marks[0][1].record()

            def mark(stage, marks=marks):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((stage, ev))

            metrics.append(trainer.step(sparse, dense, mark))
            marks_per_step.append(marks)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
        for marks in marks_per_step:
            for (_, a), (stage, b) in zip(marks, marks[1:]):
                splits.setdefault(stage, []).append(a.elapsed_time(b))
    launches = {k: fn.launches for k, fn in WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_WARMUP + TRAIN_WINDOWS * TRAIN_STEPS
    log(f"train main path: {steps} steps, launches {launches}")
    if launches["emd"] != steps:
        raise AssertionError(f"emd kernel launched {launches['emd']} times "
                             f"in {steps} train steps")
    results["emd"]["launches"] = launches["emd"]
    table = torch.stack([torch.stack([m["loss"], m["emd"],
                                      m["nan_step"].float()])
                         for m in metrics]).cpu().numpy()
    if not np.isfinite(table[:, :2]).all() or table[:, 2].any():
        raise AssertionError("train: a loss was not finite or a step "
                             "tripped the NaN guard")
    log(f"train loss first {table[0, 0]:.6f} last {table[-1, 0]:.6f}, emd "
        f"first {table[0, 1]:.4f} last {table[-1, 1]:.4f}, no NaN step")
    per_step = [w / TRAIN_STEPS for w in windows]
    median = statistics.median(per_step)
    log(f"train B={TRAIN_B} step ms per window of {TRAIN_STEPS}: "
        + ", ".join(f"{t * 1e3:.3f}" for t in per_step)
        + f"; steps/s median {1.0 / median:.3f} (range "
        f"{1.0 / max(per_step):.3f} to {1.0 / min(per_step):.3f}), on {card}")
    log(f"train B={TRAIN_B} per-step split, ms (median of "
        f"{TRAIN_WINDOWS * TRAIN_STEPS}): " + ", ".join(
            f"{k} {statistics.median(v):.3f}" for k, v in splits.items()))
    log(f"train B={TRAIN_B} peak device memory "
        f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    trace_idle(f"train B={TRAIN_B} step",
               lambda: trainer.step(sparse, dense), median)


def phase_cli():
    """Train with the CLI on the card, then serve what it saved."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m.npz")
        cmd = [sys.executable, "-m", "puflow_torch.cli.train_pu1k",
               "--synthetic", "2", "--max_epochs", "1", "--val_batches", "1",
               "--batch_size", str(TRAIN_B), "--device", "cuda",
               "--checkpoint", ckpt]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        log(f"train CLI ({time.perf_counter() - t0:.1f} s, exit "
            f"{proc.returncode}): {' '.join(cmd[1:])}")
        log(proc.stdout.strip())
        if proc.returncode != 0:
            raise AssertionError(f"train CLI failed:\n{proc.stderr[-4000:]}")
        model = checkpoint.load_checkpoint(ckpt, "cuda", fold=True)
        pc = synthetic_clouds(1, SEED + 3)
        with torch.no_grad():
            out = upsample_cloud(model, pc, NPOINT, UPRATIO, PATCH, EXPAND)
            out = remove_outliers(out, pc, N_OUTLIERS)
        torch.cuda.synchronize()
        if tuple(out.shape) != (1, N_POINTS * UPRATIO, 3):
            raise AssertionError(f"served output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("served output has non-finite values")
        log(f"served the CLI-trained checkpoint (BN folded): {N_POINTS} -> "
            f"{tuple(out.shape)}, finite")


LARGE_CLOUD = 12000  # points of the cloud served in patches over the limit


def compare_knn_stream(results, x, big):
    """The streaming self k-NN kernel (patches over shared memory) against
    the plain version: at the main path's 256 patches of 256 points (one
    lane a query) and at one patch of `KNN_MAX_N` + 1 points (four; float,
    integer grid and repeated points); equal indices, two runs bit-equal;
    timed at the large patch."""
    n = big.shape[1]
    grid = torch.from_numpy(np.random.RandomState(n).randint(
        0, 31, (1, n, 3)).astype(np.float32)).cuda()
    for label, pts in (("float, 256 patches", x), ("float", big),
                       ("integer grid", grid),
                       ("repeated half",
                        repeated_half(np.random.RandomState(n), 1, n))):
        got, ref = knn_self_stream(pts, K), knn_self_plain(pts, K)
        torch.cuda.synchronize()
        if not bool((got == ref).all()):
            raise AssertionError(f"knn_self_stream {label}: "
                                 f"{int((got != ref).sum())} indices differ "
                                 "from the plain version")
        log(f"knn_self_stream {label} {tuple(pts.shape)} -> {K}: indices "
            "equal")
        check_rerun(f"knn_self_stream {label}", got, knn_self_stream(pts, K))
    entry = results["knn_self_stream"]
    entry["max_abs_err"] = 0.0
    # n^2 distances (8 flops each) and as many compares
    set_bound(entry, nbytes(big) + n * K * 8, 9 * n * n)
    time_pair(results, "knn_self_stream", lambda: knn_self_stream(big, K),
              lambda: knn_self_plain(big, K), reps=5)
    log(f"knn_self_stream [1, {n}] -> {K}: kernel {entry['ms']:.4f} ms, "
        f"plain {entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
        f"({entry['bound_by']}) on {card_line()}")


def phase_large_patch(results, model, folded):
    """The folded path on patches one point over the shared-memory self
    k-NN kernel's limit (`KNN_MAX_N` + 1): the streaming kernel is held to
    its plain version, `discrete.forward` takes it and its four other
    kernels and matches the plain composition; then the upsample CLI (BN
    folded) serves a cloud of `LARGE_CLOUD` points in such patches
    (`--num_patch`)."""
    n = KNN_MAX_N + 1
    x = synthetic_clouds(1, SEED + 9, n)
    with torch.no_grad():
        compare_knn_stream(results, main_path_patches(8), x)
    for fn in WRAPPERS.values():
        fn.launches = 0
    with torch.no_grad():
        got = folded(x, UPRATIO)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in WRAPPERS.items()}
        ref = sample_staged(folded, x, PLAIN_OPS, lambda stage: None)
    err = float((got - ref).abs().max())
    log(f"folded sample on a patch of {n} points (KNN_MAX_N + 1): launches "
        f"{launches}; vs the plain composition max_abs_err {err:.3e} (atol "
        "1e-4)")
    path = PATHS["large_patch"]
    if launches != {k: int(k in path) for k in launches}:
        raise AssertionError("a patch over the k-NN limit: the folded path "
                             f"did not launch each of {path} once")
    results["knn_self_stream"]["launches"] = launches["knn_self_stream"]
    if not err <= 1e-4:
        raise AssertionError(f"a patch over the k-NN limit: max_abs_err {err}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m.npz")
        checkpoint.save_checkpoint(ckpt, *checkpoint.to_numpy_tree(model))
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        cloud = synthetic_clouds(1, SEED + 10, LARGE_CLOUD)[0]
        np.savetxt(os.path.join(src, "cloud.xyz"), cloud.cpu().numpy(),
                   fmt="%.6f")
        cmd = [sys.executable, "-m", "puflow_torch.cli.upsample",
               "--source", src, "--target", os.path.join(tmp, "out"),
               "--checkpoint", ckpt, "--device", "cuda",
               "--num_patch", str(n)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        log(f"upsample CLI ({time.perf_counter() - t0:.1f} s, exit "
            f"{proc.returncode}): {' '.join(cmd[3:])}: {proc.stdout.strip()}")
        if proc.returncode != 0:
            raise AssertionError("upsample CLI over the k-NN limit failed:\n"
                                 + proc.stderr[-4000:])
        pts = np.loadtxt(os.path.join(tmp, "out", "cloud.xyz"))
        if pts.shape != (LARGE_CLOUD * UPRATIO, 3) or not np.isfinite(
                pts).all():
            raise AssertionError(f"upsample CLI over the k-NN limit wrote "
                                 f"{pts.shape}")
        log(f"upsample CLI --num_patch {n}: {LARGE_CLOUD} -> {pts.shape[0]} "
            "finite points")


SOLVER_TOL = 5e-5   # kernel against plain where a step size is not clipped
WITNESS_STEPS = 1024


def rk4_witness(layers, c, y, t0, t1, steps: int) -> torch.Tensor:
    """A second witness for a block-solve, independent of the adaptive
    solver: classical RK4 on `field_plain_csl` in float64 with ``steps``
    equal steps and the time kept on the host. Its own error is read from
    the same solve with half the steps."""
    c = torch.repeat_interleave(c, y.shape[1] // c.shape[1], dim=1)
    f = continuous.field_plain_csl(_to64(layers), c.double())
    y, t0, t1 = y.double(), float(t0), float(t1)
    h = (t1 - t0) / steps
    for i in range(steps):
        t = t0 + i * h
        k1 = f(t, y)
        k2 = f(t + h / 2, y + (h / 2) * k1)
        k3 = f(t + h / 2, y + (h / 2) * k2)
        k4 = f(t + h, y + h * k3)
        y = y + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
    return y


def witness_check(args, got, ref, witness=None, steps=WITNESS_STEPS,
                  name="cnf_solve"):
    """Hold kernel and plain version against `rk4_witness` (or
    ``witness``, with ``steps`` steps). Where a step
    size follows the error estimate the two differ by more than rounding;
    that is the solver's tolerance at work only if both lie about as far
    from the witness, farther than they lie from each other. So the
    kernel's error may be at most 1.25 times the plain version's, and
    their difference at most half of the larger error (1e-6 of rounding
    allowed in both)."""
    witness = witness or rk4_witness
    fine = witness(*args, steps=steps)
    own = float((fine - witness(*args, steps=steps // 2)).abs().max())
    err_k = float((got.double() - fine).abs().max())
    err_p = float((ref.double() - fine).abs().max())
    diff = float((got - ref).abs().max())
    log(f"  against float64 RK4 of {steps} steps (its own error "
        f"{own:.3e}): kernel {err_k:.3e}, plain {err_p:.3e}, kernel "
        f"against plain {diff:.3e}")
    if not own < 1e-7:
        raise AssertionError(f"{name}: the RK4 witness has not converged")
    if not err_k <= 1.25 * err_p + 1e-6:
        raise AssertionError(f"{name}: the kernel lies farther from the "
                             "float64 witness than the plain version")
    if not diff <= 0.5 * max(err_k, err_p) + 1e-6:
        raise AssertionError(f"{name}: kernel and plain version differ by "
                             "more than the solve's own error explains")


def compare_cnf(model, results):
    """The whole-solve kernel against `cnf_solve_plain` on 32 main-path
    patches with the unfolded CNF model's own conditions.

    With seeded blocks, whose field hardly depends on t, a solve takes
    three steps and every step size is set by a clip (first step, growth
    limit, end of the span), as in the JAX package's test of its kernel
    (tests/test_cnf.py:195-213): the kernel is held to that test's bound,
    5e-6, at every shape. With the model's perturbed blocks the step sizes
    follow the error estimate, and a backward solve at tolerance 1e-5 ends
    about 3e-5 from a float64 fixed-step solve on its worst rows, kernel
    and plain version alike, and the two about 6e-6 from each other. Those
    solves are held to `SOLVER_TOL`, five times the solver's tolerance,
    and to `witness_check`.
    Step counts must be equal and two kernel runs bit-equal everywhere.
    """
    params, state = model.trees()
    x = main_path_patches(1)                       # [32, 256, 3]: R = 8,192
    cs = enc_ops.encoder_conditions_plain(params, x, knn_indices(x, x, K),
                                          state)
    rng = np.random.RandomState(SEED + 4)
    B, n = x.shape[:2]
    latents = torch.from_numpy(
        (rng.randn(B, n * UPRATIO, 3) * 0.5).astype(np.float32)).cuda()
    seeded = continuous.init(torch.Generator(device="cuda").manual_seed(
        SEED))[0]["flow_blocks"]

    def solve_args(blocks, block, c, y, reverse):
        bp = blocks[block]
        T = bp["sqrt_end_time"] * bp["sqrt_end_time"]
        zero = torch.zeros_like(T)
        return (bp["layers"], c, y) + ((T, zero) if reverse else (zero, T))

    for weights, blocks, tol in (("seeded", seeded, 5e-6),
                                 ("perturbed", params["flow_blocks"],
                                  SOLVER_TOL)):
        for block in (0, 3):                       # condition widths 32, 128
            c = cs[block]
            shapes = (("R = 8,192", c, x), ("R = 32,768, r = 4", c, latents),
                      # 251 rows a patch: no multiple of any tile height
                      ("R = 8,032", c[:, :251].contiguous(),
                       x[:, :251].contiguous()))
            for label, cc, y in shapes:
                for reverse in (False, True):
                    args = solve_args(blocks, block, cc, y, reverse)
                    got, stats = cnf_ops.cnf_solve_t(*args, return_stats=True)
                    again = cnf_ops.cnf_solve_t(*args)
                    ref, ref_stats = cnf_ops.cnf_solve_plain(
                        *args, return_stats=True)
                    torch.cuda.synchronize()
                    steps = stats.tolist()
                    log(f"cnf_solve {weights} weights, cdim {cc.shape[-1]}, "
                        f"{label}, {'T -> 0' if reverse else '0 -> T'}: "
                        f"steps [attempted, accepted] kernel {steps}, plain "
                        f"{ref_stats}")
                    if steps != [ref_stats["steps"], ref_stats["accepted"]]:
                        raise AssertionError(
                            "cnf_solve: the kernel's step counts differ from "
                            "the plain version's")
                    if steps[0] >= continuous.MAX_STEPS_EVAL:
                        raise AssertionError("cnf_solve: step budget used up")
                    if not torch.equal(got, again):
                        raise AssertionError("cnf_solve: two runs of the "
                                             "kernel are not bit-equal")
                    check_close(results, "cnf_solve", got, ref, tol)
                    if weights == "perturbed":
                        witness_check(args, got, ref)
    blocks = params["flow_blocks"]

    # times and the bound at the two shapes of `bench_cnf`'s sample, cdim
    # 128: the function reads y, c, the layers and t0, t1 and writes y(t1);
    # it makes 1 + 6 field evaluations a step attempted on every row
    # (4,480 multiply-adds each, 4,096 of them the 64 x 64 product, which
    # counts at 3xTF32 on the tensor cores, `set_bound_3xtf32`; its log
    # gives the FP32 bound beside) and projects the conditions once
    for label, y, reverse in (("f, R = 8,192", x, False),
                              ("g, R = 32,768, r = 4", latents, True)):
        args = solve_args(blocks, 3, cs[3], y, reverse)
        _, stats = cnf_ops.cnf_solve_t(*args, return_stats=True)
        attempted, accepted = stats.tolist()
        rows, c_rows = y.shape[0] * y.shape[1], B * n
        layers = args[0]
        evals = rows * (1 + 6 * attempted)
        log(f"cnf_solve {label}: steps [attempted, accepted] [{attempted}, "
            f"{accepted}], {1 + 6 * attempted} field evaluations a row")
        set_bound_3xtf32(results["cnf_solve"],
                         2 * nbytes(y) + nbytes(cs[3]) + tree_bytes(layers)
                         + 8, 2 * evals * TC_MACS,
                         2 * (evals * (FIELD_MACS - TC_MACS)
                              + c_rows * cs[3].shape[-1] * (4 * 64 + 6)))
        # the kernel line keeps the last: the g solve
        time_pair(results, "cnf_solve", lambda: cnf_ops.cnf_solve_t(*args),
                  lambda: cnf_ops.cnf_solve_plain(*args), reps=5)


def phase_cnf_bench(name, model, card):
    """`continuous.sample` alone at `bench.py:bench_cnf`'s shape: 32
    patches of 256 points, x4."""
    patches = main_path_patches(1)
    iters = 30
    with torch.no_grad():
        for _ in range(2):
            model(patches, UPRATIO)
        torch.cuda.synchronize()
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                model(patches, UPRATIO)
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / iters)
        median = statistics.median(windows)
        log(f"{name} continuous.sample on {patches.shape[0]} patches, ms per "
            f"call in windows of {iters}: "
            + ", ".join(f"{w * 1e3:.3f}" for w in windows)
            + f"; median {patches.shape[0] / median:.1f} patches/s on {card}")
        trace_idle(f"{name} continuous.sample, {patches.shape[0]} patches",
                   lambda: model(patches, UPRATIO), median)


def phase_cnf_cli(model):
    """Save the seeded CNF model as `.npz`, then serve it with the CLI."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "cnf.npz")
        checkpoint.save_checkpoint(ckpt, *checkpoint.to_numpy_tree(model))
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        np.savetxt(os.path.join(src, "cloud.xyz"),
                   synthetic_clouds(1, SEED + 5)[0].cpu().numpy(), fmt="%.6f")
        cmd = [sys.executable, "-m", "puflow_torch.cli.upsample", "--model",
               "cnf", "--source", src, "--target", dst, "--checkpoint", ckpt,
               "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        log(f"upsample CLI ({time.perf_counter() - t0:.1f} s, exit "
            f"{proc.returncode}): {' '.join(cmd[1:])}")
        log(proc.stdout.strip())
        if proc.returncode != 0:
            raise AssertionError("upsample CLI failed:\n"
                                 + proc.stderr[-4000:])
        out = np.loadtxt(os.path.join(dst, "cloud.xyz"))
        if out.shape != (N_POINTS * UPRATIO, 3) or not np.isfinite(out).all():
            raise AssertionError(f"upsample CLI wrote {out.shape}")
        log(f"upsample --model cnf wrote {out.shape[0]} finite points")


SEEDED_PICKS = NPOINT - N_POINTS                           # 6,168 a cloud
PRED_N = N_PATCH * PATCH * UPRATIO                          # 32,768


def check_fps_seeded(label, xyz, seeds, m):
    """The seeded-FPS kernel against its plain version: equal indices, and
    a second run bit-equal to the first."""
    got = farthest_point_sample_seeded(xyz, seeds, m)
    again = farthest_point_sample_seeded(xyz, seeds, m)
    ref = farthest_point_sample_seeded_plain(xyz, seeds, m)
    torch.cuda.synchronize()
    bad = (got != ref).any(dim=0).nonzero()
    if bad.numel():
        step = int(bad[0])
        raise AssertionError(
            f"fps_seeded {label}: indices differ first at step {step}: "
            f"kernel {got[:, step].tolist()[:8]} plain "
            f"{ref[:, step].tolist()[:8]}")
    if not torch.equal(got, again):
        raise AssertionError(f"fps_seeded {label}: two runs differ")
    log(f"fps_seeded {label} {tuple(xyz.shape)}, seeds "
        f"{tuple(seeds.shape)} -> {m}: indices equal, rerun bit-equal")


def compare_fps_seeded(results, rng):
    """`csrc/fps.cu:puflow_fps_seeded` against
    `farthest_point_sample_seeded_plain`, then its times at the seeded
    merge's three shapes with seeding and selection apart."""
    results["fps_seeded"]["max_abs_err"] = 0.0
    # (label, rows, candidates, seed sets, seeds, picks): the Morton cells
    # of the seeded merge at auto G = 16 (16 rows a cloud share its seed
    # set), its G = 1 row, a PU-GAN 5,000-point cloud's union at G = 1
    # (79,872 candidates: the cache in global scratch), a ragged case
    shapes = (("G = 16, 1 cloud", 16, 2048, 1, N_POINTS, 386),
              ("G = 16, 32 clouds", 512, 2048, 32, N_POINTS, 386),
              ("G = 1, 1 cloud", 1, PRED_N, 1, N_POINTS, SEEDED_PICKS),
              ("PU-GAN union", 1, 79872, 1, 5000, 300),
              ("ragged", 3, 150, 3, 33, 20))
    for label, R, M, Bs, S, m in shapes:
        for kind, make in (("integer", lambda *sh: rng.randint(0, 11, sh)),
                           ("float", lambda *sh: rng.rand(*sh))):
            xyz = torch.from_numpy(make(R, M, 3).astype(np.float32)).cuda()
            sd = torch.from_numpy(make(Bs, S, 3).astype(np.float32)).cuda()
            check_fps_seeded(f"{label}, {kind}", xyz, sd, m)
    # ties: every candidate twice, the seeds among them
    base = rng.rand(4, 1024, 3).astype(np.float32)
    dup = torch.from_numpy(np.concatenate([base, base[:, ::-1]], 1)).cuda()
    check_fps_seeded("duplicates", dup, dup[:, ::64].contiguous(), 1500)

    for label, R, M, Bs, S, m in shapes[:3]:
        xyz = torch.from_numpy(rng.rand(R, M, 3).astype(np.float32)).cuda()
        sd = torch.from_numpy(rng.rand(Bs, S, 3).astype(np.float32)).cuda()
        out = torch.empty((R, m), dtype=torch.int32, device="cuda")
        mind = torch.empty((R, M), dtype=torch.float32, device="cuda")
        fps_ops._seeded_launch(xyz, sd, out, mind, phases=1)
        seeding = time_ms(
            lambda: fps_ops._seeded_launch(xyz, sd, out, mind, phases=1), 20)
        # the cache fits in shared memory here: selection leaves mind as is
        selection = time_ms(
            lambda: fps_ops._seeded_launch(xyz, sd, out, mind, phases=2), 5)
        k1 = time_ms(lambda: farthest_point_sample_seeded(xyz, sd, m), 5)
        p1 = time_ms(lambda: farthest_point_sample_seeded_plain(xyz, sd, m),
                     1)
        k2 = time_ms(lambda: farthest_point_sample_seeded(xyz, sd, m), 5)
        entry = dict(results["fps_seeded"])
        # bytes: candidates, seeds and picks once; operations: 9 a
        # candidate-seed pair, 9 a candidate and step
        set_bound(entry, nbytes(xyz, sd, out), 9 * R * M * S + 9 * R * M * m)
        log(f"fps_seeded {label} [{R}, {M}], seeds [{Bs}, {S}] -> {m}: "
            f"kernel {k1:.4f} / {k2:.4f} ms (seeding {seeding:.4f}, "
            f"selection {selection:.4f}), plain {p1:.4f} ms, bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")
        if R == 512:     # the kernel line: 32 clouds, bench.py's batch
            results["fps_seeded"].update(
                ms=(k1 + k2) / 2, plain_ms=p1, library_ms=None,
                bound_ms=entry["bound_ms"], bound_by=entry["bound_by"])


TIMED_MERGES = (("union (default)", {}),
                ("seeded, auto G", dict(seeded_merge=True, merge_groups=0)),
                ("seeded, G = 1", dict(seeded_merge=True, merge_groups=1)),
                ("union, Morton G = 16", dict(merge_groups=16)))


def phase_merge_timing(model, card):
    """Merge-stage ms and whole-pipeline clouds/s of the folded discrete
    model for each merge, with CUDA events, median of 3; the Chamfer
    distance of each opt-in output to the union output is information,
    not a gate (the weights are seeded)."""
    for B in (1, 32):
        pc = synthetic_clouds(B, SEED + 40 + B)
        union_out = None
        for label, merge in TIMED_MERGES:
            merge_ms, totals = [], []
            with torch.no_grad():
                out, _, _ = pipeline_staged(model, pc, merge=merge)  # warm-up
                torch.cuda.synchronize()
                for _ in range(3):
                    events = []

                    def mark(stage, events=events):
                        ev = torch.cuda.Event(enable_timing=True)
                        ev.record()
                        events.append((stage, ev))

                    t0 = time.perf_counter()
                    pipeline_staged(model, pc, mark=mark, merge=merge)
                    torch.cuda.synchronize()
                    totals.append(time.perf_counter() - t0)
                    # from the model's last stage to the merged cloud
                    at = [k for k, _ in events].index("merge_fps")
                    merge_ms.append(events[at - 1][1].elapsed_time(
                        events[at][1]))
            total = statistics.median(totals)
            if union_out is None:
                union_out, cd = out, 0.0
            else:
                cd = chamfer(out, union_out)
            log(f"merge timing B={B} {label}: merge stage "
                f"{statistics.median(merge_ms):.3f} ms, pipeline "
                f"{total * 1e3:.2f} ms, {B / total:.2f} clouds/s, chamfer to "
                f"the union output {cd:.3e} (information) on {card}")


def phase_merge_cli(model):
    """Save the seeded discrete model as `.npz` and run the upsample CLI
    with the merge flags (side by side); `--seeded_merge --exact` must
    write the same file as `--exact` alone."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m.npz")
        checkpoint.save_checkpoint(ckpt, *checkpoint.to_numpy_tree(model))
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        np.savetxt(os.path.join(src, "cloud.xyz"),
                   synthetic_clouds(1, SEED + 6)[0].cpu().numpy(), fmt="%.6f")
        runs = {"seeded": ["--seeded_merge"],
                "groups": ["--merge_groups", "16"],
                "exact_seeded": ["--exact", "--seeded_merge"],
                "exact": ["--exact"]}
        procs = {}
        t0 = time.perf_counter()
        for key, flags in runs.items():
            cmd = [sys.executable, "-m", "puflow_torch.cli.upsample",
                   "--source", src, "--target", os.path.join(tmp, key),
                   "--checkpoint", ckpt, "--device", "cuda", *flags]
            procs[key] = (cmd, subprocess.Popen(
                cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        for key, (cmd, proc) in procs.items():
            out, err = proc.communicate(timeout=600)
            log(f"upsample CLI ({time.perf_counter() - t0:.1f} s, exit "
                f"{proc.returncode}): {' '.join(cmd[3:])}: {out.strip()}")
            if proc.returncode != 0:
                raise AssertionError(f"upsample CLI {runs[key]} failed:\n"
                                     + err[-4000:])
            pts = np.loadtxt(os.path.join(tmp, key, "cloud.xyz"))
            if pts.shape != (N_POINTS * UPRATIO, 3) or not np.isfinite(
                    pts).all():
                raise AssertionError(f"upsample CLI {runs[key]} wrote "
                                     f"{pts.shape}")
        texts = {k: Path(tmp, k, "cloud.xyz").read_text()
                 for k in ("exact", "exact_seeded")}
        if texts["exact"] != texts["exact_seeded"]:
            raise AssertionError("--seeded_merge --exact wrote another file "
                                 "than --exact")
        log("upsample CLI: --seeded_merge and --merge_groups 16 wrote 8192 "
            "finite points; --seeded_merge --exact wrote the same file as "
            "--exact")


def _to64(tree):
    if isinstance(tree, dict):
        return {k: _to64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to64(v) for v in tree]
    return tree.double()


def rk4_witness_logp(layers, c, y, logp, t0, t1, steps: int) -> torch.Tensor:
    """`rk4_witness` of the log-density solve: classical RK4 of (y, logp)
    on `field_with_exact_div` in float64, returned as one tensor [.., 4]."""
    c = torch.repeat_interleave(c, y.shape[1] // c.shape[1], dim=1)
    f = continuous.field_with_exact_div(_to64(layers), c.double())
    s, t0, t1 = (y.double(), logp.double()), float(t0), float(t1)
    h = (t1 - t0) / steps

    def axpy(a, x, z):
        return tuple(u + a * v for u, v in zip(x, z))

    for i in range(steps):
        t = t0 + i * h
        k1 = f(t, s)
        k2 = f(t + h / 2, axpy(h / 2, s, k1))
        k3 = f(t + h / 2, axpy(h / 2, s, k2))
        k4 = f(t + h, axpy(h, s, k3))
        s = tuple(u + (h / 6) * (a + 2 * b + 2 * cc + d)
                  for u, a, b, cc, d in zip(s, k1, k2, k3, k4))
    return torch.cat(s, dim=-1)


def maxrel(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-8))


def seeded_cnf_model():
    """The full-width CNF model at its seeded initial weights, on the
    card."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    return checkpoint.from_numpy_tree(*checkpoint.to_numpy_tree(
        continuous.ContinuousModel(*continuous.init(gen, device="cpu"))),
        "cuda", model="cnf")


def training_solve_inputs(model):
    """The training path's block-solve inputs on 32 main-path patches: the
    unfolded CNF model's conditions, latents of the g path (R = 32,768), and
    the seeded and the perturbed blocks."""
    params, state = model.trees()
    x = main_path_patches(1)                       # [32, 256, 3]: R = 8,192
    cs = enc_ops.encoder_conditions_plain(params, x, knn_indices(x, x, K),
                                          state)
    rng = np.random.RandomState(SEED + 6)
    B, n = x.shape[:2]
    latents = torch.from_numpy(
        (rng.randn(B, n * UPRATIO, 3) * 0.5).astype(np.float32)).cuda()
    seeded = seeded_cnf_model().trees()[0]["flow_blocks"]
    return x, cs, latents, (("seeded", seeded),
                            ("perturbed", params["flow_blocks"]))


def compare_cnf_logp(model, results):
    """The log-density solve kernel against `cnf_solve_logp_plain` at the
    f path's shape (R = 8,192) in both directions, condition widths 32 and
    128: 5e-6 at seeded weights, where every step size is set by a clip;
    `SOLVER_TOL` and `witness_check` (on y and logp) at perturbed ones.
    Step counts equal and two kernel runs bit-equal everywhere."""
    x, cs, _, weights = training_solve_inputs(model)
    rng = np.random.RandomState(SEED + 7)
    logp0 = torch.from_numpy((rng.randn(*x.shape[:2], 1) * 0.1)
                             .astype(np.float32)).cuda()
    for label, blocks in weights:
        tol = 5e-6 if label == "seeded" else SOLVER_TOL
        for block in (0, 3):                       # condition widths 32, 128
            bp = blocks[block]
            T = bp["sqrt_end_time"] * bp["sqrt_end_time"]
            zero = torch.zeros_like(T)
            for t0, t1 in ((zero, T), (T, zero)):
                args = (bp["layers"], cs[block], x, logp0, t0, t1)
                (gy, glp), stats = cnf_ops.cnf_solve_logp(*args,
                                                          return_stats=True)
                again = torch.cat(cnf_ops.cnf_solve_logp(*args), -1)
                (ry, rlp), ref_stats = cnf_ops.cnf_solve_logp_plain(
                    *args, return_stats=True)
                got, ref = torch.cat([gy, glp], -1), torch.cat([ry, rlp], -1)
                torch.cuda.synchronize()
                steps = stats.tolist()
                log(f"cnf_solve_logp {label} weights, cdim "
                    f"{cs[block].shape[-1]}, R = 8,192, "
                    f"{'0 -> T' if float(t1) > float(t0) else 'T -> 0'}: "
                    f"steps kernel {steps}, plain {ref_stats}")
                if steps != [ref_stats["steps"], ref_stats["accepted"]]:
                    raise AssertionError("cnf_solve_logp: the kernel's step "
                                         "counts differ from the plain "
                                         "version's")
                if steps[0] >= continuous.MAX_STEPS_EVAL:
                    raise AssertionError("cnf_solve_logp: step budget used up")
                if not torch.equal(got, again):
                    raise AssertionError("cnf_solve_logp: two runs of the "
                                         "kernel are not bit-equal")
                check_close(results, "cnf_solve_logp", got, ref, tol)
                if label == "perturbed":
                    witness_check(args, got, ref, rk4_witness_logp,
                                  WITNESS_STEPS // 2, "cnf_solve_logp")

    # times and the bound, f direction at cdim 128: y and logp in and out,
    # the conditions, the layers; 1 + 6 field evaluations with the three
    # tangent chains a step attempted on every row, and the projections
    bp = weights[1][1][3]
    T = bp["sqrt_end_time"] * bp["sqrt_end_time"]
    args = (bp["layers"], cs[3], x, logp0, torch.zeros_like(T), T)
    # the four 64 x 64 products a row and evaluation (x1 W2, u1_k W2) count
    # at 3xTF32, the rest at the FP32 peak
    _, stats = cnf_ops.cnf_solve_logp(*args, return_stats=True)
    attempted, accepted = stats.tolist()
    rows = x.shape[0] * x.shape[1]
    evals = rows * (1 + 6 * attempted)
    log(f"cnf_solve_logp f, R = 8,192, cdim 128: steps [attempted, "
        f"accepted] [{attempted}, {accepted}], {1 + 6 * attempted} field "
        "evaluations a row")
    set_bound_3xtf32(results["cnf_solve_logp"],
                     2 * nbytes(x, logp0) + nbytes(cs[3])
                     + tree_bytes(bp["layers"]) + 8, 2 * evals * 4 * TC_MACS,
                     2 * (evals * (FIELD_MACS + TANGENT_MACS - 4 * TC_MACS)
                          + rows * cs[3].shape[-1] * (4 * 64 + 6)))
    time_pair(results, "cnf_solve_logp",
              lambda: cnf_ops.cnf_solve_logp(*args),
              lambda: cnf_ops.cnf_solve_logp_plain(*args), reps=5,
              plain_reps=1)


def adjoint_leaves(out) -> list:
    """(name, tensor) of y0, a0, dc and every parameter gradient."""
    y0, a0, dc, dlayers = out[:4]
    return [("y0", y0), ("a0", a0), ("dc", dc)] + [
        (f"layer{i}.{k}.{kk}", t) for i, p in enumerate(dlayers)
        for k, v in p.items() for kk, t in v.items()]


def compare_cnf_adjoint(model, results):
    """The adjoint kernel against `cnf_adjoint_bwd_plain` at the training
    path's shapes: with the trace for f (R = 8,192), without for g
    (R = 32,768, each condition row serving 4 rows), condition widths 32
    and 128, seeded and perturbed blocks. Gates: the JAX package's for its
    kernel (tests/test_cnf.py:216-336), 2e-3 max-relative on y0, a0, dc
    and every parameter gradient, 5e-5 on the field and its trace at t1;
    equal step counts, two kernel runs bit-equal."""
    x, cs, latents, weights = training_solve_inputs(model)
    rng = np.random.RandomState(SEED + 8)

    def rand(shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32)).cuda()

    def case(blocks, block, path):
        """(args, keywords) of one backward solve of the path."""
        bp = blocks[block]
        T = bp["sqrt_end_time"] * bp["sqrt_end_time"]
        zero = torch.zeros_like(T)
        y1 = x if path == "f" else latents
        a1 = rand(y1.shape, 0.3)
        if path == "f":          # forward 0 -> T, so backward T -> 0
            ap = rand(y1.shape[:2] + (1,), 0.3)
            kw = dict(with_trace=True, logp1=rand(y1.shape[:2] + (1,), 0.1))
            t0, t1 = zero, T
        else:                    # forward T -> 0, backward 0 -> T
            ap = torch.zeros(y1.shape[:2] + (1,), device=y1.device)
            kw = dict(with_trace=False)
            t0, t1 = T, zero
        return (bp["layers"], cs[block], y1, a1, ap, t0, t1), kw

    for label, blocks in weights:
        for path in ("f", "g"):
            for block in (0, 3):
                args, kw = case(blocks, block, path)
                got = cnf_ops.cnf_adjoint_bwd(*args, **kw, return_stats=True)
                again = cnf_ops.cnf_adjoint_bwd(*args, **kw)
                ref = cnf_ops.cnf_adjoint_bwd_plain(*args, **kw,
                                                    return_stats=True)
                torch.cuda.synchronize()
                steps, ref_stats = got[-1].tolist(), ref[-1]
                rows = args[2].shape[0] * args[2].shape[1]
                log(f"cnf_adjoint_bwd {label} weights, {path} path "
                    f"(trace {kw['with_trace']}), cdim "
                    f"{cs[block].shape[-1]}, R = {rows}: steps kernel "
                    f"{steps}, plain {ref_stats}")
                if steps != [ref_stats["steps"], ref_stats["accepted"]]:
                    raise AssertionError("cnf_adjoint_bwd: the kernel's step "
                                         "counts differ from the plain "
                                         "version's")
                if steps[0] >= continuous.MAX_STEPS_EVAL:
                    raise AssertionError("cnf_adjoint_bwd: step budget used "
                                         "up")
                worst = ("", 0.0)
                for (name, g), (_, a), (_, r) in zip(adjoint_leaves(got),
                                                     adjoint_leaves(again),
                                                     adjoint_leaves(ref)):
                    if not torch.equal(g, a):
                        raise AssertionError(f"cnf_adjoint_bwd {name}: two "
                                             "kernel runs are not bit-equal")
                    rel = maxrel(g, r)
                    if not rel < 2e-3:
                        raise AssertionError(f"cnf_adjoint_bwd {name}: "
                                             f"max-relative {rel} >= 2e-3")
                    worst = max(worst, (name, rel), key=lambda w: w[1])
                    e = results["cnf_adjoint_bwd"]
                    e["max_abs_err"] = max(e.get("max_abs_err", 0.0),
                                           float((g - r).abs().max()))
                f1, div1 = got[4][:2]
                rel_f1 = maxrel(f1, ref[4][0])
                rel_div1 = maxrel(div1, ref[4][1]) if kw["with_trace"] else 0.0
                log(f"  worst max-relative {worst[1]:.3e} ({worst[0]}; gate "
                    f"2e-3); f1 {rel_f1:.3e}, div1 {rel_div1:.3e} (gate 5e-5)")
                if not (rel_f1 < 5e-5 and rel_div1 < 5e-5):
                    raise AssertionError("cnf_adjoint_bwd: the boundary "
                                         "fields differ from the plain "
                                         "version's")

    # times and the bound at cdim 128, perturbed: the inputs and outputs
    # once; 1 + 6 augmented-field evaluations a step attempted on every row
    # (the field, with the trace its tangent chains, and the vjp), the two
    # products of the projections' cotangents once a step (Wc Q per row of
    # y, c^T Q per condition row, Q summed over its repeats; for Q5 and
    # QE), one more field evaluation at t0, and the projections. The
    # 64 x 64 layer's products and the condition products count at 3xTF32
    # on the tensor cores, the rest at the FP32 peak (`set_bound_3xtf32`).
    # The kernel line keeps the f path, with the trace.
    for path in ("g", "f"):
        args, kw = case(weights[1][1], 3, path)
        trace = kw["with_trace"]
        out = cnf_ops.cnf_adjoint_bwd(*args, **kw, return_stats=True)
        attempted = out[-1].tolist()[0]
        y1, cdim = args[2], args[1].shape[-1]
        rows = y1.shape[0] * y1.shape[1]
        cond_rows = args[1].shape[0] * args[1].shape[1]
        per_eval = FIELD_MACS + VJP_MACS + (
            TANGENT_MACS + VJP_TRACE_MACS if trace else 0)
        tc_eval = ADJ_TC_MACS + (ADJ_TC_TRACE_MACS if trace else 0)
        tc_t0 = 64 * 64 * (4 if trace else 1)
        tc_macs = (rows * ((1 + 6 * attempted) * tc_eval + tc_t0)
                   + attempted * 2 * 262 * cdim * (rows + cond_rows))
        macs = (rows * ((1 + 6 * attempted) * per_eval
                        + FIELD_MACS + (TANGENT_MACS if trace else 0))
                + attempted * 2 * 262 * cdim * (rows + cond_rows)
                + cond_rows * cdim * 262)
        n_bytes = (2 * nbytes(y1, args[3]) + nbytes(args[1], out[2])
                   + 2 * tree_bytes(args[0]) + rows * 8 * 4
                   + (2 * nbytes(args[4]) if trace else 0))
        set_bound_3xtf32(results["cnf_adjoint_bwd"], n_bytes, 2 * tc_macs,
                         2 * (macs - tc_macs))
        log(f"cnf_adjoint_bwd {path} path (trace {trace}), R = {rows}, cdim "
            f"{cdim}: {attempted} steps attempted, {1 + 6 * attempted} "
            f"augmented evaluations a row")
        time_pair(results, "cnf_adjoint_bwd",
                  lambda: cnf_ops.cnf_adjoint_bwd(*args, **kw),
                  lambda: cnf_ops.cnf_adjoint_bwd_plain(*args, **kw),
                  reps=3, plain_reps=1)


def tree_paths(tree, prefix: str = "") -> list:
    """(path, leaf) of a nested dict / list tree in flattening order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in tree_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def cnf_grad_loss(params, state, sparse, dense, plain: bool, smooth: bool):
    """The training loss through `continuous.forward(train=True)`: 1e-4
    NLL + 5e-2 EMD, or with ``smooth`` the NLL plus the mean square of the
    dense cloud; ``plain`` runs the solves and the EMD on their plain
    versions."""
    cfg = TrainConfig()
    solves = continuous.training_solves(
        cnf_ops.cnf_solve_logp_plain, cnf_ops.cnf_solve_plain,
        cnf_ops.cnf_adjoint_bwd_plain) if plain else contextlib.nullcontext()
    with solves:
        pred, nll, _ = continuous.forward(params, state, sparse, UPRATIO,
                                          train=True)
    if smooth:
        return nll + torch.mean(pred ** 2)
    emd_fn = emd_auction_plain if plain else emd_auction
    dist, _ = emd_fn(pred, dense, cfg.emd_eps, cfg.emd_iters)
    return nll * cfg.logpx_weight + torch.sum(dist) * cfg.emd_weight


def cnf_grad_inputs():
    """The full-width CNF model at seeded weights (its parameter leaves
    requiring grad) and a batch at `bench.py:bench_cnf_train`'s shape
    (batch 32, 256 -> 1024 points) -> (params, state, sparse, dense)."""
    params, state = seeded_cnf_model().trees()
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    sp, de = synthetic_pairs(np.random.RandomState(1), TRAIN_B, TRAIN_N,
                             UPRATIO)
    return params, state, torch.from_numpy(sp).cuda(), torch.from_numpy(
        de).cuda()


def cnf_grad_ms(params, state, sparse, dense, plain):
    """Host ms of one training loss's forward and of its gradients'
    backward (`cnf_grad_loss`), each ending in a synchronize."""
    leaves = [t for _, t in tree_paths(params)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = cnf_grad_loss(params, state, sparse, dense, plain, False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def phase_cnf_grad(results, card):
    """One training loss's gradients through the full-width CNF model at
    seeded weights and `bench.py:bench_cnf_train`'s shape (batch 32, 256 ->
    1024 points)."""
    params, state, sparse, dense = cnf_grad_inputs()
    paths = tree_paths(params)
    leaves = [t for _, t in paths]

    logged = ("cnf_solve_logp", "cnf_solve", "cnf_adjoint_bwd")
    for fn in WRAPPERS.values():
        fn.launches = 0
    for k in logged:
        WRAPPERS[k].stats_log = []
    t0 = time.perf_counter()
    loss = cnf_grad_loss(params, state, sparse, dense, False, False)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in WRAPPERS.items()}
    stats = {k: solve_steps(WRAPPERS[k].stats_log) for k in logged}
    for k in logged:
        WRAPPERS[k].stats_log = None
    log(f"cnf_grad main path (batch {TRAIN_B}, {TRAIN_N} -> "
        f"{TRAIN_N * UPRATIO} points, seeded weights; {first_s:.2f} s with "
        f"the first launches): loss {float(loss.detach()):.6f}, launches "
        f"{launches}")
    for k, n in GRAD_LAUNCHES.items():
        if launches[k] != n:
            raise AssertionError(f"cnf_grad: {launches[k]} {k} launches in "
                                 f"one loss's gradient, not {n}")
        if COUNT_FROM[k] == "cnf_grad":
            results[k]["launches"] = launches[k]
    for k in logged:
        log(f"cnf_grad [attempted, accepted] steps of {k}: {stats[k]}")
    bad = [p for (p, _), g in zip(paths, grads)
           if not bool(torch.isfinite(g).all())]
    if bad or not bool(torch.isfinite(loss)):
        raise AssertionError(f"cnf_grad: non-finite loss or gradients {bad}")
    log(f"cnf_grad: the loss and all {len(grads)} gradient leaves finite")

    # the smooth loss on the kernels and on the plain versions; the biases
    # before train-mode BN, whose gradient is zero but for rounding, must be
    # so on both sides, and no leaf of a CNF block may be among them
    sm = {}
    for plain in (False, True):
        loss = cnf_grad_loss(params, state, sparse, dense, plain, True)
        sm[plain] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    names = [p for p, _ in paths]
    zero_kernel = rounding_zero(names, sm[False][1])
    zero_plain = rounding_zero(names, sm[True][1])
    if set(zero_plain) != set(zero_kernel):
        raise AssertionError(
            "cnf_grad: the leaves zero to rounding differ between kernels "
            "and plain versions: "
            f"{sorted(set(zero_plain) ^ set(zero_kernel))}")
    in_blocks = [p for p in zero_plain if p.startswith("/flow_blocks/")]
    if in_blocks:
        raise AssertionError(f"cnf_grad: CNF-block leaves zero to rounding "
                             f"{in_blocks}")
    worst = ("", 0.0)
    for path, gk, gp in zip(names, sm[False][1], sm[True][1]):
        if path in zero_plain:
            continue
        rel = maxrel(gk, gp)
        if not rel < 2e-2:
            raise AssertionError(f"cnf_grad {path}: kernels vs plain "
                                 f"max-relative {rel} >= 2e-2")
        worst = max(worst, (path, rel), key=lambda w: w[1])
    log(f"cnf_grad smooth loss (NLL + mean square of the dense cloud) "
        f"{sm[False][0]:.6f} on kernels, {sm[True][0]:.6f} on plain "
        f"versions; {len(paths) - len(zero_plain)} leaves within 2e-2 "
        f"max-relative (worst {worst[1]:.3e}, {worst[0]}); zero to rounding "
        f"on both sides (largest entry / the layer weight's, below "
        f"{ROUNDING_ZERO:g}), kernels vs plain: "
        + ", ".join(f"{p} {zero_kernel[p]:.2e} vs {r:.2e}"
                    for p, r in zero_plain.items()))

    def forward_backward(plain):
        return cnf_grad_ms(params, state, sparse, dense, plain)

    runs = [forward_backward(False) for _ in range(3)]
    fwd = statistics.median(r[0] for r in runs)
    bwd = statistics.median(r[1] for r in runs)
    log(f"cnf_grad on kernels, ms (median of 3): forward {fwd:.3f}, backward "
        f"{bwd:.3f}, total {fwd + bwd:.3f} on {card}")
    pf, pb = forward_backward(True)
    log(f"cnf_grad on plain versions, ms (one run): forward {pf:.3f}, "
        f"backward {pb:.3f}, total {pf + pb:.3f} on {card}")
    trace_idle("cnf_grad loss forward + backward on kernels",
               lambda: forward_backward(False), (fwd + bwd) / 1e3)
    cnf_kernel_ms(lambda: forward_backward(False))


def cnf_kernel_ms(fn):
    """The device ms of each CNF kernel in one call of ``fn`` (a loss's
    forward and backward) from torch.profiler, and its share of the card's
    busy time in it."""
    from torch.profiler import ProfilerActivity, profile

    names = {"cnf_solve_logp (f forward)": ("solve_kernel<true",),
             "cnf_solve (g forward)": ("solve_kernel<false",),
             "cnf_adjoint_bwd with the trace (f)": ("cnf_adjoint_kernel",
                                                    "<true>"),
             "cnf_adjoint_bwd without (g)": ("cnf_adjoint_kernel",
                                             "<false>")}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    parts = []
    for label, pattern in names.items():
        hits = [stop - start for start, stop, name in spans
                if all(p in name for p in pattern)]
        us = sum(hits)
        parts.append(f"{label} {us / 1e3:.3f} ms in {len(hits)} launches "
                     f"({us / busy_us:.1%})")
    log(f"cnf_grad one loss on kernels, device ms by CNF kernel (profiler; "
        f"busy {busy_us / 1e3:.3f} ms): " + "; ".join(parts))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    card = card_line()
    log(card)
    # `import puflow_torch` pins exact float32 (no TF32)
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 is on after import puflow_torch")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib, compile_s = _build.build()
    _build.library()
    log(f"kernel build: {compile_s:.2f} s nvcc, {time.perf_counter() - t0:.2f}"
        f" s with load ({lib.name})")

    results = {name: dict(name=name, **meta) for name, meta in KERNELS.items()}
    model, folded = seeded_models()
    rng = np.random.RandomState(SEED)
    with torch.no_grad():
        compare_fps(results, rng)
        x = main_path_patches(8)                   # 256 patches x 256
        compare_folded(folded, x, results, rng)
        compare_flows(model, x, results)
    phase_main_path("folded", folded, results)
    phase_main_path("exact", model, results)
    phase_timing("folded", folded, card)
    phase_timing("exact", model, card)
    params, state, sparse, dense = training_inputs(model)
    phase_emd(results, params, state, sparse, dense)
    phase_train(results, params, state, sparse, dense, card)
    phase_cli()
    phase_large_patch(results, model, folded)

    cnf_model, cnf_folded = seeded_models("cnf")
    with torch.no_grad():
        compare_cnf(cnf_model, results)
    phase_main_path("cnf_folded", cnf_folded, results)
    phase_main_path("cnf_exact", cnf_model, results)
    phase_cnf_bench("cnf_folded", cnf_folded, card)
    phase_cnf_bench("cnf_exact", cnf_model, card)
    phase_timing("cnf_folded", cnf_folded, card, batches=(1, 8))
    phase_timing("cnf_exact", cnf_model, card, batches=(8,))
    phase_cnf_cli(cnf_model)

    with torch.no_grad():
        compare_fps_seeded(results, rng)
    for name in ("seeded_merge", "union_groups"):
        for batch in (1, 32):
            phase_main_path(name, folded, results, batch=batch)
    phase_main_path("cnf_seeded_merge", cnf_folded, results, batch=1)
    phase_merge_timing(folded, card)
    phase_merge_cli(model)

    with torch.no_grad():
        compare_cnf_logp(cnf_model, results)
        compare_cnf_adjoint(cnf_model, results)
    phase_cnf_grad(results, card)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: results[name][k] for k in keys}
                                for name in KERNELS]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
