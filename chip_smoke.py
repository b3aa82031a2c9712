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
adjoint the hand-written adjoint kernel, with and without the trace. Last
it trains the CNF model with the trainer (those kernels and the EMD every
step; its validation's f solves on the log-density kernel) and runs the
CNF, PU-GAN and PUGeo train CLIs. Last it runs the evaluation protocol
(`scripts/eval_fixtures_torch.sh`) on the seeded models written as the
reference's `.pt` checkpoints: upsample on the folded path's kernels,
the p2f tool, and `cli.evaluate` with its approx-match EMD on the card.
Last it trains the discrete model data parallel on two ranks that share
the card (each rank's step launches the EMD kernel) and upsamples with the
clouds sharded over them (each rank launches the folded path's kernels),
then serves the CNF family so, with its validation NLL: every block-solve
runs the whole-solve kernels' per-attempt mode, one launch an attempt,
with the ranks' error sums exchanged between launches so that both ranks
take the one-process run's steps; and trains the CNF model data parallel
the same way: every forward solve and every backward solve of the
continuous adjoint in its kernel's per-attempt mode, the adjoint's ranks
exchanging every entry of the layers' gradient sums each attempt, two
ranks' gradients bit-equal and each solve's steps the one-process run's,
and `train_cnf` under torchrun. Last it runs the library surface that has no kernel of its own: the spline
couplings, the folding net and its point-order helper, `profile_trace`
around the folded path, `hausdorff_distance`.
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
     two runs bit-equal) under every plan of its selection (a block a row,
     a cluster a row, the global cache) at the seeded merge's shapes and
     more, and times its seeding and selection apart, each plan's
     selection, beside the parent kernel's recorded times;
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
 18. runs `continuous.forward(train=False)` (the CNF validation's NLL) at
     32 main-path patches on the seeded and the perturbed model: 6
     log-density and 6 solve launches; each solve of the plain path given
     to its kernel on the same inputs (equal step counts, 5e-6 seeded,
     5e-5 and the float64 witness perturbed); the NLL and the dense cloud
     against the plain path;
 19. trains the CNF model with `Trainer(..., forward_fn=continuous.forward)`
     at `bench.py:bench_cnf_train`'s shape: the first step's forward and
     EMD against the plain versions', 5 warm-up steps and 5 timed windows
     of 10 steps with the launch counts set to 0 before and read after (6
     log-density solves, 6 plain solves, 12 adjoint solves, 1 EMD a step;
     steps/s, a split per step, peak memory, one traced step), then
     `validate` on 2 batches (6 + 6 launches a batch) against the plain
     solves;
 20. runs `train_cnf` and `train_pugan` on 2 synthetic steps and
     `train_pugeo` on tfrecord shards it writes, then serves one cloud with
     the CNF checkpoint, BN folded, with the cnf_folded path's launches;
 21. writes the seeded discrete and CNF models as reference `.pt` files
     (and `.npz`), converts each back bit-equal, runs the protocol script
     on each at PU1K's 2048 -> 8192 points (2 fixture shapes: upsample ->
     p2f `--uniform` -> `cli.evaluate` on the card), checks that the
     discrete `.pt` and `.npz` upsample outputs are byte-identical, that
     the converted model launches the folded path's six kernels and
     serves as the seeded one, that every `evaluation.csv` column is
     filled and finite, and that `cli.evaluate --device cpu` agrees (CD,
     HD within 2e-6, EMD within 1e-5 relative, the rest equal); prints
     each stage's seconds, evaluate's ms a file by metric (also in this
     process on one pair at PU-GAN's 20,000 points) and `earth_mover`'s
     ms and peak memory at 8,192 and 20,000 points;
 22. exports the folded discrete and CNF patch samplers (symbolic batch)
     and cloud upsamplers (8 clouds and 1) with `puflow_torch.serving`,
     and runs `python -m puflow_torch.cli.export` for both kinds on a
     seeded `.npz`; loads the six `.pt2` files in a fresh process that
     imports torch and `puflow_torch.serving` alone, calls the discrete
     sampler at 1, 32 and 256 patches and the others on their inputs
     with the launch counts set to 0 before and read after (the folded
     path's five kernels once a sampler call, FPS twice more a cloud
     call; the CNF's solve 12 times, encoder and head once), holds each
     output to the live path (samplers atol 1e-6, clouds Chamfer < 5e-5)
     and two calls of one artifact bit-equal; prints each export's
     seconds and MB, each artifact's ms beside the live path's (in
     turns, one process) and each op's host dispatch beside its direct
     ctypes launch;
 23. trains the discrete model data parallel (`puflow_torch.parallel`):
     two ranks spawned on the one card with `gloo` take the first-step
     gradient at one cloud a rank (held to the one-process gradient at
     the JAX package's gate, at the one-process run's EMD assignment; the
     assignments each run's own auction takes are counted), 10 steps at
     global batch 32 (parameters, BN state and Adam moments bit-equal
     across ranks after every step, one EMD launch a step a rank, each
     rank's split with the gradient all-reduce's ms) and
     `upsample_cloud_sharded` of 8 clouds on the folded path's six
     kernels (each rank's shard bit-equal to its clouds alone, Chamfer <
     1e-4 against the one-process run, ms a call); one NCCL rank at world
     size 1 keeps the plain trainer's bits over 3 steps; with more cards
     the same under NCCL across up to 4;
 24. serves the CNF family data parallel (`phase_cnf_data_parallel`): two
     `gloo` ranks on the card run `upsample_cloud_sharded` of 8 clouds on
     the folded model and `continuous.forward(train=False)` on 32
     main-path patches of the unfolded one, at seeded and perturbed
     weights, every solve in the per-attempt mode: ranks bit-equal, each
     solve's [attempted, accepted] the one-process run's, the predictions
     and the dense clouds within atol 1e-4 of it, the NLL within rtol
     1e-5, the merged clouds within Chamfer 1e-4, one launch an attempt
     and one to finish counted on each rank, ms a call; one NCCL rank at
     world size 1 holds the per-attempt mode of both entries bit-equal to
     the one-launch kernel at R = 8,192 (f, log-density) and 32,768 (g, r
     = 4) and to the plain versions at `compare_cnf`'s gates, and times a
     solve with and without the exchange beside the one-launch kernel,
     with each mode's device time; with more cards the two-rank checks
     under NCCL across up to 4;
 25. trains the CNF family data parallel (`phase_cnf_train_data_parallel`):
     one NCCL rank at world size 1 (in this process) holds the adjoint's
     per-attempt mode bit-equal to the one-launch kernel (y0, a0, dc, G,
     the boundary fields, the stats; two runs) at the f (R = 8,192,
     trace) and g (R = 32,768, r = 4) shapes, seeded and perturbed, with
     one launch an attempt plus one, the one-launch kernel within 2e-3 of
     the plain version there (or no farther than it from the plain
     version in float64), and times a solve with and without the exchange
     beside the one-launch kernel, with each mode's device time; two
     `gloo` ranks on the card take the CNF loss's gradient at the seeded
     model and batch 32 (ranks bit-equal, each of the 24 solves' steps the
     one-process run's, the summed gradient within `phase_cnf_grad`'s
     gates of one process's at one auction assignment) and 3 trainer
     steps (parameters bit-equal across ranks, 6 + 6 + 12 solves and one
     EMD a step a rank, each rank's split with its exchanges' ms); then
     `torchrun --nproc_per_node 2 -m puflow_torch.cli.train_cnf` for one
     epoch of 2 synthetic steps, rank 0 writing the checkpoint; with more
     cards the two-rank checks under NCCL across up to 4;
 26. runs the library surface (`phase_library`, no kernel of its own): the
     three spline couplings at the discrete flow's widths (3 channels split
     1 and 2, hidden 64, conditions of 128, 64 bins, tail bound 5) on 32
     patches of 256 points and the inverse on 1,024 (x4), forward then
     inverse within JAX's round-trip gates, each direction held to the
     CPU's float64 at the CPU tests' gates, ms a call; the folding net
     trained 150 steps (the loss falls, shuffled input moves no reference
     point, the `.npz` helper permutes as the in-memory net);
     `profile_trace` around one folded `upsample_cloud` of 8 clouds (the
     trace holds the port's kernels); `hausdorff_distance` on the card
     against the CPU (2e-6);
 27. prints its total seconds, one JSON line of kernel results and, last,
     the device line.

Any failed check raises, and the script exits non-zero. It needs CUDA and
refuses to run without it.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_map

from puflow_torch import checkpoint, parallel, serving
from puflow_torch.cli import evaluate
from puflow_torch.convert import torch_ckpt
from puflow_torch.data import tfrecord
from puflow_torch.data.synthetic import synthetic_pairs
from puflow_torch.flows import spline_coupling
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
from puflow_torch.ops.approx_match import earth_mover
from puflow_torch.ops.chamfer import (chamfer_distance, chamfer_parts,
                                      hausdorff_distance)
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
from puflow_torch.utils import folding, permute
from puflow_torch.utils.timers import profile_trace

# the reference-format checkpoint writer the CPU tests use (no jax)
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_ckpt_cases import save_reference_checkpoint  # noqa: E402
from torch_op_cases import DIRECT as OP_DIRECT  # noqa: E402
from torch_parallel_cases import (card_train_rank, gradients,  # noqa: E402
                                  nccl_one_rank, recording_emd, run_ranks,
                                  seeded_first_step, upsample_one_process)
from torch_parallel_cnf_cases import (adjoint_outputs,  # noqa: E402
                                      attempt_adjoint_rank,
                                      attempt_solves_rank, card_cnf_rank,
                                      card_cnf_train_rank, cnf_eval_one_process,
                                      cnf_grad, cnf_trainer,
                                      cnf_upsample_one_process)
from torch_spline_cases import (KINDS as SPLINE_KINDS,  # noqa: E402
                                check_direction, coupling_case, lanes)

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
    # the solves' per-attempt mode (`puflow_cnf_solve_attempt`, the kernel
    # in `csrc/cnf_solve.cuh`; data parallel): a launch an attempt, the
    # ranks' error sums exchanged between
    "cnf_solve_attempt": {"route": "cuda",
                          "source": "puflow_torch/csrc/cnf_solve_attempt.cu",
                          "replaces": PALLAS + "cnf_pallas.py:372"},
    "cnf_solve_logp_attempt": {
        "route": "cuda", "source": "puflow_torch/csrc/cnf_solve_attempt.cu",
        "replaces": PALLAS + "cnf_pallas.py:281"},
    # the adjoint's per-attempt mode (`puflow_cnf_adjoint_attempt`, the
    # kernel in `csrc/cnf_adjoint.cuh`; data-parallel training): a launch
    # an attempt, the ranks' sums of every G entry exchanged between
    "cnf_adjoint_bwd_attempt": {
        "route": "cuda", "source": "puflow_torch/csrc/cnf_adjoint_attempt.cu",
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


def timed_steps(trainer, sparse, dense, warmup: int):
    """``warmup`` train steps, then `TRAIN_WINDOWS` windows of
    `TRAIN_STEPS` steps timed on the host clock, each step split by its
    marks with CUDA events; every launch count set to 0 before and read
    after -> (metrics of every step, window seconds, {stage: [ms]},
    launches, peak device bytes)."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = [trainer.step(sparse, dense) for _ in range(warmup)]
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
    return metrics, windows, splits, launches, peak


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

    metrics, windows, splits, launches, peak = timed_steps(
        trainer, sparse, dense, TRAIN_WARMUP)
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


def run_clis(*commands) -> None:
    """Run each ``(module, flags...)`` as ``python -m module --device cuda
    flags`` from the checkout, all at once (they share the card and the
    host's cores); raises unless every one exits with 0."""
    procs = []
    for module, *flags in commands:
        cmd = [sys.executable, "-m", module, "--device", "cuda", *flags]
        procs.append((cmd, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    failed = []
    try:
        for cmd, t0, proc in procs:
            out, err = proc.communicate(timeout=600)
            log(f"{cmd[2]} (ended within {time.perf_counter() - t0:.1f} s, "
                f"exit {proc.returncode}): {' '.join(cmd[3:])}")
            log(out.strip())
            if proc.returncode != 0:
                failed.append(f"{cmd[2]}:\n{err[-4000:]}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError("CLIs failed: " + "\n".join(failed))


def phase_cli():
    """Train with the CLI on the card, then serve what it saved."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "m.npz")
        run_clis(("puflow_torch.cli.train_pu1k", "--synthetic", "2",
                  "--max_epochs", "1", "--val_batches", "1", "--batch_size",
                  str(TRAIN_B), "--checkpoint", ckpt))
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
HUGE_PATCH = 32768   # one patch of a whole scan, for the streaming k-NN


def clustered_patch(rng, batch: int, n: int) -> torch.Tensor:
    """Patches of a dense cluster (sd 1e-3) with 2% of the points spread
    over a cube 4 wide around it: the cluster's tiles lie in a few cells of
    the spatial order, the far points' tiles span the patch."""
    pts = 0.5 + 1e-3 * rng.randn(batch, n, 3)
    pts = np.where(rng.rand(batch, n, 1) < 0.02,
                   rng.rand(batch, n, 3) * 4 - 2, pts)
    return torch.from_numpy(pts.astype(np.float32)).cuda()


# the streaming self k-NN's kernels, in launch order
STREAM_KERNELS = ("knn_cells_kernel", "knn_scatter_kernel",
                  "knn_stream_kernel")


def kernel_device_ms(fn, reps: int, names) -> dict:
    """Mean device ms a call of ``fn`` spends in the kernels whose names
    hold each of ``names``, from torch.profiler over ``reps`` calls after
    one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if name in e.name:
                ms[name] += (e.time_range.end - e.time_range.start) / 1e3
    return {name: t / reps for name, t in ms.items()}


def compare_knn_stream(results, x, big):
    """The streaming self k-NN (patches over shared memory) against the
    plain version: at the main path's 256 patches of 256 points (one lane
    a query), at one patch of `KNN_MAX_N` + 1 points (four; float, integer
    grid, repeated points, a cluster), at the CLI's 4 such patches and at
    one patch of `HUGE_PATCH` points; equal indices, two runs bit-equal.
    Timed at the three large shapes, each beside its plain version and its
    bound, in three more windows, with each kernel's device time from
    torch.profiler and the host's time to enqueue a call, and the
    shared-memory kernel at one patch of `KNN_MAX_N` points beside them."""
    n = big.shape[1]
    rng = np.random.RandomState(n)
    grid = torch.from_numpy(rng.randint(0, 31, (1, n, 3)).astype(
        np.float32)).cuda()
    wide = synthetic_clouds(4, SEED + 11, n)
    huge = synthetic_clouds(1, SEED + 12, HUGE_PATCH)
    for label, pts in (("float, 256 patches", x), ("float", big),
                       ("integer grid", grid),
                       ("repeated half",
                        repeated_half(np.random.RandomState(n), 1, n)),
                       ("clustered", clustered_patch(rng, 1, n)),
                       ("float, the CLI's 4 patches", wide),
                       ("float, one large patch", huge)):
        got, ref = knn_self_stream(pts, K), knn_self_plain(pts, K)
        torch.cuda.synchronize()
        if not bool((got == ref).all()):
            raise AssertionError(f"knn_self_stream {label}: "
                                 f"{int((got != ref).sum())} indices differ "
                                 "from the plain version")
        log(f"knn_self_stream {label} {tuple(pts.shape)} -> {K}: indices "
            "equal")
        check_rerun(f"knn_self_stream {label}", got, knn_self_stream(pts, K))
        del got, ref
    results["knn_self_stream"]["max_abs_err"] = 0.0

    def stream_bound(entry, pts):
        # the least any exact method needs: the patches read once, the rows
        # written once, and each returned neighbour's distance (8 flops)
        # and compare; all n^2 distances, as the plain version and the TPU
        # kernel compute them, returned beside it
        m, p = pts.shape[:2]
        set_bound(entry, nbytes(pts) + m * p * K * 8, 9 * m * p * K)
        brute = {}
        set_bound(brute, nbytes(pts) + m * p * K * 8, 9 * m * p * p)
        return brute["bound_ms"]

    card = card_line()
    for i, pts in enumerate((big, wide, huge)):
        entry = results["knn_self_stream"] if i == 0 else {}
        brute = stream_bound(entry, pts)
        time_pair({"knn_self_stream": entry}, "knn_self_stream",
                  lambda: knn_self_stream(pts, K),
                  lambda: knn_self_plain(pts, K), reps=5,
                  plain_reps=2 if i == 2 else 5)
        windows = [time_ms(lambda: knn_self_stream(pts, K), 10)
                   for _ in range(3)]
        split = kernel_device_ms(lambda: knn_self_stream(pts, K), 10,
                                 STREAM_KERNELS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            knn_self_stream(pts, K)
        host = (time.perf_counter() - t0) * 10
        torch.cuda.synchronize()
        log(f"knn_self_stream {list(pts.shape[:2])} -> {K}: kernel "
            f"{entry['ms']:.4f} ms, windows of 10 "
            f"{' / '.join(f'{t:.4f}' for t in windows)}; device ms a call "
            "(profiler) " + ", ".join(f"{name} {t:.4f}"
                                      for name, t in split.items())
            + f"; host {host:.4f} ms a call enqueued; plain "
            f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']}; all n^2 distances {brute:.4f}) on {card}")
    below = synthetic_clouds(1, SEED + 9, KNN_MAX_N)
    entry = {}
    brute = stream_bound(entry, below)
    time_pair({"knn_self": entry}, "knn_self", lambda: knn_self(below, K),
              lambda: knn_self_plain(below, K), reps=5)
    log(f"knn_self (shared memory) [1, {KNN_MAX_N}] -> {K}: kernel "
        f"{entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms (all n^2 distances {brute:.4f}) on "
        f"{card}")
    torch.cuda.empty_cache()


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
                        witness_check(args, got, ref,
                                      steps=WITNESS_STEPS // 4)
    blocks = params["flow_blocks"]

    # times and the bound (`solve_bound`; the FP32 bound in its log) at
    # the two shapes of `bench_cnf`'s sample, cdim 128
    for label, y, reverse in (("f, R = 8,192", x, False),
                              ("g, R = 32,768, r = 4", latents, True)):
        args = solve_args(blocks, 3, cs[3], y, reverse)
        _, stats = cnf_ops.cnf_solve_t(*args, return_stats=True)
        attempted, accepted = stats.tolist()
        log(f"cnf_solve {label}: steps [attempted, accepted] [{attempted}, "
            f"{accepted}], {1 + 6 * attempted} field evaluations a row")
        solve_bound(results["cnf_solve"], args[0], cs[3], y, attempted)
        # the kernel line keeps the last: the g solve
        time_pair(results, "cnf_solve", lambda: cnf_ops.cnf_solve_t(*args),
                  lambda: cnf_ops.cnf_solve_plain(*args), reps=5)


def solve_bound(entry, layers, c, y, attempted: int) -> None:
    """`cnf_solve`'s bound on these inputs: it reads y, c, the layers and
    t0, t1 and writes y(t1); it makes 1 + 6 field evaluations a step
    attempted on every row (4,480 multiply-adds each, 4,096 of them the 64
    x 64 product, counted at 3xTF32 on the tensor cores) and projects the
    conditions once."""
    evals = y.shape[0] * y.shape[1] * (1 + 6 * attempted)
    c_rows = c.shape[0] * c.shape[1]
    set_bound_3xtf32(entry, 2 * nbytes(y) + nbytes(c) + tree_bytes(layers)
                     + 8, 2 * evals * TC_MACS,
                     2 * (evals * (FIELD_MACS - TC_MACS)
                          + c_rows * c.shape[-1] * (4 * 64 + 6)))


def logp_bound(entry, layers, c, y, logp0, attempted: int) -> None:
    """`cnf_solve_logp`'s bound: y and logp in and out, the conditions,
    the layers; 1 + 6 field evaluations with the three tangent chains a
    step attempted on every row (the four 64 x 64 products, x1 W2 and u1_k
    W2, at 3xTF32, the rest at the FP32 peak), and the projections."""
    evals = y.shape[0] * y.shape[1] * (1 + 6 * attempted)
    c_rows = c.shape[0] * c.shape[1]
    set_bound_3xtf32(entry, 2 * nbytes(y, logp0) + nbytes(c)
                     + tree_bytes(layers) + 8, 2 * evals * 4 * TC_MACS,
                     2 * (evals * (FIELD_MACS + TANGENT_MACS - 4 * TC_MACS)
                          + c_rows * c.shape[-1] * (4 * 64 + 6)))


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


# the seeded selection's plans (`ops/fps.py:_fps_seeded_plan`): a block a
# row of 128-512 threads, a cluster a row of 2-16 blocks, and the
# global-scratch kernel
SEEDED_SWEEP = ([fps_ops.FpsPlan(1, t) for t in (128, 256, 512)]
                + [fps_ops.FpsPlan(c, t) for c in (2, 4, 8, 16)
                   for t in (128, 256)]
                + [fps_ops.SEEDED_GLOBAL])
# the parent kernel (one 1024-thread block a row, the cache in shared
# memory) at the three timed shapes, ms of seeding, selection and the
# whole kernel, as this script measured it before the block and cluster
# plans (PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700 W)
PARENT_SEEDED_MS = {"G = 16, 1 cloud": (0.0605, 0.4248, 0.4864),
                    "G = 16, 32 clouds": (0.6907, 1.4722, 2.1687),
                    "G = 1, 1 cloud": (0.0612, 33.5712, 33.6572)}


def plan_name(plan) -> str:
    if plan == fps_ops.SEEDED_GLOBAL:
        return "global"
    if plan.cluster == 1:
        return f"block T={plan.threads}"
    return f"C={plan.cluster} T={plan.threads}"


def check_fps_seeded(label, xyz, seeds, m):
    """The seeded-FPS kernel against its plain version under its own plan
    and under every plan of `SEEDED_SWEEP` that takes the shape, forced:
    equal indices, and a second run bit-equal to the first."""
    ref = farthest_point_sample_seeded_plain(xyz, seeds, m)
    plans = [None] + [p for p in SEEDED_SWEEP
                      if fps_ops._seeded_plan_covers(p, xyz.shape[1])]
    for plan in plans:
        got = farthest_point_sample_seeded(xyz, seeds, m, _plan=plan)
        again = farthest_point_sample_seeded(xyz, seeds, m, _plan=plan)
        torch.cuda.synchronize()
        name = "chosen" if plan is None else plan_name(plan)
        bad = (got != ref).any(dim=0).nonzero()
        if bad.numel():
            step = int(bad[0])
            raise AssertionError(
                f"fps_seeded {label} ({name}): indices differ first at step "
                f"{step}: kernel {got[:, step].tolist()[:8]} plain "
                f"{ref[:, step].tolist()[:8]}")
        if not torch.equal(got, again):
            raise AssertionError(f"fps_seeded {label} ({name}): two runs "
                                 "differ")
    chosen = fps_ops._fps_seeded_plan(xyz.shape[0], xyz.shape[1],
                                      functools.partial(
                                          fps_ops.seeded_capacity,
                                          xyz.device, xyz.shape[1]))
    log(f"fps_seeded {label} {tuple(xyz.shape)}, seeds "
        f"{tuple(seeds.shape)} -> {m}: indices equal, reruns bit-equal under "
        f"{len(plans) - 1} plans and the chosen one ({plan_name(chosen)})")


def issue_floor_ms(instructions: float) -> float:
    """FP32 instructions that cannot pair into FMAs over the card's issue
    rate: 128 lanes an SM, every SM, at its largest SM clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return instructions / (128 * sms * float(mhz) * 1e6) * 1e3


def compare_fps_seeded(results, rng):
    """`csrc/fps.cu:puflow_fps_seeded` against
    `farthest_point_sample_seeded_plain` under every plan, then its times
    at the seeded merge's three shapes: seeding and selection apart, each
    plan's selection (`SEEDED_SWEEP`), beside the parent's."""
    results["fps_seeded"]["max_abs_err"] = 0.0
    # (label, rows, candidates, seed sets, seeds, picks): the Morton cells
    # of the seeded merge at auto G = 16 (16 rows a cloud share its seed
    # set), its G = 1 row, a PU-GAN 5,000-point cloud's union at G = 1
    # (79,872 candidates), a ragged case
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
    # ties: every candidate twice, the seeds among them; then 27 distinct
    # candidates and more picks: the cache ends all zeros
    base = rng.rand(4, 1024, 3).astype(np.float32)
    dup = torch.from_numpy(np.concatenate([base, base[:, ::-1]], 1)).cuda()
    check_fps_seeded("duplicates", dup, dup[:, ::64].contiguous(), 1500)
    few = torch.from_numpy(rng.randint(0, 3, (16, 2048, 3)).astype(
        np.float32)).cuda()
    check_fps_seeded("exhausted", few, few[:1, :5].contiguous(), 386)

    for label, R, M, Bs, S, m in shapes[:3]:
        xyz = torch.from_numpy(rng.rand(R, M, 3).astype(np.float32)).cuda()
        sd = torch.from_numpy(rng.rand(Bs, S, 3).astype(np.float32)).cuda()
        out = torch.empty((R, m), dtype=torch.int32, device="cuda")
        mind = torch.empty((R, M), dtype=torch.float32, device="cuda")
        chosen = fps_ops._fps_seeded_plan(R, M, functools.partial(
            fps_ops.seeded_capacity, xyz.device, M))
        fps_ops._seeded_launch(xyz, sd, out, mind, phases=1)
        seeding = time_ms(
            lambda: fps_ops._seeded_launch(xyz, sd, out, mind, phases=1), 20)
        # the block and cluster plans leave mind as it is; the global plan
        # works on it in place, so its repeats time the same steps on a
        # spent cache
        sweep = {}
        for plan in SEEDED_SWEEP:
            if fps_ops._seeded_plan_covers(plan, M):
                sweep[plan] = time_ms(
                    lambda plan=plan: fps_ops._seeded_launch(
                        xyz, sd, out, mind, phases=2, plan=plan), 3)
                if plan != fps_ops.SEEDED_GLOBAL:
                    cap = fps_ops.seeded_capacity(xyz.device, M, plan)
                    at_once = f"{cap} rows at once"
                else:
                    at_once = "one 1024-thread block a row"
                log(f"fps_seeded sweep {label} [{R}, {M}] -> {m}: "
                    f"{plan_name(plan)} selection {sweep[plan]:.4f} ms, "
                    f"{sweep[plan] * 1e3 / m:.4f} us a step, {at_once}"
                    + (" (chosen)" if plan == chosen else ""))
        fps_ops._seeded_launch(xyz, sd, out, mind, phases=1)
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
        seed_b, select_b = dict(entry), dict(entry)
        set_bound(seed_b, nbytes(xyz, sd), 9 * R * M * S)
        set_bound(select_b, nbytes(xyz, out), 9 * R * M * m)
        ps, pl, pw = PARENT_SEEDED_MS[label]
        log(f"fps_seeded {label} [{R}, {M}], seeds [{Bs}, {S}] -> {m}: "
            f"kernel {k1:.4f} / {k2:.4f} ms (parent {pw:.4f}), seeding "
            f"{seeding:.4f} (parent {ps:.4f}), selection {selection:.4f} "
            f"(parent {pl:.4f}: {pl / selection:.2f}x) with "
            f"{plan_name(chosen)}; plain {p1:.4f} ms; bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}): seeding "
            f"{seed_b['bound_ms']:.4f} (FP32 issue floor "
            f"{issue_floor_ms(9 * R * M * S):.4f}), selection "
            f"{select_b['bound_ms']:.4f} (issue floor "
            f"{issue_floor_ms(9 * R * M * m):.4f})")
        if R == 512:     # the kernel line: 32 clouds, bench.py's batch
            results["fps_seeded"].update(
                ms=(k1 + k2) / 2, plain_ms=p1, library_ms=None,
                bound_ms=entry["bound_ms"], bound_by=entry["bound_by"])
    # the seeded merge at G = 1 and 32 clouds: 32 rows of 32,768
    capacity = functools.partial(fps_ops.seeded_capacity,
                                 torch.device("cuda"), PRED_N)
    plan = fps_ops._fps_seeded_plan(32, PRED_N, capacity)
    log(f"fps_seeded plan for [32, {PRED_N}] (G = 1, 32 clouds): "
        f"{plan_name(plan)}, {capacity(plan)} rows at once")


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
                                  WITNESS_STEPS // 8, "cnf_solve_logp")

    # times and the bound (`logp_bound`), f direction at cdim 128
    bp = weights[1][1][3]
    T = bp["sqrt_end_time"] * bp["sqrt_end_time"]
    args = (bp["layers"], cs[3], x, logp0, torch.zeros_like(T), T)
    _, stats = cnf_ops.cnf_solve_logp(*args, return_stats=True)
    attempted, accepted = stats.tolist()
    log(f"cnf_solve_logp f, R = 8,192, cdim 128: steps [attempted, "
        f"accepted] [{attempted}, {accepted}], {1 + 6 * attempted} field "
        "evaluations a row")
    logp_bound(results["cnf_solve_logp"], bp["layers"], cs[3], x, logp0,
               attempted)
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


def adjoint_case(inputs, rng, blocks, block, path):
    """(args, keywords) of one backward solve of the f path (with the
    trace, R = 8,192) or the g path (R = 32,768, r = 4) of block
    ``block`` of ``blocks`` on `training_solve_inputs`' ``inputs`` (x, cs,
    latents), the cotangents drawn from ``rng``."""
    x, cs, latents = inputs

    def rand(shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32)).cuda()

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


def adjoint_bound(entry, args, kw, out, attempted: int) -> None:
    """The bound of one backward solve (``out`` its outputs) that
    attempted ``attempted`` steps: the inputs and outputs once; 1 + 6
    augmented-field evaluations a step attempted on every row (the field,
    with the trace its tangent chains, and the vjp), the two products of
    the projections' cotangents once a step (Wc Q per row of y, c^T Q per
    condition row, Q summed over its repeats; for Q5 and QE), one more
    field evaluation at t0, and the projections. The 64 x 64 layer's
    products and the condition products count at 3xTF32 on the tensor
    cores, the rest at the FP32 peak (`set_bound_3xtf32`)."""
    trace = kw["with_trace"]
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
    set_bound_3xtf32(entry, n_bytes, 2 * tc_macs, 2 * (macs - tc_macs))


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

    def case(blocks, block, path):
        return adjoint_case((x, cs, latents), rng, blocks, block, path)

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

    # times and the bound (`adjoint_bound`) at cdim 128, perturbed; the
    # kernel line keeps the f path, with the trace
    for path in ("g", "f"):
        args, kw = case(weights[1][1], 3, path)
        trace = kw["with_trace"]
        out = cnf_ops.cnf_adjoint_bwd(*args, **kw, return_stats=True)
        attempted = out[-1].tolist()[0]
        rows, cdim = args[2].shape[0] * args[2].shape[1], args[1].shape[-1]
        adjoint_bound(results["cnf_adjoint_bwd"], args, kw, out, attempted)
        log(f"cnf_adjoint_bwd {path} path (trace {trace}), R = {rows}, cdim "
            f"{cdim}: {attempted} steps attempted, {1 + 6 * attempted} "
            f"augmented evaluations a row")
        time_pair(results, "cnf_adjoint_bwd",
                  lambda: cnf_ops.cnf_adjoint_bwd(*args, **kw),
                  lambda: cnf_ops.cnf_adjoint_bwd_plain(*args, **kw),
                  reps=3, plain_reps=1)


def recorded(fn, calls):
    """``fn`` (a plain solve) with its step counts: each call appends
    (args, output, [attempted, accepted]) to ``calls``."""
    def run(*args):
        out, stats = fn(*args, return_stats=True)
        calls.append((args, out, [stats["steps"], stats["accepted"]]))
        return out
    return run


def plain_solves(f_calls=None, g_calls=None):
    """`continuous.training_solves` with the plain versions of the three
    CNF kernels, recording the f and g solves where lists are given."""
    logp, solve = cnf_ops.cnf_solve_logp_plain, cnf_ops.cnf_solve_plain
    return continuous.training_solves(
        logp if f_calls is None else recorded(logp, f_calls),
        solve if g_calls is None else recorded(solve, g_calls),
        cnf_ops.cnf_adjoint_bwd_plain)


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
    with plain_solves() if plain else contextlib.nullcontext():
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


# the launches of one `continuous.forward(train=False)`: the six f solves
# with the log-density, the six g solves
EVAL_LAUNCHES = {"cnf_solve_logp": continuous.NUM_BLOCKS,
                 "cnf_solve": continuous.NUM_BLOCKS}
CNF_TRAIN_WARMUP = 5
CNF_VAL_BATCHES = 2


def gate(label, got, ref, tol) -> float:
    """Raise unless ``got`` lies within ``tol`` of ``ref``; -> the error."""
    err = float((got - ref).abs().max())
    log(f"  {label}: max_abs_err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{label}: max_abs_err {err} > {tol}")
    return err


def no_launch(label) -> None:
    """Raise if a kernel was launched since the counts were last set to 0
    (a run meant to take the plain versions only)."""
    launched = {k: fn.launches for k, fn in WRAPPERS.items() if fn.launches}
    if launched:
        raise AssertionError(f"{label}: kernels launched {launched}")


def phase_cnf_eval(model):
    """`continuous.forward(train=False)` (the CNF validation's NLL and
    dense cloud) on the kernels against the plain versions, at 32 main-path
    patches (R = 8,192 rows for f) on the seeded and the perturbed
    full-width model: 6 log-density and 6 plain solve launches a forward;
    every solve of the plain path given to its kernel on the same inputs
    with the same step counts, within 5e-6 at seeded weights and 5e-5 at
    perturbed ones, with `witness_check` on the first f solve there (128
    RK4 steps: the check holds the witness's own error below 1e-7; the g
    solves' kernel is `compare_cnf`'s); the plain path launches no CNF
    kernel; the NLL and the dense cloud of the two paths within the same
    gates. ``model``: the perturbed unfolded model."""
    x = main_path_patches(1)
    logged = ("cnf_solve_logp", "cnf_solve")
    for label, model in (("seeded", seeded_cnf_model()),
                         ("perturbed", model)):
        t0 = time.perf_counter()
        tol = 5e-6 if label == "seeded" else SOLVER_TOL
        params, state = model.trees()
        for fn in WRAPPERS.values():
            fn.launches = 0
        for k in logged:
            WRAPPERS[k].stats_log = []
        with torch.no_grad():
            dense, nll, _ = continuous.forward(params, state, x, UPRATIO)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in WRAPPERS.items()}
        stats = {k: solve_steps(WRAPPERS[k].stats_log) for k in logged}
        for k in logged:
            WRAPPERS[k].stats_log = None
        log(f"cnf_eval forward(train=False), {label} weights, "
            f"{tuple(x.shape)}: NLL {float(nll):.6f}, launches {launches}")
        expect = dict.fromkeys(WRAPPERS, 0) | EVAL_LAUNCHES
        if launches != expect:
            raise AssertionError(f"cnf_eval: launches {launches}, not "
                                 f"{expect}")
        f_calls, g_calls = [], []
        for fn in WRAPPERS.values():
            fn.launches = 0
        with torch.no_grad(), plain_solves(f_calls, g_calls):
            ref_dense, ref_nll, _ = continuous.forward(params, state, x,
                                                       UPRATIO)
        no_launch(f"cnf_eval {label} on the plain solves")
        log(f"cnf_eval {label}: [attempted, accepted] steps, kernels "
            f"{stats}, plain f {[c[2] for c in f_calls]}, plain g "
            f"{[c[2] for c in g_calls]}")
        for kind, calls, kernel in (("f", f_calls, cnf_ops.cnf_solve_logp),
                                    ("g", g_calls, cnf_ops.cnf_solve_t)):
            for i, (args, ref, steps) in enumerate(calls):
                got, st = kernel(*args, return_stats=True)
                if st.tolist() != steps:
                    raise AssertionError(
                        f"cnf_eval {label} {kind} solve {i}: kernel steps "
                        f"{st.tolist()}, plain {steps}")
                if kind == "f":
                    got, ref = torch.cat(got, -1), torch.cat(ref, -1)
                gate(f"{label} {kind} solve {i} on the plain path's inputs, "
                     f"steps {steps}", got, ref, tol)
                if label == "perturbed" and kind == "f" and i == 0:
                    witness_check(args[:6], got, ref, rk4_witness_logp,
                                  WITNESS_STEPS // 8, "cnf_eval f")
        gate(f"{label} dense cloud, kernels vs plain", dense, ref_dense, tol)
        scale = max(1.0, abs(float(ref_nll)))
        gate(f"{label} NLL, kernels vs plain (tol scaled by max(1, |NLL|) "
             f"= {scale:.3f})", nll / scale, ref_nll / scale, tol)
        log(f"cnf_eval {label}: {time.perf_counter() - t0:.1f} s")


def cnf_first_step(trainer, sparse, dense) -> None:
    """Hold the trainer's first step to the plain versions of its kernels:
    the train-mode forward on the kernels against the same on the plain
    solves (`plain_solves`), prediction within 5e-6 and NLL within 5e-6 of
    max(1, |NLL|) (seeded weights: every step size set by a clip); the EMD
    kernel against `emd_auction_plain` on the kernel path's prediction,
    with equal assignments (the auction's assignment is not continuous in
    its input: a prediction 1e-7 away may take another); then the step's
    NLL, EMD and loss those of the kernel forward."""
    cfg = trainer.cfg
    with torch.no_grad():
        pred, nll, _ = continuous.forward(*trainer.trees(), sparse,
                                          cfg.upratio, train=True)
        with plain_solves():
            ref_pred, ref_nll, _ = continuous.forward(
                *trainer.trees(), sparse, cfg.upratio, train=True)
        dist, assign = emd_auction(pred, dense, cfg.emd_eps, cfg.emd_iters)
        ref_dist, ref_assign = emd_auction_plain(pred, dense, cfg.emd_eps,
                                                 cfg.emd_iters)
    log("cnf_train step 1 against the plain versions:")
    gate("train-mode prediction", pred, ref_pred, 5e-6)
    scale = max(1.0, abs(float(ref_nll)))
    gate(f"NLL {float(nll):.6f} (tol scaled by {scale:.3f})", nll / scale,
         ref_nll / scale, 5e-6)
    differ = int((assign != ref_assign).sum())
    log(f"  EMD kernel vs plain on the kernel path's prediction: {differ} "
        "assignments differ")
    if differ:
        raise AssertionError("cnf_train: the EMD kernel's assignments differ")
    emd = torch.sum(dist)
    gate("EMD sum", emd, torch.sum(ref_dist), 1e-6 * float(emd))
    m = trainer.step(sparse, dense)
    loss = nll * cfg.logpx_weight + emd * cfg.emd_weight
    log(f"  step 1 loss {float(m['loss']):.7f} (NLL {float(m['logpx']):.6f},"
        f" EMD {float(m['emd']):.6f}), from the forward above "
        f"{float(loss):.7f}")
    for k, want in (("logpx", nll), ("emd", emd), ("loss", loss)):
        gate(f"step's {k}", m[k], want, 1e-6 * max(1.0, abs(float(want))))


def phase_cnf_train(card):
    """The CNF trainer: `Trainer(TrainConfig(), ..., forward_fn=
    continuous.forward)` on the full-width seeded CNF model at
    `bench.py:bench_cnf_train`'s shape (batch 32, 256 -> 1024 points).
    The first step against the plain versions (`cnf_first_step`);
    `CNF_TRAIN_WARMUP` steps and `TRAIN_WINDOWS` timed windows of
    `TRAIN_STEPS` steps with the launch counts set to 0 before and read
    after (`GRAD_LAUNCHES` a step); steps/s, the split per step, the peak
    memory and one traced step's idle share; then `trainer.validate` on
    `CNF_VAL_BATCHES` batches (`EVAL_LAUNCHES` a batch) against the same
    validation on the plain solves."""
    params, state = checkpoint.to_numpy_tree(seeded_cnf_model())
    trainer = Trainer(TrainConfig(), params, state,
                      forward_fn=continuous.forward, device="cuda")
    sp, de = synthetic_pairs(np.random.RandomState(0), TRAIN_B, TRAIN_N,
                             UPRATIO)
    sparse, dense = torch.from_numpy(sp).cuda(), torch.from_numpy(de).cuda()
    cnf_first_step(trainer, sparse, dense)

    metrics, windows, splits, launches, peak = timed_steps(
        trainer, sparse, dense, CNF_TRAIN_WARMUP)
    steps = CNF_TRAIN_WARMUP + TRAIN_WINDOWS * TRAIN_STEPS
    log(f"cnf_train main path: {steps} steps, launches {launches}")
    for k, n in GRAD_LAUNCHES.items():
        if launches[k] != n * steps:
            raise AssertionError(f"cnf_train: {launches[k]} {k} launches in "
                                 f"{steps} steps, not {n} a step")
    table = torch.stack([torch.stack([m["loss"], m["emd"],
                                      m["nan_step"].float()])
                         for m in metrics]).cpu().numpy()
    if not np.isfinite(table[:, :2]).all() or table[:, 2].any():
        raise AssertionError("cnf_train: a loss was not finite or a step "
                             "tripped the NaN guard")
    log(f"cnf_train loss step 2 {table[0, 0]:.6f}, last {table[-1, 0]:.6f}; "
        f"emd {table[0, 1]:.4f} -> {table[-1, 1]:.4f}; no NaN step")
    per_step = [w / TRAIN_STEPS for w in windows]
    median = statistics.median(per_step)
    log(f"cnf_train B={TRAIN_B} step ms per window of {TRAIN_STEPS}: "
        + ", ".join(f"{t * 1e3:.3f}" for t in per_step)
        + f"; steps/s median {1.0 / median:.3f} (range "
        f"{1.0 / max(per_step):.3f} to {1.0 / min(per_step):.3f}), on {card}")
    log(f"cnf_train B={TRAIN_B} per-step split, ms (median of "
        f"{TRAIN_WINDOWS * TRAIN_STEPS}): " + ", ".join(
            f"{k} {statistics.median(v):.3f}" for k, v in splits.items()))
    log(f"cnf_train B={TRAIN_B} peak device memory {peak / 2**30:.3f} GiB "
        "(torch.cuda.max_memory_allocated)")
    trace_idle(f"cnf_train B={TRAIN_B} step",
               lambda: trainer.step(sparse, dense), median)

    rng = np.random.RandomState(1)
    batches = [synthetic_pairs(rng, TRAIN_B, TRAIN_N, UPRATIO)
               for _ in range(CNF_VAL_BATCHES)]
    for fn in WRAPPERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = trainer.validate(batches)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in WRAPPERS.items()}
    expect = dict.fromkeys(WRAPPERS, 0) | {
        k: n * CNF_VAL_BATCHES for k, n in EVAL_LAUNCHES.items()}
    log(f"cnf_train validate on {CNF_VAL_BATCHES} batches: {got}, launches "
        f"{launches}")
    if launches != expect:
        raise AssertionError(f"cnf_train validate: launches {launches}, not "
                             f"{expect}")
    for fn in WRAPPERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with plain_solves():
        ref = trainer.validate(batches)
    ref_s = time.perf_counter() - t0
    no_launch("cnf_train validate on the plain solves")
    log(f"cnf_train validate on plain solves: {ref}")
    log(f"cnf_train validate, ms a batch (host clock, {CNF_VAL_BATCHES} "
        f"batches of {TRAIN_B}): kernels {val_s * 1e3 / CNF_VAL_BATCHES:.3f}"
        f", plain solves {ref_s * 1e3 / CNF_VAL_BATCHES:.3f}, on {card}")
    # vloss is 1e-5 of the NLLs' sum: held as `phase_cnf_eval` holds an
    # NLL, the chamfer sum as a dense cloud
    nll, ref_nll = got["vloss"] * 1e5, ref["vloss"] * 1e5
    errs = {"vloss": abs(nll - ref_nll) / max(1.0, abs(ref_nll)),
            "CD": abs(got["CD"] - ref["CD"])}
    log(f"cnf_train validate, kernels vs plain: NLL sum relative "
        f"{errs['vloss']:.3e}, CD {errs['CD']:.3e} (gates {SOLVER_TOL:.0e})")
    for k, err in errs.items():
        if not err <= SOLVER_TOL:
            raise AssertionError(f"cnf_train validate {k}: {got[k]} on "
                                 f"kernels, {ref[k]} on plain solves")


def write_pugeo_shards(folder, rng) -> str:
    """Two seeded shapes at the PUGeo defaults' resolutions (5,000 input
    and 20,000 label points) as a tfrecord shard written by the port's
    codec -> the shard's glob."""
    payloads = []
    for _ in range(2):
        lo = synthetic_clouds(1, int(rng.randint(1 << 30)), 5000)[0].cpu()
        hi = lo.numpy().repeat(4, 0) + 0.01 * rng.randn(20000, 3)
        payloads.append(tfrecord.build_example_floats(
            {"res_5000": lo.numpy().ravel(),
             "res_20000": hi.astype(np.float32).ravel()}))
    os.makedirs(folder)
    tfrecord.write_records(
        os.path.join(folder, "res_5000_res_20000_p256_0.tfrecord"), payloads)
    return os.path.join(folder, "*.tfrecord")


def served_launches(model, pc):
    """`upsample_cloud` + `remove_outliers` of ``pc`` with the launch
    counts set to 0 before and read after -> (output, launches)."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    with torch.no_grad():
        out = upsample_cloud(model, pc, NPOINT, UPRATIO, PATCH, EXPAND)
        out = remove_outliers(out, pc, N_OUTLIERS)
    torch.cuda.synchronize()
    return out, {k: fn.launches for k, fn in WRAPPERS.items()}


def phase_train_clis(cnf_folded):
    """The three train CLIs of this slice on the card: `train_cnf` and
    `train_pugan` (the loss with the chamfer term) on 2 synthetic steps,
    `train_pugeo` on tfrecord shards this script writes (300 batches of
    8), the three at once; then the CNF checkpoint, loaded BN-folded,
    serves one 2048-point cloud with the launches of the seeded folded CNF
    model on the same cloud."""
    with tempfile.TemporaryDirectory() as tmp:
        short = ("--max_epochs", "1", "--val_batches", "1")
        cnf_ckpt = os.path.join(tmp, "cnf.npz")
        records = write_pugeo_shards(os.path.join(tmp, "shards"),
                                     np.random.RandomState(SEED))
        run_clis(("puflow_torch.cli.train_cnf", "--synthetic", "2", *short,
                  "--checkpoint", cnf_ckpt),
                 ("puflow_torch.cli.train_pugan", "--synthetic", "2", *short,
                  "--checkpoint", os.path.join(tmp, "pugan.npz")),
                 ("puflow_torch.cli.train_pugeo", "--data", records,
                  "--batch_size", "8", *short, "--checkpoint",
                  os.path.join(tmp, "pugeo.npz")))
        model = checkpoint.load_checkpoint(cnf_ckpt.replace(
            ".npz", "-epoch1.npz"), "cuda", fold=True, model="cnf")
    pc = synthetic_clouds(1, SEED + 7)
    out, launches = served_launches(model, pc)
    _, expect = served_launches(cnf_folded, pc)
    log(f"served the train_cnf checkpoint (BN folded): {N_POINTS} -> "
        f"{tuple(out.shape)}, launches {launches}")
    if tuple(out.shape) != (1, N_POINTS * UPRATIO, 3):
        raise AssertionError(f"served output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("served output has non-finite values")
    if launches != expect or launches["cnf_solve"] != CNF_SOLVES:
        raise AssertionError(f"served launches {launches}, the cnf_folded "
                             f"path's {expect}")


# the evaluation protocol (scripts/eval_fixtures_torch.sh) at PU1K's shapes
PROTOCOL = ROOT / "scripts" / "eval_fixtures_torch.sh"
PROTOCOL_SHAPES = 2           # fixture shapes of the discrete protocol run
PUGAN_POINTS = 20000          # a side of the PU-GAN-shaped EMD timing
# card against CPU, the tolerances tests/test_torch_eval.py sets against
# JAX: the approx-match EMD relative, CD and HD absolute; the rest equal
EMD_RTOL = 1e-5
CHAMFER_ATOL = 2e-6


def reference_pt(path, model, family: str):
    """``model``'s trees written as the reference's ``.pt`` (the tests'
    inverse mapping, `tests/torch_ckpt_cases.py`) and as a native
    ``.npz`` beside it; checks that the port's converter reads the ``.pt``
    back bit-equal. -> (.pt path, .npz path)."""
    trees = checkpoint.to_numpy_tree(model)
    pt, npz = f"{path}.pt", f"{path}.npz"
    save_reference_checkpoint(pt, *trees, family)
    checkpoint.save_checkpoint(npz, *trees)
    back = (torch_ckpt.load_discrete_checkpoint if family == "discrete"
            else torch_ckpt.load_cnf_checkpoint)(pt)
    want, got = tree_paths(trees), tree_paths(back)
    if [k for k, _ in want] != [k for k, _ in got] or not all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for (_, a), (_, b) in zip(want, got)):
        raise AssertionError(f"{family}: the .pt does not convert back to "
                             "the trees written")
    log(f"{family} checkpoint written as a reference .pt "
        f"({os.path.getsize(pt)} bytes) and .npz; converted back bit-equal "
        f"({len(want)} arrays)")
    return pt, npz


def subprocess_env() -> dict:
    """This interpreter first on PATH, for the scripts' ``python``."""
    return dict(os.environ, PATH=os.pathsep.join(
        [os.path.dirname(sys.executable), os.environ.get("PATH", "")]))


def run_protocol(work, ckpt, shapes: int, *flags) -> dict:
    """`scripts/eval_fixtures_torch.sh` on ``shapes`` fixtures at PU1K's
    2048 -> 8192 points -> its stage seconds, evaluate's ms a file and
    the ms of each file's CD/HD/EMD, JSD and P2F with uniformity."""
    cmd = ["bash", str(PROTOCOL), ckpt, work, str(shapes), str(N_POINTS),
           str(N_POINTS * UPRATIO), *flags]
    proc = subprocess.run(cmd, cwd=ROOT, env=subprocess_env(),
                          capture_output=True, text=True, timeout=900)
    log(proc.stdout.strip())
    if proc.returncode != 0:
        raise AssertionError(f"protocol failed ({proc.returncode}): "
                             f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    return stage_times(proc.stdout)


def stage_times(stdout: str) -> dict:
    """The protocol script's `stage <name>: <s> s` lines and evaluate's
    ms a file and ms of each file by metric, from its output."""
    times = {}
    for line in stdout.splitlines():
        if line.startswith("stage "):
            name, secs = line[6:].split(":")
            times[name] = float(secs.split()[0])
        elif line.startswith("evaluated "):
            times["evaluate ms a file"] = float(line.split()[-4])
        elif line.startswith("  ms of each file, "):
            label, values = line[19:].split(": ")
            times[label] = [float(v) for v in values.split()]
    return times


def read_rows(path) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def check_rows(label, rows, files: int) -> None:
    """``files`` per-file rows and the aggregate, every column filled and
    finite."""
    if len(rows) != files + 1:
        raise AssertionError(f"{label}: {len(rows)} rows, not {files} + 1")
    for row in rows:
        for key, value in row.items():
            if key == "name":
                continue
            if value == "-" or not np.isfinite(float(value)):
                raise AssertionError(f"{label}: {row['name']} {key} = "
                                     f"{value}")
    log(f"{label}: {files} rows + the aggregate, {len(rows[0]) - 1} columns "
        "filled, all finite")


def compare_evaluations(card_rows, cpu_rows) -> None:
    """The card's CD / HD / EMD within the CPU tests' tolerances of the
    CPU's; JSD, P2F and uniformity (numpy on the host in both) equal."""
    worst = {"CD": 0.0, "hausdorff": 0.0, "EMD": 0.0}
    for a, b in zip(card_rows, cpu_rows):
        for key in a:
            if key in worst:
                x, y = float(a[key]), float(b[key])
                err = abs(x - y) / abs(y) if key == "EMD" else abs(x - y)
                worst[key] = max(worst[key], err)
            elif a[key] != b[key]:
                raise AssertionError(f"evaluate, card vs CPU: {a['name']} "
                                     f"{key} {a[key]} != {b[key]}")
    log(f"evaluate, card vs CPU: CD {worst['CD']:.3e}, HD "
        f"{worst['hausdorff']:.3e} (atol {CHAMFER_ATOL:.0e}), EMD "
        f"{worst['EMD']:.3e} relative (rtol {EMD_RTOL:.0e}); JSD, P2F and "
        "uniformity equal")
    if max(worst["CD"], worst["hausdorff"]) > CHAMFER_ATOL or (
            worst["EMD"] > EMD_RTOL):
        raise AssertionError(f"evaluate, card vs CPU: {worst}")


def time_earth_mover(card, n: int, reps: int) -> None:
    """`earth_mover` alone on one seeded pair of ``n`` points a side: ms
    a call (CUDA events) and the peak memory of one call."""
    rng = np.random.RandomState(SEED + n)
    x, y = (torch.from_numpy(rng.randn(1, n, 3).astype(np.float32)).cuda()
            for _ in range(2))
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        emd = float(earth_mover(x, y))
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_ms(lambda: earth_mover(x, y), reps)
    if not np.isfinite(emd):
        raise AssertionError(f"earth_mover at {n} points: {emd}")
    log(f"earth_mover {n} x {n}: {ms:.3f} ms a call (mean of {reps}), peak "
        f"{peak / 2**30:.3f} GiB above its inputs ({peak / (4 * n * n):.2f} "
        f"[1, n, n] float32 buffers), EMD {emd:.6f} ({card})")


def evaluate_pugan_pair(card, tmp) -> None:
    """`cli.evaluate` in this process (the card warm) on one seeded pair at
    PU-GAN's 20,000 points, without p2f side-files: ms a file by metric."""
    out = io.StringIO()

    rng = np.random.RandomState(SEED)
    gt = rng.randn(PUGAN_POINTS, 3)
    gt /= np.linalg.norm(gt, axis=1, keepdims=True)
    for name, pts in (("gt", gt), ("pred", gt + 0.01 * rng.randn(*gt.shape))):
        os.makedirs(os.path.join(tmp, name))
        np.savetxt(os.path.join(tmp, name, "pugan.xyz"), pts, fmt="%.6f")
    with contextlib.redirect_stdout(out):
        evaluate.main(["--pred", os.path.join(tmp, "pred"), "--gt",
                       os.path.join(tmp, "gt"), "--save_path",
                       os.path.join(tmp, "results"), "--device", "cuda"])
    log(out.getvalue().strip())
    check_rows("evaluation.csv (20,000 points, no p2f)", [
        {k: v for k, v in row.items() if k in ("name", "CD", "EMD",
                                               "hausdorff")}
        for row in read_rows(os.path.join(tmp, "results", "evaluation.csv"))
    ], 1)
    log(f"evaluate at {PUGAN_POINTS} x {PUGAN_POINTS}, one pair: "
        f"{stage_times(out.getvalue())} ({card})")


def served_like(pt, family: str, seeded, path: str, pc) -> None:
    """The ``.pt`` loaded BN-folded serves ``pc`` as the seeded folded
    model it was written from: every kernel of ``PATHS[path]`` launched,
    the same launches and the same output."""
    converted = checkpoint.load_checkpoint(pt, "cuda", fold=True,
                                           model=family)
    out, launches = served_launches(converted, pc)
    ref, expect = served_launches(seeded, pc)
    log(f"converted {family} .pt (BN folded) on one fixture: launches "
        f"{launches}")
    for k in PATHS[path]:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 f"converted {family} model")
    if launches != expect or not torch.equal(out, ref):
        raise AssertionError(f"the converted {family} model does not serve "
                             f"as the seeded {path} model: {expect}")


def phase_eval_protocol(model, folded, cnf_model, cnf_folded, card):
    """The evaluation protocol of the port on the card: the seeded discrete
    and CNF models written as reference ``.pt`` files, the protocol script
    on them (upsample -> p2f -> evaluate on the card), the same upsample
    from the ``.npz``, each path's kernels counted on each converted
    model, evaluate on the CPU against the card's, and the times."""
    with tempfile.TemporaryDirectory() as tmp:
        pt, npz = reference_pt(os.path.join(tmp, "discrete"), model,
                               "discrete")
        cnf_pt, _ = reference_pt(os.path.join(tmp, "cnf"), cnf_model, "cnf")
        work = os.path.join(tmp, "pu1k")
        times = run_protocol(work, pt, PROTOCOL_SHAPES)
        log(f"protocol, discrete .pt, {PROTOCOL_SHAPES} shapes at "
            f"{N_POINTS} -> {N_POINTS * UPRATIO}: {times} ({card})")

        names = sorted(os.listdir(os.path.join(work, "input")))
        t0 = time.perf_counter()
        run_clis(("puflow_torch.cli.upsample", "--source",
                  os.path.join(work, "input"), "--target",
                  os.path.join(work, "pred_npz"), "--checkpoint", npz,
                  "--up_ratio", str(UPRATIO), "--batch",
                  str(PROTOCOL_SHAPES)))
        same = [Path(work, "pred", n).read_bytes()
                == Path(work, "pred_npz", n).read_bytes() for n in names]
        log(f"upsample from the .npz ({time.perf_counter() - t0:.1f} s): "
            f"outputs byte-identical to the .pt's: {same}")
        if len(names) != PROTOCOL_SHAPES or not all(same):
            raise AssertionError("the .pt and .npz upsample outputs differ")

        pc = torch.from_numpy(np.loadtxt(os.path.join(
            work, "input", names[0]), dtype=np.float32)[None]).cuda()
        served_like(pt, "discrete", folded, "folded", pc)

        rows = read_rows(os.path.join(work, "results", "evaluation.csv"))
        check_rows("evaluation.csv (card)", rows, PROTOCOL_SHAPES)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "puflow_torch.cli.evaluate", "--pred",
             os.path.join(work, "pred"), "--gt", os.path.join(work, "gt"),
             "--save_path", os.path.join(work, "results_cpu"), "--device",
             "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=900)
        log(f"evaluate --device cpu ({time.perf_counter() - t0:.1f} s): "
            f"{proc.stdout.strip()}")
        if proc.returncode != 0:
            raise AssertionError(f"evaluate on the CPU failed:\n"
                                 f"{proc.stderr[-4000:]}")
        compare_evaluations(rows, read_rows(
            os.path.join(work, "results_cpu", "evaluation.csv")))

        # make_fixtures.py writes its two named shapes at the least
        work = os.path.join(tmp, "cnf")
        times = run_protocol(work, cnf_pt, PROTOCOL_SHAPES, "--model", "cnf")
        log(f"protocol, CNF .pt, {PROTOCOL_SHAPES} shapes: {times} ({card})")
        check_rows("evaluation.csv (CNF)", read_rows(
            os.path.join(work, "results", "evaluation.csv")), PROTOCOL_SHAPES)
        served_like(cnf_pt, "cnf", cnf_folded, "cnf_folded", pc)
        evaluate_pugan_pair(card, os.path.join(tmp, "pugan"))
    time_earth_mover(card, N_POINTS * UPRATIO, 10)
    time_earth_mover(card, PUGAN_POINTS, 5)


# --------------------------------------------------------------------------
# Serving artifacts: `torch.export` .pt2 files of the folded paths
# --------------------------------------------------------------------------
EXPORT_NPOINT = N_POINTS * UPRATIO + N_OUTLIERS   # the artifact's output
EXPORT_PATCHES = (1, 32, 256)                     # calls of the sampler
FOLDED_COUNTS = {"knn_self": 1, "encoder": 1, "interp_head": 1, "flow_f": 1,
                 "flow_g_blend": 1}
CNF_COUNTS = {"cnf_solve": CNF_SOLVES, "encoder": 1, "interp_head": 1}
# artifact -> (kernel launches a call, input names it is called on)
ARTIFACTS = {
    "discrete_patch": (FOLDED_COUNTS,
                       [f"patches{b}" for b in EXPORT_PATCHES]),
    "discrete_cloud": (dict(FOLDED_COUNTS, fps=2), ["clouds8"]),
    "cnf_patch": (CNF_COUNTS, ["patches32"]),
    "cnf_cloud": (dict(CNF_COUNTS, fps=2), ["clouds1"]),
    "cli_patch": (FOLDED_COUNTS, ["patches32"]),
    "cli_cloud": (dict(FOLDED_COUNTS, fps=2), ["clouds8"]),
}
# a fresh process that imports torch and `puflow_torch.serving` alone, loads
# every artifact, calls each twice on each of its inputs with the launch
# counts set to 0 before the first call and read after it
LOAD_AND_CALL = """
import json, sys, time
import torch
from puflow_torch import serving

spec = json.loads(sys.argv[1])
inputs = torch.load(spec["inputs"])
results = {}
for name, (path, feeds) in spec["artifacts"].items():
    t0 = time.perf_counter()
    fn = serving.load_exported(path)
    load_s = time.perf_counter() - t0
    for feed in feeds:
        x = inputs[feed].cuda()
        for w in serving.WRAPPERS.values():
            w.launches = 0
        out = fn(x)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in serving.WRAPPERS.items()
                  if w.launches}
        again = fn(x)
        results[name, feed] = dict(out=out.cpu(), counts=counts,
                                   rerun_equal=bool(torch.equal(out, again)),
                                   load_s=load_s)
torch.save(results, spec["results"])
print("loaded and called", len(spec["artifacts"]), "artifacts in",
      torch.cuda.get_device_name(0))
"""


def graph_calls(ep) -> dict:
    """``puflow::`` op calls in an exported graph and its submodules'."""
    calls = {}
    for mod in ep.graph_module.modules():
        for node in mod.graph.nodes:
            name = getattr(node.target, "name", lambda: "")()
            if node.op == "call_function" and name.startswith("puflow::"):
                op = name.split("::")[1].split(".")[0]
                calls[op] = calls.get(op, 0) + 1
    return calls


def median_call_ms(fn, reps: int) -> float:
    """Median device-clock ms of one call over ``reps`` calls."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 100) -> float:
    """Median host microseconds of one call to enqueue ``fn``, over
    ``calls`` calls after 3 warm-up calls (too few launches to fill the
    card's queue, so no call waits for a free slot)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def dispatch_cases(folded, cnf_folded, patches):
    """op -> (the wrapper's call, the op's arguments) at the main path's
    shapes: 32 patches of 256 points (the CNF's f solve of block 0 on
    them), the seed pick of one cloud, the seeded merge's Morton cells of
    one cloud, one patch over the shared-memory k-NN's limit."""
    p, cp = folded.trees()[0], cnf_folded.trees()[0]
    x = patches[:N_PATCH].contiguous()
    idx = knn_self_plain(x, K)
    idx8 = idx[..., :INTERP_K]
    cs = enc_ops.encoder_conditions_plain(p, x, idx)
    ws = interp_ops.interp_head_plain(p["interp"], x, idx8, UPRATIO)
    z = flow_ops.flow_f_plain(p["flow_blocks"], x, cs)
    fz = torch.einsum("bnkc,bnkr->bncr", gather_points(z, idx8),
                      ws).contiguous()
    enc = _build.flatten({"feat_convs": p["feat_convs"],
                          "merge_convs": p["merge_convs"]})
    head = _build.flatten(p["interp"])
    blocks = _build.flatten(list(p["flow_blocks"]))
    bp = cp["flow_blocks"][0]
    T = bp["sqrt_end_time"] * bp["sqrt_end_time"]
    c0 = enc_ops.encoder_conditions_plain(cp, x, idx)[0]
    layers = _build.flatten(list(bp["layers"]))
    zero = torch.zeros_like(T)
    pc = synthetic_clouds(1, SEED)
    cells = torch.rand((16, 2048, 3), device=x.device)
    big = clustered_patch(np.random.RandomState(SEED), 1, KNN_MAX_N + 1)
    fb = p["flow_blocks"]
    return {
        "knn_self": (lambda: knn_self(x, K), (x, K)),
        "knn_self_stream": (lambda: knn_self_stream(big, K), (big, K)),
        "encoder": (lambda: enc_ops.encoder_conditions(p, x, idx),
                    (x, idx, *enc)),
        "interp_head": (lambda: interp_ops.interp_head(
            p["interp"], x, idx8, UPRATIO),
            (x, idx8, *head, UPRATIO, "weights", None)),
        "flow_f": (lambda: flow_ops.flow_f(fb, x, cs), (x, cs, *blocks)),
        "flow_g": (lambda: flow_ops.flow_g(fb, fz, cs), (fz, cs, *blocks)),
        "flow_g_blend": (lambda: flow_ops.flow_g_blend(fb, z, ws, idx8, cs),
                         (z, ws, idx8, cs, *blocks)),
        "cnf_solve": (lambda: cnf_ops.cnf_solve_t(bp["layers"], c0, x, zero,
                                                  T),
                      (c0, x, zero, T, *layers, continuous.RTOL,
                       continuous.ATOL, continuous.MAX_STEPS_EVAL)),
        "fps": (lambda: farthest_point_sample(pc, N_PATCH),
                (pc, N_PATCH, -1, -1)),
        "fps_seeded": (lambda: farthest_point_sample_seeded(cells, pc, 386),
                       (cells, pc, 386, -1, -1)),
    }


def phase_export(model, folded, cnf_folded, card):
    """Export the folded discrete and CNF patch samplers (symbolic batch)
    and cloud upsamplers (8 and 1 clouds), and the export CLI's two kinds;
    load all six in a fresh process and count each call's launches; hold
    each artifact to the live path (patch samplers atol 1e-6, cloud
    upsamplers Chamfer < 5e-5: tests/test_serving.py's gates), two calls
    bit-equal; time the artifact beside the live path in turns, and each
    op's host dispatch beside its direct ctypes launch."""
    t_phase = time.perf_counter()
    patches = main_path_patches(8)                    # 256 patches
    inputs = {f"patches{b}": patches[:b].contiguous() for b in EXPORT_PATCHES}
    inputs.update(clouds8=synthetic_clouds(8, SEED),
                  clouds1=synthetic_clouds(1, SEED))
    live_models = {"discrete": folded, "cnf": cnf_folded}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: os.path.join(tmp, f"{name}.pt2") for name in ARTIFACTS}
        exported = {}
        for family in ("discrete", "cnf"):
            params, state = live_models[family].trees()
            for kind, batch in (("patch", None),
                                ("cloud", 8 if family == "discrete" else 1)):
                name = f"{family}_{kind}"
                t0 = time.perf_counter()
                if kind == "patch":
                    ep = serving.export_patch_sampler(params, state, family,
                                                      UPRATIO, PATCH)
                else:
                    ep = serving.export_cloud_upsampler(
                        params, state, family, N_POINTS, EXPORT_NPOINT,
                        UPRATIO, PATCH, EXPAND, batch)
                export_s = time.perf_counter() - t0
                serving.save_exported(ep, paths[name])
                calls, want = graph_calls(ep), ARTIFACTS[name][0]
                log(f"export {name}: {export_s:.2f} s, "
                    f"{os.path.getsize(paths[name]) / 1e6:.3f} MB, graph "
                    f"calls {calls} ({card})")
                if calls != want or ep.constants:
                    raise AssertionError(f"{name}: graph calls {calls}, "
                                         f"constants {list(ep.constants)}")
                exported[name] = ep
        npz = os.path.join(tmp, "discrete.npz")
        checkpoint.save_checkpoint(npz, *checkpoint.to_numpy_tree(model))
        t0 = time.perf_counter()
        shape = ("--patch_size", str(PATCH), "--cloud_points", str(N_POINTS))
        run_clis(("puflow_torch.cli.export", "--checkpoint", npz, "--out",
                  paths["cli_patch"], *shape),
                 ("puflow_torch.cli.export", "--checkpoint", npz, "--kind",
                  "cloud", "--batch", "8", "--out", paths["cli_cloud"],
                  *shape))
        log(f"export CLI, both kinds at once: {time.perf_counter() - t0:.2f}"
            f" s; {os.path.getsize(paths['cli_patch']) / 1e6:.3f} / "
            f"{os.path.getsize(paths['cli_cloud']) / 1e6:.3f} MB ({card})")

        torch.save({k: v.cpu() for k, v in inputs.items()},
                   os.path.join(tmp, "inputs.pt"))
        spec = {"inputs": os.path.join(tmp, "inputs.pt"),
                "results": os.path.join(tmp, "results.pt"),
                "artifacts": {n: (paths[n], feeds)
                              for n, (_, feeds) in ARTIFACTS.items()}}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", LOAD_AND_CALL,
                               json.dumps(spec)], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"loading the artifacts failed:\n"
                                 f"{proc.stderr[-4000:]}")
        log(f"{proc.stdout.strip()} (fresh process, "
            f"{time.perf_counter() - t0:.2f} s with its start)")
        results = torch.load(spec["results"])
        fresh = {n: serving.load_exported(paths[n]) for n in ARTIFACTS}

    live_ms = {}
    with torch.no_grad():
        for (name, feed), res in results.items():
            x = inputs[feed]
            family, kind = name.split("_")
            family = "discrete" if family == "cli" else family
            net = live_models[family]
            if kind == "patch":
                live = lambda net=net, x=x: net(x, UPRATIO)  # noqa: E731
            else:
                live = lambda net=net, x=x: upsample_cloud(  # noqa: E731
                    net, x, EXPORT_NPOINT, UPRATIO, PATCH, EXPAND)
            ref = live()
            torch.cuda.synchronize()
            got = res["out"].to(ref.device)
            want = ARTIFACTS[name][0]
            if res["counts"] != want:
                raise AssertionError(f"{name} on {feed}: launches "
                                     f"{res['counts']}, not {want}")
            if kind == "patch":
                gap = float((got - ref).abs().max())
                ok, what = gap <= 1e-6, f"max_abs_diff {gap:.3e} (atol 1e-6)"
            else:
                gap = chamfer(got, ref)
                ok, what = gap < 5e-5, f"chamfer {gap:.3e} (gate 5e-5)"
            log(f"artifact {name} on {feed} {tuple(x.shape)} (loaded in "
                f"{res['load_s']:.2f} s): launches {res['counts']}; vs the "
                f"live path {what}, bit-equal {torch.equal(got, ref)}; two "
                f"calls bit-equal {res['rerun_equal']} ({card})")
            if not ok or not res["rerun_equal"]:
                raise AssertionError(f"artifact {name} on {feed} fails its "
                                     "gate or its rerun")
            if name.startswith("cli") or (name, feed) in live_ms:
                continue
            art = lambda fn=fresh[name], x=x: fn(x)  # noqa: E731
            reps = 5 if x.shape[0] > 1 else 10
            l1, a1 = median_call_ms(live, reps), median_call_ms(art, reps)
            a2, l2 = median_call_ms(art, reps), median_call_ms(live, reps)
            live_ms[name, feed] = (l1, l2)
            log(f"artifact {name} on {feed}: {a1:.4f} / {a2:.4f} ms a call, "
                f"live {l1:.4f} / {l2:.4f} ms (median of {reps}, in turns "
                f"live, artifact, artifact, live; {card})")

        cases = dispatch_cases(folded, cnf_folded, patches)
        for op, (wrapper, args) in cases.items():
            packet = getattr(torch.ops.puflow, op)
            w = host_us(wrapper)
            o = host_us(lambda packet=packet, args=args: packet(*args))
            d = host_us(lambda op=op, args=args: OP_DIRECT[op](*args))
            log(f"dispatch {op}: wrapper {w:.1f} us, op {o:.1f} us, direct "
                f"ctypes launch {d:.1f} us a call (host, median of 100; op "
                f"- direct {o - d:.1f} us; {card})")
    log(f"phase export: {time.perf_counter() - t_phase:.1f} s ({card})")


DP_WORLD = 2             # ranks sharing the one card through gloo
DP_STEPS = 10            # data-parallel train steps at bench_train's batch
DP_CLOUDS = 8            # clouds of the sharded upsample (4 a rank)
DP_COUNTS = {k: 2 if k == "fps" else 1 for k in PATHS["folded"]}


def dp_gradient_gate(label, layout, got, want) -> None:
    """A data-parallel gradient against the one-process one, per leaf at
    the JAX package's gate ``5e-4 * scale + 1e-6`` (tests/test_train.py);
    leaves zero to rounding on both sides (`rounding_zero`) are held to
    being so on both."""
    zero_want = rounding_zero(layout.paths, want.split(layout.sizes))
    zero_got = rounding_zero(layout.paths, got.split(layout.sizes))
    if set(zero_want) != set(zero_got):
        raise AssertionError(f"{label}: the leaves zero to rounding differ: "
                             f"{sorted(set(zero_want) ^ set(zero_got))}")
    worst, worst_all = 0.0, 0.0
    for path, a, b in zip(layout.paths, got.split(layout.sizes),
                          want.split(layout.sizes)):
        scale = max(float(b.abs().max()), 1e-3)
        ratio = float((a - b).abs().max()) / (5e-4 * scale + 1e-6)
        worst_all = max(worst_all, ratio)
        if path in zero_want:
            continue
        if not ratio <= 1.0:
            raise AssertionError(f"{label} {path}: {ratio:.3f} of the gate")
        worst = max(worst, ratio)
    log(f"{label}: {len(layout.paths) - len(zero_want)} leaves within 5e-4 "
        f"* scale + 1e-6 of the one-process gradient (worst {worst:.3e} of "
        f"the gate; over all {len(layout.paths)} leaves, the {len(zero_want)}"
        f" zero to rounding included, {worst_all:.3e})")


def check_dp_ranks(label, ranks, layout, one, one_sharded) -> None:
    """The checks of `card_train_rank`'s results on every rank.

    The first-step gradient: bit-equal across ranks; at the one-process
    run's auction assignment held to the one-process gradient at that
    assignment (`dp_gradient_gate`); with each run's own auction, the
    assignments that differ and the gradients' distance printed (the two
    runs' predictions differ by rounding, and the auction is not
    continuous in them). Every step's parameters, BN state and Adam
    moments bit-equal to rank 0's, the loss finite, one EMD launch a step.
    The sharded upsample: the folded path's six kernels launched (FPS
    twice), each rank's shard bit-equal to `upsample_cloud` of its clouds
    alone, and against the one-process run of all the clouds at
    `phase_main_path`'s pipeline gate (Chamfer < 1e-4 a cloud): the
    pipeline's mean over a cloud's points rounds differently at another
    batch size (6e-8), and the merge's FPS then takes other points from
    near-ties, so the share of points beyond atol 2e-4 of their place is
    printed, not gated. Prints each rank's step split and times."""
    for r, res in enumerate(ranks):
        for key in ("fixed", "auction"):
            if not np.array_equal(res["grads"][key], ranks[0]["grads"][key]):
                raise AssertionError(f"{label}: rank {r}'s gradient ({key}) "
                                     "is not rank 0's")
    dp = ranks[0]["grads"]
    dp_gradient_gate(f"{label} first-step gradient ({len(ranks)} ranks, "
                     "one cloud a rank, 256 -> 1024) at the one-process "
                     "assignment", layout, torch.from_numpy(dp["fixed"]),
                     torch.from_numpy(one["fixed"]))
    assign = np.concatenate([res["grads"]["assign"] for res in ranks])
    scale = np.abs(one["auction"]).max()
    differ = int((assign != one["assign"]).sum())
    log(f"{label} with each run's own auction: {differ} of {assign.size} "
        f"assignments differ, loss {dp['loss']:.7f} vs "
        f"{one['loss']:.7f} one-process, gradients' max |diff| "
        f"{np.abs(dp['auction'] - one['auction']).max():.3e} (largest entry "
        f"{scale:.3e})")
    for r, res in enumerate(ranks):
        steps = res["steps"]
        bad = [i for i, s in enumerate(steps)
               if not s["bit_equal"] or s["emd_launches"] != 1
               or s["nan_step"] or not np.isfinite(s["loss"])]
        if bad:
            raise AssertionError(f"{label} rank {r}: steps {bad} broke "
                                 f"bit-equality, the EMD count, or the "
                                 f"loss: {[steps[i] for i in bad]}")
        log(f"{label} rank {r}: {len(steps)} steps at global batch "
            f"{TRAIN_B} ({TRAIN_B // len(ranks)} a rank), parameters, BN "
            "state and Adam moments bit-equal to rank 0's after every step, "
            "1 EMD launch a step, loss first "
            f"{steps[0]['loss']:.6f} last {steps[-1]['loss']:.6f}; step ms "
            "(host clock) " + ", ".join(f"{s['wall_ms']:.1f}" for s in steps)
            + "; split, ms (median, CUDA events): " + ", ".join(
                f"{k} {v:.3f}" for k, v in res["split_median"].items()))
        sh = res["sharded"]
        if sh["launches"] != DP_COUNTS:
            raise AssertionError(f"{label} rank {r}: sharded upsample "
                                 f"launches {sh['launches']}, not "
                                 f"{DP_COUNTS}")
        b = sh["alone"].shape[0]
        if not np.array_equal(sh["out"][r * b:(r + 1) * b], sh["alone"]):
            raise AssertionError(f"{label} rank {r}: its shard of the "
                                 "sharded upsample is not its clouds alone")
        out = sh["out"]
        err = np.abs(out - one_sharded).max(-1)
        moved = float((err > 2e-4).mean())
        cd = chamfer(torch.from_numpy(out).cuda(),
                     torch.from_numpy(one_sharded).cuda())
        log(f"{label} rank {r}: upsample_cloud_sharded of {DP_CLOUDS} clouds "
            f"({b} a rank) launches {sh['launches']}; its shard bit-equal to "
            f"its clouds alone; vs one process on all {out.shape[0]}: "
            f"bit-equal {np.array_equal(out, one_sharded)}, max_abs_diff "
            f"{float(err.max()):.3e}, {moved:.4%} of the points beyond atol "
            f"2e-4 (merge near-ties), Chamfer {cd:.3e} (gate 1e-4); ms a "
            "call " + ", ".join(f"{t:.2f}" for t in sh["ms"]) + "; a gloo "
            f"all-reduce of 64 floats on the card {res['small_ms']:.3f} ms")
        if not cd < 1e-4:
            raise AssertionError(f"{label}: sharded upsample vs one process: "
                                 f"Chamfer {cd}")


def phase_data_parallel(model, card):
    """Data-parallel training and cloud-sharded upsampling of the discrete
    family (`puflow_torch.parallel`): two ranks spawned on the one card
    with `gloo` (NCCL refuses two ranks on one card), each through
    `torch_parallel_cases.card_train_rank` (the first-step gradient at one
    cloud a rank held to the one-process gradient on the card; 10 steps at
    global batch 32; the folded model's `upsample_cloud_sharded` of 8
    clouds held to the one-process run; `check_dp_ranks`); one NCCL rank
    at world size 1 held bit-equal to the plain `Trainer` over 3 steps,
    both with PyTorch's deterministic algorithms; with more than one card
    the same checks under NCCL across ``min(count, 4)`` cards. Two ranks
    on one card measure correctness and overhead, not scaling."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(0)
    batch = synthetic_pairs(rng, TRAIN_B, TRAIN_N, UPRATIO)
    params, state = seeded_first_step(batch[0], "cuda")
    up_params, up_state = checkpoint.to_numpy_tree(model)
    pc = synthetic_clouds(DP_CLOUDS, SEED).cpu().numpy()
    layout = TreeLayout(params)
    one_sharded = upsample_one_process(up_params, up_state, pc, NPOINT,
                                       "cuda").cpu().numpy()

    def two_rank_run(label, n, backend, devices):
        grad_batch = synthetic_pairs(np.random.RandomState(1), n, TRAIN_N,
                                     UPRATIO)
        b = TRAIN_B - TRAIN_B % n
        tr = Trainer(TrainConfig(), params, state, device="cuda")
        one = gradients(tr, *grad_batch)
        one["fixed"] = gradients(tr, *grad_batch, one["assign"])["fixed"]
        t0 = time.perf_counter()
        ranks = run_ranks(card_train_rank, n, params, state, grad_batch,
                          one["assign"], (batch[0][:b], batch[1][:b]),
                          DP_STEPS, (up_params, up_state,
                                     pc[:DP_CLOUDS // n * n], NPOINT),
                          backend=backend, devices=devices, timeout_s=300)
        log(f"{label}: {n} ranks spawned and run in "
            f"{time.perf_counter() - t0:.1f} s ({card})")
        check_dp_ranks(label, ranks, layout, one,
                       one_sharded[:DP_CLOUDS // n * n])

    two_rank_run("data_parallel gloo, 2 ranks on one card", DP_WORLD, "gloo",
                 ["cuda:0"] * DP_WORLD)
    t0 = time.perf_counter()
    batches = [synthetic_pairs(rng, TRAIN_B, TRAIN_N, UPRATIO)
               for _ in range(3)]
    (rows,) = run_ranks(nccl_one_rank, 1, params, state, batches,
                        backend="nccl", devices=["cuda:0"], timeout_s=300)
    log(f"data_parallel nccl, world size 1 ({time.perf_counter() - t0:.1f} "
        f"s): trainer vs the plain Trainer over {len(rows)} steps at batch "
        f"{TRAIN_B}, (params bit-equal, BN state bit-equal, max |diff|) "
        f"{rows}")
    if not all(p and s for p, s, _ in rows):
        raise AssertionError("nccl at world size 1 is not the plain trainer")
    count = torch.cuda.device_count()
    if count > 1:
        n = min(count, 4)
        two_rank_run(f"data_parallel nccl, {n} cards", n, "nccl",
                     [f"cuda:{i}" for i in range(n)])
    else:
        log("data_parallel nccl across cards: one card here, not run")
    log(f"phase data_parallel: {time.perf_counter() - t_phase:.1f} s "
        f"({card})")


DPC_CLOUDS = 8           # clouds of the sharded CNF upsample (4 a rank)
DPC_REPS = 5             # timed sharded upsamples a rank


def check_cnf_dp_ranks(label, ranks, refs) -> dict:
    """The checks of `card_cnf_rank`'s results against the one-process
    runs ``refs`` (label -> {"upsample", "eval"}), for each weight set:

      * the sharded upsample: the ranks' outputs bit-equal; on every rank
        the 12 solves' [attempted, accepted] those of the one-process
        `upsample_cloud`; the model's predictions (the ranks' patches in
        rank order) within atol 1e-4 of the one-process run's (the
        `sample` gate); the merged clouds by Chamfer < 1e-4 a cloud (the
        pipeline gate of `phase_main_path`), their largest difference and
        the share beyond atol 1e-4 printed: a cloud's mean rounds by batch
        size on the card, and the merge's FPS takes other points from
        near-ties;
      * `forward(train=False)`: the 12 solves' steps the one-process
        run's, the NLL the same on every rank and within rtol 1e-5 of the
        one-process NLL, the dense clouds within atol 1e-4;
      * the unrecorded runs' counts: 12 solves an upsample (6 f, 6 g) and
        6 + 6 an eval, each in the per-attempt mode: one launch an attempt
        and one that finishes.
    -> label -> the launches of the per-attempt kernels summed over the
    ranks, {"cnf_solve": from the upsample, "cnf_solve_logp": from the
    eval}."""
    counts = {}
    for w, ref in refs.items():
        one, one_eval = ref["upsample"], ref["eval"]
        ups = [r[w]["upsample"] for r in ranks]
        evs = [r[w]["eval"] for r in ranks]
        for r, (up, ev) in enumerate(zip(ups, evs)):
            if not np.array_equal(up["out"], ups[0]["out"]):
                raise AssertionError(f"{label} {w}: rank {r}'s upsample is "
                                     "not rank 0's")
            if up["steps"] != one["steps"] or ev["steps"] != one_eval["steps"]:
                raise AssertionError(
                    f"{label} {w} rank {r}: steps {up['steps']} / "
                    f"{ev['steps']}, one process {one['steps']} / "
                    f"{one_eval['steps']}")
            if ev["nll"] != evs[0]["nll"]:
                raise AssertionError(f"{label} {w}: the ranks' NLLs differ")
        pred = np.concatenate([u["pred"] for u in ups])
        p_err = float(np.abs(pred - one["pred"]).max())
        out = ups[0]["out"]
        err = np.abs(out - one["out"]).max(-1)
        cd = chamfer(torch.from_numpy(out).cuda(),
                     torch.from_numpy(one["out"]).cuda())
        dense = np.concatenate([e["x"] for e in evs])
        d_err = float(np.abs(dense - one_eval["x"]).max())
        nll_rel = abs(evs[0]["nll"] - one_eval["nll"]) / abs(one_eval["nll"])
        log(f"{label} {w}: upsample_cloud_sharded of {out.shape[0]} clouds "
            f"({out.shape[0] // len(ranks)} a rank): ranks bit-equal, the "
            f"12 solves' steps the one-process run's {one['steps']}; "
            f"predictions max_abs_err {p_err:.3e} (atol 1e-4); merged "
            f"clouds largest difference {float(err.max()):.3e}, "
            f"{float((err > 1e-4).mean()):.4%} of the points beyond atol "
            f"1e-4 (merge near-ties), Chamfer {cd:.3e} (gate 1e-4)")
        log(f"{label} {w}: forward(train=False) on {dense.shape[0]} patches "
            f"({dense.shape[0] // len(ranks)} a rank): steps the one-process "
            f"run's {one_eval['steps']}; NLL {evs[0]['nll']:.6f} vs "
            f"{one_eval['nll']:.6f} (rel {nll_rel:.3e}, rtol 1e-5); dense "
            f"max_abs_err {d_err:.3e} (atol 1e-4)")
        if not (p_err <= 1e-4 and cd < 1e-4 and d_err <= 1e-4
                and nll_rel <= 1e-5):
            raise AssertionError(f"{label} {w}: sharded CNF paths off the "
                                 "one-process run")
        expect = {"upsample": {"cnf_solve": 12, "cnf_solve_logp": 0},
                  "eval": {"cnf_solve": 6, "cnf_solve_logp": 6}}
        for r, res in enumerate(ranks):
            runs = res[w]["launches"]
            steps = {"upsample": (one["steps"], []),
                     "eval": (one_eval["steps"][6:],
                              one_eval["steps"][:6])}
            for run, counts_of in runs.items():
                plain, logp = steps[run]
                want = {"cnf_solve": [expect[run]["cnf_solve"], sum(
                            s[0] + 1 for s in plain)],
                        "cnf_solve_logp": [expect[run]["cnf_solve_logp"],
                                           sum(s[0] + 1 for s in logp)]}
                if counts_of != want:
                    raise AssertionError(
                        f"{label} {w} rank {r} {run}: [solves, per-attempt "
                        f"launches] {counts_of}, not {want}")
            log(f"{label} {w} rank {r}: [solves, per-attempt launches] "
                f"{runs}; sharded upsample ms a call (host clock) "
                + ", ".join(f"{t:.2f}" for t in res[w]["ms"]))
        counts[w] = {
            "cnf_solve": sum(r[w]["launches"]["upsample"]["cnf_solve"][1]
                             for r in ranks),
            "cnf_solve_logp": sum(
                r[w]["launches"]["eval"]["cnf_solve_logp"][1]
                for r in ranks)}
    return counts


def attempt_cases(model):
    """The NCCL world-size-1 cases of `attempt_solves_rank` at the
    training solves' inputs (`training_solve_inputs`, block 3, condition
    width 128), seeded and perturbed weights: the log-density solve f, R =
    8,192, 0 -> T, and the plain solve g, R = 32,768, r = 4, T -> 0. ->
    [(weights, name, args on the card, numpy case)]."""
    x, cs, latents, weights = training_solve_inputs(model)
    rng = np.random.RandomState(SEED + 8)
    logp0 = torch.from_numpy((rng.randn(*x.shape[:2], 1) * 0.1)
                             .astype(np.float32)).cuda()
    out = []
    for label, blocks in weights:
        bp = blocks[3]
        T = float(bp["sqrt_end_time"] * bp["sqrt_end_time"])
        for name, args in (
                ("cnf_solve_logp", (bp["layers"], cs[3], x, logp0, 0.0, T)),
                ("cnf_solve", (bp["layers"], cs[3], latents, T, 0.0))):
            case = (name, tree_map(lambda t: t.cpu().numpy(),
                                   bp["layers"])) + tuple(
                a.cpu().numpy() if torch.is_tensor(a) else a
                for a in args[1:])
            out.append((label, name, args, case))
    return out


def check_attempt_mode(results, cases, rows, card) -> None:
    """`attempt_solves_rank`'s results (one NCCL rank): the per-attempt
    mode bit-equal to the one-launch kernel (outputs and stats, two runs),
    one launch an attempt plus one; against the plain version on the same
    inputs within 5e-6 at seeded weights, `SOLVER_TOL` and `witness_check`
    at perturbed ones; the perturbed solves give the kernel line's rows
    (ms a solve in each mode, the plain version's, the bound)."""
    for (label, name, args, _), res in zip(cases, rows):
        row = f"{name}_attempt"
        if not (np.array_equal(res["attempt"], res["one"])
                and np.array_equal(res["again"], res["one"])
                and res["steps"] == res["one_steps"]
                and res["attempt_launches"] == res["steps"][0] + 1):
            raise AssertionError(f"{row} {label}: not the one-launch "
                                 f"kernel's bits, steps {res['steps']} vs "
                                 f"{res['one_steps']}, launches "
                                 f"{res['attempt_launches']}")
        plain = (cnf_ops.cnf_solve_logp_plain if name == "cnf_solve_logp"
                 else cnf_ops.cnf_solve_plain)
        ref, ref_stats = plain(*args, return_stats=True)
        ref = torch.cat(ref, -1) if isinstance(ref, tuple) else ref
        if res["steps"] != [ref_stats["steps"], ref_stats["accepted"]]:
            raise AssertionError(f"{row} {label}: steps {res['steps']}, "
                                 f"plain {ref_stats}")
        got = torch.from_numpy(res["attempt"]).cuda()
        log(f"{row} {label} weights, world size 1 over NCCL: bit-equal to "
            f"the one-launch kernel (two runs), steps {res['steps']}, "
            f"{res['attempt_launches']} launches")
        check_close(results, row, got, ref,
                    5e-6 if label == "seeded" else SOLVER_TOL)
        if label != "perturbed":
            continue
        if name == "cnf_solve_logp":
            witness_check(args, got, ref, rk4_witness_logp,
                          WITNESS_STEPS // 8, row)
            logp_bound(results[row], *args[:4], res["steps"][0])
            plain_ms = time_ms(lambda: plain(*args), 1)
        else:
            witness_check(args, got, ref, steps=WITNESS_STEPS // 4,
                          name=row)
            solve_bound(results[row], args[0], args[1], args[2],
                        res["steps"][0])
            plain_ms = time_ms(lambda: plain(*args), 3)
        results[row].update(ms=res["ms"], plain_ms=plain_ms, library_ms=None)
        log(f"{row}: per-attempt {res['ms']:.4f} ms a solve (CUDA events; "
            f"{res['local_ms']:.4f} with no exchange), one-launch "
            f"{res['one_ms']:.4f} (x{res['ms'] / res['one_ms']:.2f}); the "
            f"kernels' device ms a solve (profiler) {res['device_ms']:.4f} "
            f"in {res['attempt_launches']} launches, one-launch "
            f"{res['one_device_ms']:.4f}; plain {plain_ms:.4f}, bound "
            f"{results[row]['bound_ms']:.4f} ms ({results[row]['bound_by']}; "
            f"{card})")


def phase_cnf_data_parallel(results, model, card):
    """CNF serving and validation data parallel (`upsample_cloud_sharded`
    and `continuous.forward(train=False, group=)` of the CNF family, every
    solve in `csrc/cnf_solve.cu`'s per-attempt mode with the ranks' error
    sums exchanged each attempt): two `gloo` ranks spawned on the one card
    (`torch_parallel_cnf_cases.card_cnf_rank`) at the seeded and the
    perturbed full-width model (the folded model's sharded upsample of 8
    clouds, 2048 -> 8192 points; the unfolded model's forward on 32
    main-path patches), held to the one-process runs on the card by
    `check_cnf_dp_ranks`; one NCCL rank at world size 1 holding the
    per-attempt mode of both entries bit-equal to the one-launch kernel
    and to the plain versions (`check_attempt_mode`); with more than one
    card the two-rank checks under NCCL across ``min(count, 4)`` cards.
    ``model``: the perturbed unfolded CNF model. Sets the kernel line's
    per-attempt rows."""
    t_phase = time.perf_counter()
    pc = synthetic_clouds(DPC_CLOUDS, SEED + 9).cpu().numpy()
    x = main_path_patches(1).cpu().numpy()
    weights = [("seeded", *checkpoint.to_numpy_tree(seeded_cnf_model())),
               ("perturbed", *checkpoint.to_numpy_tree(model))]
    refs = {w: {"upsample": cnf_upsample_one_process(
                    p, s, pc, NPOINT, UPRATIO, PATCH, EXPAND, "cuda"),
                "eval": cnf_eval_one_process(p, s, x, UPRATIO, "cuda")}
            for w, p, s in weights}

    def ranks_run(label, n, backend, devices):
        t0 = time.perf_counter()
        ranks = run_ranks(card_cnf_rank, n, weights, pc[:DPC_CLOUDS // n * n],
                          NPOINT, x[:len(x) // n * n], DPC_REPS,
                          backend=backend, devices=devices, timeout_s=300)
        log(f"{label}: {n} ranks spawned and run in "
            f"{time.perf_counter() - t0:.1f} s ({card})")
        return check_cnf_dp_ranks(label, ranks, refs)

    counts = ranks_run("cnf_data_parallel gloo, 2 ranks on one card", 2,
                       "gloo", ["cuda:0"] * 2)
    for name in ("cnf_solve", "cnf_solve_logp"):
        results[f"{name}_attempt"]["launches"] = counts["perturbed"][name]
    t0 = time.perf_counter()
    cases = attempt_cases(model)
    rows = nccl_in_process(attempt_solves_rank, [c[3] for c in cases], 5)
    log(f"cnf_data_parallel nccl, world size 1 (this process): run in "
        f"{time.perf_counter() - t0:.1f} s")
    check_attempt_mode(results, cases, rows, card)
    count = torch.cuda.device_count()
    if count > 1:
        n = min(count, 4)
        ranks_run(f"cnf_data_parallel nccl, {n} cards", n, "nccl",
                  [f"cuda:{i}" for i in range(n)])
    else:
        log("cnf_data_parallel nccl across cards: one card here, not run")
    log(f"phase cnf_data_parallel: {time.perf_counter() - t_phase:.1f} s "
        f"({card})")


DPT_STEPS = 3            # data-parallel CNF train steps at bench_cnf_train's
DPT_REPS = 3             # timed per-attempt adjoint solves a mode


def nccl_in_process(fn, *args):
    """``fn(group, *args)`` on an NCCL group of world size 1 started in
    this process (a ``file://`` rendezvous) and ended after: a spawned
    rank would cost its start-up (20-25 s a phase). Only for rank bodies
    that change no process-wide setting."""
    with tempfile.TemporaryDirectory() as tmp:
        group = parallel.init_group("nccl", 0, 1, "cuda:0",
                                    init_method=f"file://{tmp}/store")
        try:
            return fn(group, *args)
        finally:
            parallel.destroy_group()


def adjoint_attempt_cases(model):
    """The NCCL world-size-1 cases of `attempt_adjoint_rank` at the
    training backward solves' inputs (block 3, condition width 128): the f
    path with the trace (R = 8,192, T -> 0) and the g path (R = 32,768, r
    = 4, 0 -> T), seeded and perturbed weights. -> [(label, path, args on
    the card, keywords, numpy case)]."""
    x, cs, latents, weights = training_solve_inputs(model)
    rng = np.random.RandomState(SEED + 10)
    out = []
    for label, blocks in weights:
        for path in ("f", "g"):
            args, kw = adjoint_case((x, cs, latents), rng, blocks, 3, path)
            logp1 = kw.get("logp1")
            case = {"layers": tree_map(lambda t: t.cpu().numpy(), args[0]),
                    "args": [a.cpu().numpy() for a in args[1:5]]
                    + [float(args[5]), float(args[6])],
                    "with_trace": kw["with_trace"],
                    "logp1": None if logp1 is None else logp1.cpu().numpy()}
            out.append((label, path, args, kw, case))
    return out


def adjoint_f64(args, kw):
    """`cnf_adjoint_bwd_plain` in float64 on the same inputs: the witness
    a float32 solve's leaves are measured against."""
    def f64(t):
        return t.double() if torch.is_tensor(t) else t

    layers = tree_map(f64, args[0])
    kw64 = dict(kw, logp1=f64(kw.get("logp1")))
    return cnf_ops.cnf_adjoint_bwd_plain(layers, *map(f64, args[1:]),
                                         **kw64)


def check_adjoint_attempt_mode(results, cases, rows, card) -> None:
    """`attempt_adjoint_rank`'s results (one NCCL rank): the per-attempt
    adjoint bit-equal to the one-launch kernel (y0, a0, dc, G, the
    boundary fields, the stats; two runs alike), one launch an attempt
    plus one; the one-launch kernel on the same inputs here against the
    plain version: each leaf within `compare_cnf_adjoint`'s 2e-3
    max-relative, or else (where step sizes follow the error estimate and
    a small leaf moves with them) no farther from the plain version in
    float64 than 1.25 times the float32 plain version's distance plus
    1e-6, as `tests/test_torch_cuda.py::
    test_cnf_adjoint_kernel_matches_plain` holds it; the perturbed f
    solve gives the kernel line's row (ms a solve in each mode, the plain
    version's, the bound)."""
    row = results["cnf_adjoint_bwd_attempt"]
    for (label, path, args, kw, _), res in zip(cases, rows):
        name = f"cnf_adjoint_bwd_attempt {label} {path}"
        if not (np.array_equal(res["attempt"], res["one"])
                and np.array_equal(res["again"], res["one"])
                and res["steps"] == res["one_steps"]
                and res["attempt_launches"] == res["steps"][0] + 1):
            raise AssertionError(f"{name}: not the one-launch kernel's bits, "
                                 f"steps {res['steps']} vs "
                                 f"{res['one_steps']}, launches "
                                 f"{res['attempt_launches']}")
        out = cnf_ops.cnf_adjoint_bwd(*args, **kw, return_stats=True)
        if not np.array_equal(adjoint_outputs(out), res["one"]):
            raise AssertionError(f"{name}: the one-launch kernel differs "
                                 "between the rank and this process")
        ref = cnf_ops.cnf_adjoint_bwd_plain(*args, **kw, return_stats=True)
        if res["steps"] != [ref[-1]["steps"], ref[-1]["accepted"]]:
            raise AssertionError(f"{name}: steps {res['steps']}, plain "
                                 f"{ref[-1]}")
        worst, truth = 0.0, None
        for i, ((leaf, g), (_, r)) in enumerate(zip(adjoint_leaves(out),
                                                    adjoint_leaves(ref))):
            rel = maxrel(g, r)
            if not rel < 2e-3:
                if truth is None:
                    truth = [t for _, t in adjoint_leaves(adjoint_f64(args,
                                                                      kw))]
                w = truth[i]
                err, floor = maxrel(g.double(), w), maxrel(r.double(), w)
                log(f"{name} {leaf}: {rel:.3e} max-relative against the "
                    f"plain version; against it in float64 the kernel "
                    f"{err:.3e}, the float32 plain version {floor:.3e}")
                if not err <= 1.25 * floor + 1e-6:
                    raise AssertionError(f"{name} {leaf}: max-relative {rel}"
                                         " against the plain version, and "
                                         f"{err} > 1.25 x {floor} + 1e-6 "
                                         "against it in float64")
            worst = max(worst, rel)
            row["max_abs_err"] = max(row.get("max_abs_err", 0.0),
                                     float((g - r).abs().max()))
        log(f"{name} (cdim 128, R = {args[2].shape[0] * args[2].shape[1]}) "
            f"at world size 1 over NCCL: bit-equal to the one-launch kernel "
            f"(two runs), steps {res['steps']}, {res['attempt_launches']} "
            f"launches; against the plain version worst max-relative "
            f"{worst:.3e} (gate 2e-3, or the float64 witness)")
        log(f"{name}: per-attempt {res['ms']:.4f} ms a solve (CUDA events; "
            f"{res['local_ms']:.4f} with no exchange), one-launch "
            f"{res['one_ms']:.4f} (x{res['ms'] / res['one_ms']:.2f}); the "
            f"kernels' device ms a solve (profiler) {res['device_ms']:.4f} "
            f"in {res['attempt_launches']} launches, one-launch "
            f"{res['one_device_ms']:.4f} ({card})")
        if label == "perturbed" and path == "f":
            adjoint_bound(row, args, kw, out, res["steps"][0])
            plain_ms = time_ms(
                lambda: cnf_ops.cnf_adjoint_bwd_plain(*args, **kw), 1)
            row.update(ms=res["ms"], plain_ms=plain_ms, library_ms=None)
            log(f"cnf_adjoint_bwd_attempt row (perturbed, f): {res['ms']:.4f}"
                f" ms, plain {plain_ms:.4f}, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}; {card})")


def check_cnf_train_ranks(label, ranks, layout, one) -> dict:
    """The checks of `card_cnf_train_rank`'s results against the
    one-process run ``one`` (`cnf_grad` on the card at the global batch,
    its auction's assignment ``one["assign"]``):

      * the ranks' gradients bit-equal (with their own auction and at the
        one-process assignment);
      * on every rank each of the 24 solves' [attempted, accepted] the
        one-process run's (6 f and 6 g forward, 12 backward);
      * at the one-process assignment, the ranks' summed gradient against
        the one-process gradient at `phase_cnf_grad`'s gates: the same
        leaves zero to rounding, none a CNF block's, every other within
        2e-2 max-relative; the assignments each rank's own auction moves
        counted (the auction is not continuous in its input);
      * every train step: parameters, BN state and Adam moments bit-equal
        across ranks, finite loss, 6 + 6 + 12 solves and one EMD launch a
        rank, each per-attempt solve in at least 4 launches; each rank's
        split with its exchanges' ms.
    -> the adjoint's per-attempt launches of the first step, summed over
    the ranks."""
    for r, res in enumerate(ranks):
        for key in ("grads", "fixed"):
            if not np.array_equal(res[key], ranks[0][key]):
                raise AssertionError(f"{label}: rank {r}'s {key} gradient "
                                     "is not rank 0's")
        if res["steps"] != one["steps"]:
            raise AssertionError(f"{label} rank {r}: steps {res['steps']}, "
                                 f"one process {one['steps']}")
    moved = int((np.concatenate([r["assign"] for r in ranks])
                 != one["assign"]).sum())
    got_tree = tree_paths(layout.numpy_tree(torch.from_numpy(
        ranks[0]["fixed"])))
    want_tree = tree_paths(layout.numpy_tree(torch.from_numpy(one["grads"])))
    names = [p for p, _ in want_tree]
    got = [torch.from_numpy(np.asarray(g)) for _, g in got_tree]
    want = [torch.from_numpy(np.asarray(w)) for _, w in want_tree]
    zero_got, zero_want = rounding_zero(names, got), rounding_zero(names, want)
    if set(zero_got) != set(zero_want):
        raise AssertionError(f"{label}: the leaves zero to rounding differ: "
                             f"{sorted(set(zero_got) ^ set(zero_want))}")
    if [p for p in zero_want if p.startswith("/flow_blocks/")]:
        raise AssertionError(f"{label}: CNF-block leaves zero to rounding")
    worst = ("", 0.0)
    for path, g, w in zip(names, got, want):
        if path in zero_want:
            continue
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label} {path}: non-finite gradient")
        rel = maxrel(g, w)
        if not rel < 2e-2:
            raise AssertionError(f"{label} {path}: summed gradient vs one "
                                 f"process max-relative {rel} >= 2e-2")
        worst = max(worst, (path, rel), key=lambda x: x[1])
    log(f"{label}: gradients bit-equal across the ranks; the 24 solves' "
        f"steps the one-process run's {one['steps']}; at the one-process "
        f"assignment the summed gradient within 2e-2 of one process's in "
        f"{len(names) - len(zero_want)} leaves (worst {worst[1]:.3e}, "
        f"{worst[0]}); the ranks' own auction moved {moved} of "
        f"{one['assign'].size} assignments")
    launches = 0
    for r, res in enumerate(ranks):
        for i, st in enumerate(res["steps_run"]):
            counts = st["launches"]
            solves = {k: v[0] for k, v in counts.items() if k != "emd"}
            if not (st["bit_equal"] and np.isfinite(st["loss"])
                    and not st["nan_step"] and counts["emd"] == 1
                    and solves == {k: n for k, n in GRAD_LAUNCHES.items()
                                   if k != "emd"}
                    and all(v[1] >= 4 * v[0] for k, v in counts.items()
                            if k != "emd")):
                raise AssertionError(f"{label} rank {r} step {i}: {st}")
            split = ", ".join(f"{k} {v:.1f}" for k, v in st["split"].items())
            log(f"{label} rank {r} step {i}: loss {st['loss']:.6f}, wall "
                f"{st['wall_ms']:.1f} ms, split ms {split}; "
                f"{st['exchanges']} per-attempt exchanges "
                f"{st['exchange_ms']:.1f} ms (host clock); [solves, "
                f"per-attempt launches] {counts}")
        launches += res["steps_run"][0]["launches"]["cnf_adjoint_bwd"][1]
    return launches


def phase_cnf_train_data_parallel(results, model, card):
    """CNF training data parallel (`Trainer(..., forward_fn=
    continuous.forward, group=)`: every solve of a step, the 12 forward
    and the 12 adjoint backward solves, in its kernel's per-attempt mode,
    the ranks' sums exchanged each attempt, so that each step is judged on
    the global batch's error norm with G, the layers' cotangent, counted
    once):

      (a) one NCCL rank at world size 1: the per-attempt adjoint bit-equal
          to the one-launch kernel at the f (R = 8,192, trace) and g
          (R = 32,768, r = 4) shapes, seeded and perturbed, two runs
          alike, with the launch count, ms with and without the exchange
          beside the one-launch kernel's and the device ms
          (`check_adjoint_attempt_mode`);
      (b) two `gloo` ranks on the one card at the seeded full-width model
          and `bench.py:bench_cnf_train`'s global batch (32 clouds, 256 ->
          1024 points): the gradient's checks against one process on the
          card (`check_cnf_train_ranks`) and `DPT_STEPS` trainer steps;
      (c) `torchrun --standalone --nproc_per_node 2 -m
          puflow_torch.cli.train_cnf --synthetic 2` (gloo, both ranks on
          the card) for one epoch: rank 0 writes the checkpoint;
      (d) with more than one card, (b) under NCCL across ``min(count, 4)``
          cards.
    ``model``: the perturbed unfolded CNF model. Sets the kernel line's
    per-attempt adjoint row."""
    t_phase = time.perf_counter()
    cases = adjoint_attempt_cases(model)
    t0 = time.perf_counter()
    rows = nccl_in_process(attempt_adjoint_rank, [c[4] for c in cases],
                           DPT_REPS)
    log(f"cnf_train_data_parallel nccl, world size 1 (this process): run in "
        f"{time.perf_counter() - t0:.1f} s")
    check_adjoint_attempt_mode(results, cases, rows, card)

    params, state = checkpoint.to_numpy_tree(seeded_cnf_model())
    layout = TreeLayout(params)
    rng = np.random.RandomState(SEED + 11)
    grad_batch = synthetic_pairs(rng, TRAIN_B, TRAIN_N, UPRATIO)
    batch = synthetic_pairs(rng, TRAIN_B, TRAIN_N, UPRATIO)
    seen = []
    one = cnf_grad(cnf_trainer(params, state, device="cuda"), *grad_batch,
                   emd=recording_emd(seen))
    one["assign"] = seen[0].cpu().numpy()

    def ranks_run(label, n, backend, devices):
        b = TRAIN_B - TRAIN_B % n
        t0 = time.perf_counter()
        ranks = run_ranks(card_cnf_train_rank, n, params, state,
                          (grad_batch[0][:b], grad_batch[1][:b]),
                          one["assign"][:b], (batch[0][:b], batch[1][:b]),
                          DPT_STEPS, backend=backend, devices=devices,
                          timeout_s=600)
        log(f"{label}: {n} ranks spawned and run in "
            f"{time.perf_counter() - t0:.1f} s ({card})")
        return check_cnf_train_ranks(label, ranks, layout, one)

    row = results["cnf_adjoint_bwd_attempt"]
    row["launches"] = ranks_run("cnf_train_data_parallel gloo, 2 ranks on "
                                "one card", 2, "gloo", ["cuda:0"] * 2)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "cnf.npz")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "puflow_torch.cli.train_cnf",
               "--synthetic", "2", "--max_epochs", "1", "--device",
               "cuda:0", "--dist_backend", "gloo", "--checkpoint", ckpt]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=subprocess_env(),
                              capture_output=True, text=True, timeout=600)
        log(f"torchrun train_cnf, 2 gloo ranks on the card (exit "
            f"{proc.returncode}, {time.perf_counter() - t0:.1f} s): "
            f"{proc.stdout.strip()[-2000:]}")
        if proc.returncode != 0:
            raise AssertionError(f"torchrun train_cnf failed:\n"
                                 f"{proc.stderr[-4000:]}")
        final = ckpt.replace(".npz", "-epoch1.npz")
        saved = checkpoint.load_numpy_checkpoint(final, "cnf")
        leaves = [v for _, v in tree_paths(saved[0])]
        if not all(np.isfinite(np.asarray(v)).all() for v in leaves):
            raise AssertionError("torchrun train_cnf: non-finite weights")
        log(f"torchrun train_cnf: rank 0 wrote {os.path.basename(final)} "
            f"({len(leaves)} finite leaves)")

    count = torch.cuda.device_count()
    if count > 1:
        n = min(count, 4)
        ranks_run(f"cnf_train_data_parallel nccl, {n} cards", n, "nccl",
                  [f"cuda:{i}" for i in range(n)])
    else:
        log("cnf_train_data_parallel nccl across cards: one card here, not "
            "run")
    log(f"phase cnf_train_data_parallel: {time.perf_counter() - t_phase:.1f}"
        f" s ({card})")


# the port's own kernels, by the names their sources give them
PORT_KERNEL_NAMES = ("fps_kernel", "fps_cluster_kernel", "knn_self_kernel",
                     "encoder_rows_kernel", "encoder_edge_kernel",
                     "interp_head_kernel", "flow_f_kernel", "flow_g_kernel")
FOLDING_STEPS = 150
TRACE_PAD = 1000


def library_splines(card):
    """The three spline couplings at the discrete flow's widths (3
    channels split 1 and 2, hidden 64, conditions of 128, 64 bins, tail
    bound 5) on 32 patches of 256 points and, for the inverse, of 1,024
    (x4): forward then inverse within JAX's round-trip gates (1e-4, cubic
    2e-2) lane by lane, the forward at 256 and the inverse at 1,024 held
    to the CPU's float64 at the CPU tests' gates, ms a call."""
    for kind in SPLINE_KINDS:
        for split in (1, 2):
            params, x, c = coupling_case(SEED + split, kind, split, N_PATCH,
                                         PATCH, "cuda")
            _, y, cy = coupling_case(SEED + 10 + split, kind, split,
                                     N_PATCH, PATCH * UPRATIO, "cuda")
            gate = 2e-2 if kind == "cubic" else 1e-4
            trips = []
            for inp, cc in ((x, c), (y, cy)):
                out, ld = lanes(params, inp, cc, split, kind, False)
                back, ld_back = lanes(
                    params, torch.cat([inp[..., :split], out], -1), cc,
                    split, kind, True)
                trip = (float((back - inp[..., split:]).abs().max()),
                        float((ld + ld_back).abs().max()))
                if max(trip) > gate:
                    raise AssertionError(f"spline {kind} split {split}: round"
                                         f" trip {trip} past {gate}")
                trips.append(trip)
            z = spline_coupling.spline_coupling_forward(params, y, cy, split,
                                                        kind)[0]
            fwd = check_direction(params, x, c, split, kind, False)
            inv = check_direction(params, z, cy, split, kind, True)
            ms_f = time_ms(lambda: spline_coupling.spline_coupling_forward(
                params, x, c, split, kind), 20)
            ms_i = time_ms(lambda: spline_coupling.spline_coupling_inverse(
                params, z, cy, split, kind), 20)
            log(f"spline {kind} split {split}: forward [{N_PATCH}, {PATCH}, "
                f"3] {ms_f:.4f} ms a call, inverse [{N_PATCH}, "
                f"{PATCH * UPRATIO}, 3] {ms_i:.4f} ms a call ({card}); "
                f"round trip (out, logdet) {trips[0][0]:.3g}, "
                f"{trips[0][1]:.3g} / {trips[1][0]:.3g}, {trips[1][1]:.3g} "
                f"(gate {gate}); against the CPU's float64 forward "
                f"{fwd['out']:.3g} / {fwd['logdet']:.3g}, inverse "
                f"{inv['out']:.3g} / {inv['logdet']:.3g} (gates 2e-5 / "
                f"lane gates up to {max(fwd['gate'], inv['gate']):.3g})")


def library_folding(card, tmp, clouds):
    """The folding net trained on the card from seeded parameters; the
    loss must fall, the reference points must not move when the input is
    shuffled, and a `PermutateHelper` loaded from the saved `.npz` must
    permute as the in-memory function."""
    init = folding.folding_net_init(
        torch.Generator(device=clouds.device).manual_seed(SEED),
        device=clouds.device)
    init_loss = float(chamfer_distance(
        folding.folding_net_apply(init, clouds), clouds))
    # the first step of a process loads the optimizer's and the backward's
    # CUDA modules (8-12 s on an H100 with torch 2.11): one throwaway step
    # first
    t0 = time.perf_counter()
    folding.train_folding_net(None, clouds, 1, lr=3e-3, device=clouds.device,
                              params=init)
    torch.cuda.synchronize(clouds.device)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, loss = folding.train_folding_net(None, clouds, FOLDING_STEPS,
                                             lr=3e-3, device=clouds.device,
                                             params=init)
    torch.cuda.synchronize(clouds.device)
    train_s = time.perf_counter() - t0
    if not loss < init_loss:
        raise AssertionError(f"folding net: loss {loss} not below its "
                             f"initial {init_loss}")
    perm = torch.from_numpy(np.random.RandomState(SEED).permutation(
        clouds.shape[1])).to(clouds.device)
    with torch.no_grad():
        ref_a = folding.folding_net_apply(params, clouds)
        ref_b = folding.folding_net_apply(params, clouds[:, perm])
    moved = float((ref_a - ref_b).abs().max())
    if moved > 1e-5:
        raise AssertionError(f"folding net: shuffled input moved the "
                             f"reference points by {moved}")
    path = os.path.join(tmp, "folding.npz")
    permute.save_folding_params(path, params)
    helper = permute.PermutateHelper()
    helper.permutebyfolding(path, device=clouds.device)
    pts = clouds.cpu().numpy()
    out = helper.permute(pts)
    want = permute.permute_by_folding(pts, permute.bind_folding(params))
    if not np.allclose(out, want, rtol=0, atol=1e-6):
        raise AssertionError("folding net: the helper loaded from the .npz "
                             "permutes otherwise than the in-memory net")
    log(f"folding net: {FOLDING_STEPS} steps on {tuple(clouds.shape)} in "
        f"{train_s:.2f} s after a first step of {first_s:.2f} s ({card}); "
        f"chamfer {init_loss:.5f} -> {loss:.5f}; "
        f"shuffled input moves the reference points by {moved:.3g}; the "
        f".npz helper's permutation equal to the in-memory net's")


def library_trace(model, card, tmp):
    """`profile_trace` around one folded `upsample_cloud` of 8 clouds: its
    Chrome trace must hold a kernel record of each of the port's kernel
    functions that the folded path launches. On an H100 with torch 2.11 a
    trace loses its first kernel records, one for each CUDA child process
    this process has run before (4 records a trace after 4 children; 54 by
    this phase of the smoke): `TRACE_PAD` tiny kernels open the window and
    absorb them."""
    pc = synthetic_clouds(8, SEED)
    pad = torch.zeros(1, device="cuda")
    logdir = os.path.join(tmp, "trace")
    with torch.no_grad(), profile_trace(logdir):
        for _ in range(TRACE_PAD):
            pad.add_(1.0)
        torch.cuda.synchronize()
        out = upsample_cloud(model, pc, NPOINT, UPRATIO, PATCH, EXPAND)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    launches = sum(e.get("cat") == "cuda_runtime"
                   and "aunch" in e.get("name", "") for e in events)
    found = sorted({k for k in PORT_KERNEL_NAMES for name in kernels
                    if re.search(rf"\b{k}[(<]", name)})
    log(f"profile_trace: {len(kernels)} CUDA kernel records of {launches} "
        f"launches ({TRACE_PAD} of them the pad; {launches - len(kernels)} "
        f"records lost) around one folded upsample_cloud of 8 clouds, the "
        f"port's kernels among them: {found} ({card})")
    if found != sorted(PORT_KERNEL_NAMES):
        raise AssertionError(f"profile_trace: no record of "
                             f"{sorted(set(PORT_KERNEL_NAMES) - set(found))}"
                             " in the trace")
    return pc, out


def phase_library(model, card):
    """The library surface on the card: the spline couplings, the folding
    net and its permutation helper, `profile_trace` and
    `hausdorff_distance` (no kernel of its own: plain PyTorch)."""
    t_phase = time.perf_counter()
    with torch.no_grad():
        library_splines(card)
    with tempfile.TemporaryDirectory() as tmp:
        clouds, _, _ = normalize_cloud(synthetic_clouds(4, SEED + 1))
        library_folding(card, tmp, clouds)
        pc, out = library_trace(model, card, tmp)
    hd = hausdorff_distance(out, pc)
    hd_cpu = hausdorff_distance(out.cpu(), pc.cpu())
    err = float((hd.cpu() - hd_cpu).abs().max())
    log(f"hausdorff_distance: 8 clouds of {out.shape[1]} against their "
        f"{pc.shape[1]} inputs, card {hd.cpu().numpy().round(6).tolist()}, "
        f"card - CPU {err:.3g}")
    if not torch.isfinite(hd).all() or err > 2e-6:
        raise AssertionError(f"hausdorff_distance: card and CPU differ by "
                             f"{err}")
    log(f"phase library: {time.perf_counter() - t_phase:.1f} s ({card})")


def timed(phase, *args, **kwargs):
    """``phase(*args, **kwargs)``, then its name (and path, for a phase of
    one path) and seconds on a line of their own."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    label = " ".join([phase.__name__] + [a for a in args[:1]
                                         if isinstance(a, str) and a in PATHS])
    log(f"[{label}: {time.perf_counter() - t0:.1f} s]")
    return out


def main():
    start = time.perf_counter()
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
        timed(compare_fps, results, rng)
        x = main_path_patches(8)                   # 256 patches x 256
        timed(compare_folded, folded, x, results, rng)
        timed(compare_flows, model, x, results)
    timed(phase_main_path, "folded", folded, results)
    timed(phase_main_path, "exact", model, results)
    timed(phase_timing, "folded", folded, card)
    timed(phase_timing, "exact", model, card)
    params, state, sparse, dense = training_inputs(model)
    timed(phase_emd, results, params, state, sparse, dense)
    timed(phase_train, results, params, state, sparse, dense, card)
    timed(phase_cli)
    timed(phase_large_patch, results, model, folded)

    cnf_model, cnf_folded = seeded_models("cnf")
    with torch.no_grad():
        timed(compare_cnf, cnf_model, results)
    timed(phase_main_path, "cnf_folded", cnf_folded, results)
    timed(phase_main_path, "cnf_exact", cnf_model, results)
    timed(phase_cnf_bench, "cnf_folded", cnf_folded, card)
    timed(phase_cnf_bench, "cnf_exact", cnf_model, card)
    timed(phase_timing, "cnf_folded", cnf_folded, card, batches=(1, 8))
    timed(phase_timing, "cnf_exact", cnf_model, card, batches=(8,))
    timed(phase_cnf_cli, cnf_model)

    with torch.no_grad():
        timed(compare_fps_seeded, results, rng)
    for name in ("seeded_merge", "union_groups"):
        for batch in (1, 32):
            timed(phase_main_path, name, folded, results, batch=batch)
    timed(phase_main_path, "cnf_seeded_merge", cnf_folded, results, batch=1)
    timed(phase_merge_timing, folded, card)
    timed(phase_merge_cli, model)

    with torch.no_grad():
        timed(compare_cnf_logp, cnf_model, results)
        timed(compare_cnf_adjoint, cnf_model, results)
    timed(phase_cnf_grad, results, card)
    timed(phase_cnf_eval, cnf_model)
    timed(phase_cnf_train, card)
    timed(phase_train_clis, cnf_folded)
    timed(phase_eval_protocol, model, folded, cnf_model, cnf_folded, card)
    timed(phase_export, model, folded, cnf_folded, card)
    timed(phase_data_parallel, model, card)
    timed(phase_cnf_data_parallel, results, cnf_model, card)
    timed(phase_cnf_train_data_parallel, results, cnf_model, card)
    timed(phase_library, folded, card)

    log(f"chip_smoke total {time.perf_counter() - start:.1f} s")
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
