"""Times variants of the self k-NN kernels on one CUDA card.

    python3 scripts/knn_variants.py [--parent DIR] [--stage] [--sass DIR]
                                    [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/knn_variants/` (gitignored) with one change to `csrc/knn.cu`; all
are built side by side, then each runs in its own process, the parent's
and this checkout's first, then the variants, then this checkout's and the
parent's again (in turns, so drift shows). Variants of the shared-memory
kernel (`knn_self_kernel`) run on the main path's patches: 32, 256 and
1,024 patches of 256 points (1, 8 and 32 clouds,
`chip_smoke.py:main_path_patches`), k = 16. For each the script prints
whether its indices equal `knn_self_plain`'s (at each size, on an integer
grid with many ties and on patches whose second half repeats the first),
whether two runs are bit-equal, the ms of a call at each size (CUDA
events, three windows of 10 after a warm-up), and whether the folded
pipeline's output on `chip_smoke.py`'s clouds at 8 and 32 clouds is
bit-equal to the first copy's. Variants of the streaming kernels
(`knn_cells_kernel`, `knn_scatter_kernel` and `knn_stream_kernel`;
`stream_`, `tile_` and `order_` names)
run on `chip_smoke.py`'s surfaces at [1, 10433], [4, 10433] (the CLI's
batch at `--num_patch 10433`) and [1, 32768]: indices against the plain
version there and on an integer grid, a repeated half and a clustered
patch at [1, 10433], reruns bit-equal, the ms of a call in three windows,
each kernel's device ms a call (torch.profiler, by kernel name: the
order's `knn_cells_kernel` and `knn_scatter_kernel`, the walk's
`knn_stream_kernel`) and the host's ms to enqueue a call. Every copy prints the registers and spill stores of the
main instantiations (`nvcc -Xptxas -v`). The `diag_` variants drop or
count work and fail the equality check: `diag_no_list` computes every
distance and keeps no list; `diag_count` writes into slots 0-2 of each
row the voted warp-steps in which a lane inserts, the voted steps walked,
and the steps in which a lane's key beats the front half of its list;
`diag_stream_count` writes the tiles the warp walked (its own included),
those the warp's box test skipped, those the queries' test skipped, and
a lane's steps past its own tile and those in which the warp ran the
insertion chain, and the script prints the shares of tiles and distances
computed; `diag_order_clock` prints block 0's clock cycles per phase of
the cells kernel and `diag_walk_clock` warp 0's of the walk. Both
`diag_count` variants run the exact walk alone. `--stage` then splits
the self k-NN stage of the folded pipeline at 32 clouds
(`chip_smoke.py:pipeline_staged`) in each copy that is not a diagnostic:
the device time from the stage's start to the launch and of the launch,
the host time before the wrapper and in it, whether the card had drained
its queue when the host reached the stage, the wrapper and the bare C
entry timed back to back, and the kernel's device time in a profiled
pipeline run. `--parent DIR` runs the `puflow_torch/` of another checkout
(for example `git archive` of the parent commit). `--sass DIR` writes
each copy's SASS (`cuobjdump -sass`) into DIR. Names pick variants; none
runs them all. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from flow_f_variants import (prepare, ptxas, registers,  # noqa: E402
                             run_in, swap)

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "runs" / "knn_variants"
KNN = "puflow_torch/csrc/knn.cu"
K = 16
STREAM_SHAPES = ((1, 10433), (4, 10433), (1, 32768))

# the shared-memory kernel
CHECK = "  if (kCheck && !valid) key = kNone;\n"
INSERT = CHECK + "  insert(list, key);\n"
ROW = "rows[g * k + j] = static_cast<int64_t>(static_cast<uint32_t>(list[j]));"
LANES = "  if (queries >= (1 << 16)) return launch_lanes<1>("
PREFILL = "    if (exact && full >= KL / kS) {"
NARROW = "    if constexpr (L == 1 && KL == kMaxK) {"
NO_NARROW = (KNN, swap(NARROW, "    if constexpr (false) {"))
INSERT_BODY = """  if (__any_sync(0xffffffffu, key < list[KL - 1])) {
    if (kHalf && !__any_sync(0xffffffffu, key < list[kHalf - 1])) {
#pragma unroll
      for (int j = kHalf; j < KL; ++j) order2(list[j], key);
    } else {
#pragma unroll
      for (int j = 0; j < KL; ++j) order2(list[j], key);
    }
  }
"""
NARROW_BODY = """  if (__any_sync(0xffffffffu, key < a[kNarrow - 1])) {
    if (!__any_sync(0xffffffffu, key < a[kHalf - 1])) {
#pragma unroll
      for (int j = kHalf; j < kNarrow; ++j) order2(a[j], key);
    } else {
#pragma unroll
      for (int j = 0; j < kNarrow; ++j) order2(a[j], key);
    }
  }
"""
FULL_CHAIN = """#pragma unroll
  for (int j = 0; j < KL; ++j) order2(list[j], key);
"""
COUNT = [
    NO_NARROW,
    (KNN, swap("__device__ __forceinline__ void consider(",
               "__device__ __forceinline__ void consider(int (&count)[3],\n")),
    (KNN, swap("(pts, q, list", "(count, pts, q, list")),
    (KNN, swap("  uint64_t list[KL];\n",
               "  uint64_t list[KL];\n  int count[3] = {0, 0, 0};\n")),
    (KNN, swap(INSERT, CHECK + "  ++count[1];\n  count[0] += __any_sync("
                       "0xffffffffu, key < list[KL - 1]);\n  count[2] += "
                       "__any_sync(0xffffffffu, key < list[KL > 1 ? KL / 2 - 1"
                       " : 0]);\n  insert(list, key);\n")),
    (KNN, swap(ROW, "rows[g * k + j] = j < 3 ? count[j] : "
                    "static_cast<int64_t>(static_cast<uint32_t>(list[j]));")),
]

STAGE_IN_ORDER = (KNN, swap(
    "  stage_sorted(src, n, pts, words);\n",
    "  for (int i = threadIdx.x; i < n; i += kThreads)\n"
    "    pts[i] = make_float4(src[3 * i], src[3 * i + 1], src[3 * i + 2],"
    "\n                         __int_as_float(i));\n"))

# the streaming kernels
GROUP_TEST = "valid && bound_bits(wlo, whi, lo, hi) <= most"
QUERY_TEST = """      if (__all_sync(0xffffffffu,
                     bound_bits(q, q, tlo, thi) > dist_bits(bar)))
        continue;
"""
NO_GROUP_TEST = (KNN, swap(GROUP_TEST, "valid"))
NO_QUERY_TEST = (KNN, swap(QUERY_TEST, ""))
STREAM_ROW = "        row[j] = static_cast<int64_t>(static_cast<uint32_t>(list[j]));"
STREAM_INSERT = """    if constexpr (L > 1) key = key < bar ? key : kNone;
    insert(list, key);
"""
STREAM_COUNT = [
    (KNN, swap("  // the warp's own tile first",
               "  int count[5] = {1, 0, 0, 0, 0};\n"
               "  // the warp's own tile first")),
    (KNN, swap(GROUP_TEST + ");\n", GROUP_TEST + ");\n    count[1] += "
               "__popc(__ballot_sync(0xffffffffu, valid)) - __popc(todo);\n")),
    (KNN, swap(QUERY_TEST, QUERY_TEST.replace(
        "        continue;\n", "      {\n        ++count[2];\n"
        "        continue;\n      }\n      ++count[0];\n"))),
    (KNN, swap("                                          uint64_t bar,\n",
               "                                          uint64_t bar, "
               "int (&count)[5],\n")),
    (KNN, swap(STREAM_INSERT, "    if constexpr (L > 1) key = key < bar ? "
                              "key : kNone;\n    ++count[3];\n    count[4] "
                              "+= __any_sync(0xffffffffu, key < list[KL - "
                              "1]);\n    insert(list, key);\n")),
    (KNN, swap("                       bar, list);\n      bar = bar_of",
               "                       bar, count, list);\n      bar = bar_of")),
    (KNN, swap(STREAM_ROW, "        row[j] = j < 5 ? count[j] : "
                           "static_cast<int64_t>(static_cast<uint32_t>(list[j]));")),
]
# block 0's thread 0 clocks the cells kernel's phases and prints them
ORDER_CLOCK = [(KNN, edit) for edit in (
    swap("#include <cstdint>\n", "#include <cstdint>\n#include <cstdio>\n"),
    swap("  const int ncell = 1 << (3 * g);\n  const int tiles",
         "  long long clk[5];\n  clk[0] = clock64();\n"
         "  const int ncell = 1 << (3 * g);\n  const int tiles"),
    swap("  if (tid == 0) order.frame[blockIdx.x] = frame;\n",
         "  if (tid == 0) order.frame[blockIdx.x] = frame;\n"
         "  clk[1] = clock64();\n"),
    swap("        atomicAdd(&cells[padded(cell_of(v[u], frame, g))], 1u);\n"
         "    }\n  }\n  __syncthreads();\n",
         "        atomicAdd(&cells[padded(cell_of(v[u], frame, g))], 1u);\n"
         "    }\n  }\n  __syncthreads();\n  clk[2] = clock64();\n"),
    swap("      run += count;\n    }\n  }\n  __syncthreads();\n",
         "      run += count;\n    }\n  }\n  __syncthreads();\n"
         "  clk[3] = clock64();\n"),
    swap("  for (int c = tid; c < ncell; c += kOrderThreads) next[c] = "
         "cells[padded(c)];\n",
         "  for (int c = tid; c < ncell; c += kOrderThreads) next[c] = "
         "cells[padded(c)];\n  clk[4] = clock64();\n"
         "  if (tid == 0 && blockIdx.x == 0)\n"
         "    printf(\"clock cells n %d: bbox %lld, histogram %lld, scan %lld, "
         "write %lld\\n\", n, clk[1] - clk[0], clk[2] - clk[1],"
         " clk[3] - clk[2], clk[4] - clk[3]);\n"))]
# the walk's lanes a query: 1 from 65,536 queries, 4 from 32,768, else 8
WALK_L1 = "  if (queries >= (1 << 16))\n    return launch_walk<KL, 1>("
WALK_L4 = "  if (queries >= (1 << 15))\n    return launch_walk<KL, 4>("
# block 0's lane 0 of warp 0 clocks the walk's phases and prints them
TICK = ("{ const long long now = clock64(); clk[{i}] += now - tick; "
        "tick = now; }")
WALK_CLOCK = [(KNN, edit) for edit in (
    swap("#include <cstdint>\n", "#include <cstdint>\n#include <cstdio>\n"),
    swap("  float4* buf = stage[tid >> 5];\n",
         "  long long clk[6] = {0, 0, 0, 0, 0, 0}, tick = clock64();\n"
         "  float4* buf = stage[tid >> 5];\n"),
    swap("  // the warp's own tile first",
         "  " + TICK.replace("{i}", "0") + "\n  // the warp's own tile first"),
    swap("  uint64_t bar = bar_of<KL, L>(list);\n  // then the others",
         "  uint64_t bar = bar_of<KL, L>(list);\n  "
         + TICK.replace("{i}", "1") + "\n  // then the others"),
    swap(GROUP_TEST + ");\n",
         GROUP_TEST + ");\n    " + TICK.replace("{i}", "2") + "\n"),
    swap(QUERY_TEST, "      const bool skip = __all_sync(0xffffffffu, "
         "bound_bits(q, q, tlo, thi) > dist_bits(bar));\n      "
         + TICK.replace("{i}", "3") + "\n      if (skip) continue;\n"),
    swap("      bar = bar_of<KL, L>(list);\n    }\n",
         "      bar = bar_of<KL, L>(list);\n      "
         + TICK.replace("{i}", "4") + "\n    }\n"),
    swap(STREAM_ROW + "\n    }\n  }\n",
         STREAM_ROW + "\n    }\n  }\n  " + TICK.replace("{i}", "5")
         + "\n  if (blockIdx.x == 0 && tid == 0)\n"
         "    printf(\"clock walk n %d L %d: prologue %lld, own tile %lld, "
         "groups %lld, tile tests %lld, tiles %lld, merge %lld\\n\", n, L, "
         "clk[0], clk[1], clk[2], clk[3], clk[4], clk[5]);\n"))]
# the walk's registers capped at 128 instead of its launch bounds
MAXNREG = (KNN, swap("__global__ void __launch_bounds__(kWalkThreads)\n",
                     "__global__ void __maxnreg__(128)\n"))
# a lane's bar is its list's last key alone
NO_BAR = (KNN, swap("  if constexpr (L == 1) {\n    return list[KL - 1];",
                    "  if constexpr (true) {\n    return list[KL - 1];"))


def lanes(one: str):
    """The shared-memory kernel's lanes: `one` replaces its rule for 1 lane
    a query (from 65,536 queries; else 4)."""
    return (KNN, swap(LANES, LANES.replace("queries >= (1 << 16)", one)))


def walk_lanes(one: str, four: str):
    """The walk's lanes: `one` and `four` replace its rules for 1 and 4
    lanes a query (else 8)."""
    return [(KNN, swap(WALK_L1, WALK_L1.replace("queries >= (1 << 16)",
                                                one))),
            (KNN, swap(WALK_L4, WALK_L4.replace("queries >= (1 << 15)",
                                                four)))]

# (base, kernel, edits): base "tree" copies this checkout; kernel "smem"
# measures the shared-memory kernel, "stream" the streaming kernels
VARIANTS = {
    "lanes_1": ("tree", "smem", [lanes("true")]),
    "lanes_4": ("tree", "smem", [lanes("false")]),
    # the patch staged in index order: no Morton sort
    "index_order": ("tree", "smem", [STAGE_IN_ORDER]),
    # with the exact walk alone: every candidate runs the whole chain
    "no_vote": ("tree", "smem", [NO_NARROW, (KNN, swap(INSERT_BODY,
                                                       FULL_CHAIN))]),
    # with the exact walk alone: one vote against the last entry, then the
    # whole chain
    "one_chain": ("tree", "smem", [NO_NARROW, (KNN, swap(
        INSERT_BODY, "  if (__any_sync(0xffffffffu, key < list[KL - 1])) {\n"
                     + FULL_CHAIN + "  }\n"))]),
    # with the exact walk alone: the first KL keys inserted one by one
    "no_prefill": ("tree", "smem", [NO_NARROW,
                                    (KNN, swap(PREFILL, "    if (false) {"))]),
    # the exact walk alone: no narrow keys
    "exact_walk": ("tree", "smem", [NO_NARROW]),
    "diag_no_list": ("tree", "smem", [
        NO_NARROW,
        (KNN, swap(PREFILL, "    if (false) {")),
        (KNN, swap(INSERT, CHECK + "  list[0] = kmin(list[0], key);\n"))]),
    "diag_count": ("tree", "smem", COUNT),
    # the narrow walk's distances and keys, no list
    "diag_narrow_no_list": ("tree", "smem", [(KNN, swap(
        NARROW_BODY, "  a[kNarrow - 1] = min(a[kNarrow - 1], key);\n"))]),
    # the staging in index order and the output alone: no sort, no walk
    "diag_stage_only": ("tree", "smem", [
        (KNN, swap("  if (w0 < n) {", "  if (false) {")), STAGE_IN_ORDER]),
    # the staging, sort and output alone: no walk
    "diag_no_walk": ("tree", "smem", [
        (KNN, swap("  if (w0 < n) {", "  if (false) {"))]),
    # the spatial order and the outward walk, every tile walked
    "stream_no_skip": ("tree", "stream", [NO_GROUP_TEST, NO_QUERY_TEST]),
    # each tile tested against each query only, or against the warp's box
    # only
    "stream_query_test_only": ("tree", "stream", [NO_GROUP_TEST]),
    "stream_group_test_only": ("tree", "stream", [NO_QUERY_TEST]),
    "tile_16": ("tree", "stream", [(KNN, swap(
        "constexpr int kTile = 32;", "constexpr int kTile = 16;"))]),
    "tile_64": ("tree", "stream", [(KNN, swap(
        "constexpr int kTile = 32;", "constexpr int kTile = 64;"))]),
    "stream_lanes_1": ("tree", "stream", walk_lanes("true", "false")),
    "stream_lanes_4": ("tree", "stream", walk_lanes("false", "true")),
    # blocks of one and of four warps
    "stream_threads_32": ("tree", "stream", [(KNN, swap(
        "constexpr int kWalkThreads = 64;",
        "constexpr int kWalkThreads = 32;"))]),
    "stream_threads_128": ("tree", "stream", [(KNN, swap(
        "constexpr int kWalkThreads = 64;",
        "constexpr int kWalkThreads = 128;"))]),
    "stream_no_bar": ("tree", "stream", [NO_BAR]),
    "stream_lanes_8": ("tree", "stream", walk_lanes("false", "false")),
    # 16^3 cells at most
    "order_cells_4": ("tree", "stream", [(KNN, swap(
        "constexpr int kMaxCellBits = 5;", "constexpr int kMaxCellBits = 4;"))]),
    "stream_lanes_1_maxnreg": ("tree", "stream",
                               walk_lanes("true", "false") + [MAXNREG]),
    "diag_stream_count": ("tree", "stream", STREAM_COUNT),
    "diag_walk_clock": ("tree", "stream", WALK_CLOCK),
    "diag_order_clock": ("tree", "stream", ORDER_CLOCK),
}


def sass(d: Path, name: str, dest: Path) -> None:
    """The SASS of the copy's k-NN source, into `dest/NAME.sass`."""
    from puflow_torch.ops import _build

    cubin = d / "knn.cubin"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-cubin", "-o",
                    str(cubin), str(d / KNN)], check=True)
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    dest.mkdir(parents=True, exist_ok=True)
    with open(dest / f"{name}.sass", "w") as f:
        subprocess.run([str(tool), "-sass", str(cubin)], stdout=f,
                       check=True)


def report(out: str) -> str:
    """Registers and spills of the main instantiations (k = 16)."""
    return "; ".join(
        f"{label} {registers(out, kernel)}" for label, kernel in (
            ("smem L=4", "knn_self_kernelILi16ELi4E"),
            ("smem L=1", "knn_self_kernelILi16ELi1E"),
            ("stream L=8", "knn_stream_kernelILi16ELi8E"),
            ("stream L=4", "knn_stream_kernelILi16ELi4E"),
            ("stream L=1", "knn_stream_kernelILi16ELi1E"),
            ("cells", "knn_cells_kernel"),
            ("scatter", "knn_scatter_kernel")))


def measure(label: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from puflow_torch.ops.knn import knn_self, knn_self_plain

    rng = np.random.RandomState(cs.SEED)
    with torch.no_grad():
        sizes = {m: cs.main_path_patches(m // 32) for m in (32, 256, 1024)}
        x = sizes[256]
        grid = torch.from_numpy(
            rng.randint(0, 7, x.shape).astype(np.float32)).cuda()
        cases = {f"{m} patches": p for m, p in sizes.items()}
        cases.update({"grid": grid,
                      "repeated": cs.repeated_half(rng, *x.shape[:2])})
        differ = {}
        for name, p in cases.items():
            got, ref = knn_self(p, K), knn_self_plain(p, K)
            differ[name] = int((got != ref).sum())
        same = torch.equal(knn_self(x, K), knn_self(x, K))
        ms = {m: [cs.time_ms(lambda p=p: knn_self(p, K), 10)
                  for _ in range(3)] for m, p in sizes.items()}
        extra = ""
        if "count" in label:
            share = []
            for m, p in sizes.items():
                c = knn_self(p, K)[..., :3].double().sum((0, 1))
                share.append(f"{m}: {c[0]:.0f} and {c[2]:.0f} of {c[1]:.0f} "
                             f"({c[0] / c[1]:.4f}, {c[2] / c[1]:.4f})")
            extra = (", voted steps that insert and that run the whole "
                     "chain " + "; ".join(share))
        # the folded pipeline on chip_smoke.py's clouds at 8 and 32 clouds
        # (not with a diagnostic's indices, which may point anywhere)
        if "diag" not in label:
            _, folded = cs.seeded_models()
            torch.save([cs.pipeline_staged(
                folded, cs.synthetic_clouds(b, cs.SEED + b))[0].cpu()
                for b in (8, 32)], "pipeline_out.pt")
    equal = all(v == 0 for v in differ.values())
    print(f"{label}: indices equal {equal} "
          f"({', '.join(f'{k} {v}' for k, v in differ.items())} differ), "
          f"rerun equal {same}, ms at 32 patches "
          f"{' '.join(f'{t:.4f}' for t in ms[32])}, at 256 "
          f"{' '.join(f'{t:.4f}' for t in ms[256])}, at 1024 "
          f"{' '.join(f'{t:.4f}' for t in ms[1024])}{extra}", flush=True)


# the streaming kernels in launch order (the parent's walk alone)
STREAM_NAMES = ("knn_cells_kernel", "knn_scatter_kernel", "knn_stream_kernel")


def kernel_ms(fn, reps: int) -> dict:
    """Mean device ms a call of ``fn`` spends in each of `STREAM_NAMES`,
    from torch.profiler over ``reps`` calls after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(STREAM_NAMES, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in STREAM_NAMES:
                if name in e.name:
                    ms[name] += (e.time_range.end - e.time_range.start) / 1e3
    return {name: t / reps for name, t in ms.items()}


def measure_stream(label: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from puflow_torch.ops.knn import knn_self_plain, knn_self_stream

    n = STREAM_SHAPES[0][1]
    rng = np.random.RandomState(cs.SEED)
    with torch.no_grad():
        shapes = {f"[{b}, {m}]": cs.synthetic_clouds(b, cs.SEED + 9, m)
                  for b, m in STREAM_SHAPES}
        # a dense cluster and 2% far points (chip_smoke.py:clustered_patch,
        # which the parent's chip_smoke.py lacks)
        pts = 0.5 + 1e-3 * rng.randn(1, n, 3)
        pts = np.where(rng.rand(1, n, 1) < 0.02,
                       rng.rand(1, n, 3) * 4 - 2, pts)
        cases = dict(shapes, grid=torch.from_numpy(rng.randint(
            0, 31, (1, n, 3)).astype(np.float32)).cuda(),
            repeated=cs.repeated_half(rng, 1, n),
            clustered=torch.from_numpy(pts.astype(np.float32)).cuda())
        differ = {}
        for name, p in cases.items():
            got, ref = knn_self_stream(p, K), knn_self_plain(p, K)
            differ[name] = int((got != ref).sum())
            del got, ref
            torch.cuda.empty_cache()
        x = shapes["[1, 10433]"]
        same = torch.equal(knn_self_stream(x, K), knn_self_stream(x, K))
        ms = {s: [cs.time_ms(lambda p=p: knn_self_stream(p, K), 10)
                  for _ in range(3)] for s, p in shapes.items()}
        split = []
        for s, p in shapes.items():
            dev = kernel_ms(lambda p=p: knn_self_stream(p, K), 10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                knn_self_stream(p, K)
            host = (time.perf_counter() - t0) * 10
            torch.cuda.synchronize()
            split.append(f"{s} " + " + ".join(
                f"{t:.4f}" for t in dev.values()) + f", host {host:.4f}")
        parts = (", device ms a call by kernel (" + " + ".join(STREAM_NAMES)
                 + ") and host ms to enqueue a call " + "; ".join(split))
        extra = ""
        if "count" in label:
            share = []
            for s, p in shapes.items():
                m = p.shape[1]
                tiles = -(-m // 32)
                c = knn_self_stream(p, K)[..., :5].double().mean((0, 1))
                share.append(f"{s}: tiles walked {c[0]:.2f} of {tiles} "
                             f"({c[0] / tiles:.4f} of the distances), "
                             f"skipped by the warp's box {c[1]:.2f}, by "
                             f"the queries {c[2]:.2f}; past its own tile "
                             f"{c[4] / c[3]:.4f} of a lane's steps run "
                             "the chain")
            extra = ", a query's mean " + "; ".join(share)
    equal = all(v == 0 for v in differ.values())
    print(f"{label}: indices equal {equal} "
          f"({', '.join(f'{k} {v}' for k, v in differ.items())} differ), "
          f"rerun equal {same}, ms "
          + "; ".join(f"{s} {' '.join(f'{t:.4f}' for t in v)}"
                      for s, v in ms.items()) + parts + extra, flush=True)


def same_pipeline(d: Path, first: Path) -> str:
    """Whether a copy's folded pipeline outputs are bit-equal to the
    first copy's."""
    import torch

    if not (d / "pipeline_out.pt").exists():
        return "folded pipeline not run"
    a = torch.load(d / "pipeline_out.pt")
    b = torch.load(first / "pipeline_out.pt")
    equal = all(torch.equal(u, v) for u, v in zip(a, b))
    return f"folded pipeline bit-equal to {first.name}'s: {equal}"


def stage(label: str) -> None:
    """Splits the self k-NN stage of the folded pipeline at 32 clouds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from puflow_torch.ops import _build
    from puflow_torch.ops.knn import knn_self

    _, folded = cs.seeded_models()
    pc = cs.synthetic_clouds(32, cs.SEED + 32)
    rec = {}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e, time.perf_counter()

    def mark(name):
        rec[name] = event()

    def knn(p, k):
        rec["drained"] = rec["patch_knn"][0].query()
        rec["pre"] = event()
        out = knn_self(p, k)
        rec["post"] = event()
        return out

    ops = dict(cs.KERNEL_OPS, knn_self=knn)
    rows = []
    with torch.no_grad():
        for i in range(6):
            rec.clear()
            cs.pipeline_staged(folded, pc, ops, mark)
            torch.cuda.synchronize()
            if i == 0:
                continue
            (e0, h0), (e1, h1) = rec["patch_knn"], rec["pre"]
            (e2, h2), (e3, _) = rec["post"], rec["knn_self"]
            rows.append({"stage": e0.elapsed_time(e3),
                         "to launch": e0.elapsed_time(e1),
                         "launch": e1.elapsed_time(e2),
                         "host before": (h1 - h0) * 1e3,
                         "host wrapper": (h2 - h1) * 1e3,
                         "drained": float(rec["drained"])})
        med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        x = cs.main_path_patches(32)
        M, n, _ = x.shape
        wrapper = cs.time_ms(lambda: knn_self(x, K), 10)
        lib = _build.library()
        out = torch.empty((M, n, K), dtype=torch.int64, device=x.device)
        stream = _build.stream_ptr(x.device)
        bare = cs.time_ms(lambda: lib.puflow_knn_self(
            x.data_ptr(), M, n, K, out.data_ptr(), stream), 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            knn_self(x, K)
        enqueue = (time.perf_counter() - t0) * 10
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cs.pipeline_staged(folded, pc)
            torch.cuda.synchronize()
        traced = [e.time_range.end - e.time_range.start
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "knn_self_kernel" in e.name]
    print(f"{label} stage at 32 clouds (median of 5): "
          + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
          + f" (ms; drained: share of runs); [{M}, {n}] back to back: "
          f"wrapper {wrapper:.4f} ms, bare C entry {bare:.4f} ms, host "
          f"enqueue {enqueue:.4f} ms a wrapper call; profiled pipeline: "
          f"knn_self_kernel {sum(traced) / 1e3:.4f} ms device in "
          f"{len(traced)} launch(es)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    ap.add_argument("--parent", type=Path, help="another checkout to time")
    ap.add_argument("--stage", action="store_true",
                    help="also split the pipeline's self k-NN stage")
    ap.add_argument("--sass", type=Path, metavar="DIR",
                    help="write each copy's SASS into DIR")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--measure-stream", help=argparse.SUPPRESS)
    ap.add_argument("--stage-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure)
        return 0
    if args.measure_stream:
        measure_stream(args.measure_stream)
        return 0
    if args.stage_of:
        stage(args.stage_of)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("knn_variants: needs a CUDA card")
    names = args.names or list(VARIANTS)
    dirs = {}
    if args.parent:
        dirs["parent"] = prepare("parent", args.parent.resolve(), [], OUT)
    dirs["kept"] = prepare("kept", ROOT, [], OUT)
    for name in names:
        dirs[name] = prepare(name, ROOT, VARIANTS[name][2], OUT)
    builds = {name: run_in(d, ["-c", "from puflow_torch.ops import _build; "
                                     "_build.build()"])
              for name, d in dirs.items()}
    regs = {name: ptxas(d, KNN) for name, d in dirs.items()}
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{out}")
    regs = {name: report(p.communicate()[0]) for name, p in regs.items()}
    if args.sass:
        for name, d in dirs.items():
            sass(d, name, args.sass.resolve())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for name in dirs:
        print(f"{name} | {regs[name]}", flush=True)
    script = str(Path(__file__).resolve())
    ends = [n for n in ("parent", "kept") if n in dirs]
    for kernel, flag in (("smem", "--measure"), ("stream", "--measure-stream")):
        picked = [n for n in names if VARIANTS[n][1] == kernel]
        first = dirs[ends[0]]
        for name in ends + picked + ends[::-1]:
            proc = run_in(dirs[name], [script, flag, name])
            out, _ = proc.communicate()
            lines = [ln for ln in out.splitlines()
                     if ln.startswith(name + ":")]
            clocks = {}
            for ln in out.splitlines():
                if ln.startswith("clock"):
                    head, _, tail = ln.partition(":")
                    clocks.setdefault(head, []).append(tail.split(","))
            for head, rows in clocks.items():
                # the median of each phase over the launches
                cells = [statistics.median(int(r[i].split()[-1])
                                           for r in rows)
                         for i in range(len(rows[0]))]
                names = [c.split()[0] for c in rows[0]]
                print(f"{name} {head} (median of {len(rows)} launches): "
                      + ", ".join(f"{a} {b:.0f}" for a, b in
                                  zip(names, cells)), flush=True)
            if lines and not proc.returncode:
                tail = (f" | {same_pipeline(dirs[name], first)}"
                        if kernel == "smem" else "")
                print(f"{lines[-1]}{tail}", flush=True)
            else:
                print(f"{name}: failed\n{out[-2000:]}", flush=True)
    if args.stage:
        for name, d in dirs.items():
            if "diag" in name:
                continue
            proc = run_in(d, [script, "--stage-of", name])
            out, _ = proc.communicate()
            lines = [ln for ln in out.splitlines() if ln.startswith(name)]
            print(lines[-1] if lines and not proc.returncode
                  else f"{name} stage: failed\n{out[-2000:]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
