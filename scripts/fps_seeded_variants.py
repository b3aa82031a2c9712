"""Times variants of the seeded-FPS selection on one CUDA card.

    python3 scripts/fps_seeded_variants.py [--parent DIR] [--merge] [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/fps_seeded_variants/` (gitignored) with one change to
`csrc/fps.cu` (and, for `threads1024`, to `ops/fps.py`); all are built side
by side, then each runs in its own process at the seeded merge's three
shapes (`chip_smoke.py:compare_fps_seeded`'s timed ones: the Morton cells
of auto G = 16 at 1 and 32 clouds, [16, 2048] and [512, 2048] -> 386
picks, and the G = 1 row [1, 32768] -> 6,168, uniform clouds seeded by
2,048 points a cloud). For each shape it prints the plan, whether the
picks equal the plain version's and two runs are bit-equal, and the ms
of the seeding, of the selection and of the whole kernel (CUDA events,
three windows of 5 calls after a warm-up). Each copy also runs the union
merge FPS at [8, 34816] -> 8,216 and the seed pick at [8, 2048] -> 32
(`puflow_fps_cluster`, `puflow_fps`) and saves every output; the script
says whether each copy's outputs are bit-equal to the first copy's (with
`--parent`, the parent's) and prints the registers and spill stores of
the selection's kernels (`nvcc -Xptxas -v`). `--merge` then runs
`chip_smoke.py:phase_merge_timing` (the merge stage and the pipeline at 1
and 32 clouds for each merge, median of 3) in the parent, the shipped
copy, the shipped copy and the parent, each in a process of its own. The
variants:

  shipped      the selection as it is: a block of 128-512 threads a row,
               each thread's candidates and cache in registers, one
               __syncthreads a step (slots double-buffered by step
               parity, the loop two steps a trip so that each step's
               slots sit at fixed addresses); a cluster a row for larger
               rows;
  threads1024  a block of 1024 threads a row at 2,048 candidates (two a
               thread);
  parity_index one step a trip, the slots indexed by step & 1;
  two_barriers the block's argmax as the parent's: the warps' bests to
               shared memory, a barrier, warp 0 reduces them and writes
               the pick, a second barrier;
  slot_loop    every thread reduces the kW slots itself with compares in
               warp order, instead of two redux;
  l2_coords    each step reads the thread's candidates' coordinates from
               device memory (L2) again, as the parent did, instead of
               holding them in registers;
  contiguous   the block kernel with thread t holding the candidates
               [t kK, (t + 1) kK): the lowest lane (and warp) among the
               maxima holds the lowest index, so a ballot and a shuffle
               replace the second redux of each argmax;
  cluster_unroll2  the cluster kernel's step loop unrolled by two, so that
               its slots' parity is known in each copy;
  diag_clock   the shipped kernels with block 0's thread 0 reading
               clock64() at each phase's end and printing the cycles of
               each phase over the whole selection (`BLOCK_PHASES`,
               `CLUSTER_PHASES`), the clock in the time.

`--sass DIR` writes the SASS of each copy's selection kernels
(`cuobjdump -sass`, `SASS_KERNELS`) into DIR/<variant>.sass.
`--parent DIR` runs the `puflow_torch/` of another checkout first (for
example `git archive` of the parent commit: one 1024-thread block a row,
the cache in shared memory). Names pick variants; none runs them all.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from flow_f_variants import prepare, ptxas, run_in, swap  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "runs" / "fps_seeded_variants"
FPS = "puflow_torch/csrc/fps.cu"
WRAPPER = "puflow_torch/ops/fps.py"

# the block kernel's warp argmax (the cluster kernel's reads red_k)
BLOCK_ARGMAX = """    warp_argmax_key(key, bi);
    if (lane == 0) {
      rk[warp] = key;
"""
# the block kernel's step, from the warps' slots to the pick
BLOCK_STEP = """    if (lane == 0) {
      rk[warp] = key;
      ri[warp] = bi;
    }
    __syncthreads();
    key = lane < kW ? rk[lane] : 0u;
    int i = lane < kW ? ri[lane] : INT_MAX;
    warp_argmax_key(key, i);
"""
TWO_BARRIERS = """    if (lane == 0) {
      rk[warp] = key;
      ri[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      key = lane < kW ? rk[lane] : 0u;
      bi = lane < kW ? ri[lane] : INT_MAX;
      warp_argmax_key(key, bi);
      if (lane == 0) s_pick = bi;
    }
    __syncthreads();
    const int i = s_pick;
"""
SLOT_LOOP = """    if (lane == 0) {
      rk[warp] = key;
      ri[warp] = bi;
    }
    __syncthreads();
    unsigned best = rk[0];
    int i = ri[0];
#pragma unroll
    for (int w = 1; w < kW; ++w) {
      const unsigned k = rk[w];
      const int j = ri[w];
      if (k > best || (k == best && j < i)) {
        best = k;
        i = j;
      }
    }
"""
FOLD = """    if (step + 1 < m)
      fold(px, py, pz, mind, s_pts[3 * i], s_pts[3 * i + 1], s_pts[3 * i + 2],
           threadIdx.x, kT, bv, bi);
"""
L2_FOLD = """    if (step + 1 < m) {
      const float* pts = xyz + row * n * 3;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float* p = pts + 3 * min(static_cast<int>(threadIdx.x) + k * kT,
                                       n - 1);
        px[k] = __ldg(p);
        py[k] = __ldg(p + 1);
        pz[k] = __ldg(p + 2);
      }
      fold(px, py, pz, mind, __ldg(pts + 3 * i), __ldg(pts + 3 * i + 1),
           __ldg(pts + 3 * i + 2), threadIdx.x, kT, bv, bi);
    }
"""
# the block kernel's loop over steps, two a trip (the slots' parity fixed)
STEP_LOOP = """  for (int step = 0; step < m; step += 2) {
    step_at(step, red_k[0], red_i[0]);
    if (step + 1 < m) step_at(step + 1, red_k[1], red_i[1]);
  }
"""
PARITY_INDEX = """  for (int step = 0; step < m; ++step)
    step_at(step, red_k[step & 1], red_i[step & 1]);
"""
SLOTS = "  __shared__ int red_i[2][kW];\n"

WARP_FIRST_MAX = """
// the argmax of (key, i) over a warp whose lanes hold ascending index
// ranges: the lowest lane among the maxima
__device__ __forceinline__ void warp_first_max(unsigned& key, int& i) {
  const unsigned best = __reduce_max_sync(kAll, key);
  i = __shfl_sync(kAll, i, __ffs(__ballot_sync(kAll, key == best)) - 1);
  key = best;
}
"""
CONTIGUOUS = [
    (FPS, swap("// A cache value's key:",
               WARP_FIRST_MAX + "\n// A cache value's key:")),
    (FPS, swap("0, n, threadIdx.x, kT, px,\n",
               "0, n, threadIdx.x * kK, 1, px,\n")),
    (FPS, swap("best_of(mind, threadIdx.x, kT, bv, bi);",
               "best_of(mind, threadIdx.x * kK, 1, bv, bi);")),
    (FPS, swap("           threadIdx.x, kT, bv, bi);",
               "           threadIdx.x * kK, 1, bv, bi);")),
    (FPS, swap(BLOCK_ARGMAX, BLOCK_ARGMAX.replace("warp_argmax_key",
                                                  "warp_first_max"))),
    (FPS, swap("    warp_argmax_key(key, i);\n    if (threadIdx.x == 0)",
               "    warp_first_max(key, i);\n    if (threadIdx.x == 0)")),
]

# the phases diag_clock times, in each kernel's order
BLOCK_PHASES = ("warp argmax", "slots and barrier", "slot argmax", "fold")
CLUSTER_PHASES = ("block argmax and push", "cluster barrier",
                  "slot argmax", "fold")
CLOCK_TICK = """#include <cstdio>
#define TICK(p) if (threadIdx.x == 0 && blockIdx.x == 0) { \\
    const long long now = clock64(); clk[p] += now - clk_last; \\
    clk_last = now; }
"""
# the cluster kernel's step loop
CLUSTER_LOOP = ("  for (int step = 1; step < m; ++step) {\n"
                "    float bv;\n    int bi;\n    fold(")
CLOCK_START = ("  long long clk[4] = {0, 0, 0, 0};\n"
               "  long long clk_last = clock64();\n")
DIAG_CLOCK = [
    (FPS, swap("#include <cmath>\n", "#include <cmath>\n" + CLOCK_TICK)),
    # the block kernel
    (FPS, swap(SLOTS, SLOTS + CLOCK_START)),
    (FPS, swap(BLOCK_ARGMAX, "    warp_argmax_key(key, bi);\n    TICK(0)\n"
               + BLOCK_ARGMAX.split("\n", 1)[1])),
    (FPS, swap("    __syncthreads();\n    key = lane < kW ? rk[lane]",
               "    __syncthreads();\n    TICK(1)\n"
               "    key = lane < kW ? rk[lane]")),
    (FPS, swap("    if (threadIdx.x == 0) sel[step] = i;\n",
               "    if (threadIdx.x == 0) sel[step] = i;\n    TICK(2)\n")),
    (FPS, swap(FOLD + "  };\n", FOLD + "    TICK(3)\n  };\n")),
    (FPS, swap(STEP_LOOP, STEP_LOOP +
               "  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
               "    printf(\"clock block T=%d n=%d steps %d: %lld %lld %lld "
               "%lld\\n\", kT, n, m, clk[0], clk[1], clk[2], clk[3]);\n")),
    # the cluster kernel: the clock passed to its argmax
    (FPS, swap("    float& cz) {\n",
               "    float& cz, long long* clk, long long& clk_last) {\n")),
    (FPS, swap("red_k, red_i, slots, cx, cy, cz);",
               "red_k, red_i, slots, cx, cy, cz, clk, clk_last);")),
    (FPS, swap("red_k, red_i, slots, cx, cy,\n"
               "                                     cz);",
               "red_k, red_i, slots, cx, cy,\n"
               "                                     cz, clk, clk_last);")),
    (FPS, swap("  cluster.sync();\n  key = lane < csize",
               "  TICK(0)\n  cluster.sync();\n  TICK(1)\n"
               "  key = lane < csize")),
    (FPS, swap("  cz = w.z;\n  return i;",
               "  cz = w.z;\n  TICK(2)\n  return i;")),
    (FPS, swap("  cluster.sync();       // every block runs before any writes "
               "to its slots\n",
               "  cluster.sync();       // every block runs before any writes "
               "to its slots\n" + CLOCK_START)),
    (FPS, swap("    fold(px, py, pz, mind, cx, cy, cz, first, kT, bv, bi);\n",
               "    fold(px, py, pz, mind, cx, cy, cz, first, kT, bv, bi);\n"
               "    TICK(3)\n")),
    (FPS, swap("  // no block touches another's shared memory after the last "
               "barrier\n",
               "  if (kSeeded && threadIdx.x == 0 && blockIdx.x == 0)\n"
               "    printf(\"clock cluster C=%d T=%d n=%d steps %d: %lld %lld "
               "%lld %lld\\n\", csize, kT, n, m, clk[0], clk[1], clk[2], "
               "clk[3]);\n"
               "  // no block touches another's shared memory after the last "
               "barrier\n")),
]

VARIANTS = {
    "shipped": [],
    "threads1024": [
        (FPS, swap("    kernel = pick_block<512, 1, 2, 4, 8, 12, 16>(per);\n",
                   "    kernel = pick_block<512, 1, 2, 4, 8, 12, 16>(per);\n"
                   "  else if (threads == 1024)\n"
                   "    kernel = pick_block<1024, 1, 2, 4, 8>(per);\n")),
        (WRAPPER, swap("_SEEDED_BLOCK_THREADS = (128, 256, 512)",
                       "_SEEDED_BLOCK_THREADS = (128, 256, 512, 1024)"))],
    "parity_index": [(FPS, swap(STEP_LOOP, PARITY_INDEX))],
    "two_barriers": [(FPS, swap(SLOTS, SLOTS + "  __shared__ int s_pick;\n")),
                     (FPS, swap(BLOCK_STEP, TWO_BARRIERS))],
    "slot_loop": [(FPS, swap(BLOCK_STEP, SLOT_LOOP))],
    "l2_coords": [(FPS, swap(FOLD, L2_FOLD))],
    "contiguous": CONTIGUOUS,
    "cluster_unroll2": [(FPS, swap(CLUSTER_LOOP,
                                   "#pragma unroll 2\n" + CLUSTER_LOOP))],
    "diag_clock": DIAG_CLOCK,
}
# plans a variant forces at a number of candidates, FpsPlan(cluster, threads)
FORCED = {"threads1024": {2048: (1, 1024)}}
# the kernels whose registers are printed: (label, mangled name)
KERNELS = (("block T=256 kK=8", "fps_seeded_block_kernelILi256ELi8E"),
           ("block T=512 kK=4", "fps_seeded_block_kernelILi512ELi4E"),
           ("block T=1024 kK=2", "fps_seeded_block_kernelILi1024ELi2E"),
           ("seeded cluster T=128 kK=17",
            "fps_cluster_kernelILi128ELi17ELb1E"),
           ("union cluster T=128 kK=17", "fps_cluster_kernelILi128ELi17ELb0E"),
           ("union cluster T=128 kK=17", "fps_cluster_kernelILi128ELi17EE"),
           ("one block a row", "fps_seeded_kernel"))


# the kernels whose SASS --sass keeps (substrings of their mangled names)
SASS_KERNELS = ("fps_seeded_block_kernelILi128ELi16E",
                "fps_seeded_block_kernelILi512ELi4E",
                "fps_cluster_kernelILi128ELi17ELb1E", "fps_seeded_kernel")


def sass(d: Path, into: Path, name: str) -> None:
    """The SASS of `SASS_KERNELS` in copy ``d``'s library."""
    sys.path.insert(0, str(ROOT))
    from puflow_torch.ops import _build

    lib = sorted((d / "puflow_torch" / "_build").glob("*.so"))[-1]
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    keep = [part for part in out.split("\t\tFunction : ")[1:]
            if any(k in part.split("\n")[0] for k in SASS_KERNELS)]
    into.mkdir(parents=True, exist_ok=True)
    (into / f"{name}.sass").write_text(
        "".join("Function : " + part for part in keep))


def merge_timing() -> None:
    import chip_smoke as cs

    _, folded = cs.seeded_models()
    cs.phase_merge_timing(folded, cs.card_line())


def measure(label: str) -> None:
    import functools

    import numpy as np
    import torch

    import chip_smoke as cs
    from puflow_torch.ops import fps

    rng = np.random.RandomState(cs.SEED + 18)
    forced = FORCED.get(label, {})
    outputs = {}
    parts = []
    for name, R, M, Bs, m in (("G=16 1 cloud", 16, 2048, 1, 386),
                              ("G=16 32 clouds", 512, 2048, 32, 386),
                              ("G=1", 1, cs.PRED_N, 1, cs.SEEDED_PICKS)):
        xyz = torch.from_numpy(rng.rand(R, M, 3).astype(np.float32)).cuda()
        sd = torch.from_numpy(
            rng.rand(Bs, cs.N_POINTS, 3).astype(np.float32)).cuda()
        out = torch.empty((R, m), dtype=torch.int32, device="cuda")
        mind = torch.empty((R, M), dtype=torch.float32, device="cuda")
        kw, plan = {}, "parent"
        if hasattr(fps, "_fps_seeded_plan"):
            plan = fps._fps_seeded_plan(R, M, functools.partial(
                fps.seeded_capacity, xyz.device, M))
            if M in forced:
                plan = fps.FpsPlan(*forced[M])
            kw = dict(plan=plan)
            plan = f"C={plan.cluster} T={plan.threads}"

        def whole():
            fps._seeded_launch(xyz, sd, out, mind, **kw)
            return out.clone()

        ref = fps.farthest_point_sample_seeded_plain(xyz, sd, m)
        got, again = whole(), whole()
        outputs[name] = got.cpu()
        seeding = [cs.time_ms(lambda: fps._seeded_launch(
            xyz, sd, out, mind, phases=1, **kw), 5) for _ in range(3)]
        fps._seeded_launch(xyz, sd, out, mind, phases=1)
        selection = [cs.time_ms(lambda: fps._seeded_launch(
            xyz, sd, out, mind, phases=2, **kw), 5) for _ in range(3)]
        total = [cs.time_ms(lambda: fps._seeded_launch(
            xyz, sd, out, mind, **kw), 5) for _ in range(3)]
        parts.append(
            f"{name} {plan} equal {bool(torch.equal(got, ref))} rerun "
            f"{bool(torch.equal(got, again))} seeding "
            + " ".join(f"{t:.4f}" for t in seeding) + " selection "
            + " ".join(f"{t:.4f}" for t in selection) + " kernel "
            + " ".join(f"{t:.4f}" for t in total))
    merge_cloud = torch.from_numpy(
        rng.rand(8, cs.MERGE_N, 3).astype(np.float32)).cuda()
    seed_cloud = torch.from_numpy(
        rng.rand(8, cs.N_POINTS, 3).astype(np.float32)).cuda()
    outputs["union merge"] = fps.farthest_point_sample(
        merge_cloud, cs.NPOINT).cpu()
    outputs["seed pick"] = fps.farthest_point_sample(
        seed_cloud, cs.N_PATCH).cpu()
    union = [cs.time_ms(lambda: fps.farthest_point_sample(
        merge_cloud, cs.NPOINT), 3) for _ in range(2)]
    parts.append("union merge [8, 34816] ms "
                 + " ".join(f"{t:.4f}" for t in union))
    torch.save(outputs, "outputs.pt")
    print(f"{label}: " + "; ".join(parts), flush=True)


def registers(out: str) -> str:
    """Registers and spill stores of `KERNELS` from ptxas's report."""
    found = []
    lines = out.splitlines()
    for label, mangled in KERNELS:
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and mangled in line:
                info = " ".join(lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", info)
                spill = re.search(r"(\d+) bytes spill stores", info)
                stack = re.search(r"(\d+) bytes stack frame", info)
                found.append(f"{label} {regs.group(1) if regs else '?'} regs "
                             f"{spill.group(1) if spill else '?'} B spilled "
                             f"{stack.group(1) if stack else '?'} B stack")
                break
    return ", ".join(found)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    ap.add_argument("--parent", type=Path, help="another checkout to time")
    ap.add_argument("--merge", action="store_true",
                    help="merge-stage timing in the parent and shipped copy")
    ap.add_argument("--sass", type=Path,
                    help="write the selection kernels' SASS here")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--merge-timing", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure)
        return 0
    if args.merge_timing:
        merge_timing()
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fps_seeded_variants: needs a CUDA card")
    names = args.names or list(VARIANTS)
    OUT.mkdir(parents=True, exist_ok=True)
    dirs = {}
    if args.parent:
        dirs["parent"] = prepare("parent", args.parent.resolve(), [], OUT)
    for name in names:
        dirs[name] = prepare(name, ROOT, VARIANTS[name], OUT)
    builds = {name: run_in(d, ["-c", "from puflow_torch.ops import _build; "
                                     "_build.build()"])
              for name, d in dirs.items()}
    regs = {name: ptxas(d, FPS) for name, d in dirs.items()}
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{out}")
    reports = {name: registers(proc.communicate()[0])
               for name, proc in regs.items()}
    if args.sass:
        for name, d in dirs.items():
            sass(d, args.sass, name)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    first = None
    script = str(Path(__file__).resolve())
    for name, d in dirs.items():
        proc = run_in(d, [script, "--measure", name])
        out, _ = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(name + ":")]
        if not lines or proc.returncode:
            print(f"{name}: failed | {reports[name]}\n{out[-3000:]}",
                  flush=True)
            continue
        import torch

        outputs = torch.load(d / "outputs.pt")
        first = first or (name, outputs)
        same = {k: bool(torch.equal(v, first[1][k]))
                for k, v in outputs.items()}
        print(f"{lines[-1]} | outputs bit-equal to {first[0]}'s: {same} | "
              f"{reports[name]}", flush=True)
        clocks = {}     # the first of each kernel and shape
        for ln in out.splitlines():
            if ln.startswith("clock "):
                clocks.setdefault(ln.split(":")[0], ln)
        for ln in clocks.values():
            phases = (BLOCK_PHASES if ln.startswith("clock block")
                      else CLUSTER_PHASES)
            print(f"  {ln} ({', '.join(phases)})", flush=True)
    if args.merge and "shipped" in dirs:
        turns = (("parent", "shipped", "shipped", "parent")
                 if "parent" in dirs else ("shipped",))
        for name in turns:
            proc = run_in(dirs[name], [script, "--merge-timing"])
            out, _ = proc.communicate()
            for ln in out.splitlines():
                if ln.startswith("merge timing"):
                    print(f"{name}: {ln}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
