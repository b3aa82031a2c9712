"""Times variants of the auction EMD kernel on one CUDA card.

    python3 scripts/emd_variants.py [--parent DIR] [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/emd_variants/` (gitignored) with one change to `csrc/emd.cu` (and,
for `stored`, to `ops/emd.py`); all are built side by side, then each runs
in its own process on the training path's EMD (`chip_smoke.py:
training_inputs`: the full-width discrete model's prediction at batch 32,
256 -> 1024 points, against its target) and on uniform clouds in [0, 1] of
1024 points at 1, 8 and 32 clouds. For each it prints the registers and
spill stores of `emd_cluster_kernel` (`nvcc -Xptxas -v`), the cluster size
`_emd_plan` chose, whether the assignments equal the plain version's and
two runs are bit-equal, and the ms of a call (CUDA events, three windows
of 10 calls after a warm-up). The variants:

  shipped    the kernel as it is: base values recomputed in registers
             without sqrt.rn's range check, branch-free top-2 and top-3
             updates, a row's cache of 64 candidates (each lane's best
             two columns) tried before a full sweep, one warp a row;
  no_cache   every bid from a full sweep;
  cand32     a cache of each lane's best column alone (32 candidates,
             theta the largest lane second);
  cand96     a cache of each lane's best three columns (96 candidates,
             theta the largest lane fourth);
  split_tail where a block has fewer rows to sweep than warps, S warps
             share a row by column range, their (best, second, column)
             triples merged; no cache from a shared sweep;
  range_check  __fsqrt_rn of max(d2, 0) (its range check and slow path);
  branchy    the running top's update as nested branches;
  stored     the base matrix written to device memory by a grid-wide
             kernel first and swept from there, still a cloud a cluster;
  threads512 blocks of 512 threads, two an SM, so that the card holds
             more clusters at once (`_emd_plan` sees the capacity);
  diag_clock the shipped kernel with block 0's thread 0 reading clock64()
             at each phase's end and printing the cycles of each phase
             over the whole auction (`PHASES`), the clock in the time.

`--parent DIR` runs the `puflow_torch/` of another checkout first (for
example `git archive` of the parent commit: one 1024-thread block a
cloud, the base matrix in device memory). Names pick variants; none runs
them all. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from flow_f_variants import (prepare, ptxas, registers,  # noqa: E402
                             run_in, swap)

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "runs" / "emd_variants"
EMD = "puflow_torch/csrc/emd.cu"
WRAPPER = "puflow_torch/ops/emd.py"

STORED = [
    (EMD, swap("__device__ __forceinline__ Top<kCand> sweep(float4 a,",
               "__device__ __forceinline__ Top<kCand> sweep("
               "const float* __restrict__ row, float4 a,")),
    (EMD, swap("top.consider(__fsub_rn(base_value(a, ys[j]), price[j]), j);",
               "top.consider(__fsub_rn(__ldg(row + j), price[j]), j);")),
    (EMD, swap("emd_cluster_kernel(const float* __restrict__ xyz1,",
               "emd_cluster_kernel(const float* __restrict__ base, "
               "const float* __restrict__ xyz1,")),
    (EMD, swap("sweep(xs[r], ys, price,",
               "sweep(base + (static_cast<size_t>(cloud) * n + lo + r) * m, "
               "xs[r], ys, price,")),
    (EMD, swap("v = __fsub_rn(base_value(xs[r], ys[c]), price[c]);",
               "v = __fsub_rn(__ldg(base + (static_cast<size_t>(cloud) * n "
               "+ lo + r) * m + c), price[c]);")),
    (EMD, swap("""  if (cluster > 0) {
    cudaLaunchConfig_t cfg;""", """  if (cluster > 0) {
    emd_base_kernel<<<dim3((m + kBaseThreads - 1) / kBaseThreads,
                           n < kBaseRows ? n : kBaseRows, batch),
                      kBaseThreads, 0, s>>>(
        static_cast<const float*>(xyz1), static_cast<const float*>(xyz2), n,
        m, static_cast<float*>(base));
    cudaLaunchConfig_t cfg;""")),
    (EMD, swap("err = cudaLaunchKernelEx(&cfg, emd_cluster_kernel,\n",
               "err = cudaLaunchKernelEx(&cfg, emd_cluster_kernel,\n"
               "                             static_cast<const float*>(base),"
               "\n")),
    (WRAPPER, swap("""    base = scratch = None
    if cluster == GLOBAL_SCRATCH:
        base = torch.empty((B, n, m), dtype=torch.float32, device=dev)
""", """    base = torch.empty((B, n, m), dtype=torch.float32, device=dev)
    scratch = None
    if cluster == GLOBAL_SCRATCH:
""")),
]

# the phases diag_clock times, in the kernel's order
PHASES = ("list", "sweep", "barrier 1", "contend", "barrier 2", "move")
CLOCK_TICK = """#include <cstdio>
#define TICK(p) if (tid == 0 && blockIdx.x == 0) { \\
    const long long now = clock64(); clk[p] += now - clk_last; \\
    clk_last = now; }
"""
DIAG_CLOCK = [
    (EMD, swap("#include <mutex>\n", "#include <mutex>\n" + CLOCK_TICK)),
    (EMD, swap("before any remote access\n",
               "before any remote access\n"
               "  long long clk[6] = {0, 0, 0, 0, 0, 0};\n"
               "  long long clk_last = clock64();\n  int clk_it = 0;\n")),
    (EMD, swap("    const int cnt = s_count;\n",
               "    const int cnt = s_count;\n    TICK(0)\n")),
    (EMD, swap("    if (last) {  // every unassigned row takes its best column\n"
               "      __syncthreads();",
               "    TICK(1)\n    ++clk_it;\n"
               "    if (last) {  // every unassigned row takes its best column\n"
               "      __syncthreads();")),
    (EMD, swap("    // 3. every bid and count is in\n    cluster.sync();\n",
               "    // 3. every bid and count is in\n    cluster.sync();\n"
               "    TICK(2)\n")),
    (EMD, swap("    cluster.sync();\n\n    // 5.",
               "    TICK(3)\n    cluster.sync();\n    TICK(4)\n\n    // 5.")),
    (EMD, swap("    for (int c = tid; c < cols; c += kThreads) key_p[c] = INT_MIN;\n",
               "    for (int c = tid; c < cols; c += kThreads) key_p[c] = INT_MIN;\n"
               "    TICK(5)\n")),
    (EMD, swap("  cluster.sync();   // no block leaves",
               "  if (tid == 0 && blockIdx.x == 0)\n"
               "    printf(\"clock C=%d n=%d iterations %d: %lld %lld %lld %lld "
               "%lld %lld\\n\", csize, n, clk_it, clk[0], clk[1], clk[2], "
               "clk[3], clk[4], clk[5]);\n"
               "  cluster.sync();   // no block leaves")),
]

def cut(start: str, end: str, new: str):
    """An edit that replaces the text from ``start`` up to ``end`` (kept)
    with ``new``."""
    def edit(text: str) -> str:
        i = text.index(start)
        return text[:i] + new + text[text.index(end, i):]
    return edit


# Top::consider as nested branches
BRANCHY = """  __device__ __forceinline__ void consider(float v, int j) {
    if (v > b[K]) {
      if (v > b[K - 1]) {
        b[K] = b[K - 1];
#pragma unroll
        for (int i = K - 1; i > 0; --i) {
          if (!(v > b[i - 1])) {
            b[i] = v;
            c[i] = j;
            return;
          }
          b[i] = b[i - 1];
          c[i] = c[i - 1];
        }
        b[0] = v;
        c[0] = j;
      } else {
        b[K] = v;
      }
    }
  }
"""

# the full sweeps with the split tail: S warps a row (S a power of two,
# S rows at most 32 warps, at least 64 columns a warp)
SPLIT_TAIL = """    __shared__ float part_b1[kWarps], part_b2[kWarps];
    __shared__ int part_j[kWarps];
    int split = 1;
    while (2 * split * nfull <= kWarps && 2 * split * 64 <= m) split *= 2;
    const int seg = (m + split - 1) / split;
    const int c0 = (warp % split) * seg;
    for (int k = warp / split; k < nfull; k += kWarps / split) {
      const int r = full[k];
      Top<kCand> top = sweep(xs[r], ys + c0, price + c0,
                             min(m, c0 + seg) - c0, lane);
      for (int q = 0; q < kCand; ++q)
        if (top.c[q] != kNone) top.c[q] += c0;
      float b1 = top.b[0], b2 = top.b[1];
      int j1 = top.c[0];
      if (split == 1) {
        for (int q = 0; q < kCand; ++q)
          cand[(r * kCand + q) * 32 + lane] =
              top.c[q] < m ? top.c[q] : 0xffff;
        const float th =
            key_value(__reduce_max_sync(kFull, order_key(top.b[kCand])));
        warp_top2(b1, b2, j1);
        if (lane == 0) {
          theta[r] = th;
          bid(r, b1, b2, j1);
        }
      } else {
        warp_top2(b1, b2, j1);
        if (lane == 0) {
          part_b1[warp] = b1;
          part_b2[warp] = b2;
          part_j[warp] = j1;
        }
      }
    }
    if (split > 1) {
      __syncthreads();
      if (tid < nfull) {
        const int w0 = tid * split;
        float b1 = part_b1[w0], b2 = part_b2[w0];
        int j1 = part_j[w0];
        for (int s = 1; s < split; ++s)
          merge(part_b1[w0 + s], part_b2[w0 + s], part_j[w0 + s], b1, b2, j1);
        theta[full[tid]] = INFINITY;
        bid(full[tid], b1, b2, j1);
      }
    }

"""

VARIANTS = {
    "shipped": [],
    "no_cache": [(EMD, swap("      if (theta[r] < INFINITY) {",
                            "      if (false) {"))],
    "range_check": [(EMD, swap(
        "return __fsub_rn(3.0f, d2 < 0x1p-60f ? 0.0f : root);",
        "return __fsub_rn(3.0f, __fsqrt_rn(d2 < 0.0f ? 0.0f : d2));"))],
    "branchy": [(EMD, cut("  __device__ __forceinline__ void consider(",
                          "};\n\n// the exact top-2", BRANCHY))],
    "cand32": [(EMD, swap("constexpr int kCand = 2;",
                          "constexpr int kCand = 1;"))],
    "cand96": [(EMD, swap("constexpr int kCand = 2;",
                          "constexpr int kCand = 3;"))],
    "split_tail": [(EMD, cut("    // 2b. the others sweep every column",
                             "    if (last) {  // every unassigned row",
                             SPLIT_TAIL))],
    "stored": STORED,
    "threads512": [(EMD, swap("constexpr int kThreads = 1024;",
                              "constexpr int kThreads = 512;")),
                   (EMD, swap("__launch_bounds__(kThreads, 1)",
                              "__launch_bounds__(kThreads, 2)"))],
    "diag_clock": DIAG_CLOCK,
}


def measure(label: str) -> None:
    import functools

    import numpy as np
    import torch

    import chip_smoke as cs
    from puflow_torch.models import discrete
    from puflow_torch.ops import emd

    model, _ = cs.seeded_models()
    params, state, sparse, dense = cs.training_inputs(model)
    with torch.no_grad():
        pred, _, _ = discrete.forward(params, state, sparse, cs.UPRATIO,
                                      train=True)
    cases = [("train", pred.contiguous(), dense)]
    rng = np.random.RandomState(cs.SEED + 2)
    for b in (1, 8, 32):
        cases.append((f"uniform B={b}", *(
            torch.from_numpy(rng.rand(b, 1024, 3).astype(np.float32)).cuda()
            for _ in range(2))))
    parts = []
    for name, x1, x2 in cases:
        b, n = x1.shape[:2]
        plan = getattr(emd, "_emd_plan", None)
        c = "-" if plan is None else plan(b, n, x2.shape[1], functools.partial(
            emd.cluster_capacity, x1.device, n, x2.shape[1]))
        _, ref = emd.emd_auction_plain(x1, x2, 0.005, 50)
        _, got = emd.emd_auction(x1, x2, 0.005, 50)
        _, again = emd.emd_auction(x1, x2, 0.005, 50)
        equal = bool(torch.equal(got, ref))
        rerun = bool(torch.equal(got, again))
        ms = [cs.time_ms(lambda: emd.emd_auction(x1, x2, 0.005, 50), 10)
              for _ in range(3)]
        parts.append(f"{name} C={c} equal {equal} rerun {rerun} ms "
                     + " ".join(f"{t:.4f}" for t in ms))
    print(f"{label}: " + "; ".join(parts), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    ap.add_argument("--parent", type=Path, help="another checkout to time")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("emd_variants: needs a CUDA card")
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
    regs = {name: ptxas(d, EMD) for name, d in dirs.items()}
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{out}")
    reports = {name: registers(proc.communicate()[0], "emd_cluster_kernel")
               for name, proc in regs.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for name, d in dirs.items():
        proc = run_in(d, [str(Path(__file__).resolve()), "--measure", name])
        out, _ = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(name + ":")]
        if lines and not proc.returncode:
            print(f"{lines[-1]} | {reports[name]}", flush=True)
            clocks = {}
            for ln in out.splitlines():
                if ln.startswith("clock "):
                    clocks.setdefault(ln.split(":")[0], ln)
            for ln in clocks.values():
                print(f"  {ln} ({', '.join(PHASES)})", flush=True)
        else:
            print(f"{name}: failed | {reports[name]}\n{out[-2000:]}",
                  flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
