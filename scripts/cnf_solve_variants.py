"""Times variants of the CNF solve kernels on one CUDA card.

    python3 scripts/cnf_solve_variants.py [--parent DIR] [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/cnf_solve_variants/` (gitignored) with one change to
`csrc/cnf_solve.cuh` or `csrc/cnf_field.cuh`; all are built side by side,
then each runs in its own process on `chip_smoke.py:training_solve_inputs`'
perturbed block 3 (condition width 128): the plain solve f, R = 8,192, 0 ->
T; the plain solve g, R = 32,768, each condition row serving 4 rows, T ->
0; the log-density solve, R = 8,192, 0 -> T. For each it prints the
registers and spill stores of both instantiations of `solve_kernel`
(`nvcc -Xptxas -v`) and, per solve, the [attempted, accepted] steps and
whether they equal the plain version's, whether two runs are bit-equal,
the largest difference from the plain version (the plain version runs
once, first, in a process of this checkout), and the ms of a call (CUDA
events, three windows of 5 calls after a warm-up) with the ms an
attempted step; and whether the three solves' outputs and the adjoint
kernel's outputs at `scripts/adjoint_variants.py`'s two training shapes
are bit-equal to the first copy's (with `--parent`, the parent's).
`diag_` variants drop work and fail the gates on purpose. `--parent DIR`
runs the `puflow_torch/` of another checkout first and last, the variants
twice between (for example `git archive` of the parent commit).
Names pick variants; none runs them all. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import adjoint_variants  # noqa: E402
from flow_f_variants import (prepare, ptxas, registers,  # noqa: E402
                             run_in, swap)

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "runs" / "cnf_solve_variants"
SOLVE = "puflow_torch/csrc/cnf_solve.cuh"     # the kernel and its launch
ONE_LAUNCH = "puflow_torch/csrc/cnf_solve.cu"  # its one-launch instantiations
FIELD = "puflow_torch/csrc/cnf_field.cuh"

WARPS = "constexpr int kWarps = 8;"
# the gate table where condition rows serve several rows (r > 1)
GATES = "  if (args.rep > 1)\n    return launch_gates<kTrace, true, kSplit>"
TABLE_LOOP = """#pragma unroll
  for (int i = 0; i < kConds * 2 * kH / 32; ++i) {
    const int e = lane + 32 * i;
    const int cl = e / (2 * kH), j = e % (2 * kH);
    const int layer = j / kH, col = j % kH;
    if (cl < n_cond)
"""
TABLE_UNROLL_4 = """#pragma unroll 4
  for (int i = 0; i < 4 * n_cond; ++i) {
    const int e = lane + 32 * i;
    const int cl = e / (2 * kH), j = e % (2 * kH);
    const int layer = j / kH, col = j % kH;
"""
# the phases of the clock the diag_clock variant adds (enum Phase), in
# order
PHASES = ("layer 1", "product", "layer 2", "tangents", "layer 3", "table",
          "stage", "norm", "sync")
CLOCK_DECL = """// Block 0's thread 0 clocks its warp's phases with kClock and prints the
// sums at the end.
constexpr bool kClock = true;
enum Phase { kPhL1, kPhProduct, kPhL2, kPhTangents, kPhL3, kPhTable,
             kPhStage, kPhNorm, kPhSync, kPhases };
__shared__ long long clk[kPhases + 1];   // the last: the previous tick

__device__ __forceinline__ void tick(Phase phase) {
  if (kClock && threadIdx.x == 0 && blockIdx.x == 0) {
    const long long now = clock64();
    clk[phase] += now - clk[kPhases];
    clk[kPhases] = now;
  }
}

"""
CLOCK_START = """  if (kClock && tid == 0 && blockIdx.x == 0) {
    for (int i = 0; i < kPhases; ++i) clk[i] = 0;
    clk[kPhases] = clock64();
  }
"""
CLOCK_PRINT = """  if (kClock && blockIdx.x == 0 && tid == 0) {
    printf("clock trace %d rows %d tile %d rep %d steps %d:", kTrace ? 1 : 0,
           a.n_rows, kRows, a.rep, n);
    for (int i = 0; i < kPhases; ++i) printf(" %lld", clk[i]);
    printf("\\n");
  }
"""


def before(anchor: str, text: str):
    return swap(anchor, text + anchor)


def after(anchor: str, text: str):
    return swap(anchor, anchor + text)


# block 0's warp 0's clock cycles per phase of the steps, summed: a tick at
# the end of each phase
CLOCK = [(SOLVE, edit) for edit in (
    after("#include <cstdint>\n", "#include <cstdio>\n"),
    before("struct SolveArgs {", CLOCK_DECL),
    before("  // layer 2: x1 W2 on the tensor cores", "  tick(kPhL1);\n"),
    before("  float p3[kHalves][3] = {};", "  tick(kPhProduct);\n"),
    before("  // with the trace, the diagonal v3_k[k]", "  tick(kPhL2);\n"),
    before("  float h3[kHalves][3];", "  tick(kPhTangents);\n"),
    after("      kout[(g + 8) * kCh + 3] = -((d3 + d4) + d5);\n  }\n",
          "  tick(kPhL3);\n"),
    after("      table_ok = true;\n      __syncwarp();\n",
          "      tick(kPhTable);\n"),
    before("        eval(t + kC[i] * h_c", "        tick(kPhStage);\n"),
    after("      if (lane == 0) partial += static_cast<double>(sq);\n"
          "      __syncwarp();\n", "      tick(kPhNorm);\n"),
    after("    ++n;\n", "    tick(kPhSync);\n"),
    before("  float t = t0, h = direction * span / 16.f;", CLOCK_START),
    before("  const float* s_fin = sbuf", CLOCK_PRINT))]
PRODUCTS = """  tf32::mma(acc, a.hi, b.h0, b.h1);
  tf32::mma(acc, a.hi, b.l0, b.l1);
  tf32::mma(acc, a.lo, b.h0, b.h1);
"""

TILES = "  if ((args.n_rows + 7) / 8 <= warps)\n"
SIGMOID = "  return d == __int_as_float(0x7f800000) ? 0.f : r;\n"

VARIANTS = {
    "kept": [],
    # 4 warps a block (one block an SM all the same: shared memory)
    "warps_4": [(SOLVE, swap(WARPS, WARPS.replace("8", "4")))],
    # tiles of 16 rows at every shape
    "rows_16": [(SOLVE, swap(TILES, "  if (false)\n"))],
    # the sigmoid's reciprocal as the division, range check and slow path
    # included; or only for d >= 2^126 (the subnormal results)
    "sigmoid_division": [(FIELD, swap(SIGMOID, "  return 1.f / d;\n"))],
    "sigmoid_guarded": [(FIELD, swap(SIGMOID, "  return d < 0x1p126f ? r : "
                                     "1.f / d;\n"))],
    # the gate table's fill four entries a pass over the exact count, with
    # no guard, instead of unrolled whole with each entry guarded
    "table_unroll_4": [(SOLVE, swap(TABLE_LOOP, TABLE_UNROLL_4))],
    # every row computes its own gates, also where rows share a condition
    "per_row_gates": [(SOLVE, swap(GATES, GATES.replace("args.rep > 1",
                                                        "false")))],
    # the gate table at r = 1 too, which holds a tile's rows' conditions
    # (kConds = kRows): tiles of 8 rows everywhere, since at 16 a block's
    # tables outgrow shared memory (the f and log-density solves at R =
    # 8,192 take tiles of 8 in `kept` as well; the g solve does not)
    "table_everywhere": [
        (SOLVE, swap(GATES, GATES.replace("args.rep > 1", "true"))),
        (SOLVE, swap("kTable ? kRows / 2 + 1 : kRows", "kRows")),
        (SOLVE, swap(TILES, "  if (true)\n"))],
    "diag_clock": CLOCK,
    # one TF32 product instead of three (fails the gates)
    "diag_hi_hi_only": [(FIELD, swap(PRODUCTS, PRODUCTS.split("\n")[0]
                                     + "\n"))],
}


def cases():
    """(name, function of the cnf module -> outputs, plain version) of the
    three solves."""
    import torch

    import chip_smoke as cs

    cnf_model, _ = cs.seeded_models("cnf")
    x, conds, latents, weights = cs.training_solve_inputs(cnf_model)
    bp = weights[1][1][3]
    T = bp["sqrt_end_time"] * bp["sqrt_end_time"]
    zero = torch.zeros_like(T)
    layers, c = bp["layers"], conds[3]
    logp0 = torch.zeros(x.shape[:2] + (1,), device=x.device)
    return [
        ("f", lambda m, **kw: m.cnf_solve_t(layers, c, x, zero, T, **kw),
         lambda m: m.cnf_solve_plain(layers, c, x, zero, T,
                                     return_stats=True)),
        ("g", lambda m, **kw: m.cnf_solve_t(layers, c, latents, T, zero,
                                            **kw),
         lambda m: m.cnf_solve_plain(layers, c, latents, T, zero,
                                     return_stats=True)),
        ("logp", lambda m, **kw: m.cnf_solve_logp(layers, c, x, logp0, zero,
                                                  T, **kw),
         lambda m: m.cnf_solve_logp_plain(layers, c, x, logp0, zero, T,
                                          return_stats=True)),
    ]


def flat(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def reference() -> None:
    """The plain versions' outputs and steps, to a file."""
    import torch

    from puflow_torch.ops import cnf

    ref = {}
    for name, _, plain in cases():
        out, stats = plain(cnf)
        ref[name] = ([t.cpu() for t in flat(out)],
                     [stats["steps"], stats["accepted"]])
    torch.save(ref, OUT / "reference.pt")


def measure(label: str) -> None:
    import torch

    import chip_smoke as cs
    from puflow_torch.ops import cnf

    ref = torch.load(OUT / "reference.pt")
    parts, solves = [], []
    for name, kernel, _ in cases():
        outs, ref_steps = ref[name]
        got, stats = kernel(cnf, return_stats=True)
        again = kernel(cnf)
        torch.cuda.synchronize()
        steps = stats.tolist()
        got, again = flat(got), flat(again)
        solves.append([t.cpu() for t in got])
        same = all(torch.equal(u, v) for u, v in zip(got, again))
        err = max(float((u.cpu() - r).abs().max()) for u, r in zip(got, outs))
        ms = [cs.time_ms(lambda: kernel(cnf), 5) for _ in range(3)]
        parts.append(
            f"{name} steps {steps} (plain {ref_steps}, equal "
            f"{steps == ref_steps}), rerun equal {same}, max diff {err:.3e}, "
            f"ms {' '.join(f'{m:.4f}' for m in ms)} "
            f"({min(ms) / max(steps[0], 1):.4f} an attempt)")
    adj = []
    for _, args, kw in adjoint_variants.cases():
        adj.append([t.cpu() for _, t in cs.adjoint_leaves(
            cnf.cnf_adjoint_bwd(*args, **kw))])
    torch.save(adj, "adjoint_out.pt")
    torch.save(solves, "solve_out.pt")
    print(f"{label}: " + "; ".join(parts), flush=True)


def same_outputs(d: Path, first: Path) -> str:
    import torch

    def equal(name):
        a, b = torch.load(d / name), torch.load(first / name)
        return all(torch.equal(u, v) for x, y in zip(a, b)
                   for u, v in zip(x, y))

    return (f"solves bit-equal to {first.name}: {equal('solve_out.pt')}, "
            f"adjoint: {equal('adjoint_out.pt')}")


def one_launch_registers(out: str, trace: int) -> str:
    """`registers` of the one-launch `solve_kernel` with 16-row tiles and
    no gate table (not the per-attempt instantiation, whose mangled name
    adds a last template argument true)."""
    base = f"solve_kernelILb{trace}ELi2ELb0E"
    lines = [ln for ln in out.splitlines()
             if "Compiling entry function" not in ln or base + "Lb1E" not in ln]
    return registers("\n".join(lines), base)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    ap.add_argument("--parent", type=Path, help="another checkout to time")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--reference", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure)
        return 0
    if args.reference:
        reference()
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cnf_solve_variants: needs a CUDA card")
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
    regs = {name: ptxas(d, ONE_LAUNCH) for name, d in dirs.items()}
    ref = run_in(ROOT, [str(Path(__file__).resolve()), "--reference"])
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{out}")
    reports = {}
    for name, proc in regs.items():
        out = proc.communicate()[0]
        reports[name] = (f"f32 field {one_launch_registers(out, 0)}, "
                         f"trace {one_launch_registers(out, 1)}")
    out, _ = ref.communicate()
    if ref.returncode:
        raise SystemExit(f"reference failed\n{out[-3000:]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    first = next(iter(dirs.values()))
    # with a parent, in turns: parent, the variants, the variants, parent
    order = list(dirs)
    if args.parent:
        order = order + order[1:] + order[:1]
    for name in order:
        d = dirs[name]
        proc = run_in(d, [str(Path(__file__).resolve()), "--measure", name])
        out, _ = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(name + ":")]
        if lines and not proc.returncode:
            print(f"{lines[-1]} | {reports[name]} | "
                  f"{same_outputs(d, first)}", flush=True)
            clocks = {}
            for ln in out.splitlines():
                if ln.startswith("clock "):
                    clocks[ln.split(":")[0]] = ln
            for ln in clocks.values():
                print(f"  {ln} ({', '.join(PHASES)})", flush=True)
        else:
            print(f"{name}: failed | {reports[name]}\n{out[-2000:]}",
                  flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
