"""Times variants of the CNF adjoint-backward kernel on one CUDA card.

    python3 scripts/adjoint_variants.py [--parent DIR] [--cnf-grad]
                                        [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/adjoint_variants/` (gitignored) with one change to
`csrc/cnf_adjoint.cuh`, where the kernel is (the `parent_` variants change
`csrc/cnf_adjoint.cu` of a copy of the `--parent` checkout instead, a tree
of before PR 15, whose kernel was in that source); all are built side by side, then each runs
in its own process at the training path's two shapes, as
`chip_smoke.py:compare_cnf_adjoint` makes them (perturbed blocks, condition
width 128): f, with the trace, R = 8,192; g, without it, R = 32,768, each
condition row serving 4 rows. For each it prints the registers and spill
stores of both instantiations of `cnf_adjoint_kernel` (`nvcc -Xptxas -v`)
and, per shape, the [attempted, accepted] steps and whether they equal the
plain version's, whether two runs are bit-equal, the worst max-relative
error over y0, a0, dc and every parameter gradient against
`cnf_adjoint_bwd_plain` (gate 2e-3), and the ms of a call (CUDA events,
three windows of 3 calls after a warm-up) with the ms an attempted step;
and whether the outputs of the two other CNF kernels, `cnf_solve_t` and
`cnf_solve_logp` (`csrc/cnf_solve.cu`), on the same inputs are bit-equal
to the first copy's (with `--parent`, the parent's). The plain version
runs once, first, in a process of this checkout. The
`diag_` variants drop work and fail the gates on purpose (`diag_clock`
prints block 0's clock cycles per phase instead); where they
change the step counts, compare their ms an attempt. `--parent DIR` runs
the `puflow_torch/` of another checkout first (for example `git archive`
of the parent commit). `--cnf-grad` also times, in each copy that is
not a diagnostic, one CNF training loss's forward and backward on the
kernels (`chip_smoke.py:cnf_grad_ms`, median of 5, this checkout's
chip_smoke.py driving the copy's package) and splits one loss's device
time by CNF kernel (`chip_smoke.py:cnf_kernel_ms`). Names pick variants;
none runs them all. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import statistics
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "runs" / "adjoint_variants"
ADJ = "puflow_torch/csrc/cnf_adjoint.cuh"
# the one-launch kernel's source, which ptxas compiles; the parent_ variants'
# kernel
ADJ_SRC = "puflow_torch/csrc/cnf_adjoint.cu"
MMA = "puflow_torch/csrc/mma_tf32.cuh"
PATHS = ("f", "g")
# the phases of `cnf_adjoint.cuh`'s clock (enum Phase), in order
PHASES = ("setup", "input", "L1", "L2", "L3", "R2", "R1", "R1b", "F",
          "tile end", "grad out", "dc", "c^T Q", "sync 1", "reduce",
          "control")


def swap(old: str, new: str):
    def edit(text: str) -> str:
        if old not in text:
            raise ValueError(f"not found: {old[:60]!r}")
        return text.replace(old, new)
    return edit


# parts of the scalar-FMA kernel this one replaced (8-row tiles), for the
# parent_ variants
P_GRAD_SUMS = ("  for (int e = tid; e < kGOwn; e += kThreads) {\n"
               "    float v = 0.f;\n    if (e < gV1) {")
P_CTQ = "for (int blk = tid; blk < (cdim / 4) * njb; blk += kThreads) {"
P_WCQ = "for (int blk = tid; blk < kSuper * (cdim / 4); blk += kThreads) {"
P_GRED = "for (int bb = 0; bb < nb; ++bb) {"
P_FWD = ("  forward<kRows, kTrace>(w, proj, t, x, kLd, act, kout, kLd, "
         "kLogp);\n  // layer 3's cotangents")

# this tree's parts
GRAD_SUMS = "constexpr bool kGradSums = true;"
COND = "constexpr bool kCondProducts = true;"
GRED = "constexpr bool kGReduce = true;"
REVERSE = "constexpr bool kReverse = true;"
PRODUCTS = """  mma(acc, a.hi, b.h0, b.h1);
  mma(acc, a.hi, b.l0, b.l1);
  mma(acc, a.lo, b.h0, b.h1);
"""

PRODUCT_LOOP = "#pragma unroll\n  for (int kc = 0; kc < kH / 8; ++kc) {"
TRACE_GRAD = ("      if (kTrace)\n#pragma unroll\n        for (int k = 0; "
              "k < 3; ++k)\n          product_t")
CLOCK = "constexpr bool kClock = false;"

VARIANTS = {
    "parent_diag_no_grad_sums": [
        (ADJ_SRC, swap(P_GRAD_SUMS, P_GRAD_SUMS.replace("e < kGOwn", "e < 0")))],
    "parent_diag_no_cond": [
        (ADJ_SRC, swap(P_CTQ, P_CTQ.replace("blk < (cdim / 4) * njb", "blk < 0"))),
        (ADJ_SRC, swap(P_WCQ, P_WCQ.replace("blk < kSuper * (cdim / 4)",
                                        "blk < 0")))],
    "parent_diag_no_g_reduction": [
        (ADJ_SRC, swap(P_GRED, "for (int bb = 0; bb < 0; ++bb) {"))],
    "parent_diag_forward_only": [
        (ADJ_SRC, swap(P_FWD, P_FWD.replace("\n  // layer", "\n  return;\n  //"))),
        (ADJ_SRC, swap(P_CTQ, P_CTQ.replace("blk < (cdim / 4) * njb", "blk < 0"))),
        (ADJ_SRC, swap(P_WCQ, P_WCQ.replace("blk < kSuper * (cdim / 4)",
                                        "blk < 0"))),
        (ADJ_SRC, swap(P_GRED, "for (int bb = 0; bb < 0; ++bb) {"))],
    "kept": [],
    # registers: the 64-wide products two k chunks at a time, the trace's
    # gradient products one at a time
    "product_unroll_2": [(ADJ, swap(PRODUCT_LOOP, PRODUCT_LOOP.replace(
        "unroll", "unroll 2")))],
    "trace_grad_unroll_1": [(ADJ, swap(TRACE_GRAD, TRACE_GRAD.replace(
        "unroll", "unroll 1")))],
    # block 0's clock cycles per phase of the attempts, summed
    "diag_clock": [(ADJ, swap(CLOCK, CLOCK.replace("false", "true")))],
    "diag_no_grad_sums": [(ADJ, swap(GRAD_SUMS, GRAD_SUMS.replace("true",
                                                                  "false")))],
    "diag_no_cond": [(ADJ, swap(COND, COND.replace("true", "false")))],
    "diag_no_g_reduction": [(ADJ, swap(GRED, GRED.replace("true", "false")))],
    "diag_forward_only": [
        (ADJ, swap(REVERSE, REVERSE.replace("true", "false"))),
        (ADJ, swap(COND, COND.replace("true", "false"))),
        (ADJ, swap(GRED, GRED.replace("true", "false")))],
    "diag_hi_hi_only": [(ADJ, swap(PRODUCTS, PRODUCTS.split("\n")[0]
                                   + "\n"))],
}


def prepare(name: str, src: Path, edits) -> Path:
    """A copy of ``src``'s package and chip_smoke.py with ``edits``."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src / "puflow_torch", d / "puflow_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(src / "chip_smoke.py", d)
    for rel, edit in edits:
        path = d / rel
        path.write_text(edit(path.read_text()))
    return d


def run_in(d: Path, args: list[str]) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(d))
    return subprocess.Popen([sys.executable, *args], cwd=d, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def ptxas(d: Path) -> subprocess.Popen:
    """`nvcc -Xptxas -v` of the copy's adjoint source."""
    sys.path.insert(0, str(ROOT))
    from puflow_torch.ops import _build

    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(d / ADJ_SRC), "-o", os.devnull], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def registers(out: str) -> str:
    """Registers and spill stores of each `cnf_adjoint_kernel`, trace
    first (`Lb1E` in the mangled name) then without (`Lb0E`)."""
    lines = out.splitlines()
    found = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "cnf_adjoint_kernel" in line:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            key = "trace" if "Lb1E" in line else "plain"
            found[key] = (f"{regs.group(1) if regs else '?'} regs, "
                          f"{spill.group(1) if spill else '?'} B spilled")
    return ", ".join(f"{k} {v}" for k, v in sorted(found.items(),
                                                   reverse=True))


def cases():
    """(path, args, keywords) of the two training shapes, as
    `chip_smoke.py:compare_cnf_adjoint` makes them."""
    import numpy as np
    import torch

    import chip_smoke as cs

    cnf_model, _ = cs.seeded_models("cnf")
    x, conds, latents, weights = cs.training_solve_inputs(cnf_model)
    rng = np.random.RandomState(cs.SEED + 8)

    def rand(shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32)).cuda()

    bp = weights[1][1][3]
    T = bp["sqrt_end_time"] * bp["sqrt_end_time"]
    zero = torch.zeros_like(T)
    out = []
    for path in PATHS:
        y1 = x if path == "f" else latents
        a1 = rand(y1.shape, 0.3)
        if path == "f":
            ap = rand(y1.shape[:2] + (1,), 0.3)
            kw = dict(with_trace=True, logp1=rand(y1.shape[:2] + (1,), 0.1))
            t0, t1 = zero, T
        else:
            ap = torch.zeros(y1.shape[:2] + (1,), device=y1.device)
            kw = dict(with_trace=False)
            t0, t1 = T, zero
        out.append((path, (bp["layers"], conds[3], y1, a1, ap, t0, t1), kw))
    return out


def reference() -> None:
    """The plain version's leaves and steps at both shapes, to a file."""
    import torch

    import chip_smoke as cs
    from puflow_torch.ops import cnf

    ref = {}
    for path, args, kw in cases():
        out = cnf.cnf_adjoint_bwd_plain(*args, **kw, return_stats=True)
        ref[path] = ([t.cpu() for _, t in cs.adjoint_leaves(out)],
                     [out[-1]["steps"], out[-1]["accepted"]])
    torch.save(ref, OUT / "reference.pt")


def measure(label: str) -> None:
    import torch

    import chip_smoke as cs
    from puflow_torch.ops import cnf

    ref = torch.load(OUT / "reference.pt")
    parts, solves = [], []
    for path, args, kw in cases():
        leaves, ref_steps = ref[path]
        got = cnf.cnf_adjoint_bwd(*args, **kw, return_stats=True)
        again = cnf.cnf_adjoint_bwd(*args, **kw)
        torch.cuda.synchronize()
        steps = got[-1].tolist()
        g = [t for _, t in cs.adjoint_leaves(got)]
        a = [t for _, t in cs.adjoint_leaves(again)]
        same = all(torch.equal(u, v) for u, v in zip(g, a))
        worst = max(cs.maxrel(u.cpu(), r) for u, r in zip(g, leaves))
        ms = [cs.time_ms(lambda: cnf.cnf_adjoint_bwd(*args, **kw), 3)
              for _ in range(3)]
        solves.append(solve_outputs(cnf, path, args, kw))
        parts.append(
            f"{path} steps {steps} (plain {ref_steps}, equal "
            f"{steps == ref_steps}), rerun equal {same}, worst max-rel "
            f"{worst:.3e}, ms {' '.join(f'{m:.4f}' for m in ms)} "
            f"({min(ms) / steps[0]:.4f} an attempt)")
    torch.save(solves, "solve_out.pt")
    print(f"{label}: " + "; ".join(parts), flush=True)


def solve_outputs(cnf, path, args, kw):
    """(hash of the inputs, outputs) of the shape's forward solve: the
    log-density solve 0 -> T with the trace (f), else the plain solve T ->
    0 (g)."""
    import torch

    layers, c, y1, _, _, t0, t1 = args
    inputs = hashlib.sha256()
    for t in (c, y1, t0, t1):
        inputs.update(t.cpu().numpy().tobytes())
    if kw["with_trace"]:
        logp0 = torch.zeros(y1.shape[:2] + (1,), device=y1.device)
        out = list(cnf.cnf_solve_logp(layers, c, y1, logp0, t0, t1))
    else:
        out = [cnf.cnf_solve_t(layers, c, y1, t1, t0)]
    return inputs.hexdigest(), [t.cpu() for t in out]


def measure_cnf_grad(label: str) -> None:
    """One CNF training loss on the copy's kernels: forward and backward
    ms (median of 5 after a warm-up) and the device time by CNF kernel."""
    spec = importlib.util.spec_from_file_location("root_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    inputs = cs.cnf_grad_inputs()
    cs.cnf_grad_ms(*inputs, False)
    runs = [cs.cnf_grad_ms(*inputs, False) for _ in range(5)]
    fwd = statistics.median(r[0] for r in runs)
    bwd = statistics.median(r[1] for r in runs)
    print(f"{label} cnf_grad: forward {fwd:.3f} ms, backward {bwd:.3f} ms "
          "(median of 5)", flush=True)
    cs.cnf_kernel_ms(lambda: cs.cnf_grad_ms(*inputs, False))


def same_solves(d: Path, first: Path) -> str:
    """Whether a copy's `cnf_solve_t` / `cnf_solve_logp` outputs are
    bit-equal to the first copy's."""
    import torch

    a = torch.load(d / "solve_out.pt")
    b = torch.load(first / "solve_out.pt")
    if [h for h, _ in a] != [h for h, _ in b]:
        return "solve inputs differ"
    equal = all(torch.equal(u, v) for (_, x), (_, y) in zip(a, b)
                for u, v in zip(x, y))
    return f"cnf_solve_t / cnf_solve_logp bit-equal to {first.name}: {equal}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    ap.add_argument("--parent", type=Path, help="another checkout to time")
    ap.add_argument("--cnf-grad", action="store_true",
                    help="also time a CNF training loss in each copy")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--reference", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure)
        if args.cnf_grad and "diag_" not in args.measure:
            measure_cnf_grad(args.measure)
        return 0
    if args.reference:
        reference()
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("adjoint_variants: needs a CUDA card")
    names = args.names or [n for n in VARIANTS
                           if args.parent or not n.startswith("parent_")]
    if any(n.startswith("parent_") for n in names) and not args.parent:
        raise SystemExit("adjoint_variants: parent_ variants need --parent")
    OUT.mkdir(parents=True, exist_ok=True)
    dirs = {}
    if args.parent:
        dirs["parent"] = prepare("parent", args.parent.resolve(), [])
    for name in names:
        src = args.parent if name.startswith("parent_") else ROOT
        dirs[name] = prepare(name, src.resolve(), VARIANTS[name])
    builds = {name: run_in(d, ["-c", "from puflow_torch.ops import _build; "
                                     "_build.build()"])
              for name, d in dirs.items()}
    regs = {name: ptxas(d) for name, d in dirs.items()}
    ref = run_in(ROOT, [str(Path(__file__).resolve()), "--reference"])
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{out}")
    regs = {name: registers(p.communicate()[0]) for name, p in regs.items()}
    out, _ = ref.communicate()
    if ref.returncode:
        raise SystemExit(f"reference failed\n{out[-3000:]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    first = next(iter(dirs.values()))
    for name, d in dirs.items():
        proc = run_in(d, [str(Path(__file__).resolve()), "--measure", name]
                      + (["--cnf-grad"] if args.cnf_grad else []))
        out, _ = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(name + ":")]
        if lines and not proc.returncode:
            print(f"{lines[-1]} | {regs[name]} | {same_solves(d, first)}",
                  flush=True)
            for ln in out.splitlines():
                if ln.startswith(f"{name} cnf_grad") or ln.startswith(
                        "cnf_grad one loss"):
                    print(f"  {ln}", flush=True)
            for trace in ("1", "0"):
                clocks = [ln for ln in out.splitlines()
                          if ln.startswith(f"clock trace {trace} ")]
                if clocks:
                    print(f"  {clocks[-1]} ({', '.join(PHASES)})",
                          flush=True)
        else:
            print(f"{name}: failed | {regs[name]}\n{out[-2000:]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
