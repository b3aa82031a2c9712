"""Times variants of the interpolation-head kernel on one CUDA card.

    python3 scripts/interp_variants.py [--parent DIR] [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/interp_variants/` (gitignored) with one change to `csrc/interp.cu`
or `ops/interp.py`; all are built side by side, then each runs in its own
process at the main path's shapes (256 patches of 256 points, K = 8, r =
4, the seeded, perturbed, folded weights of `chip_smoke.py`). For each it
prints the registers and spills of the kernel (`nvcc -Xptxas -v`), the
largest error of each mode (logits, weights, latents) against the plain
version as a share of the JAX package's gate (2e-3, 5e-4, 5e-4), whether
two runs of each mode are bit-equal, the time of a call of `interp_head`
in mode `weights` (CUDA events, three windows of 10 after a warm-up) and
in modes `logits` and `latents` (a window each), and the card's SM clock,
temperature and power draw just after. The `diag_` variants drop work, may
fail the gates, and say what sets the pace. `--parent DIR` times the
`puflow_torch/` of another checkout in the same run (for example `git
archive` of the parent commit). Names pick variants; none runs them all.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "runs" / "interp_variants"
INTERP = "puflow_torch/csrc/interp.cu"
OPS = "puflow_torch/ops/interp.py"
GATES = {"logits": 2e-3, "weights": 5e-4, "latents": 5e-4}


def swap(old: str, new: str):
    def edit(text: str) -> str:
        if old not in text:
            raise ValueError(f"not found: {old[:60]!r}")
        return text.replace(old, new)
    return edit


def between(start: str, end: str, new: str):
    """An edit that replaces the text from ``start`` up to ``end``."""
    def edit(text: str) -> str:
        a, b = text.index(start), text.index(end)
        return text[:a] + new + text[b:]
    return edit


# the distance MLP's groups into the accumulator first, then the context
# EdgeConv's
DISTANCE_FIRST = r"""    float acc[kAcc][4];
    zero(acc);
    float h2[8][4];
    const Frag* w = begin(ring, kD1, lane);
    d_head(h2, a, w, bl);
    d_group(acc, h2, w + 32 * kDHeadFrags, bl, 0);
    w = begin(ring, kD2, lane);
    d_group(acc, h2, w, bl, 1);
    d_group(acc, h2, w + 32 * kDFrags, bl, 2);
    w = begin(ring, kG, lane);
    d_group(acc, h2, w, bl, 3);
    w = begin(ring, kE0, lane);
    growth<0>(a, w, bl);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w = begin(ring, i < 3 ? kE1 + i : kT, lane);
      e_group(acc, a, w, bl, i);
    }
"""
HI_LO = """#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) tf32::mma(acc[n0 + j], a.hi, b[j].l0, b[j].l1);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) tf32::mma(acc[n0 + j], a.lo, b[j].h0, b[j].h1);
"""
STAGE_NEXT = ("  if (next >= 0) stage(ring, next, ring.buf + (~ring.seq & 1) "
              "* kBufFloats);\n")
WAIT = '  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
W12 = (INTERP, swap("constexpr int kWarps = 8;",
                    "constexpr int kWarps = 12;"))

VARIANTS = {
    "kept": [],
    # more rows a round: 12 warps, 192 rows for each staged byte
    "warps_12": [W12],
    # the other order of the two halves of the weight MLP's first layer
    "distance_first": [
        (INTERP, between("    // the context EdgeConv, each group of e",
                         "    // the weight MLP's tail", DISTANCE_FIRST)),
        (INTERP, swap("stage(ring, kG, ring.buf);",
                      "stage(ring, kD0, ring.buf);")),
        (INTERP, swap("more ? kG : -1", "more ? kD0 : -1"))],
    # every B fragment an f32 pair, split into tf32 hi / lo as read (half
    # the bytes staged, two splits a fragment)
    "split_at_read": [(INTERP, swap("using Frag = float4;",
                                    "using Frag = float2;")),
                      (OPS, swap("_PRESPLIT = True", "_PRESPLIT = False"))],
    # the next phase's slice waited for before the current phase computes:
    # no copy overlaps the products
    "copy_then_compute": [(INTERP, swap(STAGE_NEXT, STAGE_NEXT + WAIT))],
    # the first design: each n8 tile's three products in a row, one
    # accumulator a growth layer
    "batch_1_sets_1": [(INTERP, swap("constexpr int kBatch = 4;",
                                     "constexpr int kBatch = 1;")),
                       (INTERP, swap("constexpr int kGrowthSets = 4;",
                                     "constexpr int kGrowthSets = 1;"))],
    # the three products of 8 n8 tiles interleaved, not 4
    "batch_8": [(INTERP, swap("constexpr int kBatch = 4;",
                              "constexpr int kBatch = 8;"))],
    # a growth layer's k chunks dealt to 2 accumulator sets, not 4
    "growth_sets_2": [(INTERP, swap("constexpr int kGrowthSets = 4;",
                                    "constexpr int kGrowthSets = 2;"))],
    # a group of e's k chunks dealt to 2 accumulator sets
    "e_sets_2": [(INTERP, swap("constexpr int kESets = 1;",
                               "constexpr int kESets = 2;"))],
    "diag_hi_hi_only": [(INTERP, swap(HI_LO, ""))],
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
    """`nvcc -Xptxas -v` of the copy's interp.cu."""
    sys.path.insert(0, str(ROOT))
    from puflow_torch.ops import _build

    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(d / INTERP), "-o", os.devnull], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def registers(out: str) -> str:
    """The head kernel's registers and spills from ptxas's report."""
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "interp_head_kernel" in line:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            return (f"regs {regs.group(1) if regs else '?'}, spill stores "
                    f"{spill.group(1) if spill else '?'} B")
    return "regs ?"


def measure(label: str) -> None:
    import torch

    import chip_smoke as cs
    from puflow_torch.ops import interp
    from puflow_torch.ops.knn import knn_self_plain

    _, folded = cs.seeded_models()
    ip = folded.trees()[0]["interp"]
    with torch.no_grad():
        x = cs.main_path_patches(8)
        idx8 = knn_self_plain(x, 16)[..., :8]
        z = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
        z = z.to(x.device)
        gates, same = [], True
        for mode, gate in GATES.items():
            got = interp.interp_head(ip, x, idx8, 4, mode, z)
            ref = interp.interp_head_plain(ip, x, idx8, 4, mode, z)
            gates.append(float((got - ref).abs().max()) / gate)
            same &= torch.equal(got,
                                interp.interp_head(ip, x, idx8, 4, mode, z))

        def call(mode):
            return lambda: interp.interp_head(ip, x, idx8, 4, mode, z)

        ms = [cs.time_ms(call("weights"), 10) for _ in range(3)]
        other = [cs.time_ms(call(mode), 10) for mode in ("logits", "latents")]
    print(f"{label}: gate use {' / '.join(f'{g:.4f}' for g in gates)}, rerun"
          f" equal {same}, weights ms {' '.join(f'{m:.4f}' for m in ms)}, "
          f"logits ms {other[0]:.4f}, latents ms {other[1]:.4f}", flush=True)


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
        raise SystemExit("interp_variants: needs a CUDA card")
    names = args.names or list(VARIANTS)
    dirs = {name: prepare(name, ROOT, VARIANTS[name]) for name in names}
    if args.parent:
        dirs["parent"] = prepare("parent", args.parent.resolve(), [])
    builds = {name: run_in(d, ["-c", "from puflow_torch.ops import _build; "
                                     "_build.build()"])
              for name, d in dirs.items()}
    regs = {name: ptxas(d) for name, d in dirs.items()}
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{out[-3000:]}", flush=True)
            del dirs[name]
    regs = {name: registers(proc.communicate()[0])
            for name, proc in regs.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for name, d in dirs.items():
        proc = run_in(d, [str(Path(__file__).resolve()), "--measure", name])
        out, _ = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(name + ":")]
        state = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"{lines[-1]} | {regs[name]} | after: {state}"
              if lines and not proc.returncode
              else f"{name}: failed\n{out[-2000:]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
