"""Times variants of the forward-flow kernel on one CUDA card.

    python3 scripts/flow_f_variants.py [--parent DIR] [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/flow_f_variants/` (gitignored) with one change to `csrc/flow_f.cu`
or `csrc/mma_tf32.cuh`; all are built side by side, then each runs in its
own process at the main path's shapes (256 patches of 256 points, the
seeded, perturbed, folded weights of `chip_smoke.py`). For each it prints
the registers and spill stores of `flow_f_kernel` and `flow_g_kernel`
(`nvcc -Xptxas -v`), the largest error of `flow_f` against its plain
version as a share of the gate 1e-5 * max(1, max|ref|), whether two runs
are bit-equal, the time of a call of `flow_f` (CUDA events, three windows
of 10 after a warm-up) and that of `flow_g_blend` on the same inputs, and
whether `flow_g_blend`'s and `flow_g`'s outputs are bit-equal to the
first copy's (with `--parent`, the parent's). The `diag_` variants drop
work, may fail the gate, and say what sets the pace. `--parent DIR` runs
the `puflow_torch/` of another checkout first (for example `git archive`
of the parent commit). Names pick variants; none runs them all. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "runs" / "flow_f_variants"
FLOW_F = "puflow_torch/csrc/flow_f.cu"
FLOW_G = "puflow_torch/csrc/flow_g.cu"
MMA = "puflow_torch/csrc/mma_tf32.cuh"


def swap(old: str, new: str):
    def edit(text: str) -> str:
        if old not in text:
            raise ValueError(f"not found: {old[:60]!r}")
        return text.replace(old, new)
    return edit


ONE_PASS = """  float h[3][kHt][4];
  const float2* w0[3] = {W.s_w0, W.b_w0, W.c_w0};
  first_layers<KT, 3, kBatch>(h, c0, c1, cdim, t2, w0);
"""
# flow g's split: the injector's two first layers in one pass, the
# coupling's projection in a second pass over the conditions
TWO_PASSES = """  float h[3][kHt][4];
  {
    const float2* w0[2] = {W.s_w0, W.b_w0};
    first_layers<KT, 2, kBatch>(
        reinterpret_cast<float(&)[2][kHt][4]>(h[0]), c0, c1, cdim, t2, w0);
  }
"""
COUPLING = """  float hk[kHt][4];
  coupling_first(hk, h[2], W.w0h, y, split, t2);
"""
SECOND_PASS = """  {
    const float2* wc[1] = {W.c_w0};
    first_layers<KT, 1, kBatch>(
        reinterpret_cast<float(&)[1][kHt][4]>(h[2]), c0, c1, cdim, t2, wc);
  }
"""
INJECTOR = """  // the injector's scale and bias
  float sc[2][3], bi[2][3];
  bias_lrelu(h[0], nullptr);
  mlp_tail<kBatch>(h[0], W.s_w1, W.s_b1, W.s_w2, W.s_b2, lane, sc);
  bias_lrelu(h[1], nullptr);
  mlp_tail<kBatch>(h[1], W.b_w1, W.b_b1, W.b_w2, W.b_b2, lane, bi);
"""
UPDATE = """#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (split == 1) {"""
PRODUCTS = """      if (n0 + j < NT) mma(acc[n0 + j], a.hi, b[j].h0, b[j].h1);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) mma(acc[n0 + j], a.hi, b[j].l0, b[j].l1);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) mma(acc[n0 + j], a.lo, b[j].h0, b[j].h1);
"""

VARIANTS = {
    "kept": [],
    "threads_256": [(FLOW_F, swap("constexpr int kFThreads = 384;",
                                  "constexpr int kFThreads = 256;"))],
    "threads_512": [(FLOW_F, swap("constexpr int kFThreads = 384;",
                                  "constexpr int kFThreads = 512;"))],
    "two_passes": [(FLOW_F, swap(ONE_PASS, TWO_PASSES)),
                   (FLOW_F, swap(COUPLING, SECOND_PASS + COUPLING))],
    "two_passes_256": [(FLOW_F, swap(ONE_PASS, TWO_PASSES)),
                       (FLOW_F, swap(COUPLING, SECOND_PASS + COUPLING)),
                       (FLOW_F, swap("constexpr int kFThreads = 384;",
                                     "constexpr int kFThreads = 256;"))],
    # the injector's tails after the coupling's
    "injector_last": [(FLOW_F, swap(INJECTOR, "")),
                      (FLOW_F, swap(UPDATE, INJECTOR + UPDATE))],
    # each n8 tile's three products in a row (flow g's order)
    "batch_1": [(FLOW_F, swap("constexpr int kBatch = 4;",
                              "constexpr int kBatch = 1;"))],
    "batch_8": [(FLOW_F, swap("constexpr int kBatch = 4;",
                              "constexpr int kBatch = 8;"))],
    "diag_hi_hi_only": [(MMA, swap(PRODUCTS, PRODUCTS.split("\n")[0]
                                   + "\n"))],
}


def prepare(name: str, src: Path, edits, out: Path = OUT) -> Path:
    """A copy of ``src``'s package, chip_smoke.py and the test helpers it
    imports (``tests/``) with ``edits``, in ``out``."""
    d = out / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src / "puflow_torch", d / "puflow_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(src / "tests", d / "tests",
                    ignore=shutil.ignore_patterns("__pycache__"))
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


def ptxas(d: Path, rel: str) -> subprocess.Popen:
    """`nvcc -Xptxas -v` of one of the copy's sources."""
    sys.path.insert(0, str(ROOT))
    from puflow_torch.ops import _build

    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(d / rel), "-o", os.devnull], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def registers(out: str, kernel: str) -> str:
    """A kernel's registers and spill stores from ptxas's report."""
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            return (f"{regs.group(1) if regs else '?'} regs, "
                    f"{spill.group(1) if spill else '?'} B spilled")
    return "regs ?"


def measure(label: str) -> None:
    import torch

    import chip_smoke as cs
    from puflow_torch.ops import encoder as enc
    from puflow_torch.ops import flow, interp
    from puflow_torch.ops.knn import gather_points, knn_self_plain

    _, folded = cs.seeded_models()
    fp, _ = folded.trees()
    blocks = fp["flow_blocks"]
    with torch.no_grad():
        x = cs.main_path_patches(8)
        idx = knn_self_plain(x, 16)
        idx8 = idx[..., :8]
        conds = enc.encoder_conditions_plain(fp, x, idx)
        ref = flow.flow_f_plain(blocks, x, conds)
        ws = interp.interp_head_plain(fp["interp"], x, idx8, 4)

        def f():
            return flow.flow_f(blocks, x, conds)

        def blend():
            return flow.flow_g_blend(blocks, ref, ws, idx8, conds)

        got = f()
        gate = (float((got - ref).abs().max())
                / (1e-5 * max(1.0, float(ref.abs().max()))))
        same = torch.equal(got, f())
        fz = torch.einsum("bnkc,bnkr->bncr", gather_points(ref, idx8),
                          ws).contiguous()
        g_out = [blend(), flow.flow_g(blocks, fz, conds)]
        ms = [cs.time_ms(f, 10) for _ in range(3)]
        ms_g = [cs.time_ms(blend, 10) for _ in range(3)]
        inputs = hashlib.sha256()
        for t in (x, conds[0], conds[-1], ref, ws):
            inputs.update(t.cpu().numpy().tobytes())
        torch.save({"inputs": inputs.hexdigest(),
                    "g": [t.cpu() for t in g_out]}, "flow_g_out.pt")
    print(f"{label}: gate use {gate:.4f}, rerun equal {same}, flow_f ms "
          f"{' '.join(f'{m:.4f}' for m in ms)}, flow_g_blend ms "
          f"{' '.join(f'{m:.4f}' for m in ms_g)}", flush=True)


def same_g(d: Path, first: Path) -> str:
    """Whether a copy's flow g outputs are bit-equal to the first's."""
    import torch

    a = torch.load(d / "flow_g_out.pt")
    b = torch.load(first / "flow_g_out.pt")
    if a["inputs"] != b["inputs"]:
        return "flow g inputs differ"
    equal = all(torch.equal(u, v) for u, v in zip(a["g"], b["g"]))
    return f"flow g bit-equal to {first.name}: {equal}"


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
        raise SystemExit("flow_f_variants: needs a CUDA card")
    names = args.names or list(VARIANTS)
    dirs = {}
    if args.parent:
        dirs["parent"] = prepare("parent", args.parent.resolve(), [])
    dirs.update({name: prepare(name, ROOT, VARIANTS[name]) for name in names})
    builds = {name: run_in(d, ["-c", "from puflow_torch.ops import _build; "
                                     "_build.build()"])
              for name, d in dirs.items()}
    regs = {name: (ptxas(d, FLOW_F), ptxas(d, FLOW_G))
            for name, d in dirs.items()}
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{out}")
    regs = {name: "flow_f {}, flow_g {}".format(
                registers(f.communicate()[0], "flow_f_kernel"),
                registers(g.communicate()[0], "flow_g_kernel"))
            for name, (f, g) in regs.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    first = next(iter(dirs.values()))
    for name, d in dirs.items():
        proc = run_in(d, [str(Path(__file__).resolve()), "--measure", name])
        out, _ = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(name + ":")]
        if lines and not proc.returncode:
            print(f"{lines[-1]} | {regs[name]} | {same_g(d, first)}",
                  flush=True)
        else:
            print(f"{name}: failed\n{out[-2000:]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
