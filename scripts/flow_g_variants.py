"""Times variants of the inverse-flow kernel on one CUDA card.

    python3 scripts/flow_g_variants.py [--parent DIR] [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/flow_g_variants/` (gitignored) with one change to `csrc/flow_g.cu`,
`csrc/mma_tf32.cuh` or `ops/flow.py`; all are built side by side, then
each runs in its own process at the main path's shapes (256 patches of
256 points, r = 4, the seeded, perturbed, folded weights of
`chip_smoke.py`). For each it prints the registers and spills of the
kernel (`nvcc -Xptxas -v`), the largest error of `flow_g_blend` against
its plain version as a share of the gate 1e-5 * max(1, max|ref|),
whether two runs are bit-equal, and the time of a call of `flow_g_blend`
and of `flow_g` on the blended latents (CUDA events, three windows of 10
after a warm-up). The `diag_` variants drop work, may fail the gate, and
say what sets the pace. `--parent DIR` times the `puflow_torch/` of
another checkout in the same run (for example `git archive` of the parent
commit). Names pick variants; none runs them all. Needs a CUDA card and
nvcc.
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
OUT = ROOT / "runs" / "flow_g_variants"
FLOW_G = "puflow_torch/csrc/flow_g.cu"
MMA = "puflow_torch/csrc/mma_tf32.cuh"
OPS = "puflow_torch/ops/flow.py"


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


# the 64 -> 3 layers as a lane's 16 columns of its two rows against W2's
# rows (f32 FMAs), summed over the lanes of a group by two xor-shuffles
SHUFFLE_OUT = r"""__device__ __forceinline__ void narrow_out(const float (&x)[kHt][4],
                                           const float2* w2, const float* b2,
                                           int lane, float (&v)[2][3]) {
  const int t = lane % 4;
  float s[2][3] = {};
#pragma unroll
  for (int nt = 0; nt < kHt; ++nt)
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float2 w = w2[nt * 32 + 4 * o + t];
      s[0][o] = fmaf(x[nt][1], w.y, fmaf(x[nt][0], w.x, s[0][o]));
      s[1][o] = fmaf(x[nt][3], w.y, fmaf(x[nt][2], w.x, s[1][o]));
    }
#pragma unroll
  for (int d = 1; d < 4; d *= 2)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int o = 0; o < 3; ++o)
        s[i][o] += __shfl_xor_sync(0xffffffffu, s[i][o], d);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 0; o < 3; ++o) v[i][o] = s[i][o] + b2[o];
}

"""
PRODUCTS = """    mma(acc[nt], a.hi, b.h0, b.h1);
    mma(acc[nt], a.hi, b.l0, b.l1);
    mma(acc[nt], a.lo, b.h0, b.h1);
"""
ROUND_INT = """  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"""
ROUND_CVT = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r;"""
FUSED = """    const float2* w0[2] = {W.s_w0, W.b_w0};
    first_layers<KT>(h, c0, c1, cdim, t2, w0);
"""
APART = """    const float2* w0s[1] = {W.s_w0};
    const float2* w0b[1] = {W.b_w0};
    first_layers<KT>(reinterpret_cast<float(&)[1][kHt][4]>(h[0]), c0, c1,
                     cdim, t2, w0s);
    first_layers<KT>(reinterpret_cast<float(&)[1][kHt][4]>(h[1]), c0, c1,
                     cdim, t2, w0b);
"""
PAIR_LOADS = """    const float2 zero2 = make_float2(0.f, 0.f);
    const float2 u =
        col < cdim ? __ldg(reinterpret_cast<const float2*>(c0 + col)) : zero2;
    const float2 v =
        col < cdim ? __ldg(reinterpret_cast<const float2*>(c1 + col)) : zero2;
    const float a[4] = {u.x, u.y, v.x, v.y};
"""
SCALAR_LOADS = """    const float a[4] = {col < cdim ? __ldg(c0 + col) : 0.f,
                        col + 1 < cdim ? __ldg(c0 + col + 1) : 0.f,
                        col < cdim ? __ldg(c1 + col) : 0.f,
                        col + 1 < cdim ? __ldg(c1 + col + 1) : 0.f};
"""
ROW_TAIL = """  float add[2][3];
  mlp_tail(h, W.c_w1, W.c_b1, W.c_w2, W.c_b2, lane, add);
"""

VARIANTS = {
    "kept": [],
    "threads_256": [(FLOW_G, swap("constexpr int kGThreads = 384;",
                                  "constexpr int kGThreads = 256;"))],
    "threads_512": [(FLOW_G, swap("constexpr int kGThreads = 384;",
                                  "constexpr int kGThreads = 512;"))],
    # the 64 x 64 layers too as f32 pairs, split as read (every product
    # the same way)
    "split_at_read": [
        (FLOW_G, swap("using HidFrag = float4; ", "using HidFrag = float2; ")),
        (OPS, swap('b_fragments(net["w1"], True)',
                    'b_fragments(net["w1"], False)'))],
    # tf32 rounding by `cvt.rna.tf32.f32`, as the encoder's `split`
    "cvt_round": [(MMA, swap(ROUND_INT, ROUND_CVT))],
    # the injector's two first layers in two passes over the conditions
    "first_layers_apart": [(FLOW_G, swap(FUSED, APART))],
    # the conditions read a column at a time (4-byte loads)
    "cond_scalar_loads": [(FLOW_G, swap(PAIR_LOADS, SCALAR_LOADS))],
    "out_shuffles": [(FLOW_G, between(
        "__device__ __forceinline__ void narrow_out(",
        "// Layers 1 and 2 of a LinearA1D", SHUFFLE_OUT))],
    "diag_hi_hi_only": [(MMA, swap(PRODUCTS, PRODUCTS.replace(
        "    mma(acc[nt], a.hi, b.l0, b.l1);\n"
        "    mma(acc[nt], a.lo, b.h0, b.h1);\n", "")))],
    # the per-row products dropped: what is left is the per-point phase,
    # the prologue and the rows' loads, steps and stores
    "diag_no_row_products": [(FLOW_G, swap(ROW_TAIL,
                                           "  float add[2][3] = {};\n"))],
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
    """`nvcc -Xptxas -v` of the copy's flow_g.cu."""
    sys.path.insert(0, str(ROOT))
    from puflow_torch.ops import _build

    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(d / FLOW_G), "-o", os.devnull], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def registers(out: str) -> str:
    """The flow_g kernel's registers and spills from ptxas's report."""
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "flow_g_kernel" in line:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            return (f"regs {regs.group(1) if regs else '?'}, spill stores "
                    f"{spill.group(1) if spill else '?'} B")
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
        z = flow.flow_f_plain(blocks, x, conds)
        ws = interp.interp_head_plain(fp["interp"], x, idx8, 4)
        fz = torch.einsum("bnkc,bnkr->bncr", gather_points(z, idx8),
                          ws).contiguous()

        def blend():
            return flow.flow_g_blend(blocks, z, ws, idx8, conds)

        def g():
            return flow.flow_g(blocks, fz, conds)

        got, ref = blend(), flow.flow_g_blend_plain(blocks, z, ws, idx8,
                                                    conds)
        gate = (float((got - ref).abs().max())
                / (1e-5 * max(1.0, float(ref.abs().max()))))
        got_g, ref_g = g(), flow.flow_g_plain(blocks, fz, conds)
        gate_g = (float((got_g - ref_g).abs().max())
                  / (1e-5 * max(1.0, float(ref_g.abs().max()))))
        same = torch.equal(got, blend()) and torch.equal(got_g, g())
        ms = [cs.time_ms(blend, 10) for _ in range(3)]
        ms_g = [cs.time_ms(g, 10) for _ in range(3)]
    print(f"{label}: gate use {gate:.4f} / {gate_g:.4f}, rerun equal {same}"
          f", flow_g_blend ms {' '.join(f'{m:.4f}' for m in ms)}, flow_g ms "
          f"{' '.join(f'{m:.4f}' for m in ms_g)}", flush=True)


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
        raise SystemExit("flow_g_variants: needs a CUDA card")
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
            raise SystemExit(f"{name}: build failed\n{out}")
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
        print(f"{lines[-1]} | {regs[name]}" if lines and not proc.returncode
              else f"{name}: failed\n{out[-2000:]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
