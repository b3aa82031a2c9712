"""Times variants of the condition encoder kernel on one CUDA card.

    python3 scripts/encoder_variants.py [--parent DIR] [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/encoder_variants/` (gitignored) with one change to
`csrc/encoder.cu`, `csrc/mma_tf32.cuh` or `ops/encoder.py`; all are built
side by side, then each runs in its own process at the main path's
shapes (256 patches of 256 points, K = 16, the seeded, perturbed, folded
weights of `chip_smoke.py`). For each it prints the largest error against
the plain version as a share of the gate 5e-5 * scale + 1e-4, whether two
runs are bit-equal, the time of a call (CUDA events, three windows of 10
after a warm-up) and the device ms of each kind of launch in a call
(torch.profiler). The `diag_` variants drop work, fail the gate, and say
what sets the pace. `--parent DIR` times the `puflow_torch/` of another
checkout in the same run (for example `git archive` of the parent
commit). Names pick variants; none runs them all. Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "runs" / "encoder_variants"
ENC = "puflow_torch/csrc/encoder.cu"
MMA = "puflow_torch/csrc/mma_tf32.cuh"
OPS = "puflow_torch/ops/encoder.py"


def between(start: str, end: str, new: str):
    """An edit that replaces the text from ``start`` up to ``end``."""
    def edit(text: str) -> str:
        a, b = text.index(start), text.index(end)
        return text[:a] + new + text[b:]
    return edit


def swap(old: str, new: str):
    def edit(text: str) -> str:
        if old not in text:
            raise ValueError(f"not found: {old[:60]!r}")
        return text.replace(old, new)
    return edit


EDGE_TERMS = """  const float2 a = ldg2(ps + col);
  const float2 b0 = ldg2(pn0 + col);
  const float2 b1 = ldg2(pn1 + col);"""
GATHER = """      const float* pn0 =
          p_nbr + static_cast<size_t>(base + nbrs[s0 + g]) * S::kGt + t2;
      const float* pn1 =
          p_nbr + static_cast<size_t>(base + nbrs[s0 + g + 8]) * S::kGt + t2;"""
GROWTH_TERMS = """  float acc[S::kGn][4];
#pragma unroll
  for (int nt = 0; nt < S::kGn; ++nt)
    edge_terms(acc[nt], ps, pn0, pn1, J * S::kG + 8 * nt);
  tf32::mma_3x<J * S::kGn>(acc, h, wl + 32 * S::layer_frag(J), S::kGn);
"""
OUT_TERMS = """        float acc[S::kOutPass][4];
#pragma unroll
        for (int nt = 0; nt < S::kOutPass; ++nt)
          edge_terms(acc[nt], ps, pn0, pn1, S::kHw + 8 * (c0 + nt));
        tf32::mma_3x<S::kHt>(acc, h, wl + 32 * (S::kOutFrag + c0), S::kOn);
"""
PRODUCTS = """#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 b = w[(kc * w_tiles + nt) * 32];
      mma(acc[nt], hi, b.x, b.y);
      mma(acc[nt], hi, b.z, b.w);
      mma(acc[nt], lo, b.x, b.y);
    }
"""
SPLIT = """  hi = round(x);
  lo = round(x - __uint_as_float(hi));"""

# the edge launch with kPoints points a warp (`mma_3x` over P operands:
# one fragment read feeds each point's products)
TWO_POINTS_EDGE = r"""// The edge terms p_self[p] + p_nbr[q] of one n8 tile at column `col` for
// a lane's rows g and g + 8 (ps, pn0, pn1 already offset by the lane's
// columns 2t).
__device__ __forceinline__ void edge_terms(float (&acc)[4], const float* ps,
                                           const float* pn0, const float* pn1,
                                           int col) {
  const float2 a = ldg2(ps + col);
  const float2 b0 = ldg2(pn0 + col);
  const float2 b1 = ldg2(pn1 + col);
  acc[0] = a.x + b0.x;
  acc[1] = a.y + b0.y;
  acc[2] = a.x + b1.x;
  acc[3] = a.y + b1.y;
}

// A warp's kPoints points: their rows of p_self and of p_nbr for the slot
// tile's neighbours (a lane's rows g and g + 8), each offset by the lane's
// columns.
struct EdgeRows {
  const float* ps[kPoints];
  const float* pn0[kPoints];
  const float* pn1[kPoints];
};

// Growth layers J..L-1 of one slot tile: h_J = lrelu(e_J + [h_0 ..
// h_{J-1}] W_J + b_J) into h's tiles [J g / 8, (J + 1) g / 8) (bias
// offset by the lane's columns).
template <class S, int J>
__device__ __forceinline__ void growth_layers(
    float (&h)[kPoints][S::kHt][4], const EdgeRows& e, const float* bias,
    const float4* wl) {
  float acc[kPoints][S::kGn][4];
#pragma unroll
  for (int i = 0; i < kPoints; ++i)
#pragma unroll
    for (int nt = 0; nt < S::kGn; ++nt)
      edge_terms(acc[i][nt], e.ps[i], e.pn0[i], e.pn1[i],
                 J * S::kG + 8 * nt);
  tf32::mma_3x<J * S::kGn>(acc, h, wl + 32 * S::layer_frag(J), S::kGn);
#pragma unroll
  for (int nt = 0; nt < S::kGn; ++nt) {
    const float2 b = ldg2(bias + J * S::kG + 8 * nt);
#pragma unroll
    for (int i = 0; i < kPoints; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = acc[i][nt][r] + (r % 2 ? b.y : b.x);
        h[i][J * S::kGn + nt][r] = v > 0.f ? v : 0.05f * v;  // lrelu 0.05
      }
  }
  if constexpr (J + 1 < S::kL) growth_layers<S, J + 1>(h, e, bias, wl);
}

// Block `S` over n_points points of k slots (k a multiple of 16): a warp
// kPoints points at a time, the weights' B fragments resident in shared
// memory -> pooled [n_points, odim].
template <class S>
__global__ void __launch_bounds__(kEdgeThreads, 1)
encoder_edge_kernel(const float* __restrict__ p_self,
                    const float* __restrict__ p_nbr,
                    const int64_t* __restrict__ idx, int idx_stride, int n,
                    int k, int n_points, const float4* __restrict__ frags,
                    const float* __restrict__ bias,
                    float* __restrict__ pooled) {
  extern __shared__ float4 wsm[];
  for (int i = threadIdx.x; i < 32 * S::kFrags; i += kEdgeThreads)
    wsm[i] = frags[i];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
  const float4* wl = wsm + lane;
  const float* bl = bias + t2;
  const int step = gridDim.x * kEdgeWarps * kPoints;
  for (int p0 = (blockIdx.x * kEdgeWarps + threadIdx.x / 32) * kPoints;
       p0 < n_points; p0 += step) {
    // past the last point, a warp repeats it and stores nothing
    int pt[kPoints];
    EdgeRows e;
#pragma unroll
    for (int i = 0; i < kPoints; ++i) {
      pt[i] = min(p0 + i, n_points - 1);
      e.ps[i] = p_self + static_cast<size_t>(pt[i]) * S::kGt + t2;
    }
    for (int s0 = 0; s0 < k; s0 += kTile) {
#pragma unroll
      for (int i = 0; i < kPoints; ++i) {
        const int64_t base = static_cast<int64_t>(pt[i] / n) * n;
        const int64_t* nbrs = idx + static_cast<int64_t>(pt[i]) * idx_stride;
        e.pn0[i] =
            p_nbr + static_cast<size_t>(base + nbrs[s0 + g]) * S::kGt + t2;
        e.pn1[i] =
            p_nbr + static_cast<size_t>(base + nbrs[s0 + g + 8]) * S::kGt + t2;
      }
      float h[kPoints][S::kHt][4];
      growth_layers<S, 0>(h, e, bl, wl);
      for (int c0 = 0; c0 < S::kOn; c0 += S::kOutPass) {
        float acc[kPoints][S::kOutPass][4];
#pragma unroll
        for (int i = 0; i < kPoints; ++i)
#pragma unroll
          for (int nt = 0; nt < S::kOutPass; ++nt)
            edge_terms(acc[i][nt], e.ps[i], e.pn0[i], e.pn1[i],
                       S::kHw + 8 * (c0 + nt));
        tf32::mma_3x<S::kHt>(acc, h, wl + 32 * (S::kOutFrag + c0), S::kOn);
        // max over the 16 rows: a lane's two, then lanes 4, 8, 16 apart;
        // the bias after the max (rounding is monotonic: the same value)
#pragma unroll
        for (int i = 0; i < kPoints; ++i)
#pragma unroll
          for (int nt = 0; nt < S::kOutPass; ++nt) {
            float m0 = fmaxf(acc[i][nt][0], acc[i][nt][2]);
            float m1 = fmaxf(acc[i][nt][1], acc[i][nt][3]);
#pragma unroll
            for (int d = 4; d < 32; d *= 2) {
              m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, d));
              m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, d));
            }
            // lanes 4 nt .. 4 nt + 3 store tile nt
            if (g != nt || p0 + i >= n_points) continue;
            const int col = 8 * (c0 + nt);
            const float2 b = ldg2(bl + S::kHw + col);
            float2 v = make_float2(m0 + b.x, m1 + b.y);
            float2* o = reinterpret_cast<float2*>(
                pooled + static_cast<size_t>(pt[i]) * S::kOdim + t2 + col);
            if (s0 > 0) {
              const float2 prev = *o;
              v = make_float2(fmaxf(v.x, prev.x), fmaxf(v.y, prev.y));
            }
            *o = v;
          }
      }
    }
  }
}

"""
TWO_POINTS_MMA = r"""// acc[i][nt] += A_i W for P operands A_i over KT k8 chunks: A_i's chunk
// kc is the C fragment a_tiles[i][kc] (16 rows x 8 columns, split here),
// W's fragment for (kc, nt) the float4 {hi(b0), hi(b1), lo(b0), lo(b1)}
// at w[(kc * w_tiles + nt) * 32] (w already offset by the lane), read once
// for the P operands. Three products a chunk, tile and operand: hi*hi,
// hi*lo, lo*hi.
template <int KT, int P, int NT, int AT>
__device__ __forceinline__ void mma_3x(float (&acc)[P][NT][4],
                                       const float (&a_tiles)[P][AT][4],
                                       const float4* w, int w_tiles) {
  static_assert(KT <= AT, "more k chunks than A tiles");
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t hi[P][4], lo[P][4];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      split(a_tiles[i][kc][0], hi[i][0], lo[i][0]);
      split(a_tiles[i][kc][2], hi[i][1], lo[i][1]);
      split(a_tiles[i][kc][1], hi[i][2], lo[i][2]);
      split(a_tiles[i][kc][3], hi[i][3], lo[i][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 b = w[(kc * w_tiles + nt) * 32];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        mma(acc[i][nt], hi[i], b.x, b.y);
        mma(acc[i][nt], hi[i], b.z, b.w);
        mma(acc[i][nt], lo[i], b.x, b.y);
      }
    }
  }
}

// mma_3x of one operand.
template <int KT, int NT, int AT>
__device__ __forceinline__ void mma_3x(float (&acc)[NT][4],
                                       const float (&a_tiles)[AT][4],
                                       const float4* w, int w_tiles) {
  mma_3x<KT>(reinterpret_cast<float(&)[1][NT][4]>(acc),
             reinterpret_cast<const float(&)[1][AT][4]>(a_tiles), w,
             w_tiles);
}

"""

VARIANTS = {
    "kept": [],
    "edge_threads_256": [(ENC, swap("constexpr int kEdgeThreads = 384;",
                                    "constexpr int kEdgeThreads = 256;"))],
    "rows_threads_384": [(ENC, swap("constexpr int kRowsThreads = 256;",
                                    "constexpr int kRowsThreads = 384;"))],
    "conv_out_32_columns": [(ENC, swap("constexpr int kOutTiles = 8;",
                                       "constexpr int kOutTiles = 4;"))],
    # the edge terms loaded before the products and added after them
    "edge_terms_after_products": [
        (ENC, swap(GROWTH_TERMS, GROWTH_TERMS.replace(
            "edge_terms(acc[nt]", "edge_terms(e[nt]").replace(
            "  float acc[S::kGn][4];\n",
            "  float acc[S::kGn][4] = {}, e[S::kGn][4];\n") + """#pragma unroll
  for (int nt = 0; nt < S::kGn; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = e[nt][i] + acc[nt][i];
""")),
        (ENC, swap(OUT_TERMS, OUT_TERMS.replace(
            "edge_terms(acc[nt]", "edge_terms(e[nt]").replace(
            "        float acc[S::kOutPass][4];\n",
            "        float acc[S::kOutPass][4] = {}, e[S::kOutPass][4];\n")
            + """#pragma unroll
        for (int nt = 0; nt < S::kOutPass; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = e[nt][i] + acc[nt][i];
"""))],
    # a chunk's fragments read first, then its products in three passes
    "three_passes": [(MMA, swap(PRODUCTS, """    float4 b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = w[(kc * w_tiles + nt) * 32];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma(acc[nt], hi, b[nt].x, b[nt].y);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma(acc[nt], hi, b[nt].z, b[nt].w);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma(acc[nt], lo, b[nt].x, b[nt].y);
"""))],
    # two points a warp: half the fragment reads a product; 256 threads
    # and conv_out 32 columns a pass, for the registers
    "two_points_a_warp": [
        (ENC, swap("constexpr int kEdgeThreads = 384;",
                   "constexpr int kEdgeThreads = 256;")),
        (ENC, swap("constexpr int kEdgeWarps = kEdgeThreads / 32;\n",
                   "constexpr int kEdgeWarps = kEdgeThreads / 32;\n"
                   "constexpr int kPoints = 2;\n")),
        (ENC, swap("constexpr int kOutTiles = 8;",
                   "constexpr int kOutTiles = 4;")),
        (ENC, between("// The edge terms p_self[p] + p_nbr[q]",
                      "template <class S>\ncudaError_t launch_edge",
                      TWO_POINTS_EDGE)),
        (ENC, swap("kEdgeThreads, S::kSmem, n_points, &grid)",
                   "kEdgeThreads, S::kSmem,\n"
                   "      (n_points + kPoints - 1) / kPoints, &grid)")),
        (MMA, between("// acc[nt] += A W over KT k8 chunks",
                      "}  // namespace tf32", TWO_POINTS_MMA))],
    # the weights packed again at every call
    "pack_every_call": [(OPS, swap(
        "weights, meta = _build.packed(tree_flatten(blocks)[0],\n"
        "                                  lambda: _pack(params))",
        "weights, meta = _pack(params)"))],
    "diag_hi_hi_only": [(MMA, swap(PRODUCTS, PRODUCTS.replace(
        "      mma(acc[nt], hi, b.z, b.w);\n"
        "      mma(acc[nt], lo, b.x, b.y);\n", "")))],
    "diag_no_split": [(MMA, swap(SPLIT, """  hi = __float_as_uint(x);
  lo = 0u;"""))],
    # every slot reads the point's own row of p_nbr
    "diag_no_gather": [(ENC, swap(GATHER, """      const float* pn0 = p_nbr + static_cast<size_t>(p) * S::kGt + t2 +
                         0 * (base + nbrs[s0]);
      const float* pn1 = pn0;"""))],
    "diag_no_edge_loads": [(ENC, swap(EDGE_TERMS, """  const float2 a = make_float2(0.f, 0.f);
  const float2 b0 = make_float2(__int_as_float(col), 0.f);
  const float2 b1 = make_float2(0.f, __int_as_float(col + 1));"""))],
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


def launch_kind(name: str) -> str:
    if "encoder_rows" in name:
        return "rows"
    if "encoder_edge" in name:
        g = re.search(r"EdgeShape<(\d+)", name)
        return f"edge g={g.group(1)}" if g else "edge"
    return "other"


def measure(label: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from puflow_torch.ops import encoder as enc
    from puflow_torch.ops.knn import knn_self_plain

    _, folded = cs.seeded_models()
    fp, _ = folded.trees()
    with torch.no_grad():
        x = cs.main_path_patches(8)
        idx = knn_self_plain(x, 16)
        got = enc.encoder_conditions(fp, x, idx)
        ref = enc.encoder_conditions_plain(fp, x, idx)
        gate = max(float((g - r).abs().max())
                   / (5e-5 * float(r.abs().max()) + 1e-4)
                   for g, r in zip(got, ref))
        again = enc.encoder_conditions(fp, x, idx)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ms = [cs.time_ms(lambda: enc.encoder_conditions(fp, x, idx), 10)
              for _ in range(3)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                enc.encoder_conditions(fp, x, idx)
            torch.cuda.synchronize()
    per = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[launch_kind(e.name)] += (e.time_range.end
                                         - e.time_range.start) / 3e3
    parts = ", ".join(f"{k} {v:.3f}" for k, v in sorted(per.items()))
    print(f"{label}: gate use {gate:.4f}, rerun equal {same}, ms "
          f"{' '.join(f'{m:.4f}' for m in ms)} | device ms a call: {parts}",
          flush=True)


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
        raise SystemExit("encoder_variants: needs a CUDA card")
    names = args.names or list(VARIANTS)
    dirs = {name: prepare(name, ROOT, VARIANTS[name]) for name in names}
    if args.parent:
        dirs["parent"] = prepare("parent", args.parent.resolve(), [])
    builds = {name: run_in(d, ["-c", "from puflow_torch.ops import _build; "
                                     "_build.build()"])
              for name, d in dirs.items()}
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{out}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for name, d in dirs.items():
        proc = run_in(d, [str(Path(__file__).resolve()), "--measure", name])
        out, _ = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(name + ":")]
        print(lines[-1] if lines and not proc.returncode
              else f"{name}: failed\n{out[-2000:]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
