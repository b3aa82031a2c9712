// Inverse flow g (interpolated latents -> points), all flow blocks in one
// launch, over conditions that are not repeated; with the latent blend of
// the interpolation in its prologue (puflow_flow_g_blend).
//
// Replaces the TPU kernels `flow_g_pallas` and `flow_g_blend_pallas`
// (puflow_tpu/ops/pallas/flow_pallas.py, `_flow_g_kernel`,
// `_flow_g_blend_kernel`, both on `_flow_g_body`). Per block, in
// inverse order: affine injector z = z * exp(MLP_s(c)) + MLP_b(c) ->
// reverse channels -> additive coupling h2 += MLP([h1, c]) -> inv1x1
// (z' = W^-1 z) -> ActNorm (z - bias) * exp(-logs). Input latents are
// [P, 3, r] (P points, r samples each); output rows are point-major
// [P * r, 3], the r samples of a point consecutive. Plain versions:
// `flow_g_plain` and `flow_g_blend_plain` in puflow_torch/ops/flow.py.
//
// The blend: each point's r latents are sum_s z[q_s] w[s, :] over its k
// neighbours q_s, from flow_f's latents z [P, 3] and the interpolation
// head's weights [P, k, r]. The prologue computes them straight into the
// tile's state rows, so the interpolated latents never make a round trip
// through device memory of their own and no second kernel runs.
//
// What bounds it on the H100: its products. Of the three MLPs per block,
// the two injector MLPs and the coupling's condition projection w0_c . c
// depend only on the point's condition, so they run once per point and
// are reused for its r samples (at r = 4 about 62% of the multiply-adds);
// the coupling's h1 term and its last two layers run per row. The kernel
// computes the exact f32 function (the TPU kernel's 3-pass bf16 split)
// as 3xTF32 products on the tensor cores (mma_tf32.cuh): three TF32
// products for each f32 one, so the least time is 3 x 2 x the
// multiply-adds at the dense TF32 rate (chip_smoke.py:flow_macs). The
// 3-wide steps (the blend, the injector's scale and bias, the h1 term of
// the coupling's first layer, W^-1, ActNorm) stay f32 FMAs.
//
// Design (its pieces shared with flow_f.cu in flow_common.cuh): a
// persistent grid of one block an SM walks the flow blocks in turn; for
// each it stages the block's weights in shared memory once and its warps
// then walk the thread block's share of point tiles. Every
// product is a warp's m16n8k8 `mma.sync` on a tile of 16 points:
//   per point: the three first layers read the tile's conditions straight
//     from device memory as A fragments, the injector's two in one pass
//     (each chunk loaded and split once for both); each 64-wide output
//     stays in its C fragments and is the next layer's A operand (the host
//     orders each k8 chunk's weight rows 0 2 4 6 1 3 5 7, mma_tf32.cuh);
//     the 64 -> 3 layers are an n8 tile with zero columns, whose three
//     columns a lane gathers from the lanes holding them. exp(scale) and
//     the bias (6 floats a point) and the projection (the C fragments of
//     [16 x 64]) stay in registers;
//   per row, sample by sample: row tile s holds sample s of the tile's 16
//     points, so row i of it belongs to point i and the projection's C
//     fragments start the coupling's first layer as they are. The rows'
//     3-wide state stays in the output rows between flow blocks (12 bytes
//     a row, L2-resident).
// Shared memory holds one block's weights as B fragments (204 KB at
// cdim = 128 of kMaxSmem's 227 KB): the first layers' and the 64 -> 3
// layers' as f32 pairs, split into tf32 hi / lo as they are read (all
// pre-split would take 310 KB); the three 64 x 64 layers' pre-split on
// the host (96 KB).
// Reruns are bit-equal: one fixed order, no atomics.
// Measured on an H100 at 256 patches and r = 4 (scripts/flow_g_variants.py,
// PERF.md): 0.79-0.82 ms a call of flow_g_blend, 3.6-3.8x its 3xTF32
// bound, where the CUDA-core kernel before it took 3.2-3.3 ms. Against the
// kept design, rounding with `cvt.rna.tf32.f32` took 34% longer, the
// injector's first layers in two passes 22%, the 64 x 64 layers split as
// read 13%, 4-byte condition loads 11%, 8 or 16 warps an SM 15% / 2%. A
// third of the products (hi * hi only) still takes 0.44 ms: what is left
// is each warp's chain of splits, fragment reads and dependent products,
// as in the encoder (PERF.md, section 6).

#include <cstdint>

#include "flow_common.cuh"

namespace puflow {
namespace {

constexpr int kGThreads = 384;     // 12 warps an SM
constexpr int kGWarps = kGThreads / 32;

// The blend's inputs; z == nullptr selects flow_g's latents `fz`.
struct Blend {
  const float* z;        // [n_points, 3] latents of flow_f
  const float* ws;       // [n_points, k, r] interpolation weights
  const int64_t* idx;    // point p's neighbours at idx[p * idx_stride + s],
                         // indices within its patch of n points
  int idx_stride, n, k;
};

// Sample s of the tile's 16 points (row tile s, row i of it point i):
// the injector inverse and the reverse permutation, the coupling (its
// first layer the point's projection hc plus the h1 columns in f32), W^-1
// and ActNorm. The state comes from and goes to the rows zrow[i] + 3 s of
// points g and g + 8; lane t < 3 stores channel t.
__device__ __forceinline__ void row_step(const FlowBlock& W,
                                         const float (&hc)[kHt][4],
                                         const float (&esc)[2][3],
                                         const float (&bi)[2][3], int split,
                                         int s, float* const (&zrow)[2],
                                         const bool (&ok)[2], int lane) {
  const int t = lane % 4;
  const int t2 = 2 * t;
  float z[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      z[i][2 - ch] =
          (ok[i] ? zrow[i][s * 3 + ch] : 0.f) * esc[i][ch] + bi[i][ch];
  float h[kHt][4];
  coupling_first(h, hc, W.w0h, z, split, t2);
  float add[2][3];
  mlp_tail(h, W.c_w1, W.c_b1, W.c_w2, W.c_b2, lane, add);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (split == 1) {
      z[i][1] += add[i][0];
      z[i][2] += add[i][1];
    } else {
      z[i][2] += add[i][0];
    }
    float y[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      y[c] = (W.head[6 + 3 * c] * z[i][0] + W.head[7 + 3 * c] * z[i][1] +
              W.head[8 + 3 * c] * z[i][2] - W.head[c]) *
             W.head[3 + c];
    if (ok[i] && t < 3)
      zrow[i][s * 3 + t] = t == 0 ? y[0] : t == 1 ? y[1] : y[2];
  }
}

// One flow block on a tile of 16 points from pt0 and their r rows each,
// the state in out's rows; KT k chunks cover the condition.
template <int KT>
__device__ __forceinline__ void g_tile(const FlowBlock& W,
                                       const float* __restrict__ c, int cdim,
                                       int split, int pt0, int n_points,
                                       int r, float* out, int lane) {
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
  // rows past the last point compute on its condition and store nothing
  const float* c0 = c + static_cast<size_t>(min(pt0 + g, n_points - 1)) * cdim;
  const float* c1 =
      c + static_cast<size_t>(min(pt0 + g + 8, n_points - 1)) * cdim;

  // once per point: the injector's exp(scale) and bias (their first
  // layers in one pass over the conditions), the coupling's condition
  // projection
  float esc[2][3], bi[2][3];
  {
    float h[2][kHt][4];
    const float2* w0[2] = {W.s_w0, W.b_w0};
    first_layers<KT>(h, c0, c1, cdim, t2, w0);
    bias_lrelu(h[0], nullptr);
    bias_lrelu(h[1], nullptr);
    mlp_tail(h[0], W.s_w1, W.s_b1, W.s_w2, W.s_b2, lane, esc);
    mlp_tail(h[1], W.b_w1, W.b_b1, W.b_w2, W.b_b2, lane, bi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) esc[i][ch] = expf(esc[i][ch]);
  }
  float hc[1][kHt][4];
  const float2* wc[1] = {W.c_w0};
  first_layers<KT>(hc, c0, c1, cdim, t2, wc);

  // per row, a sample at a time
  const bool ok[2] = {pt0 + g < n_points, pt0 + g + 8 < n_points};
  float* const zrow[2] = {out + static_cast<size_t>(pt0 + g) * r * 3,
                          out + static_cast<size_t>(pt0 + g + 8) * r * 3};
  for (int s = 0; s < r; ++s)
    row_step(W, hc[0], esc, bi, split, s, zrow, ok, lane);
}

// The first block's prologue: the latents of a tile's rows into out,
// blended (blend.z set) or read from fz [n_points, 3, r].
__device__ __forceinline__ void prologue(const float* __restrict__ fz,
                                         const Blend& blend, float* out,
                                         int pt0, int n_points, int r,
                                         int lane) {
  const int np = min(kTile, n_points - pt0);
  float* z_tile = out + static_cast<size_t>(pt0) * r * 3;
  for (int i = lane; i < np * r * 3; i += 32) {
    const int p = i / (3 * r);
    const int rem = i - p * 3 * r;
    const int ch = rem / r;
    const int s = rem - ch * r;
    float v;
    if (blend.z == nullptr) {
      v = fz[static_cast<size_t>(pt0) * 3 * r + i];
    } else {
      const int gp = pt0 + p;
      const int64_t base = static_cast<int64_t>(gp / blend.n) * blend.n;
      const int64_t* nb =
          blend.idx + static_cast<int64_t>(gp) * blend.idx_stride;
      const float* w = blend.ws + static_cast<size_t>(gp) * blend.k * r + s;
      v = 0.f;
      for (int q = 0; q < blend.k; ++q)
        v = fmaf(blend.z[(base + nb[q]) * 3 + ch], w[q * r], v);
    }
    z_tile[(p * r + s) * 3 + ch] = v;
  }
}

__global__ void __launch_bounds__(kGThreads, 1)
flow_g_kernel(const float* __restrict__ fz, Blend blend, FlowArgs args,
              const float* __restrict__ weights, float* __restrict__ out,
              int n_points, int r) {
  extern __shared__ float4 wsm[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int tile0, tile1;
  tile_share(n_points, tile0, tile1);
  for (int b = args.nblocks - 1; b >= 0; --b) {
    __syncthreads();   // every warp is done with the last block's weights
    stage_block<kGThreads>(weights, args, b, wsm);
    __syncthreads();
    const int cdim = args.cdim[b];
    const int kt = kt_of(cdim);
    const int split = (b % 2 == 0) ? 1 : 2;
    const FlowBlock W =
        flow_block(reinterpret_cast<const float*>(wsm), kt, lane);
    for (int tile = tile0 + warp; tile < tile1; tile += kGWarps) {
      const int pt0 = tile * kTile;
      if (b == args.nblocks - 1) {
        prologue(fz, blend, out, pt0, n_points, r, lane);
        __syncwarp();
      }
      if (kt == 4)
        g_tile<4>(W, args.cs[b], cdim, split, pt0, n_points, r, out, lane);
      else if (kt == 8)
        g_tile<8>(W, args.cs[b], cdim, split, pt0, n_points, r, out, lane);
      else
        g_tile<16>(W, args.cs[b], cdim, split, pt0, n_points, r, out, lane);
    }
  }
}

cudaError_t launch_g(const float* fz, const Blend& blend, const void* weights,
                     const void* c_ptrs, const void* cdims, const void* woff,
                     int nblocks, int n_points, int r, void* out,
                     void* stream) {
  FlowArgs args;
  cudaError_t err = check_blocks(&args, weights, c_ptrs, cdims, woff, nblocks);
  if (err != cudaSuccess) return err;
  if (r < 1) return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * args.wmax;
  int grid = 0;
  // as many SMs as there are tiles, each walking its share
  err = persistent_grid(flow_g_kernel, kGThreads, smem,
                        (n_points + kTile - 1) / kTile, &grid);
  if (err != cudaSuccess) return err;
  flow_g_kernel<<<grid, kGThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fz, blend, args, static_cast<const float*>(weights),
      static_cast<float*>(out), n_points, r);
  return cudaGetLastError();
}

}  // namespace
}  // namespace puflow

// fz [n_points, 3, r] -> out [n_points * r, 3], point-major. c_ptrs /
// cdims / woff are host arrays of nblocks, nblocks and nblocks + 1 entries;
// the conditions are [n_points, cdim] (not repeated), cdim even and <= 128,
// 8-byte aligned; the weights (16-byte aligned) are `_pack`'s, inverse.
extern "C" int puflow_flow_g(const void* fz, const void* weights,
                             const void* c_ptrs, const void* cdims,
                             const void* woff, int nblocks, int n_points,
                             int r, void* out, void* stream) {
  using namespace puflow;
  return launch_g(static_cast<const float*>(fz), Blend{}, weights, c_ptrs,
                  cdims, woff, nblocks, n_points, r, out, stream);
}

// z [n_points, 3] (patches of n points), ws [n_points, k, r], idx
// [n_points, >= k] int64 with row stride idx_stride -> out [n_points * r,
// 3], point-major; the other arguments as for puflow_flow_g.
extern "C" int puflow_flow_g_blend(const void* z, const void* ws,
                                   const void* idx, int idx_stride, int n,
                                   int k, const void* weights,
                                   const void* c_ptrs, const void* cdims,
                                   const void* woff, int nblocks,
                                   int n_points, int r, void* out,
                                   void* stream) {
  using namespace puflow;
  if (z == nullptr || k < 1 || n < 1 || n_points % n != 0)
    return cudaErrorInvalidValue;
  const Blend blend{static_cast<const float*>(z),
                    static_cast<const float*>(ws),
                    static_cast<const int64_t*>(idx), idx_stride, n, k};
  return launch_g(nullptr, blend, weights, c_ptrs, cdims, woff, nblocks,
                  n_points, r, out, stream);
}
