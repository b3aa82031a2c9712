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
// What bounds it on the H100: FP32 FMAs, as in flow_f. Of the three MLPs
// per block, the two injector MLPs and the coupling's condition
// projection w0_c . c depend only on the point's condition, so they run
// once per point and are reused for its r samples; only the coupling's
// h1 term and its last two layers run per row. At r = 4 that removes
// about two thirds of the multiply-adds, and the conditions are read once
// per point: repeat(cs, r) is never formed.
//
// Design: a thread block owns 48 points (48 r rows) for all blocks of the
// flow. Per flow block it stages the block's weights (about 150 KB at
// cdim = 128) and the points' conditions in shared memory, runs the
// per-point MLPs on all 48 points at once, then walks the rows 64 at a
// time. The 3-wide state of the rows stays in the tile's output rows
// between flow blocks (12 bytes a row, L2-resident), so shared memory does
// not grow with r. Exact f32 throughout (the TPU default was a 2-pass
// bf16 split); W^-1 comes from torch.linalg.inv on the host side, as the
// plain version computes it.

#include <cstdint>

#include "flow_common.cuh"

namespace puflow {
namespace {

// Points per tile: the most whose conditions, per-point projections and
// injector outputs fit beside a cdim = 128 block's weights.
constexpr int kPoints = 48;

// Shared-memory floats of a tile: weights, the point conditions, the
// per-point coupling projection, two [kRows] hidden tiles, the injector's
// scale and bias per point, and the state and coupling output of a chunk
// of kRows rows.
__host__ __device__ inline int g_smem_floats(int wmax, int ldc) {
  return wmax + kPoints * ldc + kPoints * kLdH + 2 * kRows * kLdH +
         2 * kPoints * 3 + 2 * kRows * 3;
}

// The blend's inputs; z == nullptr selects flow_g's latents `fz`.
struct Blend {
  const float* z;        // [n_points, 3] latents of flow_f
  const float* ws;       // [n_points, k, r] interpolation weights
  const int64_t* idx;    // point p's neighbours at idx[p * idx_stride + s],
                         // indices within its patch of n points
  int idx_stride, n, k;
};

__global__ void __launch_bounds__(kThreads, 1)
flow_g_kernel(const float* __restrict__ fz, Blend blend, FlowArgs args,
              const float* __restrict__ weights, float* __restrict__ out,
              int n_points, int r, int ldc_max) {
  extern __shared__ float smem[];
  float* w_s = smem;                        // [wmax]
  float* cp = w_s + args.wmax;              // [kPoints][ldc] conditions
  float* h_c = cp + kPoints * ldc_max;      // [kPoints][kLdH] w0_c . c
  float* h_a = h_c + kPoints * kLdH;        // [kRows][kLdH]
  float* h_b = h_a + kRows * kLdH;          // [kRows][kLdH]
  float* sc = h_b + kRows * kLdH;           // [kPoints][3] injector scale
  float* bi = sc + kPoints * 3;             // [kPoints][3] injector bias
  float* zc = bi + kPoints * 3;             // [kRows][3] state of a chunk
  float* t0 = zc + kRows * 3;               // [kRows][3] coupling output

  const int t = threadIdx.x;
  const int p0 = blockIdx.x * kPoints;
  const int np = min(kPoints, n_points - p0);
  const int rows = np * r;

  // The state of the tile's rows lives in its output rows: 12 bytes a row,
  // read and written once per flow block. Latents [np][3][r] -> rows
  // p * r + s.
  float* z_tile = out + static_cast<size_t>(p0) * r * 3;
  for (int i = t; i < rows * 3; i += kThreads) {
    const int p = i / (3 * r);
    const int rem = i - p * 3 * r;
    const int ch = rem / r;
    const int s = rem - ch * r;
    float v;
    if (blend.z == nullptr) {
      v = fz[static_cast<size_t>(p0) * 3 * r + i];
    } else {
      const int gp = p0 + p;
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

  for (int b = args.nblocks - 1; b >= 0; --b) {
    const int cdim = args.cdim[b];
    const int split = (b % 2 == 0) ? 1 : 2;
    const int ldc = cdim | 1;
    __syncthreads();  // the previous block is done with w_s and cp
    stage_weights(weights, args, b, w_s);
    const float* c = args.cs[b] + static_cast<size_t>(p0) * cdim;
    for (int i = t; i < kPoints * cdim; i += kThreads) {
      const int p = i / cdim;
      cp[p * ldc + (i - p * cdim)] = p < np ? c[i] : 0.f;
    }
    __syncthreads();
    const BlockWeights W = block_weights(w_s, cdim, split);

    // once per point: the injector's scale and bias nets, and the
    // coupling's condition projection w0_c . c
    dense_hidden<true>(cp, ldc, cdim, W.s_w0, nullptr, h_a, np);
    __syncthreads();
    dense_hidden<true>(h_a, kLdH, kHidden, W.s_w1, W.s_b1, h_b, np);
    __syncthreads();
    dense_out(h_b, W.s_w2, W.s_b2, 3, sc, np);
    __syncthreads();
    dense_hidden<true>(cp, ldc, cdim, W.b_w0, nullptr, h_a, np);
    __syncthreads();
    dense_hidden<true>(h_a, kLdH, kHidden, W.b_w1, W.b_b1, h_b, np);
    __syncthreads();
    dense_out(h_b, W.b_w2, W.b_b2, 3, bi, np);
    dense_hidden<false>(cp, ldc, cdim, W.c_w0 + split * kHidden, nullptr, h_c,
                        np);
    __syncthreads();

    // per row, kRows rows at a time
    for (int j0 = 0; j0 < rows; j0 += kRows) {
      const int nr = min(kRows, rows - j0);
      if (t < nr) {
        // affine injector inverse, then the reverse permutation
        const int p = (j0 + t) / r;
        float v[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          v[ch] = z_tile[(j0 + t) * 3 + ch] * expf(sc[p * 3 + ch]) +
                  bi[p * 3 + ch];
        zc[t * 3] = v[2];
        zc[t * 3 + 1] = v[1];
        zc[t * 3 + 2] = v[0];
      }
      __syncthreads();
      // additive coupling inverse, h2 += MLP([h1, c]): the first layer is
      // the point's projection plus the h1 columns
      for (int i = t; i < nr * kHidden; i += kThreads) {
        const int jj = i / kHidden;
        const int o = i - jj * kHidden;
        float h = h_c[((j0 + jj) / r) * kLdH + o];
        for (int s = 0; s < split; ++s)
          h = fmaf(zc[jj * 3 + s], W.c_w0[s * kHidden + o], h);
        h_a[jj * kLdH + o] = lrelu(h);
      }
      __syncthreads();
      dense_hidden<true>(h_a, kLdH, kHidden, W.c_w1, W.c_b1, h_b, nr);
      __syncthreads();
      dense_out(h_b, W.c_w2, W.c_b2, 3 - split, t0, nr);
      __syncthreads();
      if (t < nr) {
        float v[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) v[ch] = zc[t * 3 + ch];
        for (int o = 0; o < 3 - split; ++o) v[split + o] += t0[t * 3 + o];
        // inv1x1 inverse (z' = W^-1 z), then ActNorm inverse
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float y = W.head[6 + 3 * i] * v[0] +
                          W.head[7 + 3 * i] * v[1] + W.head[8 + 3 * i] * v[2];
          z_tile[(j0 + t) * 3 + i] = (y - W.head[i]) * W.head[3 + i];
        }
      }
    }
  }
}

cudaError_t launch_g(const float* fz, const Blend& blend, const void* weights,
                     const void* c_ptrs, const void* cdims, const void* woff,
                     int nblocks, int n_points, int r, void* out,
                     void* stream) {
  FlowArgs args;
  const int cmax = fill_args(&args, static_cast<const long long*>(c_ptrs),
                             static_cast<const int*>(cdims),
                             static_cast<const int*>(woff), nblocks);
  if (cmax < 0 || r < 1) return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  const int ldc_max = cmax | 1;
  const size_t smem = sizeof(float) * g_smem_floats(args.wmax, ldc_max);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flow_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (n_points + kPoints - 1) / kPoints;
  flow_g_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fz, blend, args, static_cast<const float*>(weights),
      static_cast<float*>(out), n_points, r, ldc_max);
  return cudaGetLastError();
}

}  // namespace
}  // namespace puflow

// fz [n_points, 3, r] -> out [n_points * r, 3], point-major. c_ptrs /
// cdims / woff are host arrays of nblocks, nblocks and nblocks + 1 entries;
// the conditions are [n_points, cdim] (not repeated).
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
