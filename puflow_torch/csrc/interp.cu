// Interpolation head: the weight head of the discrete model's latent
// interpolation on BN-folded weights, with three epilogues.
//
// Replaces the TPU kernels `interp_weights_cm_pallas(_t)`,
// `interp_logits_pallas` and `interp_latents_pallas`
// (puflow_tpu/ops/pallas/encoder_pallas.py, `_interp_cm_kernel`,
// `_interp_kernel`, `_interp_latents_kernel`). For every (point p, slot s)
// row, with q = idx[p, s] the slot's neighbour:
//   f10 = [x_p, x_q, x_p - x_q, |x_p - x_q|]
//   distance MLP 10 -> 64 -> 64 -> 128 (LeakyReLU 0.01)         -> d
//   context EdgeConv on [x_p, x_q, x_q - x_p]: 8 growth-16 layers
//   (LeakyReLU 0.05) and conv_out 137 -> 128, no pooling        -> e
//   weight MLP [d, e] 256 -> 128 -> 64 -> 32 (LeakyReLU 0.01)   -> logits
// then, per point, a max-subtracted softmax over its k slots of the first
// r logits. mode 0 writes the logits [points, k, 32]; mode 1 the weights
// [points, k, r] (what flow_g_blend reads); mode 2 the latents
// [points, 3, r] = sum_s z[q_s] w_s. Plain version: `interp_head_plain` in
// puflow_torch/ops/interp.py.
//
// What bounds it on the H100: FP32 FMAs, about 82 k multiply-adds a row
// (8 rows a point), 44% of them in the weight MLP's first layer. The TPU
// kernel ran single-pass bf16 (INTERP_FAST) for MXU speed; this kernel
// computes the exact f32 function, and so meets the JAX package's exact
// bounds.
//
// Design: every row is independent once its neighbour's coordinates are
// gathered (the context EdgeConv projects the raw neighbour, it does not
// pool), so a block owns 16 whole points x 8 slots = 128 rows and keeps
// all of a row's activations in shared memory: 394 floats a row, laid out
// [f10 | 128 hidden | 256 context] and reused layer by layer. The head's
// 80 k weights (321 KB) stream through a 16 KB chunk (dense.cuh); the
// context EdgeConv's edge term is folded into each layer's matmul by
// giving it the rows [W_self; W_nbr; 0] over f10's first 10 columns.
// 218 KB of shared memory, one block per SM; of 256 and 512 threads a
// block, 256 (up to 64 accumulators a thread) timed faster on the H100.

#include <cstdint>

#include "dense.cuh"

namespace puflow {
namespace {

using dense::kRows;
using dense::kWbuf;

constexpr int kThreads = 256;

constexpr int kF = 0;          // f10, then the EdgeConv's growth outputs
constexpr int kH = 10;         // 128 hidden columns
constexpr int kCtx = 138;      // 256 context columns [d, e]
constexpr int kLd = 395;       // row stride (odd)
constexpr int kLogits = 32;    // R_MAX
constexpr int kGrowth = 16;
constexpr int kFeuLayers = 8;
constexpr int kLayers = 3 + kFeuLayers + 1 + 3;

struct Head {
  const float* w[kLayers];     // [in, out] matrices, in the order below
  const float* b[kLayers];
};

// Layer l of the head over the tile's rows (row stride kLd), then a
// barrier so the next layer may read its output.
template <int NOUT, int ACT>
__device__ __forceinline__ void head_layer(const float* in, int k_in,
                                           const Head& head, int l,
                                           float* out, float* wbuf) {
  dense::layer_w<kThreads, NOUT, ACT, false>(in, kLd, k_in, head.w[l], NOUT,
                                             head.b[l], nullptr, 0, out, kLd,
                                             kRows, wbuf);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
interp_head_kernel(const float* __restrict__ xyz,
                   const int64_t* __restrict__ idx, int idx_stride, int n,
                   int k, int n_points, Head head, int mode, int r,
                   const float* __restrict__ z, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                    // [kRows][kLd]
  float* wbuf = act + kRows * kLd;      // [kWbuf]
  const int t = threadIdx.x;
  const int ppt = kRows / k;
  const int p0 = blockIdx.x * ppt;
  const int np = min(ppt, n_points - p0);
  const int rows = np * k;

  // f10 of every row; padding rows are zero
  for (int row = t; row < kRows; row += kThreads) {
    float f[10] = {};
    if (row < rows) {
      const int pl = row / k;
      const int p = p0 + pl;
      const int64_t q =
          static_cast<int64_t>(p / n) * n +
          idx[static_cast<int64_t>(p) * idx_stride + (row - pl * k)];
      for (int ch = 0; ch < 3; ++ch) {
        f[ch] = xyz[static_cast<size_t>(p) * 3 + ch];
        f[3 + ch] = xyz[static_cast<size_t>(q) * 3 + ch];
        f[6 + ch] = f[ch] - f[3 + ch];
      }
      f[9] = sqrtf(f[6] * f[6] + f[7] * f[7] + f[8] * f[8]);
    }
    for (int c = 0; c < 10; ++c) act[row * kLd + kF + c] = f[c];
  }
  __syncthreads();

  // distance MLP: f10 -> H[0:64] -> H[64:128] -> context[0:128]
  head_layer<64, dense::kLrelu01>(act + kF, 10, head, 0, act + kH, wbuf);
  head_layer<64, dense::kLrelu01>(act + kH, 64, head, 1, act + kH + 64, wbuf);
  head_layer<128, dense::kNone>(act + kH + 64, 64, head, 2, act + kCtx, wbuf);
  // context EdgeConv: layer j reads [f10, h_0 .. h_{j-1}], writes h_j
  for (int j = 0; j < kFeuLayers; ++j)
    head_layer<kGrowth, dense::kLrelu05>(act + kF, kH + kGrowth * j, head,
                                         3 + j, act + kH + kGrowth * j, wbuf);
  head_layer<128, dense::kNone>(act + kF, kH + kGrowth * kFeuLayers, head,
                                3 + kFeuLayers, act + kCtx + 128, wbuf);
  // weight MLP: context -> H[0:128] -> context[0:64] -> H[0:32]
  constexpr int kW = 4 + kFeuLayers;
  head_layer<128, dense::kLrelu01>(act + kCtx, 256, head, kW, act + kH, wbuf);
  head_layer<64, dense::kLrelu01>(act + kH, 128, head, kW + 1, act + kCtx,
                                  wbuf);
  head_layer<kLogits, dense::kNone>(act + kCtx, 64, head, kW + 2, act + kH,
                                    wbuf);
  const float* logits = act + kH;

  if (mode == 0) {
    for (int i = t; i < rows * kLogits; i += kThreads) {
      const int row = i / kLogits;
      out[static_cast<size_t>(p0) * k * kLogits + i] =
          logits[row * kLd + (i - row * kLogits)];
    }
    return;
  }
  // softmax over the k slots of each of the first r logits
  for (int i = t; i < np * r; i += kThreads) {
    const int pl = i / r;
    const int j = i - pl * r;
    const float* lg = logits + pl * k * kLd + j;
    float mx = lg[0];
    for (int s = 1; s < k; ++s) mx = fmaxf(mx, lg[s * kLd]);
    float sum = 0.f;
    for (int s = 0; s < k; ++s) sum += expf(lg[s * kLd] - mx);
    const int p = p0 + pl;
    if (mode == 1) {
      float* w_out = out + static_cast<size_t>(p) * k * r + j;
      for (int s = 0; s < k; ++s) w_out[s * r] = expf(lg[s * kLd] - mx) / sum;
    } else {
      const int64_t base = static_cast<int64_t>(p / n) * n;
      const int64_t* nb = idx + static_cast<int64_t>(p) * idx_stride;
      float acc[3] = {0.f, 0.f, 0.f};
      for (int s = 0; s < k; ++s) {
        const float w = expf(lg[s * kLd] - mx) / sum;
        const float* zq = z + (base + nb[s]) * 3;
        for (int ch = 0; ch < 3; ++ch) acc[ch] = fmaf(zq[ch], w, acc[ch]);
      }
      for (int ch = 0; ch < 3; ++ch)
        out[(static_cast<size_t>(p) * 3 + ch) * r + j] = acc[ch];
    }
  }
}

}  // namespace
}  // namespace puflow

// xyz [n_points, 3] (patches of n points), idx [n_points, >= k] int64
// (row stride idx_stride) -> mode 0: logits [n_points, k, 32]; 1: weights
// [n_points, k, r]; 2: latents [n_points, 3, r] from z [n_points, 3].
// offsets: 2 * kLayers host ints, the float offsets of each layer's
// weight matrix, then of each bias, into `weights`.
extern "C" int puflow_interp_head(const void* xyz, const void* idx,
                                  int idx_stride, int n_points, int n, int k,
                                  const void* weights, const void* offsets,
                                  int mode, int r, const void* z, void* out,
                                  void* stream) {
  using namespace puflow;
  if (k < 1 || k > kRows || n < 1 || n_points % n != 0 || mode < 0 ||
      mode > 2 || r < 1 || r > kLogits || (mode == 2 && z == nullptr))
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  const float* w = static_cast<const float*>(weights);
  const int* off = static_cast<const int*>(offsets);
  Head head;
  for (int l = 0; l < kLayers; ++l) {
    head.w[l] = w + off[l];
    head.b[l] = w + off[kLayers + l];
  }
  const size_t smem = sizeof(float) * (kRows * kLd + kWbuf);
  cudaError_t err = cudaFuncSetAttribute(
      interp_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int ppt = kRows / k;
  const int grid = (n_points + ppt - 1) / ppt;
  interp_head_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int64_t*>(idx),
      idx_stride, n, k, n_points, head, mode, r, static_cast<const float*>(z),
      static_cast<float*>(out));
  return cudaGetLastError();
}
