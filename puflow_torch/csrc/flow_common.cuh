// Shared pieces of the flow kernels. Both flow_f.cu and flow_g.cu take
// their per-block arguments through FlowArgs / fill_args and the
// constants below. The packed weight layout and the small dense layers on
// shared-memory tiles (CUDA-core FMAs, bound by FP32 throughput and by
// shared-memory reads) serve flow_f.cu only: flow_g.cu has its own layout
// of B fragments and takes its products on the tensor cores (3xTF32).
//
// Weight layout of one flow block for flow_f, as `_pack_f` in
// puflow_torch/ops/flow.py writes it (floats, every matrix [in, out]):
//   head   15                 exp(logs)[3], bias[3], W[3x3]
//   coupling1.bias_net        w0[(split + cdim) x 64] (rows: h1 then c),
//                             w1[64 x 64], b1[64], w2[64 x (3 - split)],
//                             b2[3 - split]
//   coupling2.scale_net       w0[cdim x 64], w1[64 x 64], b1[64], w2[64 x 3],
//                             b2[3]
//   coupling2.bias_net        the same
// Block b uses split = 1 when b is even, else 2.
#pragma once

#include <cuda_runtime.h>

namespace puflow {

constexpr int kRows = 64;          // state rows per tile
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kHidden = 64;        // LinearA1D hidden width
constexpr int kLdH = kHidden + 1;  // padded row stride of hidden tiles
constexpr int kMaxBlocks = 8;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr float kSlope = 0.01f;    // LinearA1D LeakyReLU

struct FlowArgs {
  const float* cs[kMaxBlocks];  // block b's conditions, [rows, cdim[b]]
  int cdim[kMaxBlocks];
  int woff[kMaxBlocks + 1];     // block b's weights: [woff[b], woff[b + 1])
  int nblocks;
  int wmax;                     // floats of the largest block's weights
};

struct BlockWeights {
  const float* head;
  const float *c_w0, *c_w1, *c_b1, *c_w2, *c_b2;
  const float *s_w0, *s_w1, *s_b1, *s_w2, *s_b2;
  const float *b_w0, *b_w1, *b_b1, *b_w2, *b_b2;
};

__device__ __forceinline__ BlockWeights block_weights(const float* w,
                                                      int cdim, int split) {
  BlockWeights p;
  p.head = w;
  w += 15;
  p.c_w0 = w;
  w += (split + cdim) * kHidden;
  p.c_w1 = w;
  w += kHidden * kHidden;
  p.c_b1 = w;
  w += kHidden;
  p.c_w2 = w;
  w += kHidden * (3 - split);
  p.c_b2 = w;
  w += 3 - split;
  p.s_w0 = w;
  w += cdim * kHidden;
  p.s_w1 = w;
  w += kHidden * kHidden;
  p.s_b1 = w;
  w += kHidden;
  p.s_w2 = w;
  w += kHidden * 3;
  p.s_b2 = w;
  w += 3;
  p.b_w0 = w;
  w += cdim * kHidden;
  p.b_w1 = w;
  w += kHidden * kHidden;
  p.b_b1 = w;
  w += kHidden;
  p.b_w2 = w;
  w += kHidden * 3;
  p.b_b2 = w;
  return p;
}

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.f ? v : kSlope * v;
}

// out[r][o] = act(bias[o] + sum_k in[r][k] * W[k][o]) for r < rows, o < 64.
// `in` has row stride ldi (odd, so the two rows a warp reads sit in
// different banks); `out` has row stride kLdH. Thread (ty, tx) owns rows
// ty + 16 i (i < kRowBlocks) and columns tx + 16 j (j < 4): per k it loads
// kRowBlocks + 4 values from shared memory for 4 kRowBlocks FMAs. Rows
// >= `rows` of the last 16-row block are computed but not stored.
template <int kRowBlocks, bool kLrelu>
__device__ __forceinline__ void dense_hidden_rows(const float* in, int ldi,
                                                  int k_in, const float* W,
                                                  const float* bias,
                                                  float* out, int rows) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[kRowBlocks][4];
#pragma unroll
  for (int i = 0; i < kRowBlocks; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < k_in; ++k) {
    float a[kRowBlocks], w[4];
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i) a[i] = in[(ty + 16 * i) * ldi + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = W[k * kHidden + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRowBlocks; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = tx + 16 * j;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[o];
      out[r * kLdH + o] = kLrelu ? lrelu(v) : v;
    }
  }
}

// The dense layer for rows <= kRows, computing only the 16-row blocks
// that hold rows (the choice is uniform over the thread block).
template <bool kLrelu>
__device__ __forceinline__ void dense_hidden(const float* in, int ldi, int k_in,
                                             const float* W, const float* bias,
                                             float* out, int rows) {
  switch ((rows + 15) / 16) {
    case 1:
      dense_hidden_rows<1, kLrelu>(in, ldi, k_in, W, bias, out, rows);
      break;
    case 2:
      dense_hidden_rows<2, kLrelu>(in, ldi, k_in, W, bias, out, rows);
      break;
    case 3:
      dense_hidden_rows<3, kLrelu>(in, ldi, k_in, W, bias, out, rows);
      break;
    default:
      dense_hidden_rows<4, kLrelu>(in, ldi, k_in, W, bias, out, rows);
  }
}

// out[r][o] = bias[o] + sum_k in[r][k] * W[k][o] for r < rows, o < n_out
// (n_out <= 3): the narrow last layer of a LinearA1D. `in` has row stride
// kLdH, `out` row stride 3.
__device__ __forceinline__ void dense_out(const float* in, const float* W,
                                          const float* bias, int n_out,
                                          float* out, int rows) {
  for (int idx = threadIdx.x; idx < rows * n_out; idx += kThreads) {
    const int r = idx / n_out;
    const int o = idx - r * n_out;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < kHidden; ++k)
      acc = fmaf(in[r * kLdH + k], W[k * n_out + o], acc);
    out[r * 3 + o] = acc + bias[o];
  }
}

// Copy block b's weights from global to shared memory.
__device__ __forceinline__ void stage_weights(const float* __restrict__ weights,
                                              const FlowArgs& args, int b,
                                              float* w_s) {
  const int lo = args.woff[b];
  const int n = args.woff[b + 1] - lo;
  for (int i = threadIdx.x; i < n; i += kThreads) w_s[i] = __ldg(weights + lo + i);
}

// Host side: fill FlowArgs from the caller's arrays. Returns the largest
// condition width, or -1 if the arguments are out of range.
inline int fill_args(FlowArgs* args, const long long* c_ptrs,
                     const int* cdims, const int* woff, int nblocks) {
  if (nblocks < 1 || nblocks > kMaxBlocks) return -1;
  int cmax = 0;
  args->nblocks = nblocks;
  args->wmax = 0;
  args->woff[0] = woff[0];
  for (int b = 0; b < nblocks; ++b) {
    args->cs[b] = reinterpret_cast<const float*>(c_ptrs[b]);
    args->cdim[b] = cdims[b];
    args->woff[b + 1] = woff[b + 1];
    const int nw = woff[b + 1] - woff[b];
    if (nw > args->wmax) args->wmax = nw;
    if (cdims[b] > cmax) cmax = cdims[b];
  }
  return cmax;
}

}  // namespace puflow
