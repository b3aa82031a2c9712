// Shared pieces of the flow kernels, flow_f.cu (forward) and flow_g.cu
// (inverse): their arguments (FlowArgs / fill_args / check_blocks), the
// layout of a flow block's weights, the staging of a block in shared
// memory, the first layers read straight from the conditions, the MLP
// tails on the tensor cores (3xTF32, mma_tf32.cuh) and the persistent
// grid's size. Both take a block's weights as `_pack` in
// puflow_torch/ops/flow.py writes them, and both walk the flow blocks
// in a persistent grid of a thread block an SM, a warp a tile of 16 rows.
#pragma once

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace puflow {

constexpr int kHidden = 64;        // LinearA1D hidden width
constexpr int kMaxBlocks = 8;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr float kSlope = 0.01f;    // LinearA1D LeakyReLU
constexpr int kTile = 16;          // rows of a warp's tile (m16)
constexpr int kHt = kHidden / 8;   // n8 tiles of a hidden layer
using HidFrag = float4;            // a 64 x 64 layer's pre-split pair

struct FlowArgs {
  const float* cs[kMaxBlocks];  // block b's conditions, [rows, cdim[b]]
  int cdim[kMaxBlocks];
  int woff[kMaxBlocks + 1];     // block b's weights: [woff[b], woff[b + 1])
  int nblocks;
  int wmax;                     // floats of the largest block's weights
};

// Layout of one flow block's weights (floats): a head of 16 (forward:
// exp(logs)[3], the ActNorm bias[3], W[9], 0; inverse: bias[3],
// exp(-logs)[3], W^-1[9], 0); c_w0's h1 rows [2][64] (row 1 zero at
// split 1); the biases c_b1, s_b1, b_b1 [64]; c_b2, s_b2, b_b2 [8] (zero
// past the net's outputs); then B fragments (32 lanes each, k chunk
// major): the first layers s_w0, b_w0 and c_w0's condition rows [8 kt x
// 64] and the 64 -> 3 layers s_w2, b_w2, c_w2 [64 x 8] as f32 pairs, the
// hidden layers s_w1, b_w1, c_w1 [64 x 64] as HidFrag. kt k chunks cover
// the condition (zero rows past cdim). Block b uses split = 1 when b is
// even, else 2.
constexpr int kW0h = 16, kCB1 = 144, kSB1 = 208, kBB1 = 272, kCB2 = 336,
              kSB2 = 344, kBB2 = 352, kFrags = 360;
constexpr int kPair = 64;                         // floats of an f32 fragment
constexpr int kHidFloats = 8 * sizeof(HidFrag);   // ... of a hidden one

__host__ __device__ constexpr int kt_of(int cdim) {
  return cdim <= 32 ? 4 : cdim <= 64 ? 8 : 16;
}

__host__ __device__ constexpr int block_floats(int kt) {
  return kFrags + kPair * 3 * (8 * kt + kHt) + kHidFloats * 3 * kHt * kHt;
}

struct FlowBlock {
  const float* head;
  const float* w0h;
  const float *c_b1, *s_b1, *b_b1, *c_b2, *s_b2, *b_b2;
  const float2 *s_w0, *b_w0, *c_w0, *s_w2, *b_w2, *c_w2;
  const HidFrag *s_w1, *b_w1, *c_w1;
};

// Block pointers into shared memory w; fragment pointers offset by the
// lane, except the 64 -> 3 layers' (narrow_out offsets them itself).
__device__ __forceinline__ FlowBlock flow_block(const float* w, int kt,
                                                int lane) {
  FlowBlock p;
  p.head = w;
  p.w0h = w + kW0h;
  p.c_b1 = w + kCB1;
  p.s_b1 = w + kSB1;
  p.b_b1 = w + kBB1;
  p.c_b2 = w + kCB2;
  p.s_b2 = w + kSB2;
  p.b_b2 = w + kBB2;
  const float2* f = reinterpret_cast<const float2*>(w + kFrags);
  p.s_w0 = f + lane;
  p.b_w0 = p.s_w0 + 32 * 8 * kt;
  p.c_w0 = p.b_w0 + 32 * 8 * kt;
  p.s_w2 = f + 3 * 32 * 8 * kt;
  p.b_w2 = p.s_w2 + 32 * kHt;
  p.c_w2 = p.b_w2 + 32 * kHt;
  const HidFrag* h = reinterpret_cast<const HidFrag*>(p.c_w2 + 32 * kHt);
  p.s_w1 = h + lane;
  p.b_w1 = p.s_w1 + 32 * kHt * kHt;
  p.c_w1 = p.b_w1 + 32 * kHt * kHt;
  return p;
}

// Copy block b's weights from global to shared memory, kThreads threads.
template <int kThreads>
__device__ __forceinline__ void stage_block(const float* __restrict__ weights,
                                            const FlowArgs& args, int b,
                                            float4* wsm) {
  const float4* src = reinterpret_cast<const float4*>(weights + args.woff[b]);
  const int n4 = (args.woff[b + 1] - args.woff[b]) / 4;
  for (int i = threadIdx.x; i < n4; i += kThreads) wsm[i] = __ldg(src + i);
}

// A thread block's share [tile0, tile1) of n_rows' 16-row tiles, the same
// for every flow block: a warp reads back only rows it wrote.
__device__ __forceinline__ void tile_share(int n_rows, int& tile0,
                                           int& tile1) {
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  tile0 = static_cast<int>(static_cast<int64_t>(n_tiles) * blockIdx.x /
                           gridDim.x);
  tile1 = static_cast<int>(static_cast<int64_t>(n_tiles) *
                           (blockIdx.x + 1) / gridDim.x);
}

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.f ? v : kSlope * v;
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// acc[j] = c W0_j for NW first layers on the tile's condition rows c0
// (row g) and c1 (row g + 8): A fragments loaded chunk by chunk and split
// once for the NW layers, zero past column cdim (even: a lane reads its
// two columns in one 8-byte load). kBatch n8 tiles of a layer take their
// three products in turn (tf32::mma_3x_tiles).
template <int KT, int NW, int kBatch = 1>
__device__ __forceinline__ void first_layers(float (&acc)[NW][kHt][4],
                                             const float* __restrict__ c0,
                                             const float* __restrict__ c1,
                                             int cdim, int t2,
                                             const float2* const (&w0)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) zero(acc[j]);
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    const int col = 8 * kc + t2;
    const float2 zero2 = make_float2(0.f, 0.f);
    const float2 u =
        col < cdim ? __ldg(reinterpret_cast<const float2*>(c0 + col)) : zero2;
    const float2 v =
        col < cdim ? __ldg(reinterpret_cast<const float2*>(c1 + col)) : zero2;
    const float a[4] = {u.x, u.y, v.x, v.y};
    const tf32::ASplit as = tf32::a_split(a);
#pragma unroll
    for (int j = 0; j < NW; ++j)
      tf32::mma_3x_tiles<kHt, float2, kBatch>(acc[j], as,
                                              w0[j] + kc * kHt * 32);
  }
}

// h = lrelu(h + bias) over a hidden layer's C fragments (bias nullptr:
// none), bias offset by the lane's columns 2t.
__device__ __forceinline__ void bias_lrelu(float (&h)[kHt][4],
                                           const float* bias) {
#pragma unroll
  for (int nt = 0; nt < kHt; ++nt) {
    const float2 b = bias ? lds2(bias + 8 * nt) : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[nt][i] = lrelu(h[nt][i] + (i % 2 ? b.y : b.x));
  }
}

// The 64 -> 3 layer of a tile: v[h][o] = (x W2 + b2)[row g + 8 h][o] for
// o < 3, in every lane of group g. An n8 tile whose columns past the
// net's outputs are zero; columns 0, 1 sit in lane 4 g, column 2 in lane
// 4 g + 1.
__device__ __forceinline__ void narrow_out(const float (&x)[kHt][4],
                                           const float2* w2, const float* b2,
                                           int lane, float (&v)[2][3]) {
  float acc[1][4];
  zero(acc);
  tf32::mma_3x_any<kHt>(acc, x, w2 + lane, 1);
  const int l0 = lane & ~3;
  constexpr unsigned kAll = 0xffffffffu;
  v[0][0] = __shfl_sync(kAll, acc[0][0], l0) + b2[0];
  v[0][1] = __shfl_sync(kAll, acc[0][1], l0) + b2[1];
  v[0][2] = __shfl_sync(kAll, acc[0][0], l0 + 1) + b2[2];
  v[1][0] = __shfl_sync(kAll, acc[0][2], l0) + b2[0];
  v[1][1] = __shfl_sync(kAll, acc[0][3], l0) + b2[1];
  v[1][2] = __shfl_sync(kAll, acc[0][2], l0 + 1) + b2[2];
}

// Layers 1 and 2 of a LinearA1D from its lrelu'd first layer h.
template <int kBatch = 1, class Frag>
__device__ __forceinline__ void mlp_tail(const float (&h)[kHt][4],
                                         const Frag* w1, const float* b1,
                                         const float2* w2, const float* b2,
                                         int lane, float (&v)[2][3]) {
  float acc[kHt][4];
  zero(acc);
  tf32::mma_3x_any<kHt, kHt, kHt, Frag, kBatch>(acc, h, w1, kHt);
  bias_lrelu(acc, b1 + 2 * (lane % 4));
  narrow_out(acc, w2, b2, lane, v);
}

// The coupling's first layer of a tile, h = lrelu(hc + [h1] W0h), from the
// condition's projection hc (C fragments) and the h1 columns y[i][0 ..
// split) of rows g + 8 i, as f32 FMAs.
__device__ __forceinline__ void coupling_first(float (&h)[kHt][4],
                                               const float (&hc)[kHt][4],
                                               const float* w0h,
                                               const float (&y)[2][3],
                                               int split, int t2) {
#pragma unroll
  for (int nt = 0; nt < kHt; ++nt) {
    const float2 w = lds2(w0h + 8 * nt + t2);
    h[nt][0] = fmaf(y[0][0], w.x, hc[nt][0]);
    h[nt][1] = fmaf(y[0][0], w.y, hc[nt][1]);
    h[nt][2] = fmaf(y[1][0], w.x, hc[nt][2]);
    h[nt][3] = fmaf(y[1][0], w.y, hc[nt][3]);
    if (split == 2) {
      const float2 u = lds2(w0h + kHidden + 8 * nt + t2);
      h[nt][0] = fmaf(y[0][1], u.x, h[nt][0]);
      h[nt][1] = fmaf(y[0][1], u.y, h[nt][1]);
      h[nt][2] = fmaf(y[1][1], u.x, h[nt][2]);
      h[nt][3] = fmaf(y[1][1], u.y, h[nt][3]);
    }
  }
  bias_lrelu(h, nullptr);
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

// Host side: FlowArgs from the caller's arrays, checked against what the
// kernels take: conditions of even width <= 128, 8-byte aligned (a lane
// reads two columns at once), weights 16-byte aligned, each block of
// block_floats floats.
inline cudaError_t check_blocks(FlowArgs* args, const void* weights,
                                const void* c_ptrs, const void* cdims,
                                const void* woff, int nblocks) {
  const int cmax = fill_args(args, static_cast<const long long*>(c_ptrs),
                             static_cast<const int*>(cdims),
                             static_cast<const int*>(woff), nblocks);
  if (cmax < 0 || cmax > 8 * kt_of(128) ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0)
    return cudaErrorInvalidValue;
  for (int b = 0; b < nblocks; ++b)
    if (args->cdim[b] < 1 || args->cdim[b] % 2 != 0 ||
        reinterpret_cast<uintptr_t>(args->cs[b]) % 8 != 0 ||
        args->woff[b] % 4 != 0 ||
        args->woff[b + 1] - args->woff[b] !=
            block_floats(kt_of(args->cdim[b])))
      return cudaErrorInvalidValue;
  if (sizeof(float) * args->wmax > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Host side: a persistent grid for `kernel` (threads a block, smem bytes
// of dynamic shared memory): as many blocks as the card holds at once, at
// most one a tile.
template <class Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                                   int tiles, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = std::min(sms * per_sm, tiles);
  return cudaSuccess;
}

}  // namespace puflow
