// Forward flow f (points -> latents), all flow blocks in one launch.
//
// Replaces the TPU kernel `flow_f_pallas` (puflow_tpu/ops/pallas/
// flow_pallas.py, `_flow_f_kernel`). Per block: ActNorm -> inv1x1 (9
// multiply-adds) -> additive coupling h2 -= MLP([h1, c]) with the MLP
// (split + cdim) -> 64 -> 64 -> 3 - split -> reverse channels -> affine
// injector x = (x - MLP_b(c)) * exp(-MLP_s(c)) with both MLPs
// cdim -> 64 -> 64 -> 3. No log-determinant: inference discards it.
// Plain version: `flow_f_plain` in puflow_torch/ops/flow.py.
//
// What bounds it on the H100: its products. A row costs about 32k
// multiply-adds per block at cdim = 128 against 4 cdim + 24 bytes read
// from device memory. The kernel computes the exact f32 function (the TPU
// kernel's 3-pass bf16 split) as 3xTF32 products on the tensor cores
// (mma_tf32.cuh): three TF32 products for each f32 one, so the least time
// is 3 x 2 x the multiply-adds at the dense TF32 rate
// (chip_smoke.py:flow_macs). The 3-wide steps (ActNorm, inv1x1, the h1
// columns of the coupling's first layer, the subtraction, the injector's
// (x - b) * exp(-s)) stay f32 FMAs.
//
// Design (flow_g.cu's, flow_common.cuh): a persistent grid of one block an
// SM walks the flow blocks in forward order; for each it stages the
// block's weights in shared memory once (204 KB at cdim = 128), and its
// warps then walk the thread block's fixed share of 16-row tiles, the same
// in every flow block, so no grid barrier is needed: the rows' 3-wide
// state stays in z between flow blocks (12 bytes a row, L2-resident).
// Every product is a warp's m16n8k8 `mma.sync` on a tile of 16 rows, each
// row its own point:
//   the three first layers (s_w0, b_w0 and c_w0's condition rows) read the
//     tile's condition rows straight from device memory as A fragments in
//     one pass, each chunk loaded and split once for all three;
//   each 64-wide output stays in its C fragments and is the next layer's A
//     operand (the host orders each k8 chunk's weight rows 0 2 4 6 1 3 5 7,
//     mma_tf32.cuh); the 64 -> 3 layers are an n8 tile with zero columns;
//   each k8 chunk's products go over kBatch n8 tiles in turn, so that a
//     tile's three dependent products stand apart;
//   the injector's two nets run first (their scale and bias, 12 floats,
//     stay in registers), then the state's ActNorm and inv1x1, the
//     coupling (the projection's C fragments plus the h1 columns in f32,
//     then its tail) and the injector's update.
// The 64 x 64 layers' fragments are pre-split on the host, the others
// split into tf32 hi / lo as they are read (`_pack` in ops/flow.py, the
// layout flow g reads); tf32 rounding by integer operations
// (`tf32::round_bits`). Reruns are bit-equal: one fixed order, no atomics.
// Measured on an H100 at 256 patches (scripts/flow_f_variants.py,
// PERF.md): 0.525 ms a call, 3.4x its 3xTF32 bound, where the CUDA-core
// kernel before it took 1.56 ms. Against the kept design, flow g's split
// (the coupling's projection in a second pass over the conditions) took
// 12% longer, one tile's three products in a row 2.5%, 8 tiles
// interleaved 0-3%; 8 warps an SM (229 registers, no spills) and the
// injector's tails after the coupling's were within 1%, 16 warps (128
// registers, 2.8 KB spilled) 60% slower. hi*hi alone takes half the
// time: the products set the pace.

#include "flow_common.cuh"

namespace puflow {
namespace {

constexpr int kFThreads = 384;     // 12 warps an SM
constexpr int kFWarps = kFThreads / 32;
constexpr int kBatch = 4;          // n8 tiles whose products interleave

// One flow block on the tile of 16 rows from row0: the state from src
// (the points for the first block, else z), the result into z; KT k
// chunks cover the condition. Rows past n_rows compute on the last row's
// condition and store nothing; lane t < 3 stores channel t.
template <int KT>
__device__ __forceinline__ void f_tile(const FlowBlock& W,
                                       const float* __restrict__ c, int cdim,
                                       int split, int row0, int n_rows,
                                       const float* src, float* z, int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
  const int t2 = 2 * t;
  const int rows[2] = {row0 + g, row0 + g + 8};
  const bool ok[2] = {rows[0] < n_rows, rows[1] < n_rows};
  const float* c0 = c + static_cast<size_t>(min(rows[0], n_rows - 1)) * cdim;
  const float* c1 = c + static_cast<size_t>(min(rows[1], n_rows - 1)) * cdim;

  // the three first layers in one pass over the condition
  float h[3][kHt][4];
  const float2* w0[3] = {W.s_w0, W.b_w0, W.c_w0};
  first_layers<KT, 3, kBatch>(h, c0, c1, cdim, t2, w0);

  // the injector's scale and bias
  float sc[2][3], bi[2][3];
  bias_lrelu(h[0], nullptr);
  mlp_tail<kBatch>(h[0], W.s_w1, W.s_b1, W.s_w2, W.s_b2, lane, sc);
  bias_lrelu(h[1], nullptr);
  mlp_tail<kBatch>(h[1], W.b_w1, W.b_b1, W.b_w2, W.b_b2, lane, bi);

  // ActNorm (x * exp(logs) + bias), then inv1x1 (y = W x)
  float y[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      v[ch] = fmaf(ok[i] ? src[static_cast<size_t>(rows[i]) * 3 + ch] : 0.f,
                   W.head[ch], W.head[3 + ch]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      y[i][ch] = W.head[6 + 3 * ch] * v[0] + W.head[7 + 3 * ch] * v[1] +
                 W.head[8 + 3 * ch] * v[2];
  }

  // additive coupling: h2 -= MLP([h1, c])
  float hk[kHt][4];
  coupling_first(hk, h[2], W.w0h, y, split, t2);
  float sub[2][3];
  mlp_tail<kBatch>(hk, W.c_w1, W.c_b1, W.c_w2, W.c_b2, lane, sub);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (split == 1) {
      y[i][1] -= sub[i][0];
      y[i][2] -= sub[i][1];
    } else {
      y[i][2] -= sub[i][0];
    }
    // reverse the channels, then the injector
    float o[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      o[ch] = (y[i][2 - ch] - bi[i][ch]) * expf(-sc[i][ch]);
    if (ok[i] && t < 3)
      z[static_cast<size_t>(rows[i]) * 3 + t] =
          t == 0 ? o[0] : t == 1 ? o[1] : o[2];
  }
}

__global__ void __launch_bounds__(kFThreads, 1)
flow_f_kernel(const float* __restrict__ x, FlowArgs args,
              const float* __restrict__ weights, float* z, int n_rows) {
  extern __shared__ float4 wsm[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int tile0, tile1;
  tile_share(n_rows, tile0, tile1);
  for (int b = 0; b < args.nblocks; ++b) {
    __syncthreads();   // every warp is done with the last block's weights
    stage_block<kFThreads>(weights, args, b, wsm);
    __syncthreads();
    const int cdim = args.cdim[b];
    const int kt = kt_of(cdim);
    const int split = (b % 2 == 0) ? 1 : 2;
    const FlowBlock W =
        flow_block(reinterpret_cast<const float*>(wsm), kt, lane);
    const float* src = b == 0 ? x : z;
    for (int tile = tile0 + warp; tile < tile1; tile += kFWarps) {
      const int row0 = tile * kTile;
      if (kt == 4)
        f_tile<4>(W, args.cs[b], cdim, split, row0, n_rows, src, z, lane);
      else if (kt == 8)
        f_tile<8>(W, args.cs[b], cdim, split, row0, n_rows, src, z, lane);
      else
        f_tile<16>(W, args.cs[b], cdim, split, row0, n_rows, src, z, lane);
    }
  }
}

}  // namespace
}  // namespace puflow

// x [n_rows, 3] -> z [n_rows, 3]. c_ptrs / cdims / woff are host arrays
// of nblocks, nblocks and nblocks + 1 entries; the conditions are
// [n_rows, cdim], cdim even and <= 128, 8-byte aligned; the weights
// (16-byte aligned) are `_pack`'s, forward.
extern "C" int puflow_flow_f(const void* x, const void* weights,
                             const void* c_ptrs, const void* cdims,
                             const void* woff, int nblocks, int n_rows,
                             void* z, void* stream) {
  using namespace puflow;
  FlowArgs args;
  cudaError_t err = check_blocks(&args, weights, c_ptrs, cdims, woff, nblocks);
  if (err != cudaSuccess) return err;
  if (n_rows == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * args.wmax;
  int grid = 0;
  err = persistent_grid(flow_f_kernel, kFThreads, smem,
                        (n_rows + kTile - 1) / kTile, &grid);
  if (err != cudaSuccess) return err;
  flow_f_kernel<<<grid, kFThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), args, static_cast<const float*>(weights),
      static_cast<float*>(z), n_rows);
  return cudaGetLastError();
}
