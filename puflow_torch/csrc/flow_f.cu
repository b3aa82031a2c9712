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
// What bounds it on the H100: FP32 FMAs. A row costs about 37.6k
// multiply-adds per block at cdim = 128 against 4 cdim + 24 bytes read from
// device memory, so it is compute-bound; the TPU kernel's 3-pass bf16
// split existed only to approach f32 on the MXU and is gone: everything
// here is exact f32 on the CUDA cores.
//
// Design: one thread block owns a tile of 64 rows for all blocks of the
// flow, so the 3-wide state never leaves shared memory between blocks and
// the intermediates of the MLPs ([64 x 64] tiles) never reach device
// memory. For each flow block it stages that block's weights (about 150 KB
// at cdim = 128) and the tile's conditions in shared memory; each dense
// layer is a 16 x 16 thread grid with a 4 x 4 register tile per thread.
// The shared memory (about 215 KB) allows one block per SM; the 16
// independent FMAs per k keep the pipes fed. Its products on the tensor
// cores, as flow_g.cu takes them (3xTF32), are queued in ROADMAP.md
// (Queue 2, "Ported kernels with open work").

#include "flow_common.cuh"

namespace puflow {
namespace {

// Shared-memory floats of a tile: weights, the condition tile (row stride
// ldc), two hidden tiles and three [kRows x 3] state tiles.
__host__ __device__ inline int f_smem_floats(int wmax, int ldc) {
  return wmax + kRows * ldc + 2 * kRows * kLdH + 3 * kRows * 3;
}

__global__ void __launch_bounds__(kThreads, 1)
flow_f_kernel(const float* __restrict__ x, FlowArgs args,
              const float* __restrict__ weights, float* __restrict__ z,
              int n_rows, int ldc_max) {
  extern __shared__ float smem[];
  float* w_s = smem;                        // [wmax]
  float* cin = w_s + args.wmax;             // [kRows][ldc]: h1 | c
  float* h_a = cin + kRows * ldc_max;       // [kRows][kLdH]
  float* h_b = h_a + kRows * kLdH;          // [kRows][kLdH]
  float* xs = h_b + kRows * kLdH;           // [kRows][3] flow state
  float* t0 = xs + kRows * 3;               // [kRows][3]
  float* t1 = t0 + kRows * 3;               // [kRows][3]

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n_rows - row0);

  for (int i = t; i < kRows * 3; i += kThreads)
    xs[i] = i < rows * 3 ? x[static_cast<size_t>(row0) * 3 + i] : 0.f;

  for (int b = 0; b < args.nblocks; ++b) {
    const int cdim = args.cdim[b];
    const int split = (b % 2 == 0) ? 1 : 2;
    const int ldc = (split + cdim) | 1;
    __syncthreads();  // the previous block is done with w_s and cin
    stage_weights(weights, args, b, w_s);
    const float* c = args.cs[b] + static_cast<size_t>(row0) * cdim;
    for (int i = t; i < kRows * cdim; i += kThreads) {
      const int r = i / cdim;
      cin[r * ldc + split + (i - r * cdim)] = r < rows ? c[i] : 0.f;
    }
    __syncthreads();
    const BlockWeights W = block_weights(w_s, cdim, split);

    // ActNorm (x * exp(logs) + bias), then inv1x1 (x' = W x)
    if (t < kRows) {
      float v[3], y[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        v[ch] = xs[t * 3 + ch] * W.head[ch] + W.head[3 + ch];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        y[i] = W.head[6 + 3 * i] * v[0] + W.head[7 + 3 * i] * v[1] +
               W.head[8 + 3 * i] * v[2];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) xs[t * 3 + ch] = y[ch];
      for (int s = 0; s < split; ++s) cin[t * ldc + s] = y[s];
    }
    __syncthreads();

    // additive coupling: h2 -= MLP([h1, c])
    dense_hidden<true>(cin, ldc, split + cdim, W.c_w0, nullptr, h_a, kRows);
    __syncthreads();
    dense_hidden<true>(h_a, kLdH, kHidden, W.c_w1, W.c_b1, h_b, kRows);
    __syncthreads();
    dense_out(h_b, W.c_w2, W.c_b2, 3 - split, t0, kRows);
    __syncthreads();
    if (t < kRows) {
      for (int o = 0; o < 3 - split; ++o) xs[t * 3 + split + o] -= t0[t * 3 + o];
      // reverse channel permutation (2, 1, 0)
      const float x0 = xs[t * 3];
      xs[t * 3] = xs[t * 3 + 2];
      xs[t * 3 + 2] = x0;
    }

    // affine injector: scale and bias nets read only the condition
    const float* cond = cin + split;
    dense_hidden<true>(cond, ldc, cdim, W.s_w0, nullptr, h_a, kRows);
    __syncthreads();
    dense_hidden<true>(h_a, kLdH, kHidden, W.s_w1, W.s_b1, h_b, kRows);
    __syncthreads();
    dense_out(h_b, W.s_w2, W.s_b2, 3, t0, kRows);
    __syncthreads();
    dense_hidden<true>(cond, ldc, cdim, W.b_w0, nullptr, h_a, kRows);
    __syncthreads();
    dense_hidden<true>(h_a, kLdH, kHidden, W.b_w1, W.b_b1, h_b, kRows);
    __syncthreads();
    dense_out(h_b, W.b_w2, W.b_b2, 3, t1, kRows);
    __syncthreads();
    if (t < kRows) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        xs[t * 3 + ch] = (xs[t * 3 + ch] - t1[t * 3 + ch]) * expf(-t0[t * 3 + ch]);
    }
  }
  __syncthreads();
  for (int i = t; i < rows * 3; i += kThreads)
    z[static_cast<size_t>(row0) * 3 + i] = xs[i];
}

}  // namespace
}  // namespace puflow

// x [n_rows, 3] -> z [n_rows, 3]. c_ptrs / cdims / woff are host arrays
// of nblocks, nblocks and nblocks + 1 entries.
extern "C" int puflow_flow_f(const void* x, const void* weights,
                             const void* c_ptrs, const void* cdims,
                             const void* woff, int nblocks, int n_rows,
                             void* z, void* stream) {
  using namespace puflow;
  FlowArgs args;
  const int cmax = fill_args(&args, static_cast<const long long*>(c_ptrs),
                             static_cast<const int*>(cdims),
                             static_cast<const int*>(woff), nblocks);
  if (cmax < 0) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const int ldc_max = (2 + cmax) | 1;
  const size_t smem = sizeof(float) * f_smem_floats(args.wmax, ldc_max);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flow_f_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (n_rows + kRows - 1) / kRows;
  flow_f_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), args, static_cast<const float*>(weights),
      static_cast<float*>(z), n_rows, ldc_max);
  return cudaGetLastError();
}
