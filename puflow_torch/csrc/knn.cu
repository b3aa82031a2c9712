// Self k-nearest neighbours of every point within its own patch.
//
// Replaces the TPU kernel `knn_self_pallas` (puflow_tpu/ops/pallas/
// knn_pallas.py, `_knn_kernel`): per patch, the k nearest points of each
// point, ascending, first index on ties, so slot 0 is the point itself.
// Distances are the delta form (dx*dx + dy*dy) + dz*dz in that order, with
// _rn intrinsics so nvcc cannot contract them into FMAs; the plain version
// `knn_self_plain` (puflow_torch/ops/knn.py) computes the same tensor and
// takes a stable sort, and both return the same indices.
//
// What bounds it on the H100: issue rate. A patch of n points costs n^2
// distances (5 flops each) and as many compares against the current k-th
// distance; the inputs (12 n bytes) and outputs (8 n k bytes) are small.
// At 1024 patches of 256 points that is 67 M distances.
//
// Design: one block per patch; the patch's points sit in shared memory
// (12 n bytes), one thread per query walks the candidates in index order
// (every thread reads the same candidate: a broadcast) and keeps a sorted
// top-kMaxK list in registers. A candidate enters only if it is strictly
// nearer than the current last entry, and the unrolled insertion orders
// by (distance, index), which gives ascending order with first-occurrence
// ties. The TPU kernel's transposed layout and k min-sweeps were for the
// VPU's sublane reductions and are not carried over.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
knn_self_kernel(const float* __restrict__ xyz, int n, int k,
                int64_t* __restrict__ out) {
  extern __shared__ float pts[];  // [n][3]
  const float* src = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  for (int i = threadIdx.x; i < n * 3; i += kThreads) pts[i] = src[i];
  __syncthreads();

  for (int qi = threadIdx.x; qi < n; qi += kThreads) {
    const float qx = pts[3 * qi];
    const float qy = pts[3 * qi + 1];
    const float qz = pts[3 * qi + 2];
    float bd[kMaxK];
    int bi[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      bd[j] = INFINITY;
      bi[j] = INT_MAX;
    }
    for (int c = 0; c < n; ++c) {
      const float dx = __fsub_rn(pts[3 * c], qx);
      const float dy = __fsub_rn(pts[3 * c + 1], qy);
      const float dz = __fsub_rn(pts[3 * c + 2], qz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < bd[kMaxK - 1]) {
        // insert (d, c); entries it passes move down one place
        float cd = d;
        int ci = c;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          if (cd < bd[j] || (cd == bd[j] && ci < bi[j])) {
            const float td = bd[j];
            const int ti = bi[j];
            bd[j] = cd;
            bi[j] = ci;
            cd = td;
            ci = ti;
          }
        }
      }
    }
    int64_t* o = out + (static_cast<size_t>(blockIdx.x) * n + qi) * k;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k) o[j] = bi[j];
  }
}

}  // namespace

// xyz [batch, n, 3] f32 -> out [batch, n, k] int64, 1 <= k <= min(16, n).
extern "C" int puflow_knn_self(const void* xyz, int batch, int n, int k,
                               void* out, void* stream) {
  if (k < 1 || k > kMaxK || k > n) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(n) * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      knn_self_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  knn_self_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, k, static_cast<int64_t*>(out));
  return cudaGetLastError();
}
