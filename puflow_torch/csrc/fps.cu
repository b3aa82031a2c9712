// Farthest point sampling, one thread block per cloud.
//
// Replaces the TPU kernel `farthest_point_sample_pallas`
// (puflow_tpu/ops/pallas/fps_pallas.py, `_fps_kernel`): greedy FPS that
// starts at index 0, with delta-form distances (p - c)^2 and the first
// index on ties. Plain version: `farthest_point_sample_plain` in
// puflow_torch/ops/fps.py; both return the same indices.
//
// What bounds it on the H100: the m - 1 selection steps are sequential and
// each ends in a block-wide argmax, so a step costs one pass over the
// cloud plus two barriers, all on one SM. The cloud (N x 12 bytes, 418 KB
// at the merge's N = 34816) is read from global memory every step and
// stays in L2; the min-distance cache (4 N bytes) lives in shared memory,
// so the only traffic that scales with N x m is L2 reads of the
// coordinates. At the merge a step takes about 5.6 us on an H100: one
// SM's instruction throughput (about 580 instructions in each of 1024
// threads) and its L2 reads (about 75 GB/s) bound it.
//
// Design: 1024 threads stride over the cloud; each keeps its running
// (max, lowest index) and the block reduces them with warp shuffles and
// one shared-memory round. All m steps run inside one launch, as on the
// TPU. The distance is computed with the _rn intrinsics in the order
// (dx*dx + dy*dy) + dz*dz, so nvcc cannot contract it into FMAs and the
// indices match the plain PyTorch version bit for bit. Clouds whose cache
// does not fit in shared memory keep it in a global scratch buffer that
// the caller allocates.
//
// One block per cloud: the merge at B = 32 runs on 32 of the 132 SMs.
// Spreading one cloud over a cluster of blocks is later work.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// (v, i) beats (bv, bi): larger value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Fold point i into the min-distance cache and the thread's running best.
// (dx*dx + dy*dy) + dz*dz with _rn intrinsics: no FMA contraction, the
// plain version's rounding.
__device__ __forceinline__ void update(float x, float y, float z, float cx,
                                       float cy, float cz, int i, float* mind,
                                       float& best_v, int& best_i) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  const float md = fminf(mind[i], d);
  mind[i] = md;
  if (md > best_v) {
    best_v = md;
    best_i = i;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int m, int* __restrict__ out,
           float* __restrict__ mind_global) {
  extern __shared__ float mind_shared[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* mind = mind_global != nullptr
                    ? mind_global + static_cast<size_t>(blockIdx.x) * n
                    : mind_shared;
  int* sel = out + static_cast<size_t>(blockIdx.x) * m;

  for (int i = tid; i < n; i += kThreads) mind[i] = INFINITY;
  if (tid == 0) sel[0] = 0;
  int last = 0;
  __syncthreads();

  for (int step = 1; step < m; ++step) {
    const float cx = __ldg(pts + 3 * last);
    const float cy = __ldg(pts + 3 * last + 1);
    const float cz = __ldg(pts + 3 * last + 2);
    float best_v = -INFINITY;
    int best_i = INT_MAX;
    // ascending i per thread, so strict '>' keeps the first index on ties;
    // kUnroll points at a time keeps several loads of a thread in flight
    int i = tid;
    for (; i + (kUnroll - 1) * kThreads < n; i += kUnroll * kThreads) {
      float px[kUnroll], py[kUnroll], pz[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* p = pts + 3 * (i + u * kThreads);
        px[u] = __ldg(p);
        py[u] = __ldg(p + 1);
        pz[u] = __ldg(p + 2);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        update(px[u], py[u], pz[u], cx, cy, cz, i + u * kThreads, mind,
               best_v, best_i);
    }
    for (; i < n; i += kThreads)
      update(__ldg(pts + 3 * i), __ldg(pts + 3 * i + 1), __ldg(pts + 3 * i + 2),
             cx, cy, cz, i, mind, best_v, best_i);
    warp_argmax(best_v, best_i);
    if (lane == 0) {
      red_v[warp] = best_v;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = red_v[lane];
      best_i = red_i[lane];
      warp_argmax(best_v, best_i);
      if (lane == 0) {
        s_last = best_i;
        sel[step] = best_i;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

extern "C" const char* puflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xyz [B, n, 3] f32 -> out [B, m] i32. `mind_scratch` is [B, n] f32 in
// global memory, or null to keep the cache in shared memory (n * 4 bytes).
extern "C" int puflow_fps(const void* xyz, int batch, int n, int m, void* out,
                          void* mind_scratch, void* stream) {
  const size_t smem =
      mind_scratch != nullptr ? 0 : static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, m, static_cast<int*>(out),
      static_cast<float*>(mind_scratch));
  return cudaGetLastError();
}
