// Farthest point sampling, one thread block per cloud: plain and seeded.
//
// `puflow_fps` replaces the TPU kernel `farthest_point_sample_pallas`
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
//
// `puflow_fps_seeded` replaces `farthest_point_sample_seeded_pallas`
// (fps_pallas.py: `_seed_mind_kernel`, then `_fps_seeded_kernel`): FPS over
// candidates whose cache starts at each candidate's squared distance to
// its nearest seed; every step takes the argmax first, then applies the
// pick's update. Plain version: `farthest_point_sample_seeded_plain`. Two
// kernels, both launched by the one entry point:
//   1. seed_mind_kernel, a grid over (candidate chunk, row): R x M x S
//      independent distances (67 M a cloud on the merge), FP32 CUDA-core
//      work. Seeds stream through shared memory in tiles of float4; each
//      thread keeps kSeedPer candidates in registers, so a seed read from
//      shared memory serves kSeedPer distances. The TPU kernel takes the
//      expanded form |p|^2 - 2 p.s + |s|^2 on its matrix unit; here the
//      delta form with _rn intrinsics, as in the selection, so the indices
//      equal the plain version's on any float input.
//   2. fps_seeded_kernel, a block a row as in fps_kernel: one pass copies
//      the seeded cache into shared memory (rows above _FPS_SMEM_POINTS
//      work on it in place in global memory) and takes its argmax, then
//      each further step updates with the last pick and takes the argmax.
// Row r is seeded by seed set r / groups: the grouped merges' G rows of a
// cloud share one seed set without a G-fold copy.

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

// Block-wide argmax of every thread's (v, i); needs kThreads == 1024 (32
// warps, one reduction round in warp 0). Returns the winner to every
// thread.
__device__ __forceinline__ int block_argmax(float v, int i, float* red_v,
                                            int* red_i, int* s_pick) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = red_v[lane];
    i = red_i[lane];
    warp_argmax(v, i);
    if (lane == 0) *s_pick = i;
  }
  __syncthreads();
  return *s_pick;
}

// One selection step's pass over the cloud: fold the pick (cx, cy, cz)
// into the cache and return the thread's running best through best_v /
// best_i. Ascending i per thread, so strict '>' keeps the first index on
// ties; kUnroll points at a time keep several loads of a thread in flight.
__device__ __forceinline__ void update_pass(const float* __restrict__ pts,
                                            int n, float cx, float cy,
                                            float cz, float* mind,
                                            float& best_v, int& best_i) {
  int i = threadIdx.x;
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
      update(px[u], py[u], pz[u], cx, cy, cz, i + u * kThreads, mind, best_v,
             best_i);
  }
  for (; i < n; i += kThreads)
    update(__ldg(pts + 3 * i), __ldg(pts + 3 * i + 1), __ldg(pts + 3 * i + 2),
           cx, cy, cz, i, mind, best_v, best_i);
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int m, int* __restrict__ out,
           float* __restrict__ mind_global) {
  extern __shared__ float mind_shared[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_pick;

  const int tid = threadIdx.x;
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
    float best_v = -INFINITY;
    int best_i = INT_MAX;
    update_pass(pts, n, __ldg(pts + 3 * last), __ldg(pts + 3 * last + 1),
                __ldg(pts + 3 * last + 2), mind, best_v, best_i);
    last = block_argmax(best_v, best_i, red_v, red_i, &s_pick);
    if (tid == 0) sel[step] = last;
  }
}

constexpr int kSeedThreads = 128;
constexpr int kSeedPer = 4;                       // candidates a thread
constexpr int kSeedChunk = kSeedThreads * kSeedPer;
constexpr int kSeedTile = 1024;                   // seeds a shared tile

// mind[row, i] = min over the row's seeds s of |p_i - s|^2, delta form.
__global__ void __launch_bounds__(kSeedThreads)
seed_mind_kernel(const float* __restrict__ xyz,
                 const float* __restrict__ seeds, int n, int s, int groups,
                 float* __restrict__ mind) {
  __shared__ float4 tile[kSeedTile];
  const int row = blockIdx.y;
  const float* pts = xyz + static_cast<size_t>(row) * n * 3;
  const float* sd = seeds + static_cast<size_t>(row / groups) * s * 3;
  const int base = blockIdx.x * kSeedChunk + threadIdx.x;
  float px[kSeedPer], py[kSeedPer], pz[kSeedPer], best[kSeedPer];
#pragma unroll
  for (int u = 0; u < kSeedPer; ++u) {
    const int i = min(base + u * kSeedThreads, n - 1);   // tail: recompute
    px[u] = __ldg(pts + 3 * i);
    py[u] = __ldg(pts + 3 * i + 1);
    pz[u] = __ldg(pts + 3 * i + 2);
    best[u] = INFINITY;
  }
  for (int t0 = 0; t0 < s; t0 += kSeedTile) {
    const int cnt = min(kSeedTile, s - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kSeedThreads) {
      const float* q = sd + 3 * (t0 + j);
      tile[j] = make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), 0.f);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 q = tile[j];
#pragma unroll
      for (int u = 0; u < kSeedPer; ++u) {
        const float dx = __fsub_rn(px[u], q.x);
        const float dy = __fsub_rn(py[u], q.y);
        const float dz = __fsub_rn(pz[u], q.z);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        best[u] = fminf(best[u], d);
      }
    }
  }
  float* out = mind + static_cast<size_t>(row) * n;
#pragma unroll
  for (int u = 0; u < kSeedPer; ++u) {
    const int i = base + u * kSeedThreads;
    if (i < n) out[i] = best[u];
  }
}

// Select m candidates of a row from its seeded cache (mind_global, [R, n]).
__global__ void __launch_bounds__(kThreads)
fps_seeded_kernel(const float* __restrict__ xyz, int n, int m,
                  int* __restrict__ out, float* __restrict__ mind_global,
                  int cache_in_global) {
  extern __shared__ float mind_shared[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_pick;

  const int tid = threadIdx.x;
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* seeded = mind_global + static_cast<size_t>(blockIdx.x) * n;
  float* mind = cache_in_global ? seeded : mind_shared;
  int* sel = out + static_cast<size_t>(blockIdx.x) * m;

  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int i = tid; i < n; i += kThreads) {
    const float v = seeded[i];
    if (!cache_in_global) mind[i] = v;
    if (v > best_v) {
      best_v = v;
      best_i = i;
    }
  }
  int last = block_argmax(best_v, best_i, red_v, red_i, &s_pick);
  if (tid == 0) sel[0] = last;
  for (int step = 1; step < m; ++step) {
    best_v = -INFINITY;
    best_i = INT_MAX;
    update_pass(pts, n, __ldg(pts + 3 * last), __ldg(pts + 3 * last + 1),
                __ldg(pts + 3 * last + 2), mind, best_v, best_i);
    last = block_argmax(best_v, best_i, red_v, red_i, &s_pick);
    if (tid == 0) sel[step] = last;
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

// Seeded FPS. xyz [R, n, 3] f32, seeds [R / groups, s, 3] f32 -> out
// [R, m] i32. `mind` is [R, n] f32 scratch from the caller: the seeded
// cache, and with cache_in_global the selection's working cache too
// (otherwise it lives in n * 4 bytes of shared memory). phases: 1 seeds
// the cache, 2 selects from it, 3 both.
extern "C" int puflow_fps_seeded(const void* xyz, const void* seeds, int rows,
                                 int n, int s, int groups, int m, void* out,
                                 void* mind, int cache_in_global, int phases,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (phases & 1) {
    const dim3 grid((n + kSeedChunk - 1) / kSeedChunk, rows);
    seed_mind_kernel<<<grid, kSeedThreads, 0, st>>>(
        static_cast<const float*>(xyz), static_cast<const float*>(seeds), n,
        s, groups, static_cast<float*>(mind));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & 2) {
    const size_t smem =
        cache_in_global ? 0 : static_cast<size_t>(n) * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        fps_seeded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fps_seeded_kernel<<<rows, kThreads, smem, st>>>(
        static_cast<const float*>(xyz), n, m, static_cast<int*>(out),
        static_cast<float*>(mind), cache_in_global);
  }
  return cudaGetLastError();
}
