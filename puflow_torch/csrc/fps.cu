// Farthest point sampling: one cloud over a thread-block cluster, one
// cloud a block, and seeded.
//
// `puflow_fps` replaces the TPU kernel `farthest_point_sample_pallas`
// (puflow_tpu/ops/pallas/fps_pallas.py, `_fps_kernel`): greedy FPS that
// starts at index 0, with delta-form distances (p - c)^2 and the first
// index on ties. Plain version: `farthest_point_sample_plain` in
// puflow_torch/ops/fps.py; every kernel here returns the same indices.
// The distance is computed with the _rn intrinsics in the order
// (dx*dx + dy*dy) + dz*dz, so nvcc cannot contract it into FMAs and the
// indices match the plain PyTorch version bit for bit. The m - 1
// selection steps are sequential: each folds the last pick into the
// min-distance cache and takes the argmax of the cache. The wrapper's plan
// (`ops/fps.py:_fps_plan`) chooses one of two kernels from the shape:
//
// fps_cluster_kernel (the merge: tens of thousands of candidates, few
// clouds): a cloud is spread over a cluster of C blocks (C up to 16) on C
// SMs. Block r of the cluster owns the contiguous indices [r * chunk,
// (r + 1) * chunk), and each of its threads holds kK of them, strided by
// the block size, with their min-distance cache in registers: the cloud
// is read from device memory once, and a step touches no memory but
// shared memory and the output index. A step: fold in the last pick; warp
// argmax (two redux instructions on the cache value's bits, which order
// as the value does, then the lowest index among the maxima); one
// shared-memory round to the block's best; warp 0 pushes it (key, index
// and the coordinates, looked up in the block's copy of its points) into
// slot `rank` of every block of the cluster through distributed shared
// memory; one cluster barrier; then every warp reads the C slots from
// its own shared memory and reduces them, so every thread has the pick
// and its coordinates. The slots are double-buffered by step parity: a
// block writes slot s & 1 of the others at step s + 2 only after every
// block has arrived at the barrier of step s + 1, and so has read step s.
// Pushing costs C remote stores a block a step; pulling (every warp
// reading the C slots remotely) cost W x C remote loads, and the step
// time grew with the warps a block.
//
// What bounds it on the H100: the chain of steps. A step is local work
// (about 10 instructions a point of the block's chunk, spread over the C
// SMs) and a fixed latency: the warp and block argmax (redux, one
// __syncthreads), the DSMEM push, one cluster barrier and the reduction
// of the C slots. chip_smoke.py's sweep at the merge (NVIDIA H100 80GB
// HBM3, 700 W) fits about 0.98 us fixed plus 0.041 ns a point of the
// chunk: 1.07 us a step at C = 16, 1.34 at C = 4, against 5.7 us for one
// block a cloud. The card holds only 28-39 clusters at once (the clusters
// of a GPC share its SMs: cudaOccupancyMaxActiveClusters), and a batch
// whose clusters do not all fit runs in two waves at twice the time, so
// the plan takes the largest C of which the batch fits. The FP32 bound
// of the work (N x m x 10 operations over the card's peak, 0.34 ms for 8
// clouds at the merge) assumes all 132 SMs busy on independent work; the
// steps are a dependent chain with a cross-SM barrier each, so no design
// reaches it: the fixed latency times m - 1 (8 ms at the merge) is the
// floor of this one.
//
// fps_kernel (the seed pick, the Morton cells, and clouds whose cache does
// not fit in shared memory): one 1024-thread block a cloud. Each step
// streams the cloud from L2, keeps the min-distance cache in shared
// memory (in a global scratch buffer that the caller allocates when it
// does not fit) and ends in a block argmax with two barriers. Where the
// batch alone fills the card, or a step is mostly the argmax (N of a few
// thousand), a cluster buys nothing.
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

#include <cooperative_groups.h>
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

constexpr int kMaxCluster = 16;
constexpr unsigned kAll = 0xffffffffu;

// A block's best candidate of one step, as it pushes it to every block of
// its cluster: its cache value's key, its index, its coordinates.
struct alignas(16) Partial {
  float x, y, z;
  unsigned key;
  int i;
};

// The argmax of (key, i) over a warp: largest key, then lowest index.
// Every lane gets it.
__device__ __forceinline__ void warp_argmax_key(unsigned& key, int& i) {
  const unsigned best = __reduce_max_sync(kAll, key);
  i = __reduce_min_sync(kAll, key == best ? i : INT_MAX);
  key = best;
}

// One cloud a cluster: see the note at the top. chunk = ceil(n / C) indices
// a block, at most kT * kK; dynamic shared memory holds them (3 chunk
// floats) for the lookup of a block's winner.
template <int kT, int kK>
__global__ void __launch_bounds__(kT, 1)
fps_cluster_kernel(const float* __restrict__ xyz, int n, int m, int chunk,
                   int* __restrict__ out) {
  constexpr int kW = kT / 32;
  extern __shared__ float s_pts[];
  __shared__ unsigned red_k[kW];
  __shared__ int red_i[kW];
  __shared__ Partial slots[2][kMaxCluster];     // [step parity][rank]

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cloud = blockIdx.x / csize;
  const float* pts = xyz + static_cast<size_t>(cloud) * n * 3;
  int* sel = out + static_cast<size_t>(cloud) * m;
  const int lo = rank * chunk;
  const int len = min(chunk, n - lo);           // may be <= 0

  // the thread's points: lo + threadIdx.x + k * kT; past the block's range
  // the cache holds -inf, which never wins
  float px[kK], py[kK], pz[kK], mind[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int j = threadIdx.x + k * kT;
    const bool in = j < len;
    const float* p = pts + 3 * static_cast<size_t>(in ? lo + j : 0);
    px[k] = __ldg(p);
    py[k] = __ldg(p + 1);
    pz[k] = __ldg(p + 2);
    mind[k] = in ? INFINITY : -INFINITY;
    if (in) {
      s_pts[3 * j] = px[k];
      s_pts[3 * j + 1] = py[k];
      s_pts[3 * j + 2] = pz[k];
    }
  }
  float cx = __ldg(pts), cy = __ldg(pts + 1), cz = __ldg(pts + 2);
  if (rank == 0 && threadIdx.x == 0) sel[0] = 0;
  cluster.sync();       // every block runs before any writes to its slots

  for (int step = 1; step < m; ++step) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float dx = __fsub_rn(px[k], cx);
      const float dy = __fsub_rn(py[k], cy);
      const float dz = __fsub_rn(pz[k], cz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      mind[k] = fminf(mind[k], d);
      if (mind[k] > bv) {       // ascending indices: the first wins ties
        bv = mind[k];
        bi = lo + threadIdx.x + k * kT;
      }
    }
    // a value >= +0 orders as its bits do; an empty thread's -inf maps to
    // 0 with index INT_MAX, so it loses to every point
    unsigned key = __float_as_uint(fmaxf(bv, 0.f));
    warp_argmax_key(key, bi);
    if (lane == 0) {
      red_k[warp] = key;
      red_i[warp] = bi;
    }
    __syncthreads();
    const int par = step & 1;
    if (warp == 0) {
      key = lane < kW ? red_k[lane] : 0u;
      bi = lane < kW ? red_i[lane] : INT_MAX;
      warp_argmax_key(key, bi);
      if (lane < csize) {       // push the block's best to block `lane`
        const int at = bi == INT_MAX ? 0 : 3 * (bi - lo);
        Partial w;
        w.x = s_pts[at];
        w.y = s_pts[at + 1];
        w.z = s_pts[at + 2];
        w.key = key;
        w.i = bi;
        *cluster.map_shared_rank(&slots[par][rank], lane) = w;
      }
    }
    // release the pushes, acquire the others'. A block overwrites slot
    // par at step + 2 only after every block has arrived here at step + 1,
    // and so has read this step's slots.
    cluster.sync();
    key = lane < csize ? slots[par][lane].key : 0u;
    int i = lane < csize ? slots[par][lane].i : INT_MAX;
    const int mine = i;
    warp_argmax_key(key, i);
    const Partial& w = slots[par][__ffs(__ballot_sync(kAll, mine == i)) - 1];
    cx = w.x;
    cy = w.y;
    cz = w.z;
    if (rank == 0 && threadIdx.x == 0) sel[step] = i;
  }
  // no block touches another's shared memory after the last barrier
}

using ClusterKernel = void (*)(const float*, int, int, int, int*);

// The instantiation with the smallest kK of the list that holds `per`
// points a thread, or null.
template <int kT, int kK, int... kMore>
ClusterKernel pick_kernel(int per) {
  if (per <= kK) return fps_cluster_kernel<kT, kK>;
  if constexpr (sizeof...(kMore) > 0) return pick_kernel<kT, kMore...>(per);
  return nullptr;
}

// The kernel for one cloud of n points over `cluster` blocks of `threads`
// (ops/fps.py:_CLUSTER_PER_THREAD holds each block size's largest kK) and
// its launch in `cfg`; cudaErrorInvalidValue where no instantiation holds
// the cloud in registers.
cudaError_t cluster_kernel(int batch, int n, int cluster, int threads,
                           cudaStream_t stream, ClusterKernel& kernel,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  if (cluster < 2 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  const int per = ((n + cluster - 1) / cluster + threads - 1) / threads;
  kernel = nullptr;
  if (threads == 128)
    kernel = pick_kernel<128, 2, 3, 5, 9, 12, 17, 24, 34, 46>(per);
  else if (threads == 256)
    kernel = pick_kernel<256, 2, 3, 5, 9, 12, 17, 24, 34, 46>(per);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(3 * sizeof(float)) *
                   ((n + cluster - 1) / cluster);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {    // not portable; the H100 takes 16
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
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

// One cloud a cluster of `cluster` blocks (2 to 16) of `threads` threads
// (128 or 256). xyz [B, n, 3] f32 -> out [B, m] i32.
// Returns cudaErrorInvalidValue where no instantiation holds ceil(n /
// cluster) points in a block's registers; a cluster the card cannot place
// fails at launch.
extern "C" int puflow_fps_cluster(const void* xyz, int batch, int n, int m,
                                  void* out, int cluster, int threads,
                                  void* stream) {
  ClusterKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_kernel(batch, n, cluster, threads,
                     static_cast<cudaStream_t>(stream), kernel, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(xyz), n, m,
      (n + cluster - 1) / cluster, static_cast<int*>(out));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of puflow_fps_cluster's kernel for (n, cluster,
// threads) the card holds at once (cudaOccupancyMaxActiveClusters), into
// *max_clusters.
extern "C" int puflow_fps_cluster_occupancy(int n, int cluster, int threads,
                                            void* max_clusters) {
  ClusterKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err =
      cluster_kernel(1, n, cluster, threads, nullptr, kernel, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(static_cast<int*>(max_clusters),
                                        kernel, &cfg);
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
