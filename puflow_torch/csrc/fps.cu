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
// pick's update. Plain version: `farthest_point_sample_seeded_plain`. The
// one entry point launches two kernels:
//   1. seed_mind_kernel, a grid over (candidate chunk, row): R x M x S
//      independent distances (67 M a cloud on the merge), FP32 CUDA-core
//      work. Seeds stream through shared memory in tiles of float4; each
//      thread keeps kSeedPer candidates in registers, so a seed read from
//      shared memory serves kSeedPer distances. The TPU kernel takes the
//      expanded form |p|^2 - 2 p.s + |s|^2 on its matrix unit; here the
//      delta form with _rn intrinsics, as in the selection, so the indices
//      equal the plain version's on any float input. 9 FP32 instructions a
//      pair that cannot contract into FMAs: at 32 clouds of the seeded merge
//      it runs near the card's FP32 issue rate.
//   2. the selection from the seeded cache (`mind`, [R, n]), one of three
//      kernels as the wrapper's plan (`ops/fps.py:_fps_seeded_plan`) says:
//      - fps_seeded_block_kernel, a block of kT = 128, 256 or 512 threads a
//        row (the Morton cells: 2,048 candidates, 386 picks; ragged rows):
//        each thread holds its kK candidates (strided by kT) and their cache
//        in registers, read once; the block keeps the row's coordinates in
//        shared memory to look up the winner. A step: warp argmax on the
//        key bits (redux), each warp's best into slots double-buffered by
//        step parity, one __syncthreads, every warp reduces the slots
//        itself and reads the pick's coordinates, then folds the pick into
//        its cache. A step's work an SM is the same at every kT, and fewer
//        warps shorten its reductions, so the plan takes the smallest kT
//        that holds the row and of which the card holds all rows at once
//        (at 32 clouds, 512 rows of 2,048: four blocks of 128 threads, 16
//        candidates a thread, an SM, one wave).
//      - fps_cluster_kernel with the seeded start (rows of tens of
//        thousands: G = 1, the PU-GAN union): the cache loaded from `mind`
//        into registers, a first step that takes its argmax over the
//        cluster, then the merge FPS's loop above (fold, then argmax).
//      - fps_seeded_kernel, one 1024-thread block a row with the cache in
//        `mind` itself, for rows the cluster kernel cannot hold (over 16 x
//        256 x 46 = 188,416 candidates).
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

// A cache value's key: a value >= +0 orders as its bits do; a thread with
// no point (-inf) maps to 0 with index INT_MAX, so it loses to every point
__device__ __forceinline__ unsigned key_of(float v) {
  return __float_as_uint(fmaxf(v, 0.f));
}

// A thread's kK points, first + k * stride: their coordinates and cache in
// registers, read once. Past `len` (relative to `lo`) the cache holds
// -inf, which never wins. `seeded` is the row's seeded cache, or null for
// the unseeded start (+inf). The points also go to s_pts (3 floats each,
// indexed from lo) for the lookup of a winner.
template <int kK>
__device__ __forceinline__ void load_points(
    const float* __restrict__ pts, const float* __restrict__ seeded, int lo,
    int len, int first, int stride, float (&px)[kK], float (&py)[kK],
    float (&pz)[kK], float (&mind)[kK], float* s_pts) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int j = first + k * stride;
    const bool in = j < len;
    const float* p = pts + 3 * static_cast<size_t>(in ? lo + j : 0);
    px[k] = __ldg(p);
    py[k] = __ldg(p + 1);
    pz[k] = __ldg(p + 2);
    mind[k] = !in ? -INFINITY
                  : seeded != nullptr ? __ldg(seeded + lo + j) : INFINITY;
    if (in) {
      s_pts[3 * j] = px[k];
      s_pts[3 * j + 1] = py[k];
      s_pts[3 * j + 2] = pz[k];
    }
  }
}

// The thread's best (value, index) of its cache; ascending indices, so
// strict '>' keeps the first on ties.
template <int kK>
__device__ __forceinline__ void best_of(const float (&mind)[kK], int first,
                                        int stride, float& bv, int& bi) {
  bv = -INFINITY;
  bi = INT_MAX;
#pragma unroll
  for (int k = 0; k < kK; ++k)
    if (mind[k] > bv) {
      bv = mind[k];
      bi = first + k * stride;
    }
}

// Fold the pick (cx, cy, cz) into the thread's cache and return its new
// best. (dx*dx + dy*dy) + dz*dz with _rn intrinsics, as `update`.
template <int kK>
__device__ __forceinline__ void fold(const float (&px)[kK],
                                     const float (&py)[kK],
                                     const float (&pz)[kK], float (&mind)[kK],
                                     float cx, float cy, float cz, int first,
                                     int stride, float& bv, int& bi) {
  bv = -INFINITY;
  bi = INT_MAX;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float dx = __fsub_rn(px[k], cx);
    const float dy = __fsub_rn(py[k], cy);
    const float dz = __fsub_rn(pz[k], cz);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    mind[k] = fminf(mind[k], d);
    if (mind[k] > bv) {
      bv = mind[k];
      bi = first + k * stride;
    }
  }
}

// The argmax of every thread's (bv, bi) over a cluster, at a step of
// parity par: warp argmax, one shared-memory round to the block's best,
// warp 0 pushes it (key, index, coordinates from s_pts) into slot `rank`
// of every block, one cluster barrier, then every warp reduces the C slots
// from its own shared memory. Returns the pick to every thread, and its
// coordinates in (cx, cy, cz).
template <int kW>
__device__ __forceinline__ int cluster_argmax(
    cooperative_groups::cluster_group& cluster, int csize, int rank,
    float bv, int bi, int par, int lo, const float* s_pts, unsigned* red_k,
    int* red_i, Partial (*slots)[kMaxCluster], float& cx, float& cy,
    float& cz) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned key = key_of(bv);
  warp_argmax_key(key, bi);
  if (lane == 0) {
    red_k[warp] = key;
    red_i[warp] = bi;
  }
  __syncthreads();
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
  // release the pushes, acquire the others'. A block overwrites slot par
  // at step + 2 only after every block has arrived here at step + 1, and
  // so has read this step's slots.
  cluster.sync();
  key = lane < csize ? slots[par][lane].key : 0u;
  int i = lane < csize ? slots[par][lane].i : INT_MAX;
  const int mine = i;
  warp_argmax_key(key, i);
  const Partial& w = slots[par][__ffs(__ballot_sync(kAll, mine == i)) - 1];
  cx = w.x;
  cy = w.y;
  cz = w.z;
  return i;
}

// One cloud (or seeded row) a cluster: see the note at the top. chunk =
// ceil(n / C) indices a block, at most kT * kK; dynamic shared memory holds
// them (3 chunk floats) for the lookup of a block's winner. Each step folds
// the last pick into the cache, then takes the cluster's argmax. The start:
// unseeded (`seeded` null), pick 0 is fixed and the cache starts at +inf;
// seeded, the cache starts at `seeded` [rows, n], and pick 0 is its
// argmax.
template <int kT, int kK, bool kSeeded>
__global__ void __launch_bounds__(kT, 1)
fps_cluster_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ seeded, int n, int m, int chunk,
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
  const int cloud = blockIdx.x / csize;
  const float* pts = xyz + static_cast<size_t>(cloud) * n * 3;
  int* sel = out + static_cast<size_t>(cloud) * m;
  const int lo = rank * chunk;
  const int len = min(chunk, n - lo);           // may be <= 0
  const int first = lo + threadIdx.x;

  float px[kK], py[kK], pz[kK], mind[kK];
  load_points(pts,
              kSeeded ? seeded + static_cast<size_t>(cloud) * n : nullptr,
              lo, len, threadIdx.x, kT, px, py, pz, mind, s_pts);
  float cx = __ldg(pts), cy = __ldg(pts + 1), cz = __ldg(pts + 2);
  if (!kSeeded && rank == 0 && threadIdx.x == 0) sel[0] = 0;
  cluster.sync();       // every block runs before any writes to its slots
  if constexpr (kSeeded) {
    float bv;
    int bi;
    best_of(mind, first, kT, bv, bi);
    const int i = cluster_argmax<kW>(cluster, csize, rank, bv, bi, 0, lo,
                                     s_pts, red_k, red_i, slots, cx, cy, cz);
    if (rank == 0 && threadIdx.x == 0) sel[0] = i;
  }
  for (int step = 1; step < m; ++step) {
    float bv;
    int bi;
    fold(px, py, pz, mind, cx, cy, cz, first, kT, bv, bi);
    const int i = cluster_argmax<kW>(cluster, csize, rank, bv, bi, step & 1,
                                     lo, s_pts, red_k, red_i, slots, cx, cy,
                                     cz);
    if (rank == 0 && threadIdx.x == 0) sel[step] = i;
  }
  // no block touches another's shared memory after the last barrier
}

using ClusterKernel = void (*)(const float*, const float*, int, int, int,
                               int*);

// The instantiation with the smallest kK of the list that holds `per`
// points a thread, or null.
template <bool kSeeded, int kT, int kK, int... kMore>
ClusterKernel pick_kernel(int per) {
  if (per <= kK) return fps_cluster_kernel<kT, kK, kSeeded>;
  if constexpr (sizeof...(kMore) > 0)
    return pick_kernel<kSeeded, kT, kMore...>(per);
  return nullptr;
}

template <bool kSeeded>
ClusterKernel pick_cluster(int threads, int per) {
  if (threads == 128)
    return pick_kernel<kSeeded, 128, 2, 3, 5, 9, 12, 17, 24, 34, 46>(per);
  if (threads == 256)
    return pick_kernel<kSeeded, 256, 2, 3, 5, 9, 12, 17, 24, 34, 46>(per);
  return nullptr;
}

// The kernel for rows of n points over `cluster` blocks of `threads`
// (ops/fps.py:_CLUSTER_PER_THREAD holds each block size's largest kK),
// seeded or not, and its launch in `cfg`; cudaErrorInvalidValue where no
// instantiation holds the row in registers.
cudaError_t cluster_kernel(int batch, int n, int cluster, int threads,
                           bool seeded, cudaStream_t stream,
                           ClusterKernel& kernel, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  if (cluster < 2 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  const int per = ((n + cluster - 1) / cluster + threads - 1) / threads;
  kernel = seeded ? pick_cluster<true>(threads, per)
                  : pick_cluster<false>(threads, per);
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

// One seeded row a block of kT threads, kK candidates a thread: see the
// note at the top. Dynamic shared memory holds the row's coordinates (3 n
// floats). Up to 8 candidates a thread the registers are held to 64 a
// thread, so that 1024 threads of blocks share an SM; above, to 128, so
// that 512 do (at 32 clouds of the seeded merge, 512 rows of 2,048, four
// blocks of 128 threads an SM, 114 registers each, take them all at once).
template <int kT, int kK>
__global__ void __launch_bounds__(kT, (kK <= 8 ? 1024 : 512) / kT)
fps_seeded_block_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ seeded, int n, int m,
                        int* __restrict__ out) {
  constexpr int kW = kT / 32;
  extern __shared__ float s_pts[];
  __shared__ unsigned red_k[2][kW];             // [step parity][warp]
  __shared__ int red_i[2][kW];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  int* sel = out + row * m;

  float px[kK], py[kK], pz[kK], mind[kK];
  load_points(xyz + row * n * 3, seeded + row * n, 0, n, threadIdx.x, kT, px,
              py, pz, mind, s_pts);
  float bv;
  int bi;
  best_of(mind, threadIdx.x, kT, bv, bi);
  // One step with the slots rk / ri of its parity. A warp writes a parity's
  // slots again two steps later only after every warp has arrived at the
  // barrier of the step between, and so has read them. The loop below
  // takes two steps a trip, so each step's slots sit at fixed addresses:
  // indexed by step & 1, the compiler rebuilt their shared-memory
  // addresses in every step's chain (S2R SR_CgaCtaId), and the selection
  // took 0.156 ms instead of 0.109 at 16 rows of 2,048 on the H100
  // (scripts/fps_seeded_variants.py parity_index). s_pts is read only
  // after the first step's barrier.
  const auto step_at = [&](int step, unsigned* rk, int* ri) {
    unsigned key = key_of(bv);
    warp_argmax_key(key, bi);
    if (lane == 0) {
      rk[warp] = key;
      ri[warp] = bi;
    }
    __syncthreads();
    key = lane < kW ? rk[lane] : 0u;
    int i = lane < kW ? ri[lane] : INT_MAX;
    warp_argmax_key(key, i);
    if (threadIdx.x == 0) sel[step] = i;
    if (step + 1 < m)
      fold(px, py, pz, mind, s_pts[3 * i], s_pts[3 * i + 1], s_pts[3 * i + 2],
           threadIdx.x, kT, bv, bi);
  };
  for (int step = 0; step < m; step += 2) {
    step_at(step, red_k[0], red_i[0]);
    if (step + 1 < m) step_at(step + 1, red_k[1], red_i[1]);
  }
}

using BlockKernel = void (*)(const float*, const float*, int, int, int*);

template <int kT, int kK, int... kMore>
BlockKernel pick_block(int per) {
  if (per <= kK) return fps_seeded_block_kernel<kT, kK>;
  if constexpr (sizeof...(kMore) > 0) return pick_block<kT, kMore...>(per);
  return nullptr;
}

// The block kernel for rows of n candidates and its dynamic shared memory
// (ops/fps.py:_SEEDED_BLOCK_THREADS and _SEEDED_BLOCK_PER_THREAD hold the
// block sizes and the largest kK); cudaErrorInvalidValue where none holds
// the row in registers.
cudaError_t block_kernel(int n, int threads, BlockKernel& kernel,
                         int& smem) {
  const int per = (n + threads - 1) / threads;
  kernel = nullptr;
  if (threads == 128)
    kernel = pick_block<128, 1, 2, 4, 8, 12, 16>(per);
  else if (threads == 256)
    kernel = pick_block<256, 1, 2, 4, 8, 12, 16>(per);
  else if (threads == 512)
    kernel = pick_block<512, 1, 2, 4, 8, 12, 16>(per);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  smem = static_cast<int>(3 * sizeof(float)) * n;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

// Select m candidates of a row from its seeded cache (mind_global, [R, n]),
// working on it in place: rows over the cluster kernel's registers.
__global__ void __launch_bounds__(kThreads)
fps_seeded_kernel(const float* __restrict__ xyz, int n, int m,
                  int* __restrict__ out, float* __restrict__ mind_global) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_pick;

  const int tid = threadIdx.x;
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* mind = mind_global + static_cast<size_t>(blockIdx.x) * n;
  int* sel = out + static_cast<size_t>(blockIdx.x) * m;

  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int i = tid; i < n; i += kThreads) {
    const float v = mind[i];
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
      cluster_kernel(batch, n, cluster, threads, false,
                     static_cast<cudaStream_t>(stream), kernel, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(xyz),
      static_cast<const float*>(nullptr), n, m, (n + cluster - 1) / cluster,
      static_cast<int*>(out));
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
  const cudaError_t err = cluster_kernel(1, n, cluster, threads, false,
                                         nullptr, kernel, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(static_cast<int*>(max_clusters),
                                        kernel, &cfg);
}

// Seeded FPS. xyz [R, n, 3] f32, seeds [R / groups, s, 3] f32 -> out
// [R, m] i32. `mind` is [R, n] f32 scratch from the caller: the seeded
// cache. The selection's kernel: cluster 0, fps_seeded_kernel (works on
// `mind` in place); 1, fps_seeded_block_kernel of `threads` (128, 256 or
// 512) a row; 2-16, fps_cluster_kernel's seeded instance, a row over
// `cluster` blocks of `threads` (128 or 256). The last two leave `mind` as
// it is. cudaErrorInvalidValue where the kernel does not hold n candidates
// in registers. phases: 1 seeds the cache, 2 selects from it, 3 both.
extern "C" int puflow_fps_seeded(const void* xyz, const void* seeds, int rows,
                                 int n, int s, int groups, int m, void* out,
                                 void* mind, int cluster, int threads,
                                 int phases, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pts = static_cast<const float*>(xyz);
  float* cache = static_cast<float*>(mind);
  int* sel = static_cast<int*>(out);
  cudaError_t err = cudaSuccess;
  if (phases & 1) {
    const dim3 grid((n + kSeedChunk - 1) / kSeedChunk, rows);
    seed_mind_kernel<<<grid, kSeedThreads, 0, st>>>(
        pts, static_cast<const float*>(seeds), n, s, groups, cache);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!(phases & 2)) return cudaSuccess;
  if (cluster == 0) {
    fps_seeded_kernel<<<rows, kThreads, 0, st>>>(pts, n, m, sel, cache);
  } else if (cluster == 1) {
    BlockKernel kernel;
    int smem;
    err = block_kernel(n, threads, kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<rows, threads, smem, st>>>(pts, cache, n, m, sel);
  } else {
    ClusterKernel kernel;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    err = cluster_kernel(rows, n, cluster, threads, true, st, kernel, cfg,
                         attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, pts,
                             static_cast<const float*>(cache), n, m,
                             (n + cluster - 1) / cluster, sel);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// How many rows of n candidates puflow_fps_seeded's selection holds at once
// on the card, into *count: for cluster 1, blocks of `threads` (the blocks
// an SM holds, cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the
// SMs); for 2-16, clusters (cudaOccupancyMaxActiveClusters).
extern "C" int puflow_fps_seeded_occupancy(int n, int cluster, int threads,
                                           void* count) {
  int* rows = static_cast<int*>(count);
  if (cluster == 1) {
    BlockKernel kernel;
    int smem, device, per_sm, sms;
    cudaError_t err = block_kernel(n, threads, kernel, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err == cudaSuccess) *rows = per_sm * sms;
    return err;
  }
  ClusterKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_kernel(1, n, cluster, threads, true,
                                         nullptr, kernel, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(rows, kernel, &cfg);
}
