// Self k-nearest neighbours of every point within its own patch.
//
// Replaces the TPU kernel `knn_self_pallas` (puflow_tpu/ops/pallas/
// knn_pallas.py, `_knn_kernel`): per patch, the k nearest points of each
// point, ascending, first index on ties, so slot 0 is the point itself
// unless an earlier point repeats it. Distances are the delta form
// (dx*dx + dy*dy) + dz*dz in that order, with _rn intrinsics so nvcc
// cannot contract them into FMAs; the plain version `knn_self_plain`
// (puflow_torch/ops/knn.py) computes the same tensor and takes a stable
// sort, and both return the same indices.
//
// What bounds it on the H100: bytes, by the numbers (the int64 output,
// 8 n k bytes a patch, against n^2 distances of 9 flops); in practice
// the integer instructions of the selection, which issue at half the
// float rate. Each query compares all n candidates with the last of its
// k best and inserts the ones that beat it; a warp runs an insertion
// whenever one of its lanes needs one, and with 32 unrelated queries
// that is nearly every candidate.
//
// Design:
// - Keys. A distance is a sum of squares, >= +0, so its float bits order
//   as an unsigned integer: key = bits(d) << 32 | index orders by
//   (distance, index), the plain version's stable order. A list is KL
//   keys in registers (KL the power of two >= k, at most 16): a lane's
//   first KL keys sorted by a network, then each insertion a branch-free
//   chain of 64-bit min / max that leaves a list unchanged when the key
//   does not beat its last entry.
//   A warp runs the chain only when a lane's key beats its last entry
//   (`__any_sync`), and only its back half when no key beats the front
//   half's last. Only the keys decide the result, so the order in which
//   candidates are walked is free.
// - Narrow keys. At one lane a query and k = 16 (the main path) the walk
//   runs first on 32-bit keys: the distance's bits with their low ib bits
//   replaced by the candidate's place in the walk order, 18 to a list,
//   a min and a max a slot where a 64-bit key takes two compares and four
//   selects. A smaller distance part means a smaller distance, so the 18
//   smallest narrow keys hold the 16 nearest in order except where
//   distance parts tie: two in a row are put in order by their exact
//   keys, and a warp in which a lane holds three in a row (exact ties on
//   an integer grid, say) walks again on exact keys.
// - Spatial order. Each block stages the patch in shared memory as
//   float4 (x, y, z, index bits), sorted by a Morton code of the patch's
//   bounding box (a bitonic sort of 32-bit code | index words). A warp's
//   queries are neighbours in that order, so they share most of their
//   neighbours, and each warp walks the candidates from its own place in
//   the order outwards, both ways: the first candidates fill every list
//   with near points, and later ones seldom beat any lane's last key, so
//   the warp skips most insertions.
// - Launch shape. L = 1 or 4 lanes a query, each walking every L-th
//   candidate of the outward order (2 streams, up and down, for L = 1),
//   then merging their sorted lists by xor shuffles (a bitonic merge); a
//   block holds 256 / L queries of one patch and the grid covers every
//   patch. The host takes L = 4 below 65,536 queries, where one lane a
//   query leaves most warp slots empty, else L = 1, which runs the fewest
//   chains (a warp of 32 queries shares them).
// - Output. A block stages its rows in shared memory, then writes each
//   row (k int64, one per query) with 16-byte stores.
// - Patches over shared memory (n > 10,432: the patch and its sort words
//   no longer fit a block) take `knn_stream_kernel` (`puflow_knn_self_stream`):
//   the same keys, lists and merge, the candidates staged from device
//   memory in chunks and walked in index order.
// The TPU kernel's transposed layout and k min-sweeps were for the VPU's
// sublane reductions and are not carried over.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxK = 16;          // the longest list a kernel keeps
constexpr int kThreads = 256;      // a block: kThreads / L queries
constexpr int kMaxSmem = 232448;   // shared memory a block may use
constexpr uint64_t kNone = ~0ull;  // above every key: an empty slot
constexpr int kNarrow = kMaxK + 2;  // a narrow list: 16 keys and 2 more

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

// (a, b) <- (min, max)
__device__ __forceinline__ void order2(uint64_t& a, uint64_t& b) {
  const uint64_t lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}
__device__ __forceinline__ void order2(uint32_t& a, uint32_t& b) {
  const uint32_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// Inserts `key` into the ascending list; a no-op when it does not beat
// the last entry. The warp runs the chain when a lane needs it, and only
// its back half when no lane's key beats the front half's last entry.
template <int KL>
__device__ __forceinline__ void insert(uint64_t (&list)[KL], uint64_t key) {
  constexpr int kHalf = KL >= 8 ? KL / 2 : 0;
  if (__any_sync(0xffffffffu, key < list[KL - 1])) {
    if (kHalf && !__any_sync(0xffffffffu, key < list[kHalf - 1])) {
#pragma unroll
      for (int j = kHalf; j < KL; ++j) order2(list[j], key);
    } else {
#pragma unroll
      for (int j = 0; j < KL; ++j) order2(list[j], key);
    }
  }
}

// Sorts list[0, KL) ascending: a bitonic network, from merges of length
// `from` on (2: any list; KL: a bitonic one).
template <int KL, int from, typename T, int N>
__device__ __forceinline__ void bitonic_sort(T (&list)[N]) {
#pragma unroll
  for (int size = from; size <= KL; size <<= 1) {
#pragma unroll
    for (int s = size / 2; s > 0; s >>= 1) {
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        if ((j & s) == 0) {
          if ((j & size) == 0) {
            order2(list[j], list[j + s]);
          } else {
            order2(list[j + s], list[j]);
          }
        }
      }
    }
  }
}

// Spreads the low 10 bits of v to every third bit.
__device__ __forceinline__ uint32_t spread3(uint32_t v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0x030000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Stages patch `src` into `pts` in Morton order: the bounding box, a
// code of each point's cell (as many bits an axis as the word leaves
// beside the index), a bitonic sort of code | index words in `words`, then
// each point gathered to its place with its index in w.
__device__ void stage_sorted(const float* __restrict__ src, int n,
                             float4* pts, uint32_t* words) {
  float* box = reinterpret_cast<float*>(words);   // [warps][6], then words
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float b[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                -INFINITY};
  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = src[3 * i + c];
      b[c] = fminf(b[c], v);
      b[3 + c] = fmaxf(b[3 + c], v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = fminf(b[c], __shfl_xor_sync(0xffffffffu, b[c], off));
      b[3 + c] = fmaxf(b[3 + c], __shfl_xor_sync(0xffffffffu, b[3 + c], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) box[warp * 6 + c] = b[c];
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = fminf(b[c], box[w * 6 + c]);
      b[3 + c] = fmaxf(b[3 + c], box[w * 6 + 3 + c]);
    }
  }
  __syncthreads();                                // the words overwrite it
  const int ib = 32 - __clz(n);                 // bits that hold n
  const int cb = min(10, (32 - ib) / 3);        // bits an axis
  const float top = static_cast<float>((1 << cb) - 1);
  const float extent = fmaxf(fmaxf(b[3] - b[0], b[4] - b[1]), b[5] - b[2]);
  const float scale = extent > 0.0f ? top / extent : 0.0f;
  const int P = pow2_at_least(n);
  for (int i = tid; i < P; i += kThreads) {
    uint32_t word = 0xffffffffu;
    if (i < n) {
      uint32_t code = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float q = fminf(fmaxf((src[3 * i + c] - b[c]) * scale, 0.0f),
                              top);
        code |= spread3(static_cast<uint32_t>(q)) << (2 - c);
      }
      word = code << ib | static_cast<uint32_t>(i);
    }
    words[i] = word;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const uint32_t a = words[lo], c = words[lo + stride];
        if ((a > c) == ((lo & size) == 0)) {
          words[lo] = c;
          words[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  }
  const uint32_t mask = (1u << ib) - 1u;
  for (int p = tid; p < n; p += kThreads) {
    const int i = static_cast<int>(words[p] & mask);
    pts[p] = make_float4(src[3 * i], src[3 * i + 1], src[3 * i + 2],
                         __int_as_float(i));
  }
}

// The key of candidate c (x, y, z, index bits) against query q.
__device__ __forceinline__ uint64_t key_of(float4 c, float4 q) {
  const float dx = __fsub_rn(c.x, q.x);
  const float dy = __fsub_rn(c.y, q.y);
  const float dz = __fsub_rn(c.z, q.z);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return static_cast<uint64_t>(__float_as_uint(d)) << 32 |
         __float_as_uint(c.w);
}

// The narrow key of the candidate at place `pos`: the distance's bits with
// their low ib bits replaced by the place (`place` = 2^ib - 1).
__device__ __forceinline__ uint32_t narrow_key(const float4* pts, float4 q,
                                               int pos, uint32_t place) {
  const float4 c = pts[pos];
  const float dx = __fsub_rn(c.x, q.x);
  const float dy = __fsub_rn(c.y, q.y);
  const float dz = __fsub_rn(c.z, q.z);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return (__float_as_uint(d) & ~place) | static_cast<uint32_t>(pos);
}

// Inserts a narrow key, as `insert` does a key (the front half: 8 keys).
__device__ __forceinline__ void insert_narrow(uint32_t (&a)[kNarrow],
                                              uint32_t key) {
  constexpr int kHalf = kMaxK / 2;
  if (__any_sync(0xffffffffu, key < a[kNarrow - 1])) {
    if (!__any_sync(0xffffffffu, key < a[kHalf - 1])) {
#pragma unroll
      for (int j = kHalf; j < kNarrow; ++j) order2(a[j], key);
    } else {
#pragma unroll
      for (int j = 0; j < kNarrow; ++j) order2(a[j], key);
    }
  }
}

// The walk of one lane a query for k = 16 on narrow keys, in the exact
// walk's order. Narrow keys order as (distance bits less the low ib,
// place): a smaller distance part means a smaller distance, so the 18
// smallest narrow keys hold the 16 nearest, in order, but where distance
// parts tie. Two in a row that tie are ordered by their exact keys; if a
// lane's list holds three in a row that tie, the 16 nearest are not
// decided and the function returns false for the warp. Else list[j] is
// the index of the j-th nearest.
__device__ __forceinline__ bool walk_narrow(const float4* pts, float4 q,
                                            int n, int centre,
                                            uint64_t (&list)[kMaxK]) {
  const int ib = 32 - __clz(n);                 // bits that hold a place
  const uint32_t place = (1u << ib) - 1u;
  int down = centre, up = centre + 1 < n ? centre + 1 : 0;
  uint32_t a[kNarrow];
#pragma unroll
  for (int f = 0; f < kMaxK / 2; ++f) {
    a[2 * f] = narrow_key(pts, q, down, place);
    a[2 * f + 1] = narrow_key(pts, q, up, place);
    if (--down < 0) down += n;
    if (++up >= n) up -= n;
  }
  bitonic_sort<kMaxK, 2>(a);
#pragma unroll
  for (int j = kMaxK; j < kNarrow; ++j) a[j] = 0xffffffffu;
  const int full = n / 2;
#pragma unroll 2
  for (int i = kMaxK / 2; i < full; ++i) {
    insert_narrow(a, narrow_key(pts, q, down, place));
    insert_narrow(a, narrow_key(pts, q, up, place));
    if (--down < 0) down += n;
    if (++up >= n) up -= n;
  }
  if (2 * full < n) insert_narrow(a, narrow_key(pts, q, down, place));
  bool tie3 = false;
#pragma unroll
  for (int j = 0; j + 2 < kNarrow; ++j)
    tie3 |= ((a[j] ^ a[j + 1]) | (a[j + 1] ^ a[j + 2])) >> ib == 0;
  if (__any_sync(0xffffffffu, tie3)) return false;
#pragma unroll
  for (int j = 0; j + 1 < kNarrow; ++j) {
    if ((a[j] ^ a[j + 1]) >> ib == 0 &&
        key_of(pts[a[j + 1] & place], q) < key_of(pts[a[j] & place], q)) {
      const uint32_t t = a[j];
      a[j] = a[j + 1];
      a[j + 1] = t;
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxK; ++j)
    list[j] = __float_as_uint(pts[a[j] & place].w);
  return true;
}

// One candidate of a stream: its key against the query, into the list.
template <int KL, bool kCheck>
__device__ __forceinline__ void consider(const float4* pts, float4 q,
                                         uint64_t (&list)[KL], int pos,
                                         bool valid) {
  uint64_t key = key_of(pts[kCheck && !valid ? 0 : pos], q);
  if (kCheck && !valid) key = kNone;
  insert(list, key);
}

// Merges the sorted lists of a query's L lanes (xor partners) into each:
// the KL smallest of two ascending lists form a bitonic sequence,
// min(a[j], b[KL - 1 - j]).
template <int KL, int L>
__device__ __forceinline__ void merge_lanes(uint64_t (&list)[KL]) {
#pragma unroll
  for (int m = 1; m < L; m <<= 1) {
    if (KL == 1) {
      list[0] = kmin(list[0], __shfl_xor_sync(0xffffffffu, list[0], m));
    } else {
#pragma unroll
      for (int j = 0; j < KL / 2; ++j) {
        const uint64_t a = __shfl_xor_sync(0xffffffffu, list[KL - 1 - j], m);
        const uint64_t b = __shfl_xor_sync(0xffffffffu, list[j], m);
        list[j] = kmin(list[j], a);
        list[KL - 1 - j] = kmin(list[KL - 1 - j], b);
      }
      bitonic_sort<KL, KL>(list);
    }
  }
}

// grid: ceil(n / (kThreads / L)) blocks a patch, patch-major; block:
// kThreads threads, lane group g of L lanes holds query g.
template <int KL, int L>
__global__ void __launch_bounds__(kThreads)
knn_self_kernel(const float* __restrict__ xyz, int n, int k,
                int64_t* __restrict__ out) {
  constexpr int kQ = kThreads / L;          // queries a block
  constexpr int kWarpQ = 32 / L;            // queries a warp
  constexpr int kD = L < 2 ? 2 : L;         // streams a query
  constexpr int kS = kD / L;                // streams a lane
  extern __shared__ float4 pts[];           // [n], then words or rows
  uint32_t* words = reinterpret_cast<uint32_t*>(pts + n);
  int64_t* rows = reinterpret_cast<int64_t*>(pts + n);

  const int blocks = (n + kQ - 1) / kQ;
  const int patch = blockIdx.x / blocks;
  const int q0 = (blockIdx.x - patch * blocks) * kQ;
  const float* src = xyz + static_cast<size_t>(patch) * n * 3;
  stage_sorted(src, n, pts, words);
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31;
  const int w0 = q0 + (tid >> 5) * kWarpQ;  // the warp's first query
  const int g = tid / L, s = lane % L;      // query in block, its lane
  const int p = q0 + g;                     // its place in the order
  uint64_t list[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j) list[j] = kNone;
  if (w0 < n) {                             // warp-uniform
    const float4 q = pts[min(p, n - 1)];
    // the outward order from the warp's centre: t = 0, 1, 2, ... is
    // offset 0, +1, -1, +2, -2, ...; stream r takes t = r, r + kD, ...
    const int centre = min(w0 + kWarpQ / 2, n - 1);
    // (odd streams walk up, even ones down, kD / 2 places a step)
    int pos[kS], step[kS];
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      const int r = s * kS + u;
      int p0 = (r & 1) ? centre + 1 + (r >> 1) : centre - (r >> 1);
      if (p0 >= n) p0 -= n;
      if (p0 < 0) p0 += n;
      pos[u] = p0;
      step[u] = (r & 1) ? kD / 2 : -kD / 2;
    }
    // one lane a query at k = 16 walks on narrow keys first
    bool exact = true;
    if constexpr (L == 1 && KL == kMaxK) {
      if (n >= kNarrow) exact = !walk_narrow(pts, q, n, centre, list);
    }
    const int full = exact ? n / kD : 0;    // steps with every stream valid
    int i = 0;
    if (exact && full >= KL / kS) {
      // the first KL keys fill the list, sorted by a network
#pragma unroll
      for (int f = 0; f < KL / kS; ++f) {
#pragma unroll
        for (int u = 0; u < kS; ++u) {
          list[f * kS + u] = key_of(pts[pos[u]], q);
          pos[u] += step[u];
          if (pos[u] >= n) pos[u] -= n;
          if (pos[u] < 0) pos[u] += n;
        }
      }
      bitonic_sort<KL, 2>(list);
      i = KL / kS;
    }
#pragma unroll 2
    for (; i < full; ++i) {
#pragma unroll
      for (int u = 0; u < kS; ++u) {
        consider<KL, false>(pts, q, list, pos[u], true);
        pos[u] += step[u];
        if (pos[u] >= n) pos[u] -= n;
        if (pos[u] < 0) pos[u] += n;
      }
    }
    if (exact && full * kD < n) {           // the last, partial step
#pragma unroll
      for (int u = 0; u < kS; ++u) {
        const int r = s * kS + u;
        consider<KL, true>(pts, q, list, pos[u], full * kD + r < n);
      }
    }
    merge_lanes<KL, L>(list);
  }
  if (p < n) {                              // rows reuse the words
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      if (j % L == s && j < k)
        rows[g * k + j] = static_cast<int64_t>(static_cast<uint32_t>(list[j]));
    }
  }
  __syncthreads();
  const int nrows = min(kQ, n - q0);
  int64_t* dst = out + static_cast<size_t>(patch) * n * k;
  if ((k & 1) == 0) {                       // 16-byte stores
    const int half = k / 2;
    for (int c = tid; c < nrows * half; c += kThreads) {
      const int r = c / half, j = c - r * half;
      const int row = __float_as_int(pts[q0 + r].w);
      reinterpret_cast<longlong2*>(dst + static_cast<size_t>(row) * k)[j] =
          reinterpret_cast<const longlong2*>(rows + r * k)[j];
    }
  } else {
    for (int c = tid; c < nrows * k; c += kThreads) {
      const int r = c / k, j = c - r * k;
      const int row = __float_as_int(pts[q0 + r].w);
      dst[static_cast<size_t>(row) * k + j] = rows[r * k + j];
    }
  }
}

// Patches larger than shared memory holds: the same keys, lists and lane
// merge, the candidates streamed from device memory through shared memory
// in chunks of kChunk points, each walked in index order (no Morton order:
// a block cannot sort a patch it cannot hold). Lane s of a query's L takes
// every L-th candidate of a chunk. grid and block as `knn_self_kernel`'s.
constexpr int kChunk = 2048;        // 32 KB of float4

template <int KL, int L>
__global__ void __launch_bounds__(kThreads)
knn_stream_kernel(const float* __restrict__ xyz, int n, int k,
                  int64_t* __restrict__ out) {
  constexpr int kQ = kThreads / L;          // queries a block
  constexpr int kWarpQ = 32 / L;            // queries a warp
  __shared__ float4 pts[kChunk];
  const int blocks = (n + kQ - 1) / kQ;
  const int patch = blockIdx.x / blocks;
  const int q0 = (blockIdx.x - patch * blocks) * kQ;
  const float* src = xyz + static_cast<size_t>(patch) * n * 3;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = tid / L, s = lane % L, p = q0 + g;
  const bool active = q0 + (tid >> 5) * kWarpQ < n;   // warp-uniform
  const float* qp = src + 3 * static_cast<size_t>(min(p, n - 1));
  const float4 q = make_float4(qp[0], qp[1], qp[2], 0.f);
  uint64_t list[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j) list[j] = kNone;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    __syncthreads();                        // the last chunk is walked
    for (int i = tid; i < m; i += kThreads) {
      const float* v = src + 3 * static_cast<size_t>(c0 + i);
      pts[i] = make_float4(v[0], v[1], v[2], __int_as_float(c0 + i));
    }
    __syncthreads();
    if (active) {
      const int whole = m - m % L;          // steps with every lane valid
      int j = 0;
#pragma unroll 4
      for (; j < whole; j += L) consider<KL, false>(pts, q, list, j + s, true);
      if (whole < m) consider<KL, true>(pts, q, list, j + s, j + s < m);
    }
  }
  if (active) merge_lanes<KL, L>(list);
  if (p < n) {
    int64_t* row = out + (static_cast<size_t>(patch) * n + p) * k;
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      if (j % L == s && j < k)
        row[j] = static_cast<int64_t>(static_cast<uint32_t>(list[j]));
    }
  }
}

// Shared memory of a launch: the patch as float4, then the larger of its
// sort words (a power of two of them) and the block's output rows.
size_t smem_bytes(int n, int k, int lanes) {
  const size_t words = 4 * static_cast<size_t>(pow2_at_least(n));
  const size_t rows = 8 * static_cast<size_t>(kThreads / lanes) * k;
  return 16 * static_cast<size_t>(n) + (words > rows ? words : rows);
}

// kStream: `knn_stream_kernel`, else `knn_self_kernel`.
template <bool kStream, int KL, int L>
cudaError_t launch(const float* xyz, int batch, int n, int k, int64_t* out,
                   cudaStream_t stream) {
  constexpr int kQ = kThreads / L;
  const long long grid = static_cast<long long>(batch) * ((n + kQ - 1) / kQ);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if constexpr (kStream) {
    knn_stream_kernel<KL, L><<<static_cast<unsigned>(grid), kThreads, 0,
                               stream>>>(xyz, n, k, out);
  } else {
    const size_t smem = smem_bytes(n, k, L);
    if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          knn_self_kernel<KL, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    knn_self_kernel<KL, L><<<static_cast<unsigned>(grid), kThreads, smem,
                             stream>>>(xyz, n, k, out);
  }
  return cudaGetLastError();
}

template <bool kStream, int L>
cudaError_t launch_lanes(const float* xyz, int batch, int n, int k,
                         int64_t* out, cudaStream_t stream) {
  if (k <= 1) return launch<kStream, 1, L>(xyz, batch, n, k, out, stream);
  if (k <= 2) return launch<kStream, 2, L>(xyz, batch, n, k, out, stream);
  if (k <= 4) return launch<kStream, 4, L>(xyz, batch, n, k, out, stream);
  if (k <= 8) return launch<kStream, 8, L>(xyz, batch, n, k, out, stream);
  return launch<kStream, 16, L>(xyz, batch, n, k, out, stream);
}

// 4 lanes a query below 65,536 queries (256 patches of 256), where one
// lane a query leaves most of the card's warp slots empty.
template <bool kStream>
int launch_queries(const void* xyz, int batch, int n, int k, void* out,
                   void* stream) {
  if (k < 1 || k > kMaxK || k > n) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const long long queries = static_cast<long long>(batch) * n;
  const float* x = static_cast<const float*>(xyz);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (queries >= (1 << 16))
    return launch_lanes<kStream, 1>(x, batch, n, k, o, s);
  return launch_lanes<kStream, 4>(x, batch, n, k, o, s);
}

}  // namespace

// xyz [batch, n, 3] f32 -> out [batch, n, k] int64, 1 <= k <= min(16, n),
// 16 n + max(4 pow2(n), 32768) <= 232448 bytes (n <= 10432).
extern "C" int puflow_knn_self(const void* xyz, int batch, int n, int k,
                               void* out, void* stream) {
  return launch_queries<false>(xyz, batch, n, k, out, stream);
}

// The same for patches of any n (the candidates streamed from device
// memory; the wrapper takes it above `puflow_knn_self`'s limit).
extern "C" int puflow_knn_self_stream(const void* xyz, int batch, int n,
                                      int k, void* out, void* stream) {
  return launch_queries<true>(xyz, batch, n, k, out, stream);
}
