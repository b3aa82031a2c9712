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
//   no longer fit a block) take `puflow_knn_self_stream`: the patch sorted
//   once in device memory by cells of a grid (`knn_cells_kernel`,
//   `knn_scatter_kernel`), with a box a tile of 32 sorted points, then
//   `knn_stream_kernel`, the same keys, lists and merge, walking the tiles
//   outwards and skipping those whose box is farther than every lane's
//   bar (the section before it says why that is exact). Without the skip
//   the walk computes all n^2 distances; with it, about 3% of them at
//   10,433 points and 1% at 32,768.
// The TPU kernel's transposed layout and k min-sweeps were for the VPU's
// sublane reductions and are not carried over.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>

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

// Patches larger than shared memory holds (`puflow_knn_self_stream`): the
// same keys, lists, insertion and lane merge, in three launches.
// `knn_cells_kernel`, a block a patch: the patch's bounding box, a grid of
// 2^g cells an axis over it (g <= 5), a histogram of the cells' Morton
// codes in shared memory and its scan, written out as each cell's first
// place in the order. `knn_scatter_kernel`, a thread a point over many
// blocks: each point to its cell's next place by a global atomic, as
// float4 (x, y, z, index bits) (the order within a cell is free: only the
// keys decide the result), and into the box of its tile of kTile
// consecutive places by atomic min / max on ordered bits: the box is the
// min and max of the tile's members' own coordinates. `knn_stream_kernel`
// walks the sorted patch as `knn_self_kernel` walks its shared memory: a
// warp's queries are consecutive in the order, and the warp visits the
// tiles outwards from its own, after a test that may skip a tile. Per
// axis the gap between the query and the box, __fsub_rn(lo, q) below it,
// __fsub_rn(q, hi) above it, else 0, and lb = (gx*gx + gy*gy) + gz*gz in
// the keys' _rn order: rounding is monotone and __fsub_rn(c, q) =
// -__fsub_rn(q, c), so lb is at most the distance of any member. A lane
// may skip a tile when lb exceeds the distance of its bar (`bar_of`:
// strictly, since a tie with a lower index still enters; an empty slot
// never lets it skip), and the warp skips it when every lane may. Tiles
// are tested 32 at a time first, one a lane, against the box of the
// warp's queries and the largest bar of its lanes (a ballot), then each
// one left against each query.
constexpr int kTile = 32;             // sorted points a tile of the walk
constexpr int kOrderThreads = 1024;   // a block of the cells kernel
constexpr int kMaxCellBits = 5;       // at most 32 cells an axis
constexpr int kUnroll = 4;            // points a thread loads at once
constexpr int kScatterThreads = 256;  // a block of the scatter
constexpr int kWalkThreads = 64;      // a block of the walk: two warps
constexpr int kMaxDevices = 64;       // devices `allow_cells_smem` tracks

// Inclusive sum over lanes 0..lane.
__device__ __forceinline__ uint32_t warp_scan(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// The Morton code of the cell of point p in the grid of 2^g cells an axis
// from (frame.x, frame.y, frame.z), frame.w cells a unit.
__device__ __forceinline__ uint32_t cell_of(const float (&p)[3],
                                            float4 frame, int g) {
  const int top = (1 << g) - 1;
  const float lo[3] = {frame.x, frame.y, frame.z};
  uint32_t code = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int v = min(static_cast<int>((p[c] - lo[c]) * frame.w), top);
    code |= spread3(static_cast<uint32_t>(v)) << (2 - c);
  }
  return code;
}

// Cell c's word in shared memory: a word of padding after every 32, so a
// warp whose threads each walk 32 consecutive cells meets 32 banks.
__device__ __forceinline__ int padded(uint32_t c) {
  return static_cast<int>(c + (c >> 5));
}

// A float's bits as an int that orders as the float does, and back.
__device__ __forceinline__ int ordered(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

// The min (b[0..2]) and max (b[3..5]) of each axis over the warp.
__device__ __forceinline__ void warp_box(float (&b)[6]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = fminf(b[c], __shfl_xor_sync(0xffffffffu, b[c], off));
      b[3 + c] = fmaxf(b[3 + c], __shfl_xor_sync(0xffffffffu, b[3 + c], off));
    }
  }
}

// Points i0 + u kOrderThreads (u < kUnroll) of the patch; past its end,
// its last point again.
__device__ __forceinline__ void load_points(const float* __restrict__ src,
                                            int n, int i0,
                                            float (&v)[kUnroll][3]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = min(i0 + u * kOrderThreads, n - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[u][c] = src[3 * i + c];
  }
}

// The order's scratch a patch: its frame (the box's low corner and cells
// a unit), each cell's next place, each tile's box (lo, hi as ordered
// bits), the sorted patch.
struct Order {
  float4* frame;         // [batch]
  uint32_t* next;        // [batch][2^(3 g)]
  int4* boxes;           // [batch][tiles][2]
  float4* sorted;        // [batch][n]
};

// grid: one block a patch; dynamic shared memory: a padded word a cell.
// Each pass over the patch keeps kUnroll points a thread in flight.
__global__ void __launch_bounds__(kOrderThreads)
knn_cells_kernel(const float* __restrict__ xyz, int n, int g, Order order) {
  extern __shared__ uint32_t cells[];          // counts, then first places
  __shared__ float part_box[kOrderThreads / 32][6];
  __shared__ uint32_t tot[32];
  constexpr int kWarps = kOrderThreads / 32;
  constexpr int kStride = kUnroll * kOrderThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncell = 1 << (3 * g);
  const int tiles = (n + kTile - 1) / kTile;
  const float* src = xyz + static_cast<size_t>(blockIdx.x) * n * 3;

  for (int c = tid; c < padded(ncell); c += kOrderThreads) cells[c] = 0u;
  int4* box = order.boxes + static_cast<size_t>(blockIdx.x) * tiles * 2;
  for (int t = tid; t < tiles; t += kOrderThreads) {
    box[2 * t] = make_int4(INT_MAX, INT_MAX, INT_MAX, 0);
    box[2 * t + 1] = make_int4(INT_MIN, INT_MIN, INT_MIN, 0);
  }
  float b[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                -INFINITY};
  for (int i0 = tid; i0 < n; i0 += kStride) {
    float v[kUnroll][3];
    load_points(src, n, i0, v);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b[c] = fminf(b[c], v[u][c]);
        b[3 + c] = fmaxf(b[3 + c], v[u][c]);
      }
    }
  }
  warp_box(b);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) part_box[warp][c] = b[c];
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = fminf(b[c], part_box[w][c]);
      b[3 + c] = fmaxf(b[3 + c], part_box[w][3 + c]);
    }
  }
  const float extent = fmaxf(fmaxf(b[3] - b[0], b[4] - b[1]), b[5] - b[2]);
  const float4 frame = make_float4(
      b[0], b[1], b[2],
      extent > 0.0f ? static_cast<float>(1 << g) / extent : 0.0f);
  if (tid == 0) order.frame[blockIdx.x] = frame;
  for (int i0 = tid; i0 < n; i0 += kStride) {
    float v[kUnroll][3];
    load_points(src, n, i0, v);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kOrderThreads < n)
        atomicAdd(&cells[padded(cell_of(v[u], frame, g))], 1u);
    }
  }
  __syncthreads();
  // the counts' exclusive scan: thread t's run of `per` consecutive cells
  // summed, the sums scanned over the block, each run written out
  const int per = ncell > kOrderThreads ? ncell / kOrderThreads : 1;
  const int first = tid * per;
  uint32_t sum = 0;
  for (int j = 0; j < per; ++j)
    if (first + j < ncell) sum += cells[padded(first + j)];
  const uint32_t incl = warp_scan(sum, lane);
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t t = tot[lane];
    tot[lane] = warp_scan(t, lane) - t;
  }
  __syncthreads();
  uint32_t run = tot[warp] + incl - sum;
  for (int j = 0; j < per; ++j) {
    if (first + j < ncell) {
      const uint32_t count = cells[padded(first + j)];
      cells[padded(first + j)] = run;
      run += count;
    }
  }
  __syncthreads();
  uint32_t* next = order.next + static_cast<size_t>(blockIdx.x) * ncell;
  for (int c = tid; c < ncell; c += kOrderThreads) next[c] = cells[padded(c)];
}

// grid: ceil(n / kScatterThreads) blocks a patch, patch-major; a thread a
// point.
__global__ void __launch_bounds__(kScatterThreads)
knn_scatter_kernel(const float* __restrict__ xyz, int n, int g,
                   Order order) {
  const int blocks = (n + kScatterThreads - 1) / kScatterThreads;
  const int patch = blockIdx.x / blocks;
  const int i = (blockIdx.x - patch * blocks) * kScatterThreads +
                threadIdx.x;
  if (i >= n) return;
  const float* src = xyz + (static_cast<size_t>(patch) * n + i) * 3;
  const float p[3] = {src[0], src[1], src[2]};
  const uint32_t cell = cell_of(p, order.frame[patch], g);
  const uint32_t at = atomicAdd(
      &order.next[(static_cast<size_t>(patch) << (3 * g)) + cell], 1u);
  order.sorted[static_cast<size_t>(patch) * n + at] =
      make_float4(p[0], p[1], p[2], __int_as_float(i));
  const int tiles = (n + kTile - 1) / kTile;
  int* box = reinterpret_cast<int*>(
      order.boxes + (static_cast<size_t>(patch) * tiles + at / kTile) * 2);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    atomicMin(box + c, ordered(p[c]));
    atomicMax(box + 4 + c, ordered(p[c]));
  }
}

// One axis of the lower bound: the gap between [qlo, qhi] and [lo, hi].
__device__ __forceinline__ float gap(float qlo, float qhi, float lo,
                                     float hi) {
  return qhi < lo ? __fsub_rn(lo, qhi)
                  : (qlo > hi ? __fsub_rn(qlo, hi) : 0.0f);
}

// The bits of the lower bound of the distance between a point of the box
// [qlo, qhi] (a query: qlo = qhi) and any point of the box [lo, hi].
__device__ __forceinline__ uint32_t bound_bits(float4 qlo, float4 qhi,
                                               float4 lo, float4 hi) {
  const float gx = gap(qlo.x, qhi.x, lo.x, hi.x);
  const float gy = gap(qlo.y, qhi.y, lo.y, hi.y);
  const float gz = gap(qlo.z, qhi.z, lo.z, hi.z);
  return __float_as_uint(__fadd_rn(
      __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz)));
}

// Tile t's box from its ordered bits.
__device__ __forceinline__ void box_of(const int4* __restrict__ boxes, int t,
                                       float4& lo, float4& hi) {
  const int4 l = boxes[2 * t], h = boxes[2 * t + 1];
  lo = make_float4(unordered(l.x), unordered(l.y), unordered(l.z), 0.0f);
  hi = make_float4(unordered(h.x), unordered(h.y), unordered(h.z), 0.0f);
}

// The distance bits of a key (0xffffffff for an empty slot).
__device__ __forceinline__ uint32_t dist_bits(uint64_t key) {
  return static_cast<uint32_t>(key >> 32);
}

// A lane's bar: no candidate whose key is at or above it can be among its
// query's KL best. Its list's last key, and at L > 1 the largest of the
// J-th keys of the query's L lanes, if smaller (J = KL / L, at least 1:
// the lanes hold L J >= KL keys at or below it). A lane's list holds the
// best of its share of the candidates only; the second bar is that of
// them all.
template <int KL, int L>
__device__ __forceinline__ uint64_t bar_of(const uint64_t (&list)[KL]) {
  if constexpr (L == 1) {
    return list[KL - 1];
  } else {
    constexpr int kJ = KL / L > 1 ? KL / L : 1;
    uint64_t bar = list[kJ - 1];
#pragma unroll
    for (int m = 1; m < L; m <<= 1) {
      const uint64_t other = __shfl_xor_sync(0xffffffffu, bar, m);
      bar = bar > other ? bar : other;
    }
    return kmin(bar, list[KL - 1]);
  }
}

// The tile of m members at `base` staged in the warp's buffer; lane s of
// a query's L takes candidates s, s + L, ..., each held to the lane's
// `bar` at L > 1.
template <int KL, int L>
__device__ __forceinline__ void walk_tile(const float4* __restrict__ pts,
                                          float4* buf, int base, int m,
                                          float4 q, int lane, int s,
                                          uint64_t bar,
                                          uint64_t (&list)[KL]) {
  constexpr int kSteps = kTile / L;
  for (int j = lane; j < m; j += 32) buf[j] = pts[base + j];
  __syncwarp();
#pragma unroll 4
  for (int f = 0; f < kSteps; ++f) {
    const int j = f * L + s;
    uint64_t key = j < m ? key_of(buf[j], q) : kNone;
    if constexpr (L > 1) key = key < bar ? key : kNone;
    insert(list, key);
  }
  __syncwarp();
}

// The walk's t-th tile from `centre`: t = 0 the warp's own, then +1, -1,
// +2, -2, ..., then on along the longer side (`below` and `above` tiles
// on either side, `both` the fewer).
__device__ __forceinline__ int outward(int t, int centre, int below,
                                       int above, int both) {
  const int e = t - 2 * both;
  if (e <= 0) return (t & 1) ? centre + (t + 1) / 2 : centre - t / 2;
  return below > above ? centre - both - e : centre + both + e;
}

// grid: ceil(n / (kWalkThreads / L)) blocks a patch, patch-major; lane
// group g of L lanes of a warp holds query g of the warp's 32 / L
// consecutive places in the order. The boxes of the next 32 tiles are
// loaded while the current ones are walked.
template <int KL, int L>
__global__ void __launch_bounds__(kWalkThreads)
knn_stream_kernel(const float4* __restrict__ sorted,
                  const int4* __restrict__ boxes, int n, int k,
                  int64_t* __restrict__ out) {
  constexpr int kQ = kWalkThreads / L;      // queries a block
  constexpr int kWarpQ = 32 / L;            // queries a warp
  constexpr int kSteps = kTile / L;         // candidates a lane a tile
  __shared__ float4 stage[kWalkThreads / 32][kTile];
  const int blocks = (n + kQ - 1) / kQ;
  const int patch = blockIdx.x / blocks;
  const int tid = threadIdx.x, lane = tid & 31;
  const int w0 = (blockIdx.x - patch * blocks) * kQ + (tid >> 5) * kWarpQ;
  if (w0 >= n) return;                      // warp-uniform
  const int tiles = (n + kTile - 1) / kTile;
  const float4* pts = sorted + static_cast<size_t>(patch) * n;
  const int4* box = boxes + static_cast<size_t>(patch) * tiles * 2;
  float4* buf = stage[tid >> 5];
  const int s = lane % L, p = w0 + lane / L;
  const float4 q = pts[min(p, n - 1)];
  const int centre = min(w0 + kWarpQ / 2, n - 1) / kTile;
  const int below = centre, above = tiles - 1 - centre;
  const int both = min(below, above);
  // the first group's boxes
  int tile = outward(lane, centre, below, above, both);
  float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
  if (lane < tiles) box_of(box, tile, lo, hi);
  float b[6] = {q.x, q.y, q.z, q.x, q.y, q.z};
  warp_box(b);                              // the box of the warp's queries
  const float4 wlo = make_float4(b[0], b[1], b[2], 0.0f);
  const float4 whi = make_float4(b[3], b[4], b[5], 0.0f);
  uint64_t list[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j) list[j] = kNone;

  // the warp's own tile first, its first keys sorted by a network
  {
    const int base = centre * kTile, m = min(kTile, n - base);
    for (int j = lane; j < m; j += 32) buf[j] = pts[base + j];
    __syncwarp();
    constexpr int kF = kSteps < KL ? kSteps : KL;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const int j = f * L + s;
      list[f] = j < m ? key_of(buf[j], q) : kNone;
    }
    bitonic_sort<KL, 2>(list);
#pragma unroll 4
    for (int f = kF; f < kSteps; ++f) {
      const int j = f * L + s;
      insert(list, j < m ? key_of(buf[j], q) : kNone);
    }
    __syncwarp();
  }
  uint64_t bar = bar_of<KL, L>(list);
  // then the others, 32 at a time
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const int t = t0 + lane;
    const bool valid = t > 0 && t < tiles;
    const int next = outward(t + 32, centre, below, above, both);
    float4 nlo = lo, nhi = hi;
    if (t + 32 < tiles) box_of(box, next, nlo, nhi);
    const uint32_t most = __reduce_max_sync(0xffffffffu, dist_bits(bar));
    uint32_t todo = __ballot_sync(
        0xffffffffu, valid && bound_bits(wlo, whi, lo, hi) <= most);
    while (todo) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      const float4 tlo = make_float4(__shfl_sync(0xffffffffu, lo.x, i),
                                     __shfl_sync(0xffffffffu, lo.y, i),
                                     __shfl_sync(0xffffffffu, lo.z, i), 0.0f);
      const float4 thi = make_float4(__shfl_sync(0xffffffffu, hi.x, i),
                                     __shfl_sync(0xffffffffu, hi.y, i),
                                     __shfl_sync(0xffffffffu, hi.z, i), 0.0f);
      if (__all_sync(0xffffffffu,
                     bound_bits(q, q, tlo, thi) > dist_bits(bar)))
        continue;
      const int base = __shfl_sync(0xffffffffu, tile, i) * kTile;
      walk_tile<KL, L>(pts, buf, base, min(kTile, n - base), q, lane, s,
                       bar, list);
      bar = bar_of<KL, L>(list);
    }
    tile = next;
    lo = nlo;
    hi = nhi;
  }
  merge_lanes<KL, L>(list);
  if (p < n) {
    int64_t* row = out + (static_cast<size_t>(patch) * n +
                          __float_as_int(q.w)) * k;
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

template <int KL, int L>
cudaError_t launch(const float* xyz, int batch, int n, int k, int64_t* out,
                   cudaStream_t stream) {
  constexpr int kQ = kThreads / L;
  const long long grid = static_cast<long long>(batch) * ((n + kQ - 1) / kQ);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
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
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_lanes(const float* xyz, int batch, int n, int k,
                         int64_t* out, cudaStream_t stream) {
  if (k <= 1) return launch<1, L>(xyz, batch, n, k, out, stream);
  if (k <= 2) return launch<2, L>(xyz, batch, n, k, out, stream);
  if (k <= 4) return launch<4, L>(xyz, batch, n, k, out, stream);
  if (k <= 8) return launch<8, L>(xyz, batch, n, k, out, stream);
  return launch<16, L>(xyz, batch, n, k, out, stream);
}

template <int KL, int L>
cudaError_t launch_walk(const Order& order, int batch, int n, int k,
                        int64_t* out, cudaStream_t stream) {
  constexpr int kQ = kWalkThreads / L;
  const long long grid = static_cast<long long>(batch) * ((n + kQ - 1) / kQ);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  knn_stream_kernel<KL, L><<<static_cast<unsigned>(grid), kWalkThreads, 0,
                             stream>>>(order.sorted, order.boxes, n, k, out);
  return cudaGetLastError();
}

// The walk's lanes a query: 8 below 32,768 queries (one patch of up to
// 32,767 points), where each warp's latency sets its time, 4 below 65,536,
// else 1.
template <int KL>
cudaError_t launch_walk_lanes(const Order& order, int batch, int n, int k,
                              int64_t* out, cudaStream_t stream) {
  const long long queries = static_cast<long long>(batch) * n;
  if (queries >= (1 << 16))
    return launch_walk<KL, 1>(order, batch, n, k, out, stream);
  if (queries >= (1 << 15))
    return launch_walk<KL, 4>(order, batch, n, k, out, stream);
  return launch_walk<KL, 8>(order, batch, n, k, out, stream);
}

// The cells kernel's grid: 2^g cells an axis, the fewest that give every
// point a cell of its own on average, at most 2^kMaxCellBits.
int cell_bits(int n) {
  int g = 1;
  while (g < kMaxCellBits && (1 << (3 * g)) < n) ++g;
  return g;
}

// The cells kernel's shared memory at 2^g cells an axis: a padded word a
// cell (`padded`).
int cells_smem(int g) {
  const int ncell = 1 << (3 * g);
  return 4 * (ncell + (ncell >> 5));
}

// The order's scratch for `batch` patches of n points at `scratch` (null:
// only its size): a patch's frame, its tiles' boxes, the sorted patch and
// a word a cell. Returns its bytes.
size_t order_at(void* scratch, int batch, int n, Order& order) {
  const size_t b = static_cast<size_t>(batch);
  const size_t tiles = (static_cast<size_t>(n) + kTile - 1) / kTile;
  const size_t ncell = size_t{1} << (3 * cell_bits(n));
  const size_t boxes = 16 * b, sorted = boxes + 32 * b * tiles,
               next = sorted + 16 * b * n;
  if (scratch != nullptr) {
    char* at = static_cast<char*>(scratch);
    order.frame = reinterpret_cast<float4*>(at);
    order.boxes = reinterpret_cast<int4*>(at + boxes);
    order.sorted = reinterpret_cast<float4*>(at + sorted);
    order.next = reinterpret_cast<uint32_t*>(at + next);
  }
  return next + 4 * b * ncell;
}

// Lets the cells kernel take its largest shared memory, once a device.
cudaError_t allow_cells_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  std::call_once(once[dev], [dev] {
    result[dev] = cudaFuncSetAttribute(
        knn_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        cells_smem(kMaxCellBits));
  });
  return result[dev];
}

}  // namespace

// xyz [batch, n, 3] f32 -> out [batch, n, k] int64, 1 <= k <= min(16, n),
// 16 n + max(4 pow2(n), 32768) <= 232448 bytes (n <= 10432). 4 lanes a
// query below 65,536 queries (256 patches of 256), where one lane a query
// leaves most of the card's warp slots empty.
extern "C" int puflow_knn_self(const void* xyz, int batch, int n, int k,
                               void* out, void* stream) {
  if (k < 1 || k > kMaxK || k > n) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const long long queries = static_cast<long long>(batch) * n;
  const float* x = static_cast<const float*>(xyz);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (queries >= (1 << 16)) return launch_lanes<1>(x, batch, n, k, o, s);
  return launch_lanes<4>(x, batch, n, k, o, s);
}

// The bytes of `puflow_knn_self_stream`'s scratch for `batch` patches of n
// points, into *bytes (a long long).
extern "C" int puflow_knn_self_stream_scratch(int batch, int n, void* bytes) {
  if (batch < 0 || n < 1) return cudaErrorInvalidValue;
  Order order;
  *static_cast<long long*>(bytes) =
      static_cast<long long>(order_at(nullptr, batch, n, order));
  return cudaSuccess;
}

// The same for patches of any n: the order (`knn_cells_kernel`, then
// `knn_scatter_kernel`) into `scratch` (16-byte aligned, `scratch_bytes`
// long: at least `puflow_knn_self_stream_scratch`'s), then the walk
// (`knn_stream_kernel`).
extern "C" int puflow_knn_self_stream(const void* xyz, int batch, int n,
                                      int k, void* out, void* scratch,
                                      long long scratch_bytes,
                                      void* stream) {
  if (k < 1 || k > kMaxK || k > n) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Order order;
  const size_t need = order_at(scratch, batch, n, order);
  if (scratch == nullptr || scratch_bytes < 0 ||
      static_cast<size_t>(scratch_bytes) < need)
    return cudaErrorInvalidValue;
  const long long grid = static_cast<long long>(batch) *
                         ((n + kScatterThreads - 1) / kScatterThreads);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xyz);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = cell_bits(n);
  if (cells_smem(g) > 48 * 1024) {
    const cudaError_t err = allow_cells_smem();
    if (err != cudaSuccess) return err;
  }
  knn_cells_kernel<<<batch, kOrderThreads, cells_smem(g), s>>>(x, n, g,
                                                                order);
  knn_scatter_kernel<<<static_cast<unsigned>(grid), kScatterThreads, 0, s>>>(
      x, n, g, order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (k <= 1) return launch_walk_lanes<1>(order, batch, n, k, o, s);
  if (k <= 2) return launch_walk_lanes<2>(order, batch, n, k, o, s);
  if (k <= 4) return launch_walk_lanes<4>(order, batch, n, k, o, s);
  if (k <= 8) return launch_walk_lanes<8>(order, batch, n, k, o, s);
  return launch_walk_lanes<16>(order, batch, n, k, o, s);
}
