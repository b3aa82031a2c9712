// Condition encoder: the discrete model's six densely connected EdgeConv
// blocks on BN-folded weights, and each block's condition-merge MLP.
//
// Replaces the TPU kernels `encoder_conditions_pallas` and
// `encoder_conditions_pallas_cm` (puflow_tpu/ops/pallas/encoder_pallas.py,
// `_encoder_kernel` / `_encoder_kernel_cm`), which compute the same six
// conditions in two layouts; here they come out channel-last [points,
// cdim_b], the layout flow_f and flow_g take. Per block b, with input x
// [points, c] (xyz for b = 0, else block b-1's pooled output):
//   edge rows (point p, slot s, neighbour q = idx[p, s]):
//     e = x_p W_self + x_q W_nbr       (W_self = W[:c] - W[2c:3c],
//                                       W_nbr = W[c:2c] + W[2c:3c])
//   growth layers j < L: h_j = lrelu_0.05(e_j + [h_0 .. h_{j-1}] W_j + b_j)
//   conv_out:            f = e_out + [h_0 .. h_{L-1}] W_out + b_out
//   pooled[p] = max over the slots of f; condition = relu(pooled W1 + b1) W2
// Plain version: `encoder_conditions_plain` in puflow_torch/ops/encoder.py
// (the port's `discrete.feat_extract` on folded params).
//
// What bounds it on the H100: its products, 477 M multiply-adds of a
// 256-point patch, about 95% in the growth layers and conv_out over the
// n x 16 edge rows. The kernel computes the exact f32 function (the JAX
// package's EXACT_PRECISION, held to its bound) as 3xTF32 products on the
// tensor cores (mma_tf32.cuh): three TF32 products for each f32 one, so
// the least time is 3 x 2 x 477 M flops a patch at the dense TF32 rate.
//
// Design: every product is a warp's m16n8k8 `mma.sync` on a tile of 16
// rows, with the weights' B fragments resident in shared memory,
// pre-split into tf32 hi / lo on the host and laid out fragment by
// fragment (a warp-wide load is 512 contiguous bytes, conflict-free). A
// layer's output stays in its C fragments and is the A operand of the
// next product with no shuffle: the host takes each k8 chunk's weight
// rows in the order the C layout gives (mma_tf32.cuh). Both launches run
// a persistent grid, about one block an SM (rows: 256 threads, edge: 384,
// the faster of those measured). Each encoder block runs two:
//   rows: a warp per tile of 16 points: the previous block's merge MLP
//     (its condition) and this block's self / neighbour projections x
//     W_self, x W_nbr to scratch [points, Gt] (the gather commutes with
//     the projection, so each point is projected once, not 16 times),
//     128 projection columns a phase, each phase's weights staged once a
//     block;
//   edge: a warp per point, whose 16 slots are the 16 rows of the tile:
//     the edge terms p_self[p] + p_nbr[q] (L2-resident within a patch)
//     start each layer's accumulators; the growth layers' outputs stay in
//     registers as the A operand of the later layers and conv_out;
//     conv_out's max over the slots is a max of a lane's two rows and
//     three xor-shuffles, and only the pooled [odim] row reaches memory.
//     No edge activation goes through shared memory. The block's weights
//     (176 KB for blocks 2-5) stay in shared memory for the whole launch.
// What sets the pace is not the tensor cores' rate: measured on an H100
// (scripts/encoder_variants.py), the edge launch of blocks 2-5 ran 7%
// faster with a third of the products, 5% without the hi / lo splits, 9%
// with no gathered loads. It is each warp's chain of dependent steps
// (loads, fragment reads from shared memory, products) at 12 warps an SM,
// which the registers holding a point's growth outputs bound; two points a
// warp (half the fragment reads, 8 warps) was slower.
// K other than 16 comes padded to a multiple of 16 slots (the wrapper
// repeats each point's first neighbour, which leaves the max unchanged); a
// warp runs a point's slot tiles in turn and keeps the running max in its
// pooled row. A final rows launch runs block 5's merge.

#include <algorithm>
#include <cstdint>

#include "mma_tf32.cuh"

namespace puflow {
namespace {

constexpr int kRowsThreads = 256;  // rows launch: a warp 16 points at a time
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kEdgeThreads = 384;  // edge launch: a warp a point
constexpr int kEdgeWarps = kEdgeThreads / 32;
constexpr int kTile = 16;        // rows of an m16 tile
constexpr int kOutTiles = 8;     // conv_out n8 tiles a pass (registers)
constexpr int kProjCols = 128;   // projection columns a rows phase
constexpr int kCondTiles = 4;    // condition n8 tiles a pass
constexpr int kMaxK = 128;       // slots, after padding
constexpr int kMaxGt = 256;      // projection columns of a block
constexpr size_t kMaxSmem = 232448;

// Per block, the host passes kMeta ints: c, g, n_layers, odim, cdim, and
// float offsets into the weights of the biases [gt] of layers 0..n_layers
// (n_layers = conv_out), the merge's b1 [odim / 2], and three runs of B
// fragments (32 float4 each, 16-byte aligned): the projections [W_self |
// W_nbr] ([c, 2 gt], rows padded to a multiple of 8), 128 columns at a
// time; the merge's W1 [odim, odim / 2] and W2 [odim / 2, cdim]; the edge
// launch's (EdgeShape).
constexpr int kMeta = 10;

struct Block {
  int c, g, n_layers, odim, cdim, gt;
  const float* bias;
  const float* m_b1;
  const float4* proj;
  const float4* merge;
  const float4* edge;
};

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Rows r0 + g and r0 + g + 8 of x [n_points, c] as the C fragments of KT
// n8 tiles (a lane's columns 8 kc + t2, + 1); zero past the last row and
// past column c.
template <int KT>
__device__ __forceinline__ void load_tile(float (&xa)[KT][4],
                                          const float* __restrict__ x, int c,
                                          int n_points, int r0, int g,
                                          int t2) {
#pragma unroll
  for (int kc = 0; kc < KT; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + (i < 2 ? 0 : 8);
      const int col = 8 * kc + t2 + i % 2;
      xa[kc][i] = r < n_points && col < c
                      ? __ldg(x + static_cast<size_t>(r) * c + col)
                      : 0.f;
    }
}

// The C fragments of NT n8 tiles to rows r0 + g and r0 + g + 8 of out
// (row stride ld; a lane's columns 8 nt + t2, + 1), rows below n_points.
template <int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4],
                                           float* out, int ld, int n_points,
                                           int r0, int g, int t2) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r < n_points)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * ld +
                                   8 * nt + t2) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// Merge MLP of one tile of 16 rows of a block's pooled output (c = odim):
// cond = relu(x W1 + b1) W2, W1's fragments at wl, W2's after them.
template <int KT>
__device__ __forceinline__ void merge_tile(const float (&xa)[KT][4],
                                           const float4* wl, const Block& m,
                                           float* cond, int n_points, int r0,
                                           int g, int t2) {
  if constexpr (KT % 2 == 0) {
    constexpr int HT = KT / 2;   // hidden n8 tiles: odim / 2 columns
    float hid[HT][4];
    zero(hid);
    tf32::mma_3x<KT>(hid, xa, wl, HT);
#pragma unroll
    for (int nt = 0; nt < HT; ++nt) {
      const float2 b = ldg2(m.m_b1 + 8 * nt + t2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hid[nt][i] = fmaxf(hid[nt][i] + (i % 2 ? b.y : b.x), 0.f);
    }
    const float4* w2 = wl + 32 * KT * HT;
    for (int c0 = 0; c0 < m.cdim / 8; c0 += kCondTiles) {
      float acc[kCondTiles][4];
      zero(acc);
      tf32::mma_3x<HT>(acc, hid, w2 + 32 * c0, m.cdim / 8);
      store_tile(acc, cond + 8 * c0, m.cdim, n_points, r0, g, t2);
    }
  }
}

// Rows launch over tiles of 16 rows of x [n_points, c] (c <= 8 KT): the
// merge of block `merge` (its condition, rows of `cond`), then the
// projections of block `proj` to p_self / p_nbr [n_points, gt], 128
// columns of [p_self | p_nbr] a phase. Each phase stages its fragments in
// shared memory once; a warp takes a tile at a time.
template <int KT>
__global__ void __launch_bounds__(kRowsThreads, 1)
encoder_rows_kernel(const float* __restrict__ x, int c, int n_points,
                    Block merge, bool has_merge, float* __restrict__ cond,
                    Block proj, bool has_proj, float* __restrict__ p_self,
                    float* __restrict__ p_nbr) {
  extern __shared__ float4 wsm[];
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
  const float4* wl = wsm + lane;
  const int n_tiles = (n_points + kTile - 1) / kTile;
  const int phases = has_proj ? 2 * proj.gt / kProjCols : 0;
  constexpr int kProjFrags = KT * kProjCols / 8;
  for (int ph = has_merge ? -1 : 0; ph < phases; ++ph) {
    const float4* src =
        ph < 0 ? merge.merge : proj.proj + 32 * kProjFrags * ph;
    const int n = 32 * (ph < 0 ? KT * KT / 2 + KT / 2 * merge.cdim / 8
                               : kProjFrags);
    __syncthreads();   // every warp is done with the last phase's weights
    for (int i = threadIdx.x; i < n; i += kRowsThreads) wsm[i] = src[i];
    __syncthreads();
    for (int tile = blockIdx.x * kRowsWarps + threadIdx.x / 32;
         tile < n_tiles; tile += gridDim.x * kRowsWarps) {
      const int r0 = tile * kTile;
      float xa[KT][4];
      load_tile(xa, x, c, n_points, r0, g, t2);
      if (ph < 0) {
        merge_tile(xa, wl, merge, cond, n_points, r0, g, t2);
        continue;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float acc[kProjCols / 16][4];
        zero(acc);
        tf32::mma_3x<KT>(acc, xa, wl + 32 * kProjCols / 16 * half,
                         kProjCols / 8);
        // 64 columns lie in p_self or in p_nbr: gt is a multiple of 64
        const int col = kProjCols * ph + kProjCols / 2 * half;
        float* out = col < proj.gt ? p_self + col : p_nbr + (col - proj.gt);
        store_tile(acc, out, proj.gt, n_points, r0, g, t2);
      }
    }
  }
}

// Grid of a persistent launch of `threads` a block over `work` items, a
// warp taking one at a time: the blocks the card holds at once, no more
// than the items fill.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            int work, int* grid) {
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
  const int warps = threads / 32;
  *grid = std::max(1, std::min(sms * per_sm, (work + warps - 1) / warps));
  return cudaSuccess;
}

template <int KT>
cudaError_t launch_rows(const float* x, int c, int n_points,
                        const Block& merge, bool has_merge, float* cond,
                        const Block& proj, bool has_proj, float* p_self,
                        float* p_nbr, cudaStream_t s) {
  const auto kernel = encoder_rows_kernel<KT>;
  const size_t frags = std::max<size_t>(
      has_proj ? KT * kProjCols / 8 : 0,
      has_merge ? KT * KT / 2 + KT / 2 * merge.cdim / 8 : 0);
  const size_t smem = sizeof(float4) * 32 * frags;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, kRowsThreads, smem,
                                    (n_points + kTile - 1) / kTile, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kRowsThreads, smem, s>>>(x, c, n_points, merge, has_merge,
                                          cond, proj, has_proj, p_self,
                                          p_nbr);
  return cudaGetLastError();
}

cudaError_t rows(const float* x, int c, int n_points, const Block& merge,
                 bool has_merge, float* cond, const Block& proj,
                 bool has_proj, float* p_self, float* p_nbr,
                 cudaStream_t s) {
  switch (c) {
    case 3:
      if (has_merge) break;
      return launch_rows<1>(x, c, n_points, merge, false, cond, proj, has_proj,
                            p_self, p_nbr, s);
    case 32:
      return launch_rows<4>(x, c, n_points, merge, has_merge, cond, proj,
                            has_proj, p_self, p_nbr, s);
    case 64:
      return launch_rows<8>(x, c, n_points, merge, has_merge, cond, proj,
                            has_proj, p_self, p_nbr, s);
    case 128:
      return launch_rows<16>(x, c, n_points, merge, has_merge, cond, proj,
                             has_proj, p_self, p_nbr, s);
  }
  return cudaErrorInvalidValue;
}

// The edge launch's shapes for g growth columns, L growth layers and
// odim outputs. Fragments: those of layer j = 1..L-1 ([j g, g]: j g / 8
// k chunks x g / 8 n tiles, k chunk major), then conv_out's ([L g, odim]),
// 32 float4 each.
template <int G, int L, int ODIM>
struct EdgeShape {
  static constexpr int kG = G;
  static constexpr int kL = L;
  static constexpr int kOdim = ODIM;
  static constexpr int kHw = L * G;        // width of [h_0 .. h_{L-1}]
  static constexpr int kGt = kHw + ODIM;   // projection columns
  static constexpr int kGn = G / 8;        // n tiles of a growth layer
  static constexpr int kHt = kHw / 8;      // n tiles of [h_0 .. h_{L-1}]
  static constexpr int kOn = ODIM / 8;     // n tiles of conv_out
  static constexpr int kOutPass = kOn < kOutTiles ? kOn : kOutTiles;
  __host__ __device__ static constexpr int layer_frag(int j) {
    return kGn * kGn * (j - 1) * j / 2;
  }
  static constexpr int kOutFrag = layer_frag(L);
  static constexpr int kFrags = kOutFrag + kHt * kOn;
  static constexpr size_t kSmem = sizeof(float4) * 32 * kFrags;
  static_assert(G % 8 == 0 && ODIM % (8 * kOutPass) == 0, "widths");
};

// The edge terms p_self[p] + p_nbr[q] of one n8 tile at column `col` for
// a lane's rows g and g + 8 (ps, pn0, pn1 already offset by the lane's
// columns 2t).
__device__ __forceinline__ void edge_terms(float (&acc)[4], const float* ps,
                                           const float* pn0, const float* pn1,
                                           int col) {
  const float2 a = ldg2(ps + col);
  const float2 b0 = ldg2(pn0 + col);
  const float2 b1 = ldg2(pn1 + col);
  acc[0] = a.x + b0.x;
  acc[1] = a.y + b0.y;
  acc[2] = a.x + b1.x;
  acc[3] = a.y + b1.y;
}

// Growth layers J..L-1 of one slot tile: h_J = lrelu(e_J + [h_0 ..
// h_{J-1}] W_J + b_J) into h's tiles [J g / 8, (J + 1) g / 8) (bias, like
// ps, pn0 and pn1, offset by the lane's columns).
template <class S, int J>
__device__ __forceinline__ void growth_layers(float (&h)[S::kHt][4],
                                              const float* ps,
                                              const float* pn0,
                                              const float* pn1,
                                              const float* bias,
                                              const float4* wl) {
  float acc[S::kGn][4];
#pragma unroll
  for (int nt = 0; nt < S::kGn; ++nt)
    edge_terms(acc[nt], ps, pn0, pn1, J * S::kG + 8 * nt);
  tf32::mma_3x<J * S::kGn>(acc, h, wl + 32 * S::layer_frag(J), S::kGn);
#pragma unroll
  for (int nt = 0; nt < S::kGn; ++nt) {
    const float2 b = ldg2(bias + J * S::kG + 8 * nt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = acc[nt][i] + (i % 2 ? b.y : b.x);
      h[J * S::kGn + nt][i] = v > 0.f ? v : 0.05f * v;   // lrelu 0.05
    }
  }
  if constexpr (J + 1 < S::kL)
    growth_layers<S, J + 1>(h, ps, pn0, pn1, bias, wl);
}

// Block `S` over n_points points of k slots (k a multiple of 16): a warp a
// point, the weights' B fragments resident in shared memory -> pooled
// [n_points, odim].
template <class S>
__global__ void __launch_bounds__(kEdgeThreads, 1)
encoder_edge_kernel(const float* __restrict__ p_self,
                    const float* __restrict__ p_nbr,
                    const int64_t* __restrict__ idx, int idx_stride, int n,
                    int k, int n_points, const float4* __restrict__ frags,
                    const float* __restrict__ bias,
                    float* __restrict__ pooled) {
  extern __shared__ float4 wsm[];
  for (int i = threadIdx.x; i < 32 * S::kFrags; i += kEdgeThreads)
    wsm[i] = frags[i];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
  const float4* wl = wsm + lane;
  const float* bl = bias + t2;
  for (int p = blockIdx.x * kEdgeWarps + threadIdx.x / 32; p < n_points;
       p += gridDim.x * kEdgeWarps) {
    const float* ps = p_self + static_cast<size_t>(p) * S::kGt + t2;
    const int64_t base = static_cast<int64_t>(p / n) * n;
    const int64_t* nbrs = idx + static_cast<int64_t>(p) * idx_stride;
    float* out = pooled + static_cast<size_t>(p) * S::kOdim + t2;
    for (int s0 = 0; s0 < k; s0 += kTile) {
      const float* pn0 =
          p_nbr + static_cast<size_t>(base + nbrs[s0 + g]) * S::kGt + t2;
      const float* pn1 =
          p_nbr + static_cast<size_t>(base + nbrs[s0 + g + 8]) * S::kGt + t2;
      float h[S::kHt][4];
      growth_layers<S, 0>(h, ps, pn0, pn1, bl, wl);
      for (int c0 = 0; c0 < S::kOn; c0 += S::kOutPass) {
        float acc[S::kOutPass][4];
#pragma unroll
        for (int nt = 0; nt < S::kOutPass; ++nt)
          edge_terms(acc[nt], ps, pn0, pn1, S::kHw + 8 * (c0 + nt));
        tf32::mma_3x<S::kHt>(acc, h, wl + 32 * (S::kOutFrag + c0), S::kOn);
        // max over the 16 rows: a lane's two, then lanes 4, 8, 16 apart;
        // the bias after the max (rounding is monotonic: the same value)
#pragma unroll
        for (int nt = 0; nt < S::kOutPass; ++nt) {
          float m0 = fmaxf(acc[nt][0], acc[nt][2]);
          float m1 = fmaxf(acc[nt][1], acc[nt][3]);
#pragma unroll
          for (int d = 4; d < 32; d *= 2) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, d));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, d));
          }
          if (g != nt) continue;  // lanes 4 nt .. 4 nt + 3 store tile nt
          const int col = 8 * (c0 + nt);
          const float2 b = ldg2(bl + S::kHw + col);
          float2 v = make_float2(m0 + b.x, m1 + b.y);
          float2* o = reinterpret_cast<float2*>(out + col);
          if (s0 > 0) {
            const float2 prev = *o;
            v = make_float2(fmaxf(v.x, prev.x), fmaxf(v.y, prev.y));
          }
          *o = v;
        }
      }
    }
  }
}

template <class S>
cudaError_t launch_edge(const float* p_self, const float* p_nbr,
                        const int64_t* idx, int idx_stride, int n, int k,
                        int n_points, const Block& b, float* pooled,
                        cudaStream_t s) {
  const auto kernel = encoder_edge_kernel<S>;
  int grid = 0;
  cudaError_t err =
      persistent_grid(kernel, kEdgeThreads, S::kSmem, n_points, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kEdgeThreads, S::kSmem, s>>>(
      p_self, p_nbr, idx, idx_stride, n, k, n_points, b.edge, b.bias,
      pooled);
  return cudaGetLastError();
}

// The (g, n_layers, odim) of the model's blocks (discrete.py:
// GROWTH_WIDTHS, FEAT_CHANNELS; n_layers = odim / g).
using Edge0 = EdgeShape<8, 4, 32>;
using Edge1 = EdgeShape<16, 4, 64>;
using Edge2 = EdgeShape<32, 4, 128>;

template <class S>
bool is_shape(const Block& b) {
  return b.g == S::kG && b.n_layers == S::kL && b.odim == S::kOdim;
}

cudaError_t edge(const float* p_self, const float* p_nbr, const int64_t* idx,
                 int idx_stride, int n, int k, int n_points, const Block& b,
                 float* pooled, cudaStream_t s) {
  if (is_shape<Edge0>(b))
    return launch_edge<Edge0>(p_self, p_nbr, idx, idx_stride, n, k, n_points,
                              b, pooled, s);
  if (is_shape<Edge1>(b))
    return launch_edge<Edge1>(p_self, p_nbr, idx, idx_stride, n, k, n_points,
                              b, pooled, s);
  if (is_shape<Edge2>(b))
    return launch_edge<Edge2>(p_self, p_nbr, idx, idx_stride, n, k, n_points,
                              b, pooled, s);
  return cudaErrorInvalidValue;
}

bool fill_block(Block* b, const float* w, const int* meta) {
  b->c = meta[0];
  b->g = meta[1];
  b->n_layers = meta[2];
  b->odim = meta[3];
  b->cdim = meta[4];
  b->gt = b->n_layers * b->g + b->odim;
  b->bias = w + meta[5];
  b->m_b1 = w + meta[6];
  b->proj = reinterpret_cast<const float4*>(w + meta[7]);
  b->merge = reinterpret_cast<const float4*>(w + meta[8]);
  b->edge = reinterpret_cast<const float4*>(w + meta[9]);
  const bool edge_ok = is_shape<Edge0>(*b) || is_shape<Edge1>(*b) ||
                       is_shape<Edge2>(*b);
  return edge_ok && meta[7] % 4 == 0 && meta[8] % 4 == 0 &&
         meta[9] % 4 == 0 && b->cdim % (8 * kCondTiles) == 0 &&
         b->gt % (kProjCols / 2) == 0;
}

}  // namespace
}  // namespace puflow

// xyz [n_points, 3] (patches of n points), idx [n_points, >= k] int64
// (row stride idx_stride, neighbours within the patch, k a multiple of
// 16) -> conditions out_ptrs[b] [n_points, cdim_b]. meta holds nblocks x
// kMeta host ints; weights must be 16-byte aligned; scratch holds
// n_points * (2 * 256 + 128) floats.
extern "C" int puflow_encoder(const void* xyz, const void* idx, int idx_stride,
                              int n_points, int n, int k, const void* weights,
                              const void* meta, int nblocks,
                              const void* out_ptrs, void* scratch,
                              void* stream) {
  using namespace puflow;
  if (nblocks < 1 || nblocks > 8 || k < 1 || k > kMaxK || k % kTile != 0 ||
      n < 1 || n_points % n != 0 ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0)
    return cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(weights);
  const int* m = static_cast<const int*>(meta);
  const long long* outs = static_cast<const long long*>(out_ptrs);
  Block blocks[8];
  int c = 3;
  for (int b = 0; b < nblocks; ++b) {
    if (!fill_block(&blocks[b], w, m + b * kMeta) || blocks[b].c != c)
      return cudaErrorInvalidValue;
    c = blocks[b].odim;
  }
  if (n_points == 0) return cudaSuccess;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p_self = static_cast<float*>(scratch);
  float* p_nbr = p_self + static_cast<size_t>(n_points) * kMaxGt;
  float* pooled = p_nbr + static_cast<size_t>(n_points) * kMaxGt;
  const float* x = static_cast<const float*>(xyz);
  c = 3;
  for (int b = 0; b <= nblocks; ++b) {
    const bool has_merge = b > 0;
    const bool has_proj = b < nblocks;
    const Block& prev = blocks[has_merge ? b - 1 : 0];
    const Block& cur = blocks[has_proj ? b : 0];
    cudaError_t err =
        rows(x, c, n_points, prev, has_merge,
             has_merge ? reinterpret_cast<float*>(outs[b - 1]) : nullptr, cur,
             has_proj, p_self, p_nbr, s);
    if (err != cudaSuccess) return err;
    if (!has_proj) break;
    err = edge(p_self, p_nbr, static_cast<const int64_t*>(idx), idx_stride, n,
               k, n_points, cur, pooled, s);
    if (err != cudaSuccess) return err;
    x = pooled;
    c = cur.odim;
  }
  return cudaSuccess;
}
