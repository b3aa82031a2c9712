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
//   growth layers j < L: h_j = lrelu_0.05(e_j + b_j + [h_0 .. h_{j-1}] W_j)
//   conv_out:            f = e_out + b_out + [h_0 .. h_{L-1}] W_out
//   pooled[p] = max over the slots of f; condition = relu(pooled W1 + b1) W2
// Plain version: `encoder_conditions_plain` in puflow_torch/ops/encoder.py
// (the port's `discrete.feat_extract` on folded params).
//
// What bounds it on the H100: FP32 FMAs. About 477 M multiply-adds per
// 256-point patch, nearly all in the growth layers and conv_out over the
// n x 16 edge rows; the TPU kernel's single-pass bf16 (FAST_PRECISION) was
// an MXU speed choice, and this kernel computes the exact f32 function
// that it approximates, so it meets the JAX package's exact bounds.
//
// Design: as in the TPU kernel, the [n x 16, <= 256] edge activations of
// a block never reach device memory. Each encoder block runs two launches:
//   rows: per tile of 128 points, the previous block's merge MLP (its
//     condition) and this block's self / neighbour projections x W_self,
//     x W_nbr, written to scratch [points, Gt] (the gather commutes with
//     the projection, so each point is projected once, not 16 times);
//   edge: per tile of 8 points x 16 slots, the edge terms (two scratch
//     rows added; the neighbour rows come in by cp.async), the growth
//     layers and conv_out in shared memory, the max over the slots, and
//     the pooled [8, odim] rows to scratch.
// A final rows launch runs block 5's merge. Weights stream through a 16 KB
// shared chunk (dense.cuh): the [128, 256] f32 projections of blocks 2-5
// are 128 KB each and never sit in shared memory at once. A tile takes
// 219 KB of shared memory, one block per SM. Of 256 and 512 threads a
// block, 512 timed faster on the H100, though at 128 registers a thread
// the compiler spills a few hundred bytes.

#include <algorithm>
#include <cstdint>

#include "dense.cuh"

namespace puflow {
namespace {

using dense::kRows;
using dense::kWbuf;

constexpr int kThreads = 512;

constexpr int kMaxLayers = 8;   // growth layers of a block
constexpr int kMaxC = 128;      // widest block input
constexpr int kMaxGt = 256;     // projection columns of a block
constexpr int kColBlock = 128;  // projection columns per layer call
constexpr int kWarps = kThreads / 32;
// Per block, the host passes kMeta ints: c, g, n_layers, odim, cdim, and
// float offsets into the weights of W_self [c][gt], W_nbr [c][gt], the
// merge's W1 [odim][odim/2], b1 [odim/2], W2 [odim/2][cdim], then the
// biases of layers 0..n_layers (n_layers = conv_out), then the rows of
// W_j that multiply the earlier layers' outputs, [j g][g] for layers
// 1..n_layers - 1 and [n_layers g][odim] for conv_out.
constexpr int kMeta = 10 + 2 * (kMaxLayers + 1);

// 16-byte copy from global to shared memory that bypasses the registers
// (sm_80+); cp_async_wait_all waits for every copy this thread issued.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

struct Block {
  int c, g, n_layers, odim, cdim, gt;
  const float* w_self;
  const float* w_nbr;
  const float* m_w1;
  const float* m_b1;
  const float* m_w2;
  const float* bias[kMaxLayers + 1];
  const float* w_h[kMaxLayers + 1];  // w_h[0] is unused
};

// Merge MLP of block `merge` (its condition, rows of `cond`) and the
// projections of block `proj`, both from one tile of block inputs x.
__global__ void __launch_bounds__(kThreads, 1)
encoder_rows_kernel(const float* __restrict__ x, int c, int n_points,
                    Block merge, bool has_merge, float* __restrict__ cond,
                    Block proj, bool has_proj, float* __restrict__ p_self,
                    float* __restrict__ p_nbr) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = c | 1;
  const int hid = has_merge ? merge.odim / 2 : 0;
  const int ldh = hid | 1;
  float* xs = smem;                     // [kRows][ldx] block inputs
  float* hs = xs + kRows * ldx;         // [kRows][ldh] merge hidden
  float* wbuf = hs + kRows * ldh;       // [kWbuf]

  const int t = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kRows;
  const int rows = min(kRows, static_cast<int>(n_points - row0));
  for (int r = t / 32; r < kRows; r += kWarps)
    for (int col = t % 32; col < c; col += 32)
      xs[r * ldx + col] = r < rows ? x[(row0 + r) * c + col] : 0.f;
  __syncthreads();

  if (has_merge) {
    dense::layer_n<kThreads, dense::kRelu, false>(
        hid, xs, ldx, c, merge.m_w1, hid, merge.m_b1, nullptr, 0, hs, ldh,
        kRows, wbuf);
    __syncthreads();
    dense::layer_n<kThreads, dense::kNone, false>(
        merge.cdim, hs, ldh, hid, merge.m_w2, merge.cdim, nullptr, nullptr, 0,
        cond + row0 * merge.cdim, merge.cdim, rows, wbuf);
  }
  if (has_proj) {
    for (int cb = 0; cb < proj.gt; cb += kColBlock) {
      const int w = min(kColBlock, proj.gt - cb);
      dense::layer_n<kThreads, dense::kNone, false>(
          w, xs, ldx, c, proj.w_self + cb, proj.gt, nullptr, nullptr, 0,
          p_self + row0 * proj.gt + cb, proj.gt, rows, wbuf);
      dense::layer_n<kThreads, dense::kNone, false>(
          w, xs, ldx, c, proj.w_nbr + cb, proj.gt, nullptr, nullptr, 0,
          p_nbr + row0 * proj.gt + cb, proj.gt, rows, wbuf);
    }
  }
}

// One tile of kRows / k points x k slots of block `blk`: edge terms, the
// growth layers, conv_out and the max over the slots -> pooled rows.
__global__ void __launch_bounds__(kThreads, 1)
encoder_edge_kernel(const float* __restrict__ p_self,
                    const float* __restrict__ p_nbr,
                    const int64_t* __restrict__ idx, int idx_stride, int n,
                    int k, int n_points, Block blk,
                    float* __restrict__ pooled) {
  extern __shared__ __align__(16) float smem[];
  const int gt = blk.gt;
  const int hw = blk.n_layers * blk.g;  // width of [h_0 .. h_{L-1}]
  const int lde = gt + 4;               // 16-byte rows for cp.async
  const int ldh = hw | 1;
  const int ppt = kRows / k;            // points per tile
  float* es = smem;                     // [kRows][lde] edge terms
  float* hs = es + kRows * lde;         // [kRows][ldh] growth outputs
  float* wbuf = hs + kRows * ldh;       // [kWbuf]
  float* ps = wbuf + kWbuf;             // [ppt][gt] self projections

  const int t = threadIdx.x;
  const int p0 = blockIdx.x * ppt;
  const int np = min(ppt, n_points - p0);
  const int rows = np * k;

  // edge terms: cp.async brings each slot's neighbour row of p_nbr and each
  // point's row of p_self into shared memory, every copy in flight at once
  // and none through registers; then each point's self row is added to
  // its slots. A warp walks rows, its lanes 16-byte columns, so the index
  // arithmetic runs once a row. Padding rows are zero.
  const int warp = t / 32;
  const int c0 = 4 * (t % 32);
  for (int r = warp; r < kRows; r += kWarps) {
    float* dst = es + r * lde;
    if (r < rows) {
      const int pl = r / k;
      const int p = p0 + pl;
      const int64_t q =
          static_cast<int64_t>(p / n) * n +
          idx[static_cast<int64_t>(p) * idx_stride + (r - pl * k)];
      const float* src = p_nbr + static_cast<size_t>(q) * gt;
      for (int c = c0; c < gt; c += 128) cp_async16(dst + c, src + c);
    } else {
      for (int c = c0; c < gt; c += 128)
        *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int pl = warp; pl < np; pl += kWarps) {
    const float* src = p_self + static_cast<size_t>(p0 + pl) * gt;
    for (int c = c0; c < gt; c += 128) cp_async16(ps + pl * gt + c, src + c);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int r = warp; r < rows; r += kWarps) {
    const float* a_row = ps + (r / k) * gt;
    for (int c = c0; c < gt; c += 128) {
      float4* e = reinterpret_cast<float4*>(es + r * lde + c);
      const float4 a = *reinterpret_cast<const float4*>(a_row + c);
      const float4 b = *e;
      *e = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
  }
  __syncthreads();

  // growth layers; layer j reads h columns [0, j g) and writes [j g, (j+1) g)
  for (int j = 0; j < blk.n_layers; ++j) {
    dense::layer_n<kThreads, dense::kLrelu05, true>(
        blk.g, hs, ldh, j * blk.g, blk.w_h[j], blk.g, blk.bias[j],
        es + j * blk.g, lde, hs + j * blk.g, ldh, kRows, wbuf);
    __syncthreads();
  }
  // conv_out, in place over its edge terms
  float* fs = es + hw;
  dense::layer_n<kThreads, dense::kNone, true>(
      blk.odim, hs, ldh, hw, blk.w_h[blk.n_layers], blk.odim,
      blk.bias[blk.n_layers], fs, lde, fs, lde, kRows, wbuf);
  __syncthreads();

  // max over the k slots of each point
  for (int i = t; i < np * blk.odim; i += kThreads) {
    const int pl = i / blk.odim;
    const int o = i - pl * blk.odim;
    const float* f = fs + pl * k * lde + o;
    float m = f[0];
    for (int s = 1; s < k; ++s) m = fmaxf(m, f[s * lde]);
    pooled[static_cast<size_t>(p0 + pl) * blk.odim + o] = m;
  }
}

bool fill_block(Block* b, const float* w, const int* meta) {
  b->c = meta[0];
  b->g = meta[1];
  b->n_layers = meta[2];
  b->odim = meta[3];
  b->cdim = meta[4];
  b->gt = b->n_layers * b->g + b->odim;
  b->w_self = w + meta[5];
  b->w_nbr = w + meta[6];
  b->m_w1 = w + meta[7];
  b->m_b1 = w + meta[8];
  b->m_w2 = w + meta[9];
  if (b->n_layers < 1 || b->n_layers > kMaxLayers) return false;
  for (int j = 0; j <= b->n_layers; ++j) {
    b->bias[j] = w + meta[10 + j];
    b->w_h[j] = j == 0 ? nullptr : w + meta[10 + kMaxLayers + 1 + j];
  }
  const bool gt_ok = b->gt <= kMaxGt &&
                     (b->gt % kColBlock == 0 ||
                      dense::supported_width(b->gt % kColBlock));
  return b->c >= 1 && b->c <= kMaxC && dense::supported_width(b->g) &&
         dense::supported_width(b->odim) &&
         dense::supported_width(b->odim / 2) && b->odim % 2 == 0 &&
         dense::supported_width(b->cdim) && gt_ok;
}

size_t rows_smem(int c, int hid) {
  return sizeof(float) * (kRows * ((c | 1) + (hid | 1)) + kWbuf);
}

size_t edge_smem(const Block& b, int k) {
  return sizeof(float) * (kRows * (b.gt + 4 + ((b.n_layers * b.g) | 1)) +
                          kWbuf + kRows / k * b.gt);
}

}  // namespace
}  // namespace puflow

// xyz [n_points, 3] (patches of n points), idx [n_points, >= k] int64
// (row stride idx_stride, neighbours within the patch) -> conditions
// out_ptrs[b] [n_points, cdim_b]. meta holds nblocks x kMeta host ints;
// scratch holds n_points * (2 * 256 + 128) floats.
extern "C" int puflow_encoder(const void* xyz, const void* idx, int idx_stride,
                              int n_points, int n, int k, const void* weights,
                              const void* meta, int nblocks,
                              const void* out_ptrs, void* scratch,
                              void* stream) {
  using namespace puflow;
  if (nblocks < 1 || nblocks > 8 || k < 1 || k > kRows || n < 1 ||
      n_points % n != 0)
    return cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(weights);
  const int* m = static_cast<const int*>(meta);
  const long long* outs = static_cast<const long long*>(out_ptrs);
  Block blocks[8];
  size_t rows_bytes = 0, edge_bytes = 0;
  int c = 3;
  for (int b = 0; b < nblocks; ++b) {
    if (!fill_block(&blocks[b], w, m + b * kMeta) || blocks[b].c != c)
      return cudaErrorInvalidValue;
    rows_bytes = std::max(rows_bytes, rows_smem(c, b ? c / 2 : 0));
    edge_bytes = std::max(edge_bytes, edge_smem(blocks[b], k));
    c = blocks[b].odim;
  }
  rows_bytes = std::max(rows_bytes, rows_smem(c, c / 2));
  if (rows_bytes > static_cast<size_t>(dense::kMaxSmem) ||
      edge_bytes > static_cast<size_t>(dense::kMaxSmem))
    return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      encoder_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rows_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(encoder_edge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(edge_bytes));
  if (err != cudaSuccess) return err;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p_self = static_cast<float*>(scratch);
  float* p_nbr = p_self + static_cast<size_t>(n_points) * kMaxGt;
  float* pooled = p_nbr + static_cast<size_t>(n_points) * kMaxGt;
  const int rows_grid = (n_points + kRows - 1) / kRows;
  const int ppt = kRows / k;
  const int edge_grid = (n_points + ppt - 1) / ppt;
  const float* x = static_cast<const float*>(xyz);
  c = 3;
  for (int b = 0; b <= nblocks; ++b) {
    const bool has_merge = b > 0;
    const bool has_proj = b < nblocks;
    const Block& prev = blocks[has_merge ? b - 1 : 0];
    const Block& cur = blocks[has_proj ? b : 0];
    encoder_rows_kernel<<<rows_grid, kThreads,
                          rows_smem(c, has_merge ? c / 2 : 0), s>>>(
        x, c, n_points, prev, has_merge,
        has_merge ? reinterpret_cast<float*>(outs[b - 1]) : nullptr, cur,
        has_proj, p_self, p_nbr);
    if (!has_proj) break;
    encoder_edge_kernel<<<edge_grid, kThreads, edge_smem(cur, k), s>>>(
        p_self, p_nbr, static_cast<const int64_t*>(idx), idx_stride, n, k,
        n_points, cur, pooled);
    x = pooled;
    c = cur.odim;
  }
  return cudaGetLastError();
}
