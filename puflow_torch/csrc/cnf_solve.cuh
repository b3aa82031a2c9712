// The dopri5 solve kernel of one CNF block, `solve_kernel`, and its launch
// in either mode: the whole solve in one cooperative launch (kSplit false,
// cnf_solve.cu's entries) or one attempt a launch (kSplit true,
// cnf_solve_attempt.cu's entry, data parallel). Each mode is compiled in
// its own source, so that nvcc builds the two sets of instantiations side
// by side. The design is described in cnf_solve.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "cnf_field.cuh"

namespace cg = cooperative_groups;

namespace puflow {

// The blocks of the one-launch `solve_kernel<kTrace, kHalves, kTable,
// false>` that fit the current card at once (defined in cnf_solve.cu):
// the grid of either mode.
cudaError_t solve_resident_blocks(bool trace, int halves, bool table,
                                  int* blocks);

namespace {

using namespace cnf_field;

// Warps a block (one block an SM fills shared memory; timed by
// scripts/cnf_solve_variants.py).
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;      // cards a process may launch on
constexpr int kLdA = kH + 8;         // the A operand's row stride (16 rows)

// A warp's tile and shared memory. kHalves: the rows a lane takes, g and
// g + 8 of an m16 row tile (2: tiles of 16 rows), or g alone (1: tiles of
// 8 rows and half the A rows zero, twice the warps at a given R; the
// launch takes them where they all fit the card at once). kTable: the
// gates of layers 1 and 2 come from a table made once a condition row
// and stage time (r > 1), else each row computes its own in place (r = 1:
// a table would save no sigmoid, and at 16-row tiles a block's tables of
// 16 condition rows would outgrow shared memory). Both are template
// parameters, so that no evaluation branches on them.
template <bool kTrace, int kHalves, bool kTable>
struct Layout {
  static constexpr int kRows = 8 * kHalves;   // a tile's rows
  static constexpr int kCh = kTrace ? 4 : 3;
  // the tile's condition rows' projections (kRows of them at r = 1, at
  // most kRows / 2 + 1 at r > 1), then the gate table of layers 1 and 2
  static constexpr int kConds = kTable ? kRows / 2 + 1 : kRows;
  static constexpr int kTableOff = kConds * kProj;
  static constexpr int kProjFloats = kTableOff + (kTable ? kConds * 2 * kH
                                                         : 0);
  static_assert(kTableOff % 2 == 0 && kProj % 2 == 0, "float2 alignment");
  // W2's pre-split fragments, the small weights, then each warp's A,
  // projections, stages, state and input; the warps' partial sums and the
  // controller's scalars
  static constexpr int kWarpFloats =
      16 * kLdA + kProjFloats + 9 * kRows * kCh;
  static constexpr int kFloats =
      2 * kFrag + kOwnW + kWarps * kWarpFloats + 2 * kWarps + 8;
};

struct SolveArgs {
  const float* y0;       // [n_rows, 3]
  const float* logp0;    // [n_rows] (the log-density solve)
  const float* proj;     // [n_rows / rep, kProj]
  const float* weights;  // [kFragOff + 2 kFrag] (`_field_weights`)
  const float* t01;      // t0, t1
  float* state;          // y[, logp] [2][n_rows][kCh], then k1 the same
  double* partials;      // [2][gridDim.x]
  float* out_y;          // [n_rows, 3]
  float* out_logp;       // [n_rows] (the log-density solve)
  int* stats;            // steps attempted, steps accepted
  int n_rows, rep, max_steps;
  float rtol, atol;
  // the per-attempt mode: this launch's attempt, every rank's (sum,
  // count) of the previous attempt in rank order, the control blocks
  // ([2][8] ints, then the blocks' ticket) and this rank's (sum, count)
  int attempt, world;
  const double* exchange;  // [world][2]
  int* ctrl;
  double* local;           // [2]
};

// A warp's tile: its shared memory and which condition row its lane's
// rows read.
struct Tile {
  float* a;             // [16][kLdA] the A operand of the products
  float* proj;          // [<= kRows][kProj], the gate table at kTableOff
  float* ks;            // [7][kRows][kCh] the stages
  float* ys;            // [kRows][kCh] the state
  float* xin;           // [kRows][kCh] a stage's input
  int cl[2];            // local condition row of rows g and g + 8
};

// The f32 pair (columns j, j + 1) of a row of shared memory.
__device__ __forceinline__ float2 pair(const float* p, int j) {
  return *reinterpret_cast<const float2*>(p + j);
}

// The gates of a column pair: read from the gate table g, or computed
// here from the projections g.
template <bool kTable>
__device__ __forceinline__ float2 gates(float t, const float* g, int j,
                                        float2 gt) {
  const float2 v = pair(g, j);
  if constexpr (kTable)
    return v;
  else
    return make_float2(gate(t, gt.x, v.x), gate(t, gt.y, v.y));
}

// The gate table of layers 1 and 2 at time t: for each of the tile's
// `n_cond` condition rows (at most kConds), 64 gates of layer 1 then 64 of
// layer 2; lane l takes entries l, l + 32, ... (unrolled: its gates'
// chains side by side).
template <int kConds, int kTableOff>
__device__ __forceinline__ void gate_table(const float* w, const Tile& tl,
                                           float t, int n_cond, int lane) {
#pragma unroll
  for (int i = 0; i < kConds * 2 * kH / 32; ++i) {
    const int e = lane + 32 * i;
    const int cl = e / (2 * kH), j = e % (2 * kH);
    const int layer = j / kH, col = j % kH;
    if (cl < n_cond)
      tl.proj[kTableOff + e] =
          gate(t, w[(layer ? oV2 : oV1) + kH + col],
               tl.proj[cl * kProj + 2 * kH * layer + col]);
  }
}

// One field evaluation of a warp's tile at time t: xin [kRows][kCh] ->
// kout [kRows][kCh], f in channels 0..2 and, with kTrace, -div in channel
// 3. Lane (g, t) holds rows g and g + 8 and columns 8 n + 2t, 8 n + 2t + 1
// of the hidden layers (C-fragment index 2 h + e: row g + 8 h, column
// 8 n + 2t + e). Sums over the 64 columns: a lane's own in the order n, e,
// then its quad's butterfly. The caller synchronises the warp before
// (xin) and after (kout).
template <bool kTrace, int kHalves, bool kTable>
__device__ __forceinline__ void field(const float* __restrict__ w,
                                      const float4* __restrict__ w2,
                                      const Tile& tl, float t,
                                      const float* xin, float* kout) {
  using L = Layout<kTrace, kHalves, kTable>;
  constexpr int kCh = L::kCh, kTableOff = L::kTableOff;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const float* pr[kHalves];
  // the gates of layer l of row half h: from pr[h] + 2 kH l, or the table
  const float* gs[kHalves][2];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      pr[h] = tl.proj + tl.cl[h] * kProj;
      gs[h][l] = kTable ? tl.proj + kTableOff + tl.cl[h] * 2 * kH + kH * l
                        : pr[h] + 2 * kH * l;
    }
  float y[kHalves][3];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c) y[h][c] = xin[(g + 8 * h) * kCh + c];

  // layer 1 into the lane's cells of A; with the trace s1 (1 - x1^2)
  float sm1[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int j = 8 * n + 2 * tq;
    const float2 w0 = pair(w + oW1, j), w1 = pair(w + oW1 + kH, j),
                 w2r = pair(w + oW1 + 2 * kH, j), b = pair(w + oV1, j),
                 gt = pair(w + oV1 + kH, j), bt = pair(w + oV1 + 2 * kH, j);
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const float2 s = gates<kTable>(t, gs[h][0], j, gt);
      const float2 bc = pair(pr[h] + kH, j);
      const float hx = fmaf(y[h][2], w2r.x,
                            fmaf(y[h][1], w1.x, y[h][0] * w0.x)) + b.x;
      const float hy = fmaf(y[h][2], w2r.y,
                            fmaf(y[h][1], w1.y, y[h][0] * w0.y)) + b.y;
      const float xx = tanhf(fmaf(hx, s.x, fmaf(t, bt.x, bc.x)));
      const float xy = tanhf(fmaf(hy, s.y, fmaf(t, bt.y, bc.y)));
      *reinterpret_cast<float2*>(tl.a + (g + 8 * h) * kLdA + j) =
          make_float2(xx, xy);
      if constexpr (kTrace) {
        sm1[n][2 * h] = s.x * (1.f - xx * xx);
        sm1[n][2 * h + 1] = s.y * (1.f - xy * xy);
      }
    }
  }
  // layer 2: x1 W2 on the tensor cores, its epilogue, and layer 3's
  // partial sums (rows g, g + 8; channels 0..2)
  float acc[1][8][4];
  product<1, 8, kLdA>(acc, tl.a, w2 + lane, lane);
  float p3[kHalves][3] = {};
  float s2[kTrace ? 8 : 1][4], m2[kTrace ? 8 : 1][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int j = 8 * n + 2 * tq;
    const float2 b = pair(w + oV2, j), gt = pair(w + oV2 + kH, j),
                 bt = pair(w + oV2 + 2 * kH, j);
    // W3 rows j and j + 1: (j, 0) (j, 1) | (j, 2) (j + 1, 0) | (j + 1, 1)
    // (j + 1, 2)
    const float2 wa = pair(w + oW3, 3 * j), wb = pair(w + oW3, 3 * j + 2),
                 wc = pair(w + oW3, 3 * j + 4);
    const float w3[2][3] = {{wa.x, wa.y, wb.x}, {wb.y, wc.x, wc.y}};
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const float2 s = gates<kTable>(t, gs[h][1], j, gt);
      const float2 bc = pair(pr[h] + 3 * kH, j);
      const float sv[2] = {s.x, s.y}, bv[2] = {b.x, b.y},
                  btv[2] = {bt.x, bt.y}, bcv[2] = {bc.x, bc.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float h2 = acc[0][n][2 * h + e] + bv[e];
        const float x2 = tanhf(fmaf(h2, sv[e], fmaf(t, btv[e], bcv[e])));
#pragma unroll
        for (int c = 0; c < 3; ++c) p3[h][c] = fmaf(x2, w3[e][c], p3[h][c]);
        if constexpr (kTrace) {
          s2[n][2 * h + e] = sv[e];
          m2[n][2 * h + e] = 1.f - x2 * x2;
        }
      }
    }
  }
  // with the trace, the diagonal v3_k[k] of each tangent chain: u1_k W2 on
  // the tensor cores (u1_k written over x1's cells), then u2_k = (v2_k s2)
  // (1 - x2^2) against W3's column k
  float v3[3][kHalves];
  if constexpr (kTrace) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = 8 * n + 2 * tq;
        const float2 wk = pair(w + oW1 + k * kH, j);
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          *reinterpret_cast<float2*>(tl.a + (g + 8 * h) * kLdA + j) =
              make_float2(wk.x * sm1[n][2 * h], wk.y * sm1[n][2 * h + 1]);
      }
      product<1, 8, kLdA>(acc, tl.a, w2 + lane, lane);
      float v[kHalves] = {};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = 8 * n + 2 * tq;
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[h] = fmaf(acc[0][n][2 * h + e] * s2[n][2 * h + e] *
                            m2[n][2 * h + e],
                        w[oW3 + 3 * (j + e) + k], v[h]);
      }
#pragma unroll
      for (int h = 0; h < kHalves; ++h) v3[k][h] = quad_sum(v[h]);
    }
  }
  float h3[kHalves][3];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c) h3[h][c] = quad_sum(p3[h][c]);
  // layer 3's epilogue: lane t of a quad takes outputs q = t and t + 4 of
  // its rows' six (q < 3: row g, channel q; else row g + 8, channel q - 3);
  // the sums picked by unrolled compares, so that they stay in registers
  float d[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = tq + 4 * i;
    if (q < 3 * kHalves) {
      const int h = q / 3, c = q % 3;
      float hs = 0.f, vs = 0.f;
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          if (q == 3 * hh + cc) {
            hs = h3[hh][cc];
            if constexpr (kTrace) vs = v3[cc][hh];
          }
      const float* p = (h ? pr[kHalves - 1] : pr[0]) + 4 * kH;
      const float s3 = gate(t, w[oV3 + 3 + c], p[c]);
      kout[(g + 8 * h) * kCh + c] =
          fmaf(hs + w[oV3 + c], s3, fmaf(t, w[oV3 + 6 + c], p[3 + c]));
      if constexpr (kTrace) d[i] = vs * s3;
    }
  }
  if constexpr (kTrace) {
    // -div of row g from the quad's q = 0, 1, 2, of row g + 8 from q = 3,
    // 4, 5, summed in channel order
    const int base = lane & ~3;
    const float d0 = __shfl_sync(0xffffffffu, d[0], base);
    const float d1 = __shfl_sync(0xffffffffu, d[0], base + 1);
    const float d2 = __shfl_sync(0xffffffffu, d[0], base + 2);
    const float d3 = __shfl_sync(0xffffffffu, d[0], base + 3);
    const float d4 = __shfl_sync(0xffffffffu, d[1], base);
    const float d5 = __shfl_sync(0xffffffffu, d[1], base + 1);
    if (tq == 2) kout[g * kCh + 3] = -((d0 + d1) + d2);
    if (kHalves == 2 && tq == 3)
      kout[(g + 8) * kCh + 3] = -((d3 + d4) + d5);
  }
}

template <bool kTrace, int kHalves, bool kTable, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1) solve_kernel(SolveArgs a) {
  using L = Layout<kTrace, kHalves, kTable>;
  constexpr int kRows = L::kRows, kCh = L::kCh, kTile = kRows * kCh;
  extern __shared__ __align__(16) float smem[];
  float4* w2_s = reinterpret_cast<float4*>(smem);   // [kFrag / 2] pre-split
  float* w_s = smem + 2 * kFrag;                    // [kOwnW]
  float* warps = w_s + kOwnW;
  double* red = reinterpret_cast<double*>(warps + kWarps * L::kWarpFloats);
  float* ctrl = reinterpret_cast<float*>(red + kWarps);   // [8]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;
  const int n_state = a.n_rows * kCh;
  const int n_tiles = (a.n_rows + kRows - 1) / kRows;
  const int stride = gridDim.x * kWarps;              // tiles a round
  const int first = warp * gridDim.x + blockIdx.x;    // this warp's first
  float* sbuf = a.state;                              // [2][n_state]
  float* kbuf = a.state + 2 * static_cast<size_t>(n_state);

  Tile tl;
  {
    float* p = warps + warp * L::kWarpFloats;
    tl.a = p;
    tl.proj = p + 16 * kLdA;
    tl.ks = tl.proj + L::kProjFloats;
    tl.ys = tl.ks + 7 * kTile;
    tl.xin = tl.ys + kTile;
  }
  // W2's fragments split once into {hi0, hi1, lo0, lo1}, and the small
  // weights
  {
    const float2* src = reinterpret_cast<const float2*>(a.weights + kFragOff);
    for (int e = tid; e < kFrag / 2; e += kThreads) {
      const tf32::BPair b = tf32::b_pair(__ldg(src + e));
      w2_s[e] = make_float4(b.h0, b.h1, b.l0, b.l1);
    }
    load_small(a.weights, w_s, tid, kThreads);
    for (int e = lane; e < 16 * kLdA; e += 32) tl.a[e] = 0.f;
  }
  __syncthreads();

  // the warp's tile: its condition rows' projections, once while the warp
  // owns one tile
  int loaded = -1, n_cond = 0;
  float table_t = 0.f;
  bool table_ok = false;
  auto take_tile = [&](int tile, int rows) {
    const int row0 = tile * kRows;
    const int cr0 = row0 / a.rep;
    if (tile != loaded) {
      n_cond = (row0 + rows - 1) / a.rep - cr0 + 1;
      for (int e = lane; e < n_cond * (kProj / 2); e += 32) {
        const int cl = e / (kProj / 2), c2 = 2 * (e % (kProj / 2));
        cp8(tl.proj + cl * kProj + c2,
            a.proj + static_cast<size_t>(cr0 + cl) * kProj + c2);
      }
      cp_wait();
      loaded = tile;
      table_ok = false;
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const int r = g + 8 * h;
      tl.cl[h] = r < rows ? (row0 + r) / a.rep - cr0 : 0;
    }
    __syncwarp();
  };
  // the field at a stage time (the table made again only at a new time)
  auto eval = [&](float ts, const float* xin, float* kout) {
    if (kTable && !(table_ok && ts == table_t)) {
      gate_table<L::kConds, L::kTableOff>(w_s, tl, ts, n_cond, lane);
      table_t = ts;
      table_ok = true;
      __syncwarp();
    }
    field<kTrace, kHalves, kTable>(w_s, w2_s, tl, ts, xin, kout);
    __syncwarp();
  };

  const float t0 = __ldg(a.t01), t1 = __ldg(a.t01 + 1);
  const float span = fabsf(t1 - t0);
  const float direction = t1 > t0 ? 1.f : (t1 < t0 ? -1.f : 0.f);

  // k1 = f(t0, y0) for this warp's tiles; state copy 0
  auto first_stage = [&]() {
    for (int tile = first; tile < n_tiles; tile += stride) {
      const int row0 = tile * kRows;
      const int rows = min(kRows, a.n_rows - row0);
      take_tile(tile, rows);
      for (int v = lane; v < kTile; v += 32) {
        const int r = v / kCh, c = v % kCh;
        const size_t row = static_cast<size_t>(row0) + r;
        tl.xin[v] = r >= rows ? 0.f
                    : c < 3   ? __ldg(a.y0 + row * 3 + c)
                              : __ldg(a.logp0 + row);
      }
      __syncwarp();
      eval(t0, tl.xin, tl.ks);
      for (int v = lane; v < rows * kCh; v += 32) {
        const size_t at = static_cast<size_t>(row0) * kCh + v;
        sbuf[at] = tl.xin[v];
        kbuf[at] = tl.ks[v];
      }
      __syncwarp();
    }
  };
  // one attempt from state copy `cur` at (t, h_c): the candidate (y5, k7)
  // into the other copy; returns lane 0's sum of the squared error ratios
  // of this warp's tiles in index order (0 in the other lanes)
  auto attempt = [&](float t, float h_c, int cur) {
    const float* s_cur = sbuf + static_cast<size_t>(cur) * n_state;
    const float* k_cur = kbuf + static_cast<size_t>(cur) * n_state;
    float* s_new = sbuf + static_cast<size_t>(1 - cur) * n_state;
    float* k_new = kbuf + static_cast<size_t>(1 - cur) * n_state;
    double partial = 0.0;
    for (int tile = first; tile < n_tiles; tile += stride) {
      const int row0 = tile * kRows;
      const int rows = min(kRows, a.n_rows - row0);
      take_tile(tile, rows);
      for (int v = lane; v < kTile; v += 32) {
        const size_t at = static_cast<size_t>(row0) * kCh + v;
        const bool valid = v < rows * kCh;
        tl.ys[v] = valid ? __ldcg(s_cur + at) : 0.f;
        tl.ks[v] = valid ? __ldcg(k_cur + at) : 0.f;
      }
      __syncwarp();
      // stages 2..7 (k1 is carried: first same as last)
#pragma unroll 1
      for (int i = 1; i < 7; ++i) {
        for (int v = lane; v < kTile; v += 32) {
          float acc = tl.ks[v] * (kA[i][0] * h_c);
          for (int j = 1; j < i; ++j)
            acc += tl.ks[j * kTile + v] * (kA[i][j] * h_c);
          tl.xin[v] = tl.ys[v] + acc;
        }
        __syncwarp();
        eval(t + kC[i] * h_c, tl.xin, tl.ks + i * kTile);
      }
      float sq = 0.f;
      for (int v = lane; v < rows * kCh; v += 32) {
        float s5 = tl.ks[v] * kB5[0];
        float se = tl.ks[v] * err_weight(0);
#pragma unroll
        for (int j = 1; j < 7; ++j) {
          const float kj = tl.ks[j * kTile + v];
          s5 += kB5[j] * kj;
          se += err_weight(j) * kj;
        }
        const float y = tl.ys[v];
        const float y5 = y + h_c * s5;
        const float r = (h_c * se) /
                        (a.atol + a.rtol * fmaxf(fabsf(y), fabsf(y5)));
        sq += r * r;
        const size_t at = static_cast<size_t>(row0) * kCh + v;
        s_new[at] = y5;
        k_new[at] = tl.ks[6 * kTile + v];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_down_sync(0xffffffffu, sq, off);
      if (lane == 0) partial += static_cast<double>(sq);
      __syncwarp();
    }
    return partial;
  };
  // the block's sum: its warps' partials in index order (thread 0's)
  auto block_partial = [&](double partial) {
    if (lane == 0) red[warp] = partial;
    __syncthreads();
    double block = 0.0;
    if (tid == 0)
      for (int i = 0; i < kWarps; ++i) block += red[i];
    return block;
  };
  // y(t1) [, logp(t1)] from state copy `cur`, and the step counts
  auto finish = [&](int cur, int n, int accepted) {
    const float* s_fin = sbuf + static_cast<size_t>(cur) * n_state;
    for (int tile = first; tile < n_tiles; tile += stride) {
      const int row0 = tile * kRows;
      const int rows = min(kRows, a.n_rows - row0);
      for (int v = lane; v < rows * kCh; v += 32) {
        const size_t row = static_cast<size_t>(row0) + v / kCh;
        const int c = v % kCh;
        const float val = __ldcg(s_fin + row * kCh + c);
        if (c < 3)
          a.out_y[row * 3 + c] = val;
        else
          a.out_logp[row] = val;
      }
    }
    if (blockIdx.x == 0 && tid == 0) {
      a.stats[0] = n;
      a.stats[1] = accepted;
    }
  };

  if constexpr (!kSplit) {
    cg::grid_group grid = cg::this_grid();
    first_stage();
    float t = t0, h = direction * span / 16.f;
    bool done = span <= 1e-12f;
    int n = 0, accepted = 0, cur = 0;
    while (!done && n < a.max_steps) {
      // never step past t1
      const float remaining = t1 - t;
      const float h_c = fabsf(h) > fabsf(remaining) ? remaining : h;
      const double block = block_partial(attempt(t, h_c, cur));
      // then the blocks
      double* part = a.partials + static_cast<size_t>(n & 1) * gridDim.x;
      if (tid == 0) part[blockIdx.x] = block;
      __threadfence();
      grid.sync();
      // every block sums the partials in the same fixed order and decides
      // alike
      if (tid < 32) {
        const double total = grid_total(part, gridDim.x);
        if (tid == 0)
          control(sqrtf(static_cast<float>(
                            total / (static_cast<double>(kCh) * a.n_rows)) +
                        1e-24f),
                  t, h_c, ctrl);
      }
      __syncthreads();
      t = ctrl[0];
      h = ctrl[1];
      if (ctrl[2] != 0.f) {
        cur ^= 1;
        ++accepted;
      }
      done = fabsf(t - t0) >= span - 1e-9f;
      ++n;
    }
    finish(cur, n, accepted);
  } else {
    // the solve's state before this launch's attempt: from scratch at
    // attempt 0, else the previous launch's control block and the
    // decision on its attempt
    float t = t0, h = direction * span / 16.f;
    bool done = span <= 1e-12f;
    int n = 0, accepted = 0, cur = 0;
    if (a.attempt == 0) {
      first_stage();
    } else {
      const int* prev = a.ctrl + 8 * ((a.attempt - 1) & 1);
      t = __int_as_float(prev[0]);
      h = __int_as_float(prev[1]);
      cur = prev[2];
      n = prev[3];
      accepted = prev[4];
      const float remaining = t1 - t;
      const float h_c = fabsf(h) > fabsf(remaining) ? remaining : h;
      if (tid == 0) {
        // every rank's sum and count in rank order
        double total = 0.0, count = 0.0;
        for (int w = 0; w < a.world; ++w) {
          total += a.exchange[2 * w];
          count += a.exchange[2 * w + 1];
        }
        control(sqrtf(static_cast<float>(total / count) + 1e-24f), t, h_c,
                ctrl);
      }
      __syncthreads();
      t = ctrl[0];
      h = ctrl[1];
      if (ctrl[2] != 0.f) {
        cur ^= 1;
        ++accepted;
      }
      done = fabsf(t - t0) >= span - 1e-9f;
      ++n;
    }
    const bool finished = done || n >= a.max_steps;
    if (blockIdx.x == 0 && tid == 0) {
      int* next = a.ctrl + 8 * (a.attempt & 1);
      next[0] = __float_as_int(t);
      next[1] = __float_as_int(h);
      next[2] = cur;
      next[3] = n;
      next[4] = accepted;
      next[5] = finished ? 1 : 0;
    }
    if (finished) {
      finish(cur, n, accepted);
      return;
    }
    const float remaining = t1 - t;
    const float h_c = fabsf(h) > fabsf(remaining) ? remaining : h;
    const double block = block_partial(attempt(t, h_c, cur));
    // the last block to finish sums every block's partial in the fixed
    // order into this rank's (sum, count) and hands the ticket back
    unsigned* ticket = reinterpret_cast<unsigned*>(a.ctrl + 16);
    if (tid == 0) {
      a.partials[blockIdx.x] = block;
      __threadfence();
      ctrl[3] = atomicAdd(ticket, 1u) == gridDim.x - 1 ? 1.f : 0.f;
    }
    __syncthreads();
    if (ctrl[3] != 0.f && tid < 32) {
      __threadfence();
      const double total = grid_total(a.partials, gridDim.x);
      if (tid == 0) {
        a.local[0] = total;
        a.local[1] = static_cast<double>(kCh) * a.n_rows;
        *ticket = 0u;
      }
    }
  }
}

// The per-attempt kernel's shared-memory limit, set once a card.
template <bool kTrace, int kHalves, bool kTable>
cudaError_t allow_split_smem() {
  using L = Layout<kTrace, kHalves, kTable>;
  static std::atomic<bool> set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(solve_kernel<kTrace, kHalves, kTable, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(float) * L::kFloats));
  if (err == cudaSuccess) set[dev].store(true, std::memory_order_relaxed);
  return err;
}

// The one-launch kernel cooperatively, or one launch of the per-attempt
// kernel on the same grid (at least one block: a rank with no rows still
// takes part in every attempt).
template <bool kTrace, int kHalves, bool kTable, bool kSplit>
cudaError_t launch_tiles(const SolveArgs& args, int max_grid,
                         cudaStream_t stream) {
  using L = Layout<kTrace, kHalves, kTable>;
  int blocks = 0;
  cudaError_t err = solve_resident_blocks(kTrace, kHalves, kTable, &blocks);
  if (err != cudaSuccess) return err;
  const int tiles = (args.n_rows + L::kRows - 1) / L::kRows;
  int grid = blocks;
  if (grid > tiles) grid = tiles;
  if (grid > max_grid) grid = max_grid;
  const size_t smem = sizeof(float) * L::kFloats;
  if constexpr (kSplit) {
    if (grid < 1) grid = 1;
    if ((err = allow_split_smem<kTrace, kHalves, kTable>()) != cudaSuccess)
      return err;
    solve_kernel<kTrace, kHalves, kTable, true>
        <<<grid, kThreads, smem, stream>>>(args);
  } else {
    SolveArgs copy = args;
    void* params[] = {&copy};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(solve_kernel<kTrace, kHalves, kTable, false>),
        dim3(grid), dim3(kThreads), params, smem, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <bool kTrace, bool kTable, bool kSplit>
cudaError_t launch_gates(const SolveArgs& args, int max_grid,
                         cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = solve_resident_blocks(kTrace, 1, kTable, &blocks);
  if (err != cudaSuccess) return err;
  const long long warps =
      static_cast<long long>(blocks < max_grid ? blocks : max_grid) * kWarps;
  if ((args.n_rows + 7) / 8 <= warps)
    return launch_tiles<kTrace, 1, kTable, kSplit>(args, max_grid, stream);
  return launch_tiles<kTrace, 2, kTable, kSplit>(args, max_grid, stream);
}

// Launch a `solve_kernel` on the current card: tiles of 8 rows where every
// one of them has a warp of its own at once, else of 16; the gate table
// where condition rows serve several rows. kSplit: one attempt of the
// per-attempt mode (which takes n_rows = 0).
template <bool kTrace, bool kSplit>
cudaError_t launch(const SolveArgs& args, int max_grid, cudaStream_t stream) {
  if (args.n_rows < (kSplit ? 0 : 1) || args.rep < 1 ||
      args.n_rows % args.rep != 0 || max_grid < 1 ||
      reinterpret_cast<uintptr_t>(args.weights + kFragOff) % 16 != 0)
    return cudaErrorInvalidValue;
  if (kSplit && (args.attempt < 0 || args.world < 1 || !args.ctrl ||
                 !args.local || (args.attempt > 0 && !args.exchange)))
    return cudaErrorInvalidValue;
  if (args.rep > 1)
    return launch_gates<kTrace, true, kSplit>(args, max_grid, stream);
  return launch_gates<kTrace, false, kSplit>(args, max_grid, stream);
}

}  // namespace
}  // namespace puflow
