// Whole adaptive dopri5 solves of one CNF block in one launch: the plain
// field, and the field with its exact-trace log-density channel.
//
// Replaces the TPU kernels `cnf_solve_pallas` / `cnf_solve_pallas_t` and
// `cnf_solve_logp_pallas` (puflow_tpu/ops/pallas/cnf_pallas.py,
// `_cnf_solve_kernel` and `_cnf_solve_logp_kernel`): integrates, for every
// row of y [R, 3] from t0 to t1 (either direction), the ConcatSquashLinear
// field 3 -> 64 -> 64 -> 3 of `cnf_field.cuh`,
//   h = x W + b;  out = h * sigmoid(t gate_t + gate_c) + (t bias_t + bias_c)
// with tanh between layers, either alone (`puflow_cnf_solve`) or with
// d logp / dt = -div f, div the exact trace from three tangent chains
// (`puflow_cnf_solve_logp`). ONE step size is shared by all rows: the
// error ratio of a step is the RMS over every entry of the state (3 R, or
// 4 R with logp), and accept / reject is one decision a step. Same
// tableau, controller and FSAL as the plain versions, `cnf_solve_plain`
// and `cnf_solve_logp_plain` in puflow_torch/ops/cnf.py
// (`models.ode.odeint_dopri5` on `field_plain_csl` / `field_with_exact_div`).
// The TPU's log-density kernel instead lets each block of up to 8,192 rows
// adapt its own step; the port follows the plain version, so that the
// kernel and its oracle take the same steps and agree to rounding wherever
// a step size is set by a clip. The per-row condition projections gate_c /
// bias_c are constant during a solve and come precomputed (one matrix
// product in the wrapper), 262 floats a condition row; a condition row may
// serve `rep` consecutive rows of y, so the inverse pass never repeats its
// conditions. The three products of the field are computed here, in f32
// on the CUDA cores.
//
// What bounds it on the H100: FP32 operations. A row costs 4,480
// multiply-adds and 259 transcendentals per plain field evaluation (about
// 13k more for the tangent chains), six evaluations a step, against 24
// bytes of state and 1,048 bytes of projections read once a step. With
// everything in shared memory and the 64 x 64 product at most a third of
// the instructions, what limits it in practice is the instruction issue
// rate of the small layers, the epilogues and the barriers around them.
//
// Design. The solve needs the error norm over every row before any row
// may go on, so it is one cooperative launch (`cudaLaunchCooperativeKernel`)
// of as many blocks as fit the card at once (the occupancy API decides),
// with one `grid.sync()` a step and no host read from start to end; t0 and
// t1 come from device memory. One step loop, `solve_kernel`, is templated
// on the field: rows are cut into tiles of the field's height; block b
// owns tiles b, b + grid, ... and, for each, runs the step's six stages
// out of shared memory (weights resident, the tile's projections loaded
// once a step and used by all six evaluations, hidden activations never in
// device memory), so there is no cap on rows. The plain field takes tiles
// of 48 rows, two blocks an SM: one block's barriers and transcendental
// chains overlap the other's products, and the shared-memory traffic of
// the 64 x 64 layer is 16-byte loads. The tangent chains of the log-density
// field triple the hidden tiles, so its tile holds 16 rows. Between steps
// the state (y[, logp] and the FSAL stage k1) lives in device memory in two
// copies: a step reads copy `cur` and writes its candidate (y5, k7) to the
// other, and an accepted step flips `cur`, so nothing is copied. The norm
// is summed in a fixed order: within a tile by a shuffle tree, over a
// block's tiles in index order, over blocks in a fixed order after the
// sync, each block repeating the same sum, so every block takes the same
// decision and two runs agree bit for bit (no float atomics). A partial
// last tile adds nothing to the sum.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

#include "cnf_field.cuh"

namespace cg = cooperative_groups;

namespace puflow {
namespace {

using namespace cnf_field;

constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kMaxDevices = 64;      // cards a process may launch on
// The plain field's tile height (a multiple of 16, at most 80) and blocks
// an SM. Timed side by side on the H100: 48 x 2 (102 KB of shared memory a
// block) ties with 32 x 3, which fills shared memory to the brim, and
// beats 32 x 2 (by 10% at 262,144 rows), 64 x 1 and 16 x 4 (by 37%).
constexpr int kPlainRows = 48;
constexpr int kRowBlocks = kPlainRows / 16;
static_assert(kPlainRows % 16 == 0 && kPlainRows * 3 <= kThreads,
              "tile height");
constexpr int kLdH = kH + 4;         // row stride of hidden tiles: rows stay
                                     // 16-byte aligned, two rows 4 banks apart
constexpr int kPlainTile = kPlainRows * 3;
constexpr int kWeightsPad = (kWeights + 3) / 4 * 4;

struct SolveArgs {
  const float* y0;       // [n_rows, 3]
  const float* logp0;    // [n_rows] (the log-density solve)
  const float* proj;     // [n_rows / rep, kProj]
  const float* weights;  // [kWeights]
  const float* t01;      // t0, t1
  float* state;          // y[, logp] [2][n_rows][kCh], then k1 the same
  double* partials;      // [2][gridDim.x]
  float* out_y;          // [n_rows, 3]
  float* out_logp;       // [n_rows] (the log-density solve)
  int* stats;            // steps attempted, steps accepted
  int n_rows, rep, max_steps;
  float rtol, atol;
};

__device__ __forceinline__ float squash(float h, float t, float gate_t,
                                        float gate_c, float bias_t,
                                        float bias_c) {
  return h * sigmoid(t * gate_t + gate_c) + (t * bias_t + bias_c);
}

// One field evaluation on a tile: xin [kPlainRows][3] -> kout [kPlainRows][3].
// Contains __syncthreads: call it from every thread, after xin is written
// and synchronised. It returns unsynchronised: thread tid < 3 kPlainRows has
// written kout[tid], the element it alone reads until the next barrier.
// Each epilogue first loads all of a thread's operands, then computes its
// outputs side by side, then stores them, so that the chains of the
// transcendentals overlap.
__device__ void field(const float* __restrict__ w_s,
                      const float* __restrict__ proj_s, float t,
                      const float* __restrict__ xin, float* __restrict__ ha,
                      float* __restrict__ hb, float* __restrict__ kout) {
  const int tid = threadIdx.x;
  // layer 1, 3 -> 64: thread = column tid % 64 of rows tid / 64 + 4 u
  {
    constexpr int kPer = kPlainRows * kH / kThreads;
    constexpr int kStep = kThreads / kH;
    const int o = tid % kH, r0 = tid / kH;
    const float w0 = w_s[kW1 + o], w1 = w_s[kW1 + kH + o],
                w2 = w_s[kW1 + 2 * kH + o], b = w_s[kV1 + o],
                gate_t = t * w_s[kV1 + kH + o],
                bias_t = t * w_s[kV1 + 2 * kH + o];
    float h[kPer], g[kPer], c[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int r = r0 + kStep * u;
      h[u] = fmaf(xin[r * 3 + 2], w2,
                  fmaf(xin[r * 3 + 1], w1, xin[r * 3] * w0)) + b;
      g[u] = gate_t + proj_s[r * kLdP + o];
      c[u] = bias_t + proj_s[r * kLdP + kH + o];
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      h[u] = tanhf(h[u] * sigmoid(g[u]) + c[u]);
#pragma unroll
    for (int u = 0; u < kPer; ++u) ha[(r0 + kStep * u) * kLdH + o] = h[u];
  }
  __syncthreads();
  // layer 2, 64 -> 64: thread (ty, tx) owns rows ty + 16 i and columns
  // 4 tx .. 4 tx + 3, a kRowBlocks x 4 register tile; activations and
  // weights come as 16-byte loads, four k at a time
  {
    const int tx = tid & 15, ty = tid >> 4;
    float acc[kRowBlocks][4];
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float4* w4 = reinterpret_cast<const float4*>(w_s + kW2) + tx;
#pragma unroll 4
    for (int k = 0; k < kH; k += 4) {
      float4 a[kRowBlocks];
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i)
        a[i] = *reinterpret_cast<const float4*>(ha + (ty + 16 * i) * kLdH + k);
      const float4 w0 = w4[k * (kH / 4)], w1 = w4[(k + 1) * (kH / 4)],
                   w2 = w4[(k + 2) * (kH / 4)], w3 = w4[(k + 3) * (kH / 4)];
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) {
        acc[i][0] = fmaf(a[i].x, w0.x, acc[i][0]);
        acc[i][1] = fmaf(a[i].x, w0.y, acc[i][1]);
        acc[i][2] = fmaf(a[i].x, w0.z, acc[i][2]);
        acc[i][3] = fmaf(a[i].x, w0.w, acc[i][3]);
        acc[i][0] = fmaf(a[i].y, w1.x, acc[i][0]);
        acc[i][1] = fmaf(a[i].y, w1.y, acc[i][1]);
        acc[i][2] = fmaf(a[i].y, w1.z, acc[i][2]);
        acc[i][3] = fmaf(a[i].y, w1.w, acc[i][3]);
        acc[i][0] = fmaf(a[i].z, w2.x, acc[i][0]);
        acc[i][1] = fmaf(a[i].z, w2.y, acc[i][1]);
        acc[i][2] = fmaf(a[i].z, w2.z, acc[i][2]);
        acc[i][3] = fmaf(a[i].z, w2.w, acc[i][3]);
        acc[i][0] = fmaf(a[i].w, w3.x, acc[i][0]);
        acc[i][1] = fmaf(a[i].w, w3.y, acc[i][1]);
        acc[i][2] = fmaf(a[i].w, w3.z, acc[i][2]);
        acc[i][3] = fmaf(a[i].w, w3.w, acc[i][3]);
      }
    }
    const float4 b4 = *reinterpret_cast<const float4*>(w_s + kV2 + 4 * tx);
    const float4 gt4 =
        *reinterpret_cast<const float4*>(w_s + kV2 + kH + 4 * tx);
    const float4 bt4 =
        *reinterpret_cast<const float4*>(w_s + kV2 + 2 * kH + 4 * tx);
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
    const float gate_t[4] = {t * gt4.x, t * gt4.y, t * gt4.z, t * gt4.w};
    const float bias_t[4] = {t * bt4.x, t * bt4.y, t * bt4.z, t * bt4.w};
    float g[kRowBlocks][4], c[kRowBlocks][4];
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i) {
      const float* p = proj_s + (ty + 16 * i) * kLdP + 2 * kH + 4 * tx;
      const float4 gc = *reinterpret_cast<const float4*>(p);
      const float4 bc = *reinterpret_cast<const float4*>(p + kH);
      const float gcv[4] = {gc.x, gc.y, gc.z, gc.w};
      const float bcv[4] = {bc.x, bc.y, bc.z, bc.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += b[j];
        g[i][j] = gate_t[j] + gcv[j];
        c[i][j] = bias_t[j] + bcv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = tanhf(acc[i][j] * sigmoid(g[i][j]) + c[i][j]);
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i)
      *reinterpret_cast<float4*>(hb + (ty + 16 * i) * kLdH + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  // layer 3, 64 -> 3: thread = (row, channel), four partial sums over
  // k = u mod 4, the row read as 16-byte loads
  if (tid < kPlainTile) {
    const int r = tid / 3, o = tid - r * 3;
    const float4* hrow = reinterpret_cast<const float4*>(hb + r * kLdH);
    const float* w3 = w_s + kW3 + o;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kH; k += 4) {
      const float4 hv = hrow[k / 4];
      acc[0] = fmaf(hv.x, w3[k * 3], acc[0]);
      acc[1] = fmaf(hv.y, w3[(k + 1) * 3], acc[1]);
      acc[2] = fmaf(hv.z, w3[(k + 2) * 3], acc[2]);
      acc[3] = fmaf(hv.w, w3[(k + 3) * 3], acc[3]);
    }
    const float h = (acc[0] + acc[1]) + (acc[2] + acc[3]) + w_s[kV3 + o];
    const float* p = proj_s + r * kLdP + 4 * kH;
    kout[tid] = squash(h, t, w_s[kV3 + 3 + o], p[o], w_s[kV3 + 6 + o],
                       p[3 + o]);
  }
}

// The plain field on tiles of 48 rows: the weights as `_pack` writes them
// (W2's rows kH apart, read as 16-byte words), two hidden tiles.
struct PlainField {
  static constexpr int kRows = kPlainRows, kCh = 3, kBlocksPerSm = 2;
  static constexpr int kWeightFloats = kWeightsPad;
  static constexpr int kScratchFloats = 2 * kRows * kLdH;
  __device__ static void load(const float* __restrict__ g, float* w_s) {
    for (int i = threadIdx.x; i < kWeights; i += kThreads)
      w_s[i] = __ldg(g + i);
  }
  // xin [kRows][3] -> kout [kRows][3]; returns unsynchronised, as `field`
  __device__ static void eval(const float* w_s, const float* proj_s, float t,
                              const float* xin, float* scratch, float* kout) {
    field(w_s, proj_s, t, xin, scratch, scratch + kRows * kLdH, kout);
  }
};

// The field and its exact trace on tiles of 16 rows: (y, logp) [kRows][4]
// -> (f, -div) [kRows][4], `cnf_field.cuh`'s `forward`.
struct LogpField {
  static constexpr int kRows = 16, kCh = 4, kBlocksPerSm = 1;
  static constexpr int kWeightFloats = kSmemW;
  static constexpr int kScratchFloats = 12 * kRows * kH + 12 * kRows;
  __device__ static void load(const float* __restrict__ g, float* w_s) {
    load_weights(g, w_s);
  }
  __device__ static void eval(const float* w_s, const float* proj_s, float t,
                              const float* xin, float* scratch, float* kout) {
    Act act;
    float* p = scratch;
    act.h1 = p; act.s1 = p + kRows * kH; act.x1 = p + 2 * kRows * kH;
    act.h2 = p + 3 * kRows * kH; act.s2 = p + 4 * kRows * kH;
    act.x2 = p + 5 * kRows * kH;
    p += 6 * kRows * kH;
    act.u1 = p; act.v2 = p + 3 * kRows * kH;
    p += 6 * kRows * kH;
    act.h3 = p; act.s3 = p + 3 * kRows; act.v3 = p + 6 * kRows;
    act.dterm = p + 9 * kRows;
    forward<kRows, true>(w_s, proj_s, t, xin, kCh, act, kout, kCh, 3);
  }
};

template <class F>
constexpr int smem_floats() {
  return F::kWeightFloats + F::kRows * kLdP + F::kScratchFloats +
         9 * F::kRows * F::kCh + 16;
}

template <class F>
__global__ void __launch_bounds__(kThreads, F::kBlocksPerSm)
solve_kernel(SolveArgs a) {
  constexpr int kRows = F::kRows, kCh = F::kCh, kTile = kRows * kCh;
  static_assert(kTile <= kThreads, "a thread an entry of the tile");
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // [F::kWeightFloats]
  float* proj_s = w_s + F::kWeightFloats;     // [kRows][kLdP]
  float* scratch = proj_s + kRows * kLdP;     // the field's activations
  float* ks = scratch + F::kScratchFloats;    // [7][kRows][kCh] stages
  float* ys = ks + 7 * kTile;                 // [kRows][kCh] state
  float* xin = ys + kTile;                    // [kRows][kCh] stage input
  float* red = xin + kTile;                   // [8] warp sums
  float* ctrl = red + 8;                      // [8] the controller's scalars

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int n_state = a.n_rows * kCh;
  const int n_tiles = (a.n_rows + kRows - 1) / kRows;
  float* sbuf = a.state;                      // [2][n_state]
  float* kbuf = a.state + 2 * static_cast<size_t>(n_state);

  F::load(a.weights, w_s);

  // a tile's projections, zero beyond the last row: warp w loads rows w,
  // w + 8, ... as 8-byte words (a row is 131 of them)
  auto load_proj = [&](int row0, int rows) {
    const int lane = tid & 31;
    for (int r = tid >> 5; r < kRows; r += kThreads / 32) {
      const float2* src = reinterpret_cast<const float2*>(
          a.proj + static_cast<size_t>((row0 + r) / a.rep) * kProj);
      float2* dst = reinterpret_cast<float2*>(proj_s + r * kLdP);
      for (int col = lane; col < kProj / 2; col += 32)
        dst[col] = r < rows ? __ldg(src + col) : make_float2(0.f, 0.f);
    }
  };

  const float t0 = __ldg(a.t01), t1 = __ldg(a.t01 + 1);
  const float span = fabsf(t1 - t0);
  const float direction = t1 > t0 ? 1.f : (t1 < t0 ? -1.f : 0.f);

  // k1 = f(t0, y0) for this block's tiles; state copy 0
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    const int rows = min(kRows, a.n_rows - row0);
    __syncthreads();  // the previous tile is done with the shared tiles
    load_proj(row0, rows);
    if (tid < kTile) {
      const int r = tid / kCh, c = tid % kCh;
      const size_t row = static_cast<size_t>(row0) + r;
      xin[tid] = r >= rows ? 0.f
                 : c < 3   ? __ldg(a.y0 + row * 3 + c)
                           : __ldg(a.logp0 + row);
    }
    __syncthreads();
    F::eval(w_s, proj_s, t0, xin, scratch, ks);
    if (tid < rows * kCh) {
      const size_t g = static_cast<size_t>(row0) * kCh + tid;
      sbuf[g] = xin[tid];
      kbuf[g] = ks[tid];
    }
  }

  float t = t0, h = direction * span / 16.f;
  bool done = span <= 1e-12f;
  int n = 0, accepted = 0, cur = 0;
  while (!done && n < a.max_steps) {
    // never step past t1
    const float remaining = t1 - t;
    const float h_c = fabsf(h) > fabsf(remaining) ? remaining : h;
    const float* s_cur = sbuf + static_cast<size_t>(cur) * n_state;
    const float* k_cur = kbuf + static_cast<size_t>(cur) * n_state;
    float* s_new = sbuf + static_cast<size_t>(1 - cur) * n_state;
    float* k_new = kbuf + static_cast<size_t>(1 - cur) * n_state;
    double partial = 0.0;  // thread 0's: this block's tiles in index order
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row0 = tile * kRows;
      const int rows = min(kRows, a.n_rows - row0);
      __syncthreads();  // the previous tile is done with the shared tiles
      load_proj(row0, rows);
      if (tid < kTile) {
        const size_t g = static_cast<size_t>(row0) * kCh + tid;
        const bool valid = tid < rows * kCh;
        ys[tid] = valid ? __ldcg(s_cur + g) : 0.f;
        ks[tid] = valid ? __ldcg(k_cur + g) : 0.f;
      }
      __syncthreads();
      // stages 2..7 (k1 is carried: first same as last)
#pragma unroll 1
      for (int i = 1; i < 7; ++i) {
        if (tid < kTile) {
          float acc = ks[tid] * (kA[i][0] * h_c);
          for (int j = 1; j < i; ++j)
            acc += ks[j * kTile + tid] * (kA[i][j] * h_c);
          xin[tid] = ys[tid] + acc;
        }
        __syncthreads();
        F::eval(w_s, proj_s, t + kC[i] * h_c, xin, scratch, ks + i * kTile);
      }
      float sq = 0.f;
      if (tid < rows * kCh) {
        float s5 = ks[tid] * kB5[0];
        float se = ks[tid] * err_weight(0);
#pragma unroll
        for (int j = 1; j < 7; ++j) {
          const float kj = ks[j * kTile + tid];
          s5 += kB5[j] * kj;
          se += err_weight(j) * kj;
        }
        const float y = ys[tid];
        const float y5 = y + h_c * s5;
        const float r = (h_c * se) /
                        (a.atol + a.rtol * fmaxf(fabsf(y), fabsf(y5)));
        sq = r * r;
        const size_t g = static_cast<size_t>(row0) * kCh + tid;
        s_new[g] = y5;
        k_new[g] = ks[6 * kTile + tid];
      }
      const float tile_sum = block_sum(sq, red);
      if (tid == 0) partial += static_cast<double>(tile_sum);
    }
    double* part = a.partials + static_cast<size_t>(n & 1) * gridDim.x;
    if (tid == 0) part[blockIdx.x] = partial;
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

  const float* s_fin = sbuf + static_cast<size_t>(cur) * n_state;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    const int rows = min(kRows, a.n_rows - row0);
    if (tid < rows * kCh) {
      const size_t row = static_cast<size_t>(row0) + tid / kCh;
      const int c = tid % kCh;
      const float v = __ldcg(s_fin + row * kCh + c);
      if (c < 3)
        a.out_y[row * 3 + c] = v;
      else
        a.out_logp[row] = v;
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.stats[0] = n;
    a.stats[1] = accepted;
  }
}

// Launch `solve_kernel<F>` on the current card. The blocks that fit a card
// at once are found (and the kernel's shared-memory limit set) at the
// first launch on that card.
template <class F>
cudaError_t launch(const SolveArgs& args, int max_grid, cudaStream_t stream) {
  if (args.n_rows < 1 || args.rep < 1 || args.n_rows % args.rep != 0 ||
      max_grid < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats<F>();
  static std::atomic<int> resident[kMaxDevices];
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = resident[dev].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             solve_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess)
      return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, solve_kernel<F>, kThreads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    blocks = sms * per_sm;
    resident[dev].store(blocks, std::memory_order_relaxed);
  }
  const int tiles = (args.n_rows + F::kRows - 1) / F::kRows;
  int grid = blocks;
  if (grid > tiles) grid = tiles;
  if (grid > max_grid) grid = max_grid;
  SolveArgs copy = args;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(solve_kernel<F>), dim3(grid), dim3(kThreads),
      params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace puflow

// y0 [n_rows, 3] -> out [n_rows, 3] = y(t1), with t01 = {t0, t1} on the
// device. proj is [n_rows / rep, 262]; state is scratch of 12 n_rows
// floats, partials scratch of 2 max_grid doubles; stats gets the steps
// attempted and accepted. n_rows > 0 and rep divides n_rows.
extern "C" int puflow_cnf_solve(const void* y0, const void* proj,
                                const void* weights, const void* t01,
                                int n_rows, int rep, float rtol, float atol,
                                int max_steps, void* state, void* partials,
                                int max_grid, void* out, void* stats,
                                void* stream) {
  using namespace puflow;
  SolveArgs args{};
  args.y0 = static_cast<const float*>(y0);
  args.proj = static_cast<const float*>(proj);
  args.weights = static_cast<const float*>(weights);
  args.t01 = static_cast<const float*>(t01);
  args.state = static_cast<float*>(state);
  args.partials = static_cast<double*>(partials);
  args.out_y = static_cast<float*>(out);
  args.stats = static_cast<int*>(stats);
  args.n_rows = n_rows;
  args.rep = rep;
  args.max_steps = max_steps;
  args.rtol = rtol;
  args.atol = atol;
  return launch<PlainField>(args, max_grid,
                            static_cast<cudaStream_t>(stream));
}

// y0 [n_rows, 3], logp0 [n_rows] -> out_y, out_logp at t1, with t01 = {t0,
// t1} on the device. proj is [n_rows / rep, 262]; state is scratch of
// 16 n_rows floats, partials scratch of 2 max_grid doubles; stats gets the
// steps attempted and accepted. n_rows > 0 and rep divides n_rows.
extern "C" int puflow_cnf_solve_logp(
    const void* y0, const void* logp0, const void* proj, const void* weights,
    const void* t01, int n_rows, int rep, float rtol, float atol,
    int max_steps, void* state, void* partials, int max_grid, void* out_y,
    void* out_logp, void* stats, void* stream) {
  using namespace puflow;
  SolveArgs args{};
  args.y0 = static_cast<const float*>(y0);
  args.logp0 = static_cast<const float*>(logp0);
  args.proj = static_cast<const float*>(proj);
  args.weights = static_cast<const float*>(weights);
  args.t01 = static_cast<const float*>(t01);
  args.state = static_cast<float*>(state);
  args.partials = static_cast<double*>(partials);
  args.out_y = static_cast<float*>(out_y);
  args.out_logp = static_cast<float*>(out_logp);
  args.stats = static_cast<int*>(stats);
  args.n_rows = n_rows;
  args.rep = rep;
  args.max_steps = max_steps;
  args.rtol = rtol;
  args.atol = atol;
  return launch<LogpField>(args, max_grid,
                           static_cast<cudaStream_t>(stream));
}
