// The backward adjoint kernel of one CNF block, `cnf_adjoint_kernel`, and
// its launch in either mode: the whole solve in one cooperative launch
// (kSplit false, cnf_adjoint.cu's entry) or one attempt a cooperative
// launch (kSplit true, cnf_adjoint_attempt.cu's entry, data parallel).
// Each mode is compiled in its own source, so that nvcc builds the two
// side by side. The design is described in cnf_adjoint.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstdio>

#include "cnf_field.cuh"

namespace cg = cooperative_groups;

namespace puflow {

// The blocks of the one-launch kernel that fit card `dev` at once (defined
// in cnf_adjoint.cu): the grid of either mode.
cudaError_t adjoint_resident_blocks(bool trace, int dev, int* blocks);

namespace {

using cnf_field::cp16;
using cnf_field::cp8;
using cnf_field::cp_wait;
using cnf_field::err_weight;
using cnf_field::kA;
using cnf_field::kB5;
using cnf_field::kC;
using cnf_field::kFrag;
using cnf_field::kFragOff;
using cnf_field::kH;
using cnf_field::kLdP;
using cnf_field::kOwnW;
using cnf_field::kProj;
using cnf_field::mma3;
using cnf_field::oV1;
using cnf_field::oV2;
using cnf_field::oV3;
using cnf_field::oW1;
using cnf_field::oW3;
using cnf_field::product;
using cnf_field::quad_sum;
using cnf_field::sigmoid;
using tf32::ASplit;
using tf32::BPair;
using tf32::b_pair;
using tf32::split_bits;

// the parts that scripts/adjoint_variants.py's diagnostic variants drop
constexpr bool kGradSums = true;      // the layers' gradient sums
constexpr bool kCondProducts = true;  // the condition cotangents
constexpr bool kGReduce = true;       // G's reduction over the blocks
constexpr bool kReverse = true;       // the vjp (false: the forward alone)
// block 0's clock per phase of the attempts, printed at the end (the
// diag_clock variant)
constexpr bool kClock = false;

// floats after an exchange's two G vectors: the row terms' sum and count
// (two doubles), the grid, padding
constexpr int kExchangeTail = 6;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kLd = 8;                // row state: y 0-2, a 3-5, logp 6
constexpr int kA0 = 3;
constexpr int kLogp = 6;
constexpr int kLdA = kH + 8;          // activations' row stride
constexpr int kKt = kLdP / 8;         // k chunks of Wc Q (262 padded)
// the packed gradient of the layers (positive dS/dtheta): per layer W
// [in, out], then db, dgate_t, dbias_t, dgate_b [out] each; then [cdim]
// [kLdP] for the projection matrix
constexpr int gW1 = 0;
constexpr int gV1 = gW1 + 3 * kH;
constexpr int gW2 = gV1 + 4 * kH;
constexpr int gV2 = gW2 + kH * kH;
constexpr int gW3 = gV2 + 4 * kH;
constexpr int gV3 = gW3 + kH * 3;
constexpr int kGOwn = gV3 + 12;       // 5,004
constexpr int kSmall = kGOwn - kH * kH;  // every entry but W2's: 908
static_assert(kGOwn == 5004 && kGOwn % 4 == 0, "gradient layout");
// the small entries in a compact index s (W2's taken out) and back
constexpr int sV2 = gV2 - kH * kH;
constexpr int sW3 = gW3 - kH * kH;
constexpr int sV3 = gV3 - kH * kH;
__device__ __forceinline__ int small_g(int s) {
  return s < gW2 ? s : s + kH * kH;
}
// the weights as the wrapper packs them (`ops/cnf.py:_field_weights`,
// `cnf_field.cuh`: the layers' own, then W2's and W2^T's B fragments as
// f32 pairs from kFragOff); the small ones in shared memory at `oW1` ...
// column sums of a tile (12 kinds x 64 columns), one per row group rg (rows
// rg, rg + 4, ...)
constexpr int kKinds = 12;

// The field tile: one m16 row tile with the trace, two without (its
// activations take less shared memory, so more rows share each phase and
// barrier).
template <bool kTrace>
struct Dims {
  static constexpr int kRows = kTrace ? 16 : 32;
  static constexpr int kMt = kRows / 16;        // m16 row tiles
  static constexpr int kTile = kRows * kLd;     // the tile's row state
  static constexpr int kArr = kRows * kLdA;     // one activation array
};

// shared memory: what lives through the launch, then a union of the
// field's tile and the condition products' staging
constexpr int kPersist = 2 * kFrag + kOwnW + 3 * kSmall + 16;
template <bool kTrace>
constexpr int field_floats() {
  using D = Dims<kTrace>;
  return D::kRows * kLdP + D::kRows + 9 * D::kTile + 3 * D::kRows * 4 +
         2 * D::kRows * kLdP + 4 * kKinds * kH +
         (kTrace ? 15 : 6) * D::kArr;
}
// c^T Q's staging: Q5, QE and c of kCondRows condition rows (c's rows 8
// apart from a multiple of 16: kc rows at cdim 128 hold kCondRows)
constexpr int kCondRows = 64;
constexpr int kUnionMin = kCondRows * (2 * kLdP + 128 + 8);
constexpr int cmax(int x, int y) { return x > y ? x : y; }
constexpr int kUnion =
    cmax(cmax(field_floats<true>(), field_floats<false>()), kUnionMin);
static_assert(kPersist % 4 == 0, "alignment");
constexpr int kSmemFloats = kPersist + kUnion;

struct AdjArgs {
  const float* y1;       // [n_rows, 3]
  const float* logp1;    // [n_rows]
  const float* a1;       // [n_rows, 3]
  const float* ap;       // [n_rows]
  const float* c;        // [n_rows / rep, cdim]
  const float* proj;     // [n_rows / rep, kProj]
  const float* weights;  // [kFragOff + 2 kFrag]
  const float* wct;      // Wc^T's B fragments, [kKt][cdim / 8][32] pairs
  const float* t01;      // t0, t1
  float* rows;           // y | a | logp [2][n_rows][8], FSAL stage [2][n_rows]
                         // [8], its q [2][n_rows][264], dc [2][n_rows]
                         // [cdim], Q5 and QE per condition row and block
                         // [n_rows / rep + max_grid][264] each
  float* per_grid;       // part [grid][2][ng], kgb [2][grid][kGOwn],
                         // G [2][ng]
  double* partials;      // [2][2][grid]
  float* out_y0;         // [n_rows, 3]
  float* out_a0;         // [n_rows, 3]
  float* out_dc;         // [n_rows, cdim]
  float* out_g;          // [ng]
  float* out_bnd;        // [n_rows, 8]: f1, div1, f0, div0
  int* stats;            // steps attempted, steps accepted
  int n_rows, rep, cdim, cdim_true, max_steps, max_grid;
  float rtol, atol;
  // the per-attempt mode: this launch's attempt, every rank's sums of the
  // previous attempt in rank order ([world][2 ng + kExchangeTail]), the
  // control blocks ([2][8] ints by attempt parity: t, h, cur, n, accepted,
  // finished), this rank's sums of this attempt, and this rank's own G
  // [2][ng] (null at world size 1, where it is the global G)
  int attempt, world;
  const float* exchange;
  int* ctrl;
  float* local;
  float* gloc;
};

// Pointers into shared memory.
struct Smem {
  const float2 *wfw, *wrv;   // W2's, W2^T's B fragments
  const float* w;            // the small weights
  float *sacc5, *saccE, *sacc7;  // the small gradient sums [kSmall]
  float *red, *ctrl;
  float* u;                  // the union
  // the field's tile
  float *proj, *ap, *ks, *ys, *xin, *s3, *dh3, *q3g, *q5, *qe, *sp;
  float *x1, *s1, *u1, *h2, *s2, *x2, *v2, *dh2, *cv2, *dh1;
};

// One stage's weights in the sums: B5, error, FSAL (the last stage's own)
struct Weights {
  float w5, wE, w7;
};

// T[n] += X^T D over rows 0..8 KT - 1: X [rows][ldx], D [rows][ldd] in
// shared memory (natural k order); T's rows are X's columns m0..m0+15,
// its n tiles D's columns 8 (nt0 + n) ...
template <int NT, int KT>
__device__ __forceinline__ void product_t(float (&T)[NT][4], const float* X,
                                          int ldx, const float* D, int ldd,
                                          int m0, int nt0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    const float* x = X + (8 * kc + t) * ldx + m0 + g;
    const float av[4] = {x[0], x[8], x[4 * ldx], x[4 * ldx + 8]};
    ASplit a;
#pragma unroll
    for (int i = 0; i < 4; ++i) split_bits(av[i], a.hi[i], a.lo[i]);
    const float* d = D + (8 * kc + t) * ldd + 8 * nt0 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma3(T[n], a, b_pair(make_float2(d[8 * n], d[4 * ldd + 8 * n])));
  }
}

// The phases block 0's thread 0 clocks with kClock.
enum Phase {
  kTkSetup, kTkInput, kTkL1, kTkL2, kTkL3, kTkR2, kTkR1, kTkR1b, kTkF,
  kTkTileEnd, kTkGradOut, kTkDc, kTkCtq, kTkSync1, kTkReduce, kTkControl,
  kPhases
};
__shared__ long long clk[kPhases + 1];   // the last: the previous tick

__device__ __forceinline__ void tick(Phase phase) {
  if (kClock && threadIdx.x == 0) {
    const long long now = clock64();
    clk[phase] += now - clk[kPhases];
    clk[kPhases] = now;
  }
}

__device__ __forceinline__ void clock_reset() {
  if (kClock && threadIdx.x == 0) {
    for (int i = 0; i < kPhases; ++i) clk[i] = 0;
    clk[kPhases] = clock64();
  }
}

// The augmented field on the tile's rows x = s.xin (channels: y, a, logp)
// at time t: writes f, -dS/dy and -div into kout (stride kLd). With
// `reverse` false the forward alone (f and -div). Adds the stage's weights
// times the layers' gradient dS/dtheta of the tile to the C fragments
// g5 / gE / g7 (W2's, this warp's slice) and to s.sacc* (the rest), w5
// and wE times q to the tile's Q5 / QE, and stores q of the tile's rows
// to q_out if it is not null.
template <bool kTrace>
__device__ __forceinline__ void aug_field(const Smem& s, float t,
                                          float* kout, Weights wt,
                                          float* q_out, int rows,
                                          bool reverse, float (&g5)[4][4],
                                          float (&gE)[4][4],
                                          float (&g7)[4][4]) {
  using D = Dims<kTrace>;
  constexpr int kRows = D::kRows, kMt = D::kMt, kArr = D::kArr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid & (kH - 1), rg = tid >> 6;   // column, row group
  const int g = lane >> 2, tq = lane & 3;
  const float* w = s.w;
  const bool grads = wt.w5 != 0.f || wt.wE != 0.f || wt.w7 != 0.f;
  const bool qsum = wt.w5 != 0.f || wt.wE != 0.f;
  constexpr int NP = kTrace ? 4 : 1;   // products of layer 2 and back
  const int p = warp / (kWarps / NP), nt0 = warp % (kWarps / NP) * NP;

  // layer 1, and the tangents u1_k = W1[k] s1 (1 - x1^2)
  for (int i = 0; i < kRows / 4; ++i) {
    const int r = rg + 4 * i, e = r * kLdA + j;
    const float* y = s.xin + r * kLd;
    const float* pr = s.proj + r * kLdP;
    const float h = fmaf(y[2], w[oW1 + 2 * kH + j],
                         fmaf(y[1], w[oW1 + kH + j], y[0] * w[oW1 + j])) +
                    w[oV1 + j];
    const float sg = sigmoid(t * w[oV1 + kH + j] + pr[j]);
    const float x = tanhf(h * sg + (t * w[oV1 + 2 * kH + j] + pr[kH + j]));
    s.x1[e] = x;
    s.s1[e] = sg;
    if (kTrace) {
      const float sm = sg * (1.f - x * x);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        s.u1[k * kArr + e] = w[oW1 + k * kH + j] * sm;
    }
  }
  __syncthreads();
  tick(kTkL1);
  // layer 2: h2 = x1 W2 + b2 and its epilogue; with the trace v2_k =
  // u1_k W2 (warp: product p, n tiles nt0 ..)
  {
    float acc[kMt][NP][4];
    product<kMt, NP, kLdA>(acc, p == 0 ? s.x1 : s.u1 + (p - 1) * kArr,
                     s.wfw + nt0 * 32 + lane, lane);
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * m + g + 8 * half, col = 8 * (nt0 + n) + 2 * tq;
          const int e = r * kLdA + col;
          if (p == 0 && !kTrace) {
            const float* pr = s.proj + r * kLdP;
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
              const int jj = col + c2;
              const float h = acc[m][n][2 * half + c2] + w[oV2 + jj];
              const float sg =
                  sigmoid(t * w[oV2 + kH + jj] + pr[2 * kH + jj]);
              s.h2[e + c2] = h;
              s.s2[e + c2] = sg;
              s.x2[e + c2] = tanhf(h * sg + (t * w[oV2 + 2 * kH + jj] +
                                             pr[3 * kH + jj]));
            }
          } else {
            *reinterpret_cast<float2*>(
                (p == 0 ? s.h2 : s.v2 + (p - 1) * kArr) + e) =
                make_float2(acc[m][n][2 * half], acc[m][n][2 * half + 1]);
          }
        }
  }
  __syncthreads();
  if (kTrace) {
    // layer 2's epilogue, spread over the block (with the trace two warps
    // hold x1 W2)
    for (int i = 0; i < kRows / 4; ++i) {
      const int r = rg + 4 * i, e = r * kLdA + j;
      const float* pr = s.proj + r * kLdP;
      const float h = s.h2[e] + w[oV2 + j];
      const float sg = sigmoid(t * w[oV2 + kH + j] + pr[2 * kH + j]);
      s.h2[e] = h;
      s.s2[e] = sg;
      s.x2[e] = tanhf(h * sg + (t * w[oV2 + 2 * kH + j] + pr[3 * kH + j]));
    }
    __syncthreads();
  }
  tick(kTkL2);
  // layer 3 (16 threads a row: output c, a quarter of the 64 columns), the
  // diagonal v3_c[c] = u2_c W3[:, c] with u2_c = v2_c s2 (1 - x2^2), and
  // layer 3's cotangents
#pragma unroll
  for (int r0 = 0; r0 < kRows; r0 += kThreads / 16) {
    const int r = r0 + (tid >> 4), c = (tid >> 2) & 3, part = tid & 3;
    const int cc = c < 3 ? c : 2;
    const int e0 = r * kLdA + 16 * part;
    float h3 = 0.f, v3 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float x = s.x2[e0 + jj];
      const float w3 = w[oW3 + (16 * part + jj) * 3 + cc];
      h3 = fmaf(x, w3, h3);
      if (kTrace)
        v3 = fmaf(s.v2[cc * kArr + e0 + jj] * s.s2[e0 + jj] * (1.f - x * x),
                  w3, v3);
    }
    h3 = quad_sum(h3);
    if (kTrace) v3 = quad_sum(v3);
    const float* pr = s.proj + r * kLdP + 4 * kH;
    const float hc = h3 + w[oV3 + cc];
    const float s3 = sigmoid(t * w[oV3 + 3 + cc] + pr[cc]);
    const float f = hc * s3 + (t * w[oV3 + 6 + cc] + pr[3 + cc]);
    const float dterm = v3 * s3;
    const int base = lane & 16;
    const float d0 = __shfl_sync(0xffffffffu, dterm, base);
    const float d1 = __shfl_sync(0xffffffffu, dterm, base + 4);
    const float d2 = __shfl_sync(0xffffffffu, dterm, base + 8);
    if (part == 0 && c < 3) {
      kout[r * kLd + c] = f;
      if (reverse) {
        const float a = s.xin[r * kLd + kA0 + c];
        const float cs = kTrace ? -s.ap[r] * v3 : 0.f;
        const float qg = (a * hc + cs) * s3 * (1.f - s3);
        s.s3[r * 4 + c] = s3;
        s.dh3[r * 4 + c] = a * s3;
        s.q3g[r * 4 + c] = qg;
        const int q0 = r * kLdP + 4 * kH + c;
        if (qsum) {
          s.q5[q0] = fmaf(wt.w5, qg, s.q5[q0]);
          s.qe[q0] = fmaf(wt.wE, qg, s.qe[q0]);
          s.q5[q0 + 3] = fmaf(wt.w5, a, s.q5[q0 + 3]);
          s.qe[q0 + 3] = fmaf(wt.wE, a, s.qe[q0 + 3]);
        }
        if (q_out != nullptr && r < rows) {
          q_out[q0] = qg;
          q_out[q0 + 3] = a;
        }
      }
    }
    if ((tid & 15) == 0) {
      kout[r * kLd + kLogp] = kTrace ? -(d0 + d1 + d2) : 0.f;
      kout[r * kLd + 7] = 0.f;
    }
  }
  __syncthreads();
  tick(kTkL3);
  if (!reverse) return;

  // layer 2's cotangents (and the tangents' reverse through layer 3)
  {
    float pdh = 0.f, pqg = 0.f, pdz = 0.f, pw3[3] = {0.f, 0.f, 0.f};
    for (int i = 0; i < kRows / 4; ++i) {
      const int r = rg + 4 * i, e = r * kLdA + j;
      const float x2 = s.x2[e], s2 = s.s2[e], m2 = 1.f - x2 * x2;
      const float* d3 = s.dh3 + r * 4;
      float cx = d3[0] * w[oW3 + j * 3] + d3[1] * w[oW3 + j * 3 + 1] +
                 d3[2] * w[oW3 + j * 3 + 2];
      float cs = 0.f;
      if (kTrace) {
        const float apr = s.ap[r];
        float cm = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float ck = -apr * s.s3[r * 4 + k];
          const float cu = ck * w[oW3 + j * 3 + k];
          const float v = s.v2[k * kArr + e];
          const float cw = cu * m2;
          cm = fmaf(cu, v * s2, cm);
          cs = fmaf(cw, v, cs);
          s.cv2[k * kArr + e] = cw * s2;
          if (grads) pw3[k] = fmaf(v * s2 * m2, ck, pw3[k]);
        }
        cx += -2.f * x2 * cm;
      }
      const float dz = cx * m2, dh = dz * s2;
      s.dh2[e] = dh;
      const float qg = (dz * s.h2[e] + cs) * s2 * (1.f - s2);
      if (grads) {
        pdh += dh;
        pqg += qg;
        pdz += dz;
#pragma unroll
        for (int c = 0; c < 3; ++c) pw3[c] = fmaf(x2, d3[c], pw3[c]);
      }
      const int q0 = r * kLdP + 2 * kH + j;
      if (qsum) {
        s.q5[q0] = fmaf(wt.w5, qg, s.q5[q0]);
        s.qe[q0] = fmaf(wt.wE, qg, s.qe[q0]);
        s.q5[q0 + kH] = fmaf(wt.w5, dz, s.q5[q0 + kH]);
        s.qe[q0 + kH] = fmaf(wt.wE, dz, s.qe[q0 + kH]);
      }
      if (q_out != nullptr && r < rows) {
        q_out[q0] = qg;
        q_out[q0 + kH] = dz;
      }
    }
    if (grads) {
      float* sp = s.sp + rg * kKinds * kH + j;
      sp[6 * kH] = pdh;
      sp[7 * kH] = pqg;
      sp[8 * kH] = pdz;
#pragma unroll
      for (int c = 0; c < 3; ++c) sp[(9 + c) * kH] = pw3[c];
    }
  }
  __syncthreads();
  tick(kTkR2);
  // cx1 = dh2 W2^T into h2's place, with the trace cu1_k = cv2_k W2^T into
  // v2_k's; W2's gradient x1^T dh2 (+ sum_k u1_k^T cv2_k), this warp's 16
  // rows x 4 n tiles of it
  {
    float acc[kMt][NP][4];
    product<kMt, NP, kLdA>(acc, p == 0 ? s.dh2 : s.cv2 + (p - 1) * kArr,
                     s.wrv + nt0 * 32 + lane, lane);
    float* out = p == 0 ? s.h2 : s.v2 + (p - 1) * kArr;
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(out + (16 * m + g + 8 * half) * kLdA +
                                     8 * (nt0 + n) + 2 * tq) =
              make_float2(acc[m][n][2 * half], acc[m][n][2 * half + 1]);
    if (grads && kGradSums) {
      const int m0 = 16 * (warp >> 1), n0 = 4 * (warp & 1);
      float T[4][4] = {};
      product_t<4, kRows / 8>(T, s.x1, kLdA, s.dh2, kLdA, m0, n0, lane);
      if (kTrace)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          product_t<4, kRows / 8>(T, s.u1 + k * kArr, kLdA,
                                  s.cv2 + k * kArr, kLdA, m0, n0, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          g5[n][q] = fmaf(wt.w5, T[n][q], g5[n][q]);
          gE[n][q] = fmaf(wt.wE, T[n][q], gE[n][q]);
          if (wt.w7 != 0.f) g7[n][q] = fmaf(wt.w7, T[n][q], g7[n][q]);
        }
    }
  }
  __syncthreads();
  tick(kTkR1);
  // layer 1's cotangents
  {
    float pdh = 0.f, pqg = 0.f, pdz = 0.f, pw1[3] = {0.f, 0.f, 0.f};
    for (int i = 0; i < kRows / 4; ++i) {
      const int r = rg + 4 * i, e = r * kLdA + j;
      const float x1 = s.x1[e], s1 = s.s1[e], m1 = 1.f - x1 * x1;
      const float* y = s.xin + r * kLd;
      const float h1 = fmaf(y[2], w[oW1 + 2 * kH + j],
                            fmaf(y[1], w[oW1 + kH + j], y[0] * w[oW1 + j])) +
                       w[oV1 + j];
      float cx = s.h2[e], cs = 0.f;
      if (kTrace) {
        float cm = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float cu = s.v2[k * kArr + e];
          const float w1 = w[oW1 + k * kH + j];
          const float cw = cu * m1;
          cm = fmaf(cu, w1 * s1, cm);
          cs = fmaf(cw, w1, cs);
          if (grads) pw1[k] += cw * s1;
        }
        cx = fmaf(-2.f * x1, cm, cx);
      }
      const float dz = cx * m1, dh = dz * s1;
      s.dh1[e] = dh;
      const float qg = (dz * h1 + cs) * s1 * (1.f - s1);
      if (grads) {
        pdh += dh;
        pqg += qg;
        pdz += dz;
#pragma unroll
        for (int k = 0; k < 3; ++k) pw1[k] = fmaf(y[k], dh, pw1[k]);
      }
      const int q0 = r * kLdP + j;
      if (qsum) {
        s.q5[q0] = fmaf(wt.w5, qg, s.q5[q0]);
        s.qe[q0] = fmaf(wt.wE, qg, s.qe[q0]);
        s.q5[q0 + kH] = fmaf(wt.w5, dz, s.q5[q0 + kH]);
        s.qe[q0 + kH] = fmaf(wt.wE, dz, s.qe[q0 + kH]);
      }
      if (q_out != nullptr && r < rows) {
        q_out[q0] = qg;
        q_out[q0 + kH] = dz;
      }
    }
    if (grads) {
      float* sp = s.sp + rg * kKinds * kH + j;
      sp[0] = pdh;
      sp[kH] = pqg;
      sp[2 * kH] = pdz;
#pragma unroll
      for (int k = 0; k < 3; ++k) sp[(3 + k) * kH] = pw1[k];
    }
  }
  __syncthreads();
  tick(kTkR1b);
  // -dS/dy = -dh1 W1^T (16 threads a row), and the small gradient sums
#pragma unroll
  for (int r0 = 0; r0 < kRows; r0 += kThreads / 16) {
    const int r = r0 + (tid >> 4), c = (tid >> 2) & 3, part = tid & 3;
    const int cc = c < 3 ? c : 2;
    const float* dh = s.dh1 + r * kLdA + 16 * part;
    const float* w1 = w + oW1 + cc * kH + 16 * part;
    float acc = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) acc = fmaf(dh[jj], w1[jj], acc);
    acc = quad_sum(acc);
    if (part == 0 && c < 3) kout[r * kLd + kA0 + c] = -acc;
  }
  if (grads && kGradSums) {
    auto add = [&](int si, float v) {
      s.sacc5[si] = fmaf(wt.w5, v, s.sacc5[si]);
      s.saccE[si] = fmaf(wt.wE, v, s.saccE[si]);
      if (wt.w7 != 0.f) s.sacc7[si] = fmaf(wt.w7, v, s.sacc7[si]);
    };
    for (int e = tid; e < kKinds * kH; e += kThreads) {
      const int kind = e / kH, jj = e % kH;
      const float* sp = s.sp + e;
      const float v = ((sp[0] + sp[kKinds * kH]) + sp[2 * kKinds * kH]) +
                      sp[3 * kKinds * kH];
      switch (kind) {
        case 0: add(gV1 + jj, v); break;
        case 1: add(gV1 + kH + jj, v * t); add(gV1 + 3 * kH + jj, v); break;
        case 2: add(gV1 + 2 * kH + jj, v * t); break;
        case 3: case 4: case 5: add(gW1 + (kind - 3) * kH + jj, v); break;
        case 6: add(sV2 + jj, v); break;
        case 7: add(sV2 + kH + jj, v * t); add(sV2 + 3 * kH + jj, v); break;
        case 8: add(sV2 + 2 * kH + jj, v * t); break;
        default: add(sW3 + jj * 3 + (kind - 9), v); break;
      }
    }
    if (tid < 12 * 16) {            // layer 3's vectors: 16 lanes an entry
      const int entry = tid / 16, part = entry / 3, c = entry % 3;
      float v = 0.f;
#pragma unroll
      for (int r = tid % 16; r < kRows; r += 16)
        v += part == 0 ? s.dh3[r * 4 + c]
             : part == 2 ? s.xin[r * kLd + kA0 + c]
                         : s.q3g[r * 4 + c];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (tid % 16 == 0) add(sV3 + entry, part == 1 || part == 2 ? v * t : v);
    }
  }
  __syncthreads();
  tick(kTkF);
}

// c^T Q's product for one k chunk of 8 condition rows: T5 += X^T D5 and
// TE += X^T DE, X = c [8][ldx], D = Q [8][ldd] in shared memory; T's rows
// are c's columns m0..m0+15, its n tiles Q's columns 8 (nt0 + n) ...
template <int NT>
__device__ __forceinline__ void product_ctq(float (&T5)[NT][4],
                                            float (&TE)[NT][4],
                                            const float* X, int ldx,
                                            const float* D5, const float* DE,
                                            int ldd, int m0, int nt0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* x = X + t * ldx + m0 + g;
  const float av[4] = {x[0], x[8], x[4 * ldx], x[4 * ldx + 8]};
  ASplit a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_bits(av[i], a.hi[i], a.lo[i]);
  const int at = t * ldd + 8 * nt0 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = at + 8 * n;
    mma3(T5[n], a, b_pair(make_float2(D5[d], D5[d + 4 * ldd])));
    mma3(TE[n], a, b_pair(make_float2(DE[d], DE[d + 4 * ldd])));
  }
}

// dc of a tile's rows (MT m16 row tiles), this warp's n tiles of it (warp,
// warp + 8, ...): D = Q Wc^T for the tile's Q5 and QE in shared memory,
// Wc's B fragments (kc, nt) read from device memory at wct[(kc * ntot +
// nt) * 32], 11 k chunks' loads in flight at a time and each split once
// for the row tiles; dc1 = dc0 - h D5 into the next copy, the error terms
// (-h DE) summed into sq.
template <int MT>
__device__ __forceinline__ void dc_tile(const Smem& s, const float2* wct,
                                        int ntot, const float* dc0,
                                        float* dc1, int row0, int rows,
                                        int cdim, float h_c, float rtol,
                                        float atol, float& sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const float* q5 = s.q5 + g * kLdP + 2 * tq;
  const float* qe = s.qe + g * kLdP + 2 * tq;
  constexpr int kBatch = kKt / 3;
  for (int nt0 = warp; nt0 < ntot; nt0 += 2 * kWarps) {
    const bool two = nt0 + kWarps < ntot;
    float a5[MT][2][4] = {}, aE[MT][2][4] = {};
    const float2* w = wct + nt0 * 32 + lane;
#pragma unroll 1
    for (int k0 = 0; k0 < kKt; k0 += kBatch) {
      float2 wb[kBatch][2];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const float2* wk = w + static_cast<size_t>(k0 + i) * ntot * 32;
        wb[i][0] = __ldg(wk);
        wb[i][1] = two ? __ldg(wk + kWarps * 32) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const BPair b[2] = {b_pair(wb[i][0]), b_pair(wb[i][1])};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int at = 16 * m * kLdP + 8 * (k0 + i);
          const float2 t5 = *reinterpret_cast<const float2*>(q5 + at);
          const float2 b5 =
              *reinterpret_cast<const float2*>(q5 + at + 8 * kLdP);
          const float2 te = *reinterpret_cast<const float2*>(qe + at);
          const float2 be =
              *reinterpret_cast<const float2*>(qe + at + 8 * kLdP);
          const float c5[4] = {t5.x, t5.y, b5.x, b5.y};
          const float ce[4] = {te.x, te.y, be.x, be.y};
          const ASplit x5 = tf32::a_split(c5), xe = tf32::a_split(ce);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma3(a5[m][n], x5, b[n]);
            mma3(aE[m][n], xe, b[n]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = 16 * m + g + 8 * (k >> 1);
          const int col = 8 * (nt0 + n * kWarps) + 2 * tq + (k & 1);
          if (r >= rows || (n == 1 && !two)) continue;
          const size_t at = static_cast<size_t>(row0 + r) * cdim + col;
          const float d0 = __ldcg(dc0 + at);
          const float d1 = d0 - h_c * a5[m][n][k];
          dc1[at] = d1;
          const float rr = (-h_c * aE[m][n][k]) /
                           (atol + rtol * fmaxf(fabsf(d0), fabsf(d1)));
          sq = fmaf(rr, rr, sq);
        }
  }
}

// The kernel in either mode. kSplit false: the whole solve in one
// cooperative launch. kSplit true: one attempt a (cooperative) launch,
// `a.attempt` its index: launch k > 0 first decides attempt k - 1 from the
// ranks' exchanged sums (`decide`), then takes attempt k and leaves this
// rank's sums in `a.local`; the grid, the tiles and every sum are the
// one-launch kernel's, so at world size 1 the two modes agree bit for bit.
template <bool kTrace, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
cnf_adjoint_kernel(AdjArgs a) {
  using D = Dims<kTrace>;
  constexpr int kRows = D::kRows, kTile = D::kTile, kArr = D::kArr;
  extern __shared__ __align__(16) float smem[];
  Smem s;
  s.wfw = reinterpret_cast<const float2*>(smem);
  s.wrv = s.wfw + kFrag / 2;
  float* ws = smem + 2 * kFrag;
  s.w = ws;
  s.sacc5 = ws + kOwnW;
  s.saccE = s.sacc5 + kSmall;
  s.sacc7 = s.saccE + kSmall;
  s.red = s.sacc7 + kSmall;
  s.ctrl = s.red + 8;
  s.u = smem + kPersist;
  {
    float* p = s.u;
    auto take = [&p](int n) { float* q = p; p += n; return q; };
    s.proj = take(kRows * kLdP);
    s.ap = take(kRows);
    s.ks = take(7 * kTile);
    s.ys = take(kTile);
    s.xin = take(kTile);
    s.s3 = take(kRows * 4);
    s.dh3 = take(kRows * 4);
    s.q3g = take(kRows * 4);
    s.q5 = take(kRows * kLdP);
    s.qe = take(kRows * kLdP);
    s.sp = take(4 * kKinds * kH);
    s.x1 = take(kArr);
    s.s1 = take(kArr);
    s.u1 = kTrace ? take(3 * kArr) : nullptr;
    s.h2 = take(kArr);
    s.s2 = take(kArr);
    s.x2 = take(kArr);
    s.v2 = kTrace ? take(3 * kArr) : nullptr;
    s.dh2 = take(kArr);
    s.cv2 = kTrace ? take(3 * kArr) : nullptr;
    s.dh1 = s.h2;       // each thread writes dh1 where it read cx1
  }

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, nb = gridDim.x;
  const int R = a.n_rows, cdim = a.cdim, rep = a.rep;
  const int ng = kGOwn + cdim * kLdP;
  // this block's tiles and rows
  const int n_tiles = (R + kRows - 1) / kRows;
  const int tb0 = static_cast<int>(static_cast<long long>(n_tiles) * b / nb);
  const int tb1 =
      static_cast<int>(static_cast<long long>(n_tiles) * (b + 1) / nb);
  const int rb0 = tb0 * kRows, rb1 = min(tb1 * kRows, R);
  // row buffers
  const size_t Rs = static_cast<size_t>(R);
  float* sbuf = a.rows;                   // [2][R][kLd]
  float* kbuf = sbuf + 2 * Rs * kLd;      // [2][R][kLd]
  float* qbuf = kbuf + 2 * Rs * kLd;      // [2][R][kLdP]
  float* dcbuf = qbuf + 2 * Rs * kLdP;    // [2][R][cdim]
  // Q5 and QE of each condition row summed over this block's rows of it,
  // at slot cr + b: [R / rep + grid][kLdP] each
  float* qc5 = dcbuf + 2 * Rs * cdim;
  float* qcE = qc5 + static_cast<size_t>(R / rep + a.max_grid) * kLdP;
  // grid buffers
  float* part = a.per_grid;                               // [grid][2][ng]
  float* kgb = part + 2 * static_cast<size_t>(a.max_grid) * ng;
  float* gbuf = kgb + 2 * static_cast<size_t>(a.max_grid) * kGOwn;
  float* my5 = part + 2 * static_cast<size_t>(b) * ng;
  float* myE = my5 + ng;

  // the weights: fragments, and the small ones
  {
    const float4* src = reinterpret_cast<const float4*>(a.weights + kFragOff);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int e = tid; e < kFrag / 2; e += kThreads) dst[e] = __ldg(src + e);
    cnf_field::load_small(a.weights, ws, tid, kThreads);
  }

  // a tile's projections into proj (131 pairs a row, copies in flight
  // until the caller's cp_wait)
  auto load_proj = [&](int row0, int rows, float* proj) {
    for (int e = tid; e < kRows * (kProj / 2); e += kThreads) {
      const int r = e / (kProj / 2), c2 = 2 * (e % (kProj / 2));
      float* dst = proj + r * kLdP + c2;
      if (r < rows)
        cp8(dst, a.proj + static_cast<size_t>((row0 + r) / rep) * kProj + c2);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(0.f, 0.f);
    }
  };
  auto load_tile = [&](int row0, int rows) {
    load_proj(row0, rows, s.proj);
    if (tid < kRows)
      s.ap[tid] = kTrace && tid < rows ? __ldg(a.ap + row0 + tid) : 0.f;
  };
  // what a step needs of a tile besides the weights, all copies in flight
  // at once: its projections, a_p, its state and FSAL stage (copy cs), and
  // q of its FSAL stage into Q5's place
  auto load_step = [&](int row0, int rows, size_t cs) {
    load_tile(row0, rows);
    const size_t at = cs * R + row0;
    for (int e = tid; e < rows * (kLdP / 4); e += kThreads)
      cp16(s.q5 + 4 * e, qbuf + at * kLdP + 4 * e);
    for (int e = tid; e < kTile / 4; e += kThreads) {
      if (e < rows * (kLd / 4)) {
        cp16(s.ys + 4 * e, sbuf + at * kLd + 4 * e);
        cp16(s.ks + 4 * e, kbuf + at * kLd + 4 * e);
      } else {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        reinterpret_cast<float4*>(s.ys)[e] = zero;
        reinterpret_cast<float4*>(s.ks)[e] = zero;
      }
    }
  };
  // this warp's slice of W2's gradient sums (rows m0.., n tiles n0..)
  const int wm0 = 16 * (warp >> 1), wn0 = 4 * (warp & 1);
  auto w2_index = [&](int n, int k) {
    return gW2 + (wm0 + (lane >> 2) + 8 * (k >> 1)) * kH +
           8 * (wn0 + n) + 2 * (lane & 3) + (k & 1);
  };
  float g5[4][4], gE[4][4], g7[4][4];

  const float t0 = __ldg(a.t01), t1 = __ldg(a.t01 + 1);
  const float span = fabsf(t0 - t1);
  const float direction = t0 > t1 ? 1.f : (t0 < t1 ? -1.f : 0.f);

  // the field at t1: FSAL stage, its q and its gradient sum, f1 and div1
  auto first_stage = [&]() {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) g5[n][k] = gE[n][k] = g7[n][k] = 0.f;
    for (int e = tid; e < kSmall; e += kThreads)
      s.sacc5[e] = s.saccE[e] = s.sacc7[e] = 0.f;
    for (int tile = tb0; tile < tb1; ++tile) {
      const int row0 = tile * kRows, rows = min(kRows, R - row0);
      __syncthreads();
      load_tile(row0, rows);
      if (tid < kTile) {
        const int r = tid / kLd, c = tid % kLd;
        const size_t row = static_cast<size_t>(row0) + r;
        float v = 0.f;
        if (r < rows) {
          if (c < 3) v = __ldg(a.y1 + row * 3 + c);
          else if (c < 6) v = __ldg(a.a1 + row * 3 + c - 3);
          else if (c == kLogp && kTrace) v = __ldg(a.logp1 + row);
        }
        s.xin[tid] = v;
      }
      cp_wait();
      __syncthreads();
      aug_field<kTrace>(s, t1, s.ks, Weights{0.f, 0.f, 1.f},
                        qbuf + static_cast<size_t>(row0) * kLdP, rows,
                        kReverse, g5, gE, g7);
      if (tid < rows * kLd) {
        const size_t at = static_cast<size_t>(row0) * kLd + tid;
        sbuf[at] = s.xin[tid];
        kbuf[at] = s.ks[tid];
      }
      for (int e = tid; e < rows * 8; e += kThreads) {
        const int r = e / 8, c = e % 8;
        float v = 0.f;
        if (c < 3) v = s.ks[r * kLd + c];
        else if (c == 3 && kTrace) v = -s.ks[r * kLd + kLogp];
        if (c < 4) a.out_bnd[(static_cast<size_t>(row0) + r) * 8 + c] = v;
      }
      for (int e = tid; e < rows * cdim; e += kThreads)
        dcbuf[static_cast<size_t>(row0) * cdim + e] = 0.f;
    }
    __syncthreads();
    {
      float* kg = kgb + static_cast<size_t>(b) * kGOwn;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) kg[w2_index(n, k)] = g7[n][k];
      for (int e = tid; e < kSmall; e += kThreads) kg[small_g(e)] = s.sacc7[e];
    }
    for (int e = b * kThreads + tid; e < ng; e += nb * kThreads) {
      gbuf[e] = 0.f;
      if (kSplit && a.gloc != nullptr) a.gloc[e] = 0.f;
    }
  };

  // One attempt from copy cs at (t, h_c), its index n: every block's
  // candidate rows into copy ns, its sums of G's quadratures (my5, myE)
  // and of the next FSAL stage's gradient, its rows' error terms into
  // prow_part[b] (partials of attempt parity n & 1).
  auto attempt = [&](float t, float h_c, size_t cs, int n) {
    const size_t ns = 1 - cs;
    // the sums start from the FSAL stage's gradient
    const float* kg1 = kgb + (cs * a.max_grid + b) * kGOwn;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = __ldcg(kg1 + w2_index(nn, k));
        g5[nn][k] = kB5[0] * v;
        gE[nn][k] = err_weight(0) * v;
        g7[nn][k] = 0.f;
      }
    __syncthreads();
    for (int e = tid; e < kSmall; e += kThreads) {
      const float v = __ldcg(kg1 + small_g(e));
      s.sacc5[e] = kB5[0] * v;
      s.saccE[e] = err_weight(0) * v;
      s.sacc7[e] = 0.f;
    }
    double prow = 0.0;  // thread 0's: this block's row terms in order
    for (int tile = tb0; tile < tb1; ++tile) {
      const int row0 = tile * kRows, rows = min(kRows, R - row0);
      __syncthreads();
      load_step(row0, rows, cs);
      cp_wait();
      __syncthreads();
      // q of the FSAL stage scaled into Q5 and QE
      for (int e = tid; e < kRows * kLdP; e += kThreads) {
        const float v = e / kLdP < rows && e % kLdP < kProj ? s.q5[e] : 0.f;
        s.q5[e] = kB5[0] * v;
        s.qe[e] = err_weight(0) * v;
      }
      __syncthreads();
      tick(kTkSetup);
#pragma unroll 1
      for (int i = 1; i < 7; ++i) {
        if (tid < kTile) {
          float acc = s.ks[tid] * (kA[i][0] * h_c);
          for (int jj = 1; jj < i; ++jj)
            acc += s.ks[jj * kTile + tid] * (kA[i][jj] * h_c);
          s.xin[tid] = s.ys[tid] + acc;
        }
        __syncthreads();
        tick(kTkInput);
        aug_field<kTrace>(
            s, t + kC[i] * h_c, s.ks + i * kTile,
            Weights{kB5[i], err_weight(i), i == 6 ? 1.f : 0.f},
            i == 6 ? qbuf + (ns * R + row0) * kLdP : nullptr, rows, kReverse,
            g5, gE, g7);
      }
      // the rows' dc: dc1 = dc0 - h Wc Q5, error -h Wc QE
      float sq = 0.f;
      if (kCondProducts)
        dc_tile<D::kMt>(s, reinterpret_cast<const float2*>(a.wct),
                        cdim / 8, dcbuf + cs * R * cdim,
                        dcbuf + ns * R * cdim, row0, rows, cdim, h_c,
                        a.rtol, a.atol, sq);
      tick(kTkDc);
      if (tid < rows * kLd) {
        const int c = tid % kLd;
        float s5 = s.ks[tid] * kB5[0];
        float se = s.ks[tid] * err_weight(0);
#pragma unroll
        for (int jj = 1; jj < 7; ++jj) {
          const float kj = s.ks[jj * kTile + tid];
          s5 += kB5[jj] * kj;
          se += err_weight(jj) * kj;
        }
        const float y = s.ys[tid];
        const float y5 = y + h_c * s5;
        if (c < 6 || (kTrace && c == kLogp)) {
          const float r = (h_c * se) /
                          (a.atol + a.rtol * fmaxf(fabsf(y), fabsf(y5)));
          sq = fmaf(r, r, sq);
        }
        const size_t at = (ns * R + row0) * kLd + tid;
        sbuf[at] = y5;
        kbuf[at] = s.ks[6 * kTile + tid];
      }
      // the tile's Q summed per condition row into this block's slots: a
      // condition row's first row in the block writes, later tiles add
      {
        const int c_lo = row0 / rep, c_hi = (row0 + rows - 1) / rep;
        constexpr int kQ4 = kLdP / 4;
        for (int e = tid; e < (c_hi - c_lo + 1) * kQ4; e += kThreads) {
          const int cr = c_lo + e / kQ4, col = 4 * (e % kQ4);
          const int r_lo = max(cr * rep, row0);
          const int r_hi = min(cr * rep + rep, row0 + rows);
          float4 v5 = make_float4(0.f, 0.f, 0.f, 0.f), vE = v5;
          for (int r = r_lo; r < r_hi; ++r) {
            const float4 q5 = *reinterpret_cast<const float4*>(
                s.q5 + (r - row0) * kLdP + col);
            const float4 qe = *reinterpret_cast<const float4*>(
                s.qe + (r - row0) * kLdP + col);
            v5 = make_float4(v5.x + q5.x, v5.y + q5.y, v5.z + q5.z,
                             v5.w + q5.w);
            vE = make_float4(vE.x + qe.x, vE.y + qe.y, vE.z + qe.z,
                             vE.w + qe.w);
          }
          float4* d5 = reinterpret_cast<float4*>(
              qc5 + static_cast<size_t>(cr + b) * kLdP + col);
          float4* dE = reinterpret_cast<float4*>(
              qcE + static_cast<size_t>(cr + b) * kLdP + col);
          if (r_lo > max(cr * rep, rb0)) {
            const float4 o5 = __ldcg(d5), oE = __ldcg(dE);
            v5 = make_float4(o5.x + v5.x, o5.y + v5.y, o5.z + v5.z,
                             o5.w + v5.w);
            vE = make_float4(oE.x + vE.x, oE.y + vE.y, oE.z + vE.z,
                             oE.w + vE.w);
          }
          *d5 = v5;
          *dE = vE;
        }
      }
      const float tile_sum = cnf_field::block_sum(sq, s.red);
      if (tid == 0) prow += static_cast<double>(tile_sum);
      tick(kTkTileEnd);
    }
    __syncthreads();
    // the block's sums of the layers' gradient (k = -dS/dtheta), and its
    // FSAL sum for the next step
    {
      float* kg = kgb + (ns * a.max_grid + b) * kGOwn;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int at = w2_index(nn, k);
          my5[at] = -g5[nn][k];
          myE[at] = -gE[nn][k];
          kg[at] = g7[nn][k];
        }
      for (int e = tid; e < kSmall; e += kThreads) {
        const int at = small_g(e);
        my5[at] = -s.sacc5[e];
        myE[at] = -s.saccE[e];
        kg[at] = s.sacc7[e];
      }
    }
    tick(kTkGradOut);
    if (kCondProducts) {
      // the projection matrix's cotangent -h c^T Q over this block's
      // condition rows (their Q summed over the repeats at each tile's end),
      // in chunks of kcr rows staged in shared memory
      const int cb0 = rb0 / rep, cb1 = (rb1 - 1) / rep + 1;
      const int ldc = cdim + 8;
      const int kcr = min(kCondRows, kUnion / (2 * kLdP + ldc) / 8 * 8);
      float* qs5 = s.u;
      float* qsE = qs5 + kcr * kLdP;
      float* c_s = qsE + kcr * kLdP;
      const int items = cdim / 16 * (kKt / 3);
      for (int k0 = cb0; k0 < cb1; k0 += kcr) {
        __syncthreads();
        for (int e = tid; e < kcr * (cdim / 4); e += kThreads) {
          const int kk = e / (cdim / 4), m = 4 * (e % (cdim / 4));
          float* dst = c_s + kk * ldc + m;
          if (k0 + kk < cb1)
            cp16(dst, a.c + static_cast<size_t>(k0 + kk) * cdim + m);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        for (int e = tid; e < kcr * (kLdP / 4); e += kThreads) {
          const int kk = e / (kLdP / 4), m = 4 * (e % (kLdP / 4));
          const size_t at = static_cast<size_t>(k0 + kk + b) * kLdP + m;
          if (k0 + kk < cb1) {
            cp16(qs5 + kk * kLdP + m, qc5 + at);
            cp16(qsE + kk * kLdP + m, qcE + at);
          } else {
            *reinterpret_cast<float4*>(qs5 + kk * kLdP + m) =
                make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(qsE + kk * kLdP + m) =
                make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        cp_wait();
        __syncthreads();
        for (int it = warp; it < items; it += kWarps) {
          const int m0 = 16 * (it / (kKt / 3)), n0 = 3 * (it % (kKt / 3));
          float a5[3][4] = {}, aE[3][4] = {};
          for (int kc = 0; kc < kcr / 8; ++kc)
            product_ctq<3>(a5, aE, c_s + 8 * kc * ldc, ldc,
                           qs5 + 8 * kc * kLdP, qsE + 8 * kc * kLdP, kLdP,
                           m0, n0, lane);
#pragma unroll
          for (int nn = 0; nn < 3; ++nn)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int at = kGOwn +
                  (m0 + (lane >> 2) + 8 * (k >> 1)) * kLdP +
                  8 * (n0 + nn) + 2 * (lane & 3) + (k & 1);
              my5[at] = (k0 == cb0 ? 0.f : my5[at]) - a5[nn][k];
              myE[at] = (k0 == cb0 ? 0.f : myE[at]) - aE[nn][k];
            }
        }
      }
      tick(kTkCtq);
    } else {
      for (int e = kGOwn + tid; e < ng; e += kThreads) my5[e] = myE[e] = 0.f;
    }
    double* prow_part = a.partials + static_cast<size_t>(n & 1) * 2 * nb;
    if (tid == 0) prow_part[b] = prow;
    __threadfence();
  };

  // G's entry e stepped from copy cs to ns by the quadrature sums s5, se
  // of the whole batch -> its error ratio
  auto g_step = [&](int e, float s5, float se, float h_c, size_t cs) {
    const float g0 = __ldcg(gbuf + cs * ng + e);
    const float g1 = g0 + h_c * s5;
    gbuf[(1 - cs) * ng + e] = g1;
    return (h_c * se) / (a.atol + a.rtol * fmaxf(fabsf(g0), fabsf(g1)));
  };
  // this block's G entries e = b kThreads + tid + i nb kThreads, and the
  // sums of each over the blocks of this rank in block order
  auto block_order = [&](int e, float& s5, float& se) {
    s5 = 0.f;
    se = 0.f;
#pragma unroll 16
    for (int bb = 0; kGReduce && bb < nb; ++bb) {
      s5 += __ldcg(part + 2 * static_cast<size_t>(bb) * ng + e);
      se += __ldcg(part + (2 * static_cast<size_t>(bb) + 1) * ng + e);
    }
  };
  // the step controller on the total of the ranks' row terms (in rank
  // order) and the blocks' G terms of attempt n, over `count` entries:
  // the same decision in every block
  auto control = [&](double rows, double count, float t, float h_c, int n) {
    double* pg_part = a.partials + static_cast<size_t>(n & 1) * 2 * nb + nb;
    if (tid < 32) {
      const double total = rows + cnf_field::grid_total(pg_part, nb);
      if (tid == 0)
        cnf_field::control(sqrtf(static_cast<float>(total / count) + 1e-24f),
                           t, h_c, s.ctrl);
    }
    __syncthreads();
  };

  // outputs: y0, a0, dc, G (this rank's), and the field at t0 with its
  // trace
  auto finish = [&](int cur, int n, int accepted) {
    const size_t cs = static_cast<size_t>(cur);
    const float* g_out = kSplit && a.gloc != nullptr ? a.gloc : gbuf;
    for (int e = b * kThreads + tid; e < ng; e += nb * kThreads)
      a.out_g[e] = __ldcg(g_out + cs * ng + e);
    for (int tile = tb0; tile < tb1; ++tile) {
      const int row0 = tile * kRows, rows = min(kRows, R - row0);
      __syncthreads();
      load_tile(row0, rows);
      if (tid < kTile) {
        const bool valid = tid < rows * kLd;
        s.xin[tid] = valid ? __ldcg(sbuf + (cs * R + row0) * kLd + tid) : 0.f;
      }
      cp_wait();
      __syncthreads();
      aug_field<kTrace>(s, t0, s.ks, Weights{0.f, 0.f, 0.f}, nullptr, rows,
                        false, g5, gE, g7);
      for (int e = tid; e < rows * 8; e += kThreads) {
        const int r = e / 8, c = e % 8;
        const size_t row = static_cast<size_t>(row0) + r;
        if (c < 3) {
          a.out_y0[row * 3 + c] = s.xin[r * kLd + c];
          a.out_a0[row * 3 + c] = s.xin[r * kLd + kA0 + c];
        } else if (c >= 4) {
          a.out_bnd[row * 8 + c] =
              c < 7 ? s.ks[r * kLd + c - 4]
                    : (kTrace ? -s.ks[r * kLd + kLogp] : 0.f);
        }
      }
      for (int e = tid; e < rows * cdim; e += kThreads)
        a.out_dc[static_cast<size_t>(row0) * cdim + e] =
            __ldcg(dcbuf + (cs * R + row0) * cdim + e);
    }
    if (b == 0 && tid == 0) {
      a.stats[0] = n;
      a.stats[1] = accepted;
    }
  };

  // the plain state's size: this rank's rows (padded condition columns
  // add no error), and G once
  const double count_rows =
      (kTrace ? 8.0 : 6.0) * R + static_cast<double>(a.cdim_true) * R;
  const double count_g = kGOwn + 262.0 * a.cdim_true;
  float t = t1, h = direction * span / 16.f;
  bool done = span <= 1e-12f;
  int n = 0, accepted = 0, cur = 0;

  if constexpr (!kSplit) {
    first_stage();
    clock_reset();
    while (!done && n < a.max_steps) {
      const float remaining = t0 - t;
      const float h_c = fabsf(h) > fabsf(remaining) ? remaining : h;
      const size_t cs = static_cast<size_t>(cur);
      attempt(t, h_c, cs, n);
      grid.sync();
      tick(kTkSync1);
      // G: every entry reduced over the blocks in block order by one thread
      float gsq = 0.f;
      for (int e = b * kThreads + tid; e < ng; e += nb * kThreads) {
        float s5, se;
        block_order(e, s5, se);
        const float rr = g_step(e, s5, se, h_c, cs);
        gsq = fmaf(rr, rr, gsq);
      }
      const float g_sum = cnf_field::block_sum(gsq, s.red);
      double* prow_part = a.partials + static_cast<size_t>(n & 1) * 2 * nb;
      if (tid == 0) prow_part[nb + b] = static_cast<double>(g_sum);
      __threadfence();
      grid.sync();
      tick(kTkReduce);
      double rows = 0.0;
      if (tid < 32) rows = cnf_field::grid_total(prow_part, nb);
      control(rows, count_rows + count_g, t, h_c, n);
      tick(kTkControl);
      t = s.ctrl[0];
      h = s.ctrl[1];
      if (s.ctrl[2] != 0.f) {
        cur ^= 1;
        ++accepted;
      }
      done = fabsf(t - t1) >= span - 1e-9f;
      ++n;
    }
    if (kClock && b == 0 && tid == 0) {
      printf("clock trace %d rows %d attempts %d:", kTrace ? 1 : 0, R, n);
      for (int i = 0; i < kPhases; ++i) printf(" %lld", clk[i]);
      printf("\n");
    }
    finish(cur, n, accepted);
  } else {
    // this rank's sums of an attempt, exchanged between launches: S5 and
    // SE of G [2][ng], then its row terms and entries (doubles) and the
    // grid (a float); `exchange` holds every rank's in rank order
    const size_t stride = 2 * static_cast<size_t>(ng) + kExchangeTail;
    if (a.attempt == 0) {
      first_stage();
    } else {
      // decide attempt n - 1 from the exchange: G stepped by the ranks'
      // sums added in rank order, this rank's own part by its own sums
      const int* prev = a.ctrl + 8 * ((a.attempt - 1) & 1);
      t = __int_as_float(prev[0]);
      h = __int_as_float(prev[1]);
      cur = prev[2];
      n = prev[3];
      accepted = prev[4];
      const float remaining = t0 - t;
      const float h_c = fabsf(h) > fabsf(remaining) ? remaining : h;
      const size_t cs = static_cast<size_t>(cur);
      float gsq = 0.f;
      for (int e = b * kThreads + tid; e < ng; e += nb * kThreads) {
        float s5 = __ldcg(a.exchange + e);
        float se = __ldcg(a.exchange + ng + e);
        for (int w = 1; w < a.world; ++w) {
          s5 += __ldcg(a.exchange + w * stride + e);
          se += __ldcg(a.exchange + w * stride + ng + e);
        }
        const float rr = g_step(e, s5, se, h_c, cs);
        gsq = fmaf(rr, rr, gsq);
        if (a.gloc != nullptr)
          a.gloc[(1 - cs) * ng + e] =
              __ldcg(a.gloc + cs * ng + e) + h_c * __ldcg(a.local + e);
      }
      const float g_sum = cnf_field::block_sum(gsq, s.red);
      double* prow_part = a.partials + static_cast<size_t>(n & 1) * 2 * nb;
      if (tid == 0) prow_part[nb + b] = static_cast<double>(g_sum);
      __threadfence();
      grid.sync();
      double rows = 0.0, count = 0.0;
      if (tid < 32) {
        for (int w = 0; w < a.world; ++w) {
          const double* tail = reinterpret_cast<const double*>(
              a.exchange + w * stride + 2 * ng);
          rows += tail[0];
          count += tail[1];
        }
      }
      control(rows, count + count_g, t, h_c, n);
      t = s.ctrl[0];
      h = s.ctrl[1];
      if (s.ctrl[2] != 0.f) {
        cur ^= 1;
        ++accepted;
      }
      done = fabsf(t - t1) >= span - 1e-9f;
      ++n;
    }
    const bool finished = done || n >= a.max_steps;
    if (b == 0 && tid == 0) {
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
    const float remaining = t0 - t;
    const float h_c = fabsf(h) > fabsf(remaining) ? remaining : h;
    attempt(t, h_c, static_cast<size_t>(cur), n);
    grid.sync();
    // this rank's sums: G's quadratures over its blocks in block order,
    // its rows' error terms and their count
    for (int e = b * kThreads + tid; e < ng; e += nb * kThreads) {
      float s5, se;
      block_order(e, s5, se);
      a.local[e] = s5;
      a.local[ng + e] = se;
    }
    if (b == 0 && tid < 32) {
      const double* prow_part =
          a.partials + static_cast<size_t>(n & 1) * 2 * nb;
      const double rows = cnf_field::grid_total(prow_part, nb);
      if (tid == 0) {
        double* tail = reinterpret_cast<double*>(a.local + 2 * ng);
        tail[0] = rows;
        tail[1] = count_rows;
        a.local[2 * ng + 4] = static_cast<float>(nb);
        a.local[2 * ng + 5] = 0.f;
      }
    }
  }
}

// The blocks of the one-launch kernel on the current card (the grid of
// either mode), found once a card.
template <bool kTrace>
cudaError_t resident_blocks(int dev, int* blocks) {
  static std::atomic<int> resident[kMaxDevices];
  int found = resident[dev].load(std::memory_order_relaxed);
  if (found == 0) {
    const size_t smem = sizeof(float) * kSmemFloats;
    int sms = 0, coop = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess)
      return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaFuncSetAttribute(
             cnf_adjoint_kernel<kTrace, false>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, cnf_adjoint_kernel<kTrace, false>, kThreads, smem)) !=
        cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    found = sms * per_sm;
    resident[dev].store(found, std::memory_order_relaxed);
  }
  *blocks = found;
  return cudaSuccess;
}

// One cooperative launch of either mode on the one-launch kernel's grid.
template <bool kTrace, bool kSplit>
cudaError_t launch(const AdjArgs& args, int dev, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kSmemFloats;
  int blocks = 0;
  cudaError_t err;
  if constexpr (!kSplit) {
    if ((err = resident_blocks<kTrace>(dev, &blocks)) != cudaSuccess)
      return err;
  } else {
    if ((err = adjoint_resident_blocks(kTrace, dev, &blocks)) != cudaSuccess)
      return err;
    static std::atomic<bool> set[kMaxDevices];
    if (!set[dev].load(std::memory_order_relaxed)) {
      if ((err = cudaFuncSetAttribute(
               cnf_adjoint_kernel<kTrace, true>,
               cudaFuncAttributeMaxDynamicSharedMemorySize,
               static_cast<int>(smem))) != cudaSuccess)
        return err;
      set[dev].store(true, std::memory_order_relaxed);
    }
  }
  const int tiles = (args.n_rows + Dims<kTrace>::kRows - 1) /
                    Dims<kTrace>::kRows;
  int grid = blocks;
  if (grid > tiles) grid = tiles;
  if (grid > args.max_grid) grid = args.max_grid;
  AdjArgs copy = args;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cnf_adjoint_kernel<kTrace, kSplit>), dim3(grid),
      dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks the arguments of either entry and fills every field the two
// modes share; returns cudaErrorInvalidValue for arguments the kernel does
// not take (`puflow_cnf_adjoint` states them).
inline cudaError_t fill_args(
    AdjArgs& args, const void* y1, const void* logp1, const void* a1,
    const void* ap, const void* c, const void* proj, const void* weights,
    const void* wct, const void* t01, int n_rows, int rep, int cdim,
    int cdim_true, float rtol, float atol, int max_steps, void* rows,
    long long rows_floats, void* per_grid, long long per_grid_floats,
    void* partials, long long partials_doubles, int max_grid, void* out_y0,
    void* out_a0, void* out_dc, void* out_g, void* out_bnd, void* stats) {
  if (n_rows < 1 || rep < 1 || n_rows % rep != 0 || max_grid < 1 ||
      cdim < 16 || cdim % 16 != 0 || cdim > 4096 || cdim_true < 0 ||
      cdim_true > cdim)
    return cudaErrorInvalidValue;
  const long long ng = kGOwn + static_cast<long long>(cdim) * kLdP;
  if (rows_floats < static_cast<long long>(n_rows) * (4 * kLd + 2 * kLdP +
                                                      2 * cdim) +
                        2LL * kLdP * (n_rows / rep + max_grid) ||
      per_grid_floats < max_grid * (2 * ng + 2 * kGOwn) + 2 * ng ||
      partials_doubles < 4LL * max_grid)
    return cudaErrorInvalidValue;
  args = AdjArgs{};
  args.y1 = static_cast<const float*>(y1);
  args.logp1 = static_cast<const float*>(logp1);
  args.a1 = static_cast<const float*>(a1);
  args.ap = static_cast<const float*>(ap);
  args.c = static_cast<const float*>(c);
  args.proj = static_cast<const float*>(proj);
  args.weights = static_cast<const float*>(weights);
  args.wct = static_cast<const float*>(wct);
  args.t01 = static_cast<const float*>(t01);
  args.rows = static_cast<float*>(rows);
  args.per_grid = static_cast<float*>(per_grid);
  args.partials = static_cast<double*>(partials);
  args.out_y0 = static_cast<float*>(out_y0);
  args.out_a0 = static_cast<float*>(out_a0);
  args.out_dc = static_cast<float*>(out_dc);
  args.out_g = static_cast<float*>(out_g);
  args.out_bnd = static_cast<float*>(out_bnd);
  args.stats = static_cast<int*>(stats);
  args.n_rows = n_rows;
  args.rep = rep;
  args.cdim = cdim;
  args.cdim_true = cdim_true;
  args.max_steps = max_steps;
  args.max_grid = max_grid;
  args.rtol = rtol;
  args.atol = atol;
  return cudaSuccess;
}

// The current card, checked against the devices a launch may go to.
inline cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev < 0 || *dev >= kMaxDevices ? cudaErrorInvalidDevice
                                         : cudaSuccess;
}

}  // namespace
}  // namespace puflow
