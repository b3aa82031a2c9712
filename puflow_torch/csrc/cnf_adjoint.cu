// Backward solve of one CNF block's continuous adjoint in one launch.
//
// Replaces the TPU kernel `cnf_adjoint_bwd_pallas`
// (puflow_tpu/ops/pallas/cnf_adjoint_pallas.py, `_cnf_adjoint_kernel`).
// It computes what the plain version, `cnf_adjoint_bwd_plain` in
// puflow_torch/ops/cnf.py (`models.ode.adjoint_backward`), computes: the
// dopri5 integration from t1 back to t0 of the augmented system
//   dy/dt = f,  [dlogp/dt = -div f],  da/dt = -dS/dy,  dg/dt = -dS/dtheta,
// S = a . f - a_p . div f with a_p constant, f the ConcatSquashLinear +
// tanh field of `cnf_field.cuh`, theta = (the layers' parameters, the
// per-row conditions c). Without the trace (the inverse pass, whose
// log-density is discarded) there is no logp and no div term. The vjp of
// the field is written out by hand: the primal's backprop, and with the
// trace the reverse of the three tangent chains, both reusing the forward's
// sigmoid and tanh values (the TPU kernel's derivation,
// cnf_adjoint_pallas.py:1-37).
//
// The solve matches the plain version step for step: ONE step size for all
// rows, FSAL, and the error norm over every leaf of the plain state: y,
// logp, a, a_p (zero error, but counted), dc per row of y, and the summed
// parameter gradient G. So each attempt needs G's two quadrature sums (the
// B5- and the error-weighted) over all rows before the step can be judged.
//
// Design.
//  * One cooperative launch of as many blocks as fit the card at once, one
//    block an SM (the occupancy API decides), no host read. Block b owns
//    super-tiles b, b + grid, ... of kSuper rows; it runs each super-tile
//    in field tiles of kRows rows through the six stages of a step out of
//    shared memory. Rows past the last add nothing anywhere: their y, a
//    and a_p are zero, so every cotangent they produce is zero.
//  * The layers' gradients (5,004 floats) are summed per block in shared
//    memory: B5-weighted, error-weighted, and the last stage's own (the
//    next step's first, FSAL), in the order the block visits its rows.
//  * The condition enters only through the projections gate_c | bias_c
//    (262 floats a row), and c is constant along the solve, so the
//    cotangents of the conditions and of the projection matrix factor
//    through the per-row cotangents q of those projections: a row's dc
//    moves by -h Wc Q and the matrix's gradient by -h c^T Q, Q the stage
//    sum of q. Both products are formed once an attempt for a super-tile
//    (its Q in shared memory), not once a stage. The matrix's part is
//    accumulated into the block's slice of a [grid][2][NG] scratch.
//  * After the blocks' passes one grid.sync; then every thread of the grid
//    reduces a fixed set of G's entries over the blocks in block order,
//    forms g1 = g0 + h S5 and the entry's error term, and writes g1 to the
//    other of two copies of G; a second grid.sync; every block sums the
//    norm's partials in the same fixed order and takes the same decision.
//    So two runs agree bit for bit.
//  * Row state (y, a, logp; the FSAL stage; q of the FSAL stage; dc) lives
//    in device memory in two copies, flipped on accept together with G and
//    each block's FSAL gradient sum.
//  * The conditions may serve `rep` consecutive rows each (the inverse
//    pass): they are indexed in place, and dc is kept per row of y, so the
//    norm counts dc over the repeated rows as the plain version, which
//    repeats c, does; the wrapper sums the repeats.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

#include "cnf_field.cuh"

namespace cg = cooperative_groups;

namespace puflow {
namespace {

using namespace cnf_field;

constexpr int kRows = 8;             // field tile
constexpr int kSubTiles = 4;
constexpr int kSuper = kRows * kSubTiles;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kLd = 8;               // row state: y 0-2, a 3-5, logp 6
constexpr int kTile = kRows * kLd;
constexpr int kA0 = 3;
constexpr int kLogp = 6;
// the packed gradient of the layers (positive dS/dtheta in shared memory):
// per layer W [in, out], then db, dgate_t, dbias_t, dgate_b [out] each
constexpr int gW1 = 0;
constexpr int gV1 = gW1 + 3 * kH;
constexpr int gW2 = gV1 + 4 * kH;
constexpr int gV2 = gW2 + kH * kH;
constexpr int gW3 = gV2 + 4 * kH;
constexpr int gV3 = gW3 + kH * 3;
constexpr int kGOwn = gV3 + 12;      // 5,004; then [cdim][kLdP] for c
static_assert(kGOwn == 5004 && kGOwn % 4 == 0, "gradient layout");

template <bool kTrace>
constexpr int smem_floats() {
  return kSmemW + kRows * kLdP + 8 + 6 * kRows * kH + 12 * kRows +
         (kTrace ? 6 * kRows * kH : 0) +                    // u1, v2
         (kTrace ? 10 * kRows * kH : 2 * kRows * kH) +      // reverse
         4 * kRows + kRows * kLdP +                         // dh3, q
         9 * kTile + 2 * kSuper * kLdP + 3 * kGOwn + 16;
}

struct AdjArgs {
  const float* y1;       // [n_rows, 3]
  const float* logp1;    // [n_rows]
  const float* a1;       // [n_rows, 3]
  const float* ap;       // [n_rows]
  const float* c;        // [n_rows / rep, cdim]
  const float* proj;     // [n_rows / rep, kProj]
  const float* weights;  // [kWeights]
  const float* wct;      // [kProj, cdim]: the projection matrix, transposed
  const float* t01;      // t0, t1
  float* rows;           // y | a | logp [2][n_rows][8], FSAL stage [2][n_rows]
                         // [8], its q [2][n_rows][264], dc [2][n_rows][cdim]
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
};

struct Rev {
  float *cv2, *cu1;      // [3][kRows][kH] (trace)
  float *cxt, *cs2;      // [kRows][kH] (trace)
  float *dh2, *dh1;      // [kRows][kH]
  float* dh3;            // [kRows][3] (+pad)
  float* q;              // [kRows][kLdP]
};

// The augmented field on a field tile: the forward of `cnf_field.cuh`,
// then the vjp with cotangent a (channels kA0.. of x) and, with the trace,
// -a_p on the divergence. Writes (f, -dS/dy, -div) into kout (stride kLd);
// adds w5, wE, w7 times the layers' gradient dS/dtheta of the tile into
// acc5, accE, acc7; adds w5, wE times q into the super-tile's Q5 / QE rows
// and, if q_out is not null, stores q of the tile's valid rows there.
template <bool kTrace>
__device__ void aug_field(const float* __restrict__ w, const float* proj,
                          const float* ap, float t, const float* x,
                          const Act& act, const Rev& rv, float* kout,
                          float* q5, float* qe, float w5, float wE, float w7,
                          float* acc5, float* accE, float* acc7,
                          float* q_out, int rows) {
  const int tid = threadIdx.x;
  forward<kRows, kTrace>(w, proj, t, x, kLd, act, kout, kLd, kLogp);
  // layer 3's cotangents, and the tangents' reverse through layer 2
  for (int e = tid; e < kRows * 3; e += kThreads) {
    const int r = e / 3, c = e % 3;
    const float a = x[r * kLd + kA0 + c], s = act.s3[e];
    const float cs = kTrace ? -ap[r] * act.v3[e] : 0.f;
    rv.dh3[e] = a * s;
    rv.q[r * kLdP + 4 * kH + c] = (a * act.h3[e] + cs) * s * (1.f - s);
    rv.q[r * kLdP + 4 * kH + 3 + c] = a;
  }
  if (kTrace) {
    for (int e = tid; e < kRows * kH; e += kThreads) {
      const int r = e / kH, j = e % kH;
      const float x2 = act.x2[e], s2 = act.s2[e], m2 = 1.f - x2 * x2;
      float cm = 0.f, cs = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float cu = -ap[r] * act.s3[r * 3 + k] * w[sW3 + j * 3 + k];
        const float v = act.v2[k * kRows * kH + e];
        const float cw = cu * m2;
        cm = fmaf(cu, v * s2, cm);
        cs = fmaf(cw, v, cs);
        rv.cv2[k * kRows * kH + e] = cw * s2;
      }
      rv.cxt[e] = -2.f * x2 * cm;
      rv.cs2[e] = cs;
    }
  }
  __syncthreads();
  // layer 2's cotangents; the tangents' cu1 = cv2 W2^T
  for (int e = tid; e < kRows * kH; e += kThreads) {
    const int r = e / kH, j = e % kH;
    float cx = rv.dh3[r * 3] * w[sW3 + j * 3] +
               rv.dh3[r * 3 + 1] * w[sW3 + j * 3 + 1] +
               rv.dh3[r * 3 + 2] * w[sW3 + j * 3 + 2];
    if (kTrace) cx += rv.cxt[e];
    const float x2 = act.x2[e], s2 = act.s2[e];
    const float dz = cx * (1.f - x2 * x2);
    const float cs = kTrace ? rv.cs2[e] : 0.f;
    rv.dh2[e] = dz * s2;
    rv.q[r * kLdP + 2 * kH + j] = (dz * act.h2[e] + cs) * s2 * (1.f - s2);
    rv.q[r * kLdP + 3 * kH + j] = dz;
  }
  if (kTrace) {
    for (int e = tid; e < 3 * kRows * kH; e += kThreads) {
      const int rk = e / kH, i = e % kH;
      const float* cv = rv.cv2 + rk * kH;
      const float* wi = w + sW2 + i * kLdW2;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < kH; ++j) acc = fmaf(cv[j], wi[j], acc);
      rv.cu1[e] = acc;
    }
  }
  __syncthreads();
  // layer 1's cotangents; cu1 becomes cv1 in place
  for (int e = tid; e < kRows * kH; e += kThreads) {
    const int r = e / kH, i = e % kH;
    const float* dh = rv.dh2 + r * kH;
    const float* wi = w + sW2 + i * kLdW2;
    float cx = 0.f;
#pragma unroll 8
    for (int j = 0; j < kH; ++j) cx = fmaf(dh[j], wi[j], cx);
    const float x1 = act.x1[e], s1 = act.s1[e], m1 = 1.f - x1 * x1;
    float cs = 0.f;
    if (kTrace) {
      float cm = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float cu = rv.cu1[k * kRows * kH + e];
        const float w1 = w[sW1 + k * kH + i];
        const float cw = cu * m1;
        cm = fmaf(cu, w1 * s1, cm);
        cs = fmaf(cw, w1, cs);
        rv.cu1[k * kRows * kH + e] = cw * s1;
      }
      cx = fmaf(-2.f * x1, cm, cx);
    }
    const float dz = cx * m1;
    rv.dh1[e] = dz * s1;
    rv.q[r * kLdP + i] = (dz * act.h1[e] + cs) * s1 * (1.f - s1);
    rv.q[r * kLdP + kH + i] = dz;
  }
  __syncthreads();
  // -dS/dy
  for (int e = tid; e < kRows * 3; e += kThreads) {
    const int r = e / 3, k = e % 3;
    const float* dh = rv.dh1 + r * kH;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < kH; ++j) acc = fmaf(dh[j], w[sW1 + k * kH + j], acc);
    kout[r * kLd + kA0 + k] = -acc;
  }
  // the layers' gradients, summed over the tile's rows
  for (int e = tid; e < kGOwn; e += kThreads) {
    float v = 0.f;
    if (e < gV1) {                                   // W1 [3][64]
      const int k = e / kH, j = e % kH;
      for (int r = 0; r < kRows; ++r) {
        v = fmaf(x[r * kLd + k], rv.dh1[r * kH + j], v);
        if (kTrace) v += rv.cu1[(k * kRows + r) * kH + j];
      }
    } else if (e < gW2) {                            // layer 1's vectors
      const int part = (e - gV1) / kH, j = (e - gV1) % kH;
      for (int r = 0; r < kRows; ++r)
        v += part == 0 ? rv.dh1[r * kH + j]
             : part == 2 ? rv.q[r * kLdP + kH + j]
                         : rv.q[r * kLdP + j];
      if (part == 1 || part == 2) v *= t;
    } else if (e < gV2) {                            // W2 [64][64]
      const int i = (e - gW2) / kH, j = (e - gW2) % kH;
      for (int r = 0; r < kRows; ++r) {
        v = fmaf(act.x1[r * kH + i], rv.dh2[r * kH + j], v);
        if (kTrace)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            v = fmaf(act.u1[(k * kRows + r) * kH + i],
                     rv.cv2[(k * kRows + r) * kH + j], v);
      }
    } else if (e < gW3) {                            // layer 2's vectors
      const int part = (e - gV2) / kH, j = (e - gV2) % kH;
      for (int r = 0; r < kRows; ++r)
        v += part == 0 ? rv.dh2[r * kH + j]
             : part == 2 ? rv.q[r * kLdP + 3 * kH + j]
                         : rv.q[r * kLdP + 2 * kH + j];
      if (part == 1 || part == 2) v *= t;
    } else if (e < gV3) {                            // W3 [64][3]
      const int j = (e - gW3) / 3, c = (e - gW3) % 3;
      for (int r = 0; r < kRows; ++r) {
        const int rj = r * kH + j;
        v = fmaf(act.x2[rj], rv.dh3[r * 3 + c], v);
        if (kTrace) {
          const float x2 = act.x2[rj];
          const float u2 = act.v2[(c * kRows + r) * kH + j] * act.s2[rj] *
                           (1.f - x2 * x2);
          v = fmaf(u2, -ap[r] * act.s3[r * 3 + c], v);
        }
      }
    } else {                                         // layer 3's vectors
      const int part = (e - gV3) / 3, c = (e - gV3) % 3;
      for (int r = 0; r < kRows; ++r)
        v += part == 0 ? rv.dh3[r * 3 + c]
             : part == 2 ? rv.q[r * kLdP + 4 * kH + 3 + c]
                         : rv.q[r * kLdP + 4 * kH + c];
      if (part == 1 || part == 2) v *= t;
    }
    acc5[e] = fmaf(w5, v, acc5[e]);
    accE[e] = fmaf(wE, v, accE[e]);
    acc7[e] = fmaf(w7, v, acc7[e]);
  }
  // the projections' cotangents q into the super-tile's stage sums
  for (int e = tid; e < kRows * kLdP; e += kThreads) {
    const float qv = rv.q[e];
    q5[e] = fmaf(w5, qv, q5[e]);
    qe[e] = fmaf(wE, qv, qe[e]);
    if (q_out != nullptr && e / kLdP < rows) q_out[e] = qv;
  }
  __syncthreads();
}

template <bool kTrace>
__global__ void __launch_bounds__(kThreads, 1)
cnf_adjoint_kernel(AdjArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;
  float* proj_s = w_s + kSmemW;               // [kRows][kLdP]
  float* ap_s = proj_s + kRows * kLdP;        // [kRows] (+pad to 8)
  float* p = ap_s + 8;
  Act act;
  act.h1 = p; act.s1 = p + kRows * kH; act.x1 = p + 2 * kRows * kH;
  act.h2 = p + 3 * kRows * kH; act.s2 = p + 4 * kRows * kH;
  act.x2 = p + 5 * kRows * kH;
  p += 6 * kRows * kH;
  act.h3 = p; act.s3 = p + 3 * kRows; act.v3 = p + 6 * kRows;
  act.dterm = p + 9 * kRows;
  p += 12 * kRows;
  Rev rv;
  if (kTrace) {
    act.u1 = p; act.v2 = p + 3 * kRows * kH;
    p += 6 * kRows * kH;
    rv.cv2 = p; rv.cu1 = p + 3 * kRows * kH;
    p += 6 * kRows * kH;
    rv.cxt = p; rv.cs2 = p + kRows * kH;
    p += 2 * kRows * kH;
  } else {
    act.u1 = act.v2 = rv.cv2 = rv.cu1 = rv.cxt = rv.cs2 = nullptr;
  }
  rv.dh2 = p; rv.dh1 = p + kRows * kH;
  p += 2 * kRows * kH;
  rv.dh3 = p;
  p += 4 * kRows;
  rv.q = p;                                   // [kRows][kLdP]
  p += kRows * kLdP;
  float* ks = p;                              // [7][kRows][kLd] stages
  float* ys = ks + 7 * kTile;                 // [kRows][kLd] state
  float* xin = ys + kTile;                    // [kRows][kLd] stage input
  float* q5 = xin + kTile;                    // [kSuper][kLdP] stage sums
  float* qe = q5 + kSuper * kLdP;
  float* acc5 = qe + kSuper * kLdP;           // [kGOwn] x 3
  float* accE = acc5 + kGOwn;
  float* acc7 = accE + kGOwn;
  float* red = acc7 + kGOwn;                  // [8] warp sums
  float* ctrl = red + 8;                      // [8] the controller's scalars

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, b = blockIdx.x, nb = gridDim.x;
  const int R = a.n_rows, cdim = a.cdim;
  const int ng = kGOwn + cdim * kLdP;
  const int n_super = (R + kSuper - 1) / kSuper;
  // row buffers
  float* sbuf = a.rows;                                   // [2][R][kLd]
  float* kbuf = sbuf + 2 * static_cast<size_t>(R) * kLd;  // [2][R][kLd]
  float* qbuf = kbuf + 2 * static_cast<size_t>(R) * kLd;  // [2][R][kLdP]
  float* dcbuf = qbuf + 2 * static_cast<size_t>(R) * kLdP;  // [2][R][cdim]
  // grid buffers
  float* part = a.per_grid;                               // [grid][2][ng]
  float* kgb = part + 2 * static_cast<size_t>(a.max_grid) * ng;
  float* gbuf = kgb + 2 * static_cast<size_t>(a.max_grid) * kGOwn;
  float* my5 = part + 2 * static_cast<size_t>(b) * ng;
  float* myE = my5 + ng;

  load_weights(a.weights, w_s);
  for (int e = tid; e < kRows * kLdP; e += kThreads) rv.q[e] = 0.f;

  auto load_tile = [&](int row0, int rows) {
    for (int e = tid; e < kRows * kProj; e += kThreads) {
      const int r = e / kProj, col = e % kProj;
      proj_s[r * kLdP + col] =
          r < rows ? __ldg(a.proj + static_cast<size_t>((row0 + r) / a.rep) *
                                        kProj + col)
                   : 0.f;
    }
    if (tid < kRows)
      ap_s[tid] = kTrace && tid < rows ? __ldg(a.ap + row0 + tid) : 0.f;
  };

  const float t0 = __ldg(a.t01), t1 = __ldg(a.t01 + 1);
  const float span = fabsf(t0 - t1);
  const float direction = t0 > t1 ? 1.f : (t0 < t1 ? -1.f : 0.f);

  // the field at t1: FSAL stage, its q and its gradient sum, f1 and div1
  for (int e = tid; e < kGOwn; e += kThreads)
    acc5[e] = accE[e] = acc7[e] = 0.f;
  for (int e = tid; e < kSuper * kLdP; e += kThreads) q5[e] = qe[e] = 0.f;
  for (int st = b; st < n_super; st += nb) {
    for (int sub = 0; sub < kSubTiles; ++sub) {
      const int row0 = st * kSuper + sub * kRows;
      const int rows = min(kRows, R - row0);
      if (rows <= 0) break;
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
        xin[tid] = v;
      }
      __syncthreads();
      aug_field<kTrace>(w_s, proj_s, ap_s, t1, xin, act, rv, ks, q5, qe, 0.f,
                        0.f, 1.f, acc5, accE, acc7,
                        qbuf + static_cast<size_t>(row0) * kLdP, rows);
      if (tid < rows * kLd) {
        const size_t g = static_cast<size_t>(row0) * kLd + tid;
        sbuf[g] = xin[tid];
        kbuf[g] = ks[tid];
      }
      for (int e = tid; e < rows * 8; e += kThreads) {
        const int r = e / 8, c = e % 8;
        float v = 0.f;
        if (c < 3) v = ks[r * kLd + c];
        else if (c == 3 && kTrace) v = -ks[r * kLd + kLogp];
        if (c < 4) a.out_bnd[(static_cast<size_t>(row0) + r) * 8 + c] = v;
      }
      for (int e = tid; e < rows * cdim; e += kThreads)
        dcbuf[static_cast<size_t>(row0) * cdim + e] = 0.f;
    }
  }
  __syncthreads();
  for (int e = tid; e < kGOwn; e += kThreads)
    kgb[static_cast<size_t>(b) * kGOwn + e] = acc7[e];
  for (int e = b * kThreads + tid; e < ng; e += nb * kThreads) gbuf[e] = 0.f;

  // the plain state's size; padded condition columns add no error
  const double count = (kTrace ? 8.0 : 6.0) * R +
                       static_cast<double>(a.cdim_true) * R +
                       (kGOwn + 262.0 * a.cdim_true);
  float t = t1, h = direction * span / 16.f;
  bool done = span <= 1e-12f;
  int n = 0, accepted = 0, cur = 0;
  while (!done && n < a.max_steps) {
    const float remaining = t0 - t;
    const float h_c = fabsf(h) > fabsf(remaining) ? remaining : h;
    const size_t cs = static_cast<size_t>(cur), ns = 1 - cs;
    const float* kg1 = kgb + (cs * a.max_grid + b) * kGOwn;
    __syncthreads();
    for (int e = tid; e < kGOwn; e += kThreads) {
      const float v = __ldcg(kg1 + e);
      acc5[e] = kB5[0] * v;
      accE[e] = err_weight(0) * v;
      acc7[e] = 0.f;
    }
    for (int e = kGOwn + tid; e < ng; e += kThreads) my5[e] = myE[e] = 0.f;
    double prow = 0.0;  // thread 0's: this block's row terms in order
    for (int st = b; st < n_super; st += nb) {
      const int srow0 = st * kSuper;
      const int srows = min(kSuper, R - srow0);
      __syncthreads();
      for (int e = tid; e < kSuper * kLdP; e += kThreads) {
        const float v = e / kLdP < srows
            ? __ldcg(qbuf + (cs * R + srow0) * kLdP + e) : 0.f;
        q5[e] = kB5[0] * v;
        qe[e] = err_weight(0) * v;
      }
      for (int sub = 0; sub < kSubTiles; ++sub) {
        const int row0 = srow0 + sub * kRows;
        const int rows = min(kRows, R - row0);
        if (rows <= 0) break;
        float* q5s = q5 + sub * kRows * kLdP;
        float* qes = qe + sub * kRows * kLdP;
        __syncthreads();
        load_tile(row0, rows);
        if (tid < kTile) {
          const size_t g = (cs * R + row0) * kLd + tid;
          const bool valid = tid < rows * kLd;
          ys[tid] = valid ? __ldcg(sbuf + g) : 0.f;
          ks[tid] = valid ? __ldcg(kbuf + g) : 0.f;
        }
        __syncthreads();
#pragma unroll 1
        for (int i = 1; i < 7; ++i) {
          if (tid < kTile) {
            float acc = ks[tid] * (kA[i][0] * h_c);
            for (int j = 1; j < i; ++j)
              acc += ks[j * kTile + tid] * (kA[i][j] * h_c);
            xin[tid] = ys[tid] + acc;
          }
          __syncthreads();
          aug_field<kTrace>(
              w_s, proj_s, ap_s, t + kC[i] * h_c, xin, act, rv,
              ks + i * kTile, q5s, qes, kB5[i], err_weight(i),
              i == 6 ? 1.f : 0.f, acc5, accE, acc7,
              i == 6 ? qbuf + (ns * R + row0) * kLdP : nullptr, rows);
        }
        float sq = 0.f;
        if (tid < rows * kLd) {
          const int c = tid % kLd;
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
          if (c < 6 || (kTrace && c == kLogp)) {
            const float r = (h_c * se) /
                            (a.atol + a.rtol * fmaxf(fabsf(y), fabsf(y5)));
            sq = r * r;
          }
          const size_t g = (ns * R + row0) * kLd + tid;
          sbuf[g] = y5;
          kbuf[g] = ks[6 * kTile + tid];
        }
        const float tile_sum = block_sum(sq, red);
        if (tid == 0) prow += static_cast<double>(tile_sum);
      }
      __syncthreads();
      // the projection matrix's cotangent: -h c^T Q, this super-tile's
      // part, 4 x 4 outputs a thread
      const int njb = kLdP / 4;
      for (int blk = tid; blk < (cdim / 4) * njb; blk += kThreads) {
        const int i0 = blk / njb * 4, j0 = blk % njb * 4;
        float s5[4][4] = {}, se[4][4] = {};
        for (int r = 0; r < srows; ++r) {
          const float4 cv = __ldg(reinterpret_cast<const float4*>(
              a.c + static_cast<size_t>((srow0 + r) / a.rep) * cdim + i0));
          const float4 v5 =
              *reinterpret_cast<const float4*>(q5 + r * kLdP + j0);
          const float4 ve =
              *reinterpret_cast<const float4*>(qe + r * kLdP + j0);
          const float ci[4] = {cv.x, cv.y, cv.z, cv.w};
          const float q5v[4] = {v5.x, v5.y, v5.z, v5.w};
          const float qev[4] = {ve.x, ve.y, ve.z, ve.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              s5[ii][jj] = fmaf(ci[ii], q5v[jj], s5[ii][jj]);
              se[ii][jj] = fmaf(ci[ii], qev[jj], se[ii][jj]);
            }
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          float4* d5 = reinterpret_cast<float4*>(
              my5 + kGOwn + (i0 + ii) * kLdP + j0);
          float4* de = reinterpret_cast<float4*>(
              myE + kGOwn + (i0 + ii) * kLdP + j0);
          float4 o5 = *d5, oe = *de;
          o5.x -= s5[ii][0]; o5.y -= s5[ii][1];
          o5.z -= s5[ii][2]; o5.w -= s5[ii][3];
          oe.x -= se[ii][0]; oe.y -= se[ii][1];
          oe.z -= se[ii][2]; oe.w -= se[ii][3];
          *d5 = o5;
          *de = oe;
        }
      }
      // the rows' dc: dc1 = dc0 - h Wc Q5, error -h Wc QE; 4 outputs a
      // thread
      float sq = 0.f;
      for (int blk = tid; blk < kSuper * (cdim / 4); blk += kThreads) {
        const int r = blk / (cdim / 4), i0 = blk % (cdim / 4) * 4;
        if (r >= srows) continue;
        float d5[4] = {}, de[4] = {};
        const float* q5r = q5 + r * kLdP;
        const float* qer = qe + r * kLdP;
        for (int j = 0; j < kProj; ++j) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(
              a.wct + static_cast<size_t>(j) * cdim + i0));
          const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            d5[ii] = fmaf(q5r[j], wj[ii], d5[ii]);
            de[ii] = fmaf(qer[j], wj[ii], de[ii]);
          }
        }
        const size_t row = static_cast<size_t>(srow0) + r;
        const float4 o = __ldcg(reinterpret_cast<const float4*>(
            dcbuf + (cs * R + row) * cdim + i0));
        const float dc0[4] = {o.x, o.y, o.z, o.w};
        float dc1[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          dc1[ii] = dc0[ii] - h_c * d5[ii];
          const float rr = (-h_c * de[ii]) /
                           (a.atol + a.rtol * fmaxf(fabsf(dc0[ii]),
                                                   fabsf(dc1[ii])));
          sq = fmaf(rr, rr, sq);
        }
        *reinterpret_cast<float4*>(dcbuf + (ns * R + row) * cdim + i0) =
            make_float4(dc1[0], dc1[1], dc1[2], dc1[3]);
      }
      const float dc_sum = block_sum(sq, red);
      if (tid == 0) prow += static_cast<double>(dc_sum);
    }
    __syncthreads();
    // the block's sums of the layers' gradient (k = -dS/dtheta), and its
    // FSAL sum for the next step
    for (int e = tid; e < kGOwn; e += kThreads) {
      my5[e] = -acc5[e];
      myE[e] = -accE[e];
      kgb[(ns * a.max_grid + b) * kGOwn + e] = acc7[e];
    }
    double* prow_part = a.partials + static_cast<size_t>(n & 1) * 2 * nb;
    double* pg_part = prow_part + nb;
    if (tid == 0) prow_part[b] = prow;
    __threadfence();
    grid.sync();
    // G: every entry reduced over the blocks in block order by one thread
    float gsq = 0.f;
    for (int e = b * kThreads + tid; e < ng; e += nb * kThreads) {
      float s5 = 0.f, se = 0.f;
      for (int bb = 0; bb < nb; ++bb) {
        s5 += __ldcg(part + 2 * static_cast<size_t>(bb) * ng + e);
        se += __ldcg(part + (2 * static_cast<size_t>(bb) + 1) * ng + e);
      }
      const float g0 = __ldcg(gbuf + cs * ng + e);
      const float g1 = g0 + h_c * s5;
      const float rr = (h_c * se) /
                       (a.atol + a.rtol * fmaxf(fabsf(g0), fabsf(g1)));
      gsq = fmaf(rr, rr, gsq);
      gbuf[ns * ng + e] = g1;
    }
    const float g_sum = block_sum(gsq, red);
    if (tid == 0) pg_part[b] = static_cast<double>(g_sum);
    __threadfence();
    grid.sync();
    if (tid < 32) {
      const double total = grid_total(prow_part, nb) + grid_total(pg_part, nb);
      if (tid == 0)
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
    done = fabsf(t - t1) >= span - 1e-9f;
    ++n;
  }

  // outputs: y0, a0, dc, G, and the field at t0 with its trace
  const size_t cs = static_cast<size_t>(cur);
  for (int e = b * kThreads + tid; e < ng; e += nb * kThreads)
    a.out_g[e] = __ldcg(gbuf + cs * ng + e);
  for (int st = b; st < n_super; st += nb) {
    for (int sub = 0; sub < kSubTiles; ++sub) {
      const int row0 = st * kSuper + sub * kRows;
      const int rows = min(kRows, R - row0);
      if (rows <= 0) break;
      __syncthreads();
      load_tile(row0, rows);
      if (tid < kTile) {
        const bool valid = tid < rows * kLd;
        xin[tid] = valid ? __ldcg(sbuf + (cs * R + row0) * kLd + tid) : 0.f;
      }
      __syncthreads();
      forward<kRows, kTrace>(w_s, proj_s, t0, xin, kLd, act, ks, kLd, kLogp);
      for (int e = tid; e < rows * 8; e += kThreads) {
        const int r = e / 8, c = e % 8;
        const size_t row = static_cast<size_t>(row0) + r;
        if (c < 3) {
          a.out_y0[row * 3 + c] = xin[r * kLd + c];
          a.out_a0[row * 3 + c] = xin[r * kLd + kA0 + c];
        } else if (c >= 4) {
          a.out_bnd[row * 8 + c] =
              c < 7 ? ks[r * kLd + c - 4]
                    : (kTrace ? -ks[r * kLd + kLogp] : 0.f);
        }
      }
      for (int e = tid; e < rows * cdim; e += kThreads)
        a.out_dc[static_cast<size_t>(row0) * cdim + e] =
            __ldcg(dcbuf + (cs * R + row0) * cdim + e);
    }
  }
  if (b == 0 && tid == 0) {
    a.stats[0] = n;
    a.stats[1] = accepted;
  }
}

template <bool kTrace>
cudaError_t launch(const AdjArgs& args, int dev, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<kTrace>();
  static std::atomic<int> resident[kMaxDevices];
  cudaError_t err;
  int blocks = resident[dev].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             cnf_adjoint_kernel<kTrace>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
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
             &per_sm, cnf_adjoint_kernel<kTrace>, kThreads, smem)) !=
        cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    blocks = sms * per_sm;
    resident[dev].store(blocks, std::memory_order_relaxed);
  }
  const int supers = (args.n_rows + kSuper - 1) / kSuper;
  int grid = blocks;
  if (grid > supers) grid = supers;
  if (grid > args.max_grid) grid = args.max_grid;
  AdjArgs copy = args;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cnf_adjoint_kernel<kTrace>), dim3(grid),
      dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace puflow

// The backward adjoint solve from t1 to t0 (t01 = {t0, t1} on the device)
// of n_rows rows: y1, a1 [n_rows, 3], logp1, ap [n_rows] (read only with
// the trace), conditions c [n_rows / rep, cdim] with their projections
// proj [n_rows / rep, 262] and the projection matrix transposed, wct
// [262, cdim]. cdim, the width of c and wct, is a multiple of 4, their
// columns past cdim_true zero; rep divides n_rows. Scratch, each with its
// size, which must be at least what the layout needs: rows, n_rows (560 +
// 2 cdim) floats; per_grid, max_grid (2 ng + 10,008) + 2 ng floats with
// ng = 5,004 + 264 cdim; partials, 4 max_grid doubles. Writes y0, a0
// [n_rows, 3], dc [n_rows, cdim] (per row of y), the packed gradient g
// [ng], bnd [n_rows, 8] = f1, div1, f0, div0, and stats = steps
// attempted, accepted.
extern "C" int puflow_cnf_adjoint(
    const void* y1, const void* logp1, const void* a1, const void* ap,
    const void* c, const void* proj, const void* weights, const void* wct,
    const void* t01, int n_rows, int rep, int cdim, int cdim_true,
    int with_trace,
    float rtol, float atol, int max_steps, void* rows, long long rows_floats,
    void* per_grid, long long per_grid_floats, void* partials,
    long long partials_doubles, int max_grid, void* out_y0, void* out_a0,
    void* out_dc, void* out_g, void* out_bnd, void* stats, void* stream) {
  using namespace puflow;
  if (n_rows < 1 || rep < 1 || n_rows % rep != 0 || max_grid < 1 ||
      cdim < 4 || cdim % 4 != 0 || cdim_true < 0 || cdim_true > cdim)
    return cudaErrorInvalidValue;
  const long long ng = kGOwn + static_cast<long long>(cdim) * kLdP;
  if (rows_floats < static_cast<long long>(n_rows) * (4 * kLd + 2 * kLdP +
                                                      2 * cdim) ||
      per_grid_floats < max_grid * (2 * ng + 2 * kGOwn) + 2 * ng ||
      partials_doubles < 4LL * max_grid)
    return cudaErrorInvalidValue;
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  AdjArgs args;
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
  const auto s = static_cast<cudaStream_t>(stream);
  return with_trace ? launch<true>(args, dev, s) : launch<false>(args, dev, s);
}
