// Dense layers over a tile of rows held in shared memory, shared by the
// condition encoder (encoder.cu) and the interpolation head (interp.cu).
//
// A block of NT threads owns a tile of kRows rows. A layer
//   out[r][o] = act(sum_k in[r][k] W[k][o] + bias[o] + add[r][o])
// reads its input rows from shared memory (row stride ldi, odd, so the
// rows a warp reads sit in different banks) and streams W, an [in, out]
// matrix in global memory, through a shared-memory chunk of kWbuf floats,
// kWbuf / n_out input rows at a time: a layer's weights never have to fit
// in shared memory at once. Each thread loads its part of the next chunk
// into registers before it computes on the current one, so the L2 latency
// of the weights hides behind the FMAs. Thread (ty, tx) owns rows
// ty + TY i and VEC-wide column groups VEC tx + VEC TX j; per input row it
// loads RPT activations and CPT / VEC vectors of weights from shared
// memory for RPT * CPT FMAs (at n_out = 128: 32 FMAs for 4 + 2 loads with
// NT = 512, 64 for 8 + 2 with NT = 256). The tiles take most of shared
// memory, so a block has its SM to itself; NT trades warps to hide
// latency against registers for accumulators, and each kernel picks it.
// Exact f32: fmaf accumulation in input order.
#pragma once

#include <cuda_runtime.h>

namespace puflow {
namespace dense {

constexpr int kRows = 128;      // rows of a tile
constexpr int kWbuf = 4096;     // floats of the staged weight chunk
constexpr int kMaxSmem = 232448;

enum Act { kNone = 0, kLrelu05 = 1, kLrelu01 = 2, kRelu = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kLrelu05) return v > 0.f ? v : 0.05f * v;
  if (ACT == kLrelu01) return v > 0.f ? v : 0.01f * v;
  if (ACT == kRelu) return v > 0.f ? v : 0.f;
  return v;
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* w) {
  if (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if (VEC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

// One layer over the tile; n_out = TX * CPT. `bias` (global) and `add`
// (row stride lda) may be null / unused; `out` has row stride ldo and only
// rows < `rows` are stored. in, add and out may lie in shared or global
// memory; out may alias add (each element is read and written by the same
// thread) but not in. wbuf must be 16-byte aligned. Contains
// __syncthreads: call it from every thread.
template <int NT, int TX, int CPT, int ACT, bool ADD>
__device__ void layer(const float* in, int ldi, int k_in,
                      const float* __restrict__ W, int ldw,
                      const float* __restrict__ bias, const float* add,
                      int lda, float* out, int ldo, int rows, float* wbuf) {
  constexpr int TY = NT / TX;
  constexpr int RPT = kRows / TY;
  constexpr int NOUT = TX * CPT;
  constexpr int KC = kWbuf / NOUT;        // weight rows per chunk
  constexpr int PER = kWbuf / NT;        // chunk floats per thread
  constexpr int VEC = CPT >= 4 ? 4 : CPT;
  constexpr int NV = CPT / VEC;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // element e = threadIdx.x + u NT of the chunk at k0 is
  // W[k0 + e / NOUT][e % NOUT]
  float next[PER];
  auto fetch = [&](int k0) {
    const int n = min(KC, k_in - k0) * NOUT;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = threadIdx.x + u * NT;
      next[u] = e < n ? __ldg(W + static_cast<size_t>(k0 + e / NOUT) * ldw +
                              e % NOUT)
                      : 0.f;
    }
  };
  if (k_in > 0) fetch(0);
  for (int k0 = 0; k0 < k_in; k0 += KC) {
    const int kc = min(KC, k_in - k0);
    __syncthreads();  // wbuf is free and `in` is written
#pragma unroll
    for (int u = 0; u < PER; ++u) wbuf[threadIdx.x + u * NT] = next[u];
    __syncthreads();
    if (k0 + KC < k_in) fetch(k0 + KC);
    const float* a_row = in + ty * ldi + k0;
    const float* w_col = wbuf + VEC * tx;
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      float a[RPT], w[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = a_row[TY * i * ldi + kk];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        load_vec<VEC>(w_col + kk * NOUT + VEC * TX * j, w + VEC * j);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int o = VEC * tx + VEC * TX * (j / VEC) + j % VEC;
      float v = acc[i][j];
      if (bias != nullptr) v += __ldg(bias + o);
      if (ADD) v += add[static_cast<size_t>(r) * lda + o];
      out[static_cast<size_t>(r) * ldo + o] = activate<ACT>(v);
    }
  }
}

// `layer` with the thread layout for each width: the widest register tile
// whose shared-memory loads stay conflict-free.
template <int NT, int NOUT, int ACT, bool ADD>
__device__ __forceinline__ void layer_w(const float* in, int ldi, int k_in,
                                        const float* __restrict__ W, int ldw,
                                        const float* __restrict__ bias,
                                        const float* add, int lda, float* out,
                                        int ldo, int rows, float* wbuf) {
  constexpr int TX = NOUT <= 16 ? 4 : NOUT == 32 ? 8 : 16;
  layer<NT, TX, NOUT / TX, ACT, ADD>(in, ldi, k_in, W, ldw, bias, add, lda,
                                     out, ldo, rows, wbuf);
}

// `layer_w` for a width known at run time: n_out in {8, 16, 32, 64, 128}
// (supported_width); the host checks widths before launching.
template <int NT, int ACT, bool ADD>
__device__ void layer_n(int n_out, const float* in, int ldi, int k_in,
                        const float* __restrict__ W, int ldw,
                        const float* __restrict__ bias, const float* add,
                        int lda, float* out, int ldo, int rows, float* wbuf) {
  switch (n_out) {
    case 8:
      layer_w<NT, 8, ACT, ADD>(in, ldi, k_in, W, ldw, bias, add, lda, out,
                               ldo, rows, wbuf);
      break;
    case 16:
      layer_w<NT, 16, ACT, ADD>(in, ldi, k_in, W, ldw, bias, add, lda, out,
                                ldo, rows, wbuf);
      break;
    case 32:
      layer_w<NT, 32, ACT, ADD>(in, ldi, k_in, W, ldw, bias, add, lda, out,
                                ldo, rows, wbuf);
      break;
    case 64:
      layer_w<NT, 64, ACT, ADD>(in, ldi, k_in, W, ldw, bias, add, lda, out,
                                ldo, rows, wbuf);
      break;
    default:
      layer_w<NT, 128, ACT, ADD>(in, ldi, k_in, W, ldw, bias, add, lda, out,
                                 ldo, rows, wbuf);
  }
}

inline bool supported_width(int n) {
  return n == 8 || n == 16 || n == 32 || n == 64 || n == 128;
}

}  // namespace dense
}  // namespace puflow
