// f32 products on Hopper's tensor cores as 3xTF32 (sm_80+ `mma.sync`).
//
// An f32 operand x splits into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest with ties away from zero (`cvt.rna`). A product is
// taken as hi*hi + hi*lo + lo*hi with f32 accumulation: the dropped lo*lo
// term and the rounding of lo leave about 2^-21 of each product, the
// counterpart of the TPU kernels' 3-pass bf16 split
// (puflow_tpu/ops/pallas/encoder_pallas.py:_f32_dot).
//
// Fragments of `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`, lane
// l = 4 g + t of a warp:
//   A (16 x 8):  a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
//                a3 = (g + 8, t + 4)
//   B (8 x 8):   b0 = (t, g), b1 = (t + 4, g)
//   C/D (16 x 8): c0 = (g, 2t), c1 = (g, 2t + 1), c2 = (g + 8, 2t),
//                 c3 = (g + 8, 2t + 1)
// So the C fragment of an n8 tile serves as the A fragment of a k8 chunk,
// {c0, c2, c1, c3}, if the chunk's k index runs over its columns in the
// order 0 2 4 6 1 3 5 7: B's rows are then taken in that order too, and
// lane l holds rows 2t and 2t + 1 of column g (`b_fragments` in
// puflow_torch/ops/encoder.py packs them so, hi and lo split).
#pragma once

#include <cstdint>

namespace puflow {
namespace tf32 {

__device__ __forceinline__ uint32_t round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round(x);
  lo = round(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile; b0, b1 already rounded to tf32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// acc[nt] += A W over KT k8 chunks: A's chunk kc is the C fragment
// a_tiles[kc] (16 rows x 8 columns, split here), W's fragment for (kc, nt)
// the float4 {hi(b0), hi(b1), lo(b0), lo(b1)} at w[(kc * w_tiles + nt) *
// 32] (w already offset by the lane). Three products a chunk and tile:
// hi*hi, hi*lo, lo*hi.
template <int KT, int NT, int AT>
__device__ __forceinline__ void mma_3x(float (&acc)[NT][4],
                                       const float (&a_tiles)[AT][4],
                                       const float4* w, int w_tiles) {
  static_assert(KT <= AT, "more k chunks than A tiles");
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    uint32_t hi[4], lo[4];
    split(a_tiles[kc][0], hi[0], lo[0]);
    split(a_tiles[kc][2], hi[1], lo[1]);
    split(a_tiles[kc][1], hi[2], lo[2]);
    split(a_tiles[kc][3], hi[3], lo[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 b = w[(kc * w_tiles + nt) * 32];
      mma(acc[nt], hi, b.x, b.y);
      mma(acc[nt], hi, b.z, b.w);
      mma(acc[nt], lo, b.x, b.y);
    }
  }
}

// The same rounding as two integer operations, add half the dropped ulp
// and clear the 13 low bits (`ops/encoder.py:tf32_round`), which gave the
// same bits as `cvt.rna.tf32.f32` for finite x and cut a call of the
// inverse flow by 25% (scripts/flow_g_variants.py, PERF.md). The helpers
// below use it; `mma_3x` (the encoder's) keeps `split`.
__device__ __forceinline__ uint32_t round_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_bits(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_bits(x);
  lo = round_bits(x - __uint_as_float(hi));
}

// The tf32 hi and lo of a lane's B pair (rows 2t, 2t + 1 of column g):
// pre-split on the host (float4 {hi0, hi1, lo0, lo1}) or split here from
// the f32 pair (float2 {b0, b1}), which halves the bytes in shared memory
// for the instructions of two splits.
struct BPair {
  float h0, h1, l0, l1;
};

__device__ __forceinline__ BPair b_pair(const float4& b) {
  return {b.x, b.y, b.z, b.w};
}

__device__ __forceinline__ BPair b_pair(const float2& b) {
  uint32_t h0, l0, h1, l1;
  split_bits(b.x, h0, l0);
  split_bits(b.y, h1, l1);
  return {__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
          __uint_as_float(l1)};
}

// A k8 chunk's C fragment (16 rows x 8 columns) -> the hi and lo of the A
// fragment it serves as.
struct ASplit {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ ASplit a_split(const float (&a)[4]) {
  ASplit s;
  split_bits(a[0], s.hi[0], s.lo[0]);
  split_bits(a[2], s.hi[1], s.lo[1]);
  split_bits(a[1], s.hi[2], s.lo[2]);
  split_bits(a[3], s.hi[3], s.lo[3]);
  return s;
}

// acc[nt] += a W for one k8 chunk, its A fragment split in a, W's
// fragment nt at w[nt * 32] (w already offset by the lane and the chunk)
// as a float4 (pre-split) or float2 (f32) pair. kBatch n8 tiles at a time
// take their three products in turn (hi*hi of each, then hi*lo, then
// lo*hi), so that a tile's dependent products stand kBatch apart; every
// tile sees its products in the same order whatever kBatch is, so the
// result is too.
template <int NT, class Frag, int kBatch = 1>
__device__ __forceinline__ void mma_3x_tiles(float (&acc)[NT][4],
                                             const ASplit& a, const Frag* w) {
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += kBatch) {
    BPair b[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) b[j] = b_pair(w[(n0 + j) * 32]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) mma(acc[n0 + j], a.hi, b[j].h0, b[j].h1);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) mma(acc[n0 + j], a.hi, b[j].l0, b[j].l1);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) mma(acc[n0 + j], a.lo, b[j].h0, b[j].h1);
  }
}

// mma_3x with B in either pair format: acc[nt] += A W over KT k8 chunks
// of A in registers (chunk kc the C fragment a[kc]), W's fragment for
// (kc, nt) at w[(kc * w_tiles + nt) * 32].
template <int KT, int NT, int AT, class Frag, int kBatch = 1>
__device__ __forceinline__ void mma_3x_any(float (&acc)[NT][4],
                                           const float (&a)[AT][4],
                                           const Frag* w, int w_tiles) {
  static_assert(KT <= AT, "more k chunks than A tiles");
#pragma unroll
  for (int kc = 0; kc < KT; ++kc)
    mma_3x_tiles<NT, Frag, kBatch>(acc, a_split(a[kc]),
                                   w + kc * w_tiles * 32);
}

}  // namespace tf32
}  // namespace puflow
