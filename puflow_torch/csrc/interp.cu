// Interpolation head: the weight head of the discrete model's latent
// interpolation on BN-folded weights, with three epilogues.
//
// Replaces the TPU kernels `interp_weights_cm_pallas(_t)`,
// `interp_logits_pallas` and `interp_latents_pallas`
// (puflow_tpu/ops/pallas/encoder_pallas.py, `_interp_cm_kernel`,
// `_interp_kernel`, `_interp_latents_kernel`). For every (point p, slot s)
// row, with q = idx[p, s] the slot's neighbour:
//   f10 = [x_p, x_q, x_p - x_q, |x_p - x_q|]
//   distance MLP 10 -> 64 -> 64 -> 128 (LeakyReLU 0.01)         -> d
//   context EdgeConv on [x_p, x_q, x_q - x_p]: 8 growth-16 layers
//   (LeakyReLU 0.05) and conv_out 137 -> 128, no pooling        -> e
//   weight MLP [d, e] 256 -> 128 -> 64 -> 32 (LeakyReLU 0.01)   -> logits
// then, per point, a max-subtracted softmax over its k slots of the first
// r logits. mode 0 writes the logits [points, k, 32]; mode 1 the weights
// [points, k, r] (what flow_g_blend reads); mode 2 the latents
// [points, 3, r] = sum_s z[q_s] w_s. Plain version: `interp_head_plain` in
// puflow_torch/ops/interp.py.
//
// What bounds it on the H100: its products, about 82 k multiply-adds a
// row (8 rows a point), 52% of them in the weight MLP. The kernel computes
// the exact f32 function (the TPU kernel's 3-pass bf16 split, not its
// single-pass INTERP_FAST) as 3xTF32 products on the tensor cores
// (mma_tf32.cuh): three TF32 products for each f32 one, so the least time
// is 3 x 2 x the multiply-adds at the dense TF32 rate
// (chip_smoke.py:interp_macs). f10, the biases, the activations, the
// softmax and the latent blend stay f32 arithmetic.
//
// Design: every product is a warp's m16n8k8 `mma.sync` on a tile of 16
// rows (at k = 8: 2 points x 8 slots), and every layer's output stays in
// its C fragments as the next product's A operand (the host orders each
// k8 chunk's weight rows 0 2 4 6 1 3 5 7, mma_tf32.cuh). f10 is built in
// registers in that layout, zero-padded to 16 columns; the EdgeConv's
// edge term takes it too, through the rows [W_self; W_nbr; 0] (its input
// [x_p, x_q, x_q - x_p] is linear in x_p and x_q). The 256-wide context
// [d, e] is never formed: the weight MLP's first layer is taken in K
// groups of 32 columns into one 16 x 128 accumulator, each group of e (or
// d) used as soon as it is made. In a round the live registers a lane are
// at most f10 and the eight growth outputs (72), the accumulator (64) and
// a group (16): 255 registers with 8 warps an SM.
// A warp's products are chains of dependent `mma.sync`s (a fragment's
// three products add into one accumulator), and one tile a warp leaves
// little else to hide their latency. So a k8 chunk takes the products of
// kBatch = 4 n8 tiles in turn (hi*hi of each, then hi*lo, then lo*hi), and
// a growth layer, two n8 tiles wide, deals its k chunks to kGrowthSets = 4
// accumulators summed at the end.
// The softmax stays in the C fragments: at k = 8 a lane's rows g and g + 8
// are slot g of the tile's two points, so the max and the sum over the
// slots are three xor-shuffles (4, 8, 16) a value, as is the blend's sum
// over the slots. Other k stage the logits of a round in shared memory.
//
// Shared memory (the budget, of kMaxSmem's 227 KB): the head's weights
// as B fragments pre-split into tf32 hi / lo are 656 KB, so they cannot
// all be resident. A persistent grid of one block an SM walks rounds of
// kWarps tiles (a tile a warp); a round runs kPhases phases, each with its
// own slice of the weights (at most 96 KB), in a ring of two buffers: the
// next phase's slice is copied in with `cp.async` while the block computes
// on the current one, and one barrier a phase hands the buffers over. The
// biases (3 KB) stay resident; the staged logits of k != 8 take 17 KB.
// Reruns are bit-equal: one fixed order, no atomics.
// Measured on an H100 at 256 patches (scripts/interp_variants.py,
// PERF.md): 2.2 ms a call in each mode, 4.2x its 3xTF32 bound, where the
// CUDA-core kernel before it took 3.2 ms. Against the kept design, each
// tile's three products in a row and one accumulator a growth layer took
// 10% longer, every fragment split as read 26%, no copy overlapping the
// products 7%, the distance half first up to 20%; 12 warps an SM
// (spilling) and 8 tiles' products interleaved were within 2%. The
// products of hi*hi alone take 1.25 ms: the tensor cores' `mma.sync` rate
// and each warp's chains set the pace, not the staging.

#include <algorithm>
#include <cstdint>

#include "mma_tf32.cuh"

namespace puflow {
namespace {

constexpr int kWarps = 8;                  // warps a block, a tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;                  // rows of an m16 tile
constexpr int kRoundRows = kTile * kWarps; // rows of a block's round
constexpr int kMaxK = 128;
constexpr int kLogits = 32;                // R_MAX
constexpr int kLgLd = kLogits + 1;         // staged logits' row stride
constexpr size_t kMaxSmem = 232448;
static_assert(kRoundRows >= kMaxK, "a round holds a point of kMaxK slots");

// B fragments pre-split on the host into {hi0, hi1, lo0, lo1} (float4) or
// f32 pairs split as read (float2); `ops/interp.py:_PRESPLIT` agrees.
using Frag = float4;
constexpr int kFragFloats = sizeof(Frag) / sizeof(float);

constexpr int kA = 18;       // k8 chunks of [f10 (2), h_0 .. h_7 (16)]
constexpr int kGrowth = 8;   // growth layers, 16 columns each
constexpr int kAcc = 16;     // n8 tiles of the weight MLP's first layer
constexpr int kGroup = 4;    // n8 tiles of a group of d or e (32 columns)
constexpr int kSub = 4;      // ... made at once, before their product
constexpr int kBatch = 4;       // n8 tiles whose products a chunk interleaves
constexpr int kGrowthSets = 4;  // accumulators of a growth layer's chains
constexpr int kESets = 1;       // ... of a group of e's

// Bias offsets (floats) in the pack's first kBiasFloats.
constexpr int kBDe0 = 0, kBDe1 = 64, kBDe2 = 128, kBFe = 256, kBFo = 384,
              kBW0 = 512, kBW1 = 640, kBW2 = 704, kBiasFloats = 736;

// The phases of a round, in the pack's order, and their B fragments (32
// lanes each, k chunk major within a matrix):
//   G:      growth layer j = 0..7, [16 + 16 j, 16] (at fragment 2 j (j + 1))
//   E0..E3: group i of e: conv_out's columns [32 i, 32 i + 32) ([144, 32]),
//           then W0's rows [128 + 32 i, +32) ([32, 128])
//   D0:     lin0 [16, 64], lin1 [64, 64], then group 0 of d
//   D1, D2: groups 1, 2 and group 3 of d: lin2's columns [32 i, 32 i + 32)
//           ([64, 32]), then W0's rows [32 i, +32) ([32, 128])
//   T:      W1 [128, 64], W2 [64, 32]
enum Phase { kG, kE0, kE1, kE2, kE3, kD0, kD1, kD2, kT, kPhases };
constexpr int kEFrags = 18 * kGroup + kGroup * kAcc;   // 136
constexpr int kDFrags = 8 * kGroup + kGroup * kAcc;    // 96
constexpr int kDHeadFrags = 2 * 8 + 8 * 8;             // 80
constexpr int kTFrags = 16 * 8 + 8 * 4;                // 160

__host__ __device__ constexpr int phase_frags(int ph) {
  return ph == kG    ? 2 * kGrowth * (kGrowth + 1)
         : ph <= kE3 ? kEFrags
         : ph == kD0 ? kDHeadFrags + kDFrags
         : ph == kD1 ? 2 * kDFrags
         : ph == kD2 ? kDFrags
                     : kTFrags;
}

constexpr int kBufFrags = 2 * kDFrags;                 // the largest phase
constexpr int kBufFloats = 32 * kFragFloats * kBufFrags;
constexpr size_t kSmem =
    sizeof(float) * (kBiasFloats + 2 * kBufFloats + kRoundRows * kLgLd);
static_assert(kSmem <= kMaxSmem, "shared memory");

// Host-given float offsets of each phase's slice in the pack, then its end.
struct Phases {
  int off[kPhases + 1];
};

enum Act { kNone, kLrelu01, kLrelu05 };

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// acc = act(acc + bias) over NT n8 tiles; bias offset by the lane's
// columns 2t.
template <int ACT, int NT>
__device__ __forceinline__ void bias_act(float (&acc)[NT][4],
                                         const float* bias) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * nt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = acc[nt][i] + (i % 2 ? b.y : b.x);
      acc[nt][i] = ACT == kLrelu01   ? (v > 0.f ? v : 0.01f * v)
                   : ACT == kLrelu05 ? (v > 0.f ? v : 0.05f * v)
                                     : v;
    }
  }
}

// acc[nt] += a W for one k8 chunk, its A fragment split in a, W's
// fragment nt at w[nt * 32]: kBatch n8 tiles at a time take their three
// products in turn (hi*hi of each, then hi*lo, then lo*hi), so that a
// tile's dependent products stand kBatch apart.
template <int NT>
__device__ __forceinline__ void chunk3(float (&acc)[NT][4],
                                       const tf32::ASplit& a, const Frag* w) {
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += kBatch) {
    tf32::BPair b[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) b[j] = tf32::b_pair(w[(n0 + j) * 32]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) tf32::mma(acc[n0 + j], a.hi, b[j].h0, b[j].h1);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) tf32::mma(acc[n0 + j], a.hi, b[j].l0, b[j].l1);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (n0 + j < NT) tf32::mma(acc[n0 + j], a.lo, b[j].h0, b[j].h1);
  }
}

// acc[nt] += A W over KT k8 chunks of A in registers (chunk kc the C
// fragment a[kc]), W's fragment (kc, nt) at w[(kc * w_tiles + nt) * 32].
template <int KT, int NT, int AT>
__device__ __forceinline__ void mma3(float (&acc)[NT][4],
                                     const float (&a)[AT][4], const Frag* w,
                                     int w_tiles) {
  static_assert(KT <= AT, "more k chunks than A tiles");
#pragma unroll
  for (int kc = 0; kc < KT; ++kc)
    chunk3(acc, tf32::a_split(a[kc]), w + kc * w_tiles * 32);
}

// mma3 with the k chunks dealt in turn to S accumulator sets, summed in
// order at the end: S independent chains a tile where KT is long and NT
// small.
template <int S, int KT, int NT, int AT>
__device__ __forceinline__ void mma3_sets(float (&acc)[NT][4],
                                          const float (&a)[AT][4],
                                          const Frag* w, int w_tiles) {
  if constexpr (S == 1) {
    mma3<KT>(acc, a, w, w_tiles);
  } else {
    static_assert(KT <= AT, "more k chunks than A tiles");
    float part[S - 1][NT][4];
#pragma unroll
    for (int i = 0; i < S - 1; ++i) zero(part[i]);
#pragma unroll
    for (int kc = 0; kc < KT; ++kc)
      chunk3(kc % S == 0 ? acc : part[kc % S - 1], tf32::a_split(a[kc]),
             w + kc * w_tiles * 32);
#pragma unroll
    for (int i = 0; i < S - 1; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] += part[i][nt][j];
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// The ring of two phase buffers. Phase number `seq` of the block's run
// computes on buffer seq % 2 while the next phase's slice is copied into
// the other.
struct Ring {
  float* buf;               // 2 x kBufFloats, shared
  const float* w;           // the pack, global
  const int* off;           // Phases::off, shared
  int seq;
};

__device__ __forceinline__ void stage(const Ring& ring, int phase,
                                      float* dst) {
  const float* src = ring.w + ring.off[phase];
  const int n4 = (ring.off[phase + 1] - ring.off[phase]) / 4;
  for (int i = threadIdx.x; i < n4; i += kThreads)
    cp_async16(dst + 4 * i, src + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Start the next phase: wait for its slice, then (the barrier: every warp
// is done with the buffer it frees) copy phase `next` (-1: none) into the
// other buffer. -> the slice's B fragments, offset by the lane.
__device__ __forceinline__ const Frag* begin(Ring& ring, int next, int lane) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* cur = ring.buf + (ring.seq & 1) * kBufFloats;
  if (next >= 0) stage(ring, next, ring.buf + (~ring.seq & 1) * kBufFloats);
  ++ring.seq;
  return reinterpret_cast<const Frag*>(cur) + lane;
}

// Growth layers J..7: h_J = lrelu_0.05([f10, h_0 .. h_{J-1}] W_J + b_J)
// into a's chunks 2 + 2 J, 3 + 2 J.
template <int J>
__device__ __forceinline__ void growth(float (&a)[kA][4], const Frag* w,
                                       const float* bias) {
  float acc[2][4];
  zero(acc);
  mma3_sets<kGrowthSets, 2 + 2 * J>(acc, a, w + 32 * 2 * J * (J + 1),
                                    2);
  bias_act<kLrelu05>(acc, bias + kBFe + 16 * J);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[2 + 2 * J + nt][i] = acc[nt][i];
  if constexpr (J + 1 < kGrowth) growth<J + 1>(a, w, bias);
}

// Group i of e (conv_out's columns [32 i, 32 i + 32)) and its part of the
// weight MLP's first layer: acc += e_i W0[128 + 32 i, +32), kSub n8 tiles
// of e at a time.
__device__ __forceinline__ void e_group(float (&acc)[kAcc][4],
                                        const float (&a)[kA][4],
                                        const Frag* w, const float* bias,
                                        int i) {
#pragma unroll
  for (int sg = 0; sg < kGroup / kSub; ++sg) {
    float e[kSub][4];
    zero(e);
    mma3_sets<kESets, kA>(e, a, w + 32 * kSub * sg, kGroup);
    bias_act<kNone>(e, bias + kBFo + 32 * i + 8 * kSub * sg);
    mma3<kSub>(acc, e, w + 32 * (18 * kGroup + kSub * sg * kAcc),
                           kAcc);
  }
}

// The distance MLP's hidden layers on f10 (a's first two chunks).
__device__ __forceinline__ void d_head(float (&h2)[8][4],
                                       const float (&a)[kA][4],
                                       const Frag* w, const float* bias) {
  float h1[8][4];
  zero(h1);
  mma3<2>(h1, a, w, 8);
  bias_act<kLrelu01>(h1, bias + kBDe0);
  zero(h2);
  mma3<8>(h2, h1, w + 32 * 16, 8);
  bias_act<kLrelu01>(h2, bias + kBDe1);
}

// Group i of d (lin2's columns [32 i, 32 i + 32)) and its part of the
// weight MLP's first layer: acc += d_i W0[32 i, +32), kSub n8 tiles of d
// at a time.
__device__ __forceinline__ void d_group(float (&acc)[kAcc][4],
                                        const float (&h2)[8][4],
                                        const Frag* w, const float* bias,
                                        int i) {
#pragma unroll
  for (int sg = 0; sg < kGroup / kSub; ++sg) {
    float d[kSub][4];
    zero(d);
    mma3<8>(d, h2, w + 32 * kSub * sg, kGroup);
    bias_act<kNone>(d, bias + kBDe2 + 32 * i + 8 * kSub * sg);
    mma3<kSub>(acc, d, w + 32 * (8 * kGroup + kSub * sg * kAcc),
                           kAcc);
  }
}

// The weight MLP's tail: logits = lrelu(lrelu(acc + b0) W1 + b1) W2 + b2.
__device__ __forceinline__ void tail(float (&lg)[4][4], float (&acc)[kAcc][4],
                                     const Frag* w, const float* bias) {
  bias_act<kLrelu01>(acc, bias + kBW0);
  float y[8][4];
  zero(y);
  mma3<kAcc>(y, acc, w, 8);
  bias_act<kLrelu01>(y, bias + kBW1);
  zero(lg);
  mma3<8>(lg, y, w + 32 * 16 * 8, 4);
  bias_act<kNone>(lg, bias + kBW2);
}

struct Args {
  const float* xyz;        // [n_points, 3], patches of n points
  const int64_t* idx;      // point p's neighbours at idx[p * idx_stride + s]
  int idx_stride, n, k, n_points, mode, r;
  const float* z;          // [n_points, 3], mode 2
  float* out;
};

// f10 of rows g and g + 8 (h = 0, 1) of a tile as the C fragments of two
// k8 chunks (a lane's columns 2t, 2t + 1 and 8 + 2t, 9 + 2t), and the
// rows' neighbours q (global point indices).
__device__ __forceinline__ void load_f10(float (&a)[kA][4], int64_t (&q)[2],
                                         const Args& args, const int (&p)[2],
                                         const int (&s)[2], int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q[h] = static_cast<int64_t>(p[h] / args.n) * args.n +
           args.idx[static_cast<int64_t>(p[h]) * args.idx_stride + s[h]];
    float f[10];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      f[ch] = __ldg(args.xyz + static_cast<size_t>(p[h]) * 3 + ch);
      f[3 + ch] = __ldg(args.xyz + q[h] * 3 + ch);
      f[6 + ch] = f[ch] - f[3 + ch];
    }
    f[9] = sqrtf(f[6] * f[6] + f[7] * f[7] + f[8] * f[8]);
    a[0][2 * h] = t == 0 ? f[0] : t == 1 ? f[2] : t == 2 ? f[4] : f[6];
    a[0][2 * h + 1] = t == 0 ? f[1] : t == 1 ? f[3] : t == 2 ? f[5] : f[7];
    a[1][2 * h] = t == 0 ? f[8] : 0.f;
    a[1][2 * h + 1] = t == 0 ? f[9] : 0.f;
  }
}

constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float slot_max(float v) {
#pragma unroll
  for (int d = 4; d < 32; d *= 2) v = fmaxf(v, __shfl_xor_sync(kAll, v, d));
  return v;
}

__device__ __forceinline__ float slot_sum(float v) {
#pragma unroll
  for (int d = 4; d < 32; d *= 2) v += __shfl_xor_sync(kAll, v, d);
  return v;
}

// k = 8, modes 1 and 2: the softmax over the slots in the C fragments of
// the logits. Rows g and g + 8 are slot g of points pt[0] and pt[1].
__device__ __forceinline__ void softmax8(const float (&lg)[4][4],
                                         const Args& args, const int (&pt)[2],
                                         const int64_t (&q)[2], int lane) {
  const int g = lane / 4;
  const int t2 = 2 * (lane % 4);
  float zq[2][3];
  if (args.mode == 2)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) zq[h][ch] = __ldg(args.z + q[h] * 3 + ch);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (8 * nt >= args.r) break;
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m = slot_max(lg[nt][i]);
      w[i] = expf(lg[nt][i] - m);
      w[i] /= slot_sum(w[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pt[h] >= args.n_points) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * nt + t2 + j;
        if (args.mode == 1) {
          if (col < args.r)
            args.out[(static_cast<size_t>(pt[h]) * 8 + g) * args.r + col] =
                w[2 * h + j];
          continue;
        }
        float v[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          v[ch] = slot_sum(zq[h][ch] * w[2 * h + j]);
        if (g == 0 && col < args.r)
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            args.out[(static_cast<size_t>(pt[h]) * 3 + ch) * args.r + col] =
                v[ch];
      }
    }
  }
}

// Other k, modes 1 and 2: the softmax of a round's staged logits ([rows of
// points p0 .., kLgLd]) by the whole block.
__device__ __forceinline__ void softmax_staged(const float* lgs,
                                               const Args& args, int p0,
                                               int np) {
  const int k = args.k, r = args.r;
  for (int i = threadIdx.x; i < np * r; i += kThreads) {
    const int pl = i / r;
    const int j = i - pl * r;
    const float* lg = lgs + pl * k * kLgLd + j;
    float mx = lg[0];
    for (int s = 1; s < k; ++s) mx = fmaxf(mx, lg[s * kLgLd]);
    float sum = 0.f;
    for (int s = 0; s < k; ++s) sum += expf(lg[s * kLgLd] - mx);
    const int p = p0 + pl;
    if (args.mode == 1) {
      float* w_out = args.out + static_cast<size_t>(p) * k * r + j;
      for (int s = 0; s < k; ++s) w_out[s * r] = expf(lg[s * kLgLd] - mx) / sum;
    } else {
      const int64_t base = static_cast<int64_t>(p / args.n) * args.n;
      const int64_t* nb = args.idx + static_cast<int64_t>(p) * args.idx_stride;
      float acc[3] = {0.f, 0.f, 0.f};
      for (int s = 0; s < k; ++s) {
        const float w = expf(lg[s * kLgLd] - mx) / sum;
        const float* zq = args.z + (base + nb[s]) * 3;
        for (int ch = 0; ch < 3; ++ch) acc[ch] = fmaf(zq[ch], w, acc[ch]);
      }
      for (int ch = 0; ch < 3; ++ch)
        args.out[(static_cast<size_t>(p) * 3 + ch) * r + j] = acc[ch];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
interp_head_kernel(Args args, const float* __restrict__ weights, int bias_off,
                   Phases phases) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int off[kPhases + 1];
  float* bias = smem;                               // [kBiasFloats]
  float* lgs = smem + kBiasFloats + 2 * kBufFloats; // [kRoundRows][kLgLd]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k = args.k;
  const int ppr = kRoundRows / k;                   // points a round
  const int n_rounds = (args.n_points + ppr - 1) / ppr;
  if (static_cast<int>(blockIdx.x) >= n_rounds) return;
  for (int i = threadIdx.x; i < kBiasFloats; i += kThreads)
    bias[i] = __ldg(weights + bias_off + i);
  if (threadIdx.x <= kPhases) off[threadIdx.x] = phases.off[threadIdx.x];
  __syncthreads();
  const float* bl = bias + 2 * t;
  Ring ring{smem + kBiasFloats, weights, off, 0};
  stage(ring, kG, ring.buf);

  for (int round = blockIdx.x; round < n_rounds; round += gridDim.x) {
    const bool more = round + static_cast<int>(gridDim.x) < n_rounds;
    const int p0 = round * ppr;
    const int np = min(ppr, args.n_points - p0);
    const int rows = np * k;
    // rows g, g + 8 of the warp's tile; rows past the round's compute on
    // its first row and store nothing
    int p[2], s[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = kTile * warp + g + 8 * h;
      ok[h] = row < rows;
      const int pl = ok[h] ? row / k : 0;
      p[h] = p0 + pl;
      s[h] = ok[h] ? row - pl * k : 0;
    }
    float a[kA][4];
    int64_t q[2];
    load_f10(a, q, args, p, s, t);

    // the context EdgeConv, each group of e into acc
    const Frag* w = begin(ring, kE0, lane);
    growth<0>(a, w, bl);
    float acc[kAcc][4];
    zero(acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w = begin(ring, i < 3 ? kE1 + i : kD0, lane);
      e_group(acc, a, w, bl, i);
    }
    // the distance MLP, each group of d into acc
    float h2[8][4];
    w = begin(ring, kD1, lane);
    d_head(h2, a, w, bl);
    d_group(acc, h2, w + 32 * kDHeadFrags, bl, 0);
    w = begin(ring, kD2, lane);
    d_group(acc, h2, w, bl, 1);
    d_group(acc, h2, w + 32 * kDFrags, bl, 2);
    w = begin(ring, kT, lane);
    d_group(acc, h2, w, bl, 3);
    // the weight MLP's tail
    w = begin(ring, more ? kG : -1, lane);
    float lg[4][4];
    tail(lg, acc, w, bl);

    const int t2 = 2 * t;
    if (args.mode == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        float* o = args.out +
                   (static_cast<size_t>(p0) * k + kTile * warp + g + 8 * h) *
                       kLogits + t2;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(o + 8 * nt) =
              make_float2(lg[nt][2 * h], lg[nt][2 * h + 1]);
      }
    } else if (k == 8) {
      const int pt[2] = {p0 + 2 * warp, p0 + 2 * warp + 1};
      softmax8(lg, args, pt, q, lane);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        float* o = lgs + (kTile * warp + g + 8 * h) * kLgLd + t2;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          o[8 * nt] = lg[nt][2 * h];
          o[8 * nt + 1] = lg[nt][2 * h + 1];
        }
      }
      __syncthreads();
      softmax_staged(lgs, args, p0, np);
    }
  }
}

}  // namespace
}  // namespace puflow

// xyz [n_points, 3] (patches of n points), idx [n_points, >= k] int64
// (row stride idx_stride) -> mode 0: logits [n_points, k, 32]; 1: weights
// [n_points, k, r]; 2: latents [n_points, 3, r] from z [n_points, 3].
// weights: `ops/interp.py:_pack`'s (16-byte aligned); offsets: kPhases + 2
// host ints, the float offset of the biases, then of each phase's slice
// and the end.
extern "C" int puflow_interp_head(const void* xyz, const void* idx,
                                  int idx_stride, int n_points, int n, int k,
                                  const void* weights, const void* offsets,
                                  int mode, int r, const void* z, void* out,
                                  void* stream) {
  using namespace puflow;
  if (k < 1 || k > kMaxK || n < 1 || n_points % n != 0 || mode < 0 ||
      mode > 2 || r < 1 || r > kLogits || (mode == 2 && z == nullptr) ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0)
    return cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  Phases phases;
  for (int i = 0; i <= kPhases; ++i) phases.off[i] = off[1 + i];
  for (int i = 0; i < kPhases; ++i)
    if (phases.off[i] % 4 != 0 ||
        phases.off[i + 1] - phases.off[i] !=
            32 * kFragFloats * phase_frags(i))
      return cudaErrorInvalidValue;
  if (n_points == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      interp_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, interp_head_kernel, kThreads, kSmem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int ppr = kRoundRows / k;
  const int rounds = (n_points + ppr - 1) / ppr;
  const int grid = std::min(sms * per_sm, rounds);
  const Args args{static_cast<const float*>(xyz),
                  static_cast<const int64_t*>(idx),
                  idx_stride,
                  n,
                  k,
                  n_points,
                  mode,
                  r,
                  static_cast<const float*>(z),
                  static_cast<float*>(out)};
  interp_head_kernel<<<grid, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<const float*>(weights), off[0], phases);
  return cudaGetLastError();
}
