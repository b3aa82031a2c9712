// Backward solve of one CNF block's continuous adjoint in one launch (and
// one attempt a launch, data parallel: the per-attempt mode below).
//
// Replaces the TPU kernel `cnf_adjoint_bwd_pallas`
// (puflow_tpu/ops/pallas/cnf_adjoint_pallas.py, `_cnf_adjoint_kernel`).
// It computes what the plain version, `cnf_adjoint_bwd_plain` in
// puflow_torch/ops/cnf.py (`models.ode.adjoint_backward`), computes: the
// dopri5 integration from t1 back to t0 of the augmented system
//   dy/dt = f,  [dlogp/dt = -div f],  da/dt = -dS/dy,  dg/dt = -dS/dtheta,
// S = a . f - a_p . div f with a_p constant, f the ConcatSquashLinear +
// tanh field 3 -> 64 -> 64 -> 3 of `cnf_field.cuh`, theta = (the layers'
// parameters, the per-row conditions c). Without the trace (the inverse
// pass, whose log-density is discarded) there is no logp and no div term.
// The vjp of the field is written out by hand: the primal's backprop, and
// with the trace the reverse of the three tangent chains u1_k = W1[k] s1
// (1 - x1^2), v2_k = u1_k W2 (the TPU kernel's derivation,
// cnf_adjoint_pallas.py:1-37).
//
// The solve matches the plain version step for step: ONE step size for all
// rows, FSAL, and the error norm over every leaf of the plain state: y,
// logp, a, a_p (zero error, but counted), dc per row of y, and the summed
// parameter gradient G. So each attempt needs G's two quadrature sums (the
// B5- and the error-weighted) over all rows before the step can be judged.
//
// What bounds it. Per row and field evaluation the work is the 64 x 64
// layer's products: x1 W2 and the reverse dh2 W2^T, with the trace also
// u1_k W2 and cv2_k W2^T (k = 0..2), and W2's gradient x1^T dh2 (+ sum_k
// u1_k^T cv2_k); once an attempt the condition cotangents Wc Q (per row of
// y) and c^T Q. All of it is small per block (62 rows a block at the f
// shape, 248 at the g shape), so a step is a chain of short dependent
// phases, each a barrier apart: on an H100 (scripts/adjoint_variants.py's
// diag_clock) a tile's six stages take about 130k cycles with the trace
// (16 rows) and 153k without (32 rows), of which the tensor-core phases
// (layer 2, and its reverse with W2's gradient) are 36% and 26%, the
// per-row f32 phases (layers 1 and 3, the epilogues, the column sums) 38%
// and 42%, dc 13% and 20%; each attempt adds c^T Q and G's reduction over
// the blocks (about 35 us each). The per-row phases cost in proportion to
// their rows: they are bound by issue, not by waiting. The kernel runs at
// 9x (f) and 11x (g) its 3xTF32 bound (`chip_smoke.py:
// compare_cnf_adjoint`), 4x and 5x its FP32 bound.
//
// Design.
//  * One cooperative launch of one 256-thread block an SM, no host read.
//    Block b owns a contiguous run of tiles of 16 rows with the trace, 32
//    without (`Dims`: what shared memory holds); it takes each tile
//    through the six stages of a step out of shared memory. Rows past the
//    last add nothing anywhere: their a and a_p are zero, so every
//    cotangent they produce is zero.
//  * Every product of 64-wide operands is a 3xTF32 `mma.sync` m16n8k8
//    (`mma_tf32.cuh`, split by integer rounding, hi*hi + hi*lo + lo*hi):
//    the block's 8 warps share out the n8 column tiles of each product
//    over the tile's m16 row tiles (with the trace, a warp one product and
//    4 column tiles). W2's and W2^T's B fragments come from a pack the
//    wrapper makes once per parameters (`ops/cnf.py:_adjoint_pack`, f32
//    pairs split here), A fragments from the tile's activations in shared
//    memory (row stride 72: conflict-free both as A and, for W2's
//    gradient, as A^T and B). The 3 -> 64 and 64 -> 3 layers, the per-
//    column vectors, the sigmoid / tanh epilogues and the dopri5
//    combinations stay f32 FMAs.
//  * W2's gradient is a product whose K runs over the tile's rows; each
//    warp keeps its 16 x 32 slice of the three stage-weighted sums (B5,
//    error, and the last stage's own, the next step's first by FSAL) in C
//    fragments for the whole attempt. The other 908 gradient entries are
//    column sums: each thread sums its column over its rows of the tile
//    in registers, and the 4 row groups are added in a fixed order.
//  * The condition enters only through the projections gate_c | bias_c
//    (262 floats a row), and c is constant along the solve, so the
//    cotangents of the conditions and of the projection matrix factor
//    through the per-row cotangents q of those projections: a row's dc
//    moves by -h Wc Q and the matrix's gradient by -h c^T Q, Q the stage
//    sum of q (B5- and error-weighted, held for the tile in shared
//    memory). Both run on the tensor cores. dc at the tile's end: A from
//    the tile's Q, Wc's B fragments (a pack of the wrapper) from device
//    memory, the warps sharing its n tiles. c^T Q once an attempt, after
//    the block's tiles: each tile's Q summed over each condition row's
//    repeats at the tile's end into the block's slot for that row (cr +
//    b, so two blocks sharing a condition row never write one slot),
//    then staged with c in shared memory, 64 condition rows at a time.
//    The block's part of G goes to its slice of a [grid][2][NG] scratch.
//  * After the blocks' passes one grid.sync; then every thread of the grid
//    reduces a fixed set of G's entries over the blocks in block order,
//    forms g1 = g0 + h S5 and the entry's error term, and writes g1 to the
//    other of two copies of G; a second grid.sync; every block sums the
//    norm's partials in the same fixed order and takes the same decision.
//    No atomics: two runs agree bit for bit.
//  * Row state (y, a, logp; the FSAL stage; q of the FSAL stage; dc) lives
//    in device memory in two copies, flipped on accept together with G and
//    each block's FSAL gradient sum.
//  * The conditions may serve `rep` consecutive rows each (the inverse
//    pass): they are indexed in place, and dc is kept per row of y, so the
//    norm counts dc over the repeated rows as the plain version, which
//    repeats c, does; the wrapper sums the repeats.
//
// Per-attempt mode (data parallel: each rank holds a shard of the rows,
// and every step is judged on the global batch's error norm, as a sharded
// jit judges it; `puflow_cnf_adjoint_attempt` in cnf_adjoint_attempt.cu).
// G is replicated, and its tolerance is taken per entry of the global G,
// so the ranks must exchange every entry's S5 and SE each attempt (2 ng
// floats, 310 KB at cdim 128), not a scalar. One cooperative launch an
// attempt on the same grid and tiles: launch k first decides attempt k - 1
// (the ranks' S5 and SE added in rank order into the global G's step and
// its error terms, the ranks' row terms in rank order, the same control),
// then takes attempt k and leaves this rank's block-reduced S5, SE, row
// terms and count in `local`; between launches the wrapper exchanges them
// exactly (a zero-filled all-reduce of their bits) and reads the finished
// flag. Each rank keeps the global G, which enters only the norm, and its
// own G (its rows' part), which it outputs: the gradient all-reduce adds
// the parts. At world size 1 they are one tensor, and every sum is the
// one-launch kernel's, so the two modes agree bit for bit.

#include "cnf_adjoint.cuh"

cudaError_t puflow::adjoint_resident_blocks(bool trace, int dev,
                                            int* blocks) {
  return trace ? resident_blocks<true>(dev, blocks)
               : resident_blocks<false>(dev, blocks);
}

// The backward adjoint solve from t1 to t0 (t01 = {t0, t1} on the device)
// of n_rows rows: y1, a1 [n_rows, 3], logp1, ap [n_rows] (read only with
// the trace), conditions c [n_rows / rep, cdim] with their projections
// proj [n_rows / rep, 262]; weights, the pack of `ops/cnf.py:_adjoint_pack`
// (13,068 floats); wct, the projection matrix transposed and padded to
// [264, cdim] as B fragments (`fragment_order`, f32 pairs). cdim, the width
// of c and wct, is a multiple of 16 and at most 4,096, their columns past
// cdim_true zero; rep divides n_rows. Scratch, each with its size, which
// must be at least what the layout needs: rows, n_rows (560 + 2 cdim) +
// 528 (n_rows / rep + max_grid) floats; per_grid, max_grid (2 ng +
// 10,008) + 2 ng floats with ng = 5,004 + 264 cdim; partials, 4 max_grid
// doubles. Writes y0, a0 [n_rows, 3], dc [n_rows, cdim] (per row of y),
// the packed gradient g [ng], bnd [n_rows, 8] = f1, div1, f0, div0, and
// stats = steps attempted, accepted.
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
  AdjArgs args;
  int dev = 0;
  cudaError_t err = fill_args(
      args, y1, logp1, a1, ap, c, proj, weights, wct, t01, n_rows, rep, cdim,
      cdim_true, rtol, atol, max_steps, rows, rows_floats, per_grid,
      per_grid_floats, partials, partials_doubles, max_grid, out_y0, out_a0,
      out_dc, out_g, out_bnd, stats);
  if (err != cudaSuccess || (err = current_device(&dev)) != cudaSuccess)
    return err;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_trace ? launch<true, false>(args, dev, s)
                    : launch<false, false>(args, dev, s);
}
