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
// (`puflow_cnf_solve_logp`):
//   u1_k = W1[k] s1 (1 - x1^2);  v2_k = u1_k W2;
//   v3_k[k] = sum_j v2_k[j] s2[j] (1 - x2[j]^2) W3[j][k];
//   div = sum_k v3_k[k] s3[k]
// (the TPU kernel's `_cnf_solve_logp_kernel`, cnf_pallas.py:176-278). ONE
// step size is shared by all rows: the error ratio of a step is the RMS
// over every entry of the state (3 R, or 4 R with logp), and accept /
// reject is one decision a step. Same tableau, controller and FSAL as the
// plain versions, `cnf_solve_plain` and `cnf_solve_logp_plain` in
// puflow_torch/ops/cnf.py (`models.ode.odeint_dopri5` on `field_plain_csl`
// / `field_with_exact_div`). The TPU's log-density kernel instead lets each
// block of up to 8,192 rows adapt its own step; the port follows the plain
// version, so that the kernel and its oracle take the same steps and agree
// to rounding wherever a step size is set by a clip. The per-row condition
// projections gate_c / bias_c are constant during a solve and come
// precomputed (one matrix product in the wrapper), 262 floats a condition
// row; a condition row may serve `rep` consecutive rows of y, so the
// inverse pass never repeats its conditions.
//
// What bounds it on the H100. A row costs, per field evaluation, the 64 x
// 64 product x1 W2 (4,096 multiply-adds; with the trace also u1_k W2, 3 x
// 4,096) and 384 more multiply-adds and 259 transcendentals (tanh and the
// sigmoid gates) in f32; six evaluations a step, against 24 bytes of state
// and 1,048 bytes of projections. The products run on the tensor cores as
// 3xTF32 `mma.sync` (`cnf_field.cuh:product`); what sets the pace is each
// warp's chain through its tile: block 0's clock (the diag_clock variant
// of scripts/cnf_solve_variants.py) gives layer 1 about 30% of a warp's
// cycles, the product 25%, layer 2's epilogue 15%, the stage sums, the
// gate table and the step's grid barrier the rest; more warps an SM did
// not help, 8-row tiles where the rows are few did.
//
// Design. The solve needs the error norm over every row before any row
// may go on, so it is one cooperative launch (`cudaLaunchCooperativeKernel`)
// of as many blocks as fit the card at once (the occupancy API decides),
// with one `grid.sync()` a step and no host read from start to end; t0 and
// t1 come from device memory. One step loop, `solve_kernel`, is templated
// on the field. Rows are cut into tiles of 16, one m16 row tile of the
// tensor cores, or of 8 (the tile's other 8 rows of A zero) where tiles of
// 8 give every warp the card holds at most one; tile i goes to warp i /
// grid of block i % grid and its repeats every grid x kWarps tiles, so a
// short solve spreads over all the SMs. A warp takes its tile through the
// step's six stages alone, with __syncwarp and no block barrier: lane (g,
// t) computes layer 1 for rows g and g + 8 and columns 8 n + 2t, 8 n + 2t
// + 1 (n = 0..7), the very cells of the A operand its `product` reads back
// (a region of its own in shared memory, so no lane waits for another),
// the product leaves layer 2 in the same cells as C fragments, whose
// epilogue and layer 3's partial sums stay in registers, and a quad's
// butterfly ends layer 3. W2's B fragments are split once into shared
// memory (from the f32 pairs of `ops/cnf.py:_field_weights`, the pack the
// adjoint reads too). The gates of layers 1 and 2 depend only on the
// stage's time and the condition row: with rep > 1 a warp computes them
// once a condition row and stage time into a table its rows read (with
// the same `gate`, so the bits are those a row would compute); with rep =
// 1 each row computes its own in place; which of the two is a template
// parameter, so no evaluation branches on it. A tile's projections are
// staged when its warp takes it up, and stay staged while the warp owns
// that one tile. Between steps the state (y[, logp] and the FSAL stage k1)
// lives in device memory in two copies: a step reads copy `cur` and writes
// its candidate (y5, k7) to the other, and an accepted step flips `cur`,
// so nothing is copied. The norm is summed in a fixed order: within a tile
// by a shuffle tree, over a warp's tiles in index order, over a block's
// warps in index order, over blocks in a fixed order after the sync, each
// block repeating the same sum, so every block takes the same decision and
// two runs agree bit for bit (no float atomics). A partial last tile adds
// nothing to the sum.
//
// Per-attempt mode (`puflow_cnf_solve_attempt` in cnf_solve_attempt.cu,
// either field; template parameter kSplit; the kernel and the launch of
// both modes are in cnf_solve.cuh, each mode compiled in its own source so
// that nvcc builds them side by side). Data parallel, a rank holds a shard of the batch,
// and the step size must come from the error norm of every rank's rows,
// as a sharded jit of the JAX solver takes it; the ranks' sums meet in a
// collective (NCCL or gloo, `torch.distributed`), which no kernel can
// wait for. So the loop is cut at each attempt: a
// launch runs one attempt (the six stages, the candidate into the other
// state copy, the block partials in the order above) and the last block
// to finish (an integer ticket) sums the partials in the same fixed order
// into this rank's local sum and entry count (two doubles). The wrapper
// exchanges them exactly (`parallel.gather_batch`) and the next launch's
// prologue adds the ranks' pairs in rank order, divides the sum by the
// global count and applies the same `control` in every block; block 0
// writes the result to a control block in device memory (t, h, cur,
// attempts, accepted, finished; two copies, by attempt parity, so that no
// block reads what another writes). A launch that finds the solve
// finished writes the outputs and the stats; the host reads the finished
// flag after each launch. The state copies stay where they are. The grid
// and the tile-to-warp map are the one-launch path's for the same rows
// (its occupancy decides them), so at world size 1 the mode computes the
// one-launch kernel's outputs and stats bit for bit: the same arithmetic
// in the same order, plus an exact 0 + sum. A rank with no rows launches
// one block that adds 0 and joins every exchange.

#include "cnf_solve.cuh"

namespace puflow {
namespace {

// The blocks of a `solve_kernel` that fit the current card at once (the
// kernel's shared-memory limit set), found at the first call on each card;
// 0 and an error if the card cannot take it.
template <bool kTrace, int kHalves, bool kTable>
cudaError_t resident_blocks(int* blocks) {
  using L = Layout<kTrace, kHalves, kTable>;
  static std::atomic<int> resident[kMaxDevices];
  cudaError_t err;
  int dev = 0;
  *blocks = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *blocks = resident[dev].load(std::memory_order_relaxed);
  if (*blocks > 0) return cudaSuccess;
  const auto kernel = solve_kernel<kTrace, kHalves, kTable, false>;
  const int smem = static_cast<int>(sizeof(float) * L::kFloats);
  int sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = sms * per_sm;
  resident[dev].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

cudaError_t solve_resident_blocks(bool trace, int halves, bool table,
                                  int* blocks) {
  if (halves == 1)
    return trace ? (table ? resident_blocks<true, 1, true>(blocks)
                          : resident_blocks<true, 1, false>(blocks))
                 : (table ? resident_blocks<false, 1, true>(blocks)
                          : resident_blocks<false, 1, false>(blocks));
  return trace ? (table ? resident_blocks<true, 2, true>(blocks)
                        : resident_blocks<true, 2, false>(blocks))
               : (table ? resident_blocks<false, 2, true>(blocks)
                        : resident_blocks<false, 2, false>(blocks));
}

}  // namespace puflow

// y0 [n_rows, 3] -> out [n_rows, 3] = y(t1), with t01 = {t0, t1} on the
// device. proj is [n_rows / rep, 262]; weights are `_field_weights`' (16-
// byte aligned); state is scratch of 12 n_rows floats, partials scratch of
// 2 max_grid doubles; stats gets the steps attempted and accepted. n_rows
// > 0 and rep divides n_rows.
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
  return launch<false, false>(args, max_grid,
                              static_cast<cudaStream_t>(stream));
}

// y0 [n_rows, 3], logp0 [n_rows] -> out_y, out_logp at t1, with t01 = {t0,
// t1} on the device. proj is [n_rows / rep, 262]; weights as
// `puflow_cnf_solve`'s; state is scratch of 16 n_rows floats, partials
// scratch of 2 max_grid doubles; stats gets the steps attempted and
// accepted. n_rows > 0 and rep divides n_rows.
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
  return launch<true, false>(args, max_grid,
                             static_cast<cudaStream_t>(stream));
}

