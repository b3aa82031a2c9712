// The per-attempt mode of the CNF adjoint's backward solve
// (`cnf_adjoint_kernel<kTrace, true>` of cnf_adjoint.cuh): one attempt a
// launch, the ranks' sums exchanged between launches. The design is
// described in cnf_adjoint.cu.

#include "cnf_adjoint.cuh"

// One attempt of the backward solve in the per-attempt mode:
// `puflow_cnf_adjoint`'s arguments (the same scratch, kept between the
// launches of one solve), then the attempt's index (0 first); the ranks'
// sums of the previous attempt in rank order ([world][2 ng + 6] floats:
// S5 and SE of every G entry, the row terms' sum and count as doubles, the
// grid; read from attempt 1 on); the control blocks (16 ints, the finished
// flag of attempt a is int 8 (a & 1) + 5); this rank's sums of this
// attempt ([2 ng + 6] floats, 8-byte aligned); and gloc, this rank's own G
// ([2][ng] floats), or null at world size 1, where it is the global G.
// Outputs as `puflow_cnf_adjoint`'s, written by the launch that finishes;
// out_g is this rank's G.
extern "C" int puflow_cnf_adjoint_attempt(
    const void* y1, const void* logp1, const void* a1, const void* ap,
    const void* c, const void* proj, const void* weights, const void* wct,
    const void* t01, int n_rows, int rep, int cdim, int cdim_true,
    int with_trace, float rtol, float atol, int max_steps, void* rows,
    long long rows_floats, void* per_grid, long long per_grid_floats,
    void* partials, long long partials_doubles, int max_grid, void* out_y0,
    void* out_a0, void* out_dc, void* out_g, void* out_bnd, void* stats,
    int attempt, const void* exchange, int world, void* ctrl, void* local,
    void* gloc, void* stream) {
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
  if (attempt < 0 || world < 1 || ctrl == nullptr || local == nullptr ||
      reinterpret_cast<uintptr_t>(local) % 8 != 0 ||
      (attempt > 0 && exchange == nullptr) || (world > 1 && gloc == nullptr))
    return cudaErrorInvalidValue;
  args.attempt = attempt;
  args.world = world;
  args.exchange = static_cast<const float*>(exchange);
  args.ctrl = static_cast<int*>(ctrl);
  args.local = static_cast<float*>(local);
  args.gloc = static_cast<float*>(gloc);
  const auto s = static_cast<cudaStream_t>(stream);
  return with_trace ? launch<true, true>(args, dev, s)
                    : launch<false, true>(args, dev, s);
}
