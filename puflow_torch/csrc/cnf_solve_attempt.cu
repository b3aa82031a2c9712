// The per-attempt mode of the CNF block solves (`solve_kernel<..., kSplit =
// true>` of cnf_solve.cuh): one attempt a launch, the ranks' error sums
// exchanged between launches. The design is described in cnf_solve.cu.

#include "cnf_solve.cuh"

// One attempt of either solve in the per-attempt mode: `puflow_cnf_solve`'s
// or `puflow_cnf_solve_logp`'s arguments (logp0 and out_logp null for the
// plain field; n_rows may be 0), then the attempt's index (0 first), the
// ranks' (sum, count) pairs of the previous attempt in rank order
// ([world][2] doubles, read from attempt 1 on), the control blocks (17
// ints, zero before attempt 0; the finished flag of attempt a is int
// 8 (a & 1) + 5) and this rank's (sum, count) of this attempt (2
// doubles). partials needs max_grid doubles.
extern "C" int puflow_cnf_solve_attempt(
    const void* y0, const void* logp0, const void* proj, const void* weights,
    const void* t01, int n_rows, int rep, float rtol, float atol,
    int max_steps, void* state, void* partials, int max_grid, void* out_y,
    void* out_logp, void* stats, int attempt, const void* exchange,
    int world, void* ctrl, void* local, void* stream) {
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
  args.attempt = attempt;
  args.world = world;
  args.exchange = static_cast<const double*>(exchange);
  args.ctrl = static_cast<int*>(ctrl);
  args.local = static_cast<double*>(local);
  const bool trace = logp0 != nullptr;
  if (trace != (out_logp != nullptr)) return cudaErrorInvalidValue;
  return trace ? launch<true, true>(args, max_grid,
                                    static_cast<cudaStream_t>(stream))
               : launch<false, true>(args, max_grid,
                                     static_cast<cudaStream_t>(stream));
}
