// Per-channel pair statistics (sum a, sum a*b) over the middle axis of
// [B, S, C] (K10), the two reductions of GroupNorm: forward (x, x) ->
// (sum x, sum x^2), backward (dy, x) -> (sum dy, sum dy*x).
//
// Replaces (TPU / Pallas): motioneditor_tpu/ops/gn_stats.py _pair_stats
// (_stats_kernel, pallas_call at gn_stats.py:78).
//
// What it computes. s1[b, c] = sum_s a[b, s, c] and s2[b, c] = sum_s
// a[b, s, c] * b[b, s, c] for fp32 or bf16 inputs, rounded to fp32 into
// out [2, B, C] (s1 then s2). A thread adds each batch of U rows in fp32
// and the batches into a compensated pair of fp32 (TwoSum, about 48 bits),
// and every later sum is fp64: an error of a few ulps of a U-row batch,
// not one that grows with S and depends on the order. GroupNorm takes
// var = E[x^2] - mean^2 from these sums and ReLUs follow, where a long fp32
// sum's order-dependent error can flip a unit (a tiny fp32 training check
// against the plain path did). fp32 to fp64 conversions run at a quarter
// of the fp64 rate, hence no fp64 in the loop over rows.
//
// What bounds it on the H100. Memory: 2 or 3 flops per element loaded; the
// bound is the bytes of a (and b when it is another tensor) over 3.35 TB/s.
// At the training step's shapes that is 1-13 us, so the launch, the
// load latency and the cross-block combine all count.
//
// Design: one launch, a fixed summation order.
// - The launch plan is Python's (ops/gn_stats.py pair_stats_plan, set from
//   chip_variants.py --k10-plans): vec channels a load, cols column groups
//   of a channel slice, ctas blocks along S per (batch row, slice), rows a
//   block, threads = cols x lanes. The grid (ctas, slices, B) holds at most
//   one block an SM (an SM
//   that ran two blocks of equal rows would double the time): slices of
//   128-byte lines of a row, as narrow as the SMs allow, and S split only
//   where a block would otherwise read more than the combine costs.
// - Streaming loads. With vec = 16 / itemsize (8 bf16, 4 fp32) each thread
//   loads 16 bytes along C; thread (lane, col) sums rows lane, lane +
//   lanes, ... of its block, U rows loaded back to back (U = 8 for (x, x),
//   4 for (dy, x)), and keeps the next U rows' loads in flight while
//   it adds the current U (else the warps' adds leave the memory idle). vec = 1
//   is the general body (rows off a 16-byte boundary, C * itemsize % 16 !=
//   0): the same code on 1-element loads; the host routes between the two.
// - The block's lanes are added through shared memory, one sum at a time:
//   runs of 8 lanes in lane order in the compensated pair, each rounded to
//   fp64 once (conversions are the slow part), then the runs in order.
// - The combine, inside the launch. With one block along S (ctas = 1) the
//   block's sums are the output. Otherwise (at most 16 blocks along S,
//   the plan's cap) each block writes an fp64 partial per (channel, sum) to
//   the workspace and takes an integer ticket (one acquire-release add on
//   its (batch row, slice)'s counter); the block that draws the last ticket
//   adds the partials with all of its threads, spread over channels and
//   over chunks of consecutive partials (sum_partials), into out, and
//   resets the counter to 0 for the next launch on the stream. Every sum
//   runs in an order fixed by the plan (no float atomics): two runs on one
//   card give bit-identical statistics, as the TPU kernel's sequential grid
//   does.
// - With a == b (the forward) each element is loaded once.
//
// Workspace: B * slices * ctas * 2 * cols * vec doubles of partials;
// tickets: B * slices unsigned ints, all 0 before the launch (and after).
#include "norm_stats.cuh"

// dtype: 0 float32, 1 bfloat16. out: [2, B, C] fp32 (s1, s2). work and
// tickets as above (tickets all 0). The plan (vec, cols, ctas, rows,
// threads) is ops/gn_stats.py pair_stats_plan's; vec = 16 / itemsize
// needs a, b and work on 16-byte boundaries. Passing b == a reads the input once.
// Returns a cudaError_t code (0 = launched; cudaErrorInvalidValue for a plan
// that does not fit the shape or a misaligned operand of the 16-byte body).
extern "C" int me_pair_stats(const void* a, const void* b, void* out, void* work, void* tickets,
                             int B, int S, int C, int dtype, int vec, int cols, int ctas,
                             int rows, int threads, void* stream) {
  Plan p;
  const int bad = pair_stats_plan(a, b, work, B, S, C, dtype, vec, cols, ctas, rows, threads, &p);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  double* w = static_cast<double*>(work);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  if (dtype == 0)
    return (int)(vec == 1 ? pair_stats_launch<float, 1>(a, b, o, w, t, p, threads, st)
                          : pair_stats_launch<float, 4>(a, b, o, w, t, p, threads, st));
  return (int)(vec == 1 ? pair_stats_launch<__nv_bfloat16, 1>(a, b, o, w, t, p, threads, st)
                        : pair_stats_launch<__nv_bfloat16, 8>(a, b, o, w, t, p, threads, st));
}
