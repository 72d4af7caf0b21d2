// GroupNorm forward over [B, S, C], with the SiLU that follows it when
// asked, where no gradient is recorded: one call (me_group_norm) launches
// two kernels back to back on the caller's stream.
//
// Replaces (TPU / Pallas): none. The JAX package's GroupNorm with
// MOTIONEDITOR_FUSED_GN off is plain jnp code that XLA fuses on the TPU into
// a statistics pass and an apply pass; in PyTorch's eager mode the same code
// is ~11 kernels over fp32 copies of the activation (x.float(), var_mean,
// the subtract, rsqrt, multiplies and adds, the cast back) and a 12th for
// the SiLU, ~48-52 bytes moved an element.
//
// What it computes, as models/layers.py group_norm's plain version does:
// per (batch row, group) the mean and variance (unbiased=False) over S and
// the group's C / G channels, then per element in fp32, rounded as the
// plain version's separate kernels round,
//   y = bf16(((x - mean) * rstd) * w + b),  rstd = 1 / sqrt(var + eps),
// and with the SiLU silu(float(y)) rounded once more. Only the statistics
// round differently: here the sums stay in fp64 (K10's compensated fp32
// batches, fp64 partials) until the group's variance E[x^2] - mean^2 is
// formed, so an input whose mean is far above its spread loses nothing
// to cancellation.
//
// What bounds it on the H100. Memory: 2 or 3 flops per element; the least
// traffic is reading x twice (statistics, apply) and writing y once, 6
// bytes an element in bf16, over 3.35 TB/s.
//
// Design:
// - (a) Statistics: K10's kernel (norm_stats.cuh), launched on its Python
//   plan (ops/gn_stats.py pair_stats_plan) with a == b, writes the
//   per-channel (sum x, sum x^2) of each batch row in fp64 into the
//   workspace: its 16-byte loads, one block an SM at most, its fixed-order
//   in-launch combine behind an integer ticket.
// - (b) Apply: grid (ctas, B); each block first folds its batch row's C
//   channel sums into the G groups' mean and rstd (a warp a group at a
//   time, lanes over the group's channels, then a butterfly of shuffles:
//   a fixed order) into shared memory. A thread owns one 16-byte column
//   group of 8 bf16 (4 fp32) channels, keeps their mean, rstd, weight
//   and bias in registers, and streams rows of its batch row with 16-byte
//   loads and stores, U = 4 rows in flight and the next chunk's 4 loading
//   while the current ones are written; the blocks of a batch row take
//   chunks of lanes x U rows in turn, so the grid moves through memory
//   together, in one wave of at most 2 blocks an SM (ops/group_norm.py
//   apply_plan; a sweep on the H100 of threads, U, the prefetch and blocks
//   an SM chose these). The arithmetic uses the _rn intrinsics, which the compiler
//   never contracts into an fma, so each step rounds where the plain
//   version's kernels do.
// - The 16-byte body only: the host sends rows whose C * itemsize is not
//   a multiple of 16, or operands off 16-byte boundaries, to the plain
//   version.
//
// Workspace: [2, B, C] doubles of sums, then K10's partials; tickets as
// K10's (all 0 before the launch and after).
#include <stdint.h>

#include "common.cuh"
#include "norm_stats.cuh"

namespace {

constexpr int APPLY_MAX_THREADS = 512;  // ops/group_norm.py APPLY_MAX_THREADS
constexpr int APPLY_ROWS = 4;            // U: a thread's rows in flight (ops/group_norm.py)

// 16-byte stores of an output column group, and the output dtype's rounding
template <typename T>
struct Out;

template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    me::store8(p, v);
  }
  // the value as the plain version's bf16 tensor holds it
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Out<float> {
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

// K10's 16-byte loads (norm_stats.cuh): 8 bf16 or 4 fp32 channels
template <typename T>
using Load16 = Loader<T, 16 / sizeof(T)>;

struct ApplyShape {
  int B, S, C, G;
  float eps;
};

// U rows r, r + lanes, ... below S of a thread's column group, 16 bytes each
template <typename T, int U>
__device__ __forceinline__ void load_rows(typename Load16<T>::Raw* buf, const T* px, int r,
                                          int lanes, int S, int C) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int rr = r + u * lanes;
    if (rr < S) buf[u] = Load16<T>::load(px + (size_t)rr * C);
  }
}

// grid (ctas, B), blockDim a multiple of 32; dynamic shared memory 2 * G
// floats (the groups' mean, then rstd). The next chunk's U rows load while
// the current ones are written.
template <typename T, typename W, bool SILU>
__global__ void __launch_bounds__(APPLY_MAX_THREADS)
    group_norm_apply_kernel(const T* __restrict__ x, const double* __restrict__ sums,
                            const W* __restrict__ weight, const W* __restrict__ bias,
                            T* __restrict__ y, ApplyShape p) {
  using Raw = typename Load16<T>::Raw;
  constexpr int N = 16 / sizeof(T);
  extern __shared__ float group_stats[];
  const int bi = blockIdx.y;
  const int cpg = p.C / p.G;
  {  // the batch row's groups from its channel sums, a warp a group
    const double* s1 = sums + (size_t)bi * p.C;
    const double* s2 = sums + ((size_t)p.B + bi) * p.C;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const double n = (double)p.S * cpg;
    for (int g = warp; g < p.G; g += blockDim.x / 32) {
      double a = 0.0, q = 0.0;
      for (int k = lane; k < cpg; k += 32) {
        a += __ldcg(s1 + g * cpg + k);
        q += __ldcg(s2 + g * cpg + k);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (lane == 0) {
        const double mean = a / n;
        const double var = fmax(q / n - mean * mean, 0.0);
        group_stats[g] = (float)mean;
        group_stats[p.G + g] = (float)(1.0 / sqrt(var + (double)p.eps));
      }
    }
  }
  __syncthreads();
  const int ncol = p.C / N;
  const int cols = min(ncol, (int)blockDim.x);
  const int lanes = blockDim.x / cols;
  const int col = threadIdx.x % cols, lr = threadIdx.x / cols;
  if (lr >= lanes) return;
  constexpr int U = APPLY_ROWS;
  const int step = lanes * U;  // rows of one chunk
  const int stride = gridDim.x * step;
  const size_t row0 = (size_t)bi * p.S;
  for (int q = col; q < ncol; q += cols) {
    const int c0 = q * N;
    float mean[N], rstd[N], w[N], b[N];
#pragma unroll
    for (int v = 0; v < N; ++v) {
      const int g = (c0 + v) / cpg;
      mean[v] = group_stats[g];
      rstd[v] = group_stats[p.G + g];
      w[v] = me::load1(weight + c0 + v);
      b[v] = me::load1(bias + c0 + v);
    }
    const T* px = x + row0 * p.C + c0;
    T* py = y + row0 * p.C + c0;
    Raw in[U];
    int r = blockIdx.x * step + lr;
    load_rows<T, U>(in, px, r, lanes, p.S, p.C);
    for (; r < p.S; r += stride) {
      Raw next[U];
      load_rows<T, U>(next, px, r + stride, lanes, p.S, p.C);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * lanes;
        if (rr < p.S) {
          float f[N];
          Load16<T>::to_float(in[u], f);
#pragma unroll
          for (int v = 0; v < N; ++v) {
            float t = __fmul_rn(__fsub_rn(f[v], mean[v]), rstd[v]);
            t = __fadd_rn(__fmul_rn(t, w[v]), b[v]);
            if (SILU) {
              t = Out<T>::round(t);
              t = t / (1.0f + expf(-t));
            }
            f[v] = t;
          }
          Out<T>::store(py + (size_t)rr * p.C, f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) in[u] = next[u];
    }
  }
}

template <typename T, typename W>
cudaError_t apply_launch(const void* x, const double* sums, const void* w, const void* b, void* y,
                         const ApplyShape& p, int silu, int threads, int ctas, cudaStream_t st) {
  const dim3 grid(ctas, p.B);
  const size_t smem = 2 * p.G * sizeof(float);
  const T* tx = static_cast<const T*>(x);
  const W* tw = static_cast<const W*>(w);
  const W* tb = static_cast<const W*>(b);
  T* ty = static_cast<T*>(y);
  if (silu)
    group_norm_apply_kernel<T, W, true><<<grid, threads, smem, st>>>(tx, sums, tw, tb, ty, p);
  else
    group_norm_apply_kernel<T, W, false><<<grid, threads, smem, st>>>(tx, sums, tw, tb, ty, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, double* sums,
                   double* work, unsigned int* tickets, const Plan& plan, int stats_threads,
                   const ApplyShape& p, int wdtype, int silu, int threads, int ctas,
                   cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  cudaError_t e = pair_stats_launch<T, VEC>(x, x, sums, work, tickets, plan, stats_threads, st);
  if (e != cudaSuccess) return e;
  return wdtype == 0 ? apply_launch<T, float>(x, sums, w, b, y, p, silu, threads, ctas, st)
                     : apply_launch<T, __nv_bfloat16>(x, sums, w, b, y, p, silu, threads, ctas,
                                                      st);
}

}  // namespace

// x, y: [B, S, C] of dtype (0 float32, 1 bfloat16), C a multiple of 16 /
// itemsize and of G; w, b: [C] of wdtype. work: [2, B, C] doubles of sums,
// then K10's partials (ops/gn_stats.py PairStatsPlan.workspace_floats);
// tickets as K10's. (vec, cols, ctas, rows, threads): K10's plan of [B, S,
// C] with vec = 16 / itemsize; (apply_threads, apply_ctas):
// ops/group_norm.py apply_plan's. silu: apply the SiLU after the norm.
// Returns a cudaError_t code (0 = both launched; cudaErrorInvalidValue for a
// shape, plan or operand the kernels do not take).
extern "C" int me_group_norm(const void* x, const void* w, const void* b, void* y, void* work,
                             void* tickets, int B, int S, int C, int G, float eps, int silu,
                             int dtype, int wdtype, int vec, int cols, int ctas, int rows,
                             int threads, int apply_threads, int apply_ctas, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (vec * itemsize != 16 || G < 1 || C % G != 0 || (wdtype != 0 && wdtype != 1))
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) ||
      ((reinterpret_cast<uintptr_t>(work)) & 15))
    return (int)cudaErrorInvalidValue;
  const int ncol = C / vec;
  if (apply_threads < 32 || apply_threads > APPLY_MAX_THREADS || apply_threads % 32 != 0 ||
      apply_ctas < 1 || 2 * G * (int)sizeof(float) > 48 * 1024 ||
      apply_threads / (ncol < apply_threads ? ncol : apply_threads) < 1)
    return (int)cudaErrorInvalidValue;
  double* sums = static_cast<double*>(work);
  double* partials = sums + 2 * (size_t)B * C;
  Plan plan;
  const int bad = pair_stats_plan(x, x, partials, B, S, C, dtype, vec, cols, ctas, rows, threads,
                                  &plan);
  if (bad) return bad;
  ApplyShape p;
  p.B = B; p.S = S; p.C = C; p.G = G;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  if (dtype == 0)
    return (int)launch<float>(x, w, b, y, sums, partials, t, plan, threads, p, wdtype, silu,
                              apply_threads, apply_ctas, st);
  return (int)launch<__nv_bfloat16>(x, w, b, y, sums, partials, t, plan, threads, p, wdtype, silu,
                                    apply_threads, apply_ctas, st);
}
