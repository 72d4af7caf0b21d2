// GroupNorm over [B, S, C], with the SiLU that follows it when asked: the
// forward in one call (me_group_norm) of two kernels back to back on the
// caller's stream, and, where autograd records a gradient, the backward in
// one call (me_group_norm_bwd) of two more.
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
// - Where a gradient is recorded, the first block of each batch row also
//   writes the groups' fp32 mean and rstd, as the apply kernel used them,
//   to `stats` [2, B, G] for the backward.
//
// Backward (me_group_norm_bwd). Replaces PyTorch autograd's backward of
// the plain version and F.silu: ~25 kernels, most over fp32 copies of the
// activation, ~100 bytes an element. With z = ((x - mean) * rstd) * w + b
// the forward's pre-activation and g = dy * silu'(z) (g = dy without the
// SiLU), per (batch row, group) of N = S * C / G elements:
//   dx = rstd * w * g - (x - mean) * b_g - a_g,
//   a_g = rstd / N * sum_c w_c S1_c,
//   b_g = rstd^3 / N * sum_c w_c (S2_c - mean * S1_c),
//   dw_c = sum_b rstd * (S2_c - mean * S1_c),  db_c = sum_b S1_c,
// with S1_c = sum_s g and S2_c = sum_s g * x per channel. That is JAX's
// _gn_bwd (dx = dy * gain - x * b_g + c_g) with the x - mean of the forward
// kept, so a mean far above the spread does not cancel in fp32.
// - (c) Gradient statistics: K10's kernel on (dy, x) with the map a -> g
//   (SiluGrad: z recomputed from the forward's fp32 mean and rstd at its
//   rounding points, so bit for bit the z the forward rounded, then
//   PyTorch's silu_backward arithmetic, rounded to x's dtype as the
//   plain version's gradient is): S1, S2 per channel in fp64, K10's plan
//   and fixed-order combine, 2 rows of each input in flight (the map's
//   registers).
// - (d) Apply: the forward's grid and plan; each block folds its batch
//   row's channel sums into the groups' a_g, b_g in fp64 (a warp a group,
//   as (b)), spreads dw, db (channels over the grid's blocks, batch rows in
//   order) when asked for, then streams dy and x with 16-byte loads, U = 4
//   rows in flight, recomputes g and writes dx in x's dtype; with dx not
//   asked for it stops after dw, db.
// The least traffic is 10 bytes an element in bf16: dy and x read twice,
// dx written once.
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

// the norm and affine in fp32, each step rounded as the plain version's
// separate kernels round it: the _rn intrinsics are never contracted into
// an fma
__device__ __forceinline__ float pre_activation(float x, float mean, float rstd, float w,
                                                float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), w), b);
}

// dy * silu'(z) as PyTorch's silu_backward computes it in fp32, rounded to
// T as the plain version's gradient of a T tensor is
template <typename T>
__device__ __forceinline__ float silu_grad(float dy, float z) {
  const float s = 1.0f / (1.0f + expf(-z));
  return Out<T>::round(dy * s * (1.0f + z * (1.0f - s)));
}

// The backward's map of dy before K10's sums (norm_stats.cuh's Op): g =
// dy * silu'(z), z the forward's pre-activation rounded to T
template <typename T, typename W>
struct SiluGrad {
  const float* stats;  // [2, B, G]: the forward's mean, then rstd
  const W* w;
  const W* b;
  int B, G, cpg;

  template <int VEC>
  struct Lane {
    float mean[VEC], rstd[VEC], w[VEC], b[VEC];
    __device__ __forceinline__ void init(const SiluGrad& o, int bi, int c0) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int g = (c0 + v) / o.cpg;
        mean[v] = o.stats[(size_t)bi * o.G + g];
        rstd[v] = o.stats[((size_t)o.B + bi) * o.G + g];
        w[v] = me::load1(o.w + c0 + v);
        b[v] = me::load1(o.b + c0 + v);
      }
    }
    __device__ __forceinline__ float operator()(int v, float dy, float x) const {
      return silu_grad<T>(dy, Out<T>::round(pre_activation(x, mean[v], rstd[v], w[v], b[v])));
    }
  };
};

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
                            T* __restrict__ y, float* __restrict__ stats, ApplyShape p) {
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
  if (stats && blockIdx.x == 0) {  // for the backward: [2, B, G], mean then rstd
    for (int i = threadIdx.x; i < 2 * p.G; i += blockDim.x)
      stats[((size_t)(i / p.G) * p.B + bi) * p.G + i % p.G] = group_stats[i];
  }
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
            float t = pre_activation(f[v], mean[v], rstd[v], w[v], b[v]);
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
                         float* stats, const ApplyShape& p, int silu, int threads, int ctas,
                         cudaStream_t st) {
  const dim3 grid(ctas, p.B);
  const size_t smem = 2 * p.G * sizeof(float);
  const T* tx = static_cast<const T*>(x);
  const W* tw = static_cast<const W*>(w);
  const W* tb = static_cast<const W*>(b);
  T* ty = static_cast<T*>(y);
  if (silu)
    group_norm_apply_kernel<T, W, true>
        <<<grid, threads, smem, st>>>(tx, sums, tw, tb, ty, stats, p);
  else
    group_norm_apply_kernel<T, W, false>
        <<<grid, threads, smem, st>>>(tx, sums, tw, tb, ty, stats, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, float* stats,
                   double* sums, double* work, unsigned int* tickets, const Plan& plan,
                   int stats_threads, const ApplyShape& p, int wdtype, int silu, int threads,
                   int ctas, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  cudaError_t e = pair_stats_launch<T, VEC>(x, x, sums, work, tickets, plan, stats_threads, st);
  if (e != cudaSuccess) return e;
  return wdtype == 0
             ? apply_launch<T, float>(x, sums, w, b, y, stats, p, silu, threads, ctas, st)
             : apply_launch<T, __nv_bfloat16>(x, sums, w, b, y, stats, p, silu, threads, ctas,
                                              st);
}

// ---- backward ---------------------------------------------------------------------

constexpr int BWD_ROWS = 4;  // U of the backward's apply: rows of dy and x in flight

// grid (ctas, B) as the forward's apply; dynamic shared memory 4 * G floats
// (the groups' mean, rstd, b_g, a_g). sums: [2, B, C] of S1, S2; stats:
// [2, B, G] of the forward's mean, rstd. dx, dw, db: null where not asked
// for.
template <typename T, typename W, bool SILU>
__global__ void __launch_bounds__(APPLY_MAX_THREADS)
    group_norm_bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                                const double* __restrict__ sums,
                                const float* __restrict__ stats, const W* __restrict__ weight,
                                const W* __restrict__ bias, T* __restrict__ dx,
                                W* __restrict__ dw, W* __restrict__ db, ApplyShape p) {
  using Raw = typename Load16<T>::Raw;
  constexpr int N = 16 / sizeof(T);
  extern __shared__ float group_coef[];
  const int bi = blockIdx.y;
  const int cpg = p.C / p.G;
  const double* s1 = sums;
  const double* s2 = sums + (size_t)p.B * p.C;
  const float* means = stats;
  const float* rstds = stats + (size_t)p.B * p.G;
  if (dw || db) {  // channels over the grid's blocks, each channel's batch rows in order
    const int blocks = gridDim.x * gridDim.y;
    const int k = blockIdx.y * gridDim.x + blockIdx.x;
    for (int c = k * blockDim.x + threadIdx.x; c < p.C; c += blocks * blockDim.x) {
      const int g = c / cpg;
      double aw = 0.0, ab = 0.0;
      for (int r = 0; r < p.B; ++r) {
        const double a = __ldcg(s1 + (size_t)r * p.C + c);
        const double q = __ldcg(s2 + (size_t)r * p.C + c);
        aw += (double)rstds[(size_t)r * p.G + g] * (q - (double)means[(size_t)r * p.G + g] * a);
        ab += a;
      }
      if (dw) me::store1(dw + c, (float)aw);
      if (db) me::store1(db + c, (float)ab);
    }
  }
  if (!dx) return;
  {  // the batch row's groups from its channel sums, a warp a group
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const double n = (double)p.S * cpg;
    for (int g = warp; g < p.G; g += blockDim.x / 32) {
      const float mean = means[(size_t)bi * p.G + g];
      const float rstd = rstds[(size_t)bi * p.G + g];
      double a = 0.0, q = 0.0;
      for (int k = lane; k < cpg; k += 32) {
        const int c = g * cpg + k;
        const double w = me::load1(weight + c);
        const double t1 = __ldcg(s1 + (size_t)bi * p.C + c);
        const double t2 = __ldcg(s2 + (size_t)bi * p.C + c);
        a += w * t1;
        q += w * (t2 - (double)mean * t1);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (lane == 0) {
        const double r = rstd;
        group_coef[g] = mean;
        group_coef[p.G + g] = rstd;
        group_coef[2 * p.G + g] = (float)(r * r * r * q / n);
        group_coef[3 * p.G + g] = (float)(r * a / n);
      }
    }
  }
  __syncthreads();
  const int ncol = p.C / N;
  const int cols = min(ncol, (int)blockDim.x);
  const int lanes = blockDim.x / cols;
  const int col = threadIdx.x % cols, lr = threadIdx.x / cols;
  if (lr >= lanes) return;
  constexpr int U = BWD_ROWS;
  const int step = lanes * U;
  const int stride = gridDim.x * step;
  const size_t row0 = (size_t)bi * p.S;
  for (int q = col; q < ncol; q += cols) {
    const int c0 = q * N;
    float mean[N], rstd[N], w[N], b[N], bg[N], ag[N];
#pragma unroll
    for (int v = 0; v < N; ++v) {
      const int g = (c0 + v) / cpg;
      mean[v] = group_coef[g];
      rstd[v] = group_coef[p.G + g];
      bg[v] = group_coef[2 * p.G + g];
      ag[v] = group_coef[3 * p.G + g];
      w[v] = me::load1(weight + c0 + v);
      b[v] = SILU ? me::load1(bias + c0 + v) : 0.f;
    }
    const T* pdy = dy + row0 * p.C + c0;
    const T* px = x + row0 * p.C + c0;
    T* pdx = dx + row0 * p.C + c0;
    for (int r = blockIdx.x * step + lr; r < p.S; r += stride) {
      Raw rd[U], rx[U];
      load_rows<T, U>(rd, pdy, r, lanes, p.S, p.C);
      load_rows<T, U>(rx, px, r, lanes, p.S, p.C);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * lanes;
        if (rr < p.S) {
          float fd[N], fx[N];
          Load16<T>::to_float(rd[u], fd);
          Load16<T>::to_float(rx[u], fx);
#pragma unroll
          for (int v = 0; v < N; ++v) {
            float g = fd[v];
            if (SILU)
              g = silu_grad<T>(g, Out<T>::round(pre_activation(fx[v], mean[v], rstd[v], w[v],
                                                                b[v])));
            const float xc = __fsub_rn(fx[v], mean[v]);
            fd[v] = rstd[v] * w[v] * g - (xc * bg[v] + ag[v]);
          }
          Out<T>::store(pdx + (size_t)rr * p.C, fd);
        }
      }
    }
  }
}

template <typename T, typename W>
cudaError_t bwd_launch(const void* dy, const void* x, const void* w, const void* b,
                       const float* stats, void* dx, void* dw, void* db, double* sums,
                       double* work, unsigned int* tickets, const Plan& plan, int stats_threads,
                       const ApplyShape& p, int silu, int threads, int ctas, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const W* tw = static_cast<const W*>(w);
  const W* tb = static_cast<const W*>(b);
  cudaError_t e;
  if (silu) {
    SiluGrad<T, W> op{stats, tw, tb, p.B, p.G, p.C / p.G};
    e = pair_stats_launch<T, VEC>(dy, x, sums, work, tickets, plan, stats_threads, st, op);
  } else {
    e = pair_stats_launch<T, VEC>(dy, x, sums, work, tickets, plan, stats_threads, st);
  }
  if (e != cudaSuccess) return e;
  const dim3 grid(ctas, p.B);
  const size_t smem = 4 * p.G * sizeof(float);
  const T* tdy = static_cast<const T*>(dy);
  const T* tx = static_cast<const T*>(x);
  T* tdx = static_cast<T*>(dx);
  W* tdw = static_cast<W*>(dw);
  W* tdb = static_cast<W*>(db);
  if (silu)
    group_norm_bwd_apply_kernel<T, W, true>
        <<<grid, threads, smem, st>>>(tdy, tx, sums, stats, tw, tb, tdx, tdw, tdb, p);
  else
    group_norm_bwd_apply_kernel<T, W, false>
        <<<grid, threads, smem, st>>>(tdy, tx, sums, stats, tw, tb, tdx, tdw, tdb, p);
  return cudaGetLastError();
}

// The checks both entries make of the shape and the apply plan
int check_shape(int vec, int itemsize, int C, int G, int wdtype, int apply_threads,
                int apply_ctas, int stat_floats) {
  if (vec * itemsize != 16 || G < 1 || C % G != 0 || (wdtype != 0 && wdtype != 1))
    return (int)cudaErrorInvalidValue;
  const int ncol = C / vec;
  if (apply_threads < 32 || apply_threads > APPLY_MAX_THREADS || apply_threads % 32 != 0 ||
      apply_ctas < 1 || stat_floats * G * (int)sizeof(float) > 48 * 1024 ||
      apply_threads / (ncol < apply_threads ? ncol : apply_threads) < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x, y: [B, S, C] of dtype (0 float32, 1 bfloat16), C a multiple of 16 /
// itemsize and of G; w, b: [C] of wdtype. stats: null, or [2, B, G] fp32
// for the groups' mean and rstd (the backward's). work: [2, B, C] doubles
// of sums, then K10's partials (ops/gn_stats.py
// PairStatsPlan.workspace_floats); tickets as K10's. (vec, cols, ctas,
// rows, threads): K10's plan of [B, S, C] with vec = 16 / itemsize;
// (apply_threads, apply_ctas): ops/group_norm.py apply_plan's. silu: apply
// the SiLU after the norm. Returns a cudaError_t code (0 = both launched;
// cudaErrorInvalidValue for a shape, plan or operand the kernels do not
// take).
extern "C" int me_group_norm(const void* x, const void* w, const void* b, void* y, void* stats,
                             void* work, void* tickets, int B, int S, int C, int G, float eps,
                             int silu, int dtype, int wdtype, int vec, int cols, int ctas,
                             int rows, int threads, int apply_threads, int apply_ctas,
                             void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const int bad = check_shape(vec, itemsize, C, G, wdtype, apply_threads, apply_ctas, 2);
  if (bad) return bad;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) ||
      ((reinterpret_cast<uintptr_t>(work)) & 15))
    return (int)cudaErrorInvalidValue;
  double* sums = static_cast<double*>(work);
  double* partials = sums + 2 * (size_t)B * C;
  Plan plan;
  const int unplanned = pair_stats_plan(x, x, partials, B, S, C, dtype, vec, cols, ctas, rows,
                                        threads, &plan);
  if (unplanned) return unplanned;
  ApplyShape p;
  p.B = B; p.S = S; p.C = C; p.G = G;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  float* gs = static_cast<float*>(stats);
  if (dtype == 0)
    return (int)launch<float>(x, w, b, y, gs, sums, partials, t, plan, threads, p, wdtype, silu,
                              apply_threads, apply_ctas, st);
  return (int)launch<__nv_bfloat16>(x, w, b, y, gs, sums, partials, t, plan, threads, p, wdtype,
                                    silu, apply_threads, apply_ctas, st);
}

// The backward of me_group_norm on the same x, w, b and the stats it wrote:
// dy, x [B, S, C] of dtype; dx: [B, S, C] of dtype or null; dw, db: [C] of
// wdtype or null. work: [2, B, C] doubles of S1, S2, then K10's partials of
// (dy, x); (vec, cols, ctas, rows, threads): K10's plan of [B, S, C] for two
// inputs (pair_stats_plan same=False); the apply plan as the forward's.
// Returns a cudaError_t code as me_group_norm.
extern "C" int me_group_norm_bwd(const void* dy, const void* x, const void* w, const void* b,
                                 const void* stats, void* dx, void* dw, void* db, void* work,
                                 void* tickets, int B, int S, int C, int G, int silu, int dtype,
                                 int wdtype, int vec, int cols, int ctas, int rows, int threads,
                                 int apply_threads, int apply_ctas, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const int bad = check_shape(vec, itemsize, C, G, wdtype, apply_threads, apply_ctas, 4);
  if (bad) return bad;
  if (((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(x) |
        reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(work)) & 15) ||
      dy == x || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  double* sums = static_cast<double*>(work);
  double* partials = sums + 2 * (size_t)B * C;
  Plan plan;
  const int unplanned = pair_stats_plan(dy, x, partials, B, S, C, dtype, vec, cols, ctas, rows,
                                        threads, &plan);
  if (unplanned) return unplanned;
  ApplyShape p;
  p.B = B; p.S = S; p.C = C; p.G = G;
  p.eps = 0.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  const float* gs = static_cast<const float*>(stats);
  if (dtype == 0)
    return (int)(wdtype == 0
                     ? bwd_launch<float, float>(dy, x, w, b, gs, dx, dw, db, sums, partials, t,
                                                plan, threads, p, silu, apply_threads,
                                                apply_ctas, st)
                     : bwd_launch<float, __nv_bfloat16>(dy, x, w, b, gs, dx, dw, db, sums,
                                                        partials, t, plan, threads, p, silu,
                                                        apply_threads, apply_ctas, st));
  return (int)(wdtype == 0
                   ? bwd_launch<__nv_bfloat16, float>(dy, x, w, b, gs, dx, dw, db, sums,
                                                      partials, t, plan, threads, p, silu,
                                                      apply_threads, apply_ctas, st)
                   : bwd_launch<__nv_bfloat16, __nv_bfloat16>(dy, x, w, b, gs, dx, dw, db, sums,
                                                              partials, t, plan, threads, p,
                                                              silu, apply_threads, apply_ctas,
                                                              st));
}
