// K10's kernel, the per-channel pair statistics (sum a, sum a*b) over the
// middle axis of [B, S, C], and its plan check and launch: shared by
// csrc/norm_stats.cu (me_pair_stats, sums rounded to fp32) and
// csrc/group_norm.cu (me_group_norm's statistics, sums kept in fp64, and
// me_group_norm_bwd's, where a is first mapped elementwise: an Op). The
// design is norm_stats.cu's notes.
#pragma once

#include <stdint.h>

#include <cuda/atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_RUNS = 2 * MAX_THREADS;  // runs of 8 lanes a sum: cols * vec * ceil(lanes / 8)

struct Plan {
  int B, S, C;
  int cols, lanes, slices;  // column groups per slice, row lanes, slices
  int ctas, rows;           // blocks along S per (batch row, slice), rows per block
  int chs;                  // channels per slice, cols * vec
};

// The map of a before it is summed, (sum f(a, b), sum f(a, b) * b): a
// itself here. An Op's Lane<VEC> holds what a thread needs for its VEC
// channels c0.. of batch row bi; init runs once before the rows. Any other
// Op reads two inputs (a != b).
struct SumA {
  template <int VEC>
  struct Lane {
    __device__ __forceinline__ void init(const SumA&, int, int) {}
    __device__ __forceinline__ float operator()(int, float a, float) const { return a; }
  };
};

// 16-byte and 1-element loads, converted to fp32
template <typename T, int VEC>
struct Loader;

template <>
struct Loader<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void to_float(const Raw& r, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Loader<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void to_float(const Raw& r, float* o) {
    o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
  }
};

template <typename T>
struct Loader<T, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const T* p) { return me::load1(p); }
  static __device__ __forceinline__ void to_float(const Raw& r, float* o) { o[0] = r; }
};

// True in every thread of the block that draws the last of n tickets of
// *counter; that block resets the counter. One thread takes the ticket
// with an acquire-release add at device scope after the block's barrier:
// the barrier orders every thread's earlier global writes before the
// release, and the acquire with the barrier after it orders the other
// blocks' writes before what the last block reads next. (A sequentially
// consistent __threadfence in every thread was measurably slower.)
__device__ __forceinline__ bool last_ticket(unsigned int* counter, unsigned int n) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(*counter);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == n - 1;
    if (last) ticket.store(0u, cuda::memory_order_relaxed);
  }
  __syncthreads();
  return last;
}

// V consecutive doubles of a partial through L2 (the partials were written
// by other blocks), or zeros for a null p
template <int V>
__device__ __forceinline__ void load_partial(const double* p, double* o) {
  if constexpr (V == 2) {
    const double2 d = p ? __ldcg(reinterpret_cast<const double2*>(p)) : make_double2(0, 0);
    o[0] = d.x; o[1] = d.y;
  } else {
    o[0] = p ? __ldcg(p) : 0.0;
  }
}

// V sums, values i.. of a partial, to out [2, B, C] for batch row bi,
// slice sl, rounded to O
template <int V, typename O>
__device__ __forceinline__ void put_sums(const double* t, int i, O* out, const Plan& p, int bi,
                                         int sl) {
  // value i + j of a partial: sum (i + j) / chs of channel col * VEC + v of
  // the slice, k = v * cols + col
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int which = (i + j) / p.chs, k = (i + j) % p.chs;
    const int c = sl * p.chs + (k % p.cols) * (p.chs / p.cols) + k / p.cols;
    if (c < p.C) out[((size_t)which * p.B + bi) * p.C + c] = (O)t[j];
  }
}

// Adds n partials of width = 2 * chs doubles, `src` the first, into out.
// The block
// splits the partials into J = max(1, threads / (width / V)) chunks of
// m = ceil(n / J) consecutive partials; thread (chunk j, column q) owns V
// consecutive values and adds its chunk's partials in index order from 0,
// issuing the loads of 8 before it adds them (V = 2 on the 16-byte body:
// double2 loads); with J > 1 the chunk sums meet in shared memory (`red`,
// J * width doubles) and are added in chunk order. The order is fixed by
// (n, width, threads), as ops/gn_stats.py PairStatsPlan.combine_chunks
// states it.
template <int V, typename O>
__device__ __forceinline__ void sum_partials(const double* src, int n, O* out, double* red,
                                             const Plan& p, int bi, int sl) {
  const int width = 2 * p.chs;  // a multiple of V
  const int Q = width / V;
  const int J = max(1, (int)blockDim.x / Q);
  const int m = (n + J - 1) / J;
  for (int t = threadIdx.x; t < J * Q; t += blockDim.x) {
    const int q = t % Q, j = t / Q;
    const int k0 = j * m, k1 = min(n, k0 + m);
    double acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0;
    for (int k = k0; k < k1; k += 8) {
      double x[8][V];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        load_partial<V>(k + u < k1 ? src + (size_t)(k + u) * width + q * V : nullptr, x[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (k + u < k1) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += x[u][v];
        }
      }
    }
    if (J == 1) {
      put_sums<V>(acc, q * V, out, p, bi, sl);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) red[j * width + q * V + v] = acc[v];
    }
  }
  if (J == 1) return;
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    double acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0;
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += red[j * width + q * V + v];
    }
    put_sums<V>(acc, q * V, out, p, bi, sl);
  }
}

// hi + lo += t, exactly up to lo's own rounding: Knuth's TwoSum puts the
// rounding error of hi + t into lo
__device__ __forceinline__ void two_sum(float& hi, float& lo, float t) {
  const float s = hi + t;
  const float bb = s - hi;
  lo += (hi - (s - bb)) + (t - bb);
  hi = s;
}

// Loads rows r, r + lanes, ..., r + (U - 1) * lanes below r1 of a (and of b
// unless SAME)
template <typename L, typename T, int U, bool SAME>
__device__ __forceinline__ void load_rows(typename L::Raw* ra, typename L::Raw* rb,
                                          const T* pa, const T* pb, int r, int r1, int lanes,
                                          int C) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int rr = r + u * lanes;
    if (rr < r1) {
      ra[u] = L::load(pa + (size_t)rr * C);
      if (!SAME) rb[u] = L::load(pb + (size_t)rr * C);
    }
  }
}

template <typename T, int VEC, bool SAME, typename O, typename Op = SumA>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    pair_stats_kernel(const T* __restrict__ a, const T* __restrict__ b, O* __restrict__ out,
                      double* __restrict__ work, unsigned int* __restrict__ tickets, Plan p,
                      Op op) {
  using L = Loader<T, VEC>;
  using Raw = typename L::Raw;
  constexpr bool MAPPED = !std::is_same<Op, SumA>::value;
  static_assert(!(SAME && MAPPED), "a mapped a reads a second input");
  // a map's per-channel registers leave room for 2 rows of each input in flight
  constexpr int U = SAME ? 8 : (MAPPED ? 2 : 4);
  constexpr int V = VEC > 1 ? 2 : 1;  // doubles a load in the combine
  // one sum at a time: the threads' (hi, lo) pairs [v][thread], each row
  // padded by 64 bytes so that a half-warp's loads of 2 rows hit distinct
  // banks, then the sums of runs of 8 lanes [run][value]
  __shared__ float2 pairs[VEC][MAX_THREADS + 8];
  __shared__ double runs[MAX_RUNS];
  const int cta = blockIdx.x, sl = blockIdx.y, bi = blockIdx.z;
  const int col = threadIdx.x % p.cols, lane = threadIdx.x / p.cols;
  const int c0 = (sl * p.cols + col) * VEC;  // C % VEC == 0: the whole vector is in range
  const int r0 = cta * p.rows, r1 = min(p.S, r0 + p.rows);
  // each sum as an unevaluated pair hi + lo of fp32 (about 48 bits)
  float h1[VEC], l1[VEC], h2[VEC], l2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) h1[v] = l1[v] = h2[v] = l2[v] = 0.f;
  if (c0 < p.C) {
    typename Op::template Lane<VEC> f;
    f.init(op, bi, c0);
    const size_t base = (size_t)bi * p.S * p.C + c0;
    const T* pa = a + base;
    const T* pb = b + base;
    const int step = U * p.lanes;
    // the next U rows are in flight while the current U are added
    Raw ca[U], cb[U], na[U], nb[U];
    load_rows<L, T, U, SAME>(ca, cb, pa, pb, r0 + lane, r1, p.lanes, p.C);
    for (int r = r0 + lane; r < r1; r += step) {
      load_rows<L, T, U, SAME>(na, nb, pa, pb, r + step, r1, p.lanes, p.C);
      float t1[VEC], t2[VEC];  // the batch's rows in fp32, then into the pairs
#pragma unroll
      for (int v = 0; v < VEC; ++v) t1[v] = t2[v] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * p.lanes < r1) {
          float x[VEC], y[VEC];
          L::to_float(ca[u], x);
          if (!SAME) L::to_float(cb[u], y);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float g = SAME ? x[v] : f(v, x[v], y[v]);
            t1[v] += g;
            t2[v] = fmaf(g, SAME ? x[v] : y[v], t2[v]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        two_sum(h1[v], l1[v], t1[v]);
        two_sum(h2[v], l2[v], t2[v]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ca[u] = na[u];
        if (!SAME) cb[u] = nb[u];
      }
    }
  }
  // this block's partial, [sum][v][col] (channel col * VEC + v of the
  // slice), one sum at a time: each run of 8 lanes added in lane order in
  // the compensated pair and rounded to fp64, then the runs in order in fp64
  const int width = 2 * p.chs;
  const size_t row_slice = (size_t)bi * p.slices + sl;
  double* partials = work + row_slice * p.ctas * width;
  const int nruns = (p.lanes + 7) / 8;
  for (int which = 0; which < 2; ++which) {
    if (which) __syncthreads();  // the first sum's runs are read
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      pairs[v][threadIdx.x] = which ? make_float2(h2[v], l2[v]) : make_float2(h1[v], l1[v]);
    __syncthreads();
    for (int u = threadIdx.x; u < p.chs * nruns; u += blockDim.x) {
      const int k = u % p.chs, l0 = (u / p.chs) * 8;  // value k = v * cols + col
      const float2* src = &pairs[k / p.cols][k % p.cols];
      float hi = 0.f, lo = 0.f;
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        if (l0 + l < p.lanes) {
          const float2 q = src[(l0 + l) * p.cols];
          two_sum(hi, lo, q.x);
          lo += q.y;
        }
      }
      runs[u] = (double)hi + (double)lo;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < p.chs; k += blockDim.x) {
      double t = 0.0;
      for (int r = 0; r < nruns; ++r) t += runs[r * p.chs + k];
      const int i = which * p.chs + k;
      if (p.ctas == 1)  // the block's partial is the sum: no combine
        put_sums<1>(&t, i, out, p, bi, sl);
      else
        partials[(size_t)cta * width + i] = t;
    }
  }
  if (p.ctas == 1) return;
  // the last block of the (batch row, slice) to arrive adds the partials
  if (!last_ticket(tickets + row_slice, p.ctas)) return;
  double* red = reinterpret_cast<double*>(&pairs[0][0]);  // the lanes are added by now
  sum_partials<V>(partials, p.ctas, out, red, p, bi, sl);
}

// The Plan of a launch of [B, S, C] (dtype 0 float32, 1 bfloat16) from
// ops/gn_stats.py pair_stats_plan's (vec, cols, ctas, rows, threads), or
// cudaErrorInvalidValue for a plan that does not fit the shape or a
// misaligned operand of the 16-byte body (vec = 16 / itemsize needs a, b
// and work on 16-byte boundaries)
inline int pair_stats_plan(const void* a, const void* b, const void* work, int B, int S, int C,
                           int dtype, int vec, int cols, int ctas, int rows, int threads,
                           Plan* p) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B < 1 || B > 65535 || S < 1 || C < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((vec != 1 && vec * itemsize != 16) || C % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(work)) & 15))
    return (int)cudaErrorInvalidValue;
  if (cols < 1 || threads < cols || threads > MAX_THREADS || threads % cols != 0 || rows < 1 ||
      ctas != (S + rows - 1) / rows)
    return (int)cudaErrorInvalidValue;
  p->B = B; p->S = S; p->C = C;
  p->cols = cols;
  p->lanes = threads / cols;
  p->slices = (C / vec + cols - 1) / cols;
  p->ctas = ctas;
  p->rows = rows;
  p->chs = cols * vec;
  if (p->slices > 65535 || p->chs * ((p->lanes + 7) / 8) > MAX_RUNS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One launch on stream st: the sums of a (and a * b) rounded to O into out;
// with an Op, the sums of op(a, b) (and op(a, b) * b), a != b
template <typename T, int VEC, typename O, typename Op = SumA>
cudaError_t pair_stats_launch(const void* a, const void* b, O* out, double* work,
                              unsigned int* tickets, const Plan& p, int threads, cudaStream_t st,
                              Op op = Op()) {
  const dim3 grid(p.ctas, p.slices, p.B);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if constexpr (std::is_same<Op, SumA>::value) {
    if (a == b) {
      pair_stats_kernel<T, VEC, true, O>
          <<<grid, threads, 0, st>>>(ta, tb, out, work, tickets, p, SumA());
      return cudaGetLastError();
    }
  } else if (a == b) {
    return cudaErrorInvalidValue;
  }
  pair_stats_kernel<T, VEC, false, O, Op><<<grid, threads, 0, st>>>(ta, tb, out, work, tickets, p,
                                                                   op);
  return cudaGetLastError();
}

}  // namespace
