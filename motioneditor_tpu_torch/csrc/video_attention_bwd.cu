// Backward of the packed-head video attention (K1) for the frame-selection
// modes normal / sparse_causal / motion_frame: dQ (K5) and per-(target
// frame, source slot) dK/dV partials (K6).
//
// Replaces (TPU / Pallas):
//   K5  motioneditor_tpu/ops/video_flash_bwd.py  _dq_kernel   (pallas_call at :403)
//   K6  motioneditor_tpu/ops/video_flash_bwd.py  _dkv_kernel  (pallas_call at :437)
//
// What it computes, per head h (the standard flash backward):
//   P  = exp(scale * Q K^T - lse)     (lse saved by the forward, K4)
//   D  = rowsum(dO o O)
//   dS = P o (dO V^T - D)
//   dQ = scale * dS K      dK = scale * dS^T Q      dV = P^T dO
// over the same source frames as the forward (me::pass_frame: frame 0 reads
// frame 0 twice). The softmax is the forward's exact one: no CAP = 60
// clamp indicator, so these are the gradients of K1's own forward; they
// equal the JAX bf16 kernel's whenever every |logit| < 60.
//
// Design. Heads are a channel stride, as in K1. K5: a block owns (64
// queries, one head, one (b, f)), computes D for its rows (and writes it for
// K6), then streams the source frames' 32-key tiles, recomputes P and
// accumulates dQ in registers. K6: a block owns (64 keys, one head, one
// (b, target frame f), one source slot), streams frame f's 32-query tiles
// and accumulates dK and dV in registers; it writes fp32 partials
// [B, F, S, N, C] that combine_partials (ops/video_flash_bwd.py) scatters onto
// the source frames. Partials instead of atomicAdd keep the result
// deterministic. All products are fp32 FMAs on CUDA cores with 4x4 register
// patches, as in K1.
//
// What bounds it on the H100: like the forward, the FMA loops and their
// shared-memory reads (the backward does ~2.5x the forward's flops); wgmma
// tiles and TMA loads are the planned next step.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int TQ = 64;   // K5: queries per block
constexpr int TK = 32;   // K5: keys per tile
constexpr int TKV = 64;  // K6: keys per block
constexpr int TQ6 = 32;  // K6: queries per tile
constexpr int SST = 33;  // stride of the 32-wide score tiles

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;   // [B, F, N, H], natural log
  float* delta;       // [B, F, N, H] D = rowsum(dO o O): K5 writes, K6 reads
  void* dq;           // q's dtype
  float* dk_part;     // [B, F, S, N, C] fp32
  float* dv_part;
  int B, F, N, H, d, S;
  float scale;
  float scale_log2;
  int mode;
};

// Loads rows [n0, n0 + rows) of one head of a [.., N, C] frame slab into
// shared memory as fp32 with stride st; rows past N and the padded columns
// d..DP are zero.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int st, const T* src, int rows, int n0,
                                          int N, int C, int hd, int d) {
  constexpr int DC = DP / 8;
  const int dc = d / 8;
  for (int idx = threadIdx.x; idx < rows * DC; idx += NTHREADS) {
    const int r = idx / DC, c8 = idx - (idx / DC) * DC;
    const int n = n0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (c8 < dc && n < N) me::load8(src + (size_t)n * C + hd + c8 * 8, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * st + c8 * 8 + i] = x[i];
  }
}

template <int DP>
struct DqSmem {
  static constexpr int ST = DP + 1;  // +1 pads rows off the same bank
  static constexpr int floats = 2 * TQ * ST + 2 * TK * ST + TQ * SST + 2 * TQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(BwdParams p) {
  using S = DqSmem<DP>;
  constexpr int DPT = DP / 8;  // dQ accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TQ * S::ST;
  float* Ks = dOs + TQ * S::ST;
  float* Vs = Ks + TK * S::ST;
  float* Ss = Vs + TK * S::ST;     // dS of the current tile
  float* row_lse = Ss + TQ * SST;  // log2 units
  float* row_D = row_lse + TQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int bf = blockIdx.z;
  const int b = bf / p.F;
  const int f = bf - b * p.F;
  const int d = p.d;
  const int C = p.H * d;
  const int hd = h * d;
  const size_t qbase = (size_t)bf * p.N * C;

  load_tile<T, DP>(Qs, S::ST, static_cast<const T*>(p.q) + qbase, TQ, q0, p.N, C, hd, d);
  load_tile<T, DP>(dOs, S::ST, static_cast<const T*>(p.dout) + qbase, TQ, q0, p.N, C, hd, d);
  __syncthreads();

  // D = rowsum(dO o O) over the head's d columns: two threads per row
  {
    const int r = tid >> 1, half = tid & 1;
    const int n = q0 + r;
    float acc = 0.f;
    if (n < p.N) {
      const T* orow = static_cast<const T*>(p.out) + qbase + (size_t)n * C + hd;
      for (int c8 = half; c8 < d / 8; c8 += 2) {
        float o[8];
        me::load8(orow + c8 * 8, o);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(o[i], dOs[r * S::ST + c8 * 8 + i], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const size_t li = ((size_t)bf * p.N + n) * p.H + h;
      row_D[r] = acc;
      row_lse[r] = n < p.N ? p.lse[li] * me::kLog2e : 0.f;
      if (n < p.N) p.delta[li] = acc;
    }
  }

  const int ty = tid / 8;  // query rows 4*ty .. 4*ty+3
  const int tx = tid % 8;  // keys 4*tx .. 4*tx+3; dQ columns tx + 8*j
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  const int npass = me::num_passes(p.mode, p.F);
  for (int pass = 0; pass < npass; ++pass) {
    const int fs = me::pass_frame(p.mode, pass, f);
    const size_t kvbase = (size_t)(b * p.F + fs) * p.N * C;
    for (int k0 = 0; k0 < p.N; k0 += TK) {
      __syncthreads();  // the previous tile's readers of Ks/Vs/Ss are done
      load_tile<T, DP>(Ks, S::ST, static_cast<const T*>(p.k) + kvbase, TK, k0, p.N, C, hd, d);
      load_tile<T, DP>(Vs, S::ST, static_cast<const T*>(p.v) + kvbase, TK, k0, p.N, C, hd, d);
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DP; ++c) {
        float qa[4], ga[4], kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = Qs[(ty * 4 + i) * S::ST + c];
          ga[i] = dOs[(ty * 4 + i) * S::ST + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kk[j] = Ks[(tx * 4 + j) * S::ST + c];
          vv[j] = Vs[(tx * 4 + j) * S::ST + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
            dp[i][j] = fmaf(ga[i], vv[j], dp[i][j]);
          }
      }
      const int nvalid = min(TK, p.N - k0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = tx * 4 + j;
          const float pr = kj < nvalid ? exp2f(s[i][j] * p.scale_log2 - row_lse[r]) : 0.f;
          Ss[r * SST + kj] = pr * (dp[i][j] - row_D[r]);
        }
      }
      __syncthreads();

      // dQ += dS . K
      for (int j = 0; j < TK; ++j) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = Ss[(ty * 4 + i) * SST + j];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const float kv = Ks[j * S::ST + tx + 8 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
        }
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n < p.N) {
      T* row = dqg + qbase + (size_t)n * C + hd;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 8 * c;
        if (col < d) me::store1(row + col, acc[i][c] * p.scale);
      }
    }
  }
}

template <int DP>
struct DkvSmem {
  static constexpr int ST = DP + 1;
  static constexpr int floats = 2 * TKV * ST + 2 * TQ6 * ST + 2 * TKV * SST + 2 * TQ6;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(BwdParams p) {
  using S = DkvSmem<DP>;
  constexpr int DPT = DP / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TKV * S::ST;
  float* Qs = Vs + TKV * S::ST;
  float* dOs = Qs + TQ6 * S::ST;
  float* Ps = dOs + TQ6 * S::ST;    // P^T of the current tile: [key][query]
  float* Ds = Ps + TKV * SST;       // dS^T
  float* row_lse = Ds + TKV * SST;  // per query, log2 units
  float* row_D = row_lse + TQ6;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * TKV;
  const int h = blockIdx.y;
  const int z = blockIdx.z;  // ((b * F) + f) * S + slot
  const int slot = z % p.S;
  const int bf = z / p.S;
  const int b = bf / p.F;
  const int f = bf - b * p.F;
  const int fs = me::pass_frame(p.mode, slot, f);
  const int d = p.d;
  const int C = p.H * d;
  const int hd = h * d;
  const size_t qbase = (size_t)bf * p.N * C;
  const size_t kvbase = (size_t)(b * p.F + fs) * p.N * C;

  load_tile<T, DP>(Ks, S::ST, static_cast<const T*>(p.k) + kvbase, TKV, k0, p.N, C, hd, d);
  load_tile<T, DP>(Vs, S::ST, static_cast<const T*>(p.v) + kvbase, TKV, k0, p.N, C, hd, d);

  const int ty = tid / 8;  // keys 4*ty .. 4*ty+3
  const int tx = tid % 8;  // queries 4*tx .. 4*tx+3; dK/dV columns tx + 8*j
  float dk[4][DPT], dv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < p.N; q0 += TQ6) {
    __syncthreads();  // the previous tile's readers of Qs/dOs/Ps/Ds are done
    load_tile<T, DP>(Qs, S::ST, static_cast<const T*>(p.q) + qbase, TQ6, q0, p.N, C, hd, d);
    load_tile<T, DP>(dOs, S::ST, static_cast<const T*>(p.dout) + qbase, TQ6, q0, p.N, C, hd,
                     d);
    if (tid < TQ6) {
      const int n = q0 + tid;
      const size_t li = ((size_t)bf * p.N + n) * p.H + h;
      // a query row past N gets P = exp2(s - inf) = 0
      row_lse[tid] = n < p.N ? p.lse[li] * me::kLog2e : INFINITY;
      row_D[tid] = n < p.N ? p.delta[li] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float kk[4], vv[4], qa[4], ga[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = Ks[(ty * 4 + i) * S::ST + c];
        vv[i] = Vs[(ty * 4 + i) * S::ST + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qa[j] = Qs[(tx * 4 + j) * S::ST + c];
        ga[j] = dOs[(tx * 4 + j) * S::ST + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kk[i], qa[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ga[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tx * 4 + j;
        const float pr = exp2f(s[i][j] * p.scale_log2 - row_lse[qj]);
        Ps[r * SST + qj] = pr;
        Ds[r * SST + qj] = pr * (dp[i][j] - row_D[qj]);
      }
    }
    __syncthreads();

    // dV += P^T dO,  dK += dS^T Q
    for (int j = 0; j < TQ6; ++j) {
      float pr[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = Ps[(ty * 4 + i) * SST + j];
        ds[i] = Ds[(ty * 4 + i) * SST + j];
      }
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const float g = dOs[j * S::ST + tx + 8 * c];
        const float qv = Qs[j * S::ST + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pr[i], g, dv[i][c]);
          dk[i][c] = fmaf(ds[i], qv, dk[i][c]);
        }
      }
    }
  }

  const size_t pbase = (size_t)z * p.N * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = k0 + ty * 4 + i;
    if (n < p.N) {
      float* dkr = p.dk_part + pbase + (size_t)n * C + hd;
      float* dvr = p.dv_part + pbase + (size_t)n * C + hd;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 8 * c;
        if (col < d) {
          dkr[col] = dk[i][c] * p.scale;
          dvr[col] = dv[i][c];
        }
      }
    }
  }
}

template <typename Smem, typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, Smem::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t run(const BwdParams& p, bool dkv, cudaStream_t st) {
  if (!dkv) {
    const dim3 grid((p.N + TQ - 1) / TQ, p.H, p.B * p.F);
    return launch<DqSmem<DP>>(dq_kernel<T, DP>, grid, p, st);
  }
  const dim3 grid((p.N + TKV - 1) / TKV, p.H, p.B * p.F * p.S);
  return launch<DkvSmem<DP>>(dkv_kernel<T, DP>, grid, p, st);
}

template <typename T>
cudaError_t dispatch(const BwdParams& p, bool dkv, cudaStream_t st) {
  if (p.d <= 16) return run<T, 16>(p, dkv, st);
  if (p.d <= 32) return run<T, 32>(p, dkv, st);
  if (p.d <= 48) return run<T, 48>(p, dkv, st);
  if (p.d <= 64) return run<T, 64>(p, dkv, st);
  if (p.d <= 80) return run<T, 80>(p, dkv, st);
  if (p.d <= 96) return run<T, 96>(p, dkv, st);
  if (p.d <= 128) return run<T, 128>(p, dkv, st);
  if (p.d <= 160) return run<T, 160>(p, dkv, st);
  return cudaErrorInvalidValue;
}

int launch_bwd(BwdParams p, float scale, int dtype, bool dkv, void* stream) {
  if (p.d % 8 != 0 || p.d > 160 || p.mode < 0 || p.mode > 2) return (int)cudaErrorInvalidValue;
  p.S = me::num_passes(p.mode, p.F);
  p.scale = scale;
  p.scale_log2 = scale * me::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(p, dkv, st) : dispatch<__nv_bfloat16>(p, dkv, st);
  return (int)err;
}

}  // namespace

// K5. mode: 0 normal, 1 sparse_causal, 2 motion_frame. dtype: 0 float32,
// 1 bfloat16 (q, k, v, out, dout, dq). Writes dq and delta [B, F, N, H].
// Returns a cudaError_t code (0 = launched).
extern "C" int me_video_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const float* lse,
                                         float* delta, void* dq, int B, int F, int N, int H,
                                         int d, float scale, int mode, int dtype,
                                         void* stream) {
  BwdParams p{q, k, v, out, dout, lse, delta, dq, nullptr, nullptr, B, F, N, H, d, 1,
              0.f, 0.f, mode};
  return launch_bwd(p, scale, dtype, false, stream);
}

// K6. Reads delta from K5; writes fp32 partials [B, F, S, N, C] with S = 1
// (normal) or 2 (sparse_causal, motion_frame).
extern "C" int me_video_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, float* dk_part, float* dv_part,
                                          int B, int F, int N, int H, int d, float scale,
                                          int mode, int dtype, void* stream) {
  BwdParams p{q, k, v, nullptr, dout, lse, const_cast<float*>(delta), nullptr, dk_part,
              dv_part, B, F, N, H, d, 1, 0.f, 0.f, mode};
  return launch_bwd(p, scale, dtype, true, stream);
}
