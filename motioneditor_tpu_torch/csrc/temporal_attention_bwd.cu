// Backward of the temporal attention over the frame axis (K7).
//
// Replaces (TPU / Pallas): motioneditor_tpu/ops/temporal_flash.py
// _temporal_4d_bwd (_bwd_kernel, pallas_call at temporal_flash.py:190).
//
// What it computes. Tokens [B, F, N, C] are N*H independent length-F
// sequences of d = C/H channels (as in K3). For each sequence, from q, k, v
// and the output gradient dO, with P the fp32 causal (or full) softmax of
// scale * q k^T:
//   D_f  = sum_g P[f,g] dP[f,g],    dP[f,g] = dO_f . v_g
//   dS   = P o (dP - D)
//   dq_f = scale sum_g dS[f,g] k_g     dk_g = scale sum_f dS[f,g] q_f
//   dv_g = sum_f P[f,g] dO_f
// Like the JAX kernel it saves no residuals: the scores and the softmax are
// recomputed, and causal pairs g > f are never formed.
//
// Design. One thread owns one (b, n, head) sequence, all F frames of it, in
// the native layout (no transpose, no head split, no [.., F, F] tensor in
// device memory). Pass 1 walks the query frames: scores and dP in
// registers, the row's log-sum-exp and D kept per frame, dq_f written.
// Pass 2 walks the key frames: P and dS of the column recomputed from the
// saved row statistics, then dk_g and dv_g written. A block is 128
// neighbouring (site, head) sequences.
//
// What bounds it on the H100: memory, as for K3 (a few flops per byte at
// F = 8); q, k, v, dO rows are re-read once per frame pair and hit L1/L2.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;

template <typename T, int FMAX>
__global__ void __launch_bounds__(NTHREADS)
    temporal_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int B,
                        int F, int N, int H, int d, float scale, float scale_log2,
                        int causal) {
  const long long idx = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  const long long total = (long long)B * N * H;
  if (idx >= total) return;
  const int h = (int)(idx % H);
  const long long bn = idx / H;
  const int n = (int)(bn % N);
  const int b = (int)(bn / N);
  const int C = H * d;
  const size_t fstride = (size_t)N * C;
  const size_t base = ((size_t)b * F * N + n) * C + (size_t)h * d;

  float row_lse[FMAX];  // per query frame, log2 units
  float row_D[FMAX];

  // pass 1: query frames
  for (int f = 0; f < F; ++f) {
    const int glim = causal ? f + 1 : F;
    float s[FMAX], dp[FMAX];
#pragma unroll
    for (int g = 0; g < FMAX; ++g) s[g] = dp[g] = 0.f;
    for (int c = 0; c < d; c += 8) {
      float qv[8], gv[8];
      me::load8(q + base + f * fstride + c, qv);
      me::load8(dout + base + f * fstride + c, gv);
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < glim) {
          float kv[8], vv[8];
          me::load8(k + base + g * fstride + c, kv);
          me::load8(v + base + g * fstride + c, vv);
          float sd = 0.f, pd = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            sd = fmaf(qv[i], kv[i], sd);
            pd = fmaf(gv[i], vv[i], pd);
          }
          s[g] += sd;
          dp[g] += pd;
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int g = 0; g < FMAX; ++g) {
      if (g < glim) {
        s[g] *= scale_log2;
        m = fmaxf(m, s[g]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int g = 0; g < FMAX; ++g)
      if (g < glim) l += exp2f(s[g] - m);
    const float lse = m + log2f(l);
    float D = 0.f;
#pragma unroll
    for (int g = 0; g < FMAX; ++g) {
      if (g < glim) {
        s[g] = exp2f(s[g] - lse);  // P[f, g]
        D = fmaf(s[g], dp[g], D);
      }
    }
    row_lse[f] = lse;
    row_D[f] = D;
#pragma unroll
    for (int g = 0; g < FMAX; ++g)
      if (g < glim) s[g] = s[g] * (dp[g] - D) * scale;  // scale * dS[f, g]
    for (int c = 0; c < d; c += 8) {
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < glim) {
          float kv[8];
          me::load8(k + base + g * fstride + c, kv);
#pragma unroll
          for (int i = 0; i < 8; ++i) o[i] = fmaf(s[g], kv[i], o[i]);
        }
      }
      me::store8(dq + base + f * fstride + c, o);
    }
  }

  // pass 2: key frames
  for (int g = 0; g < F; ++g) {
    const int flo = causal ? g : 0;
    float pc[FMAX], dsc[FMAX];
#pragma unroll
    for (int f = 0; f < FMAX; ++f) pc[f] = dsc[f] = 0.f;
    for (int c = 0; c < d; c += 8) {
      float kv[8], vv[8];
      me::load8(k + base + g * fstride + c, kv);
      me::load8(v + base + g * fstride + c, vv);
#pragma unroll
      for (int f = 0; f < FMAX; ++f) {
        if (f >= flo && f < F) {
          float qv[8], gv[8];
          me::load8(q + base + f * fstride + c, qv);
          me::load8(dout + base + f * fstride + c, gv);
          float sd = 0.f, pd = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            sd = fmaf(qv[i], kv[i], sd);
            pd = fmaf(gv[i], vv[i], pd);
          }
          pc[f] += sd;
          dsc[f] += pd;
        }
      }
    }
#pragma unroll
    for (int f = 0; f < FMAX; ++f) {
      if (f >= flo && f < F) {
        const float pr = exp2f(pc[f] * scale_log2 - row_lse[f]);
        dsc[f] = pr * (dsc[f] - row_D[f]) * scale;  // scale * dS[f, g]
        pc[f] = pr;                                  // P[f, g]
      }
    }
    for (int c = 0; c < d; c += 8) {
      float ak[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float av[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int f = 0; f < FMAX; ++f) {
        if (f >= flo && f < F) {
          float qv[8], gv[8];
          me::load8(q + base + f * fstride + c, qv);
          me::load8(dout + base + f * fstride + c, gv);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            ak[i] = fmaf(dsc[f], qv[i], ak[i]);
            av[i] = fmaf(pc[f], gv[i], av[i]);
          }
        }
      }
      me::store8(dk + base + g * fstride + c, ak);
      me::store8(dv + base + g * fstride + c, av);
    }
  }
}

template <typename T, int FMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, int B, int F, int N, int H, int d, float scale,
                   int causal, cudaStream_t st) {
  const long long total = (long long)B * N * H;
  const unsigned blocks = (unsigned)((total + NTHREADS - 1) / NTHREADS);
  temporal_bwd_kernel<T, FMAX><<<blocks, NTHREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), B, F, N, H, d, scale, scale * me::kLog2e, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, int B, int F, int N, int H, int d, float scale,
                     int causal, cudaStream_t st) {
  if (F <= 8) return launch<T, 8>(q, k, v, dout, dq, dk, dv, B, F, N, H, d, scale, causal, st);
  if (F <= 16) return launch<T, 16>(q, k, v, dout, dq, dk, dv, B, F, N, H, d, scale, causal, st);
  if (F <= 32) return launch<T, 32>(q, k, v, dout, dq, dk, dv, B, F, N, H, d, scale, causal, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (all seven operands). Returns a cudaError_t
// code (0 = launched).
extern "C" int me_temporal_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         int B, int F, int N, int H, int d, float scale,
                                         int causal, int dtype, void* stream) {
  if (d % 8 != 0 || F < 1 || F > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(q, k, v, dout, dq, dk, dv, B, F, N, H, d, scale, causal, st)
                 : dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, B, F, N, H, d, scale,
                                           causal, st);
  return (int)err;
}
