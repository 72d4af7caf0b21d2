// Temporal attention over the frame axis at every spatial site (K3).
//
// Replaces (TPU / Pallas): motioneditor_tpu/ops/temporal_flash.py _temporal_4d
// (_kernel, pallas_call at temporal_flash.py:208).
//
// What it computes. Tokens [B, F, N, C] are N*H independent length-F
// sequences of d = C/H channels; each query frame f attends over frames
// g <= f (causal) or all g, with an fp32 softmax for any input dtype. Causal
// pairs g > f are never computed, which equals the reference's additive
// -1e4 mask to within exp(-1e4) = 0.
//
// Design. One thread owns one (b, n, head) sequence and works in the native
// layout: for each query frame it accumulates the F scores in registers
// over 8-channel vector loads, normalises them, then streams V once per
// output chunk. No transpose, no head split, no [.., F, F] score tensor in
// device memory.
//
// What bounds it on the H100. Memory: the work is ~4*F*F*C flops per site
// against ~4*F*C elements of q, k, v, out; at F = 8 that is a few flops per
// byte, far under the card's compute/bandwidth ratio. K and V rows are
// re-read once per query frame; those re-reads hit L1/L2 (a site's F rows of
// one head are F*d*2 bytes).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;

template <typename T, int FMAX>
__global__ void __launch_bounds__(NTHREADS)
    temporal_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out, int B,
                              int F, int N, int H, int d, float scale_log2, int causal) {
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

  for (int f = 0; f < F; ++f) {
    const int glim = causal ? f + 1 : F;
    float s[FMAX];
#pragma unroll
    for (int g = 0; g < FMAX; ++g) s[g] = 0.f;
    for (int c = 0; c < d; c += 8) {
      float qv[8];
      me::load8(q + base + f * fstride + c, qv);
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < glim) {
          float kv[8];
          me::load8(k + base + g * fstride + c, kv);
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) dot = fmaf(qv[i], kv[i], dot);
          s[g] += dot;
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
    for (int g = 0; g < FMAX; ++g) {
      if (g < glim) {
        s[g] = exp2f(s[g] - m);
        l += s[g];
      }
    }
    const float inv = 1.f / l;
    for (int c = 0; c < d; c += 8) {
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < glim) {
          float vv[8];
          me::load8(v + base + g * fstride + c, vv);
          const float pg = s[g] * inv;
#pragma unroll
          for (int i = 0; i < 8; ++i) o[i] = fmaf(pg, vv[i], o[i]);
        }
      }
      me::store8(out + base + f * fstride + c, o);
    }
  }
}

template <typename T, int FMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int F,
                   int N, int H, int d, float scale_log2, int causal, cudaStream_t st) {
  const long long total = (long long)B * N * H;
  const unsigned blocks = (unsigned)((total + NTHREADS - 1) / NTHREADS);
  temporal_attention_kernel<T, FMAX><<<blocks, NTHREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), B, F, N, H, d, scale_log2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B, int F,
                     int N, int H, int d, float scale_log2, int causal, cudaStream_t st) {
  if (F <= 8) return launch<T, 8>(q, k, v, out, B, F, N, H, d, scale_log2, causal, st);
  if (F <= 16) return launch<T, 16>(q, k, v, out, B, F, N, H, d, scale_log2, causal, st);
  if (F <= 32) return launch<T, 32>(q, k, v, out, B, F, N, H, d, scale_log2, causal, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t code (0 = launched).
extern "C" int me_temporal_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int F, int N, int H, int d, float scale,
                                     int causal, int dtype, void* stream) {
  if (d % 8 != 0 || F < 1 || F > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = scale * me::kLog2e;
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(q, k, v, out, B, F, N, H, d, sl, causal, st)
                 : dispatch<__nv_bfloat16>(q, k, v, out, B, F, N, H, d, sl, causal, st);
  return (int)err;
}
