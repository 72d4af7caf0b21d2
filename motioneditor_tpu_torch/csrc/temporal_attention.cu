// Temporal attention over the frame axis for the frame-sharded path (K14):
// the body K3 ran on until K3 moved to temporal_attention_tma.cu.
//
// Replaces (TPU / Pallas): motioneditor_tpu/ops/temporal_flash.py
// _temporal_4d_bias (_kernel_bias, pallas_call at temporal_flash.py:361):
// q holds Fq local frames of a frame shard, K/V all Fk gathered frames, and
// the causal mask holds at global frame indices: pair (f, g) is kept iff
// g <= f + q_off. The TPU kernel adds a -1e30 bias per pair; skipping the
// pair is exact. With Fq = Fk and q_off = 0 it computes K3's function.
//
// What it computes. Tokens [B, F, N, C] are N*H independent length-F
// sequences of d = C/H channels; each query frame attends over its kept
// key frames with an fp32 softmax for any input dtype.
//
// Design. One thread owns one (b, n, head) sequence and works in the native
// layout: for each query frame it accumulates the Fk scores in registers
// over 8-channel vector loads, normalises them, then streams V once per
// output chunk. No transpose, no head split, no [.., F, F] score tensor in
// device memory.
//
// What bounds it on the H100. Memory: the work is ~4*Fq*Fk*C flops per site
// against ~2*(Fq + Fk)*C elements of q, k, v, out, a few flops per byte.
// K and V rows are re-read once per query frame from L1/L2, neighbouring
// threads (the heads of one site) touch 2*d-byte-apart 16-byte chunks, and
// a thread per sequence leaves the card short of bytes in flight: the
// TMA-staged body (temporal_attention_tma.cu) answers all three and takes
// Fq, Fk and q_off for K14 to move onto.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;

// q, out: [B, Fq, N, C]; k, v: [B, Fk, N, C]; FMAX >= Fk.
template <typename T, int FMAX>
__global__ void __launch_bounds__(NTHREADS)
    temporal_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out, int B,
                              int Fq, int Fk, int N, int H, int d, float scale_log2,
                              int causal, int q_off) {
  const long long idx = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  const long long total = (long long)B * N * H;
  if (idx >= total) return;
  const int h = (int)(idx % H);
  const long long bn = idx / H;
  const int n = (int)(bn % N);
  const int b = (int)(bn / N);
  const int C = H * d;
  const size_t fstride = (size_t)N * C;
  const size_t qbase = ((size_t)b * Fq * N + n) * C + (size_t)h * d;
  const size_t base = ((size_t)b * Fk * N + n) * C + (size_t)h * d;

  for (int f = 0; f < Fq; ++f) {
    const int glim = causal ? min(f + q_off + 1, Fk) : Fk;
    float s[FMAX];
#pragma unroll
    for (int g = 0; g < FMAX; ++g) s[g] = 0.f;
    for (int c = 0; c < d; c += 8) {
      float qv[8];
      me::load8(q + qbase + f * fstride + c, qv);
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
      me::store8(out + qbase + f * fstride + c, o);
    }
  }
}

template <typename T, int FMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Fq,
                   int Fk, int N, int H, int d, float scale_log2, int causal, int q_off,
                   cudaStream_t st) {
  const long long total = (long long)B * N * H;
  const unsigned blocks = (unsigned)((total + NTHREADS - 1) / NTHREADS);
  temporal_attention_kernel<T, FMAX><<<blocks, NTHREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), B, Fq, Fk, N, H, d, scale_log2, causal, q_off);
  return cudaGetLastError();
}

// the FMAX buckets are over Fk, the frames each query attends over
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B, int Fq,
                     int Fk, int N, int H, int d, float sl, int causal, int q_off,
                     cudaStream_t st) {
  if (Fk <= 8) return launch<T, 8>(q, k, v, out, B, Fq, Fk, N, H, d, sl, causal, q_off, st);
  if (Fk <= 16) return launch<T, 16>(q, k, v, out, B, Fq, Fk, N, H, d, sl, causal, q_off, st);
  if (Fk <= 32) return launch<T, 32>(q, k, v, out, B, Fq, Fk, N, H, d, sl, causal, q_off, st);
  return cudaErrorInvalidValue;
}

int run(const void* q, const void* k, const void* v, void* out, int B, int Fq, int Fk, int N,
        int H, int d, float scale, int causal, int q_off, int dtype, void* stream) {
  if (d % 8 != 0 || Fq < 1 || Fk < 1 || Fk > 32 || q_off < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = scale * me::kLog2e;
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(q, k, v, out, B, Fq, Fk, N, H, d, sl, causal, q_off, st)
                 : dispatch<__nv_bfloat16>(q, k, v, out, B, Fq, Fk, N, H, d, sl, causal, q_off,
                                           st);
  return (int)err;
}

}  // namespace

// K14: q [B, Fq, N, C] holds global frames [q_off, q_off + Fq); k, v
// [B, Fk, N, C] hold all frames. Returns a cudaError_t code.
extern "C" int me_temporal_attention_global(const void* q, const void* k, const void* v,
                                            void* out, int B, int Fq, int Fk, int N, int H,
                                            int d, float scale, int causal, int q_off,
                                            int dtype, void* stream) {
  return run(q, k, v, out, B, Fq, Fk, N, H, d, scale, causal, q_off, dtype, stream);
}
