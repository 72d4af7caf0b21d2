// Fused residual add + LayerNorm over the channel axis (K11):
//   summed = tokens + delta;  normed = LN(summed) * w + b.
//
// Replaces (TPU / Pallas): motioneditor_tpu/ops/fused_norm.py _add_ln
// (_kernel, pallas_call at fused_norm.py:73).
//
// What it computes. For each token row of C channels: the sum t + d in fp32,
// written back in the input dtype; its fp32 mean and variance; and the
// normalized fp32 sum times the fp32 weight plus the fp32 bias, written in
// the input dtype. As the TPU kernel does, the statistics and the
// normalization read the fp32 sum, not its rounding to the input dtype.
// The variance is taken in two passes over the row held in registers
// (mean first, then the mean of squared deviations), which is at least as
// accurate as the TPU kernel's one-pass E[x^2] - E[x]^2.
//
// Design. One warp per row: each lane holds every 32nd channel of the row
// in registers (C <= 32 * PER, PER in {10, 20, 40}, so C <= 1280), the warp
// reduces with shuffles, and the loads and stores of the warp are
// contiguous. A block of 8 warps covers 8 rows.
//
// What bounds it on the H100. Memory: two inputs read and two outputs
// written per element against ~10 flops; the bound is 4 * rows * C elements
// over 3.35 TB/s.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int PER>
__global__ void __launch_bounds__(32 * WARPS)
    add_layer_norm_kernel(const T* __restrict__ t, const T* __restrict__ d,
                          const float* __restrict__ w, const float* __restrict__ bias,
                          T* __restrict__ summed, T* __restrict__ normed, long long rows, int C,
                          float eps) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.y;
  if (row >= rows) return;
  const int lane = threadIdx.x;
  const size_t base = (size_t)row * C;
  float x[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    x[i] = 0.f;
    if (c < C) {
      x[i] = me::load1(t + base + c) + me::load1(d + base + c);
      me::store1(summed + base + c, x[i]);
      s += x[i];
    }
  }
  const float mean = warp_sum(s) / (float)C;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      const float dv = x[i] - mean;
      ss = fmaf(dv, dv, ss);
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)C + eps);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (c < C) me::store1(normed + base + c, (x[i] - mean) * inv * w[c] + bias[c]);
  }
}

template <typename T, int PER>
cudaError_t launch(const void* t, const void* d, const float* w, const float* b, void* summed,
                   void* normed, long long rows, int C, float eps, cudaStream_t st) {
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  add_layer_norm_kernel<T, PER><<<blocks, dim3(32, WARPS), 0, st>>>(
      static_cast<const T*>(t), static_cast<const T*>(d), w, b, static_cast<T*>(summed),
      static_cast<T*>(normed), rows, C, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* t, const void* d, const float* w, const float* b,
                     void* summed, void* normed, long long rows, int C, float eps,
                     cudaStream_t st) {
  if (C <= 320) return launch<T, 10>(t, d, w, b, summed, normed, rows, C, eps, st);
  if (C <= 640) return launch<T, 20>(t, d, w, b, summed, normed, rows, C, eps, st);
  return launch<T, 40>(t, d, w, b, summed, normed, rows, C, eps, st);
}

}  // namespace

// t, d, summed, normed: [rows, C] in dtype (0 float32, 1 bfloat16); w, b:
// [C] fp32. C <= 1280. Returns a cudaError_t code (0 = launched).
extern "C" int me_add_layer_norm(const void* t, const void* d, const void* w, const void* b,
                                 void* summed, void* normed, long long rows, int C, float eps,
                                 int dtype, void* stream) {
  if (rows < 1 || C < 1 || C > 1280) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(t, d, wf, bf, summed, normed, rows, C, eps, st)
          : dispatch<__nv_bfloat16>(t, d, wf, bf, summed, normed, rows, C, eps, st);
  return (int)err;
}
