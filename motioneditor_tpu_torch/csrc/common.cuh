// Shared helpers for the attention kernels: 8-wide vector loads/stores that
// convert between the storage dtype (fp32 or bf16) and fp32 registers.
//
// Every operand is a contiguous [B, F, N, C] tensor whose head dim d is a
// multiple of 8, so an 8-element chunk of one head never straddles a head
// and starts on a 16-byte (bf16) or 32-byte (fp32) boundary.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace me {

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// K/V source frames of the video attention modes, shared by the forward
// (video_attention.cu) and the backward (video_attention_bwd.cu) so both
// read the same frames: normal [f] | sparse_causal [0, f-1] |
// motion_frame [f-1, f] | dense [0..F-1] | injection [f-1, f, f], with f-1
// clamped to 0 (frame 0 reads frame 0 twice).
enum Mode { NORMAL = 0, SPARSE_CAUSAL = 1, MOTION_FRAME = 2, DENSE = 3, INJECTION = 4 };

__host__ __device__ __forceinline__ int num_passes(int mode, int F) {
  if (mode == NORMAL) return 1;
  if (mode == DENSE) return F;
  if (mode == INJECTION) return 3;
  return 2;
}

__host__ __device__ __forceinline__ int pass_frame(int mode, int pass, int f) {
  const int prev = f > 0 ? f - 1 : 0;
  switch (mode) {
    case NORMAL: return f;
    case SPARSE_CAUSAL: return pass == 0 ? 0 : prev;
    case DENSE: return pass;
    default: return pass == 0 ? prev : f;  // motion_frame; injection [f-1|f|f]
  }
}

}  // namespace me
