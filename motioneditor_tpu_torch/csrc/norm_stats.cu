// Per-channel pair statistics (sum a, sum a*b) over the middle axis of
// [B, S, C] (K10), the two reductions of GroupNorm: forward (x, x) ->
// (sum x, sum x^2), backward (dy, x) -> (sum dy, sum dy*x).
//
// Replaces (TPU / Pallas): motioneditor_tpu/ops/gn_stats.py _pair_stats
// (_stats_kernel, pallas_call at gn_stats.py:78).
//
// What it computes. s1[b, c] = sum_s a[b, s, c] and s2[b, c] = sum_s
// a[b, s, c] * b[b, s, c], accumulated in fp32 for fp32 or bf16 inputs.
//
// Design. A column reduction: C is the contiguous axis, so the threads of a
// warp run along C and every row load is coalesced. Pass 1: the grid cuts S
// into chunks of CHUNK rows; a block owns one (batch, chunk, 64-channel tile)
// and its 4 row lanes each sum every 4th row of the chunk, then lane 0 adds
// the 4 lane sums in lane order and writes one fp32 partial per channel.
// Pass 2: one thread per (batch, channel) adds the chunk partials in chunk
// order. Every sum runs in a fixed order (no float atomics), so two runs on
// one card give bit-identical statistics, as the TPU kernel's sequential
// grid does. With a == b (the forward) each element is loaded once.
//
// What bounds it on the H100. Memory: 2 or 3 flops per element loaded; the
// bound is the bytes of a (and b when it is another tensor) over 3.35 TB/s.
// The chunk partials are 2 * B * ceil(S / CHUNK) * C floats, under 1% of
// the input at CHUNK = 128.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TILE_C = 64;
constexpr int LANES = 4;
constexpr int CHUNK = 128;
constexpr int COMBINE_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(TILE_C * LANES)
    pair_stats_partial(const T* __restrict__ a, const T* __restrict__ b,
                       float* __restrict__ p1, float* __restrict__ p2, int S, int C,
                       int nchunks, int same) {
  const int chunk = blockIdx.x;
  const int c = blockIdx.y * TILE_C + threadIdx.x;
  const int bi = blockIdx.z;
  const int r0 = chunk * CHUNK;
  const int r1 = min(S, r0 + CHUNK);
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const size_t base = (size_t)bi * S * C + c;
    for (int r = r0 + threadIdx.y; r < r1; r += LANES) {
      const size_t i = base + (size_t)r * C;
      const float x = me::load1(a + i);
      const float y = same ? x : me::load1(b + i);
      s1 += x;
      s2 = fmaf(x, y, s2);
    }
  }
  __shared__ float sh1[LANES][TILE_C];
  __shared__ float sh2[LANES][TILE_C];
  sh1[threadIdx.y][threadIdx.x] = s1;
  sh2[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      t1 += sh1[l][threadIdx.x];
      t2 += sh2[l][threadIdx.x];
    }
    const size_t o = ((size_t)bi * nchunks + chunk) * C + c;
    p1[o] = t1;
    p2[o] = t2;
  }
}

__global__ void __launch_bounds__(COMBINE_THREADS)
    pair_stats_combine(const float* __restrict__ p1, const float* __restrict__ p2,
                       float* __restrict__ s1, float* __restrict__ s2, int C, int nchunks) {
  const int c = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= C) return;
  float t1 = 0.f, t2 = 0.f;
  for (int k = 0; k < nchunks; ++k) {
    const size_t o = ((size_t)bi * nchunks + k) * C + c;
    t1 += p1[o];
    t2 += p2[o];
  }
  s1[(size_t)bi * C + c] = t1;
  s2[(size_t)bi * C + c] = t2;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, float* s1, float* s2, float* scratch, int B,
                   int S, int C, cudaStream_t st) {
  const int nchunks = (S + CHUNK - 1) / CHUNK;
  float* p1 = scratch;
  float* p2 = scratch + (size_t)B * nchunks * C;
  const dim3 grid(nchunks, (C + TILE_C - 1) / TILE_C, B);
  pair_stats_partial<T><<<grid, dim3(TILE_C, LANES), 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), p1, p2, S, C, nchunks, a == b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((C + COMBINE_THREADS - 1) / COMBINE_THREADS, B);
  pair_stats_combine<<<grid2, COMBINE_THREADS, 0, st>>>(p1, p2, s1, s2, C, nchunks);
  return cudaGetLastError();
}

}  // namespace

// The scratch buffer holds 2 * B * me_pair_stats_chunks(S) * C floats.
extern "C" int me_pair_stats_chunks(int S) { return (S + CHUNK - 1) / CHUNK; }

// dtype: 0 float32, 1 bfloat16. s1, s2: [B, C] fp32. Passing b == a reads
// the input once. Returns a cudaError_t code (0 = launched).
extern "C" int me_pair_stats(const void* a, const void* b, void* s1, void* s2, void* scratch,
                             int B, int S, int C, int dtype, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o1 = static_cast<float*>(s1);
  float* o2 = static_cast<float*>(s2);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t err =
      dtype == 0 ? launch<float>(a, b, o1, o2, sc, B, S, C, st)
                 : launch<__nv_bfloat16>(a, b, o1, o2, sc, B, S, C, st);
  return (int)err;
}
