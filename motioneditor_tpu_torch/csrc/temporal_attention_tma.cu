// Temporal attention over the frame axis at every spatial site (K3) and its
// frame-sharded variant (K14), with each tile's frame slabs staged once in
// shared memory by TMA.
//
// Replaces (TPU / Pallas): motioneditor_tpu/ops/temporal_flash.py
//   K3  _temporal_4d (_kernel, pallas_call at temporal_flash.py:208), whose
//       BlockSpec holds the whole [F, bn, C] slab of a block of sites in VMEM;
//   K14 _temporal_4d_bias (_kernel_bias, pallas_call at temporal_flash.py:361),
//       the same over Fq local query frames and Fk gathered K/V frames, its
//       causal mask an additive bias at global frame indices.
//
// What it computes. Tokens [B, F, N, C] are N*H independent length-F
// sequences of d = C/H channels; query frame f attends over key frames
// g <= f + q_off (causal) or all g, with an fp32 softmax for any input
// dtype, and P.V is stored in the input dtype. Pairs above the diagonal are
// never formed, which equals the reference's additive -1e4 mask (K14's
// -1e30 bias) to within exp(-1e4) = 0. K3 is Fq = Fk, q_off = 0; K14 has q
// hold the Fq local frames of a shard at global offset q_off and K/V all Fk
// frames, so a tile stages an Fq-frame q slab and K/V slabs of the frames its
// queries read: causal, only the first min(Fk, q_off + Fq) (a shard at offset
// 0 of a 4-way split of 8 frames reads 2 of them).
//
// What bounds it on the H100: bytes. At F = 8 a site's work is
// ~4 F(F+1)/2 C flops against 4 F C elements of q, k, v and out, a few
// flops per byte, far under the card's ~20 fp32 flops per byte; tensor
// cores bring nothing to 8 x 8 x d products, so this runs on CUDA cores.
//
// Design (temporal_tma.cuh for the shared parts).
//  - Persistent blocks (as many as fit on the card) walk tiles of `sites`
//    consecutive sites x `hg` heads x all frames of one batch row; thread 0
//    keeps a ring of `stages` tiles in flight, each filled by one TMA box per
//    operand and completing on the stage's mbarrier, so every byte of q, k
//    and v crosses HBM once and the next tiles load while this one computes.
//  - The threads of a (site, head) sequence sit in one warp: their reads of
//    k_g and v_g are the same shared-memory words (broadcasts), so shared
//    traffic stays near the slab size, not Fq times it. A thread takes one
//    query frame f, or two (rows = 2: f and Fq - 1 - f, so every causal pair
//    of frames does Fq + 1 frame pairs and one load and conversion of a k or
//    v chunk serves both), keeps their scores in registers, and walks every
//    split-th 8-channel chunk of d (one 16-byte load per chunk in bf16); the
//    split threads of a frame add their partial scores with warp shuffles
//    and each stores its own chunks of the output. The split puts more
//    threads on each staged byte: the ring holds only so many slabs, and a
//    thread per frame alone leaves the SM short of warps.
//  - Outputs go straight from registers to device memory as 16-byte stores,
//    bf16 packed with __floats2bfloat162_rn; rows past N are not stored.
#include <math.h>
#include <stdint.h>

#include "temporal_tma.cuh"

namespace {

using me_tt::Params;

template <typename T, int FMAX, int R>
__global__ void __launch_bounds__(32 * me_tt::MAX_WARPS)
    temporal_attention_tma_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = me_tt::ring_start(p, smem, false);
  const me_tt::Lanes L(p, threadIdx.x);
  const int d = p.d, w = p.hg * d, C = p.H * d;
  int fr[R], glim[R];  // the thread's query frames and their key-frame limits
  fr[0] = L.f;
  if (R == 2) fr[R - 1] = L.f2;
  int gmax = 0;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    glim[a] = a > 0 && !L.pair ? 0 : p.causal ? min(fr[a] + p.q_off + 1, p.Fk) : p.Fk;
    gmax = max(gmax, glim[a]);
  }
  const size_t kstride = (size_t)p.sites * w;  // elements between frames of a slab
  T* out = static_cast<T*>(p.o0);

  int it = 0;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x, ++it) {
    const int s = it % p.stages;
    me_tc::mbar_wait(full + s, (it / p.stages) & 1);
    const me_tt::Tile x = me_tt::tile_of(p, t);
    const unsigned char* stage = smem + s * p.stage_bytes;
    const T* qs = reinterpret_cast<const T*>(stage);
    const T* ks = reinterpret_cast<const T*>(stage + p.slab_q);
    const T* vs = reinterpret_cast<const T*>(stage + p.slab_q + p.slab_kv);
    for (int j = 0; j < L.passes; ++j) {
      const me_tt::Seq q = L.seq(p, x, j);
      if (!__any_sync(0xffffffffu, q.store)) continue;  // the warp has no row below N
      const size_t col = (size_t)q.si * w + q.hh * d;
      float sc[R][FMAX];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int g = 0; g < FMAX; ++g) sc[a][g] = 0.f;
      for (int c = 8 * L.part; c < d; c += 8 * p.split) {
        float qv[R][8];
#pragma unroll
        for (int a = 0; a < R; ++a) me::load8(qs + fr[a] * kstride + col + c, qv[a]);
#pragma unroll
        for (int g = 0; g < FMAX; ++g) {
          if (g < gmax) {
            float kv[8];
            me::load8(ks + g * kstride + col + c, kv);
#pragma unroll
            for (int a = 0; a < R; ++a) {
              if (g < glim[a]) {
                float dot = 0.f;
#pragma unroll
                for (int i = 0; i < 8; ++i) dot = fmaf(qv[a][i], kv[i], dot);
                sc[a][g] += dot;
              }
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
        me_tt::sum_parts<FMAX>(sc[a], p.split);
        float m = -INFINITY;
#pragma unroll
        for (int g = 0; g < FMAX; ++g) {
          if (g < glim[a]) {
            sc[a][g] *= p.scale_log2;
            m = fmaxf(m, sc[a][g]);
          }
        }
        float l = 0.f;
#pragma unroll
        for (int g = 0; g < FMAX; ++g) {
          if (g < glim[a]) {
            sc[a][g] = exp2f(sc[a][g] - m);
            l += sc[a][g];
          }
        }
        const float inv = glim[a] > 0 ? 1.f / l : 0.f;
#pragma unroll
        for (int g = 0; g < FMAX; ++g) sc[a][g] *= inv;
      }
      if (!q.store) continue;
      T* orow[R];
#pragma unroll
      for (int a = 0; a < R; ++a)
        orow[a] = out + ((size_t)(x.b * p.Fq + fr[a]) * p.N + x.n0 + q.si) * C +
                  (size_t)(x.h0 + q.hh) * d;
      for (int c = 8 * L.part; c < d; c += 8 * p.split) {
        float o[R][8];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int i = 0; i < 8; ++i) o[a][i] = 0.f;
#pragma unroll
        for (int g = 0; g < FMAX; ++g) {
          if (g < gmax) {
            float vv[8];
            me::load8(vs + g * kstride + col + c, vv);
#pragma unroll
            for (int a = 0; a < R; ++a)
#pragma unroll
              for (int i = 0; i < 8; ++i) o[a][i] = fmaf(sc[a][g], vv[i], o[a][i]);
          }
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
          if (a == 0 || L.pair) me::store8(orow[a] + c, o[a]);
      }
    }
    __syncthreads();  // every thread is done with stage s
    me_tt::ring_refill(p, smem, full, s, t, false);
  }
}

template <typename T>
cudaError_t dispatch(Params& p, int smem_bytes, cudaStream_t st) {
  using me_tt::launch_persistent;
  if (p.rows == 2)  // plan() admits two rows at Fk <= 8 only
    return launch_persistent(temporal_attention_tma_kernel<T, 8, 2>, p, smem_bytes, st);
  if (p.Fk <= 8)
    return launch_persistent(temporal_attention_tma_kernel<T, 8, 1>, p, smem_bytes, st);
  if (p.Fk <= 16)
    return launch_persistent(temporal_attention_tma_kernel<T, 16, 1>, p, smem_bytes, st);
  return launch_persistent(temporal_attention_tma_kernel<T, 32, 1>, p, smem_bytes, st);
}

}  // namespace

// K3 (Fq = Fk, q_off = 0) and K14: q, out [B, Fq, N, C];
// k, v [B, Fk, N, C]; the tile (sites, hg, rows, split, stages, warps, smem_bytes) from
// ops/temporal_flash.py temporal_tile at Fq and the staged K/V frames
// (causal ? min(Fk, q_off + Fq) : Fk). dtype: 0 float32, 1 bfloat16.
// Returns a cudaError_t code (0 = launched).
extern "C" int me_temporal_attention_tma(const void* q, const void* k, const void* v, void* out,
                                         int B, int Fq, int Fk, int N, int H, int d,
                                         float scale, int causal, int q_off, int sites, int hg,
                                         int rows, int split, int stages, int warps,
                                         int smem_bytes, int dtype, void* stream) {
  // query frame f < Fq reads key frames g <= f + q_off < q_off + Fq when causal
  const int staged = causal && q_off < Fk - Fq ? q_off + Fq : Fk;
  Params p{};
  p.B = B, p.Fq = Fq, p.Fk = staged, p.kv_frames = Fk, p.N = N, p.H = H, p.d = d;
  p.causal = causal, p.q_off = q_off;
  p.sites = sites, p.hg = hg, p.rows = rows, p.split = split, p.stages = stages;
  p.warps = warps;
  p.scale = scale, p.scale_log2 = scale * me::kLog2e;
  p.o0 = out;
  const bool bf16 = dtype == 1;
  if ((dtype != 0 && !bf16) || !me_tt::plan(p, bf16, false, smem_bytes) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int C = H * d, w = hg * d;
  if (!me_tt::encode3(&p.mq, q, bf16, C, N, B * Fq, w, sites, Fq) ||
      !me_tt::encode3(&p.mk, k, bf16, C, N, B * Fk, w, sites, staged) ||
      !me_tt::encode3(&p.mv, v, bf16, C, N, B * Fk, w, sites, staged))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? dispatch<__nv_bfloat16>(p, smem_bytes, st)
                    : dispatch<float>(p, smem_bytes, st));
}
