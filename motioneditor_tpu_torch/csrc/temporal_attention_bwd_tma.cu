// Backward of the temporal attention over the frame axis (K7), in one pass
// over device memory, with each tile's frame slabs staged once in shared
// memory by TMA.
//
// Replaces (TPU / Pallas): motioneditor_tpu/ops/temporal_flash.py
// _temporal_4d_bwd (_bwd_kernel, pallas_call at temporal_flash.py:190),
// which keeps all F frames of a block of sites resident in VMEM for the
// same reason.
//
// What it computes. Tokens [B, F, N, C] are N*H independent length-F
// sequences of d = C/H channels (as in K3). Per sequence, from q, k, v and
// the output gradient dO, with P the fp32 causal (or full) softmax of
// scale * q k^T (recomputed: no residuals are saved):
//   dP[f,g] = dO_f . v_g,   D_f = sum_g P[f,g] dP[f,g],   dS = P o (dP - D)
//   dq_f = scale sum_g dS[f,g] k_g     dk_g = scale sum_f dS[f,g] q_f
//   dv_g = sum_f P[f,g] dO_f
// Causal pairs g > f are never formed; a causal column g sums f >= g.
//
// What bounds it on the H100: bytes, as for K3: 7 tensors cross HBM (q, k,
// v, dO in; dq, dk, dv out) for ~10 F(F+1)/2 C flops per site at F = 8,
// on CUDA cores (tensor cores bring nothing to F x F x d products).
//
// Design (temporal_tma.cuh for the tile walk, the ring and the lanes): the
// tile's q, k, v and dO slabs arrive by TMA into a ring stage, once. Per
// (site, head) sequence, its F frame threads (x split, each on every
// split-th 8-channel chunk) sit in one warp:
//  1. rows: thread f forms scores and dP against every staged k_g, v_g
//     (broadcast reads), adds its split partners' partial sums by shuffles,
//     builds P and dS of row f in registers, writes both rows to the
//     sequence's fp32 F x (F + 1) buffers, and stores dq_f as the row sum
//     scale * sum_g dS[f,g] k_g;
//  2. columns (after __syncwarp): thread g reads column g of P and dS and
//     stores dk_g and dv_g as sums over the staged q_f and dO_f.
// Each of dq, dk and dv is written once, as 16-byte stores from registers.
#include <math.h>
#include <stdint.h>

#include "temporal_tma.cuh"

namespace {

using me_tt::Params;

template <typename T, int FMAX>
__global__ void __launch_bounds__(32 * me_tt::MAX_WARPS)
    temporal_bwd_tma_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = me_tt::ring_start(p, smem, true);
  const me_tt::Lanes L(p, threadIdx.x);
  const int F = p.Fq, d = p.d, w = p.hg * d, C = p.H * d;
  const int f = L.f;  // this thread's row, then its column
  const int rs = F + 1;  // row stride of the P / dS buffers
  float* pbuf = reinterpret_cast<float*>(smem + p.buf_off) +
                (size_t)(L.warp * L.spw + (L.slot < L.spw ? L.slot : 0)) *
                    me_tt::seq_buf_floats(F);
  float* dsbuf = pbuf + F * rs;
  const size_t fstride = (size_t)p.sites * w;  // elements between frames of a slab
  T* dq = static_cast<T*>(p.o0);
  T* dk = static_cast<T*>(p.o1);
  T* dv = static_cast<T*>(p.o2);

  int it = 0;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x, ++it) {
    const int s = it % p.stages;
    me_tc::mbar_wait(full + s, (it / p.stages) & 1);
    const me_tt::Tile x = me_tt::tile_of(p, t);
    const unsigned char* stage = smem + s * p.stage_bytes;
    const T* qs = reinterpret_cast<const T*>(stage);
    const T* ks = reinterpret_cast<const T*>(stage + p.slab_q);
    const T* vs = reinterpret_cast<const T*>(stage + p.slab_q + p.slab_kv);
    const T* gs = reinterpret_cast<const T*>(stage + p.slab_q + 2 * p.slab_kv);
    for (int j = 0; j < L.passes; ++j) {
      const me_tt::Seq q = L.seq(p, x, j);
      if (!__any_sync(0xffffffffu, q.store)) continue;  // the warp has no row below N
      const size_t col = (size_t)q.si * w + q.hh * d;
      const size_t grow =
          ((size_t)(x.b * F + f) * p.N + x.n0 + q.si) * C + (size_t)(x.h0 + q.hh) * d;
      // 1. row f: scores and dP, P and dS, dq_f
      const int glim = p.causal ? f + 1 : F;
      float sc[FMAX], dp[FMAX];
#pragma unroll
      for (int g = 0; g < FMAX; ++g) sc[g] = dp[g] = 0.f;
      const T* qrow = qs + f * fstride + col;
      const T* dorow = gs + f * fstride + col;
      for (int c = 8 * L.part; c < d; c += 8 * p.split) {
        float qv[8], gv[8];
        me::load8(qrow + c, qv);
        me::load8(dorow + c, gv);
#pragma unroll
        for (int g = 0; g < FMAX; ++g) {
          if (g < glim) {
            float kv[8], vv[8];
            me::load8(ks + g * fstride + col + c, kv);
            me::load8(vs + g * fstride + col + c, vv);
            float sd = 0.f, pd = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              sd = fmaf(qv[i], kv[i], sd);
              pd = fmaf(gv[i], vv[i], pd);
            }
            sc[g] += sd;
            dp[g] += pd;
          }
        }
      }
      me_tt::sum_parts<FMAX>(sc, p.split);
      me_tt::sum_parts<FMAX>(dp, p.split);
      float m = -INFINITY;
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < glim) {
          sc[g] *= p.scale_log2;
          m = fmaxf(m, sc[g]);
        }
      }
      float l = 0.f;
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < glim) {
          sc[g] = exp2f(sc[g] - m);
          l += sc[g];
        }
      }
      const float inv = 1.f / l;
      float D = 0.f;
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < glim) {
          sc[g] *= inv;  // P[f, g]
          D = fmaf(sc[g], dp[g], D);
        }
      }
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < F) {
          const bool in = g < glim;
          dp[g] = in ? sc[g] * (dp[g] - D) * p.scale : 0.f;  // scale * dS[f, g]
          if (L.part == 0 && q.store) {  // lanes without a sequence share slot 0's rows
            pbuf[f * rs + g] = in ? sc[g] : 0.f;
            dsbuf[f * rs + g] = dp[g];
          }
        }
      }
      if (q.store) {
        for (int c = 8 * L.part; c < d; c += 8 * p.split) {
          float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int g = 0; g < FMAX; ++g) {
            if (g < glim) {
              float kv[8];
              me::load8(ks + g * fstride + col + c, kv);
#pragma unroll
              for (int i = 0; i < 8; ++i) o[i] = fmaf(dp[g], kv[i], o[i]);
            }
          }
          me::store8(dq + grow + c, o);
        }
      }
      __syncwarp();
      if (q.store) {  // 2. column g = f: dk_g, dv_g
        const int g = f;
        const int flo = p.causal ? g : 0;
        float pc[FMAX], dsc[FMAX];
#pragma unroll
        for (int r = 0; r < FMAX; ++r) {
          const bool in = r >= flo && r < F;
          pc[r] = in ? pbuf[r * rs + g] : 0.f;
          dsc[r] = in ? dsbuf[r * rs + g] : 0.f;
        }
        for (int c = 8 * L.part; c < d; c += 8 * p.split) {
          float ak[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          float av[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < FMAX; ++r) {
            if (r >= flo && r < F) {
              float qv[8], gv[8];
              me::load8(qs + r * fstride + col + c, qv);
              me::load8(gs + r * fstride + col + c, gv);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                ak[i] = fmaf(dsc[r], qv[i], ak[i]);
                av[i] = fmaf(pc[r], gv[i], av[i]);
              }
            }
          }
          me::store8(dk + grow + c, ak);
          me::store8(dv + grow + c, av);
        }
      }
      __syncwarp();  // the buffers are free for the warp's next sequences
    }
    __syncthreads();  // every thread is done with stage s
    me_tt::ring_refill(p, smem, full, s, t, true);
  }
}

template <typename T>
cudaError_t dispatch(Params& p, int smem_bytes, cudaStream_t st) {
  if (p.Fq <= 8)
    return me_tt::launch_persistent(temporal_bwd_tma_kernel<T, 8>, p, smem_bytes, st);
  if (p.Fq <= 16)
    return me_tt::launch_persistent(temporal_bwd_tma_kernel<T, 16>, p, smem_bytes, st);
  return me_tt::launch_persistent(temporal_bwd_tma_kernel<T, 32>, p, smem_bytes, st);
}

}  // namespace

// K7: q, k, v, dout, dq, dk, dv [B, F, N, C], one dtype (0 float32, 1
// bfloat16); the tile (sites, hg, rows, split, stages, warps, smem_bytes) from
// ops/temporal_flash.py temporal_tile. Returns a cudaError_t code (0 = launched).
extern "C" int me_temporal_attention_bwd_tma(const void* q, const void* k, const void* v,
                                             const void* dout, void* dq, void* dk, void* dv,
                                             int B, int F, int N, int H, int d, float scale,
                                             int causal, int sites, int hg, int rows,
                                             int split, int stages, int warps, int smem_bytes,
                                             int dtype, void* stream) {
  Params p{};
  p.B = B, p.Fq = F, p.Fk = F, p.kv_frames = F, p.N = N, p.H = H, p.d = d, p.causal = causal;
  p.q_off = 0;
  p.sites = sites, p.hg = hg, p.rows = rows, p.split = split, p.stages = stages;
  p.warps = warps;
  p.scale = scale, p.scale_log2 = scale * me::kLog2e;
  p.o0 = dq, p.o1 = dk, p.o2 = dv;
  const bool bf16 = dtype == 1;
  // one frame per thread: two (rows = 2, as K3 takes them) measured slower
  if ((dtype != 0 && !bf16) || rows != 1 || !me_tt::plan(p, bf16, true, smem_bytes))
    return (int)cudaErrorInvalidValue;
  for (const void* o : {(const void*)dq, (const void*)dk, (const void*)dv})
    if (reinterpret_cast<uintptr_t>(o) % 16 != 0) return (int)cudaErrorInvalidValue;
  const int C = H * d, w = hg * d;
  if (!me_tt::encode3(&p.mq, q, bf16, C, N, B * F, w, sites, F) ||
      !me_tt::encode3(&p.mk, k, bf16, C, N, B * F, w, sites, F) ||
      !me_tt::encode3(&p.mv, v, bf16, C, N, B * F, w, sites, F) ||
      !me_tt::encode3(&p.mdo, dout, bf16, C, N, B * F, w, sites, F))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? dispatch<__nv_bfloat16>(p, smem_bytes, st)
                    : dispatch<float>(p, smem_bytes, st));
}
