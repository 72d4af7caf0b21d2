// Packed-head video attention on [B, F, N, C] (K1) and the fg/bg injection
// attention of the edit rows (K2), one kernel body for both.
//
// Replaces (TPU / Pallas):
//   K1  motioneditor_tpu/ops/video_flash.py  _video_flash
//       (_kernel_nomax / _kernel_maxsafe, pallas_call at video_flash.py:248)
//   K2  motioneditor_tpu/ops/video_flash.py  _video_injection
//       (_inj_kernel_nomax / _inj_kernel_maxsafe, pallas_call at :591)
//   K4  motioneditor_tpu/ops/video_flash_bwd.py  video_flash_fwd_res
//       (_fwd_res_nomax / _fwd_res_maxsafe, pallas_call at video_flash_bwd.py:229):
//       K1's body, which also writes lse = m + ln(l) per (query row, head)
//       in fp32 for the backward kernels (video_attention_bwd.cu)
//   K12 motioneditor_tpu/ops/video_flash.py  _video_flash_kv (pallas_call at :726)
//   K13 motioneditor_tpu/ops/video_flash.py  _video_injection_kv (pallas_call at :859)
//       the explicit-K/V twins of K1 and K2 that the frame-sharded path runs
//       (parallel/flash_sharding.py): the K/V source of every query frame is
//       built outside the kernel with collectives and handed over as
//       [B, Fk, M, C]; query frame f reads K/V frame (Fk == 1 ? 0 : f), M
//       tokens of it. K13 reads its source keys so, with the per-token fg
//       mask row mask[f, 0..M) ([F, M], already halo-built as [prev | cur]),
//       then the N target-row keys of frame f. Same body: only the
//       addressing differs. Offsets are 64-bit (dense M = F*N = 32768).
//
// What it computes. For query frame f of batch row b and head h, softmax
// attention over the keys of the source frames chosen by `mode`:
//   normal [f] | sparse_causal [0, f-1] | motion_frame [f-1, f] | dense [0..F-1]
// with f-1 clamped to 0, so frame 0 reads frame 0 twice and the duplicated
// keys keep their doubled softmax weight. Injection (K2) scores the source
// keys of frames [f-1, f] once and uses each score s twice, as the logits
// s*m and s*(1-m) (m = the fg mask of the key's frame) with the same value;
// a key with m = 0 has fg logit 0, not -inf. Then the current frame's
// target-row keys follow as a third, unmasked pass.
//
// Design. Heads are a channel stride: a block loads the d columns of its head
// straight from the packed layout, so no head-split copies exist. A block
// owns (64 queries, one head, one (b, f)); it picks its K/V frames from its
// own block index and streams 32-key tiles through shared memory with an
// exact online softmax (running max, fp32) for both dtypes. Scores and the
// P.V product are fp32 FMAs on CUDA cores with 4x4 / 4x(d/8) register tiles.
//
// What bounds it on the H100. Attention at these shapes is compute-bound
// (N = 1024-4096 keys per source frame, d = 40-80): ~4*N_kv*d flops per
// query against ~2*d*2 bytes per key tile shared by 64 queries. This body
// runs on the fp32 CUDA cores and is bounded by shared-memory bandwidth of
// the FMA loops, far below the bf16 tensor-core peak. K1 in bf16 (d % 8 ==
// 0, d <= 160) no longer comes here, nor do K2, K4, K12 and K13 under the
// same rule: they run the wgmma + TMA bodies of attention_tc.cu. Their
// fp32 launches (and other head dims) still run this one.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 32;   // keys per tile
constexpr int NTHREADS = 128;

using me::DENSE;
using me::INJECTION;
using me::MOTION_FRAME;
using me::NORMAL;
using me::SPARSE_CAUSAL;
using me::num_passes;
using me::pass_frame;

// the explicit-K/V modes (K12, K13): mode codes past me::Mode's
constexpr int EXPLICIT_KV = 5;
constexpr int INJECTION_KV = 6;

struct Params {
  const void* q;
  const void* k;     // K1: k;  K2: source-row keys
  const void* v;
  const void* k2;    // K2: target-row keys (current frame only)
  const void* v2;
  const float* mask; // K2: [F, N] fg mask, indexed by the key's frame;
                     // K13: [F, M] fg mask, indexed by the query's frame
  void* out;
  float* lse;        // K4 only: [B, F, N, H] natural-log log-sum-exp, else null
  int B, F, N, H, d;
  float scale_log2;  // softmax scale * log2(e): scores live in log2 units
  int mode;
  int Fk, M;         // K12 / K13: the explicit K/V source [B, Fk, M, C]
};

template <int DP>
struct Smem {
  static constexpr int QST = DP + 1;  // +1 pads rows off the same bank
  static constexpr int KST = DP + 1;
  static constexpr int VST = DP;
  static constexpr int SST = BK + 1;
  static constexpr int floats = BQ * QST + BK * KST + BK * VST + BQ * SST + BK + 3 * BQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS) video_attention_kernel(Params p) {
  using S = Smem<DP>;
  constexpr int DC = DP / 8;   // 8-wide chunks per padded head row
  constexpr int DPT = DP / 8;  // P.V accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * S::QST;
  float* Vs = Ks + BK * S::KST;
  float* Ss = Vs + BK * S::VST;
  float* Mk = Ss + BQ * S::SST;  // per-key fg mask of the current tile
  float* row_m = Mk + BK;        // running max per query row
  float* row_l = row_m + BQ;     // running denominator
  float* row_a = row_l + BQ;     // rescale factor of the current tile

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bf = blockIdx.z;
  const int b = bf / p.F;
  const int f = bf - b * p.F;
  const int d = p.d;
  const int dc = d / 8;
  const int C = p.H * d;
  const T* qg = static_cast<const T*>(p.q);
  T* og = static_cast<T*>(p.out);

  for (int idx = tid; idx < BQ * DC; idx += NTHREADS) {
    const int r = idx / DC, c8 = idx - (idx / DC) * DC;
    const int n = q0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (c8 < dc && n < p.N) me::load8(qg + ((size_t)bf * p.N + n) * C + h * d + c8 * 8, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) Qs[r * S::QST + c8 * 8 + i] = x[i];
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  const int ty = tid / 8;  // query rows 4*ty .. 4*ty+3
  const int tx = tid % 8;  // S columns 4*tx..4*tx+3; P.V columns tx + 8*j
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  const bool explicit_kv = p.mode >= EXPLICIT_KV;
  const int npass = p.mode == EXPLICIT_KV ? 1 : p.mode == INJECTION_KV ? 2 : num_passes(p.mode, p.F);
  for (int pass = 0; pass < npass; ++pass) {
    const bool target = (p.mode == INJECTION && pass == 2) || (p.mode == INJECTION_KV && pass == 1);
    const bool masked = (p.mode == INJECTION && pass < 2) || (p.mode == INJECTION_KV && pass == 0);
    const T* kg = static_cast<const T*>(target ? p.k2 : p.k);
    const T* vg = static_cast<const T*>(target ? p.v2 : p.v);
    int nkeys = p.N;            // keys of this pass
    size_t kv_base;             // element offset of key 0, head h
    const float* mrow = nullptr;  // fg mask of this pass's keys
    if (!explicit_kv) {
      const int fs = pass_frame(p.mode, pass, f);
      kv_base = (size_t)(b * p.F + fs) * p.N * C + h * d;
      if (masked) mrow = p.mask + (size_t)fs * p.N;
    } else if (target) {        // K13's target rows: frame f of [B, F, N, C]
      kv_base = ((size_t)b * p.F + f) * p.N * C + h * d;
    } else {                    // the explicit source: frame f (or 0) of [B, Fk, M, C]
      nkeys = p.M;
      kv_base = ((size_t)b * p.Fk + (p.Fk == 1 ? 0 : f)) * p.M * C + h * d;
      if (masked) mrow = p.mask + (size_t)f * p.M;
    }

    for (int k0 = 0; k0 < nkeys; k0 += BK) {
      __syncthreads();  // the previous tile's readers of Ks/Vs/Ss are done
      for (int idx = tid; idx < BK * DC; idx += NTHREADS) {
        const int r = idx / DC, c8 = idx - (idx / DC) * DC;
        const int n = k0 + r;
        float kx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float vx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (c8 < dc && n < nkeys) {
          me::load8(kg + kv_base + (size_t)n * C + c8 * 8, kx);
          me::load8(vg + kv_base + (size_t)n * C + c8 * 8, vx);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          Ks[r * S::KST + c8 * 8 + i] = kx[i];
          Vs[r * S::VST + c8 * 8 + i] = vx[i];
        }
      }
      if (tid < BK) {
        const int n = k0 + tid;
        Mk[tid] = (masked && n < nkeys) ? mrow[n] : 0.f;
      }
      __syncthreads();

      // scores of a 4x4 (query, key) patch per thread
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < DP; ++c) {
        float a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * S::QST + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx * 4 + j) * S::KST + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ss[(ty * 4 + i) * S::SST + tx * 4 + j] = s[i][j] * p.scale_log2;
      __syncthreads();

      // online softmax: two threads (adjacent lanes) per query row
      {
        const int r = tid >> 1, half = tid & 1;
        const int nvalid = min(BK, nkeys - k0);
        float* srow = Ss + r * S::SST;
        float mx = -INFINITY;
        for (int j = half * 16; j < half * 16 + 16; ++j) {
          if (j < nvalid) {
            const float sv = srow[j];
            if (masked) {
              const float fg = sv * Mk[j];
              mx = fmaxf(mx, fmaxf(fg, sv - fg));
            } else {
              mx = fmaxf(mx, sv);
            }
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_old = row_m[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = half * 16; j < half * 16 + 16; ++j) {
          float pv = 0.f;
          if (j < nvalid) {
            const float sv = srow[j];
            if (masked) {
              const float fg = sv * Mk[j];
              pv = exp2f(fg - m_new) + exp2f(sv - fg - m_new);
            } else {
              pv = exp2f(sv - m_new);
            }
          }
          srow[j] = pv;
          sum += pv;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        __syncwarp();  // both halves have read row_m[r] before it changes
        if (half == 0) {
          const float alpha = exp2f(m_old - m_new);
          row_a[r] = alpha;
          row_l[r] = row_l[r] * alpha + sum;
          row_m[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P . V
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = row_a[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] *= al;
      }
      for (int j = 0; j < BK; ++j) {
        float pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = Ss[(ty * 4 + i) * S::SST + j];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const float vv = Vs[j * S::VST + tx + 8 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int n = q0 + r;
    if (n < p.N) {
      const float inv = 1.f / row_l[r];
      T* orow = og + ((size_t)bf * p.N + n) * C + h * d;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 8 * c;
        if (col < d) me::store1(orow + col, acc[i][c] * inv);
      }
    }
  }
  if (p.lse != nullptr && tid < BQ && q0 + tid < p.N) {
    // scores are in log2 units: lse = (m + log2 l) * ln 2
    p.lse[((size_t)bf * p.N + q0 + tid) * p.H + h] = (row_m[tid] + log2f(row_l[tid])) * me::kLn2;
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Smem<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      video_attention_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BQ - 1) / BQ, p.H, p.B * p.F);
  video_attention_kernel<T, DP><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.d <= 16) return launch<T, 16>(p, stream);
  if (p.d <= 32) return launch<T, 32>(p, stream);
  if (p.d <= 48) return launch<T, 48>(p, stream);
  if (p.d <= 64) return launch<T, 64>(p, stream);
  if (p.d <= 80) return launch<T, 80>(p, stream);
  if (p.d <= 96) return launch<T, 96>(p, stream);
  if (p.d <= 128) return launch<T, 128>(p, stream);
  if (p.d <= 160) return launch<T, 160>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 normal, 1 sparse_causal, 2 motion_frame, 3 dense, 4 injection.
// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t code (0 = launched).
extern "C" int me_video_attention(const void* q, const void* k, const void* v,
                                  const void* k2, const void* v2, const void* mask,
                                  void* out, int B, int F, int N, int H, int d,
                                  float scale, int mode, int dtype, void* stream) {
  if (d % 8 != 0 || d > 160 || mode < 0 || mode > 4) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, k2, v2, static_cast<const float*>(mask), out, nullptr,
           B, F, N, H, d, scale * me::kLog2e, mode, F, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, st) : dispatch<__nv_bfloat16>(p, st);
  return (int)err;
}

// K4: the forward of modes 0-3 that also writes the log-sum-exp of every
// (query row, head) as fp32 [B, F, N, H] for the backward (video_attention_bwd.cu).
extern "C" int me_video_attention_fwd_res(const void* q, const void* k, const void* v,
                                          void* out, float* lse, int B, int F, int N, int H,
                                          int d, float scale, int mode, int dtype,
                                          void* stream) {
  if (d % 8 != 0 || d > 160 || mode < 0 || mode > 3 || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, nullptr, nullptr, nullptr, out, lse,
           B, F, N, H, d, scale * me::kLog2e, mode, F, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, st) : dispatch<__nv_bfloat16>(p, st);
  return (int)err;
}

// K12 (injection 0): q [B, F, N, C] against the explicit K/V [B, Fk, M, C],
// Fk in {1, F}; query frame f reads K/V frame (Fk == 1 ? 0 : f).
// K13 (injection 1): q_tgt [B, F, N, C]; source K/V [B, F, M, C] with the fg
// mask [F, M] of each query frame's source tokens; target K/V (k2, v2)
// [B, F, N, C] of the current frame. Returns a cudaError_t code.
extern "C" int me_video_attention_kv(const void* q, const void* k, const void* v,
                                     const void* k2, const void* v2, const void* mask,
                                     void* out, int B, int F, int N, int Fk, int M, int H,
                                     int d, float scale, int injection, int dtype,
                                     void* stream) {
  if (d % 8 != 0 || d > 160 || M < 1 || (Fk != 1 && Fk != F)) return (int)cudaErrorInvalidValue;
  if (injection && (Fk != F || mask == nullptr || k2 == nullptr || v2 == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, k2, v2, static_cast<const float*>(mask), out, nullptr,
           B, F, N, H, d, scale * me::kLog2e, injection ? INJECTION_KV : EXPLICIT_KV, Fk, M};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, st) : dispatch<__nv_bfloat16>(p, st);
  return (int)err;
}
