// Split-head flash attention (K8) and split-head fg/bg injection attention
// (K9) over [G, H, N, D] operands addressed by strides.
//
// Replaces (TPU / Pallas):
//   K8  motioneditor_tpu/ops/flash_attention.py  _flash_3d
//       (_flash_kernel / _flash_kernel_nomax, pallas_call at flash_attention.py:222)
//   K9  motioneditor_tpu/ops/injection_flash.py  _fused_3d
//       (_kernel / _kernel_nomax, pallas_call at injection_flash.py:268)
//
// What it computes. Every operand is a [G, H, N, D] view given by a pointer
// and the element strides of its G, H and N axes (D is contiguous), so the
// head-split views that split_heads makes of a packed [..., N, H*D] tensor
// are read in place and no head-split copy exists. For each (g, h):
//   K8  softmax(q k^T * scale) v over the Nk keys;
//   K9  a source pass over Nk keys that scores each key once and uses the
//       score s twice, as the logits s*m and s*(1-m) with the same value
//       (m = mask[g % F, key], the fg mask of the key's frame; a key with
//       m = 0 has fg logit 0, not -inf), then a target pass over Nt
//       unmasked keys, all under one softmax.
// The auto-mask injection hands K8 keys and values already multiplied by
// the mask; those score 0 and keep their softmax weight with zero values,
// as in JAX: nothing here special-cases them.
//
// Design. The tile loop of K1 (video_attention.cu): a block owns (64
// queries, one head, one g) and streams 32-key tiles through shared memory
// with an exact online softmax (running max, fp32) for both dtypes; scores
// and P.V are fp32 FMAs on CUDA cores with 4x4 / 4x(DP/8) register tiles.
// What differs is the addressing: strides in place of the packed layout's
// frame selection, so one body serves both entry points. The head dim is
// any d <= 256, zero-padded in shared memory to a bucket DP. Rows load as
// 16-byte vectors when every row of every operand starts on a 16-byte
// boundary and d % 8 == 0 (the auto path: d = 40, 80), else element by
// element (e.g. d = 9 in the split-head branch of the mask injection).
//
// What bounds it on the H100. At the auto path's shapes (Nq = 1024-4096
// queries against 2Nq keys, d = 40-80) attention is compute-bound: ~4*Nk*d
// flops per query against 2*d elements per key tile shared by 64 queries.
// This body runs on the fp32 CUDA cores and is bounded by the shared-memory
// bandwidth of its FMA loops, far below the bf16 tensor-core peak. K8 in
// bf16 with 16-byte aligned rows, d % 8 == 0 and d <= 160 (the auto path)
// no longer comes here: it runs the wgmma + TMA body of attention_tc.cu.
// K8 in fp32 or at other head dims, and K9, still run this one.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 32;   // keys per tile
constexpr int NTHREADS = 128;
constexpr int MAX_D = 256;
constexpr int FLASH = 0;      // K8
constexpr int INJECTION = 1;  // K9

struct View {  // a [G, H, N, D] operand: element strides of G, H and N; D contiguous
  const void* ptr;
  long long sg, sh, sn;
};

struct Params {
  View q, k, v;  // k, v: K8's keys; K9's source keys
  View k2, v2;   // K9: target keys
  View out;
  const float* mask;  // K9: [F, Nk] fg mask over the source keys, row g % F
  int G, H, Nq, Nk, Nt, F, d;
  float scale_log2;  // softmax scale * log2(e): scores live in log2 units
  int mode;
  int vec;  // 1: rows load as 16-byte vectors (see the header)
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

// dst[r * ld + c] = row (n0 + r) of `base`, column c, for r < ROWS, c < DP;
// zero past d and past row n_end.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base, long long sn,
                                          int n0, int n_end, int d, int vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int DC = DP / 8;
    const int dc = d / 8;
    for (int idx = tid; idx < ROWS * DC; idx += NTHREADS) {
      const int r = idx / DC, c8 = idx - (idx / DC) * DC;
      const int n = n0 + r;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c8 < dc && n < n_end) me::load8(base + (long long)n * sn + c8 * 8, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[r * ld + c8 * 8 + i] = x[i];
    }
  } else {
    for (int idx = tid; idx < ROWS * DP; idx += NTHREADS) {
      const int r = idx / DP, c = idx - (idx / DP) * DP;
      const int n = n0 + r;
      dst[r * ld + c] = (c < d && n < n_end) ? me::load1(base + (long long)n * sn + c) : 0.f;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS) split_attention_kernel(Params p) {
  using S = Smem<DP>;
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
  const int g = blockIdx.z;
  const int d = p.d;

  const T* qg = static_cast<const T*>(p.q.ptr) + g * p.q.sg + h * p.q.sh;
  load_rows<T, DP, BQ>(Qs, S::QST, qg, p.q.sn, q0, p.Nq, d, p.vec);
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

  const int npass = p.mode == INJECTION ? 2 : 1;
  for (int pass = 0; pass < npass; ++pass) {
    const bool masked = p.mode == INJECTION && pass == 0;
    const View kv = pass == 0 ? p.k : p.k2;
    const View vv = pass == 0 ? p.v : p.v2;
    const int nk = pass == 0 ? p.Nk : p.Nt;
    const T* kg = static_cast<const T*>(kv.ptr) + g * kv.sg + h * kv.sh;
    const T* vg = static_cast<const T*>(vv.ptr) + g * vv.sg + h * vv.sh;
    const float* mrow = masked ? p.mask + (size_t)(g % p.F) * p.Nk : nullptr;

    for (int k0 = 0; k0 < nk; k0 += BK) {
      __syncthreads();  // the previous tile's readers of Ks/Vs/Ss are done
      load_rows<T, DP, BK>(Ks, S::KST, kg, kv.sn, k0, nk, d, p.vec);
      load_rows<T, DP, BK>(Vs, S::VST, vg, vv.sn, k0, nk, d, p.vec);
      if (tid < BK) Mk[tid] = (masked && k0 + tid < nk) ? mrow[k0 + tid] : 0.f;
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
        const int nvalid = min(BK, nk - k0);
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
          const float vx = Vs[j * S::VST + tx + 8 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vx, acc[i][c]);
        }
      }
    }
  }
  __syncthreads();

  T* og = const_cast<T*>(static_cast<const T*>(p.out.ptr)) + g * p.out.sg + h * p.out.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int n = q0 + r;
    if (n < p.Nq) {
      const float inv = 1.f / row_l[r];
      T* orow = og + (long long)n * p.out.sn;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 8 * c;
        if (col < d) me::store1(orow + col, acc[i][c] * inv);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Smem<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      split_attention_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Nq + BQ - 1) / BQ, p.H, p.G);
  split_attention_kernel<T, DP><<<grid, NTHREADS, smem, stream>>>(p);
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
  if (p.d <= 192) return launch<T, 192>(p, stream);
  return launch<T, MAX_D>(p, stream);
}

View make_view(const void* ptr, const long long* s) { return View{ptr, s[0], s[1], s[2]}; }

bool rows_aligned(const View& x) {
  return reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0 && x.sg % 8 == 0 && x.sh % 8 == 0 &&
         x.sn % 8 == 0;
}

}  // namespace

// mode: 0 flash (K8), 1 injection (K9). dtype: 0 float32, 1 bfloat16.
// strides: 18 element strides, (G, H, N) of q, k, v, k2, v2, out in turn.
// K8 ignores k2, v2, mask, Nt and F. Returns a cudaError_t code (0 = launched).
extern "C" int me_split_attention(const void* q, const void* k, const void* v, const void* k2,
                                  const void* v2, const float* mask, void* out,
                                  const long long* strides, int G, int H, int Nq, int Nk, int Nt,
                                  int F, int d, float scale, int mode, int dtype, void* stream) {
  const bool inj = mode == INJECTION;
  if (d < 1 || d > MAX_D || (mode != FLASH && !inj) || G < 1 || G > 65535 || H < 1 ||
      H > 65535 || Nq < 1 || Nk < 1 || (inj && (Nt < 1 || F < 1 || mask == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = make_view(q, strides);
  p.k = make_view(k, strides + 3);
  p.v = make_view(v, strides + 6);
  p.k2 = make_view(k2, strides + 9);
  p.v2 = make_view(v2, strides + 12);
  p.out = make_view(out, strides + 15);
  p.mask = mask;
  p.G = G;
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.Nt = inj ? Nt : 0;
  p.F = inj ? F : 1;
  p.d = d;
  p.scale_log2 = scale * me::kLog2e;
  p.mode = mode;
  p.vec = d % 8 == 0 && rows_aligned(p.q) && rows_aligned(p.k) && rows_aligned(p.v) &&
          (!inj || (rows_aligned(p.k2) && rows_aligned(p.v2)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, st) : dispatch<__nv_bfloat16>(p, st);
  return (int)err;
}
