// The bf16 tensor-core flash-attention mainloop shared by the packed video
// attention (K1), its residual-saving forward (K4, which also writes the
// log-sum-exp), the split-head flash attention (K8), the explicit-K/V
// video attention (K12) and the fg/bg injection attention with its
// explicit-K/V twin (K2, K13: the injection variant, below):
// attention_tc.cu. Its building blocks (mbarriers, TMA loads, wgmma, the
// tensor maps) also serve the flash backward's dK/dV (K6,
// attention_bwd_tc.cu) and dQ (K5, attention_dq_tc.cu).
//
// Every operand is a [G, H, N, D] view given by element strides, D
// contiguous (K1's packed [B, F, N, C] is the view G = B*F, strides
// (N*C, d, C)). One block owns 128-256 queries of one head and one group
// g, warp-specialised:
//   producer   one warp; one thread issues TMA tile loads (4-D tensor maps
//              over the views) into a ring of NS K/V stages, each stage
//              guarded by a "full" mbarrier (transaction bytes) and an
//              "empty" one (the consumers' release);
//   consumers  2-4 warpgroups of 64 query rows (Shape::WGS). Per 64-key tile:
//              S = Q K^T   wgmma m64n64k16, Q and K from shared memory;
//              softmax     exact online softmax in log2 units: running max
//                          in fp32, keys past the pass's end at -inf;
//              O += P V    wgmma m64nNk16 with P rounded to bf16 in
//                          registers as the A operand (the S accumulator's
//                          layout is the A fragment's) and V from shared
//                          memory as an MN-major B.
// Shared tiles use the no-swizzle canonical layout: a tile of R rows is
// stored as D/8 column chunks of R x 16 bytes, so every 8 x 16-byte core
// matrix is 128 contiguous bytes; one TMA box {8 columns, R rows} fills one
// chunk. The head dim pads to DP, a multiple of 16 (the k depth of wgmma):
// chunks past d are zeroed once and never loaded, so no byte of another
// head is read; TMA zero-fills rows past a view's N (the next frame's
// tokens are never read), and those keys are masked before the max.
//
// The injection variant (INJ; K2, K13) runs nsrc masked source passes of
// Nk keys (K2: frames f-1 and f; K13: the explicit source) and then one
// target pass of Nt keys from the second pair of maps. A source key scored
// s' (log2 units) with fg mask m has the two logits m s' and (1 - m) s',
// both against its one V row: P = ex2(m s' - M) + ex2((1 - m) s' - M),
// summed in fp32 and rounded to bf16 once for the single P.V product; a
// key with m = 0 keeps its logit 0 (not -inf). The mask reaches the
// consumers through a slot of each ring stage: the producer warp loads the
// tile's 64 values from global memory (zero past the pass's end) and votes
// whether all are 0 or 1, then every lane arrives on the stage's "full"
// barrier (count 32), so the slot is ordered with the TMA bytes by the same
// barrier. Why a slot and not loads by the consumers: the 16 values a
// consumer needs per tile would sit in registers the d = 40 instantiation
// does not have, and 128 * WGS threads would issue the same loads. A binary
// tile (the pipeline's nearest-resized masks) has the logit pair {s', 0}
// for every key, whatever m is: P = ex2(s' - M) + ex2(-M), one MUFU op per
// score as in K1, the row max covering 0. Any fractional value sends the
// whole tile down the general path (two MUFU ops per score). Target tiles
// take K1's softmax.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace me_tc {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;   // keys per tile
constexpr int NS = 4;    // K/V stages: two held by the consumers, two in flight
constexpr int MAX_D = 160;

struct View {  // a [G, H, N, D] operand: element strides of G, H and N; D contiguous
  const bf16* ptr;
  long long sg, sh, sn;
};

struct Params {
  CUtensorMap mq, mk, mv;  // 4-D maps (D, N, H, G), box {8, rows, 1, 1}
  bf16* out;
  long long osg, osh, osn;
  float* lse;              // K4: the natural-log log-sum-exp of every (row, head),
  long long lsg, lsh, lsn; // element strides of G, H and N; nullptr: not written
  int Nq, Nk, d;     // Nk: keys of one pass
  float scale_log2;  // softmax scale * log2(e): scores live in log2 units
  int npass;         // passes over Nk keys each
  int video_mode;    // -1: K/V group g / kv_div (K8, K12); else K1's mode:
                     // group b*F + pass_frame(mode, pass, f)
  int F;
  int kv_div;        // query groups per K/V group: 1; K8's broadcast K/V: G (their
                     // maps have G = 1); K12 with one K/V frame per clip: F
  // the injection variant (K2, K13); unused elsewhere
  CUtensorMap mk2, mv2;  // the target rows' K/V, Nt keys per group
  const float* mask;     // fp32 fg mask rows, mrs floats apart: K2's row is the
  long long mrs;         // key's frame, K13's the query's frame
  int nsrc;              // masked source passes before the target pass: K2 2, K13 1
  int Nt;                // keys of the target pass
};

template <int DP, bool INJ = false>
struct Shape {
  // consumer warpgroups of 64 query rows: more of them share each K/V tile
  // (fewer L2 -> shared bytes per query) while their registers fit one
  // block per SM (ptxas allots a thread 65536 / (128 * (WGS + 1)) registers,
  // the producer warp counting as a warpgroup); the fastest of 2, 3 and 4
  // on the H100 at d = 40 and d = 80 (PERF.md), the injection variant's too
  // (one warpgroup fewer, without its spills, was slower at both)
  static constexpr int WGS = DP <= 48 ? 4 : DP <= 80 ? 3 : 2;
  static constexpr int BQ = 64 * WGS;             // queries per block
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int NTHREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int CH = DP / 8;               // 16-byte column chunks
  static constexpr int Q_BYTES = CH * BQ * 16;
  static constexpr int KV_BYTES = CH * BK * 16;   // one K or V tile
  static constexpr int PVN = DP <= 80 ? DP : DP / 2;  // N of one P.V wgmma
  static constexpr int NH = DP / PVN;
  // INJ: after the barriers, NS mask slots of BK floats, then NS binary flags
  static constexpr int MASK_OFF = Q_BYTES + 2 * NS * KV_BYTES + 80;
  static constexpr size_t bytes =
      INJ ? MASK_OFF + NS * (BK + 1) * 4 : Q_BYTES + 2 * NS * KV_BYTES + (2 * NS + 1) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one TMA box {8 columns, rows} of a 4-D map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// --- wgmma --------------------------------------------------------------------

// shared-memory matrix descriptor, no swizzle: start, leading- and
// stride-dimension byte offsets (K-major: LBO between the two 8-column core
// matrices of a k16 slice, SBO between 8-row groups; MN-major: LBO between
// 8-row groups along K, SBO between 8-column groups along N)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers an asynchronous wgmma reads or writes: the compiler may
// neither move their accesses across this point nor reuse them before it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ME_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ME_D8(i) ME_D4(i), ME_D4(i + 4)

// S[64 x 64] (+)= A[64 x 16] . B[16 x 64], both K-major in shared memory;
// scale_d = 0 overwrites S
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ME_D8(0), ME_D8(8), ME_D8(16), ME_D8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// S[64 x 32] (+)= A[64 x 16] . B[16 x 32], both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : ME_D8(0), ME_D8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

// O[64 x N] += P[64 x 16] . V[16 x N]: P from registers, V MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ME_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ME_D8(0), ME_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : ME_D8(0), ME_D8(8), ME_D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ME_D8(0), ME_D8(8), ME_D8(16), ME_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : ME_D8(0), ME_D8(8), ME_D8(16), ME_D8(24), ME_D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ME_D8
#undef ME_D4

__device__ __forceinline__ float ex2(float x) {  // 2^x on the MUFU; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- the kernel ---------------------------------------------------------------

// The kernel's body; LSE also writes the log-sum-exp of every valid row
// (K4), INJ runs the injection variant (K2, K13); K1's, K8's and K12's
// instantiations compile neither.
template <int DP, bool LSE, bool INJ>
__device__ __forceinline__ void attention_body(const Params& p) {
  using S = Shape<DP, INJ>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* KVs = smem + S::Q_BYTES;  // stage s: K at 2s, V at 2s + 1 (KV_BYTES each)
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + 2 * NS * S::KV_BYTES);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;
  float* mslot = reinterpret_cast<float*>(smem + S::MASK_OFF);  // INJ: stage s at s * BK
  int* binary = reinterpret_cast<int*>(mslot + NS * BK);         // INJ: stage s's vote

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int BQ = S::BQ;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, g = blockIdx.z;
  const int dc = p.d / 8;
  const int tiles_per_pass = (p.Nk + BK - 1) / BK;
  // INJ: nsrc source passes of Nk keys, then the target pass of Nt keys
  const int src_tiles = INJ ? p.nsrc * tiles_per_pass : 0;
  const int ntiles = INJ ? src_tiles + (p.Nt + BK - 1) / BK : tiles_per_pass * p.npass;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, INJ ? 32 : 1);  // INJ: every producer lane stages mask values
      mbar_init(empty + s, S::CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the pad chunks (columns d..DP) are never loaded: zero them once
  if (dc < S::CH) {
    for (int i = tid; i < (S::CH - dc) * BQ; i += S::NTHREADS)
      reinterpret_cast<uint4*>(Qs + dc * BQ * 16)[i] = make_uint4(0, 0, 0, 0);
    for (int s = 0; s < 2 * NS; ++s)
      for (int i = tid; i < (S::CH - dc) * BK; i += S::NTHREADS)
        reinterpret_cast<uint4*>(KVs + s * S::KV_BYTES + dc * BK * 16)[i] =
            make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    // ---- producer: one thread keeps the ring of K/V stages full (INJ: the
    // whole warp, which also stages each source tile's mask) ----
    if (INJ || lane == 0) {
      int b = 0, f = 0;
      if (INJ || p.video_mode >= 0) {
        b = g / p.F;
        f = g - b * p.F;
      }
      if (lane == 0) {
        mbar_expect_tx(qbar, dc * BQ * 16);
        for (int c = 0; c < dc; ++c) tma_load(Qs + c * BQ * 16, &p.mq, c * 8, q0, h, g, qbar);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % NS;
        if (t >= NS) mbar_wait(empty + s, ((t / NS) - 1) & 1);
        const bool target = INJ && t >= src_tiles;
        const int pass = target ? p.nsrc : t / tiles_per_pass;
        const int k0 = (target ? t - src_tiles : t - pass * tiles_per_pass) * BK;
        const int frame = p.video_mode >= 0 ? me::pass_frame(p.video_mode, pass, f) : f;
        const int grp = p.video_mode >= 0 ? b * p.F + frame : g / p.kv_div;
        if constexpr (INJ) {
          if (!target) {  // lane i stages keys k0 + 2i, k0 + 2i + 1 of the mask row
            const float* mrow = p.mask + (long long)(p.video_mode >= 0 ? frame : f) * p.mrs;
            const int c = k0 + 2 * lane;
            const float m0 = c < p.Nk ? mrow[c] : 0.f;
            const float m1 = c + 1 < p.Nk ? mrow[c + 1] : 0.f;
            const bool bin = __all_sync(0xffffffffu, (m0 == 0.f || m0 == 1.f) &&
                                                         (m1 == 0.f || m1 == 1.f));
            reinterpret_cast<float2*>(mslot + s * BK)[lane] = make_float2(m0, m1);
            if (lane == 0) binary[s] = bin;
          }
          if (lane != 0) {
            mbar_arrive(full + s);  // releases this lane's mask values
            continue;
          }
        }
        const CUtensorMap* mk = target ? &p.mk2 : &p.mk;
        const CUtensorMap* mv = target ? &p.mv2 : &p.mv;
        unsigned char* ks = KVs + 2 * s * S::KV_BYTES;
        mbar_expect_tx(full + s, 2 * dc * BK * 16);
        for (int c = 0; c < dc; ++c) {
          tma_load(ks + c * BK * 16, mk, c * 8, k0, h, grp, full + s);
          tma_load(ks + S::KV_BYTES + c * BK * 16, mv, c * 8, k0, h, grp, full + s);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows wg*64 .. wg*64+63 ----
  // Tile t's softmax runs while the tensor cores do tile t-1's P.V: per
  // iteration, issue S_t = Q K_t and O += P_{t-1} V_{t-1}, wait for S_t,
  // exponentiate it, wait for P.V, then rescale O and pack P_t.
  const int wg = tid / 128;
  const int quad = lane & 3;
  float o[S::NH][S::PVN / 2];
#pragma unroll
  for (int hh = 0; hh < S::NH; ++hh)
#pragma unroll
    for (int i = 0; i < S::PVN / 2; ++i) o[hh][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
  float sc[32];                             // S_t; column of sc[4j + e]: 8j + 2*quad + (e & 1),
                                            // row lane/4 + 8 * (e >> 1)
  uint32_t pa[BK / 16][4];                  // P_{t-1} as bf16 A fragments, one per 16 keys
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 16;
  auto kv_addr = [&](int t) { return smem_u32(KVs + 2 * (t % NS) * S::KV_BYTES); };

  auto issue_s = [&](int t) {  // S = Q K^T: DP/16 k-slices of two column chunks
    const uint32_t k_addr = kv_addr(t);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(sc, gmma_desc(q_addr + kk * 2 * BQ * 16, BQ * 16, 128),
                   gmma_desc(k_addr + kk * 2 * BK * 16, BK * 16, 128), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {  // O += P V: 4 k-slices of 16 keys
    const uint32_t v_addr = kv_addr(t) + S::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < S::NH; ++hh)
        wgmma_rs<S::PVN>(o[hh], pa[kk],
                         gmma_desc(v_addr + kk * 2 * 128 + hh * (S::PVN / 8) * BK * 16, 128,
                                   BK * 16));
    wgmma_commit();
  };
  // the running max of each row against this tile's max mx (raw scores; a
  // tile has a valid key): leaves the rescale factor in alpha, -max in m_sub
  float alpha[2];
  auto update_max = [&](float (&mx)[2], float (&m_sub)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 64 scores live in the 4 threads of a quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i] * p.scale_log2);  // finite: a tile has a key
      alpha[i] = ex2(m_run[i] - m_new);
      m_run[i] = m_new;
      m_sub[i] = -m_new;
    }
  };
  // exponentiate S_t, whose first nvalid keys are valid, in place against
  // the new running max
  auto softmax = [&](int nvalid) {
    if (nvalid < BK) {  // keys past the pass's end (zero-filled rows) at -inf
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + quad * 2 + (e & 1) >= nvalid) sc[4 * j + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float m_sub[2];
    update_max(mx, m_sub);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = ex2(fmaf(sc[i], p.scale_log2, m_sub[(i >> 1) & 1]));
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
  };
  // INJ: a source tile's softmax over the logit pairs (m s', (1 - m) s').
  // Keys past the pass's end score 0 (zero-filled rows, mask 0): they join
  // the max (harmless: a max only stabilises) and their P is dropped after
  // the exponentials, so full tiles pay no per-key test
  auto softmax_masked = [&](int t) {
    const int s = t % NS;
    float mx[2], m_sub[2], rs[2] = {0.f, 0.f};
    if (binary[s]) {  // every pair is {s', 0}: the max covers 0, P = ex2(s' - M) + ex2(-M)
      mx[0] = mx[1] = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      update_max(mx, m_sub);
      const float zero[2] = {ex2(m_sub[0]), ex2(m_sub[1])};  // the 0 logit's term
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = ex2(fmaf(sc[i], p.scale_log2, m_sub[(i >> 1) & 1])) + zero[(i >> 1) & 1];
        rs[(i >> 1) & 1] += sc[i];
      }
    } else {  // the general path: each key's two logits m s' and (1 - m) s'
      const float2* ms = reinterpret_cast<const float2*>(mslot + s * BK) + quad;  // + 4j
      mx[0] = mx[1] = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 m2 = ms[4 * j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float fg = sc[4 * j + e] * ((e & 1) ? m2.y : m2.x);
          mx[e >> 1] = fmaxf(mx[e >> 1], fmaxf(fg, sc[4 * j + e] - fg));
        }
      }
      update_max(mx, m_sub);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 m2 = ms[4 * j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float fg = sc[i] * ((e & 1) ? m2.y : m2.x);
          sc[i] = ex2(fmaf(fg, p.scale_log2, m_sub[e >> 1])) +
                  ex2(fmaf(sc[i] - fg, p.scale_log2, m_sub[e >> 1]));
          rs[e >> 1] += sc[i];
        }
      }
    }
    const int nvalid = min(BK, p.Nk - (t % tiles_per_pass) * BK);
    if (nvalid < BK) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + quad * 2 + (e & 1) >= nvalid) {
            rs[e >> 1] -= sc[4 * j + e];
            sc[4 * j + e] = 0.f;
          }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
  };
  auto tile_softmax = [&](int t) {
    if constexpr (INJ) {  // the target tiles take K1's softmax over Nt keys
      if (t < src_tiles)
        softmax_masked(t);
      else
        softmax(min(BK, p.Nt - (t - src_tiles) * BK));
    } else {
      const int pass = t / tiles_per_pass;
      softmax(min(BK, p.Nk - (t - pass * tiles_per_pass) * BK));
    }
  };
  auto pack_p = [&]() {  // P's A fragment of keys 16kk.. is S n-tiles 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  mbar_wait(qbar, 0);
  mbar_wait(full, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  tile_softmax(0);
  pack_p();
  for (int t = 1; t < ntiles; ++t) {
    mbar_wait(full + t % NS, (t / NS) & 1);
    wgmma_fence();  // o and pa were written by ordinary instructions
    issue_s(t);
    issue_pv(t - 1);
    wgmma_wait<1>();  // S_t has landed; P_{t-1} V_{t-1} may still run
    fence_regs(sc);
    tile_softmax(t);
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
#pragma unroll
    for (int hh = 0; hh < S::NH; ++hh) {
      fence_regs(o[hh]);
#pragma unroll
      for (int i = 0; i < S::PVN / 2; ++i) o[hh][i] *= alpha[(i >> 1) & 1];
    }
    mbar_arrive(empty + (t - 1) % NS);  // tile t-1's K and V are no longer read
    pack_p();
  }
  wgmma_fence();
  issue_pv(ntiles - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int hh = 0; hh < S::NH; ++hh) fence_regs(o[hh]);

  // epilogue: full row sums across the quad, then O / l as bf16 pairs
  float l[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l_run[i];
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  bf16* og = p.out + g * p.osg + (long long)h * p.osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + wg * 64 + (warp % 4) * 16 + (lane >> 2) + 8 * i;
    if constexpr (LSE) {  // m_run is in log2 units: lse = (m + log2 l) * ln 2
      if (quad == 0 && n < p.Nq)
        p.lse[g * p.lsg + h * p.lsh + n * p.lsn] = (m_run[i] + log2f(l[i])) * me::kLn2;
    }
    if (n < p.Nq) {
      bf16* orow = og + (long long)n * p.osn;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (j * 8 < p.d) {
          const float* oj = &o[j / (S::PVN / 8)][4 * (j % (S::PVN / 8))];
          *reinterpret_cast<uint32_t*>(orow + j * 8 + quad * 2) =
              pack_bf16(oj[2 * i] * inv[i], oj[2 * i + 1] * inv[i]);
        }
      }
    }
  }
}

// K1, K8, K12
template <int DP>
__global__ void __launch_bounds__(Shape<DP>::NTHREADS, 1)
    attention_tc_kernel(const __grid_constant__ Params p) {
  attention_body<DP, false, false>(p);
}

// K4: K1 that also writes the log-sum-exp (its own name in a profile)
template <int DP>
__global__ void __launch_bounds__(Shape<DP>::NTHREADS, 1)
    attention_tc_lse_kernel(const __grid_constant__ Params p) {
  attention_body<DP, true, false>(p);
}

// K2, K13: the injection variant (its own name in a profile)
template <int DP>
__global__ void __launch_bounds__(Shape<DP, true>::NTHREADS, 1)
    attention_tc_inj_kernel(const __grid_constant__ Params p) {
  attention_body<DP, false, true>(p);
}

// a launch of kernel, whose body's shape is S
template <class S>
cudaError_t launch_as(void (*kernel)(Params), const Params& p, int H, int G,
                      cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Nq + S::BQ - 1) / S::BQ, H, G);
  kernel<<<grid, S::NTHREADS, S::bytes, stream>>>(p);
  return cudaGetLastError();
}

// p.mq's box must hold Shape<DP, p.mask != nullptr>::BQ rows
template <int DP>
cudaError_t launch(const Params& p, int H, int G, cudaStream_t stream) {
  if (p.mask != nullptr)
    return launch_as<Shape<DP, true>>(attention_tc_inj_kernel<DP>, p, H, G, stream);
  auto* kernel = p.lse != nullptr ? attention_tc_lse_kernel<DP> : attention_tc_kernel<DP>;
  return launch_as<Shape<DP>>(kernel, p, H, G, stream);
}

template <int DP>
using Padded = std::integral_constant<int, DP>;

// fn(Padded<DP>{}) for the bucket DP that head dim d pads to
template <class Fn>
cudaError_t with_padded_dim(int d, Fn&& fn) {
  if (d <= 16) return fn(Padded<16>{});
  if (d <= 32) return fn(Padded<32>{});
  if (d <= 48) return fn(Padded<48>{});
  if (d <= 64) return fn(Padded<64>{});
  if (d <= 80) return fn(Padded<80>{});
  if (d <= 96) return fn(Padded<96>{});
  if (d <= 128) return fn(Padded<128>{});
  return fn(Padded<160>{});
}

// --- host side: tensor maps --------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda at first use (no -lcuda at link time)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

inline bool aligned(const View& x) {
  return reinterpret_cast<uintptr_t>(x.ptr) % 16 == 0 && x.sg % 8 == 0 && x.sh % 8 == 0 &&
         x.sn % 8 == 0;
}

// a 4-D map (D, N, H, G) of the view, box {8 columns, rows, 1, 1}, rows past
// N zero-filled. A view broadcast over G (stride 0) gets G = 1 and a stride
// that is never stepped.
inline bool encode(CUtensorMap* map, const View& x, int G, int H, int N, int d, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const long long sg = x.sg != 0 ? x.sg : (x.sn * N > x.sh * H ? x.sn * N : x.sh * H);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)N, (cuuint64_t)H,
                              (cuuint64_t)(x.sg != 0 ? G : 1)};
  const cuuint64_t strides[3] = {(cuuint64_t)x.sn * 2, (cuuint64_t)x.sh * 2, (cuuint64_t)sg * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x.ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace me_tc
