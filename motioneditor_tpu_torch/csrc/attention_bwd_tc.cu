// bf16 tensor-core body of the flash backward's dK/dV partials (K6) of the
// packed-head video attention, for the modes normal / sparse_causal /
// motion_frame. Built from attention_tc.cuh's blocks (TMA tile loads through
// 4-D tensor maps, an mbarrier ring, wgmma).
//
// Replaces (TPU / Pallas):
//   K6  motioneditor_tpu/ops/video_flash_bwd.py  _dkv_kernel  (pallas_call at :437)
//       here in bf16 with d % 8 == 0, d <= 80; fp32 and larger head dims
//       stay on the CUDA-core body of video_attention_bwd.cu. The routing
//       rule is Python (ops/video_flash_bwd.py dkv_tensor_core_body); this
//       entry refuses what it cannot take rather than fall back.
//
// What it computes, per head h, target frame f and source slot (the frame
// me::pass_frame(mode, slot, f)), with lse from the forward (K4) and
// delta = rowsum(dO o O) from K5:
//   P^T  = exp(scale * K Q^T - lse)      (columns are queries)
//   dS^T = P^T o (V dO^T - delta)
//   dV   = P^T dO        dK = scale * dS^T Q
// as fp32 partials [B, F, S, N, C] that combine_partials scatters onto the
// source frames, exactly as the CUDA-core body writes them.
//
// Design. A block owns one (b, f, slot, head) and 128 keys, two consumer
// warpgroups of 64 keys each, and a producer warp. The producer loads the
// slot's K and V tiles once, then streams frame f's Q and dO tiles (BQ
// queries) into a ring of NS stages with, beside each, the tile's lse (in
// log2 units, +inf for rows past N so their P is 0) and delta, written by
// the producer lanes. Per query tile, each consumer warpgroup runs
//   S^T  = K Q^T       wgmma SS, K and Q K-major
//   dP^T = V dO^T      wgmma SS, V and dO K-major
//   P^T  = exp2(S^T scale_log2 - lse2), packed to bf16 A fragments
//   dV  += P^T dO      wgmma RS, dO as an MN-major B (the same shared tile)
//   dS^T = P^T (dP^T - delta), packed to bf16 A fragments
//   dK  += dS^T Q      wgmma RS, Q as an MN-major B
// (P and dS rounded to bf16 as JAX's _dkv_kernel rounds them to the input
// dtype) and releases the stage. The scale on dK is applied once in the
// epilogue. Rows of Q / dO past N are zero-filled by TMA and masked by
// lse2 = +inf; keys past N compute garbage rows that are never written.
//
// Registers bound the shape: dK and dV take DP fp32 registers a thread and
// ptxas gives each thread of a 2-warpgroup block ~168, so a tile has 64
// queries at padded d <= 48 and 32 above (S^T and dP^T take BQ registers).
//
// What bounds it on the H100: the four products (8 * d flops per query,
// key and head) on the tensor cores, and the MUFU exp2 per score. Left: the
// products of one warpgroup are not overlapped with its own softmax (the
// two warpgroups of a block interleave instead), d = 40 pads to 48, and
// lse / delta are loaded by the producer lanes, not by TMA.
#include "attention_tc.cuh"

namespace {

using namespace me_tc;

constexpr int DKV_MAX_D = 80;

template <int DP>
struct DkvShape {
  static constexpr int WGS = 2;                  // consumer warpgroups of 64 keys
  static constexpr int BKV = 64 * WGS;           // keys per block
  static constexpr int BQ = DP <= 48 ? 64 : 32;  // queries per tile
  static constexpr int NS = 4;                   // Q / dO stages
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int NTHREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int CH = DP / 8;                // 16-byte column chunks
  static constexpr int KV_BYTES = CH * BKV * 16;   // the K or the V tile
  static constexpr int QT_BYTES = CH * BQ * 16;    // one Q or dO tile
  // a stage: Q tile, dO tile, lse2[BQ], delta[BQ]
  static constexpr int STAGE_BYTES = 2 * QT_BYTES + 2 * BQ * 4;
  static constexpr size_t bytes = 2 * KV_BYTES + NS * STAGE_BYTES + (2 * NS + 1) * 8;
};

struct DkvParams {
  CUtensorMap mq, mdo, mk, mv;  // 4-D maps (D, N, H, B*F); Q / dO box BQ rows, K / V BKV
  const float* lse;             // [B, F, N, H], natural log
  const float* delta;           // [B, F, N, H]
  float* dk_part;               // [B, F, S, N, C]
  float* dv_part;
  int F, N, H, d, S, mode;
  float scale, scale_log2;
};

// S[64 x BQ] = A . B over DP / 16 k-slices, A (64 rows of a tile of `rows`
// rows) and B (BQ rows) both K-major in shared memory
template <int DP, int BQ>
__device__ __forceinline__ void product_ss(float (&d)[BQ / 2], uint32_t a_addr, int rows,
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t a = gmma_desc(a_addr + kk * 2 * rows * 16, rows * 16, 128);
    const uint64_t b = gmma_desc(b_addr + kk * 2 * BQ * 16, BQ * 16, 128);
    if constexpr (BQ == 64)
      wgmma_ss_n64(d, a, b, kk > 0);
    else
      wgmma_ss_n32(d, a, b, kk > 0);
  }
}

// D[64 x DP] += A[64 x BQ] . B[BQ x DP]: A as bf16 fragments of 16 columns,
// B an MN-major view of a K-major [BQ rows x DP] shared tile
template <int DP, int BQ>
__device__ __forceinline__ void product_rs(float (&d)[DP / 2], const uint32_t (&a)[BQ / 16][4],
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    wgmma_rs<DP>(d, a[kk], gmma_desc(b_addr + kk * 2 * 128, 128, BQ * 16));
}

template <int BQ>
__device__ __forceinline__ void pack(uint32_t (&a)[BQ / 16][4], const float (&x)[BQ / 2]) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int DP>
__global__ void __launch_bounds__(DkvShape<DP>::NTHREADS, 1)
    attention_tc_dkv_kernel(const __grid_constant__ DkvParams p) {
  using S = DkvShape<DP>;
  constexpr int BQ = S::BQ, BKV = S::BKV, NS = S::NS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + S::KV_BYTES;
  unsigned char* stages = Vs + S::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + NS * S::STAGE_BYTES);
  uint64_t* empty = full + NS;
  uint64_t* kvbar = empty + NS;
  auto q_tile = [&](int s) { return stages + s * S::STAGE_BYTES; };
  auto do_tile = [&](int s) { return stages + s * S::STAGE_BYTES + S::QT_BYTES; };
  // lse2 of the stage's BQ queries, then their delta
  auto rows_of = [&](int s) {
    return reinterpret_cast<float*>(stages + s * S::STAGE_BYTES + 2 * S::QT_BYTES);
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BKV, h = blockIdx.y, z = blockIdx.z;  // z = (b*F + f)*S + slot
  const int slot = z % p.S, bf = z / p.S;
  const int b = bf / p.F, f = bf - b * p.F;
  const int dc = p.d / 8;
  const int ntiles = (p.N + BQ - 1) / BQ;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 32);  // every producer lane, after its lse / delta stores
      mbar_init(empty + s, S::CONSUMERS);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the pad chunks (columns d..DP) are never loaded: zero them once
  if (dc < S::CH) {
    for (int i = tid; i < (S::CH - dc) * BKV; i += S::NTHREADS) {
      reinterpret_cast<uint4*>(Ks + dc * BKV * 16)[i] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(Vs + dc * BKV * 16)[i] = make_uint4(0, 0, 0, 0);
    }
    for (int s = 0; s < NS; ++s)
      for (int i = tid; i < (S::CH - dc) * BQ; i += S::NTHREADS) {
        reinterpret_cast<uint4*>(q_tile(s) + dc * BQ * 16)[i] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(do_tile(s) + dc * BQ * 16)[i] = make_uint4(0, 0, 0, 0);
      }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    // ---- producer warp: K / V once, then the ring of Q / dO stages ----
    if (lane == 0) {
      const int kv_grp = b * p.F + me::pass_frame(p.mode, slot, f);
      mbar_expect_tx(kvbar, 2 * dc * BKV * 16);
      for (int c = 0; c < dc; ++c) {
        tma_load(Ks + c * BKV * 16, &p.mk, c * 8, k0, h, kv_grp, kvbar);
        tma_load(Vs + c * BKV * 16, &p.mv, c * 8, k0, h, kv_grp, kvbar);
      }
    }
    const long long row0 = (long long)bf * p.N;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % NS;
      if (t >= NS) mbar_wait(empty + s, ((t / NS) - 1) & 1);
      float* rows = rows_of(s);
      for (int i = lane; i < BQ; i += 32) {
        const int n = t * BQ + i;
        const long long li = (row0 + n) * p.H + h;
        rows[i] = n < p.N ? p.lse[li] * me::kLog2e : INFINITY;  // a row past N: P = 0
        rows[BQ + i] = n < p.N ? p.delta[li] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full + s, 2 * dc * BQ * 16);  // lane 0's arrival
        for (int c = 0; c < dc; ++c) {
          tma_load(q_tile(s) + c * BQ * 16, &p.mq, c * 8, t * BQ, h, bf, full + s);
          tma_load(do_tile(s) + c * BQ * 16, &p.mdo, c * 8, t * BQ, h, bf, full + s);
        }
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + wg*64 .. k0 + wg*64 + 63 ----
  const int wg = tid / 128;
  const int quad = lane & 3;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  float sc[BQ / 2];  // S^T, then P^T: row (key) lane/4 + 8 * (e >> 1) of sc[4j + e],
  float dp[BQ / 2];  // column (query) 8j + 2*quad + (e & 1); dP^T, then dS^T
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T and dS^T as bf16 A fragments
  const uint32_t k_addr = smem_u32(Ks) + wg * 64 * 16;
  const uint32_t v_addr = smem_u32(Vs) + wg * 64 * 16;

  mbar_wait(kvbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NS;
    mbar_wait(full + s, (t / NS) & 1);
    const uint32_t q_addr = smem_u32(q_tile(s)), do_addr = smem_u32(do_tile(s));
    const float* rows = rows_of(s);
    wgmma_fence();
    product_ss<DP, BQ>(sc, k_addr, BKV, q_addr);
    product_ss<DP, BQ>(dp, v_addr, BKV, do_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], p.scale_log2, -rows[8 * j + 2 * quad + (e & 1)]));
    pack<BQ>(pa, sc);
    wgmma_fence();  // pa and dv were written by ordinary instructions
    product_rs<DP, BQ>(dv, pa, do_addr);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - rows[BQ + 8 * j + 2 * quad + (e & 1)]);
    pack<BQ>(da, dp);
    wgmma_fence();
    product_rs<DP, BQ>(dk, da, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    mbar_arrive(empty + s);  // this stage's tiles, lse and delta are no longer read
  }

  // epilogue: fp32 rows of the partials; keys past N are not written
  const long long C = (long long)p.H * p.d;
  const long long base = (long long)z * p.N * C + (long long)h * p.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = k0 + wg * 64 + (warp % 4) * 16 + (lane >> 2) + 8 * i;
    if (n < p.N) {
      float* dkr = p.dk_part + base + n * C;
      float* dvr = p.dv_part + base + n * C;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (j * 8 < p.d) {
          const int col = j * 8 + 2 * quad;
          *reinterpret_cast<float2*>(dkr + col) =
              make_float2(dk[4 * j + 2 * i] * p.scale, dk[4 * j + 2 * i + 1] * p.scale);
          *reinterpret_cast<float2*>(dvr + col) = make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

template <int DP>
cudaError_t launch_dkv(DkvParams& p, const View& q, const View& k, const View& v,
                       const View& dout, int B, cudaStream_t stream) {
  using S = DkvShape<DP>;
  const int G = B * p.F;
  if (!encode(&p.mq, q, G, p.H, p.N, p.d, S::BQ) || !encode(&p.mdo, dout, G, p.H, p.N, p.d, S::BQ) ||
      !encode(&p.mk, k, G, p.H, p.N, p.d, S::BKV) || !encode(&p.mv, v, G, p.H, p.N, p.d, S::BKV))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_tc_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + S::BKV - 1) / S::BKV, p.H, G * p.S);
  attention_tc_dkv_kernel<DP><<<grid, S::NTHREADS, S::bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K6, bf16. mode: 0 normal, 1 sparse_causal, 2 motion_frame. q, k, v, dout
// [B, F, N, C] bf16; lse (natural log) and delta [B, F, N, H] fp32; writes
// the fp32 partials [B, F, S, N, C], S = 1 (normal) or 2. Returns a
// cudaError_t code (0 = launched).
extern "C" int me_video_attention_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, float* dk_part, float* dv_part,
                                             int B, int F, int N, int H, int d, float scale,
                                             int mode, void* stream) {
  if (d < 8 || d % 8 != 0 || d > DKV_MAX_D || mode < 0 || mode > 2 || B < 1 || F < 1 || N < 1 ||
      H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  DkvParams p{};
  p.lse = lse;
  p.delta = delta;
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  p.F = F;
  p.N = N;
  p.H = H;
  p.d = d;
  p.S = me::num_passes(mode, F);
  p.mode = mode;
  p.scale = scale;
  p.scale_log2 = scale * me::kLog2e;
  if ((long long)B * F * p.S > 65535) return (int)cudaErrorInvalidValue;
  const long long C = (long long)H * d;
  auto view = [&](const void* ptr) {
    return me_tc::View{static_cast<const me_tc::bf16*>(ptr), (long long)N * C, d, C};
  };
  const me_tc::View vq = view(q), vk = view(k), vv = view(v), vdo = view(dout);
  if (!me_tc::aligned(vq) || !me_tc::aligned(vk) || !me_tc::aligned(vv) || !me_tc::aligned(vdo))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 16)
    err = launch_dkv<16>(p, vq, vk, vv, vdo, B, st);
  else if (d <= 32)
    err = launch_dkv<32>(p, vq, vk, vv, vdo, B, st);
  else if (d <= 48)
    err = launch_dkv<48>(p, vq, vk, vv, vdo, B, st);
  else if (d <= 64)
    err = launch_dkv<64>(p, vq, vk, vv, vdo, B, st);
  else
    err = launch_dkv<80>(p, vq, vk, vv, vdo, B, st);
  return (int)err;
}
