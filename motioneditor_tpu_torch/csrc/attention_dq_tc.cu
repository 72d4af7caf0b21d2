// bf16 tensor-core body of the flash backward's dQ (K5) of the packed-head
// video attention, for the modes normal / sparse_causal / motion_frame.
// Built from attention_tc.cuh's blocks (TMA tile loads through 4-D tensor
// maps, an mbarrier ring of K/V stages, wgmma).
//
// Replaces (TPU / Pallas):
//   K5  motioneditor_tpu/ops/video_flash_bwd.py  _dq_kernel  (pallas_call at :403)
//       here in bf16 with d % 8 == 0, d <= 80; fp32 and larger head dims
//       stay on the CUDA-core body of video_attention_bwd.cu. The routing
//       rule is Python (ops/video_flash_bwd.py dq_tensor_core_body); this
//       entry refuses what it cannot take rather than fall back.
//
// What it computes, per head h and target frame f, over the keys of the
// frames me::pass_frame(mode, pass, f) as the forward reads them, with lse
// from the forward (K4):
//   delta = rowsum(dO o O)              (written for K6, attention_bwd_tc.cu)
//   P     = exp(scale * Q K^T - lse)
//   dS    = P o (dO V^T - delta)
//   dQ    = scale * dS K                (in q's dtype)
// (dS rounded to bf16 before dS K, as JAX's _dq_kernel rounds it to the
// input dtype).
//
// Design. K6's problem with the roles swapped, on the forward's mainloop
// shape: a block owns 128 queries of one head and one (b, f), two consumer
// warpgroups of 64 query rows and a producer warp. The producer loads the
// block's Q and dO tiles once, then streams the source frames' 64-key K and
// V tiles into a ring of NS stages. The consumers read lse once per row,
// compute delta from the held dO tile and one read of O, then per key tile
//   S  = Q K^T       wgmma SS, Q and K K-major
//   dP = dO V^T      wgmma SS, dO and V K-major
//   P  = exp2(S scale_log2 - lse2); dS = P (dP - delta), packed to bf16
//                    A fragments (the accumulator's layout is the A fragment's)
//   dQ += dS K       wgmma RS, K as an MN-major B (the same shared tile)
// with tile t's exponentials computed while the tensor cores run tile t-1's
// dS K, as the forward overlaps its softmax with P V. The scale on dQ is
// applied once in the epilogue. Rows of Q / dO past N are zero-filled by TMA
// and get lse2 = +inf (P = 0); keys past a pass's end get P = 0; neither is
// ever written.
//
// Registers bound the shape: dQ takes DP / 2 fp32 a thread, S and dP 32
// each, dS's fragments 16; ptxas gives each thread of a 2-warpgroup block
// ~168 (PERF.md: registers and spills per padded d), hence d <= 80.
//
// What bounds it on the H100: the three products (6 * d flops per query,
// key and head) on the tensor cores, and the MUFU exp2 per score. Left:
// d = 40 pads to 48, the two warpgroups are not scheduled against each
// other, and the 16-byte column boxes fetch each 32-byte sector twice.
#include "attention_tc.cuh"

namespace {

using namespace me_tc;

constexpr int DQ_MAX_D = 80;

template <int DP>
struct DqShape {
  static constexpr int WGS = 2;                   // consumer warpgroups of 64 queries
  static constexpr int BQ = 64 * WGS;             // queries per block
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int NTHREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int CH = DP / 8;                // 16-byte column chunks
  static constexpr int Q_BYTES = CH * BQ * 16;     // the Q or the dO tile
  static constexpr int KV_BYTES = CH * BK * 16;    // one K or V tile
  static constexpr size_t bytes = 2 * Q_BYTES + 2 * NS * KV_BYTES + (2 * NS + 1) * 8;
};

struct DqParams {
  CUtensorMap mq, mdo, mk, mv;  // 4-D maps (D, N, H, B*F); Q / dO box BQ rows, K / V BK
  const bf16* out;              // O [B, F, N, C]
  const float* lse;             // [B, F, N, H], natural log
  float* delta;                 // [B, F, N, H]
  bf16* dq;                     // [B, F, N, C]
  int F, N, H, d, npass, mode;
  float scale, scale_log2;
};

template <int DP>
__global__ void __launch_bounds__(DqShape<DP>::NTHREADS, 1)
    attention_tc_dq_kernel(const __grid_constant__ DqParams p) {
  using S = DqShape<DP>;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + S::Q_BYTES;
  unsigned char* KVs = dOs + S::Q_BYTES;  // stage s: K at 2s, V at 2s + 1 (KV_BYTES each)
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + 2 * NS * S::KV_BYTES);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, g = blockIdx.z;  // g = b*F + f
  const int dc = p.d / 8;
  const int tiles_per_pass = (p.N + BK - 1) / BK;
  const int ntiles = tiles_per_pass * p.npass;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, S::CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the pad chunks (columns d..DP) are never loaded: zero them once
  if (dc < S::CH) {
    for (int i = tid; i < (S::CH - dc) * BQ; i += S::NTHREADS) {
      reinterpret_cast<uint4*>(Qs + dc * BQ * 16)[i] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(dOs + dc * BQ * 16)[i] = make_uint4(0, 0, 0, 0);
    }
    for (int s = 0; s < 2 * NS; ++s)
      for (int i = tid; i < (S::CH - dc) * BK; i += S::NTHREADS)
        reinterpret_cast<uint4*>(KVs + s * S::KV_BYTES + dc * BK * 16)[i] =
            make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    // ---- producer: Q and dO once, then the ring of K/V stages ----
    if (lane == 0) {
      const int b = g / p.F, f = g - b * p.F;
      mbar_expect_tx(qbar, 2 * dc * BQ * 16);
      for (int c = 0; c < dc; ++c) {
        tma_load(Qs + c * BQ * 16, &p.mq, c * 8, q0, h, g, qbar);
        tma_load(dOs + c * BQ * 16, &p.mdo, c * 8, q0, h, g, qbar);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % NS;
        if (t >= NS) mbar_wait(empty + s, ((t / NS) - 1) & 1);
        const int pass = t / tiles_per_pass, k0 = (t - pass * tiles_per_pass) * BK;
        const int grp = b * p.F + me::pass_frame(p.mode, pass, f);
        unsigned char* ks = KVs + 2 * s * S::KV_BYTES;
        mbar_expect_tx(full + s, 2 * dc * BK * 16);
        for (int c = 0; c < dc; ++c) {
          tma_load(ks + c * BK * 16, &p.mk, c * 8, k0, h, grp, full + s);
          tma_load(ks + S::KV_BYTES + c * BK * 16, &p.mv, c * 8, k0, h, grp, full + s);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows wg*64 .. wg*64+63 ----
  const int wg = tid / 128;
  const int quad = lane & 3;
  const long long C = (long long)p.H * p.d;
  int row[2], n[2];  // this thread's rows lane/4 and lane/4 + 8 of its warp's 16
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wg * 64 + (warp % 4) * 16 + (lane >> 2) + 8 * i;
    n[i] = q0 + row[i];
    const long long li = ((long long)g * p.N + n[i]) * p.H + h;
    lse2[i] = n[i] < p.N ? p.lse[li] * me::kLog2e : INFINITY;  // a row past N: P = 0
  }

  mbar_wait(qbar, 0);
  // delta = rowsum(dO o O): the quad's 4 threads share a row's 16-byte chunks
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float acc = 0.f;
    if (n[i] < p.N) {
      const bf16* orow = p.out + ((long long)g * p.N + n[i]) * C + (long long)h * p.d;
      for (int c = quad; c < dc; c += 4) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(dOs + c * BQ * 16 + row[i] * 16);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          acc = fmaf(of.x, df.x, fmaf(of.y, df.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta[i] = acc;
    if (quad == 0 && n[i] < p.N) p.delta[((long long)g * p.N + n[i]) * p.H + h] = acc;
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  float sc[32];  // S_t, then P_t; column of sc[4j + e]: 8j + 2*quad + (e & 1),
  float dp[32];  // row lane/4 + 8 * (e >> 1); dP_t, then dS_t
  uint32_t da[BK / 16][4];  // dS_{t-1} as bf16 A fragments, one per 16 keys
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 16;
  const uint32_t do_addr = smem_u32(dOs) + wg * 64 * 16;
  auto kv_addr = [&](int t) { return smem_u32(KVs + 2 * (t % NS) * S::KV_BYTES); };

  auto issue_s_dp = [&](int t) {  // S = Q K^T and dP = dO V^T: DP/16 k-slices each
    const uint32_t k_addr = kv_addr(t), v_addr = k_addr + S::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(sc, gmma_desc(q_addr + kk * 2 * BQ * 16, BQ * 16, 128),
                   gmma_desc(k_addr + kk * 2 * BK * 16, BK * 16, 128), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(dp, gmma_desc(do_addr + kk * 2 * BQ * 16, BQ * 16, 128),
                   gmma_desc(v_addr + kk * 2 * BK * 16, BK * 16, 128), kk > 0);
    wgmma_commit();
  };
  auto issue_dq = [&](int t) {  // dQ += dS K: 4 k-slices of 16 keys, K MN-major
    const uint32_t k_addr = kv_addr(t);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(dq, da[kk], gmma_desc(k_addr + kk * 2 * 128, 128, BK * 16));
    wgmma_commit();
  };
  auto grad_scores = [&](int t) {  // dp <- dS = P (dP - delta), P = 0 past the pass's end
    const int pass = t / tiles_per_pass;
    const int nvalid = min(BK, p.N - (t - pass * tiles_per_pass) * BK);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (e >> 1) & 1;
        float pr = ex2(fmaf(sc[4 * j + e], p.scale_log2, -lse2[i]));
        if (j * 8 + quad * 2 + (e & 1) >= nvalid) pr = 0.f;
        dp[4 * j + e] = pr * (dp[4 * j + e] - delta[i]);
      }
  };
  auto pack_ds = [&]() {  // dS's A fragment of keys 16kk.. is n-tiles 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
  };

  mbar_wait(full, 0);
  wgmma_fence();
  issue_s_dp(0);
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  grad_scores(0);
  pack_ds();
  for (int t = 1; t < ntiles; ++t) {
    mbar_wait(full + t % NS, (t / NS) & 1);
    wgmma_fence();  // dq and da were written by ordinary instructions
    issue_s_dp(t);
    issue_dq(t - 1);
    wgmma_wait<1>();  // S_t and dP_t have landed; dS_{t-1} K_{t-1} may still run
    fence_regs(sc);
    fence_regs(dp);
    grad_scores(t);
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(da[kk]);
    fence_regs(dq);
    mbar_arrive(empty + (t - 1) % NS);  // tile t-1's K and V are no longer read
    pack_ds();
  }
  wgmma_fence();
  issue_dq(ntiles - 1);
  wgmma_wait<0>();
  fence_regs(dq);

  // epilogue: scale * dQ as bf16 pairs; rows past N are not written
  bf16* dqg = p.dq + (long long)g * p.N * C + (long long)h * p.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (n[i] < p.N) {
      bf16* drow = dqg + (long long)n[i] * C;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (j * 8 < p.d)
          *reinterpret_cast<uint32_t*>(drow + j * 8 + quad * 2) =
              pack_bf16(dq[4 * j + 2 * i] * p.scale, dq[4 * j + 2 * i + 1] * p.scale);
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq(DqParams& p, const View& q, const View& k, const View& v,
                      const View& dout, int B, cudaStream_t stream) {
  using S = DqShape<DP>;
  const int G = B * p.F;
  if (!encode(&p.mq, q, G, p.H, p.N, p.d, S::BQ) ||
      !encode(&p.mdo, dout, G, p.H, p.N, p.d, S::BQ) ||
      !encode(&p.mk, k, G, p.H, p.N, p.d, BK) || !encode(&p.mv, v, G, p.H, p.N, p.d, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_tc_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + S::BQ - 1) / S::BQ, p.H, G);
  attention_tc_dq_kernel<DP><<<grid, S::NTHREADS, S::bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K5, bf16. mode: 0 normal, 1 sparse_causal, 2 motion_frame. q, k, v, out,
// dout, dq [B, F, N, C] bf16; lse (natural log) [B, F, N, H] fp32; writes dq
// and delta [B, F, N, H] fp32, which K6 reads. Returns a cudaError_t code
// (0 = launched).
extern "C" int me_video_attention_bwd_dq_tc(const void* q, const void* k, const void* v,
                                            const void* out, const void* dout, const float* lse,
                                            float* delta, void* dq, int B, int F, int N, int H,
                                            int d, float scale, int mode, void* stream) {
  if (d < 8 || d % 8 != 0 || d > DQ_MAX_D || mode < 0 || mode > 2 || B < 1 || F < 1 || N < 1 ||
      H < 1 || H > 65535 || (long long)B * F > 65535)
    return (int)cudaErrorInvalidValue;
  DqParams p{};
  p.out = static_cast<const bf16*>(out);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.F = F;
  p.N = N;
  p.H = H;
  p.d = d;
  p.npass = me::num_passes(mode, F);
  p.mode = mode;
  p.scale = scale;
  p.scale_log2 = scale * me::kLog2e;
  const long long C = (long long)H * d;
  auto view = [&](const void* ptr) {
    return View{static_cast<const bf16*>(ptr), (long long)N * C, d, C};
  };
  const View vq = view(q), vk = view(k), vv = view(v), vdo = view(dout), vo = view(out),
             vdq = view(dq);
  if (!aligned(vq) || !aligned(vk) || !aligned(vv) || !aligned(vdo) || !aligned(vo) ||
      !aligned(vdq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 16)
    err = launch_dq<16>(p, vq, vk, vv, vdo, B, st);
  else if (d <= 32)
    err = launch_dq<32>(p, vq, vk, vv, vdo, B, st);
  else if (d <= 48)
    err = launch_dq<48>(p, vq, vk, vv, vdo, B, st);
  else if (d <= 64)
    err = launch_dq<64>(p, vq, vk, vv, vdo, B, st);
  else
    err = launch_dq<80>(p, vq, vk, vv, vdo, B, st);
  return (int)err;
}
