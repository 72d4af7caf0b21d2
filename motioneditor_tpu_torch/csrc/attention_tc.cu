// bf16 tensor-core bodies of the packed video attention (K1), its
// residual-saving forward (K4), the split-head flash attention (K8), the
// explicit-K/V video attention (K12), the fg/bg injection attention (K2),
// its explicit-K/V twin (K13) and its split-head twin (K9); the mainloop is
// attention_tc.cuh.
//
// Replaces (TPU / Pallas):
//   K1  motioneditor_tpu/ops/video_flash.py  _video_flash
//       (_kernel_nomax / _kernel_maxsafe, pallas_call at video_flash.py:248)
//       here in bf16 with d % 8 == 0, d <= 160; fp32 stays on the CUDA-core
//       body of video_attention.cu
//   K4  motioneditor_tpu/ops/video_flash_bwd.py  video_flash_fwd_res
//       (pallas_call at video_flash_bwd.py:229) here in bf16 with K1's rule;
//       fp32 stays on video_attention.cu. K1's mainloop, whose epilogue also
//       writes (m + log2 l) * ln 2 of every valid row (the lse instantiation,
//       attention_tc_lse_kernel; K1's own code is unchanged)
//   K8  motioneditor_tpu/ops/flash_attention.py  _flash_3d
//       (_flash_kernel / _flash_kernel_nomax, pallas_call at flash_attention.py:222)
//       here in bf16 when every row is 16-byte aligned, d % 8 == 0 and
//       d <= 160; the rest stays on split_attention.cu
//   K12 motioneditor_tpu/ops/video_flash.py  _video_flash_kv
//       (pallas_call at video_flash.py:726) here in bf16 with d % 8 == 0,
//       d <= 160; fp32 stays on video_attention.cu
//   K2  motioneditor_tpu/ops/video_flash.py  _video_injection
//       (_inj_kernel_nomax / _inj_kernel_maxsafe, pallas_call at :591) and
//   K13 motioneditor_tpu/ops/video_flash.py  _video_injection_kv
//       (pallas_call at :859) here in bf16 with K1's rule: the injection
//       instantiation (attention_tc_inj_kernel); fp32 stays on
//       video_attention.cu
//   K9  motioneditor_tpu/ops/injection_flash.py  _fused_3d
//       (pallas_call at injection_flash.py:268) here in bf16 with K8's rule
//       and K/V not broadcast over G: K13's launch of the injection
//       instantiation on split-head views; the rest stays on
//       split_attention.cu
// The routing rule lives in Python (ops/video_flash.py tensor_core_body,
// ops/video_flash_bwd.py fwd_res_tensor_core_body), so the wrappers decide
// which body a launch takes; these entry points refuse what they cannot take
// rather than fall back.
//
// What it computes: softmax(q k^T * scale) v per (query row, head), exactly
// as the CUDA-core bodies do (an exact online softmax, running max in fp32,
// scores in log2 units), with P rounded to bf16 before P.V as the plain
// version rounds its probabilities to the value dtype.
//   K1  q, k, v, out [B, F, N, C], heads as a channel stride (C = H * d);
//       query frame f reads the K/V frames of its mode, N keys each:
//       normal [f] | sparse_causal [0, f-1] | motion_frame [f-1, f] |
//       dense [0..F-1], f-1 clamped to 0 (frame 0 reads frame 0 twice and
//       the duplicated keys keep their doubled weight).
//   K4  K1, and the fp32 log-sum-exp of the scaled scores [B, F, N, H].
//   K8  [G, H, N, D] views given by element strides, D contiguous; K/V may
//       broadcast over G (stride 0), the output is written through its
//       strides (the packed [..., N, H, D] order of the wrapper).
//   K12 q, out [B, F, N, C] over an explicit K/V [B, Fk, M, C] built by the
//       frame-sharded path: the [G, H, N, D] views of K1 with M keys per
//       K/V group, query group g reading K/V group g / kv_div.
//   K2  the edit rows' softmax over [K_src[f-1]*m, K_src[f-1]*(1-m),
//       K_src[f]*m, K_src[f]*(1-m), K_tgt[f]] with values [V_src[f-1] x2,
//       V_src[f] x2, V_tgt[f]], m the [F, N] fg mask row of the key's frame:
//       each source key is scored once and weighs its V row by the sum of
//       its two logits' exponentials (attention_tc.cuh), so 3N keys are
//       scored, not 5N. Frame 0 reads frame 0 in both source passes.
//   K13 the same over an explicit source K/V [B, F, M, C] (one masked pass
//       of M keys, mask row [F, M] of the query's frame), then the N target
//       keys of frame f.
//   K9  K13's function on [G, H, N, D] views given by element strides (as
//       K8's), G = B * F: Ns source keys under the mask row [F, Ns] of the
//       query group's frame g % F, then Nt target keys.
//
// What bounds it on the H100. At the main path's shapes (N = 1024-4096
// queries against 2N keys, d = 40-80) attention is compute-bound: 4 * d
// flops per (query, key) against 4 * d bytes per key shared by a block's
// 128-256 queries. Both products run on the tensor cores as asynchronous warpgroup
// MMAs (wgmma, bf16 in, fp32 out) on tiles that TMA brings into shared
// memory while the previous ones are in use, and each warpgroup
// exponentiates tile t while the tensor cores run tile t-1's P.V. Left: at
// d = 40 the padded depth 48 wastes 1/6 of the mma work, and the softmax's
// exp2 (one MUFU op per score, 16 per clock per SM) costs more than the two
// products; the warpgroups are not scheduled against each other (no
// ping-pong), and the 16-byte column boxes fetch each 32-byte sector twice.
// K2's and K13's binary-mask tiles add one MUFU op per row and tile to
// K1's; a tile with a fractional mask value pays two per score.
#include "attention_tc.cuh"

namespace {

using me_tc::aligned;
using me_tc::bf16;
using me_tc::encode;
using me_tc::Params;
using me_tc::View;

bool head_dim_ok(int d) { return d >= 8 && d % 8 == 0 && d <= me_tc::MAX_D; }

// The injection variant's extra operands (K2, K13): the target rows' K/V
// ([G, H, Nt, D] views), the fp32 fg mask with mask_row floats per row, and
// the number of masked source passes before the target pass.
struct Injection {
  View k, v;
  const float* mask;
  long long mask_row;
  int nsrc, Nt;
};

// q, k, v, out as [G, H, N, D] views; K/V hold Nk keys per group and pass.
// Query group g reads K/V group g / kv_div (video_mode -1) or the frame of
// K1's mode (video_mode >= 0, kv_div 1).
// lse (nullptr: not written) is [G, N, H] fp32; inj (nullptr: none) makes
// the first inj->nsrc passes masked source passes and adds the target pass.
cudaError_t run(const View& q, const View& k, const View& v, const View& out, float* lse,
                int G, int H, int Nq, int Nk, int d, float scale, int npass, int video_mode,
                int F, int kv_div, cudaStream_t stream, const Injection* inj = nullptr) {
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out) || (k.sg == 0) != (v.sg == 0) ||
      kv_div < 1 || G % kv_div != 0)
    return cudaErrorInvalidValue;
  const int kv_groups = G / kv_div;
  Params p{};
  if (!encode(&p.mk, k, kv_groups, H, Nk, d, me_tc::BK) ||
      !encode(&p.mv, v, kv_groups, H, Nk, d, me_tc::BK))
    return cudaErrorInvalidValue;
  if (inj != nullptr) {
    if (!aligned(inj->k) || !aligned(inj->v) || inj->mask == nullptr || kv_div != 1 ||
        inj->Nt < 1 || npass != inj->nsrc + 1 ||
        !encode(&p.mk2, inj->k, G, H, inj->Nt, d, me_tc::BK) ||
        !encode(&p.mv2, inj->v, G, H, inj->Nt, d, me_tc::BK))
      return cudaErrorInvalidValue;
    p.mask = inj->mask;
    p.mrs = inj->mask_row;
    p.nsrc = inj->nsrc;
    p.Nt = inj->Nt;
  }
  p.out = const_cast<bf16*>(out.ptr);
  p.osg = out.sg;
  p.osh = out.sh;
  p.osn = out.sn;
  p.lse = lse;
  p.lsg = (long long)Nq * H;
  p.lsh = 1;
  p.lsn = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.d = d;
  p.scale_log2 = scale * me::kLog2e;
  p.npass = npass;
  p.video_mode = video_mode;
  p.F = F;
  p.kv_div = kv_div;
  return me_tc::with_padded_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const int bq = inj != nullptr ? me_tc::Shape<DP, true>::BQ : me_tc::Shape<DP>::BQ;
    if (!encode(&p.mq, q, G, H, Nq, d, bq)) return cudaErrorInvalidValue;
    return me_tc::launch<DP>(p, H, G, stream);
  });
}

}  // namespace

// K1, bf16. mode: 0 normal, 1 sparse_causal, 2 motion_frame, 3 dense.
// Returns a cudaError_t code (0 = launched).
extern "C" int me_video_attention_tc(const void* q, const void* k, const void* v, void* out,
                                     int B, int F, int N, int H, int d, float scale, int mode,
                                     void* stream) {
  if (!head_dim_ok(d) || mode < 0 || mode > 3 || B < 1 || F < 1 || N < 1 || H < 1 ||
      B * F > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)H * d;
  auto view = [&](const void* ptr) {
    return View{static_cast<const bf16*>(ptr), (long long)N * C, d, C};
  };
  return (int)run(view(q), view(k), view(v), view(out), nullptr, B * F, H, N, N, d, scale,
                  me::num_passes(mode, F), mode, F, 1, static_cast<cudaStream_t>(stream));
}

// K4, bf16: K1 that also writes lse [B, F, N, H] fp32 (natural log) for the
// backward (attention_dq_tc.cu, attention_bwd_tc.cu). mode: 0 normal,
// 1 sparse_causal, 2 motion_frame, 3 dense. Returns a cudaError_t code.
extern "C" int me_video_attention_fwd_res_tc(const void* q, const void* k, const void* v,
                                             void* out, float* lse, int B, int F, int N, int H,
                                             int d, float scale, int mode, void* stream) {
  if (!head_dim_ok(d) || mode < 0 || mode > 3 || lse == nullptr || B < 1 || F < 1 || N < 1 ||
      H < 1 || B * F > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)H * d;
  auto view = [&](const void* ptr) {
    return View{static_cast<const bf16*>(ptr), (long long)N * C, d, C};
  };
  return (int)run(view(q), view(k), view(v), view(out), lse, B * F, H, N, N, d, scale,
                  me::num_passes(mode, F), mode, F, 1, static_cast<cudaStream_t>(stream));
}

// K12, bf16: q, out [B, F, N, C] against the explicit K/V [B, Fk, M, C],
// Fk in {1, F}; query frame f reads K/V frame (Fk == 1 ? 0 : f), i.e. K/V
// group (b*F + f) / (Fk == 1 ? F : 1) of the [B*Fk, H, M, d] view.
// Returns a cudaError_t code (0 = launched).
extern "C" int me_video_attention_kv_tc(const void* q, const void* k, const void* v, void* out,
                                        int B, int F, int N, int Fk, int M, int H, int d,
                                        float scale, void* stream) {
  if (!head_dim_ok(d) || B < 1 || F < 1 || N < 1 || M < 1 || H < 1 || (Fk != 1 && Fk != F) ||
      B * F > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)H * d;
  auto view = [&](const void* ptr, int rows) {
    return View{static_cast<const bf16*>(ptr), (long long)rows * C, d, C};
  };
  return (int)run(view(q, N), view(k, M), view(v, M), view(out, N), nullptr, B * F, H, N, M, d,
                  scale, 1, -1, F, Fk == 1 ? F : 1, static_cast<cudaStream_t>(stream));
}

// K2, bf16: q_tgt, k_src, v_src, k_tgt, v_tgt, out [B, F, N, C], mask [F, N]
// fp32 (the fg mask of the key's frame). Returns a cudaError_t code.
extern "C" int me_video_injection_tc(const void* q, const void* k_src, const void* v_src,
                                     const void* k_tgt, const void* v_tgt, const float* mask,
                                     void* out, int B, int F, int N, int H, int d, float scale,
                                     void* stream) {
  if (!head_dim_ok(d) || mask == nullptr || B < 1 || F < 1 || N < 1 || H < 1 ||
      B * F > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)H * d;
  auto view = [&](const void* ptr) {
    return View{static_cast<const bf16*>(ptr), (long long)N * C, d, C};
  };
  const Injection inj{view(k_tgt), view(v_tgt), mask, N, 2, N};
  return (int)run(view(q), view(k_src), view(v_src), view(out), nullptr, B * F, H, N, N, d,
                  scale, me::num_passes(me::INJECTION, F), me::INJECTION, F, 1,
                  static_cast<cudaStream_t>(stream), &inj);
}

// K13, bf16: q_tgt, k_tgt, v_tgt, out [B, F, N, C] against the explicit
// source K/V [B, Fk, M, C], Fk == F, whose fg mask [F, M] fp32 is the row of
// the query's frame. Returns a cudaError_t code.
extern "C" int me_video_injection_kv_tc(const void* q, const void* k_src, const void* v_src,
                                        const void* k_tgt, const void* v_tgt, const float* mask,
                                        void* out, int B, int F, int N, int Fk, int M, int H,
                                        int d, float scale, void* stream) {
  if (!head_dim_ok(d) || mask == nullptr || B < 1 || F < 1 || N < 1 || M < 1 || H < 1 ||
      Fk != F || B * F > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)H * d;
  auto view = [&](const void* ptr, int rows) {
    return View{static_cast<const bf16*>(ptr), (long long)rows * C, d, C};
  };
  const Injection inj{view(k_tgt, N), view(v_tgt, N), mask, M, 1, N};
  return (int)run(view(q, N), view(k_src, M), view(v_src, M), view(out, N), nullptr, B * F, H,
                  N, M, d, scale, 2, -1, F, 1, static_cast<cudaStream_t>(stream), &inj);
}

// K8, bf16. strides: 12 element strides, (G, H, N) of q, k, v, out in turn;
// K/V may broadcast over G (stride 0). Returns a cudaError_t code (0 = launched).
extern "C" int me_split_attention_tc(const void* q, const void* k, const void* v, void* out,
                                     const long long* strides, int G, int H, int Nq, int Nk,
                                     int d, float scale, void* stream) {
  if (!head_dim_ok(d) || G < 1 || G > 65535 || H < 1 || H > 65535 || Nq < 1 || Nk < 1)
    return (int)cudaErrorInvalidValue;
  auto view = [&](const void* ptr, const long long* s) {
    return View{static_cast<const bf16*>(ptr), s[0], s[1], s[2]};
  };
  return (int)run(view(q, strides), view(k, strides + 3), view(v, strides + 6),
                  view(out, strides + 9), nullptr, G, H, Nq, Nk, d, scale, 1, -1, 1,
                  strides[3] == 0 ? G : 1, static_cast<cudaStream_t>(stream));
}

// K9, bf16: q [G, H, Nq, D], k_src / v_src [G, H, Ns, D], k_tgt / v_tgt
// [G, H, Nt, D] and out as views given by element strides (18: (G, H, N) of
// q, k_src, v_src, k_tgt, v_tgt, out in turn; no K/V broadcast over G);
// G = B * frames, mask [frames, Ns] fp32, query group g reading row g % frames.
// Returns a cudaError_t code (0 = launched).
extern "C" int me_split_injection_tc(const void* q, const void* k_src, const void* v_src,
                                     const void* k_tgt, const void* v_tgt, const float* mask,
                                     void* out, const long long* strides, int G, int H, int Nq,
                                     int Ns, int Nt, int frames, int d, float scale,
                                     void* stream) {
  if (!head_dim_ok(d) || mask == nullptr || G < 1 || G > 65535 || H < 1 || H > 65535 ||
      Nq < 1 || Ns < 1 || Nt < 1 || frames < 1 || G % frames != 0 || strides[3] == 0 ||
      strides[6] == 0 || strides[9] == 0 || strides[12] == 0)
    return (int)cudaErrorInvalidValue;
  auto view = [&](const void* ptr, const long long* s) {
    return View{static_cast<const bf16*>(ptr), s[0], s[1], s[2]};
  };
  const Injection inj{view(k_tgt, strides + 9), view(v_tgt, strides + 12), mask, Ns, 1, Nt};
  return (int)run(view(q, strides), view(k_src, strides + 3), view(v_src, strides + 6),
                  view(out, strides + 15), nullptr, G, H, Nq, Ns, d, scale, 2, -1, frames, 1,
                  static_cast<cudaStream_t>(stream), &inj);
}
