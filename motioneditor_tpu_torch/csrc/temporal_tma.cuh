// What the TMA-staged temporal attention bodies (K3 and K14 forward,
// temporal_attention_tma.cu; K7 backward, temporal_attention_bwd_tma.cu)
// share: the tile walk, the shared-memory layout, the 3-D tensor maps and
// the launch of a persistent grid.
//
// A tile is `sites` consecutive spatial sites x a group of `hg` heads x all
// frames of one batch row. Each operand's slab of the tile is one TMA box
// {hg*d channels, sites, F frames} of a 3-D tensor map over (C, N, B*F),
// started at (h0*d, n0, b*F) and stored densely as [F][sites][hg*d]: F = Fq
// for q and dO; for k and v the map spans the kv_frames of a batch row and
// the box its first Fk, the frames the queries read. The box
// zero-fills rows past N of a ragged last tile, whose outputs are never
// stored. The geometry (sites, hg, rows, split, stages, warps, shared bytes) is
// chosen in Python (ops/temporal_flash.py `temporal_tile`); the host side
// here recomputes the layout and refuses a launch whose bytes disagree.
#pragma once

#include <initializer_list>

#include "attention_tc.cuh"

namespace me_tt {

using me_tc::smem_u32;

constexpr int MAX_WARPS = 8;

struct Params {
  CUtensorMap mq, mk, mv, mdo;  // 3-D maps (C, N, B*F); mdo: the backward's dO
  void* o0;                     // forward: out; backward: dq
  void* o1;                     // backward: dk
  void* o2;                     // backward: dv
  int B, Fq, Fk, N, H, d, causal, q_off;
  int kv_frames;  // K/V frames of a batch row in memory; a tile stages the first Fk
  int sites, hg, rows, split, stages, warps;  // rows: query frames per thread (1 or 2);
                                              // split: threads per (sequence, frame)
  int site_tiles, groups, ntiles;  // tiles: B x site_tiles x groups, groups fastest
  int slab_q, slab_kv, slab_do;    // bytes of each slab in a stage, 128-aligned
  int stage_bytes, tx_bytes;       // bytes of a stage; bytes its TMA boxes bring
  int buf_off;                     // backward: offset of the P / dS rows
  float scale, scale_log2;
};

__host__ __device__ inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

// threads of one (site, head) sequence: ceil(Fq / rows) x split, all in one warp
__host__ __device__ inline int seq_threads(int fq, int rows, int split) {
  return (fq + rows - 1) / rows * split;
}

// sequences one warp holds at a time
__host__ __device__ inline int seqs_per_warp(int fq, int rows, int split) {
  return 32 / seq_threads(fq, rows, split);
}

// the backward's fp32 P and dS rows of one sequence, rows padded to F + 1
__host__ __device__ inline int seq_buf_floats(int f) { return 2 * f * (f + 1); }

// a 3-D box {hg*d, sites, F} of the map into shared memory
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

struct Tile {
  int b, n0, h0;
};

struct Seq {
  int si, hh;  // site in the tile, head in the group (0, 0 for a lane without one)
  bool store;  // the lane has a sequence and its row is below N
};

// A thread's place: lane = slot * seq_threads + i * split + part. Slot
// `slot` of the warp holds sequence (j * warps + warp) * spw + slot in pass j
// over the tile; the thread takes query frame i and, with rows = 2, frame
// Fq - 1 - i too (so a causal pair does F + 1 frame pairs whatever i is;
// the middle frame of an odd Fq has no partner: pair = false), and every
// split-th 8-channel chunk from `part`. Lanes past the last slot, and
// slots past the tile's sequences, compute on sequence 0 of the tile and
// store nothing, so every lane reaches the warp's shuffles.
struct Lanes {
  int warp, slot, f, f2, part, spw, passes;
  bool pair;  // f2 is a second frame of this thread (else f2 == f)
  __device__ __forceinline__ Lanes(const Params& p, int tid) {
    warp = tid >> 5;
    const int lane = tid & 31, group = seq_threads(p.Fq, p.rows, p.split);
    spw = 32 / group;
    slot = lane / group;
    const int r = lane - slot * group;
    f = r / p.split;
    part = r - f * p.split;
    pair = p.rows == 2 && p.Fq - 1 - f > f;
    f2 = pair ? p.Fq - 1 - f : f;
    const int nseq = p.sites * p.hg;
    passes = (nseq + p.warps * spw - 1) / (p.warps * spw);
  }
  __device__ __forceinline__ Seq seq(const Params& p, const Tile& x, int j) const {
    const int s = (j * p.warps + warp) * spw + slot;
    if (slot >= spw || s >= p.sites * p.hg) return {0, 0, false};
    const int si = s / p.hg;
    return {si, s - si * p.hg, x.n0 + si < p.N};
  }
};

// the full scores of a frame from its split threads' partial sums
template <int FMAX>
__device__ __forceinline__ void sum_parts(float (&v)[FMAX], int split) {
  for (int m = 1; m < split; m <<= 1) {
#pragma unroll
    for (int g = 0; g < FMAX; ++g) v[g] += __shfl_xor_sync(0xffffffffu, v[g], m);
  }
}

__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  const int g = t % p.groups;
  const int rest = t / p.groups;
  return {rest / p.site_tiles, (rest % p.site_tiles) * p.sites, g * p.hg};
}

// one elected thread: the boxes of tile t into stage `stage`, completing on `bar`
__device__ __forceinline__ void issue_tile(const Params& p, int t, unsigned char* stage,
                                           uint64_t* bar, bool with_do) {
  const Tile x = tile_of(p, t);
  me_tc::mbar_expect_tx(bar, p.tx_bytes);
  const int c0 = x.h0 * p.d;
  tma_load3(stage, &p.mq, c0, x.n0, x.b * p.Fq, bar);
  tma_load3(stage + p.slab_q, &p.mk, c0, x.n0, x.b * p.kv_frames, bar);
  tma_load3(stage + p.slab_q + p.slab_kv, &p.mv, c0, x.n0, x.b * p.kv_frames, bar);
  if (with_do) tma_load3(stage + p.slab_q + 2 * p.slab_kv, &p.mdo, c0, x.n0, x.b * p.Fq, bar);
}

// Barrier init and the first `stages` tiles of this block, by thread 0;
// returns the stage barriers (after the stages).
__device__ __forceinline__ uint64_t* ring_start(const Params& p, unsigned char* smem,
                                                bool with_do) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_bytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) me_tc::mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < p.stages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < p.ntiles) issue_tile(p, t, smem + s * p.stage_bytes, full + s, with_do);
    }
  }
  __syncthreads();
  return full;
}

// After every thread is done with the tile in stage `s` (a __syncthreads),
// thread 0 refills it with the tile `stages` turns later.
__device__ __forceinline__ void ring_refill(const Params& p, unsigned char* smem,
                                            uint64_t* full, int s, int t, bool with_do) {
  if (threadIdx.x == 0) {
    // the stage was read by ordinary loads; order them before the async writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int tn = t + p.stages * gridDim.x;
    if (tn < p.ntiles) issue_tile(p, tn, smem + s * p.stage_bytes, full + s, with_do);
  }
}

// ---- host side ---------------------------------------------------------------

inline bool encode3(CUtensorMap* map, const void* ptr, bool bf16, int C, int N, int BF, int box0,
                    int box1, int box2) {
  const me_tc::EncodeTiled fn = me_tc::encoder();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const int elt = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)BF};
  const cuuint64_t strides[2] = {(cuuint64_t)C * elt, (cuuint64_t)C * N * elt};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, (cuuint32_t)box2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Fills the geometry of p from the tile the caller chose and checks it:
// box limits (each box dimension <= 256, hg*d*elt a multiple of 16 bytes),
// hg dividing H, rows 1 (or 2 at Fk <= 8), split in {1, 2, 4, 8} with
// seq_threads <= 32, warps in
// [1, MAX_WARPS], and `smem_bytes` equal to the layout's: stages x (q, k,
// v[, dO] slabs) + a barrier per stage [+ the backward's P / dS rows for
// warps x seqs_per_warp sequences].
inline bool plan(Params& p, bool bf16, bool backward, int smem_bytes) {
  const int elt = bf16 ? 2 : 4, w = p.hg * p.d;
  if (p.d % 8 != 0 || p.hg < 1 || p.H % p.hg != 0 || w > 256 || p.sites < 1 ||
      p.sites > 256 || p.Fq < 1 || p.Fk < 1 || p.Fq > 32 || p.Fk > 32 || p.stages < 1 ||
      (p.split & (p.split - 1)) != 0 || p.split < 1 || p.split > 8 ||
      (p.rows != 1 && !(p.rows == 2 && p.Fk <= 8)) || seq_threads(p.Fq, p.rows, p.split) > 32 ||
      p.warps < 1 || p.warps > MAX_WARPS || p.B < 1 || p.N < 1 || p.q_off < 0)
    return false;
  p.slab_q = align_up(p.Fq * p.sites * w * elt, 128);
  p.slab_kv = align_up(p.Fk * p.sites * w * elt, 128);
  p.slab_do = backward ? p.slab_q : 0;
  p.stage_bytes = p.slab_q + 2 * p.slab_kv + p.slab_do;
  p.tx_bytes = ((backward ? 2 : 1) * p.Fq + 2 * p.Fk) * p.sites * w * elt;
  int bytes = p.stages * p.stage_bytes + 8 * p.stages;
  p.buf_off = 0;
  if (backward) {
    p.buf_off = align_up(bytes, 16);
    bytes = p.buf_off + p.warps * seqs_per_warp(p.Fq, p.rows, p.split) * seq_buf_floats(p.Fq) * 4;
  }
  p.site_tiles = (p.N + p.sites - 1) / p.sites;
  p.groups = p.H / p.hg;
  const long long tiles = (long long)p.B * p.site_tiles * p.groups;
  if (tiles > (1LL << 30)) return false;
  p.ntiles = (int)tiles;
  return bytes == smem_bytes;
}

// a persistent grid: as many blocks as fit on the card at once, at most one per tile
template <class Kernel>
cudaError_t launch_persistent(Kernel kernel, const Params& p, int smem_bytes,
                              cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * p.warps, smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(p.ntiles < most ? p.ntiles : most);
  kernel<<<grid, 32 * p.warps, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace me_tt
