"""Temporal self-attention over the frame axis on [B, F, N, C]
(port of motioneditor_tpu/ops/temporal_flash.py).

Kernels (CUDA C++):

  temporal_flash_attention      replaces _temporal_4d      (temporal_flash.py:208)
                                csrc/temporal_attention_tma.cu
  temporal_flash_attention_bwd  replaces _temporal_4d_bwd  (temporal_flash.py:190)
                                csrc/temporal_attention_bwd_tma.cu
  temporal_flash_attention_global
                                replaces _temporal_4d_bias (temporal_flash.py:361)
                                csrc/temporal_attention_tma.cu (K3's body)

Every spatial site and head is an independent length-F sequence; the
kernels keep the native layout (no transpose, no head split, no [.., F, F]
score tensor in device memory), compute the softmax in fp32 for any input
dtype, and never compute the causal pairs g > f. They stage each tile's
frame slabs in shared memory once, by TMA: the tile's geometry is chosen
here (``temporal_tile``), not in C++. Bound on the H100 and design notes:
see the .cu sources. Their boxes and 16-byte stores need every operand on a
16-byte boundary; the wrappers raise ``ValueError`` before any launch
otherwise.

Under autograd a CUDA call goes through ``TemporalFlashAttentionFn``, the
port of JAX's custom VJP (temporal_flash.py:286-305): the forward kernel
saves only (q, k, v) and the fused backward kernel recomputes the scores.

``temporal_flash_attention_global`` is the frame-sharded variant: q holds
the Fq local frames [q_offset, q_offset + Fq) of a shard, K/V all Fk
gathered frames, and the causal mask holds at global frame indices. It
takes the VJP of its plain version, as JAX's does (``kernel_with_xla_vjp``).

Each wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops import flop_count

MAX_FRAMES = 32
MAX_HEAD_DIM = 160
SMEM_LIMIT = 232448  # dynamic shared memory of one block on the H100 (227 KB)
BOX_MAX = 256  # elements of one TMA box dimension
# The tile rule's constants, from a sweep of tiles on the H100 (chip_variants.py
# --temporal, PERF.md): two stages beat three and four (a smaller ring leaves room
# for more blocks, hence warps, per SM), and a split leaving each thread >= 2
# chunks beat a wider one.
TILE_WARPS = 8  # warps of a block when the tile has work for them all
SMEM_TARGET = {False: 64 * 1024, True: 48 * 1024}  # bytes of a block: forward, backward
MAX_STAGES = 2  # the ring's depth
MAX_SPLIT = 4  # threads per (sequence, query frame), each on every split-th 8-channel chunk
PAIR_FRAMES = 8  # K3 at F <= this (its only two-row instantiation): frames f and F - 1 - f


def temporal_flash_supported(f: int, c: int, heads: int) -> bool:
    if c % heads:
        return False
    d = c // heads
    return d % 8 == 0 and d <= MAX_HEAD_DIM and 1 <= f <= MAX_FRAMES


class TemporalTile(NamedTuple):
    """A tile of the TMA-staged K3 / K7 / K14 bodies: ``sites`` consecutive
    sites x ``heads`` heads x all frames of one batch row; ``rows`` query
    frames per thread (1, or 2: f and Fq - 1 - f), ``split`` threads per
    (sequence, query frame); a ring of ``stages`` tiles per block of
    ``warps`` warps, ``smem_bytes`` of shared memory."""
    sites: int
    heads: int
    rows: int
    split: int
    stages: int
    warps: int
    smem_bytes: int


def _align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def seq_threads(fq: int, rows: int, split: int) -> int:
    """Threads of one (site, head) sequence of Fq query frames, all in one
    warp."""
    return -(-fq // rows) * split


def tile_smem_bytes(fq: int, fk: int, d: int, sites: int, hg: int, rows: int, split: int,
                    stages: int, warps: int, itemsize: int, backward: bool) -> int:
    """Shared bytes of a tile (the layout csrc/temporal_tma.cuh ``plan``
    checks): per stage a 128-aligned [Fq, sites, hg * d] slab of q (and of
    dO), then one [Fk, sites, hg * d] slab each of k and v, an mbarrier per
    stage, and for the backward (Fq = Fk) the fp32 P and dS rows, Fq x
    (Fq + 1) each, of the sequences its warps hold at once."""
    slab_q = _align(fq * sites * hg * d * itemsize, 128)
    slab_kv = _align(fk * sites * hg * d * itemsize, 128)
    total = stages * (slab_q * (2 if backward else 1) + 2 * slab_kv) + 8 * stages
    if backward:
        spw = 32 // seq_threads(fq, rows, split)
        total = _align(total, 16) + warps * spw * 2 * fq * (fq + 1) * 4
    return total


@functools.cache  # called at every launch with a handful of distinct shapes
def temporal_tile(fq: int, fk: int, d: int, heads: int, dtype: torch.dtype,
                  backward: bool) -> TemporalTile:
    """The tile K3 (``backward`` False, Fq = Fk), K14 (the forward at Fq
    local query frames against the Fk frames it stages, ``staged_kv_frames``)
    or K7 (Fq = Fk) launches with at head dim d and ``heads`` heads:
    - rows: for K3 two query frames per thread at F <= ``PAIR_FRAMES``
      (one load and conversion of each staged k or v chunk serves both),
      else one; K7 takes one (two measured slower), and so does K14 at
      Fq < Fk, whose short q slab leaves too few threads for its staged
      K/V bytes (at Fq = 2 of 8 frames two rows measured 1.4x slower);
    - split: threads per frame, the largest power of two up to
      ``MAX_SPLIT`` whose sequence still fits a warp and leaves two 8-channel
      chunks to each thread (one where d has fewer than four, and at
      Fq < Fk, where the wider split measured faster);
    - heads: the widest head group whose box row fits ``BOX_MAX`` elements
      and whose block (one site, ``MAX_STAGES`` stages) stays under
      ``SMEM_TARGET`` bytes;
    - sites: enough for one pass of ``TILE_WARPS`` warps (each holds
      32 // ``seq_threads`` sequences) as far as the block stays under that
      target;
    - stages: ``MAX_STAGES``, the whole block within ``SMEM_LIMIT``."""
    if not (1 <= fq <= MAX_FRAMES and 1 <= fk <= MAX_FRAMES and d % 8 == 0
            and 8 <= d <= MAX_HEAD_DIM) or (backward and fq != fk):
        raise ValueError(f"temporal_tile: unsupported Fq={fq}, Fk={fk}, d={d}")
    itemsize = torch.finfo(dtype).bits // 8
    rows = 2 if fq == fk <= PAIR_FRAMES and not backward else 1
    chunks = 2 if fq == fk else 1  # 8-channel chunks a split leaves each thread
    split = 1
    while (split < MAX_SPLIT and seq_threads(fq, rows, split * 2) <= 32
           and chunks * (split * 2) <= d // 8):
        split *= 2
    spw = 32 // seq_threads(fq, rows, split)

    def fit(sites, hg, stages):
        warps = min(TILE_WARPS, -(-sites * hg // spw))
        return warps, tile_smem_bytes(fq, fk, d, sites, hg, rows, split, stages, warps,
                                      itemsize, backward)

    for hg in sorted((h for h in range(1, heads + 1) if heads % h == 0 and h * d <= BOX_MAX),
                     reverse=True):
        sites = min(BOX_MAX, -(-TILE_WARPS * spw // hg))
        while sites > 1 and fit(sites, hg, MAX_STAGES)[1] > SMEM_TARGET[backward]:
            sites -= 1
        if fit(sites, hg, MAX_STAGES)[1] <= SMEM_TARGET[backward]:
            break
    warps, smem = fit(sites, hg, MAX_STAGES)
    if smem > SMEM_LIMIT:
        raise ValueError(f"temporal_tile: no tile fits at Fq={fq}, Fk={fk}, d={d}")
    return TemporalTile(sites, hg, rows, split, MAX_STAGES, warps, smem)


def temporal_flash_attention_plain(q, k, v, scale: float, heads: int, causal: bool = True):
    """Plain PyTorch version: fp32 scores over frame pairs, -inf above the
    diagonal when causal, fp32 softmax, P.V in the value dtype."""
    b, f, n, c = q.shape
    d = c // heads
    q5 = q.reshape(b, f, n, heads, d).float()
    k5 = k.reshape(b, f, n, heads, d).float()
    v5 = v.reshape(b, f, n, heads, d)
    s = torch.einsum("bfnhd,bgnhd->bnhfg", q5, k5) * scale
    if causal:
        keep = torch.tril(torch.ones((f, f), dtype=torch.bool, device=q.device))
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bnhfg,bgnhd->bfnhd", p, v5)
    return out.reshape(b, f, n, c)


def temporal_flash_attention_bwd_plain(q, k, v, do, scale: float, heads: int,
                                       causal: bool = True):
    """Plain PyTorch version of the backward, in fp32: P the softmax of the
    forward, dS = P o (dP - rowsum(P o dP)), dP = dO V^T; returns
    (dq, dk, dv) = (scale dS K, scale dS^T Q, P^T dO) in the input dtypes."""
    b, f, n, c = q.shape
    d = c // heads
    q5, k5, v5, g5 = (t.reshape(b, f, n, heads, d).float() for t in (q, k, v, do))
    s = torch.einsum("bfnhd,bgnhd->bnhfg", q5, k5) * scale
    if causal:
        keep = torch.tril(torch.ones((f, f), dtype=torch.bool, device=q.device))
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bfnhd,bgnhd->bnhfg", g5, v5)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bnhfg,bgnhd->bfnhd", ds, k5)
    dk = torch.einsum("bnhfg,bfnhd->bgnhd", ds, q5)
    dv = torch.einsum("bnhfg,bfnhd->bgnhd", p, g5)
    return tuple(t.reshape(b, f, n, c).to(x.dtype) for t, x in ((dq, q), (dk, k), (dv, v)))


def _check(name, q, heads, *others):
    if q.dim() != 4 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{name}: operands must share one [B, F, N, C] shape")
    b, f, n, c = q.shape
    if not temporal_flash_supported(f, c, heads):
        raise ValueError(f"{name}: unsupported F={f}, C={c}, heads={heads}")
    _build.check_operands(name, (q, *others))


def _check_aligned(name, *tensors):
    """The TMA boxes and the 16-byte stores of the bodies need every operand
    on a 16-byte boundary; contiguous with d % 8 == 0, its rows then are."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must start on a 16-byte boundary")


def temporal_flash_attention(q, k, v, scale: float, heads: int,
                             causal: bool = True) -> torch.Tensor:
    """Temporal attention over [B, F, N, C] in the native token layout;
    differentiable."""
    # per site F x F over all heads: 4 b n f f c
    flop_count.add_kernel_flops(4 * q.numel() * q.shape[1], "temporal_flash_attention")
    if q.device.type == "cpu":
        return temporal_flash_attention_plain(q, k, v, scale, heads, causal)
    _check("temporal_flash_attention", q, heads, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return TemporalFlashAttentionFn.apply(q, k, v, scale, heads, causal)
    return _temporal_kernel(q, k, v, scale, heads, causal)


def _temporal_kernel(q, k, v, scale, heads, causal):
    name = "temporal_flash_attention"
    _check_aligned(name, q, k, v)
    b, f, n, c = q.shape
    tile = temporal_tile(f, f, c // heads, heads, q.dtype, backward=False)
    out = torch.empty_like(q)
    code = _build.kernels().me_temporal_attention_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, f, f, n, heads, c // heads, float(scale), int(causal), 0, *tile,
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return out


def temporal_flash_attention_bwd(q, k, v, do, scale: float, heads: int, causal: bool = True):
    """(dq, dk, dv) of temporal_flash_attention for the output gradient
    ``do``, recomputing the scores from (q, k, v)."""
    if q.device.type == "cpu":
        return temporal_flash_attention_bwd_plain(q, k, v, do, scale, heads, causal)
    _check("temporal_flash_attention_bwd", q, heads, k, v, do)
    return _temporal_bwd_kernel(q, k, v, do, scale, heads, causal)


def _temporal_bwd_kernel(q, k, v, do, scale, heads, causal):
    name = "temporal_flash_attention_bwd"
    _check_aligned(name, q, k, v, do)
    b, f, n, c = q.shape
    tile = temporal_tile(f, f, c // heads, heads, q.dtype, backward=True)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    code = _build.kernels().me_temporal_attention_bwd_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, f, n, heads, c // heads, float(scale), int(causal), *tile,
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return dq, dk, dv


class TemporalFlashAttentionFn(torch.autograd.Function):
    """temporal_flash_attention with its fused backward: the forward saves
    (q, k, v) only. CUDA tensors launch the kernels; CPU tensors take their
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, heads: int, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, heads, causal)
        if q.device.type == "cpu":
            return temporal_flash_attention_plain(q, k, v, scale, heads, causal)
        return _temporal_kernel(q, k, v, scale, heads, causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        grads = temporal_flash_attention_bwd(q, k, v, dout.to(q.dtype).contiguous(), *ctx.args)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None)


def temporal_flash_attention_global_plain(q, k, v, scale: float, heads: int, causal: bool,
                                          q_offset: int):
    """Plain PyTorch version: fp32 scores of the Fq local query frames
    against all Fk frames, pair (f, g) kept iff g <= f + q_offset when
    causal, fp32 softmax, P.V in the value dtype."""
    b, fq, n, c = q.shape
    fk = k.shape[1]
    d = c // heads
    q5 = q.reshape(b, fq, n, heads, d).float()
    k5 = k.reshape(b, fk, n, heads, d).float()
    v5 = v.reshape(b, fk, n, heads, d)
    s = torch.einsum("bfnhd,bgnhd->bnhfg", q5, k5) * scale
    if causal:
        g = torch.arange(fk, device=q.device)
        f = torch.arange(fq, device=q.device) + q_offset
        s = s.masked_fill(g[None, :] > f[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bnhfg,bgnhd->bfnhd", p, v5)
    return out.reshape(b, fq, n, c)


def temporal_flash_attention_global(q, k, v, scale: float, heads: int, causal: bool,
                                    q_offset: int) -> torch.Tensor:
    """Temporal attention of the local frames q [B, Fq, N, C], global frames
    [q_offset, q_offset + Fq), over all frames k, v [B, Fk, N, C]; causal at
    global frame indices. Differentiable through the plain version's VJP."""
    from motioneditor_tpu_torch.ops.video_flash import KernelWithPlainVJP, needs_grad

    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return temporal_flash_attention_global_plain(q, k, v, scale, heads, causal, q_offset)
    name = "temporal_flash_attention_global"
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and K/V {tuple(k.shape)} do not fit")
    if (not temporal_flash_supported(k.shape[1], q.shape[3], heads) or q_offset < 0
            or q.shape[1] > MAX_FRAMES):
        raise ValueError(f"{name}: unsupported Fq={q.shape[1]}, Fk={k.shape[1]}, C={q.shape[3]}, "
                         f"heads={heads}, q_offset={q_offset}")
    _build.check_operands(name, (q, k, v))
    if needs_grad(q, k, v):
        return KernelWithPlainVJP.apply(
            lambda *t: _temporal_global_kernel(*t, scale, heads, causal, q_offset),
            lambda *t: temporal_flash_attention_global_plain(*t, scale, heads, causal,
                                                             q_offset), q, k, v)
    return _temporal_global_kernel(q, k, v, scale, heads, causal, q_offset)


def staged_kv_frames(fq: int, fk: int, causal: bool, q_offset: int) -> int:
    """The K/V frames K14's tiles stage: a causal query frame f reads key
    frames g <= f + q_offset, so only the first q_offset + Fq of them."""
    return min(fk, q_offset + fq) if causal else fk


def _temporal_global_kernel(q, k, v, scale, heads, causal, q_offset):
    """K14 on K3's body: the entry takes Fq query frames at global offset
    ``q_offset`` against Fk K/V frames and stages ``staged_kv_frames`` of
    them, with the tile ``temporal_tile`` gives at Fq and that count."""
    name = "temporal_flash_attention_global"
    _check_aligned(name, q, k, v)
    b, fq, n, c = q.shape
    fk = k.shape[1]
    tile = temporal_tile(fq, staged_kv_frames(fq, fk, causal, q_offset), c // heads, heads,
                         q.dtype, backward=False)
    out = torch.empty_like(q)
    code = _build.kernels().me_temporal_attention_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, fq, fk, n, heads, c // heads, float(scale), int(causal), q_offset, *tile,
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return out
