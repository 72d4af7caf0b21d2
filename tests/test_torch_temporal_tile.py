"""The tile geometry of the TMA-staged temporal attention bodies (K3 and
K14 forward, csrc/temporal_attention_tma.cu; K7 backward,
csrc/temporal_attention_bwd_tma.cu), on the CPU.

``temporal_tile`` (ops/temporal_flash.py) chooses each launch's tile in
Python, so these tests reach it without a card:
- every supported (F, d, heads, dtype, direction) gets a tile within the
  H100's 227 KB of shared memory and the TMA box limits, and so does K14's
  every (Fq, Fk) of a frame split, its bytes equal to the layout the C side
  (csrc/temporal_tma.cuh ``plan``) recomputes: an Fq-frame q slab, Fk-frame
  k and v slabs;
- K3's and K7's tiles (Fq = Fk) are the ones they took before K14 moved
  onto K3's body, pinned at the shapes the card runs;
- a walk of the tiles, written as the kernels index them (tile t ->
  (b, n0, h0), warp / pass / lane -> (site, head, frame)), writes every
  (b, f, n, c) of the output (K14's: of its Fq frames) exactly once, with a
  ragged last tile and with N smaller than one tile;
- a torch emulation of the one-pass K7 (rows: P, dS and dq; then columns:
  dk, dv from the same staged slabs), of K3 and of K14 over those tiles
  agrees with JAX's Pallas kernels in interpret mode (``_temporal_4d_bwd``,
  ``_temporal_4d``, and ``temporal_flash_attention_global`` at Fq = 2 of
  Fk = 8 frames, offsets 0, 2, 4, 6) on inputs made with numpy from a seed,
  fp32, atol 2e-5; the same emulation with one tile's last site dropped,
  with the causal column starting at f = g + 1, or with K14's key limit
  blind to the offset, fails that tolerance.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops.temporal_flash import _temporal_4d, _temporal_4d_bwd
from motioneditor_tpu.ops.temporal_flash import (
    temporal_flash_attention_global as jax_temporal_global,
)

from motioneditor_tpu_torch.ops.temporal_flash import (
    BOX_MAX,
    MAX_FRAMES,
    MAX_HEAD_DIM,
    PAIR_FRAMES,
    SMEM_LIMIT,
    TILE_WARPS,
    seq_threads,
    staged_kv_frames,
    temporal_flash_supported,
    temporal_tile,
    tile_smem_bytes,
)

from torch_port_helpers import normal, setup_torch

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_fits_the_card(dtype, backward):
    itemsize = torch.finfo(dtype).bits // 8
    for f, d, heads in itertools.product(range(1, MAX_FRAMES + 1),
                                         range(8, MAX_HEAD_DIM + 1, 8), (1, 4, 8)):
        assert temporal_flash_supported(f, heads * d, heads)
        t = temporal_tile(f, f, d, heads, dtype, backward)
        where = f"F={f} d={d} heads={heads} {t}"
        assert t.smem_bytes <= SMEM_LIMIT, where
        assert t.smem_bytes == tile_smem_bytes(f, f, d, t.sites, t.heads, t.rows, t.split,
                                               t.stages, t.warps, itemsize, backward), where
        assert t.smem_bytes == plan_bytes(f, f, d, t, itemsize, backward), where
        # TMA box {hg * d, sites, F}: each dimension <= 256 elements, the inner one
        # a multiple of 16 bytes
        assert heads % t.heads == 0 and t.heads * d <= BOX_MAX, where
        assert 1 <= t.sites <= BOX_MAX and f <= BOX_MAX, where
        assert t.heads * d * itemsize % 16 == 0, where
        # a ring of at least two stages; one or two frames per thread (two
        # only where K3 instantiates them, F <= 8; K7 takes one); a
        # power-of-two split with a chunk for each thread; a sequence's
        # threads in one warp; no warp without a sequence
        assert t.stages >= 2, where
        assert t.rows == 1 or (t.rows == 2 and f <= 8 and not backward), where
        assert t.split in (1, 2, 4, 8) and 8 * t.split <= d, where
        assert seq_threads(f, t.rows, t.split) <= 32, where
        spw = 32 // seq_threads(f, t.rows, t.split)
        assert 1 <= t.warps <= TILE_WARPS, where
        assert (t.warps - 1) * spw < t.sites * t.heads, where


def plan_bytes(fq, fk, d, t, itemsize, backward):
    """The shared bytes csrc/temporal_tma.cuh ``plan`` requires of a tile:
    per stage a 128-aligned q slab of Fq frames (and dO's), k and v slabs of
    Fk frames, then a barrier per stage; the backward adds, 16-aligned, the
    fp32 P and dS rows (Fq x (Fq + 1) each) of every sequence its warps hold."""
    w = t.heads * d
    slab_q = -(-fq * t.sites * w * itemsize // 128) * 128
    slab_kv = -(-fk * t.sites * w * itemsize // 128) * 128
    total = t.stages * (slab_q * (2 if backward else 1) + 2 * slab_kv) + 8 * t.stages
    if backward:
        spw = 32 // seq_threads(fq, t.rows, t.split)
        total = -(-total // 16) * 16 + t.warps * spw * 2 * fq * (fq + 1) * 4
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k14_tile_fits_the_card(dtype):
    """K14's tiles at the shard-local (Fq, Fk) of frame splits fit the card
    and equal ``plan``'s layout byte for byte; two query frames per thread
    only at Fk <= PAIR_FRAMES (``plan``'s condition), and only for K3's
    shape Fq = Fk."""
    itemsize = torch.finfo(dtype).bits // 8
    for fq, fk, d, heads in itertools.product((1, 2, 4), (4, 8, 16, 32),
                                              range(8, MAX_HEAD_DIM + 1, 8), (1, 4, 8)):
        t = temporal_tile(fq, fk, d, heads, dtype, False)
        where = f"Fq={fq} Fk={fk} d={d} heads={heads} {t}"
        assert t.smem_bytes <= SMEM_LIMIT, where
        assert t.smem_bytes == plan_bytes(fq, fk, d, t, itemsize, False), where
        assert t.smem_bytes == tile_smem_bytes(fq, fk, d, t.sites, t.heads, t.rows, t.split,
                                               t.stages, t.warps, itemsize, False), where
        assert t.rows == (2 if fq == fk <= PAIR_FRAMES else 1), where
        assert t.rows == 1 or fk <= PAIR_FRAMES, where
        assert heads % t.heads == 0 and t.heads * d <= BOX_MAX, where
        assert 1 <= t.sites <= BOX_MAX and t.heads * d * itemsize % 16 == 0, where
        assert t.stages >= 2 and t.split in (1, 2, 4, 8) and 8 * t.split <= d, where
        assert seq_threads(fq, t.rows, t.split) <= 32, where
        spw = 32 // seq_threads(fq, t.rows, t.split)
        assert 1 <= t.warps <= TILE_WARPS and (t.warps - 1) * spw < t.sites * t.heads, where


# (F, d, heads) -> the tiles of K3 and K7 in fp32 and bf16 (forward, backward in
# turn) before K14 took K3's body with a separate Fq and Fk: the shapes chip_smoke.py
# and the card tests run, with F = 1, 2, 3, 4, 8, 16, 17, 24, 32 and d = 8 to 160
K3_K7_TILES = {
    (1, 8, 4): [(64, 4, 2, 1, 2, 8, 49168), (44, 4, 1, 1, 2, 6, 48144),
                (64, 4, 2, 1, 2, 8, 24592), (64, 4, 1, 1, 2, 8, 36880)],
    (3, 8, 4): [(28, 4, 2, 1, 2, 7, 64528), (14, 4, 1, 1, 2, 6, 48784),
                (32, 4, 2, 1, 2, 8, 36880), (20, 4, 1, 1, 2, 8, 38416)],
    (1, 8, 1): [(256, 1, 2, 1, 2, 8, 49168), (176, 1, 1, 1, 2, 6, 48144),
                (256, 1, 2, 1, 2, 8, 24592), (256, 1, 1, 1, 2, 8, 36880)],
    (4, 8, 1): [(85, 1, 2, 1, 2, 6, 65296), (40, 1, 1, 1, 2, 5, 47376),
                (128, 1, 2, 1, 2, 8, 49168), (64, 1, 1, 1, 2, 8, 43024)],
    (8, 40, 8): [(2, 4, 2, 2, 2, 2, 61456), (1, 4, 1, 2, 2, 2, 43280),
                 (4, 4, 2, 2, 2, 4, 61456), (2, 4, 1, 2, 2, 4, 45584)],
    (8, 80, 8): [(2, 2, 2, 4, 2, 2, 61456), (1, 2, 1, 4, 2, 2, 42128),
                 (4, 2, 2, 4, 2, 4, 61456), (2, 2, 1, 4, 2, 4, 43280)],
    (8, 160, 8): [(2, 1, 2, 4, 2, 1, 61456), (1, 1, 1, 4, 2, 1, 41552),
                  (4, 1, 2, 4, 2, 2, 61456), (2, 1, 1, 4, 2, 2, 42128)],
    (3, 160, 8): [(5, 1, 2, 4, 2, 2, 57616), (3, 1, 1, 4, 2, 2, 46480),
                  (11, 1, 2, 4, 2, 3, 63760), (6, 1, 1, 4, 2, 3, 46672)],
    (17, 160, 8): [(1, 1, 1, 1, 2, 1, 65296), (1, 1, 1, 1, 2, 1, 89504),
                   (2, 1, 1, 1, 2, 2, 65296), (1, 1, 1, 1, 2, 1, 46496)],
    (24, 80, 8): [(1, 1, 1, 1, 2, 1, 46096), (1, 1, 1, 1, 2, 1, 66256),
                  (1, 2, 1, 1, 2, 2, 46096), (1, 1, 1, 1, 2, 1, 35536)],
    (32, 160, 8): [(1, 1, 1, 1, 2, 1, 122896), (1, 1, 1, 1, 2, 1, 172304),
                   (1, 1, 1, 1, 2, 1, 61456), (1, 1, 1, 1, 2, 1, 90384)],
    (32, 8, 1): [(8, 1, 1, 1, 2, 8, 49168), (2, 1, 1, 1, 2, 2, 33296),
                 (8, 1, 1, 1, 2, 8, 24592), (3, 1, 1, 1, 2, 3, 37648)],
    (16, 40, 8): [(1, 4, 1, 2, 2, 4, 61456), (1, 2, 1, 2, 2, 2, 45328),
                  (2, 4, 1, 2, 2, 8, 61456), (1, 2, 1, 2, 2, 2, 24848)],
    (2, 40, 8): [(8, 4, 2, 2, 2, 2, 61456), (4, 4, 1, 2, 2, 2, 41744),
                 (17, 4, 2, 2, 2, 5, 65296), (9, 4, 1, 2, 2, 5, 48016)],
}


@pytest.mark.parametrize("f,d,heads", list(K3_K7_TILES))
def test_k3_k7_tiles_unchanged(f, d, heads):
    got = [tuple(temporal_tile(f, f, d, heads, dtype, backward))
           for dtype in (torch.float32, torch.bfloat16) for backward in (False, True)]
    assert got == K3_K7_TILES[(f, d, heads)]


def tiles(b, n, heads, t):
    """(b, n0, h0) of every tile, in the kernels' order (head groups fastest)."""
    site_tiles = -(-n // t.sites)
    groups = heads // t.heads
    for i in range(b * site_tiles * groups):
        rest, g = divmod(i, groups)
        yield rest // site_tiles, (rest % site_tiles) * t.sites, g * t.heads


def sequences(f, n, n0, t):
    """(frame, chunk part, site, head in the group) of every store of a tile's
    threads, in the kernels' order (pass j, warp, lane; csrc/temporal_tma.cuh
    ``Lanes``): a thread stores frame i and, with two rows, frame f - 1 - i
    when that is another frame."""
    group = seq_threads(f, t.rows, t.split)
    spw = 32 // group
    nseq = t.sites * t.heads
    passes = -(-nseq // (t.warps * spw))
    for j, warp, lane in itertools.product(range(passes), range(t.warps), range(32)):
        slot, r = divmod(lane, group)
        i, part = divmod(r, t.split)
        seq = (j * t.warps + warp) * spw + slot
        if slot >= spw or seq >= nseq:
            continue
        si, hh = divmod(seq, t.heads)
        if n0 + si < n:
            yield i, part, si, hh
            if t.rows == 2 and f - 1 - i > i:
                yield f - 1 - i, part, si, hh


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("f,d,heads", [(1, 8, 4), (3, 16, 4), (8, 40, 8), (8, 80, 8),
                                       (17, 160, 8), (32, 8, 1)])
def test_tile_walk_writes_every_output_once(f, d, heads, backward):
    b, c = 2, heads * d
    t = temporal_tile(f, f, d, heads, torch.float32, backward)
    for n in (2 * t.sites + 1, max(1, t.sites // 2)):  # a ragged last tile; under one tile
        writes = np.zeros((b, f, n, c), np.int32)
        for bi, n0, h0 in tiles(b, n, heads, t):
            for fi, part, si, hh in sequences(f, n, n0, t):
                lo = (h0 + hh) * d
                for c0 in range(8 * part, d, 8 * t.split):  # the chunks a thread stores
                    writes[bi, fi, n0 + si, lo + c0:lo + c0 + 8] += 1
        assert (writes == 1).all(), f"N={n} {t}: {np.unique(writes)}"


@pytest.mark.parametrize("fq,fk,d,heads", [(2, 8, 40, 8), (2, 8, 80, 8), (1, 32, 8, 4),
                                           (4, 16, 160, 8), (3, 24, 16, 4), (2, 4, 8, 1)])
def test_k14_tile_walk_writes_every_output_once(fq, fk, d, heads):
    """K14's threads cover the Fq query frames of its output once each."""
    b, c = 2, heads * d
    t = temporal_tile(fq, fk, d, heads, torch.float32, False)
    for n in (2 * t.sites + 1, max(1, t.sites // 2)):
        writes = np.zeros((b, fq, n, c), np.int32)
        for bi, n0, h0 in tiles(b, n, heads, t):
            for fi, part, si, hh in sequences(fq, n, n0, t):
                lo = (h0 + hh) * d
                for c0 in range(8 * part, d, 8 * t.split):
                    writes[bi, fi, n0 + si, lo + c0:lo + c0 + 8] += 1
        assert (writes == 1).all(), f"N={n} {t}: {np.unique(writes)}"


def _slab(x, bi, n0, h0, t, d):
    """The TMA box of a tile: [F, sites, hg, d] (F: x's frames), zero past N."""
    f, n = x.shape[1], x.shape[2]
    box = torch.zeros((f, t.sites, t.heads, d), dtype=x.dtype)
    rows = x[bi, :, n0:min(n, n0 + t.sites), h0 * d:(h0 + t.heads) * d]
    box[:, :rows.shape[1]] = rows.reshape(f, rows.shape[1], t.heads, d)
    return box


def _put(out, bi, n0, h0, t, d, value, dropped):
    """Stores a tile's [F, sites, hg, d] result at the rows below N, less the
    ``dropped`` sites."""
    n = out.shape[2]
    for si in range(t.sites):
        if n0 + si < n and si not in dropped:
            out[bi, :, n0 + si, h0 * d:(h0 + t.heads) * d] = value[:, si].flatten(1)


def emulate_bwd(q, k, v, do, scale, heads, causal, drop_site=False, column_shift=0):
    """K7 over the tiles ``temporal_tile`` gives: per tile, from the staged
    slabs, rows first (P and dS of row f, zero past the causal limit; dq_f as
    the row sum), then columns (dk_g, dv_g over rows f >= g + column_shift
    when causal). ``drop_site`` skips the last site of the first tile."""
    b, f, n, c = q.shape
    d = c // heads
    t = temporal_tile(f, f, d, heads, q.dtype, backward=True)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    fi = torch.arange(f)
    keep = fi[None, :] <= fi[:, None] if causal else torch.ones((f, f), dtype=torch.bool)
    cols = fi[:, None] >= fi[None, :] + column_shift if causal else keep
    for i, (bi, n0, h0) in enumerate(tiles(b, n, heads, t)):
        qs, ks, vs, gs = (_slab(x, bi, n0, h0, t, d) for x in (q, k, v, do))
        s = torch.einsum("fshd,gshd->shfg", qs, ks) * scale
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        dp = torch.einsum("fshd,gshd->shfg", gs, vs)
        ds = torch.where(keep, p * (dp - (p * dp).sum(-1, keepdim=True)) * scale, 0.0)
        p = torch.where(keep, p, 0.0)
        dropped = {t.sites - 1} if drop_site and i == 0 else set()
        _put(dq, bi, n0, h0, t, d, torch.einsum("shfg,gshd->fshd", ds, ks), dropped)
        ds_c, p_c = torch.where(cols, ds, 0.0), torch.where(cols, p, 0.0)
        _put(dk, bi, n0, h0, t, d, torch.einsum("shfg,fshd->gshd", ds_c, qs), dropped)
        _put(dv, bi, n0, h0, t, d, torch.einsum("shfg,fshd->gshd", p_c, gs), dropped)
    return dq, dk, dv


def emulate_fwd(q, k, v, scale, heads, causal, q_off=0, blind_offset=False, short_kv=False):
    """K3 (Fq = Fk, ``q_off`` 0) or K14 over the tiles ``temporal_tile``
    gives at Fq and the staged K/V frames (``staged_kv_frames``; one fewer
    with ``short_kv``), each tile's k and v slabs holding only those: query
    frame f keeps key frames g <= f + q_off when causal (g <= f with
    ``blind_offset``)."""
    b, fq, n, c = q.shape
    fs = staged_kv_frames(fq, k.shape[1], causal, q_off) - short_kv
    d = c // heads
    t = temporal_tile(fq, fs, d, heads, q.dtype, backward=False)
    out = torch.zeros_like(q)
    lim = torch.arange(fq) + (0 if blind_offset else q_off)
    keep = (torch.arange(fs)[None, :] <= lim[:, None] if causal
            else torch.ones((fq, fs), dtype=torch.bool))
    for bi, n0, h0 in tiles(b, n, heads, t):
        qs, ks, vs = (_slab(x, bi, n0, h0, t, d) for x in (q, k[:, :fs], v[:, :fs]))
        s = torch.einsum("fshd,gshd->shfg", qs, ks) * scale
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        _put(out, bi, n0, h0, t, d, torch.einsum("shfg,gshd->fshd", p, vs), set())
    return out


HEADS, C = 4, 64


def _case(f, seed, count):
    """Inputs [2, F, N, C] with N past two tiles and ragged."""
    t = temporal_tile(f, f, C // HEADS, HEADS, torch.float32, backward=True)
    n = 2 * t.sites + max(1, t.sites // 2)
    assert n % t.sites
    rng = np.random.default_rng(seed)
    return [normal(rng, (2, f, n, C)) for _ in range(count)], (C // HEADS) ** -0.5


def _max_err(got, ref):
    return max((a - torch.from_numpy(np.array(r))).abs().max().item()
               for a, r in zip(got, ref))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("f", [1, 3, 8])
def test_one_pass_backward_matches_jax(f, causal):
    arrays, scale = _case(f, 10 + f, 4)
    ref = _temporal_4d_bwd(*(jnp.asarray(a) for a in arrays), scale, HEADS, causal, True)
    got = emulate_bwd(*(torch.from_numpy(a) for a in arrays), scale, HEADS, causal)
    assert _max_err(got, ref) <= ATOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("f", [1, 3, 8])
def test_tiled_forward_matches_jax(f, causal):
    arrays, scale = _case(f, 20 + f, 3)
    ref = _temporal_4d(*(jnp.asarray(a) for a in arrays), scale, HEADS, causal, True)
    got = emulate_fwd(*(torch.from_numpy(a) for a in arrays), scale, HEADS, causal)
    assert _max_err([got], [ref]) <= ATOL


@pytest.mark.parametrize("fault", ["dropped site", "causal column from g + 1"])
def test_emulation_faults_fail_the_tolerance(fault):
    arrays, scale = _case(8, 18, 4)
    ref = _temporal_4d_bwd(*(jnp.asarray(a) for a in arrays), scale, HEADS, True, True)
    xs = [torch.from_numpy(a) for a in arrays]
    assert _max_err(emulate_bwd(*xs, scale, HEADS, True), ref) <= ATOL
    kw = {"drop_site": True} if fault == "dropped site" else {"column_shift": 1}
    assert _max_err(emulate_bwd(*xs, scale, HEADS, True, **kw), ref) > ATOL


FQ, FK, N_GLOBAL = 2, 8, 128  # K14: the shards of a 4-way split of 8 frames


def _global_case(seed):
    """q [2, Fq, N, C], k and v [2, Fk, N, C]; N a power of two (so JAX's
    Pallas kernel runs, not its fallback) and ragged against K14's tile."""
    for off in range(0, FK, FQ):  # every shard's tile leaves a ragged last tile
        fs = staged_kv_frames(FQ, FK, True, off)
        assert N_GLOBAL % temporal_tile(FQ, fs, C // HEADS, HEADS, torch.float32, False).sites
    rng = np.random.default_rng(seed)
    return ([normal(rng, (2, FQ, N_GLOBAL, C))]
            + [normal(rng, (2, FK, N_GLOBAL, C)) for _ in range(2)]), (C // HEADS) ** -0.5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offset", [0, 2, 4, 6])
def test_tiled_global_forward_matches_jax(offset, causal):
    arrays, scale = _global_case(30 + offset)
    ref = jax_temporal_global(*(jnp.asarray(a) for a in arrays), scale, HEADS, causal,
                              jnp.asarray(offset))
    got = emulate_fwd(*(torch.from_numpy(a) for a in arrays), scale, HEADS, causal, offset)
    assert _max_err([got], [ref]) <= ATOL


@pytest.mark.parametrize("fault", ["key limit blind to the offset", "one K/V frame short"])
def test_global_emulation_faults_fail_the_tolerance(fault):
    arrays, scale = _global_case(38)
    xs = [torch.from_numpy(a) for a in arrays]
    ref = jax_temporal_global(*(jnp.asarray(a) for a in arrays), scale, HEADS, True,
                              jnp.asarray(4))
    assert _max_err([emulate_fwd(*xs, scale, HEADS, True, 4)], [ref]) <= ATOL
    kw = {"blind_offset": True} if fault.startswith("key") else {"short_kv": True}
    assert _max_err([emulate_fwd(*xs, scale, HEADS, True, 4, **kw)], [ref]) > ATOL
