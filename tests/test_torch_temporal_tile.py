"""The tile geometry of the TMA-staged temporal attention bodies (K3
forward, csrc/temporal_attention_tma.cu; K7 backward,
csrc/temporal_attention_bwd_tma.cu), on the CPU.

``temporal_tile`` (ops/temporal_flash.py) chooses each launch's tile in
Python, so these tests reach it without a card:
- every supported (F, d, heads, dtype, direction) gets a tile within the
  H100's 227 KB of shared memory and the TMA box limits;
- a walk of the tiles, written as the kernels index them (tile t ->
  (b, n0, h0), warp / pass / lane -> (site, head, frame)), writes every
  (b, f, n, c) of the output exactly once, with a ragged last tile and with
  N smaller than one tile;
- a torch emulation of the one-pass K7 (rows: P, dS and dq; then columns:
  dk, dv from the same staged slabs) and of K3 over those tiles agrees with
  JAX's Pallas kernels in interpret mode (``_temporal_4d_bwd``,
  ``_temporal_4d``) on inputs made with numpy from a seed, fp32, atol 2e-5;
  the same emulation with one tile's last site dropped, or with the causal
  column starting at f = g + 1, fails that tolerance.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops.temporal_flash import _temporal_4d, _temporal_4d_bwd

from motioneditor_tpu_torch.ops.temporal_flash import (
    BOX_MAX,
    MAX_FRAMES,
    MAX_HEAD_DIM,
    SMEM_LIMIT,
    TILE_WARPS,
    seq_threads,
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
        t = temporal_tile(f, d, heads, dtype, backward)
        where = f"F={f} d={d} heads={heads} {t}"
        assert t.smem_bytes <= SMEM_LIMIT, where
        assert t.smem_bytes == tile_smem_bytes(f, d, t.sites, t.heads, t.rows, t.split,
                                               t.stages, t.warps, itemsize, backward), where
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
    t = temporal_tile(f, d, heads, torch.float32, backward)
    for n in (2 * t.sites + 1, max(1, t.sites // 2)):  # a ragged last tile; under one tile
        writes = np.zeros((b, f, n, c), np.int32)
        for bi, n0, h0 in tiles(b, n, heads, t):
            for fi, part, si, hh in sequences(f, n, n0, t):
                lo = (h0 + hh) * d
                for c0 in range(8 * part, d, 8 * t.split):  # the chunks a thread stores
                    writes[bi, fi, n0 + si, lo + c0:lo + c0 + 8] += 1
        assert (writes == 1).all(), f"N={n} {t}: {np.unique(writes)}"


def _slab(x, bi, n0, h0, t, d):
    """The TMA box of a tile: [F, sites, hg, d], zero past N."""
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
    t = temporal_tile(f, d, heads, q.dtype, backward=True)
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


def emulate_fwd(q, k, v, scale, heads, causal):
    """K3 over the tiles ``temporal_tile`` gives."""
    b, f, n, c = q.shape
    d = c // heads
    t = temporal_tile(f, d, heads, q.dtype, backward=False)
    out = torch.zeros_like(q)
    fi = torch.arange(f)
    keep = fi[None, :] <= fi[:, None] if causal else torch.ones((f, f), dtype=torch.bool)
    for bi, n0, h0 in tiles(b, n, heads, t):
        qs, ks, vs = (_slab(x, bi, n0, h0, t, d) for x in (q, k, v))
        s = torch.einsum("fshd,gshd->shfg", qs, ks) * scale
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        _put(out, bi, n0, h0, t, d, torch.einsum("shfg,gshd->fshd", p, vs), set())
    return out


HEADS, C = 4, 64


def _case(f, seed, count):
    """Inputs [2, F, N, C] with N past two tiles and ragged."""
    t = temporal_tile(f, C // HEADS, HEADS, torch.float32, backward=True)
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
