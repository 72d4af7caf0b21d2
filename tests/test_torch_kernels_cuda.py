"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in
a fixture, never at import). Run on a GPU host with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Shapes cover ragged token counts (not multiples of the 64-query / 32-key
tiles, nor of the tensor-core body's 128-query / 64-key ones), every
supported head-dim bucket and F up to 24 (32 for the temporal backward).
The TMA-staged temporal bodies (K3, K7) also run at the edges of their
tiles (ops/temporal_flash.py ``temporal_tile``): N one past a multiple of
the tile's sites, N under one tile, F = 1, d = 8 and d = 160, and K7 at
F = 32 with d = 160; K14, on K3's body, at Fq < Fk and global offsets
q_off > 0, N ragged against its own tile.
In bf16, K1, K2, K8, K9, K12, K13 and K4 run the tensor-core body
(csrc/attention_tc.cu; K2, K9 and K13 its injection instantiation) where
ops/video_flash.py ``tensor_core_body`` routes them (K9 with K/V not
broadcast over the lead dims), K5 and K6 their
own (csrc/attention_dq_tc.cu, csrc/attention_bwd_tc.cu) where
ops/video_flash_bwd.py ``dq_tensor_core_body`` and ``dkv_tensor_core_body``
do, and the tests whose names hold ``tc`` assert that they did. The split-head kernels (K8, K9)
also take strided head-split views, K/V broadcast over frames, and head
dims up to 256, d = 9 among them (element loads in place of 16-byte
vectors). The norm kernels (K10
pair statistics, K11 add + LayerNorm) run at the training path's shapes
and ragged ones, with their own tolerances stated at each test. The
frame-sharded path's kernels (K12 explicit-K/V attention, K13 explicit-K/V
injection, K14 global-offset temporal attention) run at the one-rank shapes
of SD-1.5 at 64x64 latents and at the shard-local shapes of a 4-way frame
split, forward and gradient through the wrapper. Forward
outputs: fp32 runs with TF32 off, atol 2e-5; bf16 atol
3e-2 plus rtol 1.6e-2 (torch's bf16 default: one bf16 ulp of an output of
magnitude 4 is already 0.031), on inputs whose logits stay far below the
JAX bf16 kernels' clamp of 60; the bf16 K1 and K8 cases are also held to
errors scaled to the reference (chip_smoke.py ``scaled_error``), since on
these inputs an output's RMS, about sqrt(e / keys), falls below that atol;
so are the bf16 K12 and K4 outputs, K2's, K9's and K13's (with binary,
fractional, all-0, all-1 and mixed masks, since every binary mask gives the
same output), K5's dQ against the fp32 plain dQ and K6's fp32 dK / dV
partials against the plain partials.
Gradients: fp32 rtol 1e-4, atol 1e-3; bf16 max error relative to the max
|gradient| < 0.06 (the tolerances of tests/test_video_flash_bwd.py).
"""

import pytest
import torch

from chip_smoke import (
    GROUP_NORM_BWD_FLOOR,
    GROUP_NORM_BWD_RATIO,
    GROUP_NORM_BWD_SHAPES,
    LOGIT_CAP,
    bf16_ulps,
    fg_mask,
    group_norm_backward_errors,
    logit_bound,
    phase_group_norm_backward,
    scaled_error,
    unet_group_norm_shapes,
)
from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops.attention import split_heads
from motioneditor_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from motioneditor_tpu_torch.ops import group_norm as gn_kernel
from motioneditor_tpu_torch.ops.fused_norm import add_layer_norm, add_layer_norm_plain
from motioneditor_tpu_torch.ops.gn_stats import (
    channel_pair_stats,
    channel_pair_stats_plain,
    vector_body,
)
from motioneditor_tpu_torch.ops.injection_flash import (
    fused_injection_attention,
    fused_injection_attention_plain,
)
from motioneditor_tpu_torch.ops.temporal_flash import (
    temporal_flash_attention,
    temporal_flash_attention_bwd,
    temporal_flash_attention_bwd_plain,
    temporal_flash_attention_plain,
    staged_kv_frames,
    temporal_tile,
)
from motioneditor_tpu_torch.ops.video_flash import (
    video_flash_attention,
    video_flash_attention_plain,
    video_injection_attention,
    video_injection_attention_plain,
)
from motioneditor_tpu_torch.ops.temporal_flash import (
    temporal_flash_attention_global,
    temporal_flash_attention_global_plain,
)
from motioneditor_tpu_torch.ops.video_flash import (
    video_flash_attention_kv,
    video_flash_attention_kv_plain,
    video_injection_attention_kv,
    video_injection_attention_kv_plain,
)
from motioneditor_tpu_torch.ops.video_flash_bwd import (
    _delta,
    VideoFlashAttentionFn,
    video_flash_bwd,
    video_flash_bwd_dkv,
    video_flash_bwd_dq,
    video_flash_bwd_dkv_plain,
    video_flash_bwd_plain,
    video_flash_fwd_res,
    video_flash_fwd_res_plain,
)

pytestmark = pytest.mark.cuda

MODES = ["normal", "sparse_causal", "motion_frame", "dense"]
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=3e-2, rtol=1.6e-2)}

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, device, gen):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,f,n,c,heads", [
    (2, 3, 200, 32, 4),     # d = 8, ragged n
    (1, 4, 1024, 320, 8),   # d = 40
    (2, 2, 333, 640, 8),    # d = 80, ragged n
    (1, 2, 130, 1280, 8),   # d = 160
    (1, 3, 96, 192, 2),     # d = 96
])
def test_video_flash_kernel(device, dtype, mode, b, f, n, c, heads):
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (_rand((b, f, n, c), dtype, device, gen) for _ in range(3))
    scale = (c // heads) ** -0.5
    before = _build.launch_counts["video_flash_attention"]
    out = video_flash_attention(q, k, v, mode, scale, heads)
    torch.cuda.synchronize()
    assert _build.launch_counts["video_flash_attention"] == before + 1
    ref = video_flash_attention_plain(q, k, v, mode, scale, heads)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        scaled_error(out, ref)


TC_VIDEO_SHAPES = [  # (b, f, n, c, heads): B*F > 1, so frame-boundary tails occur
    (2, 3, 200, 320, 8),    # d = 40, N below one 128-query tile
    (1, 4, 1000, 640, 8),   # d = 80, ragged N
    (2, 2, 4096, 320, 8),   # d = 40 at 64x64 latents
    (1, 2, 4096, 640, 8),   # d = 80
    (2, 2, 200, 1280, 8),   # d = 160
    (1, 3, 1000, 1280, 8),  # d = 160, ragged N
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,f,n,c,heads", TC_VIDEO_SHAPES)
def test_video_flash_tc_kernel(device, mode, b, f, n, c, heads):
    """K1's bf16 tensor-core body against the plain version: every head
    (the first and the last included) of every frame, ragged N whose last
    key tile would otherwise reach into the next frame's tokens."""
    gen = torch.Generator(device=device).manual_seed(10)
    q, k, v = (_rand((b, f, n, c), torch.bfloat16, device, gen) for _ in range(3))
    scale = (c // heads) ** -0.5
    before = _build.launch_counts["video_flash_attention.tc"]
    out = video_flash_attention(q, k, v, mode, scale, heads)
    torch.cuda.synchronize()
    assert _build.launch_counts["video_flash_attention.tc"] == before + 1
    ref = video_flash_attention_plain(q, k, v, mode, scale, heads)
    d = c // heads
    for h in (0, heads - 1):
        torch.testing.assert_close(out[..., h * d:(h + 1) * d].float(),
                                   ref[..., h * d:(h + 1) * d].float(), **TOL[torch.bfloat16])
        scaled_error(out[..., h * d:(h + 1) * d], ref[..., h * d:(h + 1) * d])
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    scaled_error(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,n,c,heads", [
    (2, 3, 200, 32, 4), (2, 4, 1024, 320, 8), (2, 2, 333, 640, 8),
])
def test_video_injection_kernel(device, dtype, b, f, n, c, heads):
    gen = torch.Generator(device=device).manual_seed(1)
    q, ks, vs, kt, vt = (_rand((b, f, n, c), dtype, device, gen) for _ in range(5))
    mask = (torch.rand((f, n), generator=gen, device=device) > 0.5).float()
    scale = (c // heads) ** -0.5
    out = video_injection_attention(q, ks, vs, kt, vt, mask, scale, heads)
    torch.cuda.synchronize()
    ref = video_injection_attention_plain(q, ks, vs, kt, vt, mask, scale, heads)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


MASKS = ["binary", "fractional", "zeros", "ones", "mixed"]


def _check_tc_injection(out, ref, q, keys, heads, scale):
    """The bf16 injection output against the plain version in fp32 on the
    same bf16 inputs (the bf16 plain version rounds m and K*m to bf16, which
    the kernel does not: chip_smoke.py ``INJECTION_MASKS``): tolerance and
    scaled limits, the first and last head apart and whole; the inputs'
    logits stay below the JAX bf16 kernels' clamp."""
    assert max(logit_bound(q, k, heads, scale) for k in keys) < LOGIT_CAP
    d = q.shape[-1] // heads
    for h in (0, heads - 1):
        torch.testing.assert_close(out[..., h * d:(h + 1) * d].float(),
                                   ref[..., h * d:(h + 1) * d].float(), **TOL[torch.bfloat16])
        scaled_error(out[..., h * d:(h + 1) * d], ref[..., h * d:(h + 1) * d])
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    scaled_error(out, ref)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("b,f,n,c,heads", [
    (2, 3, 200, 320, 8),    # d = 40, ragged N below one query block; frame 0 reads itself twice
    (2, 3, 1024, 640, 8),   # d = 80 at 32x32 latents
    (1, 3, 1000, 640, 8),   # d = 80, ragged N
    (2, 2, 4096, 320, 8),   # d = 40 at 64x64 latents
    (1, 3, 200, 1280, 8),   # d = 160
])
def test_video_injection_tc_kernel(device, mask_kind, b, f, n, c, heads):
    """K2's injection instantiation of the tensor-core body against the
    plain version."""
    gen = torch.Generator(device=device).manual_seed(11)
    q, ks, vs, kt, vt = (_rand((b, f, n, c), torch.bfloat16, device, gen) for _ in range(5))
    mask = fg_mask(mask_kind, (f, n), device, gen)
    scale = (c // heads) ** -0.5
    _build.reset_launch_counts()
    out = video_injection_attention(q, ks, vs, kt, vt, mask, scale, heads)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"video_injection_attention": 1,
                                          "video_injection_attention.tc": 1}
    ref = video_injection_attention_plain(*(t.float() for t in (q, ks, vs, kt, vt)), mask,
                                          scale, heads)
    _check_tc_injection(out, ref, q, (ks, kt), heads, scale)


def _tile_n(n, f, c, heads, dtype, backward):
    """N of a case: an int, or a rule on the sites S of the tile K3 / K7
    takes at this shape (ops/temporal_flash.py temporal_tile): "S+1" one past
    a multiple of S, "3S+1", or "S//2" under one tile."""
    if isinstance(n, int):
        return n
    s = temporal_tile(f, f, c // heads, heads, dtype, backward).sites
    return {"S+1": s + 1, "3S+1": 3 * s + 1, "S//2": max(1, s // 2)}[n]


# the TMA-staged bodies' tile edges: a ragged last tile, N under one tile,
# F = 1, d = 8 and d = 160
TEMPORAL_EDGES = [
    (2, 8, "3S+1", 320, 8), (1, 8, "S//2", 640, 8), (2, 1, "S+1", 32, 4),
    (1, 4, "S+1", 8, 1), (1, 8, "S+1", 1280, 8), (1, 3, "S//2", 1280, 8),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,f,n,c,heads", [
    (2, 3, 200, 32, 4), (2, 8, 1024, 320, 8), (1, 24, 77, 640, 8), (1, 17, 64, 1280, 8),
    *TEMPORAL_EDGES,
])
def test_temporal_flash_kernel(device, dtype, causal, b, f, n, c, heads):
    n = _tile_n(n, f, c, heads, dtype, backward=False)
    gen = torch.Generator(device=device).manual_seed(2)
    q, k, v = (_rand((b, f, n, c), dtype, device, gen) for _ in range(3))
    scale = (c // heads) ** -0.5
    before = _build.launch_counts["temporal_flash_attention"]
    out = temporal_flash_attention(q, k, v, scale, heads, causal=causal)
    torch.cuda.synchronize()
    assert _build.launch_counts["temporal_flash_attention"] == before + 1
    ref = temporal_flash_attention_plain(q, k, v, scale, heads, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,fq,fk,n,c,heads,q_off", [
    (2, 2, 8, "S+1", 320, 8, 0),      # the first shard of a 4-way split: 2 K/V frames staged
    (2, 2, 8, "S+1", 320, 8, 6),      # the last shard, d = 40
    (2, 2, 8, "3S+1", 640, 8, 2),     # d = 80
    (1, 1, 8, "S//2", 1280, 8, 7),    # one query frame, d = 160, N under one tile
    (1, 4, 16, "S+1", 320, 8, 12),    # one row per thread (Fk > 8)
    (2, 3, 24, "S+1", 32, 4, 9),      # d = 8
    (1, 2, 32, 77, 640, 8, 30),       # the most frames
])
def test_temporal_global_tma_kernel(device, dtype, causal, b, fq, fk, n, c, heads, q_off):
    """K14 on K3's TMA-staged body at Fq < Fk and q_off >= 0, N ragged
    against its tile (``temporal_tile`` at Fq and the K/V frames it stages),
    against its plain version and against K3 over all frames, of which it
    is a slice."""
    if not isinstance(n, int):
        fs = staged_kv_frames(fq, fk, causal, q_off)
        s = temporal_tile(fq, fs, c // heads, heads, dtype, False).sites
        n = {"S+1": s + 1, "3S+1": 3 * s + 1, "S//2": max(1, s // 2)}[n]
    gen = torch.Generator(device=device).manual_seed(3)
    whole_q, k, v = (_rand((b, fk, n, c), dtype, device, gen) for _ in range(3))
    q = whole_q[:, q_off:q_off + fq].contiguous()
    scale = (c // heads) ** -0.5
    _build.reset_launch_counts()
    out = temporal_flash_attention_global(q, k, v, scale, heads, causal, q_off)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"temporal_flash_attention_global": 1}
    ref = temporal_flash_attention_global_plain(q, k, v, scale, heads, causal, q_off)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    whole = temporal_flash_attention(whole_q, k, v, scale, heads, causal=causal)
    torch.testing.assert_close(out.float(), whole[:, q_off:q_off + fq].float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,kv_lead,h,nq,nk,d", [
    ((2, 3), (2, 3), 8, 1024, 2048, 40),   # the auto path at 32x32, fewer frames
    ((2, 2), (2, 2), 8, 333, 666, 80),     # ragged n
    ((2,), (2,), 4, 200, 77, 9),           # d = 9: element loads
    ((1, 2), (1, 1), 2, 130, 300, 160),    # K/V broadcast over frames
    ((1,), (1,), 2, 100, 150, 256),        # the largest head dim
])
def test_flash_attention_kernel(device, dtype, lead, kv_lead, h, nq, nk, d):
    gen = torch.Generator(device=device).manual_seed(7)
    q = _rand((*lead, h, nq, d), dtype, device, gen)
    k, v = (_rand((*kv_lead, h, nk, d), dtype, device, gen) for _ in range(2))
    before = _build.launch_counts["flash_attention"]
    out = flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = flash_attention_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        scaled_error(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,n,c,heads", [(2, 3, 1024, 320, 8), (2, 2, 333, 36, 4),
                                           (1, 3, 200, 640, 8)])
def test_flash_attention_kernel_on_split_views(device, dtype, b, f, n, c, heads):
    """The head-split views of packed [B, F, N, C] tensors, read in place."""
    gen = torch.Generator(device=device).manual_seed(8)
    q, k, v = (split_heads(_rand((b, f, n, c), dtype, device, gen), heads) for _ in range(3))
    scale = (c // heads) ** -0.5
    out = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, scale)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        scaled_error(out, ref)


@pytest.mark.parametrize("lead,kv_lead,h,nq,nk,d,tc", [
    ((2, 3), (2, 1), 8, 1000, 2000, 40, True),  # K/V broadcast over frames (stride 0)
    ((2, 8), (2, 8), 8, 1024, 2048, 80, True),  # the auto path at 32x32
    ((1, 2), (1, 1), 2, 130, 300, 160, True),   # the largest tensor-core head dim
    ((2,), (2,), 4, 200, 77, 24, True),         # fewer keys than one tile
    ((1, 2), (1, 2), 2, 100, 150, 168, False),  # d > 160: the CUDA-core body
    ((2,), (2,), 4, 200, 77, 9, False),         # d = 9: the CUDA-core body
])
def test_flash_attention_tc_route(device, lead, kv_lead, h, nq, nk, d, tc):
    """K8 in bf16 takes the tensor-core body exactly where tensor_core_body
    says so, and either body matches the plain version."""
    gen = torch.Generator(device=device).manual_seed(11)
    q = _rand((*lead, h, nq, d), torch.bfloat16, device, gen)
    k, v = (_rand((*kv_lead, h, nk, d), torch.bfloat16, device, gen) for _ in range(2))
    _build.reset_launch_counts()
    out = flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention"] == 1
    assert _build.launch_counts["flash_attention.tc"] == int(tc)
    ref = flash_attention_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    scaled_error(out, ref)


@pytest.mark.parametrize("b,f,n,c,heads,offset", [
    (2, 3, 1024, 320, 8, 0), (1, 3, 1000, 640, 8, 0), (2, 2, 333, 1280, 8, 0),
    (2, 2, 200, 320, 8, 4),  # rows 8 bytes off a 16-byte boundary: the CUDA-core body
])
def test_flash_attention_tc_on_split_views(device, b, f, n, c, heads, offset):
    """K8's tensor-core body on head-split views of packed [B, F, N, C]
    tensors, read in place, writing the packed order through its strides."""
    gen = torch.Generator(device=device).manual_seed(12)
    packed = [_rand((b * f * n * c + offset,), torch.bfloat16, device, gen)[offset:].view(
        b, f, n, c) for _ in range(3)]
    q, k, v = (split_heads(x, heads) for x in packed)
    scale = (c // heads) ** -0.5
    _build.reset_launch_counts()
    out = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention.tc"] == int(offset == 0)
    ref = flash_attention_plain(q, k, v, scale)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    scaled_error(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,h,nq,d", [(2, 4, 8, 1024, 40), (2, 3, 4, 333, 9),
                                        (1, 2, 8, 200, 80), (1, 2, 2, 100, 200)])
def test_fused_injection_kernel(device, dtype, b, f, h, nq, d):
    """K9 on either body (bf16 at d = 40 and 80 on the tensor cores) against
    the plain version."""
    gen = torch.Generator(device=device).manual_seed(9)
    q = _rand((b, f, h, nq, d), dtype, device, gen)
    ks, vs = (_rand((b, f, h, 2 * nq, d), dtype, device, gen) for _ in range(2))
    kt, vt = (_rand((b, f, h, nq, d), dtype, device, gen) for _ in range(2))
    mask = (torch.rand((f, 2 * nq), generator=gen, device=device) > 0.5).float()
    _build.reset_launch_counts()
    out = fused_injection_attention(q, ks, vs, mask, kt, vt, d ** -0.5)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16 and d % 8 == 0 and d <= 160
    assert dict(_build.launch_counts) == {"fused_injection_attention": 1,
                                          **({"fused_injection_attention.tc": 1} if tc else {})}
    ref = fused_injection_attention_plain(q, ks, vs, mask, kt, vt, d ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    if tc:
        scaled_error(out, ref)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("b,f,nq,ns,c,heads,packed", [
    (2, 3, 200, 400, 320, 8, True),     # d = 40, head-split views of packed tensors
    (2, 4, 1024, 2048, 320, 8, False),  # d = 40, the auto path at 32x32 latents' N
    (1, 3, 333, 555, 640, 8, True),     # d = 80, ragged Nq and Ns
    (2, 2, 1000, 2000, 640, 8, False),  # d = 80, ragged
    (1, 3, 130, 77, 1280, 8, False),    # d = 160, fewer source keys than one tile
])
def test_fused_injection_tc_kernel(device, mask_kind, b, f, nq, ns, c, heads, packed):
    """K9's bf16 body, the injection instantiation on split-head views,
    against the plain version in fp32 on the same bf16 inputs (the bf16
    plain version rounds m and K*m to bf16, which the kernel does not:
    chip_smoke.py ``INJECTION_MASKS``), at the tolerance and the scaled
    limits; packed views are those ``split_heads`` makes of [B, F, N, C]
    (80-byte head offsets at d = 40), read and written in place."""
    gen = torch.Generator(device=device).manual_seed(13)
    d = c // heads

    def operand(n):
        x = split_heads(_rand((b, f, n, c), torch.bfloat16, device, gen), heads)
        return x if packed else x.contiguous()

    q, kt, vt = (operand(nq) for _ in range(3))
    ks, vs = (operand(ns) for _ in range(2))
    mask = fg_mask(mask_kind, (f, ns), device, gen)
    scale = d ** -0.5
    _build.reset_launch_counts()
    out = fused_injection_attention(q, ks, vs, mask, kt, vt, scale)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"fused_injection_attention": 1,
                                          "fused_injection_attention.tc": 1}
    ref = fused_injection_attention_plain(*(t.float() for t in (q, ks, vs)), mask,
                                          *(t.float() for t in (kt, vt)), scale)
    top = q.float().norm(dim=-1).amax().item() * scale
    assert max(x.float().norm(dim=-1).amax().item() for x in (ks, kt)) * top < LOGIT_CAP
    for h in (0, heads - 1):
        torch.testing.assert_close(out[:, :, h].float(), ref[:, :, h], **TOL[torch.bfloat16])
        scaled_error(out[:, :, h], ref[:, :, h])
    torch.testing.assert_close(out.float(), ref, **TOL[torch.bfloat16])
    scaled_error(out, ref)


def test_wrapper_rejects_bad_operands(device):
    q = torch.zeros((1, 2, 64, 32), device=device)
    with pytest.raises(ValueError):
        video_flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3), q,
                              "normal", 0.35, 4)
    with pytest.raises(TypeError):
        temporal_flash_attention(q.half(), q.half(), q.half(), 0.35, 4)
    x = torch.zeros((1, 2, 64, 300), device=device)
    with pytest.raises(ValueError):
        flash_attention(x, x, x)  # head dim 300 > 256
    with pytest.raises(ValueError):
        fused_injection_attention(x, x, x, torch.zeros((2, 63), device=device), x, x, 0.1)


def assert_grads_close(got, ref, dtype):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        a, b = a.float(), b.float()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
        else:
            assert (a - b).abs().max() / (b.abs().max() + 1e-6) < 0.06


def _grad_case(row, dtype, device, gen):
    """(wrapper fn, plain fn, inputs, the kernels its grad path launches)."""
    tc = dtype == torch.bfloat16  # K8, K9 and dense K1 forwards take the tensor-core body
    if row in ("flash", "flash_broadcast"):
        kv_shape = (2, 3, 4, 200, 40) if row == "flash" else (2, 1, 4, 333, 40)
        xs = [_rand((2, 3, 4, 200, 40), dtype, device, gen),
              *(_rand(kv_shape, dtype, device, gen) for _ in range(2))]
        return (lambda *t: flash_attention(*t, 40 ** -0.5),
                lambda *t: flash_attention_plain(*t, 40 ** -0.5), xs,
                ("flash_attention",) + (("flash_attention.tc",) if tc else ()))
    if row == "fused_injection":
        xs = [_rand((2, 3, 4, n, 16), dtype, device, gen)
              for n in (100, 200, 200, 100, 100)]
        mask = (torch.rand((3, 200), generator=gen, device=device) > 0.5).float()

        def with_mask(fn):
            return lambda q, ks, vs, kt, vt: fn(q, ks, vs, mask, kt, vt, 0.25)

        return (with_mask(fused_injection_attention), with_mask(fused_injection_attention_plain),
                xs, ("fused_injection_attention",)
                + (("fused_injection_attention.tc",) if tc else ()))
    if row == "temporal":
        b, f, n, c, heads = 2, 8, 200, 320, 8
        xs = [_rand((b, f, n, c), dtype, device, gen) for _ in range(3)]
        scale = (c // heads) ** -0.5
        return (lambda *t: temporal_flash_attention(*t, scale, heads),
                lambda *t: temporal_flash_attention_plain(*t, scale, heads), xs,
                ("temporal_flash_attention", "temporal_flash_attention_bwd"))
    b, f, n, c, heads = (1, 3, 333, 640, 8) if row == "dense_d80" else (2, 3, 200, 64, 4)
    row = "dense" if row == "dense_d80" else row
    scale = (c // heads) ** -0.5
    if row == "injection":
        xs = [_rand((b, f, n, c), dtype, device, gen) for _ in range(5)]
        mask = (torch.rand((f, n), generator=gen, device=device) > 0.5).float()
        return (lambda *t: video_injection_attention(*t, mask, scale, heads),
                lambda *t: video_injection_attention_plain(*t, mask, scale, heads), xs,
                ("video_injection_attention",) + (("video_injection_attention.tc",) if tc else ()))
    xs = [_rand((b, f, n, c), dtype, device, gen) for _ in range(3)]
    kernels = ((("video_flash_attention",) + (("video_flash_attention.tc",) if tc else ()))
               if row == "dense" else
               ("video_flash_fwd_res", "video_flash_bwd_dq", "video_flash_bwd_dkv"))
    return (lambda *t: video_flash_attention(*t, row, scale, heads),
            lambda *t: video_flash_attention_plain(*t, row, scale, heads), xs, kernels)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row", MODES + ["injection", "temporal", "flash", "fused_injection",
                                         "dense_d80", "flash_broadcast"])
def test_wrapper_gradients_match_plain(device, dtype, row):
    """Gradients flow through every kernel wrapper on a CUDA tensor: those of
    sum(out**2) with respect to every input match the plain version's, and
    the grad path launches its kernels (K4-K7, or the kernel forward with
    the plain VJP for dense, injection, K8 and K9; in bf16 the dense K1,
    the K2, the K8 and the K9 forwards are the tensor-core body's)."""
    gen = torch.Generator(device=device).manual_seed(5)
    fn, plain, xs, kernels = _grad_case(row, dtype, device, gen)
    xs = [x.requires_grad_() for x in xs]
    _build.reset_launch_counts()
    out = fn(*xs)
    got = torch.autograd.grad(out.float().pow(2).sum(), xs)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[k] == 1 for k in kernels), dict(_build.launch_counts)
    ref = torch.autograd.grad(plain(*xs).float().pow(2).sum(), xs)
    assert_grads_close(got, ref, dtype)


def test_grad_path_only_when_needed(device):
    """The residual-saving forward runs only when a gradient is needed, and
    inputs that need none get no gradient."""
    gen = torch.Generator(device=device).manual_seed(6)
    q, k, v = (_rand((1, 3, 100, 64), torch.float32, device, gen) for _ in range(3))
    _build.reset_launch_counts()
    video_flash_attention(q, k, v, "motion_frame", 0.35, 4)
    with torch.no_grad():
        video_flash_attention(q, k, v.requires_grad_(), "motion_frame", 0.35, 4)
    assert _build.launch_counts["video_flash_attention"] == 2
    assert _build.launch_counts["video_flash_fwd_res"] == 0
    out = video_flash_attention(q, k, v, "motion_frame", 0.35, 4)
    out.sum().backward()
    assert q.grad is None and k.grad is None and v.grad is not None
    assert _build.launch_counts["video_flash_fwd_res"] == 1


BWD_SHAPES = [
    (2, 3, 200, 32, 4),     # d = 8, ragged n
    (1, 2, 130, 48, 2),     # d = 24
    (1, 4, 1024, 320, 8),   # d = 40
    (1, 2, 257, 128, 2),    # d = 64
    (2, 2, 333, 640, 8),    # d = 80
    (1, 3, 96, 192, 2),     # d = 96
    (1, 2, 100, 256, 2),    # d = 128
    (1, 2, 130, 1280, 8),   # d = 160
    (1, 24, 64, 64, 8),     # F = 24
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame"])
@pytest.mark.parametrize("b,f,n,c,heads", BWD_SHAPES)
def test_video_flash_bwd_kernels(device, dtype, mode, b, f, n, c, heads):
    """K4 (out, lse) and K5/K6 (dq, dk, dv via video_flash_bwd) against
    their plain versions on the same residuals."""
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v, do = (_rand((b, f, n, c), dtype, device, gen) for _ in range(4))
    scale = (c // heads) ** -0.5
    out, lse = video_flash_fwd_res(q, k, v, mode, scale, heads)
    torch.cuda.synchronize()
    out_ref, lse_ref = video_flash_fwd_res_plain(q, k, v, mode, scale, heads)
    torch.testing.assert_close(out.float(), out_ref.float(), **TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    got = video_flash_bwd(q, k, v, out_ref, lse_ref, do, mode, scale, heads)
    torch.cuda.synchronize()
    ref = video_flash_bwd_plain(q, k, v, out_ref, lse_ref, do, mode, scale, heads)
    assert_grads_close(got, ref, dtype)


# K6's tensor-core body: d = 40 and 80 (the gated sites of SD-1.5), N below
# one 128-key block and one query tile, and at 32x32 latents; B = 2 once per d
TC_DKV_SHAPES = [
    (1, 3, 200, 320, 8),    # d = 40, ragged N
    (2, 3, 200, 640, 8),    # d = 80, ragged N, B = 2
    (2, 4, 1024, 320, 8),   # d = 40, B = 2
    (1, 4, 1024, 640, 8),   # d = 80
]


@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame"])
@pytest.mark.parametrize("b,f,n,c,heads", TC_DKV_SHAPES)
def test_video_flash_bwd_dkv_tc_kernel(device, mode, b, f, n, c, heads):
    """K6's bf16 tensor-core body against the plain partials, slot by slot
    (motion_frame's frame 0 reads frame 0 in both slots, sparse_causal's
    slot 0 is frame 0 for every target): every partial is held to the
    scaled limits and to the gradients' tolerance."""
    gen = torch.Generator(device=device).manual_seed(13)
    q, k, v, do = (_rand((b, f, n, c), torch.bfloat16, device, gen) for _ in range(4))
    scale = (c // heads) ** -0.5
    out, lse = video_flash_fwd_res_plain(q, k, v, mode, scale, heads)
    delta = _delta(out, do, heads)
    _build.reset_launch_counts()
    got = video_flash_bwd_dkv(q, k, v, lse, delta, do, mode, scale, heads)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"video_flash_bwd_dkv": 1, "video_flash_bwd_dkv.tc": 1}
    ref = video_flash_bwd_dkv_plain(q, k, v, lse, delta, do, mode, scale, heads)
    for part, want in zip(got, ref):
        assert part.shape == want.shape and part.dtype == torch.float32
        for slot in range(part.shape[2]):
            assert_grads_close((part[:, :, slot],), (want[:, :, slot],), torch.bfloat16)
            scaled_error(part[:, :, slot], want[:, :, slot])


@pytest.mark.parametrize("b,f,n,c,heads,tc", [
    (1, 2, 200, 768, 8, False),   # d = 96: past the tensor-core body's 80
    (1, 2, 200, 320, 8, True),
])
def test_video_flash_bwd_dkv_tc_route(device, b, f, n, c, heads, tc):
    """In bf16, K6 takes the tensor-core body exactly where
    dkv_tensor_core_body says so, and either body matches the plain partials."""
    gen = torch.Generator(device=device).manual_seed(14)
    q, k, v, do = (_rand((b, f, n, c), torch.bfloat16, device, gen) for _ in range(4))
    scale = (c // heads) ** -0.5
    out, lse = video_flash_fwd_res_plain(q, k, v, "motion_frame", scale, heads)
    delta = _delta(out, do, heads)
    _build.reset_launch_counts()
    got = video_flash_bwd_dkv(q, k, v, lse, delta, do, "motion_frame", scale, heads)
    torch.cuda.synchronize()
    assert _build.launch_counts["video_flash_bwd_dkv.tc"] == int(tc)
    ref = video_flash_bwd_dkv_plain(q, k, v, lse, delta, do, "motion_frame", scale, heads)
    assert_grads_close(got, ref, torch.bfloat16)
    for part, want in zip(got, ref):
        scaled_error(part, want)


@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame"])
@pytest.mark.parametrize("b,f,n,c,heads", TC_DKV_SHAPES)
def test_video_flash_fwd_res_tc_kernel(device, mode, b, f, n, c, heads):
    """K4's bf16 tensor-core body (K1's mainloop with the lse epilogue)
    against its plain version: the output to the bf16 tolerance and the
    scaled limits, the lse of every row (ragged N: the rows of the last
    block past N are not written) to atol 1e-4."""
    gen = torch.Generator(device=device).manual_seed(15)
    q, k, v = (_rand((b, f, n, c), torch.bfloat16, device, gen) for _ in range(3))
    scale = (c // heads) ** -0.5
    _build.reset_launch_counts()
    out, lse = video_flash_fwd_res(q, k, v, mode, scale, heads)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"video_flash_fwd_res": 1, "video_flash_fwd_res.tc": 1}
    ref, lse_ref = video_flash_fwd_res_plain(q, k, v, mode, scale, heads)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    scaled_error(out, ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame"])
@pytest.mark.parametrize("b,f,n,c,heads", TC_DKV_SHAPES)
def test_video_flash_bwd_dq_tc_kernel(device, mode, b, f, n, c, heads):
    """K5's bf16 tensor-core body against the plain dQ computed in fp32 from
    the same bf16 residuals (to the gradients' tolerance and the scaled
    limits) and its delta against the plain rowsum(dO o O)."""
    gen = torch.Generator(device=device).manual_seed(16)
    q, k, v, do = (_rand((b, f, n, c), torch.bfloat16, device, gen) for _ in range(4))
    scale = (c // heads) ** -0.5
    out, lse = video_flash_fwd_res_plain(q, k, v, mode, scale, heads)
    _build.reset_launch_counts()
    dq, delta = video_flash_bwd_dq(q, k, v, out, lse, do, mode, scale, heads)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"video_flash_bwd_dq": 1, "video_flash_bwd_dq.tc": 1}
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16
    torch.testing.assert_close(delta, _delta(out, do, heads), atol=1e-5, rtol=1e-5)
    ref = video_flash_bwd_plain(*(t.float() for t in (q, k, v, out)), lse, do.float(), mode,
                                scale, heads)[0]
    assert_grads_close((dq.float(),), (ref,), torch.bfloat16)
    scaled_error(dq, ref)


@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame"])
@pytest.mark.parametrize("b,f,n,c,heads", [
    (1, 3, 200, 320, 8),    # d = 40, ragged N
    (1, 2, 333, 640, 8),    # d = 80, ragged N
])
def test_video_flash_tc_gradients_match_plain_autograd(device, mode, b, f, n, c, heads):
    """The gradients through VideoFlashAttentionFn in bf16, with K4, K5 and
    K6 each on its tensor-core body, against autograd of the plain forward."""
    gen = torch.Generator(device=device).manual_seed(17)
    xs = [_rand((b, f, n, c), torch.bfloat16, device, gen).requires_grad_() for _ in range(3)]
    scale = (c // heads) ** -0.5
    _build.reset_launch_counts()
    out = VideoFlashAttentionFn.apply(*xs, mode, scale, heads)
    got = torch.autograd.grad(out.float().pow(2).sum(), xs)
    torch.cuda.synchronize()
    names = ("video_flash_fwd_res", "video_flash_bwd_dq", "video_flash_bwd_dkv")
    assert dict(_build.launch_counts) == {**{k: 1 for k in names},
                                          **{k + ".tc": 1 for k in names}}
    ref = torch.autograd.grad(
        video_flash_attention_plain(*xs, mode, scale, heads).float().pow(2).sum(), xs)
    assert_grads_close(got, ref, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,f,n,c,heads", [
    (2, 3, 200, 32, 4), (2, 8, 1024, 320, 8), (1, 24, 77, 640, 8), (1, 17, 64, 1280, 8),
    (1, 32, 40, 64, 8), *TEMPORAL_EDGES, (1, 32, "S+1", 160, 1),
])
def test_temporal_flash_bwd_kernel(device, dtype, causal, b, f, n, c, heads):
    n = _tile_n(n, f, c, heads, dtype, backward=True)
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v, do = (_rand((b, f, n, c), dtype, device, gen) for _ in range(4))
    scale = (c // heads) ** -0.5
    before = _build.launch_counts["temporal_flash_attention_bwd"]
    got = temporal_flash_attention_bwd(q, k, v, do, scale, heads, causal=causal)
    torch.cuda.synchronize()
    assert _build.launch_counts["temporal_flash_attention_bwd"] == before + 1
    ref = temporal_flash_attention_bwd_plain(q, k, v, do, scale, heads, causal=causal)
    assert_grads_close(got, ref, dtype)


PAIR_STATS_CASES = [
    (1, 32768, 320, 0),   # the pooled level-0 resnet GroupNorm at 512 px, 8 frames
    (8, 4096, 320, 0),    # the per-frame transformer GroupNorm
    (1, 512, 2560, 0),    # the widest up-block input: C cut into slices
    (3, 333, 100, 0),     # ragged: bf16 rows of 200 bytes take the general body
    (2, 7, 32, 0),        # fewer rows than SMs
    (1, 32768, 320, 8),   # a view 8 bytes off a 16-byte boundary: the general body
    (2, 20, 320, 0),      # S below one block's step of lanes x U rows
    (8, 64, 1280, 0),     # B = 8 with S = 64: slices of a short S
    (1, 98304, 320, 0),   # the pooled level-0 GroupNorm at 24 frames
    (1, 400000, 8, 0),    # a narrow C over a long S: 16 blocks' partials to combine
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("b,s,c,offset", PAIR_STATS_CASES)
def test_channel_pair_stats_kernel(device, dtype, same, b, s, c, offset):
    """K10 against its plain version; both sum in fp32, in two orders: the
    error is held to 1e-4 of the sum of the terms' magnitudes. Two runs are
    bit-identical (fixed summation order, no atomics). One launch, counted
    as ".vec" exactly when ``vector_body`` routes to the 16-byte body."""
    gen = torch.Generator(device=device).manual_seed(10)
    skip = offset // torch.tensor([], dtype=dtype).element_size()
    a = (2 * torch.randn((b * s * c + skip,), generator=gen, device=device) + 0.5).to(dtype)
    a = a[skip:].view(b, s, c)
    other = a if same else _rand((b, s, c), dtype, device, gen)
    vector = vector_body(a, other)
    assert vector is (offset == 0 and c * a.element_size() % 16 == 0)
    before = dict(_build.launch_counts)
    got = channel_pair_stats(a, other)
    torch.cuda.synchronize()
    for key, n in (("channel_pair_stats", 1), ("channel_pair_stats.vec", int(vector))):
        assert _build.launch_counts[key] == before.get(key, 0) + n
    ref = channel_pair_stats_plain(a, other)
    af, bf = a.float(), other.float()
    for g, r, terms in zip(got, ref, (af.abs().sum(1), (af * bf).abs().sum(1))):
        assert g.dtype == torch.float32 and g.shape == (b, c)
        assert ((g - r).abs() <= 1e-4 * terms).all()
    again = channel_pair_stats(a, other)
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((1, 8, 64, 64, 320), 32), ((8, 32, 32, 640), 32),
                                          ((2, 3, 5, 7, 64), 8)])
def test_group_norm_function_gradients(device, dtype, shape, groups, monkeypatch):
    """The GroupNorm Function (K10 forward on (x, x), backward on (dy, x))
    against autograd of the plain group_norm (the knob off, the two-launch
    pair's route closed): output, dx, dscale, dbias."""
    import os

    from motioneditor_tpu_torch.models.layers import group_norm

    monkeypatch.setattr(gn_kernel, "takes", lambda *args: False)

    gen = torch.Generator(device=device).manual_seed(11)
    x = (2 * torch.randn(shape, generator=gen, device=device) + 0.5).to(dtype)
    dy = _rand(shape, dtype, device, gen)
    p = torch.nn.GroupNorm(groups, shape[-1], device=device)
    with torch.no_grad():
        p.weight.normal_(1.0, 0.3, generator=gen)
        p.bias.normal_(0.0, 0.2, generator=gen)
    outs = {}
    old = os.environ.get("MOTIONEDITOR_FUSED_GN")
    try:
        for knob in ("1", "0"):
            os.environ["MOTIONEDITOR_FUSED_GN"] = knob
            xi = x.detach().requires_grad_()
            p.zero_grad()
            _build.reset_launch_counts()
            y = group_norm(p, xi, groups, 1e-5)
            y.backward(dy)
            torch.cuda.synchronize()
            assert _build.launch_counts["channel_pair_stats"] == (2 if knob == "1" else 0)
            outs[knob] = (y.detach(), xi.grad, p.weight.grad.clone(), p.bias.grad.clone())
    finally:
        if old is None:
            os.environ.pop("MOTIONEDITOR_FUSED_GN", None)
        else:
            os.environ["MOTIONEDITOR_FUSED_GN"] = old
    fwd_tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(outs["1"][0].float(), outs["0"][0].float(), **fwd_tol)
    assert_grads_close(outs["1"][1:], outs["0"][1:], dtype)


# every GroupNorm [B, S, C] of the cells: the UNet at batch 1 and 24 frames
# (the inversion, stage 1) and at the edit's 4 rows and 8 frames, the
# ControlNet's per-frame ones (2 rows x 8 frames), a VAE resnet's at 512 px
CONTROLNET_GROUP_NORM_SHAPES = [(16, 4096, 320), (16, 1024, 320), (16, 1024, 640),
                                (16, 256, 640), (16, 256, 1280), (16, 64, 1280)]
GROUP_NORM_SHAPES = sorted(set(unet_group_norm_shapes(batch=1, frames=24))
                           | set(unet_group_norm_shapes(batch=4, frames=8))
                           | set(CONTROLNET_GROUP_NORM_SHAPES) | {(1, 262144, 128)})


def _group_norm_case(shape, dtype, device, gen, shift=0.0):
    c = shape[-1]
    x = (2 * torch.randn(shape, generator=gen, device=device) + 0.5 + shift).to(dtype)
    w = (1 + 0.3 * torch.randn(c, generator=gen, device=device)).to(dtype)
    b = (0.2 * torch.randn(c, generator=gen, device=device)).to(dtype)
    return x, w, b


def _assert_within_ulps(got, ref):
    ulps = bf16_ulps(got, ref)
    within = (ulps <= 1).float().mean().item()
    assert ulps.max().item() <= 2 and within >= 0.999, (ulps.max().item(), within)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GROUP_NORM_SHAPES, ids=str)
def test_group_norm_kernel(device, dtype, silu, shape):
    """The GroupNorm pair (ops/group_norm.py) against the plain chain at
    every GroupNorm of the cells: the norm at most 1 bf16 ulp off on 99.9%
    of elements and 2 anywhere (chip_smoke.bf16_ulps); with the SiLU, the
    output is F.silu of the kernel's own norm bit for bit (the SiLU rounds
    where the plain version's does) and within 1 ulp of the chain's on
    99.9% of elements (not 2 anywhere: where the norm's output is below
    about -3, one ulp of it moves the SiLU's by more than 2 of its own);
    two calls bit-identical; one launch counted, and one ".silu" with the
    SiLU."""
    gen = torch.Generator(device=device).manual_seed(12)
    x, w, b = _group_norm_case(shape, dtype, device, gen)
    before = dict(_build.launch_counts)
    got = gn_kernel.group_norm(x, w, b, 32, 1e-5, silu=silu)
    torch.cuda.synchronize()
    assert _build.launch_counts["group_norm"] == before.get("group_norm", 0) + 1
    assert _build.launch_counts["group_norm.silu"] == before.get("group_norm.silu", 0) + silu
    ref = gn_kernel.group_norm_plain(x, w, b, 32, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    if silu:
        normed = gn_kernel.group_norm(x, w, b, 32, 1e-5)
        _assert_within_ulps(normed, ref)
        assert torch.equal(got, torch.nn.functional.silu(normed))
        ulps = bf16_ulps(got, torch.nn.functional.silu(ref))
        assert (ulps <= 1).float().mean().item() >= 0.999
    else:
        _assert_within_ulps(got, ref)
    assert torch.equal(got, gn_kernel.group_norm(x, w, b, 32, 1e-5, silu=silu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 98304, 320), (32, 4096, 320), (2, 300, 64)], ids=str)
def test_group_norm_kernel_shifted_input(device, dtype, shape):
    """An input whose mean is 30x its spread: the kernel's fp64 sums lose
    nothing to cancellation (the same limit as above)."""
    gen = torch.Generator(device=device).manual_seed(13)
    x, w, b = _group_norm_case(shape, dtype, device, gen, shift=60.0)  # std 2, mean 60.5
    _assert_within_ulps(gn_kernel.group_norm(x, w, b, 32, 1e-5),
                        gn_kernel.group_norm_plain(x, w, b, 32, 1e-5))


@pytest.mark.parametrize("case", ["rows_of_8_bytes", "off_16_bytes", "strided", "fp32_weight"])
def test_group_norm_route_on_the_card(device, case):
    """models/layers.py group_norm without grad: rows the 16-byte rule
    refuses keep the plain chain (no launch), a strided input is copied to
    fresh rows and taken, fp32 weights with bf16 activations are taken."""
    from motioneditor_tpu_torch.models.layers import group_norm

    gen = torch.Generator(device=device).manual_seed(14)
    c, groups = (36, 4) if case == "rows_of_8_bytes" else (320, 32)
    flat = _rand((2 * 64 * c + 4,), torch.bfloat16, device, gen)
    x = flat[4 if case == "off_16_bytes" else 0:][: 2 * 64 * c].view(2, 64, c)
    if case == "strided":
        x = x.reshape(2, 8, 8, c).permute(0, 2, 1, 3)
    p = torch.nn.GroupNorm(groups, c, device=device)
    with torch.no_grad():
        p.weight.normal_(1.0, 0.3, generator=gen)
        p.bias.normal_(0.0, 0.2, generator=gen)
    if case != "fp32_weight":
        p = p.to(torch.bfloat16)
    taken = case in ("strided", "fp32_weight")
    before = _build.launch_counts["group_norm"]
    with torch.no_grad():
        got = group_norm(p, x, groups, 1e-5, silu=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["group_norm"] == before + taken
    ref = torch.nn.functional.silu(gn_kernel.group_norm_plain(x, p.weight, p.bias, groups, 1e-5))
    if taken:
        assert torch.equal(got, torch.nn.functional.silu(gn_kernel.group_norm(
            x, p.weight, p.bias, groups, 1e-5)))
        assert (bf16_ulps(got, ref) <= 1).float().mean().item() >= 0.999
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GROUP_NORM_BWD_SHAPES, ids=str)
def test_group_norm_backward_kernel(device, dtype, silu, shape):
    """The GroupNorm pair's backward (GroupNormKernelFn) at the pooled
    level-1 norm of 24 frames, the per-frame one and the pooled level-3 one:
    dx, dw and db, x, the weight and the bias all recording, against
    autograd of the plain chain on fp32 copies (chip_smoke
    group_norm_backward_errors: fp32 within GROUP_NORM_BWD_FLOOR, bf16
    within GROUP_NORM_BWD_RATIO of the bf16 chain's own error plus the
    floor); one recorded forward and one backward call launched."""
    gen = torch.Generator(device=device).manual_seed(15)
    x, w, b = _group_norm_case(shape, dtype, device, gen)
    dy = _rand(shape, dtype, device, gen)
    r = group_norm_backward_errors(x, w, b, dy, silu)
    assert r["launched"] == {"group_norm.grad": 1, "group_norm.bwd": 1}


def test_group_norm_backward_phase(device):
    """chip_smoke.py ``phase_group_norm_backward``: the backward's ms at
    GROUP_NORM_BWD_SHAPES beside its byte bound and the chain's autograd
    backward ("[group_norm] backward" lines); raises on a gradient off its
    limit."""
    r = phase_group_norm_backward(device)["group_norm.bwd"]
    assert r["ms"] > 0 and r["bound_ms"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_backward_in_a_checkpointed_resnet(device, dtype, monkeypatch):
    """A video resnet block (models/unet.py resnet_block, 320 -> 640, its
    temporal convs nonzero) under non-reentrant checkpointing, as
    models/unet.py ``checkpointed`` runs it, every parameter and the input
    recording: each norm records in the pass and the recompute and runs one
    backward; every gradient of the kernel route against the plain route's
    in fp32, ||got - ref|| / ||ref|| within chip_smoke's
    GROUP_NORM_BWD_FLOOR, in bf16 plus GROUP_NORM_BWD_RATIO times the bf16
    plain route's own."""
    import copy

    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.unet import ResnetBlock, resnet_block
    from motioneditor_tpu_torch.ops import group_norm as gn_kernel

    gen = torch.Generator(device=device).manual_seed(16)
    block = init_params(ResnetBlock(320, 640, 1280, 32, 1e-5, video=True).to(device), gen)
    with torch.no_grad():
        for conv in (block.temp_conv1, block.temp_conv2):
            conv.weight.normal_(0.0, 0.02, generator=gen)
    x = torch.randn((1, 4, 32, 32, 320), generator=gen, device=device)
    temb = torch.randn((1, 1280), generator=gen, device=device)
    dy = torch.randn((1, 4, 32, 32, 640), generator=gen, device=device)

    def grads(blk):
        blk_dtype = next(blk.parameters()).dtype
        xi = x.to(blk_dtype).requires_grad_()
        blk.zero_grad(set_to_none=True)
        y = torch.utils.checkpoint.checkpoint(
            lambda t: resnet_block(blk, t, temb.to(blk_dtype)), xi, use_reentrant=False)
        y.backward(dy.to(blk_dtype))
        torch.cuda.synchronize()
        return [xi.grad] + [q.grad for q in blk.parameters()]

    low = copy.deepcopy(block).to(dtype)
    before = dict(_build.launch_counts)
    got = grads(low)
    launched = {k: _build.launch_counts[k] - before.get(k, 0)
                for k in ("group_norm", "group_norm.grad", "group_norm.bwd")}
    assert launched == {"group_norm": 4, "group_norm.grad": 4, "group_norm.bwd": 2}
    monkeypatch.setattr(gn_kernel, "takes", lambda *args: False)
    plain, ref = grads(low), grads(block)
    assert _build.launch_counts["group_norm"] == before.get("group_norm", 0) + 4

    def err(a, r):
        return ((a.double() - r.double()).norm() / r.double().norm()).item()

    dt = str(dtype).replace("torch.", "")
    for g, q, r in zip(got, plain, ref):
        assert g.dtype == dtype and g.shape == r.shape and torch.isfinite(g).all()
        limit = GROUP_NORM_BWD_FLOOR[dt] + (GROUP_NORM_BWD_RATIO * err(q, r)
                                            if dtype == torch.bfloat16 else 0.0)
        assert err(g, r) <= limit, (tuple(g.shape), err(g, r), err(q, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 4096, 320), (1, 8, 1024, 640), (2, 3, 100, 1280),
                                   (1, 2, 77, 36)])
def test_add_layer_norm_kernel(device, dtype, shape):
    """K11 against its plain version: the sum bit-identical (one fp32 add,
    one rounding), the normed output within 1e-5 in fp32 and the bf16
    tolerance in bf16 (the kernel normalizes the fp32 sum, the plain version
    its bf16 rounding)."""
    gen = torch.Generator(device=device).manual_seed(12)
    t = _rand(shape, dtype, device, gen)
    d = (0.5 * torch.randn(shape, generator=gen, device=device) + 0.2).to(dtype)
    norm = torch.nn.LayerNorm(shape[-1], device=device)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.3, generator=gen)
        norm.bias.normal_(0.0, 0.2, generator=gen)
        before = _build.launch_counts["add_layer_norm"]
        summed, normed = add_layer_norm(norm, t, d)
        torch.cuda.synchronize()
        assert _build.launch_counts["add_layer_norm"] == before + 1
        ref_s, ref_n = add_layer_norm_plain(t, d, norm.weight, norm.bias)
    assert summed.dtype == dtype and normed.shape == shape
    assert torch.equal(summed, ref_s)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(normed.float(), ref_n.float(), **tol)


def test_add_layer_norm_gradients_and_rejections(device):
    """Under autograd K11 runs forward with the plain version's VJP; C above
    1280 is refused."""
    gen = torch.Generator(device=device).manual_seed(13)
    t, d = (_rand((1, 2, 600, 320), torch.float32, device, gen).requires_grad_()
            for _ in range(2))
    norm = torch.nn.LayerNorm(320, device=device)
    _build.reset_launch_counts()
    s, n = add_layer_norm(norm, t, d)
    got = torch.autograd.grad((s * n).sum(), (t, d, norm.weight, norm.bias))
    assert _build.launch_counts["add_layer_norm"] == 1
    s2, n2 = add_layer_norm_plain(t, d, norm.weight, norm.bias)
    ref = torch.autograd.grad((s2 * n2).sum(), (t, d, norm.weight, norm.bias))
    assert_grads_close(got, ref, torch.float32)
    x = torch.zeros((1, 1, 8, 1536), device=device)
    with pytest.raises(ValueError):
        add_layer_norm(torch.nn.LayerNorm(1536, device=device), x, x)


# ---------------------------------------------------------------------------
# K12-K14: the frame-sharded path's kernels
# ---------------------------------------------------------------------------


def _motion_frame_kv(x):
    """[B, F, N, C] -> [B, F, 2N, C] = [prev | cur], frame 0's prev itself."""
    prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    return torch.cat([prev, x], dim=2).contiguous()


# (B, F of q, N, C, heads, Fk, M): the one-rank shapes at 64x64 latents
# (motion_frame K/V over 2N tokens, dense over all 8 frames), a 2-frame shard
# of 8 frames, and ragged / other head-dim cases
KV_SHAPES = [
    (2, 8, 4096, 320, 8, 8, 8192),
    (2, 8, 4096, 320, 8, 1, 32768),
    (2, 2, 4096, 320, 8, 2, 8192),
    (2, 2, 4096, 320, 8, 1, 32768),
    (1, 3, 333, 640, 8, 3, 666),
    (2, 3, 200, 32, 4, 1, 77),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,n,c,heads,fk,m", KV_SHAPES)
def test_video_flash_kv_kernel(device, dtype, b, f, n, c, heads, fk, m):
    gen = torch.Generator(device=device).manual_seed(20)
    q = _rand((b, f, n, c), dtype, device, gen)
    k, v = (_rand((b, fk, m, c), dtype, device, gen) for _ in range(2))
    scale = (c // heads) ** -0.5
    before = _build.launch_counts["video_flash_attention_kv"]
    out = video_flash_attention_kv(q, k, v, scale, heads)
    torch.cuda.synchronize()
    assert _build.launch_counts["video_flash_attention_kv"] == before + 1
    ref = video_flash_attention_kv_plain(q, k, v, scale, heads)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


# K12's tensor-core body: (B, F of q, N, C, heads, Fk, M)
TC_KV_SHAPES = [
    (2, 8, 4096, 320, 8, 8, 8192),    # one rank: motion_frame K/V over 2N tokens
    (2, 8, 4096, 320, 8, 1, 32768),   # one rank: the dense site's one K/V frame
    (1, 8, 4096, 320, 8, 1, 32768),   # B = 1
    (1, 8, 4096, 320, 8, 8, 8192),
    (2, 2, 4096, 320, 8, 2, 8192),    # a 2-frame shard of a 4-way split
    (2, 2, 4096, 320, 8, 1, 32768),
    (2, 3, 200, 320, 8, 3, 400),      # N = 200: below one query block, ragged keys
    (1, 3, 200, 640, 8, 1, 600),      # d = 80, Fk = 1
    (2, 2, 200, 1280, 8, 2, 333),     # d = 160
]


@pytest.mark.parametrize("b,f,n,c,heads,fk,m", TC_KV_SHAPES)
def test_video_flash_kv_tc_kernel(device, b, f, n, c, heads, fk, m):
    """K12's bf16 tensor-core body against the plain version, the first and
    the last head apart and the whole output, to the scaled limits."""
    gen = torch.Generator(device=device).manual_seed(25)
    q = _rand((b, f, n, c), torch.bfloat16, device, gen)
    k, v = (_rand((b, fk, m, c), torch.bfloat16, device, gen) for _ in range(2))
    scale = (c // heads) ** -0.5
    _build.reset_launch_counts()
    out = video_flash_attention_kv(q, k, v, scale, heads)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"video_flash_attention_kv": 1,
                                          "video_flash_attention_kv.tc": 1}
    ref = video_flash_attention_kv_plain(q, k, v, scale, heads)
    d = c // heads
    for h in (0, heads - 1):
        torch.testing.assert_close(out[..., h * d:(h + 1) * d].float(),
                                   ref[..., h * d:(h + 1) * d].float(), **TOL[torch.bfloat16])
        scaled_error(out[..., h * d:(h + 1) * d], ref[..., h * d:(h + 1) * d])
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    scaled_error(out, ref)


@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_kv_tc_on_a_4_way_split(device, shard):
    """Each 2-frame shard at 64x64 latents on K12's tensor-core body gives
    its slice of the unsharded K1 output (also the tensor-core body's)."""
    gen = torch.Generator(device=device).manual_seed(26)
    b, f, n, c, heads = 2, 8, 4096, 320, 8
    q, k, v = (_rand((b, f, n, c), torch.bfloat16, device, gen) for _ in range(3))
    scale = (c // heads) ** -0.5
    lo, hi = 2 * shard, 2 * shard + 2
    k_mf, v_mf = _motion_frame_kv(k), _motion_frame_kv(v)
    _build.reset_launch_counts()
    got = video_flash_attention_kv(q[:, lo:hi].contiguous(), k_mf[:, lo:hi].contiguous(),
                                   v_mf[:, lo:hi].contiguous(), scale, heads)
    dense = video_flash_attention_kv(q[:, lo:hi].contiguous(), k.reshape(b, 1, f * n, c),
                                     v.reshape(b, 1, f * n, c), scale, heads)
    torch.cuda.synchronize()
    assert _build.launch_counts["video_flash_attention_kv.tc"] == 2
    for out, mode in ((got, "motion_frame"), (dense, "dense")):
        want = video_flash_attention(q, k, v, mode, scale, heads)[:, lo:hi]
        torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])
        scaled_error(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,n,c,heads", [(2, 8, 4096, 320, 8), (2, 2, 4096, 320, 8),
                                           (2, 3, 333, 640, 8), (1, 2, 200, 32, 4)])
def test_video_injection_kv_kernel(device, dtype, b, f, n, c, heads):
    gen = torch.Generator(device=device).manual_seed(21)
    q, kt, vt = (_rand((b, f, n, c), dtype, device, gen) for _ in range(3))
    ks, vs = (_rand((b, f, 2 * n, c), dtype, device, gen) for _ in range(2))
    mask = (torch.rand((f, 2 * n), generator=gen, device=device) > 0.5).float()
    scale = (c // heads) ** -0.5
    before = _build.launch_counts["video_injection_attention_kv"]
    out = video_injection_attention_kv(q, ks, vs, kt, vt, mask, scale, heads)
    torch.cuda.synchronize()
    assert _build.launch_counts["video_injection_attention_kv"] == before + 1
    ref = video_injection_attention_kv_plain(q, ks, vs, kt, vt, mask, scale, heads)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("b,f,n,c,heads,m", [
    (2, 3, 200, 320, 8, 400),     # d = 40, M = 2N (the halo-built [prev | cur])
    (1, 3, 200, 640, 8, 333),     # d = 80, ragged M
    (2, 2, 4096, 320, 8, 8192),   # a 2-frame shard at 64x64 latents
    (2, 3, 100, 1280, 8, 200),    # d = 160
])
def test_video_injection_kv_tc_kernel(device, mask_kind, b, f, n, c, heads, m):
    """K13's injection instantiation of the tensor-core body against the
    plain version."""
    gen = torch.Generator(device=device).manual_seed(27)
    q, kt, vt = (_rand((b, f, n, c), torch.bfloat16, device, gen) for _ in range(3))
    ks, vs = (_rand((b, f, m, c), torch.bfloat16, device, gen) for _ in range(2))
    mask = fg_mask(mask_kind, (f, m), device, gen)
    scale = (c // heads) ** -0.5
    _build.reset_launch_counts()
    out = video_injection_attention_kv(q, ks, vs, kt, vt, mask, scale, heads)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"video_injection_attention_kv": 1,
                                          "video_injection_attention_kv.tc": 1}
    ref = video_injection_attention_kv_plain(*(t.float() for t in (q, ks, vs, kt, vt)), mask,
                                             scale, heads)
    _check_tc_injection(out, ref, q, (ks, kt), heads, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_kv_kernels_on_a_4_way_split(device, dtype, shard):
    """Each 2-frame shard of 8 frames, its explicit K/V sliced from the
    global halo-built K/V, gives its slice of the unsharded K1 / K2 output."""
    gen = torch.Generator(device=device).manual_seed(22)
    b, f, n, c, heads = 2, 8, 1024, 320, 8
    q, k, v, kt, vt = (_rand((b, f, n, c), dtype, device, gen) for _ in range(5))
    mask = (torch.rand((f, n), generator=gen, device=device) > 0.5).float()
    scale = (c // heads) ** -0.5
    lo, hi = 2 * shard, 2 * shard + 2
    k_mf, v_mf = _motion_frame_kv(k), _motion_frame_kv(v)
    m_mf = torch.cat([torch.cat([mask[:1], mask[:-1]]), mask], dim=1)
    got = video_flash_attention_kv(q[:, lo:hi].contiguous(), k_mf[:, lo:hi].contiguous(),
                                   v_mf[:, lo:hi].contiguous(), scale, heads)
    want = video_flash_attention(q, k, v, "motion_frame", scale, heads)[:, lo:hi]
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    dense = video_flash_attention_kv(q[:, lo:hi].contiguous(), k.reshape(b, 1, f * n, c),
                                     v.reshape(b, 1, f * n, c), scale, heads)
    want = video_flash_attention(q, k, v, "dense", scale, heads)[:, lo:hi]
    torch.testing.assert_close(dense.float(), want.float(), **TOL[dtype])
    inj = video_injection_attention_kv(
        q[:, lo:hi].contiguous(), k_mf[:, lo:hi].contiguous(), v_mf[:, lo:hi].contiguous(),
        kt[:, lo:hi].contiguous(), vt[:, lo:hi].contiguous(), m_mf[lo:hi], scale, heads)
    want = video_injection_attention(q, k, v, kt, vt, mask, scale, heads)[:, lo:hi]
    torch.testing.assert_close(inj.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,fq,fk,n,c,heads,offsets", [
    (2, 8, 8, 4096, 320, 8, (0,)),          # one rank
    (2, 2, 8, 4096, 320, 8, (0, 2, 4, 6)),  # the shards of a 4-way split
    (1, 3, 24, 77, 640, 8, (0, 9, 21)),
    (2, 1, 32, 64, 32, 4, (0, 31)),
])
def test_temporal_global_kernel(device, dtype, causal, b, fq, fk, n, c, heads, offsets):
    gen = torch.Generator(device=device).manual_seed(23)
    k, v = (_rand((b, fk, n, c), dtype, device, gen) for _ in range(2))
    whole_q = _rand((b, fk, n, c), dtype, device, gen)
    scale = (c // heads) ** -0.5
    whole = temporal_flash_attention(whole_q, k, v, scale, heads, causal=causal)
    for off in offsets:
        q = whole_q[:, off:off + fq].contiguous()
        before = _build.launch_counts["temporal_flash_attention_global"]
        out = temporal_flash_attention_global(q, k, v, scale, heads, causal, off)
        torch.cuda.synchronize()
        assert _build.launch_counts["temporal_flash_attention_global"] == before + 1
        ref = temporal_flash_attention_global_plain(q, k, v, scale, heads, causal, off)
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
        # the shard's output is its slice of K3's over all frames
        torch.testing.assert_close(out.float(), whole[:, off:off + fq].float(), **TOL[dtype])


def _kv_grad_case(row, dtype, device, gen):
    """(wrapper fn, plain fn, inputs, the kernel its forward launches)."""
    b, f, n, c, heads = 2, 3, 200, 64, 4
    scale = (c // heads) ** -0.5
    if row in ("kv", "kv_dense"):
        fk, m = (f, 2 * n) if row == "kv" else (1, f * n)
        xs = [_rand((b, f, n, c), dtype, device, gen)] + [
            _rand((b, fk, m, c), dtype, device, gen) for _ in range(2)]
        return (lambda *t: video_flash_attention_kv(*t, scale, heads),
                lambda *t: video_flash_attention_kv_plain(*t, scale, heads), xs,
                "video_flash_attention_kv")
    if row == "injection_kv":
        xs = [_rand((b, f, m, c), dtype, device, gen) for m in (n, 2 * n, 2 * n, n, n)]
        mask = (torch.rand((f, 2 * n), generator=gen, device=device) > 0.5).float()
        return (lambda *t: video_injection_attention_kv(*t, mask, scale, heads),
                lambda *t: video_injection_attention_kv_plain(*t, mask, scale, heads), xs,
                "video_injection_attention_kv")
    xs = [_rand((b, 2, n, c), dtype, device, gen)] + [
        _rand((b, 8, n, c), dtype, device, gen) for _ in range(2)]
    return (lambda *t: temporal_flash_attention_global(*t, scale, heads, True, 4),
            lambda *t: temporal_flash_attention_global_plain(*t, scale, heads, True, 4), xs,
            "temporal_flash_attention_global")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row", ["kv", "kv_dense", "injection_kv", "temporal_global"])
def test_kv_wrapper_gradients_match_plain(device, dtype, row):
    """K12-K14 under autograd: the kernel forward (K12's and K13's on the
    tensor-core body in bf16), the plain version's VJP."""
    gen = torch.Generator(device=device).manual_seed(24)
    fn, plain, xs, kernel = _kv_grad_case(row, dtype, device, gen)
    xs = [x.requires_grad_() for x in xs]
    _build.reset_launch_counts()
    out = fn(*xs)
    got = torch.autograd.grad(out.float().pow(2).sum(), xs)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16 and kernel != "temporal_flash_attention_global"  # K12, K13
    assert dict(_build.launch_counts) == {kernel: 1, **({kernel + ".tc": 1} if tc else {})}
    ref = torch.autograd.grad(plain(*xs).float().pow(2).sum(), xs)
    assert_grads_close(got, ref, dtype)


def test_kv_wrappers_reject_bad_operands(device):
    q = torch.zeros((1, 2, 64, 32), device=device)
    with pytest.raises(ValueError):  # Fk must be 1 or F
        video_flash_attention_kv(q, torch.zeros((1, 3, 64, 32), device=device), q, 0.35, 4)
    with pytest.raises(ValueError):  # the mask must cover the source tokens
        video_injection_attention_kv(q, q, q, q, q, torch.zeros((2, 63), device=device), 0.35, 4)
    kv = torch.zeros((1, 33, 64, 32), device=device)
    with pytest.raises(ValueError):  # more than 32 K/V frames
        temporal_flash_attention_global(q, kv, kv, 0.35, 4, True, 0)
    with pytest.raises(TypeError):
        temporal_flash_attention_global(q.half(), q.half(), q.half(), 0.35, 4, True, 0)


def test_launch_from_a_new_thread(device):
    """A thread on which PyTorch has made no CUDA call yet has no current
    context for the library's statically linked runtime: before
    ``_build.stream_handle`` made the context current, K1's and K4's first
    launch there failed with cudaErrorInvalidValue (as K5's did on
    autograd's device thread)."""
    import threading

    gen = torch.Generator(device=device).manual_seed(9)
    q, k, v = (_rand((1, 2, 1024, 320), torch.bfloat16, device, gen) for _ in range(3))
    ref = video_flash_attention(q, k, v, "motion_frame", 40 ** -0.5, 8)
    got = {}

    def run():
        try:
            got["out"] = video_flash_attention(q, k, v, "motion_frame", 40 ** -0.5, 8)
            got["res"] = video_flash_fwd_res(q, k, v, "motion_frame", 40 ** -0.5, 8)[0]
        except Exception as e:  # reported below, in the test's thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    torch.testing.assert_close(got["out"], ref, atol=0, rtol=0)
    torch.testing.assert_close(got["res"], ref, **TOL[torch.bfloat16])


def test_sdxl_kernels_and_stage1_step(device):
    """SDXL's attention sites at heads of 64 (chip_smoke.py ``phase_sdxl``):
    K1, K4-K7 and K3 in bf16 at [1, 8, 1024, 1280] with 20 heads and [1, 8,
    4096, 640] with 10 against their plain versions, then one stage-1 step of
    SDXL_BASE at 8 frames of 128x128 latents under
    EXPECTED_PER_SDXL_STAGE1_STEP; the phase raises on any miss."""
    from chip_smoke import EXPECTED_PER_SDXL_STAGE1_STEP, phase_sdxl

    r = phase_sdxl(device)
    assert r["stage1_step"]["launches"] == EXPECTED_PER_SDXL_STAGE1_STEP
