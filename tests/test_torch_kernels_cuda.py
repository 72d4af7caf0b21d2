"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in
a fixture, never at import). Run on a GPU host with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Shapes cover ragged token counts (not multiples of the 64-query / 32-key
tiles), every supported head-dim bucket and F up to 24 (32 for the temporal
backward). Forward outputs: fp32 runs with TF32 off, atol 2e-5; bf16 atol
3e-2 plus rtol 1.6e-2 (torch's bf16 default: one bf16 ulp of an output of
magnitude 4 is already 0.031), on inputs whose logits stay far below the
JAX bf16 kernels' clamp of 60. Gradients: fp32 rtol 1e-4, atol 1e-3; bf16
max error relative to the max |gradient| < 0.06 (the tolerances of
tests/test_video_flash_bwd.py).
"""

import pytest
import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops.temporal_flash import (
    temporal_flash_attention,
    temporal_flash_attention_bwd,
    temporal_flash_attention_bwd_plain,
    temporal_flash_attention_plain,
)
from motioneditor_tpu_torch.ops.video_flash import (
    video_flash_attention,
    video_flash_attention_plain,
    video_injection_attention,
    video_injection_attention_plain,
)
from motioneditor_tpu_torch.ops.video_flash_bwd import (
    video_flash_bwd,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,f,n,c,heads", [
    (2, 3, 200, 32, 4), (2, 8, 1024, 320, 8), (1, 24, 77, 640, 8), (1, 17, 64, 1280, 8),
])
def test_temporal_flash_kernel(device, dtype, causal, b, f, n, c, heads):
    gen = torch.Generator(device=device).manual_seed(2)
    q, k, v = (_rand((b, f, n, c), dtype, device, gen) for _ in range(3))
    scale = (c // heads) ** -0.5
    out = temporal_flash_attention(q, k, v, scale, heads, causal=causal)
    torch.cuda.synchronize()
    ref = temporal_flash_attention_plain(q, k, v, scale, heads, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_wrapper_rejects_bad_operands(device):
    q = torch.zeros((1, 2, 64, 32), device=device)
    with pytest.raises(ValueError):
        video_flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3), q,
                              "normal", 0.35, 4)
    with pytest.raises(TypeError):
        temporal_flash_attention(q.half(), q.half(), q.half(), 0.35, 4)


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
    if row == "temporal":
        b, f, n, c, heads = 2, 8, 200, 320, 8
        xs = [_rand((b, f, n, c), dtype, device, gen) for _ in range(3)]
        scale = (c // heads) ** -0.5
        return (lambda *t: temporal_flash_attention(*t, scale, heads),
                lambda *t: temporal_flash_attention_plain(*t, scale, heads), xs,
                ("temporal_flash_attention", "temporal_flash_attention_bwd"))
    b, f, n, c, heads = 2, 3, 200, 64, 4
    scale = (c // heads) ** -0.5
    if row == "injection":
        xs = [_rand((b, f, n, c), dtype, device, gen) for _ in range(5)]
        mask = (torch.rand((f, n), generator=gen, device=device) > 0.5).float()
        return (lambda *t: video_injection_attention(*t, mask, scale, heads),
                lambda *t: video_injection_attention_plain(*t, mask, scale, heads), xs,
                ("video_injection_attention",))
    xs = [_rand((b, f, n, c), dtype, device, gen) for _ in range(3)]
    kernels = (("video_flash_attention",) if row == "dense" else
               ("video_flash_fwd_res", "video_flash_bwd_dq", "video_flash_bwd_dkv"))
    return (lambda *t: video_flash_attention(*t, row, scale, heads),
            lambda *t: video_flash_attention_plain(*t, row, scale, heads), xs, kernels)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row", MODES + ["injection", "temporal"])
def test_wrapper_gradients_match_plain(device, dtype, row):
    """Gradients flow through every kernel wrapper on a CUDA tensor: those of
    sum(out**2) with respect to every input match the plain version's, and
    the grad path launches its kernels (K4-K7, or the kernel forward with
    the plain VJP for dense and injection)."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,f,n,c,heads", [
    (2, 3, 200, 32, 4), (2, 8, 1024, 320, 8), (1, 24, 77, 640, 8), (1, 17, 64, 1280, 8),
    (1, 32, 40, 64, 8),
])
def test_temporal_flash_bwd_kernel(device, dtype, causal, b, f, n, c, heads):
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v, do = (_rand((b, f, n, c), dtype, device, gen) for _ in range(4))
    scale = (c // heads) ** -0.5
    got = temporal_flash_attention_bwd(q, k, v, do, scale, heads, causal=causal)
    torch.cuda.synchronize()
    ref = temporal_flash_attention_bwd_plain(q, k, v, do, scale, heads, causal=causal)
    assert_grads_close(got, ref, dtype)
