"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in
a fixture, never at import). Run on a GPU host with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Shapes cover ragged token counts (not multiples of the 64-query / 32-key
tiles), every supported head-dim bucket and F up to 24. fp32 runs with
TF32 off, atol 2e-5; bf16 atol 3e-2 plus rtol 1.6e-2 (torch's bf16
default: one bf16 ulp of an output of magnitude 4 is already 0.031), on
inputs whose logits stay far below the JAX bf16 kernels' clamp of 60.
"""

import pytest
import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops.temporal_flash import (
    temporal_flash_attention,
    temporal_flash_attention_plain,
)
from motioneditor_tpu_torch.ops.video_flash import (
    video_flash_attention,
    video_flash_attention_plain,
    video_injection_attention,
    video_injection_attention_plain,
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
