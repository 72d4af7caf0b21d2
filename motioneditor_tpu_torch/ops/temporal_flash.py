"""Temporal self-attention over the frame axis on [B, F, N, C]
(port of motioneditor_tpu/ops/temporal_flash.py).

Kernel (CUDA C++, ``csrc/temporal_attention.cu``):

  temporal_flash_attention  replaces _temporal_4d  (temporal_flash.py:208)

Every spatial site and head is an independent length-F sequence; the
kernel keeps the native layout (no transpose, no head split, no [.., F, F]
score tensor in device memory), computes the softmax in fp32 for any input
dtype, and never computes the causal pairs g > f. Bound on the H100 and
design notes: see the .cu source.

The wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from motioneditor_tpu_torch import _build

MAX_FRAMES = 32
MAX_HEAD_DIM = 160


def temporal_flash_supported(f: int, c: int, heads: int) -> bool:
    if c % heads:
        return False
    d = c // heads
    return d % 8 == 0 and d <= MAX_HEAD_DIM and 1 <= f <= MAX_FRAMES


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


def temporal_flash_attention(q, k, v, scale: float, heads: int,
                             causal: bool = True) -> torch.Tensor:
    """Temporal attention over [B, F, N, C] in the native token layout."""
    if q.device.type == "cpu":
        return temporal_flash_attention_plain(q, k, v, scale, heads, causal)
    name = "temporal_flash_attention"
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, F, N, C] shape")
    b, f, n, c = q.shape
    if not temporal_flash_supported(f, c, heads):
        raise ValueError(f"{name}: unsupported F={f}, C={c}, heads={heads}")
    _build.check_operands(name, (q, k, v))
    out = torch.empty_like(q)
    code = _build.kernels().me_temporal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, f, n, heads, c // heads, float(scale), int(causal),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return out
