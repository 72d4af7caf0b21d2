"""Split-head fg/bg injection attention
(port of motioneditor_tpu/ops/injection_flash.py).

Kernel (CUDA C++), two bodies chosen by ops/flash_attention.py
``launch_split_attention``:

  fused_injection_attention   replaces _fused_3d (injection_flash.py:268)
    bf16, d % 8 == 0, d <= 160, every row 16-byte aligned and no K/V view
    broadcast over the lead dims: the injection instantiation of the
    tensor-core body ``csrc/attention_tc.cu`` (K13's, on split-head views;
    also counted as ``fused_injection_attention.tc``); else
    ``csrc/split_attention.cu`` (fp32, d = 9, d up to 256), shared with
    ops/flash_attention.py.

The edit rows' softmax over K = [K_src*m, K_src*(1-m), K_tgt] with
V = [V_src, V_src, V_tgt]: since q.(k*m) = m*(q.k), both bodies score each
source key once and use the score twice, and never build the concatenation.
It runs in the split-head branch of ``injected_spatial_attention``
(control/injection.py), taken for head dims the packed-head kernel of
ops/video_flash.py declines. Operands are split-head views, read through
their strides; the result is a view of a packed [B, F, N, H, D] tensor (see
ops/flash_attention.py).

The wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises. Under autograd the kernel forward is
paired with the plain version's VJP, as JAX pairs it through
``kernel_with_xla_vjp``.
"""

from __future__ import annotations

import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops import flop_count
from motioneditor_tpu_torch.ops.attention import sdpa
from motioneditor_tpu_torch.ops.flash_attention import _INJECTION_CODE, launch_split_attention
from motioneditor_tpu_torch.ops.video_flash import KernelWithPlainVJP, needs_grad


def fused_injection_attention_plain(q, k_src, v_src, mask, k_tgt, v_tgt, scale: float):
    """Plain PyTorch version: softmax over the concatenated keys
    [K_src*m, K_src*(1-m), K_tgt] with values [V_src, V_src, V_tgt], one
    frame at a time (which bounds the fp32 scores to one frame's: 5 GB at
    the auto path's 4096 queries against 20480 keys, 8 heads, 2 rows)."""
    outs = []
    for f in range(q.shape[1]):
        m = mask[f].to(k_src.dtype)[:, None]  # [Ns, 1]
        ks, vs = k_src[:, f], v_src[:, f]
        k_cat = torch.cat([ks * m, ks * (1.0 - m), k_tgt[:, f]], dim=-2)
        v_cat = torch.cat([vs, vs, v_tgt[:, f]], dim=-2)
        outs.append(sdpa(q[:, f], k_cat, v_cat, scale))
    return torch.stack(outs, dim=1)


def fused_injection_attention(q, k_src, v_src, mask, k_tgt, v_tgt, scale: float):
    """q [B, F, H, Nq, D] edit-row queries; k_src / v_src [B, F, H, Ns, D]
    source-row motion-frame keys; mask [F, Ns] fg mask over the source keys
    of each frame; k_tgt / v_tgt [B, F, H, Nt, D] the edit rows' current-frame
    keys. Returns q's shape and dtype; differentiable."""
    # score + P.V over the [2 Ns fg/bg-src + Nt tgt] virtual concatenation:
    # 4 b f h nq (2 ns + nt) d
    flop_count.add_kernel_flops(4 * q.numel() * (2 * k_src.shape[-2] + k_tgt.shape[-2]),
                                "fused_injection_attention")
    if q.device.type == "cpu":
        return fused_injection_attention_plain(q, k_src, v_src, mask, k_tgt, v_tgt, scale)
    name = "fused_injection_attention"
    if q.dim() != 5:
        raise ValueError(f"{name}: expected q [B, F, H, N, D], got {tuple(q.shape)}")
    f, ns = q.shape[1], k_src.shape[-2]
    if mask.shape != (f, ns):
        raise ValueError(f"{name}: mask shape {tuple(mask.shape)} != {(f, ns)}")
    mask = mask.to(torch.float32).contiguous()
    _build.check_operands(name, (mask,), dtype=torch.float32)
    args = (q, k_src, v_src, mask, k_tgt, v_tgt)
    if needs_grad(*args):
        return KernelWithPlainVJP.apply(
            lambda *t: _injection_kernel(*t, scale),
            lambda *t: fused_injection_attention_plain(*t, scale), *args)
    return _injection_kernel(*args, scale)


def _injection_kernel(q, k_src, v_src, mask, k_tgt, v_tgt, scale):
    return launch_split_attention("fused_injection_attention", _INJECTION_CODE, q, k_src, v_src,
                                  scale, k2=k_tgt, v2=v_tgt, mask=mask, frames=q.shape[1])
