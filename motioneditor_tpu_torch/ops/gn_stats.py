"""Per-channel pair statistics and the GroupNorm built on them (port of
motioneditor_tpu/ops/gn_stats.py).

Kernel (CUDA C++, ``csrc/norm_stats.cu``):

  channel_pair_stats   replaces _pair_stats   (gn_stats.py:78)

(sum a, sum a*b) over the middle axis of [B, S, C] in fp32: the forward
statistics of GroupNorm with (x, x), the two reductions of its gradient
with (dy, x). ``GroupNormFn`` is the exact custom-VJP GroupNorm of the JAX
package (``_gn_fwd`` / ``_gn_bwd``): both directions reduce in the kernel,
the rest is elementwise.

Off by default, as in the JAX package: ``MOTIONEDITOR_FUSED_GN=1`` turns it
on, read at each call. JAX also declines shapes for which its
``_pick_rows`` finds no row blocking within the TPU's VMEM budget; that
rule is a property of the TPU, and the port does not carry it over: the
CUDA kernel takes any [B, S, C]. The one shape gate kept is JAX's
``C % num_groups == 0`` (models/layers.py ``group_norm``).

The wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.utils.runtime import env_flag


def enabled() -> bool:
    return env_flag("MOTIONEDITOR_FUSED_GN", False)


def channel_pair_stats_plain(a: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch version: (sum a, sum a*b) over axis 1, fp32."""
    af = a.float()
    bf = af if b is a else b.float()
    return af.sum(1), (af * bf).sum(1)


def channel_pair_stats(a: torch.Tensor, b: torch.Tensor):
    """(sum a, sum a*b) over the middle axis of [B, S, C], each [B, C] fp32.
    Pass ``b is a`` for the forward statistics: the kernel then reads the
    input once."""
    if a.device.type == "cpu":
        return channel_pair_stats_plain(a, b)
    name = "channel_pair_stats"
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"{name}: expected two [B, S, C] tensors, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    _build.check_operands(name, (a, b))
    bt, s, c = a.shape
    lib = _build.kernels()
    s1 = torch.empty((bt, c), dtype=torch.float32, device=a.device)
    s2 = torch.empty_like(s1)
    scratch = torch.empty(2 * bt * lib.me_pair_stats_chunks(s) * c, dtype=torch.float32,
                          device=a.device)
    code = lib.me_pair_stats(
        a.data_ptr(), b.data_ptr(), s1.data_ptr(), s2.data_ptr(), scratch.data_ptr(),
        bt, s, c, _build.DTYPE_CODES[a.dtype], _build.stream_handle(a.device))
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return s1, s2


def _group_stats(s1, s2, num_groups: int, n: float, eps: float):
    bt, c = s1.shape
    cpg = c // num_groups
    mean = s1.reshape(bt, num_groups, cpg).sum(-1) / n  # [B, G]
    ex2 = s2.reshape(bt, num_groups, cpg).sum(-1) / n
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def _bshape(x, v):
    return v.reshape((x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],))


class GroupNormFn(torch.autograd.Function):
    """GroupNorm over [B, ..., C] (statistics over every interior axis and
    the channels of a group), with the exact gradient of JAX's ``_gn_bwd``."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float):
        bt, c = x.shape[0], x.shape[-1]
        cpg = c // num_groups
        x2 = x.reshape(bt, -1, c).contiguous()
        n = float(x2.shape[1] * cpg)
        s1, s2 = channel_pair_stats(x2, x2)
        mean, inv = _group_stats(s1, s2, num_groups, n, eps)
        scale_g = scale.float().reshape(num_groups, cpg)
        bias_g = bias.float().reshape(num_groups, cpg)
        gain = (inv[..., None] * scale_g).reshape(bt, c)
        offset = (bias_g - (mean * inv)[..., None] * scale_g).reshape(bt, c)
        ctx.save_for_backward(scale, x, mean, inv)
        ctx.num_groups = num_groups
        return (x.float() * _bshape(x, gain) + _bshape(x, offset)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        scale, x, mean, inv = ctx.saved_tensors
        num_groups = ctx.num_groups
        bt, c = x.shape[0], x.shape[-1]
        cpg = c // num_groups
        x2 = x.reshape(bt, -1, c).contiguous()
        n = float(x2.shape[1] * cpg)
        t1, t2 = channel_pair_stats(dy.reshape(bt, -1, c).contiguous(), x2)
        scale_g = scale.float().reshape(num_groups, cpg)[None]  # [1, G, cpg]
        t1g = t1.reshape(bt, num_groups, cpg)
        t2g = t2.reshape(bt, num_groups, cpg)
        # per group: the sums of w*dy and of w*dy*(x - mean), w_c = inv_g * scale_c
        sum_wdy = inv * (scale_g * t1g).sum(-1)  # [B, G]
        sum_wdy_xc = inv * (scale_g * (t2g - mean[..., None] * t1g)).sum(-1)
        a_g = sum_wdy / n
        b_g = inv * inv * sum_wdy_xc / n
        gain = (inv[..., None] * scale_g).reshape(bt, c)
        b_c = b_g.repeat_interleave(cpg, dim=-1)
        const_c = (mean * b_g - a_g).repeat_interleave(cpg, dim=-1)
        dx = (dy.float() * _bshape(x, gain) - x.float() * _bshape(x, b_c)
              + _bshape(x, const_c)).to(x.dtype)
        dscale = dbias = None
        if ctx.needs_input_grad[1]:
            dscale = (inv[..., None] * (t2g - mean[..., None] * t1g)).sum(0).reshape(c)
            dscale = dscale.to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = t1.sum(0).to(scale.dtype)
        return dx, dscale, dbias, None, None


def group_norm_fused(p, x: torch.Tensor, num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm of ``x`` [B, ..., C] with the norm module ``p``'s weight and
    bias, its statistics and its gradient's reductions in the kernel."""
    return GroupNormFn.apply(x, p.weight, p.bias, num_groups, eps)
