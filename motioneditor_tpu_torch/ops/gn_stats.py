"""Per-channel pair statistics and the GroupNorm built on them (port of
motioneditor_tpu/ops/gn_stats.py).

Kernel (CUDA C++, ``csrc/norm_stats.cu``):

  channel_pair_stats   replaces _pair_stats   (gn_stats.py:78)

One launch per call: the grid comes from ``pair_stats_plan`` (pure Python, pinned by the CPU tests), and
``vector_body`` routes between the kernel's 16-byte and 1-element loads.

(sum a, sum a*b) over the middle axis of [B, S, C] in fp32 (the kernel adds
in fp64): the forward
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

import functools
from typing import NamedTuple

import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops import flop_count
from motioneditor_tpu_torch.utils.runtime import env_flag


def enabled() -> bool:
    return env_flag("MOTIONEDITOR_FUSED_GN", False)


def channel_pair_stats_plain(a: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch version: (sum a, sum a*b) over axis 1, fp32."""
    af = a.float()
    bf = af if b is a else b.float()
    return af.sum(1), (af * bf).sum(1)


class PairStatsPlan(NamedTuple):
    """K10's launch (csrc/norm_stats.cu): the grid is (ctas, slices, B)."""

    vec: int      # channels per load: 16 bytes (8 bf16, 4 fp32), or 1 on the general body
    cols: int     # column groups (vec channels each) of a block's channel slice
    ctas: int     # blocks along S per (batch row, slice)
    rows: int     # rows per block; the last takes the remainder
    threads: int  # cols x row lanes

    def slices(self, c: int) -> int:
        return -(-(c // self.vec) // self.cols)

    def workspace_floats(self, b: int, c: int) -> int:
        """The fp64 partials, in fp32 words: one per block, 2 sums each."""
        return 2 * b * self.slices(c) * self.ctas * 2 * self.cols * self.vec

    def tickets(self, b: int, c: int) -> int:
        """The combine's counters: one per (batch row, slice)."""
        return b * self.slices(c)

    def combine_chunks(self) -> int:
        """J, the chunks of consecutive partials a combining block adds
        apart before it adds their sums in chunk order (csrc/norm_stats.cu
        sum_partials): threads over the width / V column units of a
        partial, V = 2 doubles a load on the 16-byte body."""
        units = 2 * self.cols * self.vec // (2 if self.vec > 1 else 1)
        return max(1, self.threads // units)


PAIR_THREADS = 512  # at most, and csrc/norm_stats.cu MAX_THREADS
PAIR_SLICE_BYTES = (128, 256, 512, 1024, 2048)  # a slice's bytes of a row, narrowest first
PAIR_BLOCK_BYTES = 128 << 10  # a block's input below which splitting S costs more (combine)
PAIR_SPLIT = 16     # blocks along S at most (the combine adds their partials)


@functools.lru_cache(maxsize=None)
def pair_stats_plan(b: int, s: int, c: int, dtype: torch.dtype, sm_count: int,
                    vector: bool = True, same: bool = True) -> PairStatsPlan:
    """K10's launch plan for [B, S, C] (``same``: b is a, one input) on a
    card of ``sm_count`` SMs (chip_variants.py --k10-plans measured the
    choices; PERF.md).
    - Slices: the narrowest of PAIR_SLICE_BYTES a row (at least a full
      128-byte line) that keeps B x slices within the SMs.
    - Blocks along S: one, so no combine at all, while a (batch row, slice)
      reads at most PAIR_BLOCK_BYTES; else as many as the SMs take, at
      most PAIR_SPLIT. Never more blocks than SMs: an SM that ran two
      blocks of equal rows would double the time."""
    vec = 16 // dtype.itemsize if vector else 1
    if c % vec:
        raise ValueError(f"pair_stats_plan: C = {c} is not a multiple of {vec}")
    cv = c // vec
    row = vec * dtype.itemsize  # bytes of a column group
    for width in PAIR_SLICE_BYTES:
        cols = min(cv, max(1, width // row), PAIR_THREADS)
        cols = -(-cv // -(-cv // cols))  # the same slices, evened out
        units = b * -(-cv // cols)
        if units <= sm_count:
            break
    unit_bytes = s * cols * row * (1 if same else 2)
    ctas = 1
    if unit_bytes > PAIR_BLOCK_BYTES:
        ctas = max(1, min(sm_count // units, PAIR_SPLIT, s))
    rows = -(-s // ctas)
    ctas = -(-s // rows)
    threads = max(1, PAIR_THREADS // cols) * cols
    return PairStatsPlan(vec, cols, ctas, rows, threads)


def vector_body(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether K10 takes its 16-byte body: fp32 or bf16 rows of C * itemsize
    bytes, a multiple of 16, with both operands on 16-byte boundaries (the
    rows of a contiguous [B, S, C] then are too). Otherwise the general
    body, the same kernel on 1-element loads."""
    size = a.dtype.itemsize
    return (a.dtype in (torch.float32, torch.bfloat16) and a.shape[-1] * size % 16 == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> the combine's counters, all 0 between launches
# (each launch's last blocks reset theirs); a stream's launches run in order
_tickets: dict = {}


def _ticket_ptr(device: torch.device, stream: int, n: int) -> int:
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return t.data_ptr()


def channel_pair_stats(a: torch.Tensor, b: torch.Tensor):
    """(sum a, sum a*b) over the middle axis of [B, S, C], each [B, C] fp32
    (views of one [2, B, C] buffer). Pass ``b is a`` for the forward
    statistics: the kernel then reads the input once. One launch; counts
    ``channel_pair_stats`` and, on the 16-byte body, ``.vec``."""
    # JAX's count: 1 add for sum a, a mul and an add for sum a*b, per element
    flop_count.add_kernel_flops(3 * a.numel(), "channel_pair_stats")
    if a.device.type == "cpu":
        return channel_pair_stats_plain(a, b)
    return _pair_stats_kernel(a, b)


def _pair_stats_kernel(a: torch.Tensor, b: torch.Tensor):
    name = "channel_pair_stats"
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"{name}: expected two [B, S, C] tensors, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    _build.check_operands(name, (a, b))
    bt, s, c = a.shape
    vector = vector_body(a, b)
    plan = pair_stats_plan(bt, s, c, a.dtype, _sm_count(a.device.index), vector,
                           a.data_ptr() == b.data_ptr())
    buf = torch.empty(2 * bt * c + plan.workspace_floats(bt, c), dtype=torch.float32,
                      device=a.device)
    stream = _build.stream_handle(a.device)
    code = _build.kernels().me_pair_stats(
        a.data_ptr(), b.data_ptr(), buf.data_ptr(), buf.data_ptr() + 8 * bt * c,
        _ticket_ptr(a.device, stream, plan.tickets(bt, c)), bt, s, c,
        _build.DTYPE_CODES[a.dtype], *plan, stream)
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    if vector:
        _build.launch_counts[f"{name}.vec"] += 1
    out = buf[: 2 * bt * c].view(2, bt, c)
    return out[0], out[1]


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
    the channels of a group), with the exact gradient of JAX's ``_gn_bwd``.

    ``reduce``, when given, sums per-channel [B, C] statistics over the
    ranks that hold the other blocks of the interior axes (the frame-sharded
    GroupNorm, parallel/frame_ops.py) and has ``parts``, their number: the
    pair sums are additive, so the statistics are global. The gradient
    reductions are summed the same way for dx; dscale and dbias stay this
    rank's share, which the training step sums over the world."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float, reduce=None):
        bt, c = x.shape[0], x.shape[-1]
        cpg = c // num_groups
        x2 = x.reshape(bt, -1, c).contiguous()
        n = float(x2.shape[1] * cpg)
        s1, s2 = channel_pair_stats(x2, x2)
        if reduce is not None:
            s1, s2, n = reduce(s1), reduce(s2), n * reduce.parts
        mean, inv = _group_stats(s1, s2, num_groups, n, eps)
        scale_g = scale.float().reshape(num_groups, cpg)
        bias_g = bias.float().reshape(num_groups, cpg)
        gain = (inv[..., None] * scale_g).reshape(bt, c)
        offset = (bias_g - (mean * inv)[..., None] * scale_g).reshape(bt, c)
        ctx.save_for_backward(scale, x, mean, inv)
        ctx.num_groups, ctx.reduce = num_groups, reduce
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
        mine = (t1g, t2g)  # this rank's share, for dscale and dbias
        if ctx.reduce is not None:
            t1g, t2g = ctx.reduce(t1g), ctx.reduce(t2g)
            n = n * ctx.reduce.parts
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
        t1g, t2g = mine
        if ctx.needs_input_grad[1]:
            dscale = (inv[..., None] * (t2g - mean[..., None] * t1g)).sum(0).reshape(c)
            dscale = dscale.to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = t1.sum(0).to(scale.dtype)
        return dx, dscale, dbias, None, None, None


def group_norm_fused(p, x: torch.Tensor, num_groups: int, eps: float,
                     reduce=None) -> torch.Tensor:
    """GroupNorm of ``x`` [B, ..., C] with the norm module ``p``'s weight and
    bias, its statistics and its gradient's reductions in the kernel;
    ``reduce`` as for ``GroupNormFn``."""
    return GroupNormFn.apply(x, p.weight, p.bias, num_groups, eps, reduce)
